"""The port's public surface against the JAX package's, by signature.

One case per module of ``vidmat`` (outside ``vidmat/ops/pallas/``, the
TPU kernels, which the port replaces with ``vidmat_torch/csrc/``): every
public function and class the module defines, and every public method of
such a class, has a counterpart in the same-named ``vidmat_torch``
module that takes the JAX parameter names (the port may take more, such
as ``device``). A Flax module's ``__call__`` is held to the PyTorch
module's ``forward``, and its ``__init__`` without Flax's own fields.
``DELIBERATE`` lists the differences the port makes on purpose, each
with its reason; any other difference fails, and so does an entry that
is no longer a difference. Only signatures are read.
"""

import importlib
import inspect
import pkgutil

import flax.linen as fnn
import pytest

import vidmat

# Flax's own module fields: the tree position (parent, name, scope) and
# the compute dtype, which Flax gives every submodule and the port only
# the network (``MattingNetwork(dtype=)``).
FLAX_FIELDS = {"parent", "name", "scope", "dtype"}

_LAYOUT = ("a TPU layout helper of the planar net (lane-dense grids for "
           "Pallas); the CUDA kernels take NCHW planes, ROADMAP exempts it")
_FORWARD = ("the planar net's functional forward; its role is played by "
            "PlanarNetwork (vidmat_torch/models/planar.py)")
_IMPL = ("the XLA/Pallas choice; the port's counterpart is kernels= (the "
         "CUDA kernel or its plain twin)")

DELIBERATE = {
    "vidmat.models.planar.plane_to_grid": _LAYOUT,
    "vidmat.models.planar.grid_to_plane": _LAYOUT,
    "vidmat.models.planar.s2d_grid": _LAYOUT,
    "vidmat.models.planar.d2s_grid": _LAYOUT,
    "vidmat.models.planar.upsample2x_grid": _LAYOUT,
    "vidmat.models.planar.stride2_tap_weights_jnp": _LAYOUT,
    "vidmat.models.planar.build_planar_forward": _FORWARD,
    "vidmat.models.planar.batch_planar_forward": _FORWARD,
    "vidmat.models.planar.planar_init_state_batched": (
        "PlanarNetwork.init_state(batch, h, w) makes the batched state"),
    "vidmat.models.torch_oracle": (
        "the JAX package's PyTorch oracle of its own net; the port is "
        "PyTorch, and ROADMAP leaves the oracle unported"),
    "vidmat.models.layers.ConvBNAct.__init__(features)": (
        "a PyTorch convolution is built with its input width: the port "
        "takes (cin, cout) where Flax infers cin and takes features"),
    "vidmat.ops.guided_filter.guided_upsample(impl)": _IMPL,
    "vidmat.ops.guided_filter.guided_upsample(interpret)": (
        "Pallas's interpret mode; the port's plain twins run on CPU "
        "tensors"),
    "vidmat.refine.tiling.tiled_guided_upsample(impl)": _IMPL,
    "vidmat.refine.tiling.tiled_guided_upsample(interpret)": (
        "Pallas's interpret mode; the port's plain twins run on CPU "
        "tensors"),
    "vidmat.pipeline.stepfactory.build_serving_body(pallas_interpret)": (
        "Pallas's interpret mode; use_pallas= and kernels= choose the "
        "port's branch and its plain twins"),
}


def _modules():
    names = ["vidmat"]
    for m in pkgutil.walk_packages(vidmat.__path__, "vidmat."):
        if not m.name.startswith("vidmat.ops.pallas"):
            names.append(m.name)
    return names


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _missing_params(qual, want, have, skip=()):
    jp, tp = _params(want), _params(have)
    if jp is None or tp is None:
        return []
    return [f"{qual}({p})" for p in jp if p not in tp and p not in skip]


def _methods(cls):
    for name, v in vars(cls).items():
        if name.startswith("_") and name not in ("__init__", "__call__"):
            continue
        if isinstance(v, (staticmethod, classmethod)):
            v = v.__func__
        if inspect.isfunction(v) or isinstance(v, property):
            yield name, v


def differences(name):
    """The port's differences from JAX module ``name``: 'module' where
    the port lacks it, 'module.name' where it lacks a name,
    'module.name(param)' where its counterpart lacks a parameter."""
    jm = importlib.import_module(name)
    try:
        tm = importlib.import_module("vidmat_torch" + name[len("vidmat"):])
    except ModuleNotFoundError:
        return [name]
    out = []
    for key, obj in vars(jm).items():
        if (key.startswith("_") or getattr(obj, "__module__", None) != name
                or not (inspect.isfunction(obj) or inspect.isclass(obj))):
            continue
        qual = f"{name}.{key}"
        if not hasattr(tm, key):
            out.append(qual)
            continue
        port = getattr(tm, key)
        if inspect.isfunction(obj):
            out += _missing_params(qual, obj, port)
            continue
        flax = issubclass(obj, fnn.Module)
        for mname, meth in _methods(obj):
            mqual = f"{qual}.{mname}"
            pname = "forward" if flax and mname == "__call__" else mname
            if not hasattr(port, pname):
                out.append(mqual)
            elif inspect.isfunction(meth):
                out += _missing_params(
                    mqual, meth, getattr(port, pname),
                    FLAX_FIELDS if flax and mname == "__init__" else ())
    return out


MODULES = _modules()


def _owner(entry):
    """The module a ``DELIBERATE`` entry is about."""
    base = entry.split("(")[0]
    return max((m for m in MODULES if base == m or base.startswith(m + ".")),
               key=len)


@pytest.mark.parametrize("name", MODULES)
def test_port_has_the_jax_surface(name):
    diffs = differences(name)
    unexplained = [d for d in diffs if d not in DELIBERATE]
    assert not unexplained, unexplained
    stale = [d for d in DELIBERATE if _owner(d) == name and d not in diffs]
    assert not stale, stale
