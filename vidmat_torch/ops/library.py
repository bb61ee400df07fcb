"""The port's kernels as PyTorch custom operators (``vidmat_torch::*``).

Every hand-written kernel that a serving body reaches is registered here
with ``torch.library.custom_op``, so that ``torch.export`` records it as
one node of the exported program (the counterpart of the Pallas calls that
``jax.export`` embeds in its StableHLO, vidmat/deploy.py:1-9) and a
loaded program runs the same kernel as the live body:

  vidmat_torch::ingest_pool_normalize   csrc/ingest.cu
  vidmat_torch::guided_filter_coeffs    csrc/gf_coeffs.cu
  vidmat_torch::fused_refine_composite  csrc/refine_composite.cu
  vidmat_torch::fused_refine_float      csrc/refine_float.cu
  vidmat_torch::composite_rgba_packed   csrc/composite.cu
  vidmat_torch::planar_conv             csrc/planar_conv.cu
  vidmat_torch::planar_conv2            csrc/planar_conv2.cu
  vidmat_torch::planar_conv_gru         csrc/planar_gru.cu
  vidmat_torch::planar_gru              csrc/planar_gru.cu

Each op has three implementations:

- CUDA: the kernel, launched through its ctypes launcher
  (``_launch_<op>`` in the op's module under ``vidmat_torch/ops``) on
  the current stream. The
  launcher counts the launch on its wrapper (``.launches``), so a count
  is taken only where a kernel really runs, never while a program is
  traced; a failed build or launch raises, nothing falls back.
- CPU: the kernel's plain PyTorch twin, so that a CPU program holds the
  same nodes as a CUDA one.
- fake: the output shapes and dtypes, for tracing.

The ops are functional: each allocates its outputs and none returns an
alias of an input. The two packing ops return their RGBA words as int32
(the bits of the uint32 words; ``words`` gives the uint32 view). The
wrappers (``ingest_pool_normalize``, ...) check their arguments and call
these ops on every device. ``int8_conv`` (the int8 planes probe) is
reached by no serving body and stays a plain wrapper.

Importing this module registers the ops; it imports only ``torch``. The
kernel modules are imported when an op first runs.
"""

import importlib
from typing import List, Optional, Tuple

import torch
from torch import Tensor

#: op name -> the module under vidmat_torch/ops holding its launcher,
#: wrapper and plain twin
MODULES = {
    "ingest_pool_normalize": "ingest",
    "guided_filter_coeffs": "gf",
    "fused_refine_composite": "refine",
    "fused_refine_float": "refine",
    "composite_rgba_packed": "composite",
    "planar_conv": "planar",
    "planar_conv2": "planar",
    "planar_conv_gru": "planar",
    "planar_gru": "planar",
}

#: the six ops of the main path (the video_1080p chunk body)
MAIN_PATH = ("ingest_pool_normalize", "planar_conv", "planar_conv2",
             "planar_conv_gru", "guided_filter_coeffs",
             "fused_refine_composite")


_LOADED = {}


def _mod(op: str):
    """The module holding ``op``'s launcher and plain twin."""
    mod = _LOADED.get(op)
    if mod is None:
        mod = _LOADED[op] = importlib.import_module(
            f"vidmat_torch.ops.{MODULES[op]}")
    return mod


def _register(name: str, cpu, fake) -> None:
    """Register ``vidmat_torch::<name>`` with the signature of ``cpu``
    (its CPU implementation): the CUDA implementation is the module's
    ``_launch_<name>``, the fake ``fake``."""
    custom = torch.library.custom_op(f"vidmat_torch::{name}", cpu,
                                     mutates_args=(), device_types="cpu")

    def cuda(*args, **kwargs):
        return getattr(_mod(name), f"_launch_{name}")(*args, **kwargs)

    custom.register_kernel("cuda")(cuda)
    custom.register_fake(fake)


def words(packed: Tensor) -> Tensor:
    """Packed RGBA words as the port hands them out, uint32, from the
    int32 the packing ops return (the same bits). While ``torch.export``
    traces a body they stay int32: the program serializer of some PyTorch
    releases (2.11) has no uint32; ``deploy.ServingBundle`` reads a
    program's words as uint32 on the host."""
    return packed if torch.compiler.is_compiling() else packed.view(
        torch.uint32)


def _empty(like: Tensor, shape, dtype) -> Tensor:
    return like.new_empty(tuple(shape), dtype=dtype)


# ---- ingest ----

def _ingest_cpu(frames: Tensor, pool: int, scale: List[float],
                offset: List[float], out_dtype: torch.dtype) -> Tensor:
    return _mod("ingest_pool_normalize").ingest_pool_normalize_plain(
        frames, pool, scale, offset, out_dtype)


def _ingest_fake(frames, pool, scale, offset, out_dtype):
    n, h, w, c = frames.shape
    return _empty(frames, (n, h // pool, w // pool, c), out_dtype)


# ---- guided-filter coefficients ----

def _gf_cpu(guide: Tensor, p: Tensor, radius: int,
            eps: float) -> Tuple[Tensor, Tensor]:
    return _mod("guided_filter_coeffs").guided_filter_coeffs_plain(
        guide, p, radius, eps)


def _gf_fake(guide, p, radius, eps):
    return (_empty(p, p.shape, torch.float32),
            _empty(p, p.shape, torch.float32))


# ---- refine tails ----

def _refine_composite_cpu(frame: Tensor, a_lr: Tensor, b_lr: Tensor,
                          bg: Optional[Tensor],
                          color: Optional[List[float]],
                          pool: int) -> Tensor:
    return _mod("fused_refine_composite").fused_refine_composite_plain(
        frame, a_lr, b_lr, color if bg is None else bg, pool).view(
            torch.int32)


def _refine_composite_fake(frame, a_lr, b_lr, bg, color, pool):
    return _empty(frame, frame.shape[:3], torch.int32)


def _refine_float_cpu(frame: Tensor, a_lr: Tensor, b_lr: Tensor,
                      pool: int) -> Tuple[Tensor, Tensor]:
    return _mod("fused_refine_float").fused_refine_float_plain(
        frame, a_lr, b_lr, pool)


def _refine_float_fake(frame, a_lr, b_lr, pool):
    n, h, w, _ = frame.shape
    return (_empty(frame, (n, h, w, 1), torch.float32),
            _empty(frame, (n, h, w, 3), torch.float32))


# ---- composite ----

def _composite_cpu(fgr: Tensor, alpha: Tensor, bg: Optional[Tensor],
                   color: Optional[List[float]]) -> Tensor:
    return _mod("composite_rgba_packed").composite_rgba_packed_plain(
        fgr, alpha, color if bg is None else bg).view(torch.int32)


def _composite_fake(fgr, alpha, bg, color):
    return _empty(fgr, fgr.shape[:3], torch.int32)


# ---- planar convs ----

def _out_hw(h: int, w: int, k: int, stride: int):
    p = k // 2
    return (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1


def _planar_conv_cpu(xs: List[Tensor], w: Tensor, scale: Tensor,
                     bias: Tensor, stride: int, act: str,
                     packed: Optional[Tensor]) -> Tensor:
    return _mod("planar_conv").planar_conv_plain(xs, w, scale, bias, stride,
                                                 act)


def _planar_conv_fake(xs, w, scale, bias, stride, act, packed):
    n, _, h, wd = xs[0].shape
    return _empty(xs[0], (n, w.shape[0], *_out_hw(h, wd, w.shape[-1],
                                                 stride)), xs[0].dtype)


def _planar_conv2_cpu(xs: List[Tensor], w1: Tensor, scale1: Tensor,
                      bias1: Tensor, w2: Tensor, scale2: Tensor,
                      bias2: Tensor, stride: int, act: str,
                      act2: str) -> Tensor:
    return _mod("planar_conv2").planar_conv2_plain(
        xs, w1, scale1, bias1, w2, scale2, bias2, stride, act, act2)


def _planar_conv2_fake(xs, w1, scale1, bias1, w2, scale2, bias2, stride,
                       act, act2):
    n, _, h, wd = xs[0].shape
    return _empty(xs[0], (n, w2.shape[0], *_out_hw(h, wd, 3, stride)),
                  xs[0].dtype)


def _planar_conv_gru_cpu(xs: List[Tensor], w: Tensor, scale: Tensor,
                         bias: Tensor, h: Tensor, wg: Tensor, bg: Tensor,
                         wc: Tensor, bc: Tensor) -> Tuple[Tensor, Tensor]:
    return _mod("planar_conv_gru").planar_conv_gru_plain(
        xs, w, scale, bias, h, wg, bg, wc, bc)


def _planar_conv_gru_fake(xs, w, scale, bias, h, wg, bg, wc, bc):
    return (_empty(h, h.shape, xs[0].dtype), _empty(h, h.shape, h.dtype))


def _planar_gru_cpu(x: Tensor, h: Tensor, wg: Tensor, bg: Tensor,
                    wc: Tensor, bc: Tensor) -> Tensor:
    return _mod("planar_gru").planar_gru_plain(x, h, wg, bg, wc, bc)


def _planar_gru_fake(x, h, wg, bg, wc, bc):
    return _empty(h, h.shape, h.dtype)


for _name, (_cpu, _fake) in {
        "ingest_pool_normalize": (_ingest_cpu, _ingest_fake),
        "guided_filter_coeffs": (_gf_cpu, _gf_fake),
        "fused_refine_composite": (_refine_composite_cpu,
                                   _refine_composite_fake),
        "fused_refine_float": (_refine_float_cpu, _refine_float_fake),
        "composite_rgba_packed": (_composite_cpu, _composite_fake),
        "planar_conv": (_planar_conv_cpu, _planar_conv_fake),
        "planar_conv2": (_planar_conv2_cpu, _planar_conv2_fake),
        "planar_conv_gru": (_planar_conv_gru_cpu, _planar_conv_gru_fake),
        "planar_gru": (_planar_gru_cpu, _planar_gru_fake)}.items():
    if not hasattr(torch.ops.vidmat_torch, _name):  # registered once
        _register(_name, _cpu, _fake)


def program_ops(gm: torch.fx.GraphModule) -> dict:
    """{op name: nodes} of the ``vidmat_torch`` ops in a traced program
    (its graph and every sub-graph, e.g. a ``torch.cond`` branch), and
    under "aten.convolution" its convolution nodes."""
    counts = {}
    for mod in gm.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            if node.op != "call_function":
                continue
            name = getattr(node.target, "name", lambda: "")()
            if name.startswith("vidmat_torch::"):
                key = name.split("::")[1].split(".")[0]
            elif name.startswith("aten::convolution") or name.startswith(
                    "aten::conv"):
                key = "aten.convolution"
            else:
                continue
            counts[key] = counts.get(key, 0) + 1
    return counts
