"""The last names of the JAX package's surface, against it on the CPU:
``build_serving_body(refine_at_full=True)``, ``tiled_apply``,
``have_native`` and ``pad_stack(threads=)``.

The body: ``clip_480p``'s geometry and net (ratio 1.0, the planar net,
here on its plain twins) at 64x96 with a narrow ``ModelConfig`` and
random BatchNorm statistics, guided refinement at full resolution, over
4 recurrent frames of a synthetic clip. Against the JAX body (its
``conv_impl="xla"`` net, which the planar net's parity tests pin):
packed words, with the Pallas GF and composite in interpret mode, within
mean 0.26 and max 2 LSB a byte (the bar of tests/test_torch_serving.py);
float output (``use_pallas=False``) within 1e-4; the uint8 tuple
(``use_pallas=False``) within 1 LSB. ``refine_at_full=False`` keeps the
unrefined body's bytes, and the refinement changes them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_clip
from vidmat_torch.models.weights import (build_network, init_params,
                                         randomize_bn_stats)
from vidmat_torch.pipeline.stepfactory import build_serving_body

H, W = 64, 96
CFG = ModelConfig(enc_channels=(8, 8, 8, 8), dec_channels=(8, 8, 8, 8),
                  conv_impl="planar")


@pytest.fixture(scope="module")
def variables():
    return randomize_bn_stats(init_params(CFG, seed=0))


def _port(variables, refine_at_full=True, **kw):
    net = build_network(CFG, variables)
    return build_serving_body(net, CFG, RefineConfig("guided"), H, W, 1.0,
                              cdtype=torch.float32,
                              refine_at_full=refine_at_full, **kw)


def _jax(**kw):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as jbuild

    jcfg = JModelConfig(**{**dataclasses.asdict(CFG), "conv_impl": "xla"})
    return jbuild(JNet(jcfg), jcfg, JRefineConfig("guided"), H, W, 1.0,
                  cdtype=jnp.float32, refine_at_full=True, **kw)


def _run(body, plan, frames, wrap, unwrap):
    state, outs = plan.make_state(1), []
    for f in frames:
        out, state = body(wrap(f[None]), state)
        outs.append(unwrap(out))
    return outs


def _tuple_np(out):
    return [np.asarray(t).astype(np.float64) for t in
            (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("tail", ["packed", "float", "uint8 tuple"])
def test_refine_at_full_body_matches_jax(variables, tail):
    frames = [f for f, _ in synthetic_clip(H, W, 4, seed=4)]
    kw = {"packed": dict(use_pallas=True),
          "float": dict(use_pallas=False, float_output=True),
          "uint8 tuple": dict(use_pallas=False)}[tail]
    body, plan = _port(variables, **kw)
    jbody, jplan = _jax(pallas_interpret=kw.get("use_pallas", False), **kw)
    assert plan.full and jplan.full and plan.packed == jplan.packed
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    got = _run(body, plan, frames, torch.from_numpy,
               lambda o: _tuple_np(tuple(t.numpy() for t in o)
                                   if isinstance(o, tuple) else o.numpy()))
    jstep = jax.jit(jbody)
    want = _run(lambda f, s: jstep(jvars, f, s), jplan, frames, jnp.asarray,
                _tuple_np)
    if tail == "packed":
        d = np.stack([np.abs(g[0].astype(np.uint32).view(np.uint8).astype(int)
                             - w[0].astype(np.uint32).view(np.uint8)
                             .astype(int)) for g, w in zip(got, want)])
        assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())
    else:
        bar = 1e-4 if tail == "float" else 1.0
        worst = max(float(np.abs(a - b).max()) for g, w in zip(got, want)
                    for a, b in zip(g, w))
        assert worst <= bar, worst


def test_refine_at_full_false_is_the_unrefined_body(variables):
    """Off, the body is the unrefined full-resolution body (the default);
    on, the guided filter changes its bytes."""
    frames = [torch.from_numpy(f[None])
              for f, _ in synthetic_clip(H, W, 2, seed=5)]
    outs = {}
    for name, kw in (("off", dict(refine_at_full=False)), ("default", {}),
                     ("on", dict(refine_at_full=True))):
        net = build_network(CFG, variables)
        body, plan = build_serving_body(net, CFG, RefineConfig("guided"), H,
                                        W, 1.0, cdtype=torch.float32, **kw)
        state, outs[name] = plan.make_state(1), []
        for f in frames:
            out, state = body(f, state)
            outs[name].append(out)
    assert all(torch.equal(a, b) for a, b in zip(outs["off"],
                                                 outs["default"]))
    assert not all(torch.equal(a, b) for a, b in zip(outs["off"],
                                                     outs["on"]))


def test_tiled_apply_matches_global_for_pointwise():
    """The counterpart of tests/unit/test_refine.py's: a pointwise fn
    commutes with tiling, and the port's blend equals the JAX package's
    on a 3x3-window fn, whose seams it blends."""
    from vidmat.refine.tiling import tiled_apply as jtiled_apply

    from vidmat_torch.refine.tiling import tiled_apply

    x = np.random.RandomState(1).rand(1, 96, 128, 3).astype(np.float32)
    out = tiled_apply(lambda t: torch.tanh(t * 2.0), torch.from_numpy(x),
                      tile=48, overlap=16)
    np.testing.assert_allclose(out.numpy(), np.tanh(x * 2.0), atol=1e-5)

    def box(t):
        return torch.nn.functional.avg_pool2d(
            t.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)

    def jbox(t):
        return jax.lax.reduce_window(t, 0.0, jax.lax.add, (1, 3, 3, 1),
                                     (1, 1, 1, 1), "SAME") / 9.0

    got = tiled_apply(box, torch.from_numpy(x), tile=48, overlap=16)
    want = jtiled_apply(jbox, jnp.asarray(x), tile=48, overlap=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("threads", [0, 1])
def test_pad_stack_threads_equals_jax(threads):
    """``pad_stack(threads=)`` equals the JAX package's byte for byte, and
    ``have_native`` is True (the staging library builds and loads)."""
    from vidmat.io.native import pad_stack as j_pad_stack

    from vidmat_torch.io.native import have_native, pad_stack

    assert have_native()
    rng = np.random.RandomState(threads)
    frames = [rng.randint(0, 256, (90, 150, 3), np.uint8) for _ in range(3)]
    got = pad_stack(frames, 96, 160, threads=threads)
    np.testing.assert_array_equal(
        got, j_pad_stack(frames, 96, 160, threads=threads))
