"""The port's matting train step (vidmat_torch/train/loop.py) against
the JAX package's on the CPU; the segmentation step and the loop are in
tests/test_torch_train_loop.py.

Both sides start from the same JAX-initialised variables and take the
same batch. The gradients are read from each step through an optimizer
that stores them in its state and returns zero updates (the JAX package's
own ``make_train_step``, with that optimizer). The reference gradients
are the JAX step's in float64 (``jax.enable_x64``): at these sizes the
JAX step in float32 is itself up to ~2e-4 (32x32) and ~1.3e-3 (64x64)
per leaf from its float64 gradients, the port's float32 step ~1e-5, so
the bound of 1e-4 per leaf is held against float64. The losses are held
to the float64 step, the running statistics to the float32 step. Each
JAX step compiles once per module-scope fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vidmat.config import ModelConfig as JModelConfig
from vidmat.models.weights import graft_seg_params as jgraft
from vidmat.models.weights import init_params as jinit
from vidmat.train import loop as jloop
from vidmat.train.data import synthetic_clip_batches
from vidmat_torch.config import ModelConfig
from vidmat_torch.config import preset_video_1080p
from vidmat_torch.models.weights import flatten_variables, numpy_variables
from vidmat_torch.train import loop as tloop
from vidmat_torch.train import optim

T = 2


def _jcapture():
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g),
                              {"g": g}))


def _tcapture():
    return optim.GradientTransformation(
        lambda p: {"g": optim.tree_map(optim.zeros_like, p)},
        lambda g, s, p=None: (optim.tree_map(torch.zeros_like, g),
                              {"g": g}))


def _jax_variables(jcfg, size, with_seg=False):
    """JAX-initialised variables as numpy (the init jitted: run op by op
    it takes half a minute here)."""
    def init():
        v = jinit(jcfg, seed=0, height=size, width=size)
        return jgraft(v, jcfg, seed=0) if with_seg else v
    return jax.tree_util.tree_map(np.asarray, jax.jit(init)())


def _np(tree):
    return flatten_variables(jax.tree_util.tree_map(np.asarray, tree))


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), tree)


def _jax_step(kind, jcfg, variables, batch, x64, **kw):
    """One JAX step with the capturing optimizer: (grads, metrics,
    batch_stats) as flat numpy dicts."""
    dt = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        v = _cast(variables, dt)
        b = [np.asarray(x, dt) for x in batch]
        if kind == "mat":
            fn = jloop.make_train_step(jcfg, optimizer=_jcapture(), **kw)
        else:
            fn = jloop.make_seg_train_step(jcfg, optimizer=_jcapture(), **kw)
        st, m = fn(jloop.TrainState(variables=v, opt_state=_jcapture().init(
            v["params"])), *b)
        return (_np(st.opt_state["g"]), {k: float(x) for k, x in m.items()},
                _np(st.variables["batch_stats"]))


def _port_step(kind, cfg, variables, batch, **kw):
    if kind == "mat":
        fn = tloop.make_train_step(cfg, optimizer=_tcapture(), device="cpu",
                                   **kw)
    else:
        fn = tloop.make_seg_train_step(cfg, optimizer=_tcapture(),
                                       device="cpu", **kw)
    st, m = fn(tloop.TrainState(variables=variables,
                                opt_state=_tcapture().init(
                                    variables["params"])), *batch)
    return (flatten_variables(numpy_variables(st.opt_state["g"])),
            {k: float(x) for k, x in m.items()},
            flatten_variables(numpy_variables(st.variables["batch_stats"])))


MAT_CASES = {
    # name: (ModelConfig fields, size, N, laplacian, boundary)
    "default": ({}, 32, 2, 0.0, 0.0),
    "video_1080p": (dataclasses.asdict(preset_video_1080p()[0]), 64, 2,
                    0.5, 2.0),
}


@pytest.fixture(scope="module", params=list(MAT_CASES))
def mat_case(request):
    fields, size, n, lap, bnd = MAT_CASES[request.param]
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in fields.items()}
    jcfg, cfg = JModelConfig(**fields), ModelConfig(**fields)
    variables = _jax_variables(jcfg, size)
    batch = next(synthetic_clip_batches(t=T, n=n, h=size, w=size, seed=3))
    kw = dict(laplacian_weight=lap, boundary_weight=bnd)
    ref64 = _jax_step("mat", jcfg, variables, batch, True, **kw)
    ref32 = _jax_step("mat", jcfg, variables, batch, False, **kw)
    got = {remat: _port_step("mat", cfg, variables, batch, remat=remat,
                             **kw) for remat in (True, False)}
    return dict(ref64=ref64, ref32=ref32, got=got, lap=lap, bnd=bnd)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_train_step_grads_match_jax_per_leaf(mat_case):
    g64, _, _ = mat_case["ref64"]
    g, _, _ = mat_case["got"][True]
    assert set(g) == set(g64)
    worst = {k: _rel(g[k], g64[k]) for k in g64}
    assert max(worst.values()) <= 1e-4, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


def test_train_step_loss_terms_and_stats_match_jax(mat_case):
    _, m64, _ = mat_case["ref64"]
    _, _, s32 = mat_case["ref32"]
    _, m, s = mat_case["got"][True]
    want = {"loss", "alpha", "grad", "fgr", "temporal"}
    want |= {"laplacian"} if mat_case["lap"] > 0 else set()
    want |= {"boundary"} if mat_case["bnd"] > 0 else set()
    assert set(m) == set(m64) == want
    for k in m64:
        assert abs(m[k] - m64[k]) <= 1e-5 * max(abs(m64[k]), 1e-12), (
            k, m[k], m64[k])
    assert set(s) == set(s32)
    for k in s32:
        np.testing.assert_allclose(s[k], s32[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_remat_on_and_off_equal(mat_case):
    """The recomputed frames report their statistics into scopes that are
    dropped: with and without remat the step gives the same gradients and
    running statistics (each frame folded in once)."""
    g1, m1, s1 = mat_case["got"][True]
    g0, m0, s0 = mat_case["got"][False]
    for k in g1:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s0[k], err_msg=k)
    assert m1 == m0
