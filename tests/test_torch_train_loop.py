"""The port's segmentation step and training loop
(vidmat_torch/train/loop.py) against the JAX package's on the CPU.

Both sides start from the same JAX-initialised variables and take the
same batch. The gradients are read from each step through an optimizer
that stores them in its state and returns zero updates (the JAX package's
own ``make_train_step``, with that optimizer). The reference gradients
are the JAX step's in float64 (``jax.enable_x64``): at these sizes the
JAX step in float32 is itself up to ~2e-4 (32x32) and ~1.3e-3 (64x64)
per leaf from its float64 gradients, the port's float32 step ~1e-5, so
the bound of 1e-4 per leaf is held against float64. The losses are held
to the float64 step, the running statistics to the float32 step. Each
JAX step compiles once per module-scope fixture. The helpers repeat
tests/test_torch_train_step.py's (the matting step).
"""

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
from vidmat.train.data import synthetic_clip_batches, synthetic_seg_batches
from vidmat_torch.config import ModelConfig
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


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def seg_setup():
    jcfg, cfg = JModelConfig(), ModelConfig()
    variables = _jax_variables(jcfg, 32, with_seg=True)
    batch = next(synthetic_seg_batches(t=T, n=2, h=32, w=32, seed=5))
    return jcfg, cfg, variables, batch


@pytest.mark.parametrize("bn_train", [True, False])
def test_seg_step_grads_match_jax(seg_setup, bn_train):
    jcfg, cfg, variables, batch = seg_setup
    g64, m64, _ = _jax_step("seg", jcfg, variables, batch, True,
                            bn_train=bn_train)
    _, _, s32 = _jax_step("seg", jcfg, variables, batch, False,
                          bn_train=bn_train)
    g, m, s = _port_step("seg", cfg, variables, batch, bn_train=bn_train)
    assert set(g) == set(g64)
    worst = {k: _rel(g[k], g64[k]) for k in g64 if np.any(g64[k])}
    assert max(worst.values()) <= 1e-4, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    # The matting head is not on the seg pass: zero gradients, as JAX's.
    for k in ("head/kernel", "head/bias"):
        assert not np.any(g[k]) and not np.any(g64[k])
    assert set(m) == set(m64) == {"loss", "seg_bce", "seg_iou"}
    for k in m64:
        assert abs(m[k] - m64[k]) <= 1e-5 * max(abs(m64[k]), 1e-12), k
    for k in s32:
        np.testing.assert_allclose(s[k], s32[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    if not bn_train:  # frozen running statistics are carried unchanged
        frozen = flatten_variables(variables["batch_stats"])
        for k in s:
            np.testing.assert_array_equal(s[k], frozen[k])


def test_train_on_clips_three_steps_match_jax():
    """Three steps of the real loop (clip, Adam at lr 1e-4) from equal
    variables on equal batches: Adam's normalised steps make a near-zero
    gradient's sign visible, so a few elements may differ by up to 2 lr a
    step; all but 0.1% agree within 1e-6."""
    lr, steps, size = 1e-4, 3, 32
    jcfg, cfg = JModelConfig(), ModelConfig()
    variables = _jax_variables(jcfg, size)
    seen = {"jax": [], "port": []}
    jst = jloop.train_on_clips(
        jcfg, synthetic_clip_batches(t=T, n=2, h=size, w=size, seed=9),
        num_steps=steps, lr=lr, variables=variables,
        callback=lambda i, m: seen["jax"].append(float(m["loss"])))
    tst = tloop.train_on_clips(
        cfg, synthetic_clip_batches(t=T, n=2, h=size, w=size, seed=9),
        num_steps=steps, lr=lr, variables=variables, device="cpu",
        callback=lambda i, m: seen["port"].append(m["loss"]))
    want = _np(jst.variables["params"])
    got = flatten_variables(numpy_variables(tst.variables["params"]))
    assert tst.step == steps
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert np.mean(d <= 1e-6) >= 0.999, np.mean(d <= 1e-6)
    assert d.max() <= 2 * lr * steps, d.max()
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-5)


def test_interleave_order_and_auto_graft():
    """seg_every=3: every third step is a segmentation step; a matting
    tree without seg_head gets one grafted, and its matting leaves enter
    the loop unchanged."""
    cfg = ModelConfig()
    from vidmat_torch.models.weights import init_params

    variables = init_params(cfg, seed=1)
    assert "seg_head" not in variables["params"]
    kinds = []
    st = tloop.train_on_clips(
        cfg, synthetic_clip_batches(t=1, n=1, h=32, w=32, seed=1),
        num_steps=6, lr=1e-4, variables=variables, device="cpu",
        seg_data_iter=synthetic_seg_batches(t=1, n=1, h=32, w=32, seed=2),
        seg_every=3,
        callback=lambda i, m: kinds.append("seg" if "seg_bce" in m
                                           else "mat"))
    assert kinds == ["mat", "mat", "seg", "mat", "mat", "seg"]
    assert "seg_head" in st.variables["params"]
    assert st.step == 6


def test_mesh_runs_the_sharded_loop():
    """``mesh=`` (A.12's sharded training) runs: train_on_clips over a
    ('data', 'spatial') mesh of CPU positions, a matting step then a
    segmentation step, gives the unsharded loop's losses (1e-4 relative)
    and state."""
    from vidmat_torch.models.weights import init_params
    from vidmat_torch.parallel.mesh import make_mesh

    cfg = ModelConfig()
    mesh = make_mesh(("data", "spatial"), (2, 2), devices=["cpu"] * 4)
    runs = {}
    for name, kw in (("one", dict(device="cpu")), ("mesh", dict(mesh=mesh))):
        losses = []
        st = tloop.train_on_clips(
            cfg, synthetic_clip_batches(t=T, n=2, h=32, w=32, seed=1),
            num_steps=2, variables=init_params(cfg, seed=1),
            seg_data_iter=synthetic_seg_batches(t=T, n=2, h=32, w=32,
                                                seed=2),
            seg_every=2, callback=lambda i, m: losses.append(m["loss"]),
            **kw)
        runs[name] = (losses, st)
    np.testing.assert_allclose(runs["mesh"][0], runs["one"][0], rtol=1e-4)
    assert runs["mesh"][1].step == 2
    got = flatten_variables(numpy_variables(runs["mesh"][1].variables))
    want = flatten_variables(numpy_variables(runs["one"][1].variables))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
