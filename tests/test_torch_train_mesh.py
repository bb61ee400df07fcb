"""Sharded training (``mesh=`` of vidmat_torch/train/loop.py,
vidmat_torch/parallel/spatial.py) on the CPU, over positions that repeat
the CPU.

The step and the segmentation step on a (4, 2) ('data', 'spatial') mesh
of ``["cpu"] * 8`` (the step also on ('data',) and ('spatial',) meshes)
against
the port's unsharded step at T=2, N=4, 32x32, the size of the JAX
package's sharded tests (tests/unit/test_train.py:43,
tests/unit/test_seg.py:167); tests/test_torch_train_step.py holds the
unsharded step to the JAX package. Bars: loss and terms 2e-5 relative,
gradients per leaf max|dg| / max|g| <= 1e-4 (read through an optimizer that
keeps them in its state), running statistics 1e-5. The JAX sharded
step's loss on the conftest's 8 virtual devices as a (4, 2) mesh, and on
4 of them as a ('spatial', 'data') (2, 2) mesh, against the port's, rtol
2e-5. Width-sharded inference at 64x256 over 8
positions against the unsharded forward, atol 2e-5 (the counterpart of
tests/unit/test_spatial_sharding.py). In float64 the sharded training
forward and backward equal the unsharded ones to 1e-10: the sharding
changes only the order of float32 sums (which at 512 px moves the
deepest leaves' float32 gradients by more than 1e-4, chip_smoke.py phase
H). The preconditions raise; a mesh whose 'spatial' group spans
processes gives the Layout its positions (tests/test_torch_multihost.py
runs such meshes over two processes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat.config import ModelConfig as JModelConfig
from vidmat.parallel.mesh import make_mesh as jmake_mesh
from vidmat.train import loop as jloop
from vidmat.train.data import synthetic_clip_batches, synthetic_seg_batches
from vidmat_torch.config import ModelConfig, preset_video_1080p
from vidmat_torch.models.matting_net import MattingNetwork, init_state
from vidmat_torch.models.weights import (flatten_variables,
                                         graft_seg_params, init_params,
                                         load_into_torch, numpy_variables,
                                         randomize_bn_stats)
from vidmat_torch.parallel.mesh import Mesh, make_mesh
from vidmat_torch.parallel.spatial import (Layout, apply_sharded,
                                           sharded_forward)
from vidmat_torch.train import loop as tloop
from vidmat_torch.train import optim

MESHES = {"data x spatial (4, 2)": (("data", "spatial"), (4, 2)),
          "data (4,)": (("data",), (4,)),
          "spatial (2,)": (("spatial",), (2,))}


def _cpu_mesh(axes, shape):
    return make_mesh(axes, shape, devices=["cpu"] * int(np.prod(shape)))


def _capture():
    return optim.GradientTransformation(
        lambda p: {"g": optim.tree_map(optim.zeros_like, p)},
        lambda g, s, p=None: (optim.tree_map(torch.zeros_like, g),
                              {"g": g}))


def _step(kind, variables, batch, mesh=None):
    """One step with the capturing optimizer: (grads, metrics,
    batch_stats) as flat numpy dicts."""
    opt = _capture()
    make = (tloop.make_train_step if kind == "mat"
            else tloop.make_seg_train_step)
    kw = dict(laplacian_weight=0.5, boundary_weight=2.0) if kind == "mat" \
        else {}
    fn = make(ModelConfig(), optimizer=opt, mesh=mesh,
              device=None if mesh is not None else "cpu", **kw)
    st, m = fn(tloop.TrainState(variables=variables, opt_state=opt.init(
        variables["params"])), *batch)
    return (flatten_variables(numpy_variables(st.opt_state["g"])),
            {k: float(x) for k, x in m.items()},
            flatten_variables(numpy_variables(st.variables["batch_stats"])))


@pytest.fixture(scope="module")
def setup():
    cfg = ModelConfig()
    v = init_params(cfg, seed=0)
    cases = {"mat": (v, next(synthetic_clip_batches(t=2, n=4, h=32, w=32,
                                                    seed=9))),
             "seg": (graft_seg_params(v, cfg),
                     next(synthetic_seg_batches(t=2, n=4, h=32, w=32,
                                                seed=7)))}
    return {k: (v, b, _step(k, v, b)) for k, (v, b) in cases.items()}


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("kind,mesh_name", [
    ("mat", name) for name in MESHES] + [("seg", "data x spatial (4, 2)")])
def test_sharded_step_matches_unsharded(setup, kind, mesh_name):
    variables, batch, (g0, m0, s0) = setup[kind]
    g, m, s = _step(kind, variables, batch, _cpu_mesh(*MESHES[mesh_name]))
    assert set(g) == set(g0) and set(m) == set(m0) and set(s) == set(s0)
    worst_m = {k: abs(m[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0}
    assert max(worst_m.values()) <= 2e-5, worst_m
    worst_g = {k: _rel(g[k], g0[k]) for k in g0}
    assert max(worst_g.values()) <= 1e-4, sorted(
        worst_g.items(), key=lambda kv: -kv[1])[:5]
    # (A rerun under remat that reported its statistics again would fold
    # them in twice and miss this bar.)
    worst_s = max(float(np.abs(s[k] - s0[k]).max()) for k in s0)
    assert worst_s <= 1e-5, worst_s


def test_jax_sharded_loss_matches_port(setup):
    """The JAX package's sharded step on a (4, 2) mesh of the conftest's
    virtual CPU devices gives the port's sharded loss."""
    variables, batch, _ = setup["mat"]
    jcfg = JModelConfig()
    opt = jloop.make_optimizer()
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    jmesh = jmake_mesh(("data", "spatial"), (4, 2))
    _, jm = jloop.make_train_step(jcfg, opt, mesh=jmesh)(
        jloop.TrainState(variables=v, opt_state=opt.init(v["params"])),
        *(jnp.asarray(x) for x in batch))
    step = tloop.make_train_step(ModelConfig(), mesh=_cpu_mesh(
        ("data", "spatial"), (4, 2)))
    opt_t = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(1e-4))
    _, tm = step(tloop.TrainState(variables=variables, opt_state=opt_t.init(
        variables["params"])), *batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-5)


def test_jax_spatial_data_mesh_loss_matches_port(setup):
    """The JAX package's sharded step on a ('spatial', 'data') (2, 2) mesh
    of four of the conftest's virtual CPU devices gives the port's loss on
    the same mesh shape."""
    variables, batch, _ = setup["mat"]
    opt = jloop.make_optimizer()
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    jmesh = jmake_mesh(("spatial", "data"), (2, 2),
                       devices=jax.devices()[:4])
    _, jm = jloop.make_train_step(JModelConfig(), opt, mesh=jmesh)(
        jloop.TrainState(variables=v, opt_state=opt.init(v["params"])),
        *(jnp.asarray(x) for x in batch))
    step = tloop.make_train_step(ModelConfig(), mesh=_cpu_mesh(
        ("spatial", "data"), (2, 2)))
    opt_t = optim.make_optimizer()
    _, tm = step(tloop.TrainState(variables=variables, opt_state=opt_t.init(
        variables["params"])), *batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-5)


def test_width_sharded_inference_matches_unsharded():
    """``apply_sharded`` over 8 'spatial' positions at 64x256 against the
    unsharded forward, from a zero state and then from its own state."""
    cfg = ModelConfig()
    net = MattingNetwork(cfg)
    load_into_torch(net, randomize_bn_stats(init_params(cfg, seed=0)))
    h, w = 64, 256
    frame = torch.from_numpy(
        np.random.RandomState(0).rand(1, h, w, 3).astype(np.float32))
    mesh = _cpu_mesh(("spatial",), (8,))
    with torch.no_grad():
        state = ref_state = init_state(cfg, 1, h, w)
        for _ in range(2):
            ref = net(frame, ref_state)
            got = apply_sharded(net, mesh, frame, state)
            for a, b in zip(got[:2] + tuple(got[2]),
                            ref[:2] + tuple(ref[2])):
                assert a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
            ref_state, state = ref[2], got[2]


def test_sharded_training_forward_backward_exact_in_float64(monkeypatch):
    """The training network (BatchNorm on batch statistics) on the
    fast_demo model (s2d=2) at 32x128, N=4, over a (2, 4) ('data',
    'spatial') mesh (one column a position at stride 16), in float64
    (``Tensor.float`` kept float64 for the test): the sharded outputs
    and the gradients of a weighted sum of them equal the unsharded ones
    per leaf to 1e-10 (max|dg| / max|g|)."""
    monkeypatch.setattr(torch.Tensor, "float", lambda self: self)
    axes, shape = ("data", "spatial"), (2, 4)
    cfg = preset_video_1080p()[0]
    net = MattingNetwork(cfg, bn_train=True)
    load_into_torch(net, init_params(cfg, seed=0))
    net = net.double().train()
    rng = np.random.RandomState(0)
    frame, wa, wf = (torch.from_numpy(rng.rand(4, 32, 128, c))
                     for c in (3, 1, 3))
    lay = Layout(_cpu_mesh(axes, shape))

    def run(sharded):
        net.zero_grad()
        if sharded:
            fb = lay.frame_bounds(128, 2)
            a, f, _ = sharded_forward(net, lay, lay.split(frame, 0, 2, fb),
                                      128)
            a, f = lay.join(a, 0, 2, fb), lay.join(f, 0, 2, fb)
        else:
            a, f, _ = net(frame)
        ((a * wa).sum() + (f * wf).sum()).backward()
        return a.detach(), f.detach(), {
            k: p.grad.clone() for k, p in net.named_parameters()}

    a0, f0, g0 = run(False)
    a1, f1, g1 = run(True)
    assert a1.dtype == torch.float64
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), rtol=0, atol=1e-12)
    worst = max(float((g1[k] - g0[k]).abs().max() / g0[k].abs().max())
                for k in g0 if g0[k].abs().max() > 0)
    assert worst <= 1e-10, worst


@pytest.mark.parametrize("case", ["width not divisible",
                                  "narrower than a column a position",
                                  "batch not divisible",
                                  "spatial group across processes"])
def test_preconditions_raise(case):
    cfg = ModelConfig()
    net = MattingNetwork(cfg)
    if case == "width not divisible":
        # 64 columns over 3 positions (64 / 16 = 4 columns at stride 16).
        with pytest.raises(ValueError, match="divisible by the 'spatial'"):
            apply_sharded(net, _cpu_mesh(("spatial",), (3,)),
                          torch.zeros(1, 32, 64, 3))
    elif case == "narrower than a column a position":
        with pytest.raises(ValueError, match="columns at stride 16"):
            apply_sharded(net, _cpu_mesh(("spatial",), (4,)),
                          torch.zeros(1, 32, 32, 3))
    elif case == "batch not divisible":
        batch = next(synthetic_clip_batches(t=1, n=2, h=32, w=32, seed=0))
        step = tloop.make_train_step(cfg, mesh=_cpu_mesh(("data",), (4,)))
        v = init_params(cfg, seed=0)
        with pytest.raises(ValueError, match="'data' size 4"):
            step(tloop.TrainState(variables=v, opt_state=optim.chain(
                optim.clip_by_global_norm(1.0), optim.adam(1e-4)).init(
                v["params"])), *batch)
    else:
        # No longer a precondition: a group's 'spatial' positions may lie
        # in several processes. This process holds position 0 of the one
        # group, whose positions are in processes 0 and 1.
        devs = np.empty((1, 2), dtype=object)
        devs[0, 0] = torch.device("cpu")
        mesh = Mesh(devs, ("data", "spatial"), [[0, 1]], 0)
        lay = Layout(mesh)
        assert lay.nproc == 2
        assert lay.rows == [0] and lay.devices == [[torch.device("cpu"),
                                                    None]]
        assert lay.local_keys() == [(0, 0)]
        assert sorted(set(lay.pids[0].tolist())) == [0, 1]
        tloop.make_train_step(cfg, mesh=mesh)
