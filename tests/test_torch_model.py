"""The port's MattingNetwork against the Flax network on the same weights,
on the CPU, over recurrent rollouts.

fp32 bound: 1e-3 MAD per frame (tests/parity/test_image_parity.py);
bf16 bound: 2e-2 (tests/parity/test_planar_parity.py:113).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig
from vidmat_torch.io.fixtures import synthetic_clip
from vidmat_torch.models.matting_net import (RecurrentState, depth_to_space,
                                             init_state, space_to_depth)
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.utils.metrics import mad


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _rollout(cfg, variables, h, w, frames, jdtype=None, tdtype=None,
             seed=7):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.models.matting_net import init_state as j_init_state

    jcfg = JModelConfig(space_to_depth=cfg.space_to_depth,
                        recurrent=cfg.recurrent)
    jnet = JNet(jcfg, dtype=jdtype)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    apply = jax.jit(jnet.apply)
    net = build_network(cfg, variables, dtype=tdtype)
    js = j_init_state(jcfg, 1, h, w, jdtype or jnp.float32)
    ts = init_state(cfg, 1, h, w, tdtype or torch.float32)
    worst = 0.0
    with jax.default_matmul_precision("float32"), torch.inference_mode():
        for f, _ in synthetic_clip(h, w, frames, seed=seed):
            x = (f.astype(np.float32) / 255.0)[None]
            ja, jf, js = apply(jvars, jnp.asarray(x), js)
            ta, tf, ts = net(torch.from_numpy(x), ts)
            worst = max(worst, mad(ja, ta.numpy()), mad(jf, tf.numpy()))
    for jl, tl in zip(js, ts):
        assert tuple(jl.shape) == tuple(tl.shape)
    return worst


def test_fast_demo_fp32_rollout():
    cfg = ModelConfig(space_to_depth=2)
    worst = _rollout(cfg, default_variables(cfg), 128, 192, 8)
    assert worst <= 1e-3, worst


def test_fast_demo_bf16_rollout():
    cfg = ModelConfig(space_to_depth=2)
    worst = _rollout(cfg, default_variables(cfg), 128, 192, 8,
                     jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    assert worst <= 2e-2, worst


def test_s2d1_random_weights_fp32_rollout():
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.weights import init_params, randomize_bn_stats

    variables = jax.tree_util.tree_map(np.asarray, randomize_bn_stats(
        init_params(JModelConfig(), seed=2), seed=3))
    worst = _rollout(ModelConfig(), variables, 64, 96, 4)
    assert worst <= 1e-3, worst


def test_cotrained_checkpoint_loads_without_seg_head():
    """A co-trained tree (with ``seg_head``) loads into the matting net,
    which ignores the head, and mattes exactly as the Flax net does."""
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.models.weights import init_params

    jcfg = JModelConfig(space_to_depth=2)
    variables = jax.tree_util.tree_map(
        np.asarray, init_params(jcfg, seed=4, with_seg=True))
    assert "seg_head" in variables["params"]
    net = build_network(ModelConfig(space_to_depth=2), variables)
    x = np.random.RandomState(5).rand(1, 64, 64, 3).astype(np.float32)
    want, _, _ = JNet(jcfg).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    with torch.inference_mode():
        got, _, _ = net(torch.from_numpy(x), None)
    assert got.shape == (1, 64, 64, 1)
    assert mad(want, got.numpy()) <= 1e-4


def test_space_to_depth_matches_jax():
    from vidmat.models.matting_net import depth_to_space as j_d2s
    from vidmat.models.matting_net import space_to_depth as j_s2d

    x = np.random.RandomState(6).rand(2, 8, 12, 3).astype(np.float32)
    want = np.asarray(j_s2d(jnp.asarray(x), 2))
    got = space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    back = depth_to_space(got, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(j_d2s(jnp.asarray(want), 2)))


def test_unported_model_options_raise():
    """The trimap pin (once an A.10 raise in the serving body and the
    planar net, now ported) against the JAX network on the shipped
    trimap weights: trimap_demo as F.conv2d and trimap_prop_demo through
    the planar net's plain versions, fp32, alpha and fgr MAD <= 1e-3,
    pinned pixels exact; then the planar build and the state layout."""
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.matting_net import MattingNetwork as JNet

    from vidmat_torch.models.planar import PlanarNetwork

    rng = np.random.RandomState(8)
    x = rng.rand(1, 64, 64, 4).astype(np.float32)
    x[..., 3] = rng.choice([0.0, 128 / 255, 1.0], (1, 64, 64))
    for kw, impl in ((dict(recurrent=False), "xla"),
                     (dict(space_to_depth=2), "planar")):
        tcfg = ModelConfig(use_trimap=True, conv_impl=impl, **kw)
        variables = default_variables(tcfg)
        tnet = build_network(tcfg, variables)
        assert isinstance(tnet, PlanarNetwork) == (impl == "planar")
        jcfg = JModelConfig(use_trimap=True, **kw)
        with jax.default_matmul_precision("float32"):
            ja, jf, _ = JNet(jcfg).apply(
                jax.tree_util.tree_map(jnp.asarray, variables),
                jnp.asarray(x))
        with torch.inference_mode():
            alpha, fgr, _ = tnet(torch.from_numpy(x), None)
        assert mad(ja, alpha.numpy()) <= 1e-3, mad(ja, alpha.numpy())
        assert mad(jf, fgr.numpy()) <= 1e-3
        a, t = alpha[0, ..., 0].numpy(), x[0, ..., 3]
        assert (a[t == 1.0] == 1.0).all() and (a[t == 0.0] == 0.0).all()
        known = t != np.float32(128 / 255)
        np.testing.assert_array_equal(a[known],
                                      np.asarray(ja)[0, ..., 0][known])
    # conv_impl="planar" builds the planar-kernel network.
    cfg = ModelConfig(space_to_depth=2, conv_impl="planar")
    net = build_network(cfg, default_variables(cfg), dtype=torch.bfloat16)
    assert isinstance(net, PlanarNetwork) and net.dtype == torch.bfloat16
    assert net.d1_gru_wg.shape == (24, 24, 3, 3)
    st = init_state(ModelConfig(space_to_depth=2), 1, 64, 96)
    assert isinstance(st, RecurrentState)
    assert st.h3.shape == (1, 4, 6, 24) and st.h1.shape == (1, 16, 24, 12)
