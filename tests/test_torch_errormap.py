"""The port's error-map refiner (``vidmat_torch/refine/errormap.py``), its
serving body and ``preset_video_1080p_errormap`` against the JAX package
on the CPU.

- Selection: equal to ``jax.lax.top_k`` (indices and order) on planted
  grids: all zeros, ties across the K boundary, K equal to the slot
  count, two rows.
- The refiner against the JAX module on the shipped errormap_demo
  weights, float32, at 64x64 (P 16, K 4) and 128x96 (P 8, K 16): alpha and
  error map max |d| <= 1e-4. Where the two selections differ, the JAX
  grid's K-th and (K+1)-th values lie within 1e-6 (a near tie).
- The errormap serving body (use_pallas=False, fp32, 128x128, ratio 0.25)
  against the JAX body over 3 recurrent frames (max |d| <= 1e-4), with
  and without a refiner, and convert_video on the errormap configuration
  against the JAX body frame by frame (alpha bytes mean <= 0.26 LSB, max
  <= 2, the serving bar of tests/test_torch_serving.py).
- The quality gate: the port-side copy of
  tests/integration/test_quality.py::test_errormap_beats_guided_on_hard_content.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_hard_clip
from vidmat_torch.models.weights import (build_network, build_refiner,
                                         default_refiner_variables,
                                         default_variables)
from vidmat_torch.pipeline.stepfactory import build_serving_body


def _planted(case):
    rng = np.random.RandomState(3)
    if case == "all zeros":
        return np.zeros((1, 40), np.float32), 8
    if case == "three non-zero":
        g = np.zeros((1, 40), np.float32)
        g[0, [5, 17, 30]] = [0.5, 0.5, 0.25]
        return g, 8
    if case == "ties across K":
        # 6 equal values straddle the K boundary (K = 4), zeros below.
        g = np.zeros((1, 64), np.float32)
        g[0, [3, 9, 20, 33, 41, 60]] = 0.75
        g[0, [1, 50]] = 0.9
        return g, 4
    if case == "K equals slots":
        return np.round(rng.rand(1, 24) * 4).astype(np.float32) / 4, 24
    # Two rows, each with its own ties and zeros.
    g = np.round(rng.rand(2, 96) * 3).astype(np.float32) / 3
    g[:, ::5] = 0.0
    return g, 20


@pytest.mark.parametrize("case", ["all zeros", "three non-zero",
                                  "ties across K", "K equals slots",
                                  "two rows"])
def test_selection_equals_lax_top_k(case):
    from vidmat_torch.refine.errormap import select_patches

    grid, k = _planted(case)
    _, want = jax.lax.top_k(jnp.asarray(grid), k)
    got = select_patches(torch.from_numpy(grid), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_refiner(k, p):
    from vidmat.refine.errormap import ErrorMapRefiner

    return ErrorMapRefiner(num_patches=k, patch_size=p)


def _jax_vars():
    return jax.tree_util.tree_map(jnp.asarray, default_refiner_variables())


@pytest.mark.parametrize("h,w,p,k", [(64, 64, 16, 4), (128, 96, 8, 16)])
def test_refiner_matches_jax(h, w, p, k):
    from vidmat.ops.resize import resize_bilinear as j_resize

    from vidmat_torch.ops.resize import resize_bilinear
    from vidmat_torch.refine.errormap import select_patches

    rng = np.random.RandomState(h + k)
    hl, wl = h // 2, w // 2
    rgb = rng.rand(2, h, w, 3).astype(np.float32)
    rgb_lr = np.asarray(j_resize(jnp.asarray(rgb), hl, wl))
    alpha_lr = rng.rand(2, hl, wl, 1).astype(np.float32)
    ja, je = _jax_refiner(k, p).apply(_jax_vars(), jnp.asarray(rgb),
                                      jnp.asarray(rgb_lr),
                                      jnp.asarray(alpha_lr))
    ref = build_refiner(default_refiner_variables(), k, p)
    ta, te = ref(*(torch.from_numpy(np.array(a))
                   for a in (rgb, rgb_lr, alpha_lr)))
    d_err = float(np.abs(te.numpy() - np.asarray(je)).max())
    assert d_err <= 1e-4, d_err

    # The two selections; where they differ, the JAX grid has a near tie
    # at the K boundary.
    gh, gw = h // p, w // p
    jgrid = np.asarray(j_resize(je, gh, gw)).reshape(2, gh * gw)
    _, jidx = jax.lax.top_k(jnp.asarray(jgrid), k)
    tidx = select_patches(resize_bilinear(te, gh, gw).reshape(2, -1), k)
    for b in range(2):
        if set(np.asarray(jidx[b])) != set(tidx[b].numpy()):
            srt = np.sort(jgrid[b])[::-1]
            assert srt[k - 1] - srt[k] <= 1e-6, (
                f"row {b}: the selections differ without a near tie: the "
                f"JAX grid's K-th and (K+1)-th values are {srt[k - 1]} and "
                f"{srt[k]}")
            continue
        d_alpha = float(np.abs(ta[b].numpy() - np.asarray(ja[b])).max())
        assert d_alpha <= 1e-4, (b, d_alpha)


def test_feather_equals_jax():
    from vidmat.refine.errormap import _feather as j_feather

    from vidmat_torch.refine.errormap import ErrorMapRefiner, _feather

    for p in (8, 16, 32):
        np.testing.assert_array_equal(_feather(p, max(2, p // 8)),
                                      j_feather(p, max(2, p // 8)))
    ref = ErrorMapRefiner(num_patches=4, patch_size=16)
    assert "feather" not in ref.state_dict()
    np.testing.assert_array_equal(ref.feather.numpy(), j_feather(16, 2))


H = W = 128
BASE = ModelConfig()


def _jax_body(refine, k, float_output=True, with_refiner=True):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig()
    kw = (dict(refiner=(_jax_refiner(k, 16), _jax_vars()))
          if with_refiner else {})
    body, plan = j_build(JNet(jcfg), jcfg,
                         JRefineConfig(mode=refine, errormap_patches=k),
                         H, W, 0.25, cdtype=jnp.float32, use_pallas=False,
                         float_output=float_output, **kw)
    return jax.jit(body), plan


def _port_body(refine, k, float_output=True, with_refiner=True):
    net = build_network(BASE, default_variables(BASE))
    refiner = (build_refiner(default_refiner_variables(), k, 16)
               if with_refiner else None)
    return build_serving_body(
        net, BASE, RefineConfig(mode=refine, errormap_patches=k), H, W, 0.25,
        cdtype=torch.float32, use_pallas=False, float_output=float_output,
        refiner=refiner)


@pytest.mark.parametrize("with_refiner", [True, False],
                         ids=["refiner", "no refiner"])
def test_errormap_body_matches_jax(with_refiner):
    """The errormap body over 3 recurrent frames of the hard clip; with no
    refiner both packages take the bilinear tail."""
    jbody, jplan = _jax_body("errormap", 16, with_refiner=with_refiner)
    body, plan = _port_body("errormap", 16, with_refiner=with_refiner)
    assert plan.chunk_body is None
    jvars = jax.tree_util.tree_map(jnp.asarray, default_variables(BASE))
    js, ts = jplan.make_state(1), plan.make_state(1)
    worst = 0.0
    for f, _ in synthetic_hard_clip(H, W, 3, seed=11):
        (ja, jf), js = jbody(jvars, jnp.asarray(f[None]), js)
        (ta, tf), ts = body(torch.from_numpy(f[None]), ts)
        worst = max(worst, float(np.abs(ta.numpy() - np.asarray(ja)).max()),
                    float(np.abs(tf.numpy() - np.asarray(jf)).max()))
    assert worst <= 1e-4, worst


def test_errormap_convert_video_matches_jax():
    """convert_video on the errormap configuration (fp32, no kernels,
    chunk 4: one full chunk through the per-frame chunk and a drained
    frame, the patch budget clamped from 256 to 32 of the 64 slots)
    against the JAX package's errormap body frame by frame (its loop's
    scan runs that body in order)."""
    import vidmat_torch

    frames = [f for f, _ in synthetic_hard_clip(H, W, 5, seed=12)]
    got = []
    m = vidmat_torch.convert_video(
        frames, output_alpha=got.append, model_cfg=BASE,
        pipe_cfg=PipelineConfig(downsample_ratio=0.25, chunk_size=4,
                                dtype="float32", use_pallas=False,
                                refine=RefineConfig(mode="errormap")),
        device="cpu")
    assert m["frames"] == 5 and len(got) == 5
    jbody, jplan = _jax_body("errormap", 32, float_output=False)
    jvars = jax.tree_util.tree_map(jnp.asarray, default_variables(BASE))
    js = jplan.make_state(1)
    want = []
    for f in frames:
        (alpha_u8, _, _), js = jbody(jvars, jnp.asarray(f[None]), js)
        want.append(np.asarray(alpha_u8)[0, ..., 0])
    d = np.abs(np.stack(got).astype(int) - np.stack(want).astype(int))
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_patch_budget_clamps_and_refiner_loads_as_jax(monkeypatch):
    """The patch budget clamps to max(1, slots // 2) where it exceeds the
    frame's slots and stays so; no refiner at full resolution; the shipped
    errormap_demo is loaded when refiner_variables is None, and a missing
    one raises the JAX package's ValueError."""
    import vidmat_torch.models.weights as weights
    from vidmat_torch.pipeline.video import VideoPipeline

    pipe = PipelineConfig(refine=RefineConfig(mode="errormap"))
    p = VideoPipeline(pipe_cfg=pipe, device="cpu")
    assert p._refiner_for(64, 64, 1.0) is None  # full resolution
    ref = p._refiner_for(64, 96, 0.5)
    assert ref.num_patches == 12 and ref.patch_size == 16  # 24 slots
    assert p._refiner_for(128, 128, 0.5).num_patches == 12
    want = default_refiner_variables()
    got = ref.state_dict()
    np.testing.assert_array_equal(
        got["refine_net.head.weight"].numpy(),
        want["params"]["refine_net"]["head"]["kernel"].transpose(3, 2, 0, 1))
    monkeypatch.setattr(weights, "default_refiner_path",
                        lambda: "/nonexistent/errormap_demo.npz")
    with pytest.raises(ValueError, match="errormap"):
        VideoPipeline(pipe_cfg=pipe, device="cpu")._refiner_for(64, 96, 0.5)


def test_errormap_beats_guided_on_hard_content():
    """The port-side copy of the JAX package's gate
    (tests/integration/test_quality.py::test_errormap_beats_guided_on_hard_content):
    on the hard clip at 256x256 (seed 31415, 4 frames, 64 of 256 patch
    slots) the errormap body's unknown-band alpha MAD is below the guided
    tail's on the same base model."""
    from vidmat_torch.pipeline.trimap import alpha_to_trimap

    h = w = 256
    n_patches = 64
    net = build_network(BASE, default_variables(BASE))
    refiner = build_refiner(default_refiner_variables(), n_patches, 16)
    bodies = {}
    for mode, kw in (("guided", {}), ("errormap", dict(refiner=refiner))):
        body, plan = build_serving_body(
            net, BASE, RefineConfig(mode=mode, errormap_patches=n_patches),
            h, w, 0.25, cdtype=torch.float32, use_pallas=False,
            float_output=True, **kw)
        bodies[mode] = [body, plan.make_state(1)]
    unk = {m: [] for m in bodies}
    for frame, gt in synthetic_hard_clip(h, w, 4, seed=31415):
        band = alpha_to_trimap(gt[..., 0])[..., 0] == 0.5
        for m, bs in bodies.items():
            (alpha, _), bs[1] = bs[0](torch.from_numpy(frame[None]), bs[1])
            d = np.abs(alpha[0, ..., 0].numpy() - gt[..., 0])
            unk[m].append(d[band].mean())
    em, gd = np.mean(unk["errormap"]), np.mean(unk["guided"])
    assert em < gd, (em, gd)
