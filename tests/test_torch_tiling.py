"""The port's tiled refinement (``vidmat_torch/refine/tiling.py`` and the
tiled serving bodies) against the JAX package on the CPU.

The JAX bodies run on the ``conv_impl="xla"`` net with their Pallas
kernels in interpret mode, as tests/unit/test_fused_tiled_tail.py runs
them; the port runs the plain PyTorch versions of its kernels (CPU
tensors). The case is that test's: 256x256 at ratio 0.25 (pool 4), tile
64, overlap 16, on the shipped weights. Bounds: layouts equal; tiling and
the blend max |d| <= 1e-6; packed or alpha bytes mean |d| <= 0.26 LSB and
max <= 2 (as tests/test_torch_serving.py); float outputs MAD <= 1e-3;
the fp32 parity session MAD <= 1e-3 per frame, the bf16 one <= 2e-2
(as tests/test_torch_session.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_clip, synthetic_frames_only
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.pipeline.stepfactory import build_serving_body
from vidmat_torch.refine.tiling import (TileLayout, tile_frame,
                                        untile_frame)

H = W = 256
RATIO = 0.25
TILE, OVERLAP = 64, 16

# (h, w, tile, overlap): 4K coarse grids (272x480, what 2160 and 2176
# rows snap to at ratio 0.125, and 270x480) and full frames, the test case's full and coarse grids, a tall
# narrow frame with a single column.
LAYOUTS = [(270, 480, 128, 16), (272, 480, 128, 16),
           (2160, 3840, 1024, 128), (2176, 3840, 1024, 128),
           (256, 256, 64, 16), (64, 64, 16, 4), (100, 50, 64, 16)]


@pytest.mark.parametrize("case", LAYOUTS, ids=lambda c: "x".join(map(str, c)))
def test_tile_layout_matches_jax(case):
    from vidmat.refine.tiling import TileLayout as JTileLayout

    want, got = JTileLayout(*case), TileLayout(*case)
    assert (got.ys, got.xs, got.num_tiles, got.tile_h, got.tile_w) == (
        want.ys, want.xs, want.num_tiles, want.tile_h, want.tile_w)


@pytest.mark.parametrize("case", [LAYOUTS[0], LAYOUTS[5], LAYOUTS[6]],
                         ids=lambda c: "x".join(map(str, c)))
def test_tile_untile_match_jax(case):
    from vidmat.refine import tiling as jt

    h, w, t, v = case
    rng = np.random.RandomState(h + w)
    frame = rng.rand(2, h, w, 4).astype(np.float32)
    jl, tl = jt.TileLayout(*case), TileLayout(*case)
    want = np.asarray(jt.tile_frame(jnp.asarray(frame), jl))
    got = tile_frame(torch.from_numpy(frame), tl).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    tiles = rng.rand(*want.shape).astype(np.float32)
    want = np.asarray(jt.untile_frame(jnp.asarray(tiles), jl, 2))
    got = untile_frame(torch.from_numpy(tiles), tl, 2).numpy()
    assert got.shape == (2, h, w, 4)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _jax_body(s2d, **kw):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(space_to_depth=s2d)
    if kw.get("use_pallas", True):
        kw = dict(kw, use_pallas=True, pallas_interpret=True)
    body, plan = j_build(JNet(jcfg), jcfg, JRefineConfig("guided"), H, W,
                         RATIO, cdtype=jnp.float32, **kw)
    return jax.jit(body), plan


def _port_body(s2d, conv_impl="xla", **kw):
    cfg = ModelConfig(space_to_depth=s2d, conv_impl=conv_impl)
    net = build_network(cfg, default_variables(cfg))
    return build_serving_body(net, cfg, RefineConfig("guided"), H, W, RATIO,
                              cdtype=torch.float32, **kw)


def _bytes(out):
    """Comparable uint8 planes of a body's output."""
    if isinstance(out, tuple):  # the uint8 tuple: alpha, fgr, rgba
        return np.concatenate([np.asarray(o).reshape(-1) for o in out])
    a = np.asarray(out)
    return (a.view(np.uint8) if a.dtype == np.uint32 else a).reshape(-1)


# (s2d, options, what the port's plan must be)
TILED_BODIES = [
    (1, {}, "packed"),
    (2, {}, "packed"),
    (1, dict(alpha_only=True), "alpha_only"),
    (2, dict(float_output=True), "float"),
    (1, dict(use_pallas=False), "tuple"),
]


@pytest.mark.parametrize("case", range(len(TILED_BODIES)),
                         ids=lambda i: "-".join(
                             [f"s2d{TILED_BODIES[i][0]}",
                              TILED_BODIES[i][2]]))
def test_tiled_body_matches_jax(case):
    s2d, kw, kind = TILED_BODIES[case]
    kw = dict(kw, tile_size=TILE, tile_overlap=OVERLAP)
    jstep, jplan = _jax_body(s2d, **kw)
    body, plan = _port_body(s2d, **kw)
    assert (plan.packed, plan.alpha_only) == (jplan.packed, jplan.alpha_only)
    assert plan.packed == (kind in ("packed", "alpha_only"))
    jvars = jax.tree_util.tree_map(
        jnp.asarray, default_variables(ModelConfig(space_to_depth=s2d)))
    js, ts = jplan.make_state(1), plan.make_state(1)
    diffs = []
    for f, _ in synthetic_clip(H, W, 3, seed=11):
        jo, js = jstep(jvars, jnp.asarray(f[None]), js)
        to, ts = body(torch.from_numpy(f[None]), ts)
        if kind == "float":
            for j, t in zip(jo, to):
                diffs.append(np.abs(np.asarray(j) - t.numpy()).mean())
            continue
        if kind == "tuple":
            to = tuple(t.numpy() for t in to)
        else:
            to = to.numpy()
        diffs.append(np.abs(_bytes(jo).astype(int) - _bytes(to).astype(int)))
    if kind == "float":
        assert max(diffs) <= 1e-3, diffs
        return
    d = np.concatenate(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


@pytest.mark.parametrize("content", ["noise", "synthetic clip"])
def test_tiled_alpha_near_untiled(content):
    """The fused tiled tail against the untiled one. On a uniform-noise
    frame at JAX's own bound (tests/unit/test_fused_tiled_tail.py:62-65):
    max <= 3, mean < 0.05 LSB. On the moving-disk clip the tiles' edge
    statistics move more bytes, in the JAX package as in the port: the
    port's tiled-minus-untiled bytes equal the JAX package's within 4 (each
    body within 2 of its JAX counterpart)."""
    tiled, plan = _port_body(1, tile_size=TILE, tile_overlap=OVERLAP,
                             alpha_only=True)
    untiled, _ = _port_body(1, alpha_only=True)
    if content == "noise":
        f = torch.from_numpy(np.random.RandomState(0).randint(
            0, 255, (1, H, W, 3), np.uint8))
        a, _ = tiled(f, plan.make_state(1))
        b, _ = untiled(f, plan.make_state(1))
        d = (a.int() - b.int()).abs()
        assert int(d.max()) <= 3 and float(d.float().mean()) < 0.05, (
            int(d.max()), float(d.float().mean()))
        return
    jt, jplan = _jax_body(1, tile_size=TILE, tile_overlap=OVERLAP,
                          alpha_only=True)
    ju, _ = _jax_body(1, alpha_only=True)
    jvars = jax.tree_util.tree_map(jnp.asarray,
                                   default_variables(ModelConfig()))
    st = [plan.make_state(1), plan.make_state(1), jplan.make_state(1),
          jplan.make_state(1)]
    worst = 0
    for f, _ in synthetic_clip(H, W, 3, seed=11):
        x = torch.from_numpy(f[None])
        a, st[0] = tiled(x, st[0])
        b, st[1] = untiled(x, st[1])
        ja, st[2] = jt(jvars, jnp.asarray(f[None]), st[2])
        jb, st[3] = ju(jvars, jnp.asarray(f[None]), st[3])
        d_port = a.numpy().astype(int) - b.numpy().astype(int)
        d_jax = np.asarray(ja).astype(int) - np.asarray(jb).astype(int)
        worst = max(worst, int(np.abs(d_jax).max()))
        assert np.abs(d_port - d_jax).max() <= 4
    print(f"tiled vs untiled on the clip, JAX package: max |d| {worst}")
    assert worst > 3  # the clip is the case the noise bound does not cover


def test_misaligned_overlap_raises():
    """An overlap that is no multiple of the pool leaves the fused tails
    and the unfused tiled tail refuses it, as in the JAX package."""
    body, plan = _port_body(1, tile_size=TILE, tile_overlap=18)
    assert not plan.packed or plan.pool == 4
    f = torch.zeros((1, H, W, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="align with the coarse pool"):
        body(f, plan.make_state(1))


def test_tiled_chunk_body_equals_per_frame_body():
    """The tiled planar chunk body (4 frames) against 4 calls of the
    per-frame body. The batched encoder may sum in another order than
    batch 1 on the CPU; bytes agree to one LSB."""
    body, plan = _port_body(2, conv_impl="planar", tile_size=TILE,
                            tile_overlap=OVERLAP)
    assert plan.chunk_body is not None
    frames = np.stack([f for f, _ in synthetic_clip(H, W, 4, seed=4)])
    s1, s2 = plan.make_state(1), plan.make_state(1)
    chunk_out, s1 = plan.chunk_body(torch.from_numpy(frames), s1)
    outs = []
    for i in range(4):
        o, s2 = body(torch.from_numpy(frames[i:i + 1]), s2)
        outs.append(o)
    d = (chunk_out.view(torch.uint8).int()
         - torch.cat(outs).view(torch.uint8).int()).abs()
    assert int(d.max()) <= 1, int(d.max())


def _sessions(dtype, monkeypatch):
    from vidmat.api import MattingSession as JSession
    from vidmat.config import ModelConfig as JModelConfig

    from vidmat_torch import MattingSession

    if dtype == "bfloat16":
        # The JAX session's serving mode with its kernels interpreted, as
        # tests/test_torch_session.py runs it.
        from vidmat.pipeline import stepfactory

        orig = stepfactory.build_serving_body

        def patched(*a, **kw):
            kw["pallas_interpret"] = True
            kw.setdefault("use_pallas", True)
            return orig(*a, **kw)

        monkeypatch.setattr(stepfactory, "build_serving_body", patched)
        cfg = ModelConfig(space_to_depth=2, conv_impl="planar")
    else:
        cfg = ModelConfig()
    kw = dict(downsample_ratio=RATIO, dtype=dtype, tile_size=TILE,
              tile_overlap=OVERLAP)
    jsess = JSession(H, W, model_cfg=JModelConfig(
        space_to_depth=cfg.space_to_depth, conv_impl=cfg.conv_impl), **kw)
    return jsess, MattingSession(H, W, model_cfg=cfg, device="cpu", **kw)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-3),
                                         ("bfloat16", 2e-2)])
def test_tiled_session_matches_jax(dtype, bound, monkeypatch):
    jsess, sess = _sessions(dtype, monkeypatch)
    if dtype == "bfloat16":
        assert not sess._stepper._plan.packed
    mads = []
    for f in synthetic_frames_only(H, W, 3, seed=6):
        ja, jf = jsess.step(f)
        ta, tf = sess.step(f)
        mads.append(max(float(np.abs(ta - ja).mean()),
                        float(np.abs(tf - jf).mean())))
    assert max(mads) <= bound, mads


def test_convert_video_4k_preset_small_tiles():
    """video_4k's model and options (pool 8, the fused tiled tail, chunk
    1) through convert_video at 256x256 with a 64/16 tile, in float32,
    frame for frame against the JAX package's tiled body on the same
    options (kernels interpreted): alpha bytes mean <= 0.26 LSB, max <=
    2."""
    from vidmat_torch import convert_video, preset_video_4k

    mcfg, pcfg = preset_video_4k()
    assert (pcfg.tile_size, pcfg.tile_overlap, pcfg.downsample_ratio,
            pcfg.chunk_size) == (1024, 128, 0.125, 1)
    pcfg = dataclasses.replace(pcfg, tile_size=TILE, tile_overlap=OVERLAP,
                               dtype="float32")
    frames = list(synthetic_frames_only(H, W, 3, seed=2))
    alphas = []
    m = convert_video(frames, output_alpha=alphas.append, model_cfg=mcfg,
                      pipe_cfg=pcfg, device="cpu")
    assert m["frames"] == 3 and len(alphas) == 3
    assert alphas[0].shape == (H, W) and alphas[0].dtype == np.uint8

    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(space_to_depth=2)
    jbody, jplan = j_build(JNet(jcfg), jcfg, JRefineConfig("guided"), H, W,
                           pcfg.downsample_ratio, cdtype=jnp.float32,
                           use_pallas=True, pallas_interpret=True,
                           tile_size=TILE, tile_overlap=OVERLAP,
                           alpha_only=True)
    assert jplan.pool == 8 and jplan.alpha_only
    jstep = jax.jit(jbody)
    jvars = jax.tree_util.tree_map(jnp.asarray, default_variables(mcfg))
    js = jplan.make_state(1)
    diffs = []
    for f, got in zip(frames, alphas):
        jo, js = jstep(jvars, jnp.asarray(f[None]), js)
        diffs.append(np.abs(np.asarray(jo)[0].astype(int) - got))
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


@pytest.mark.parametrize("rows", [2160, 2176])
def test_video_4k_plan_matches_jax(rows):
    """video_4k's plan at the two 4K buckets against the JAX package's:
    the coarse grid snaps to 272x480 at both, an integer pool (8, the
    tiled fused tail) only of 2176 rows; 2160 takes the untiled guided
    tail in both packages."""
    from vidmat.config import preset_video_4k as j_preset
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    from vidmat_torch import preset_video_4k

    mcfg, pcfg = preset_video_4k()
    jm, jp = j_preset()
    kw = dict(tile_size=pcfg.tile_size, tile_overlap=pcfg.tile_overlap,
              alpha_only=True)
    _, jplan = j_build(JNet(jm), jm, jp.refine, rows, 3840,
                       jp.downsample_ratio, use_pallas=True,
                       pallas_interpret=True, **kw)
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16)
    _, plan = build_serving_body(net, mcfg, pcfg.refine, rows, 3840,
                                 pcfg.downsample_ratio, **kw)
    got = (plan.net_h, plan.net_w, plan.pool, plan.packed, plan.alpha_only,
           plan.state_h, plan.state_w)
    assert got == (jplan.net_h, jplan.net_w, jplan.pool, jplan.packed,
                   jplan.alpha_only, jplan.state_h, jplan.state_w)
    assert (plan.net_h, plan.net_w, plan.state_h) == (272, 480, 288)
    assert plan.pool == (8 if rows == 2176 else 0)
