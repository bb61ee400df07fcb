"""The port's refine tails, composite and unfused serving bodies against
the JAX package on the CPU, and the port's default configuration.

Kernels: the port's plain versions against the JAX package's Pallas
kernels in interpret mode (``fused_refine_float`` atol 1e-5, as
tests/unit/test_fused_tiled_tail.py; ``composite_rgba_packed`` bit-exact in
all four modes, as tests/unit/test_pallas_kernels.py; ``guided_upsample``
atol 1e-5). Serving bodies: the JAX body with its kernels in interpret mode
(``use_pallas=True, pallas_interpret=True``) against the port's on the
plain versions, fp32, over a few recurrent frames; packed bytes mean |d|
<= 0.26 LSB (1e-3 * 255) and max <= 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_clip, synthetic_frames_only
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.pipeline.stepfactory import build_serving_body


def _rng(seed):
    return np.random.RandomState(seed)


# ---- kernels: plain versions against the Pallas kernels ----


# (n, h, w, pool): the pools the session runs (4 at ratio 0.25, 2 at 0.5)
# and 8, and one frame whose width leaves the kernel's last warp strip
# ragged (300 = 2 x 124 + 52).
@pytest.mark.parametrize("n,h,w,pool", [(2, 64, 128, 4), (2, 64, 128, 2),
                                        (2, 64, 128, 8), (1, 36, 300, 4)])
def test_fused_refine_float_plain_matches_jax(n, h, w, pool):
    from vidmat.ops.pallas.refine_kernel import fused_refine_float as j_rf

    from vidmat_torch.ops.refine import fused_refine_float_plain

    rng = _rng(0)
    frame = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    hl, wl = h // pool, w // pool
    a = (rng.rand(n, hl, wl, 4) * 2 - 0.5).astype(np.float32)
    b = (rng.rand(n, hl, wl, 4) - 0.5).astype(np.float32)
    ja, jf = j_rf(jnp.asarray(frame), jnp.asarray(a), jnp.asarray(b),
                  pool=pool, interpret=True)
    ta, tf = fused_refine_float_plain(torch.from_numpy(frame),
                                      torch.from_numpy(a),
                                      torch.from_numpy(b), pool)
    assert ta.shape == (n, h, w, 1) and tf.shape == (n, h, w, 3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)


# 37x53: h w mod 4 != 0, so the kernel's 4-pixel groups straddle frames.
# The Pallas kernel computes whole 8-row tiles only (its grid is h // 8
# there), so every row is held to the JAX package's XLA composite, the
# function the Pallas kernel packs, and the tiled rows to the kernel.
@pytest.mark.parametrize("h,w", [(24, 136), (37, 53)])
@pytest.mark.parametrize("mode", ["color", "none", "image", "per_frame"])
def test_composite_packed_plain_matches_jax(mode, h, w):
    from vidmat.ops.composite import composite_rgba as j_rgba
    from vidmat.ops.pallas import composite_rgba_packed as j_comp

    from vidmat_torch.ops.composite import composite_rgba_packed_plain

    rng = _rng(1)
    n = 2
    fgr = rng.rand(n, h, w, 3).astype(np.float32)
    # Alpha slightly outside [0, 1]: the RGB term takes it unclipped.
    alpha = (rng.rand(n, h, w, 1) * 1.2 - 0.1).astype(np.float32)
    bg = {"color": np.array([0.2, 0.9, 0.4], np.float32), "none": None,
          "image": rng.rand(h, w, 3).astype(np.float32),
          "per_frame": rng.rand(n, h, w, 3).astype(np.float32)}[mode]
    jbg = None if bg is None else jnp.asarray(bg)
    tiled = np.asarray(j_comp(jnp.asarray(fgr), jnp.asarray(alpha), jbg,
                              interpret=True))[:, :h // 8 * 8]
    rgba = np.asarray(j_rgba(jnp.asarray(fgr), jnp.asarray(alpha), jbg))
    got = composite_rgba_packed_plain(
        torch.from_numpy(fgr), torch.from_numpy(alpha),
        None if bg is None else torch.from_numpy(bg))
    assert got.dtype == torch.uint32 and got.shape == (n, h, w)
    got = got.numpy().view(np.uint8).reshape(n, h, w, 4)
    for want in (tiled.view(np.uint8).reshape(n, -1, w, 4), rgba):
        d = np.abs(got[:, :want.shape[1]].astype(int) - want.astype(int))
        assert d.max() == 0, (d.max(), (d > 0).sum())


def test_guided_upsample_matches_jax():
    from vidmat.ops.guided_filter import guided_upsample as j_gu

    from vidmat_torch.ops.guided_filter import guided_upsample

    rng = _rng(2)
    rgb = rng.rand(1, 96, 128, 3).astype(np.float32)
    alpha = rng.rand(1, 32, 48, 1).astype(np.float32)
    fgr = rng.rand(1, 32, 48, 3).astype(np.float32)
    ja, jf = j_gu(jnp.asarray(rgb), jnp.asarray(alpha), jnp.asarray(fgr),
                  4, 1e-4, impl="pallas", interpret=True)
    for kernels in (True, False):
        ta, tf = guided_upsample(torch.from_numpy(rgb),
                                 torch.from_numpy(alpha),
                                 torch.from_numpy(fgr), 4, 1e-4,
                                 kernels=kernels)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-5)


# ---- serving bodies: the unfused tails and the raw-foreground tuple ----


def _jax_body(cfg, refine, h, w, ratio, **kw):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(space_to_depth=cfg.space_to_depth,
                        conv_impl=cfg.conv_impl)
    body, plan = j_build(JNet(jcfg), jcfg, JRefineConfig(refine.mode), h, w,
                         ratio, cdtype=jnp.float32, use_pallas=True,
                         pallas_interpret=True, **kw)
    return jax.jit(body), plan


def _bytes(out):
    """Integer bytes of a body output (packed words or uint8 tensors)."""
    arr = np.asarray(out)
    return arr.view(np.uint8).astype(int) if arr.dtype == np.uint32 \
        else arr.astype(int)


CASES = {
    # clip_480p's branch: the planar net at full resolution, no refinement
    "full_res_planar": (ModelConfig(conv_impl="planar"), "none", 64, 96,
                        1.0, {}),
    # bilinear upsample of the coarse mattes
    "ratio_0.5_none": (ModelConfig(), "none", 96, 128, 0.5, {}),
    # guided refinement at a coarse grid that is no integer pool
    "ratio_0.4_guided": (ModelConfig(), "guided", 96, 128, 0.4,
                         dict(bg=(0.0, 1.0, 0.0))),
    # raw foreground: fused_refine_float, then the uint8 tuple
    "need_fgr": (ModelConfig(space_to_depth=2), "guided", 128, 192, 0.25,
                 dict(need_fgr=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_body_tails_match_jax(case):
    cfg, mode, h, w, ratio, kw = CASES[case]
    refine = RefineConfig(mode)
    jbody, jplan = _jax_body(cfg, refine, h, w, ratio,
                             **{k: (jnp.asarray(v, jnp.float32) if k == "bg"
                                    else v) for k, v in kw.items()})
    variables = default_variables(cfg)
    body, plan = build_serving_body(build_network(cfg, variables), cfg,
                                    refine, h, w, ratio,
                                    cdtype=torch.float32, **kw)
    for f in ("pool", "packed", "full", "net_h", "net_w", "state_h",
              "state_w", "static_skip"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.chunk_body is None and jplan.chunk_body is None
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    js, ts = jplan.make_state(1), plan.make_state(1)
    diffs = []
    for f, _ in synthetic_clip(h, w, 3, seed=7):
        jo, js = jbody(jvars, jnp.asarray(f[None]), js)
        to, ts = body(torch.from_numpy(f[None]), ts)
        jo = jo if isinstance(jo, tuple) else (jo,)
        to = to if isinstance(to, tuple) else (to,)
        assert [t.shape for t in to] == [tuple(j.shape) for j in jo]
        diffs.append(np.concatenate(
            [np.abs(_bytes(j) - _bytes(t.numpy())).ravel()
             for j, t in zip(jo, to)]))
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


@pytest.mark.parametrize("s2d", [1, 2])
def test_planar_net_hands_kernels_contiguous_planes(monkeypatch, s2d):
    """The CUDA wrappers refuse non-contiguous planes, which the plain
    versions the CPU runs accept: every planar call of the bf16 net (the
    full-resolution s2d=1 net of clip_480p too) gets contiguous inputs."""
    import vidmat_torch.models.planar as pm

    seen = []

    def recorder(key, fn):
        def rec(*args):
            planes = args[0] if key != "gru" else args[:2]
            seen.append((key, [t.is_contiguous() for t in planes]))
            return fn(*args)
        return rec

    for key, fn in list(pm._PLAIN.items()):
        monkeypatch.setitem(pm._PLAIN, key, recorder(key, fn))
    cfg = ModelConfig(space_to_depth=s2d, conv_impl="planar")
    net = build_network(cfg, default_variables(cfg), dtype=torch.bfloat16)
    frame = torch.from_numpy(
        next(synthetic_frames_only(64, 96, 1, seed=8))[None]).float() / 255
    with torch.inference_mode():
        net(frame.to(torch.bfloat16), None, plain=True)
    assert len(seen) == 9, seen
    assert all(all(c) for _, c in seen), seen


def test_non_integer_ingest_casts_before_resizing():
    """At a ratio that is no integer pool, ingest casts the frame to the
    compute dtype and resizes in it (vidmat/pipeline/stepfactory.py:401):
    the coarse frame the net sees equals the JAX package's to a bf16 unit,
    and it is nearer to it than the frame resized in float32 and cast
    after. (The JAX package also rounds its resize weights and the
    intermediate of its two contractions to bf16, the port resizes bf16
    values in float32: one bf16 unit apart at most.)"""
    from vidmat.ops.resize import resize_bilinear as j_resize

    from vidmat_torch.models.matting_net import MattingNetwork

    seen = []
    net = build_network(ModelConfig(), default_variables(ModelConfig()),
                        dtype=torch.bfloat16)
    orig = MattingNetwork.forward

    def spy(self, frame, state=None):
        seen.append(frame)
        return orig(self, frame, state)

    frame = next(synthetic_frames_only(96, 128, 1, seed=9))[None]
    body, plan = build_serving_body(net, ModelConfig(), RefineConfig(),
                                    96, 128, 0.4)
    assert plan.pool == 0 and not plan.full
    MattingNetwork.forward = spy
    try:
        body(torch.from_numpy(frame), plan.make_state(1))
    finally:
        MattingNetwork.forward = orig
    got = seen[0].float().numpy()
    x = jnp.asarray(frame).astype(jnp.float32) * (1.0 / 255.0)
    want = np.asarray(j_resize(x.astype(jnp.bfloat16), 32, 48), np.float32)
    late = np.asarray(j_resize(x, 32, 48).astype(jnp.bfloat16), np.float32)
    assert got.shape == want.shape
    unit = 2.0 ** -7 * np.abs(want)  # one bf16 unit in the last place
    assert (np.abs(got - want) <= unit + 1e-7).all()
    assert np.abs(got - want).mean() < np.abs(late - want).mean()


# ---- the port's defaults are the JAX package's ----


def test_default_configs_equal_jax():
    import dataclasses

    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import PipelineConfig as JPipelineConfig
    from vidmat.config import preset_clip_480p as j_clip
    from vidmat.config import preset_video_1080p as j_1080

    from vidmat_torch.config import preset_clip_480p, preset_video_1080p
    from vidmat_torch.pipeline.video import VideoPipeline

    def same(port, ref):
        for f in dataclasses.fields(port):
            a, b = getattr(port, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(a):
                same(a, b)
            else:
                assert a == b, (type(port).__name__, f.name, a, b)

    pipe = VideoPipeline(device="cpu")
    same(pipe.model_cfg, JModelConfig())
    same(pipe.pipe_cfg, JPipelineConfig())
    assert pipe.model_cfg == ModelConfig() and pipe.pipe_cfg == PipelineConfig()
    for port, ref in ((preset_video_1080p(), j_1080()),
                      (preset_clip_480p(), j_clip())):
        same(port[0], ref[0])
        same(port[1], ref[1])


def test_default_convert_video_matches_jax_body():
    """convert_video with no configuration against the JAX serving body
    built from ModelConfig() / PipelineConfig() (synthetic_demo, auto
    ratio, bfloat16; at 96x128 the net runs at full resolution and
    composite_rgba_packed packs), alpha bytes, over 4 frames. The
    configuration is bfloat16, so the bar is the bf16 serving bar (alpha
    MAD <= 2e-2 per frame, tests/parity/test_planar_parity.py); the bytes
    also meet the fp32 bodies' mean |d| <= 0.26 LSB (single bytes differ
    by a few LSB where the two frameworks round a bf16 conv output
    differently)."""
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import PipelineConfig as JPipelineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.models.weights import default_variables as j_default
    from vidmat.pipeline.stepfactory import build_serving_body as j_build
    from vidmat.pipeline.video import auto_downsample_ratio

    from vidmat_torch import convert_video

    h, w = 96, 128
    frames = list(synthetic_frames_only(h, w, 4, seed=4))
    alphas = []
    convert_video(frames, output_alpha=alphas.append, device="cpu")

    jcfg, jpipe = JModelConfig(), JPipelineConfig()
    assert jpipe.dtype == "bfloat16" and jpipe.downsample_ratio is None
    jbody, jplan = j_build(
        JNet(jcfg, dtype=jnp.bfloat16), jcfg, jpipe.refine, h, w,
        auto_downsample_ratio(h, w), cdtype=jnp.bfloat16, use_pallas=True,
        pallas_interpret=True, alpha_only=True)
    assert jplan.full and jplan.alpha_only
    jstep = jax.jit(jbody)
    jvars = jax.tree_util.tree_map(jnp.asarray, j_default(jcfg))
    js = jplan.make_state(1)
    diffs = []
    for f, got in zip(frames, alphas):
        jo, js = jstep(jvars, jnp.asarray(f[None]), js)
        diffs.append(np.abs(np.asarray(jo)[0].astype(int)
                            - got.astype(int)))
    d = np.stack(diffs)
    assert d.mean(axis=(1, 2)).max() / 255.0 <= 2e-2
    assert d.mean() <= 0.26, d.mean()
