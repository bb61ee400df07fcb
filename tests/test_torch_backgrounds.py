"""The port's background paths against the JAX package on the CPU:
background replacement (an image baked into the body, or one per call),
portrait blur, and the options of convert_video.

Kernels: the plain version of ``fused_refine_composite`` in its image and
coarse modes against the JAX kernel in interpret mode, bytes max <= 1
(the port's bilinear upsample goes columns first, the TPU kernel's rows
first; one LSB where a value sits on a rounding edge); ``box_blur``
against the JAX ``box_blur`` within 1e-6. Serving bodies: the JAX body
with its kernels in interpret mode (``use_pallas=True,
pallas_interpret=True``) against the port's on the plain versions, fp32,
over a few recurrent frames; packed bytes mean |d| <= 0.26 LSB and max
<= 2, as tests/test_torch_tails.py.
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


def _bytes(out):
    arr = np.asarray(out)
    return arr.view(np.uint8).astype(int) if arr.dtype == np.uint32 \
        else arr.astype(int)


# ---- kernels: plain versions against the Pallas kernel ----


@pytest.mark.parametrize("mode", ["image", "coarse"])
def test_refine_composite_plain_background_modes_match_jax(mode):
    from vidmat.ops.pallas.refine_kernel import \
        fused_refine_composite as j_refine

    from vidmat_torch.ops.refine import (background_mode,
                                         fused_refine_composite,
                                         fused_refine_composite_plain)

    rng = _rng(3)
    n, h, w, pool = 2, 64, 128, 4
    frame = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    a = (rng.rand(n, h // pool, w // pool, 4) * 2 - 0.5).astype(np.float32)
    b = (rng.rand(n, h // pool, w // pool, 4) - 0.5).astype(np.float32)
    # Slightly outside [0, 1]: the image is taken unclipped, the coarse
    # background is clipped after its upsample.
    shape = (h, w, 3) if mode == "image" else (n, h // pool, w // pool, 3)
    bg = (rng.rand(*shape) * 1.2 - 0.1).astype(np.float32)
    want = np.asarray(j_refine(jnp.asarray(frame), jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(bg), pool=pool,
                               interpret=True))
    args = (torch.from_numpy(frame), torch.from_numpy(a),
            torch.from_numpy(b), torch.from_numpy(bg), pool)
    assert background_mode(args[3], n, h, w, pool) == mode
    got = fused_refine_composite_plain(*args)
    assert got.dtype == torch.uint32 and got.shape == (n, h, w)
    # On CPU tensors the wrapper takes the plain version.
    assert torch.equal(fused_refine_composite(*args), got)
    d = np.abs(_bytes(got.numpy()) - _bytes(want))
    assert d.max() <= 1, (d.max(), (d > 0).mean())


def test_background_mode_by_rank_and_shape():
    from vidmat_torch.ops.refine import background_mode

    n, h, w, pool = 2, 16, 32, 4
    assert background_mode(None, n, h, w, pool) == "none"
    assert background_mode((0.0, 1.0, 0.0), n, h, w, pool) == "color"
    assert background_mode(np.zeros((h, w, 3)), n, h, w, pool) == "image"
    assert background_mode(np.zeros((n, 4, 8, 3)), n, h, w, pool) == "coarse"
    assert background_mode(np.zeros((n, h, w, 3)), n, h, w, pool) \
        == "per_frame"
    # At pool 1 a rank-4 background is coarse, as in the TPU kernel.
    assert background_mode(np.zeros((n, h, w, 3)), n, h, w, 1) == "coarse"
    with pytest.raises(ValueError):
        background_mode(np.zeros((n, 5, 8, 3)), n, h, w, pool)


@pytest.mark.parametrize("radius", [1, 4, 9])
def test_box_blur_matches_jax(radius):
    from vidmat.ops.guided_filter import box_blur as j_blur

    from vidmat_torch.ops.guided_filter import box_blur

    x = _rng(4).rand(2, 17, 30, 3).astype(np.float32)
    got = box_blur(torch.from_numpy(x), radius).numpy()
    np.testing.assert_allclose(got, np.asarray(j_blur(jnp.asarray(x),
                                                      radius)),
                               rtol=0, atol=1e-6)


# ---- serving bodies ----


def _jax_body(cfg, refine, h, w, ratio, **kw):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(space_to_depth=cfg.space_to_depth,
                        conv_impl=cfg.conv_impl)
    return j_build(JNet(jcfg), jcfg, JRefineConfig(refine.mode), h, w,
                   ratio, cdtype=jnp.float32, use_pallas=True,
                   pallas_interpret=True, **kw)


XLA2 = ModelConfig(space_to_depth=2)
PLANAR2 = ModelConfig(space_to_depth=2, conv_impl="planar")

CASES = {
    # fused packed tail, one image baked into the body (image mode)
    "image": (XLA2, 64, 128, 0.25, dict(bg="image")),
    # a background per call, the per-frame body (image mode)
    "dynamic": (XLA2, 64, 128, 0.25, dict(bg_dynamic=True)),
    # portrait blur on the fused packed tail (coarse mode)
    "blur": (XLA2, 64, 128, 0.25, dict(bg_blur=16)),
    # portrait blur with the static-scene fast path (a repeated frame)
    "blur_static": (XLA2, 64, 128, 0.25, dict(bg_blur=16,
                                            static_skip_eps=0.5 / 255)),
    # portrait blur with raw foreground: the float tail and the uint8
    # tuple, the blurred background upsampled and composited per frame
    "blur_need_fgr": (XLA2, 64, 128, 0.25, dict(bg_blur=16, need_fgr=True)),
    # portrait blur on the unfused guided tail (no integer pool):
    # composite_rgba_packed with per-frame images
    "blur_unfused": (ModelConfig(), 96, 128, 0.4, dict(bg_blur=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_body_backgrounds_match_jax(case):
    cfg, h, w, ratio, kw = CASES[case]
    refine = RefineConfig("guided")
    rng = _rng(5)
    image = rng.rand(h, w, 3).astype(np.float32)
    kw = dict(kw)
    if kw.get("bg") == "image":
        kw["bg"] = image
    jkw = {k: (jnp.asarray(v) if k == "bg" else v) for k, v in kw.items()}
    jbody, jplan = _jax_body(cfg, refine, h, w, ratio, **jkw)
    jbody = jax.jit(jbody)
    variables = default_variables(cfg)
    body, plan = build_serving_body(build_network(cfg, variables), cfg,
                                    refine, h, w, ratio,
                                    cdtype=torch.float32, **kw)
    for f in ("pool", "packed", "full", "static_skip"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.pool == (4 if ratio == 0.25 else 0)
    assert (plan.chunk_body is None) == (jplan.chunk_body is None)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    js, ts = jplan.make_state(1), plan.make_state(1)
    frames = [f for f, _ in synthetic_clip(h, w, 3, seed=7)]
    if kw.get("static_skip_eps"):
        frames.insert(2, frames[1])  # a static frame: the net is skipped
    diffs = []
    for i, f in enumerate(frames):
        extra = ()
        if kw.get("bg_dynamic"):
            extra = (rng.rand(1, h, w, 3).astype(np.float32),)
        jo, js = jbody(jvars, jnp.asarray(f[None]), js,
                       *map(jnp.asarray, extra))
        to, ts = body(torch.from_numpy(f[None]), ts,
                      *map(torch.from_numpy, extra))
        jo = jo if isinstance(jo, tuple) else (jo,)
        to = to if isinstance(to, tuple) else (to,)
        assert [t.shape for t in to] == [tuple(j.shape) for j in jo]
        diffs.append(np.concatenate(
            [np.abs(_bytes(j) - _bytes(t.numpy())).ravel()
             for j, t in zip(jo, to)]))
    if kw.get("static_skip_eps"):
        assert ts[1][3] == 1 and int(js[1][3]) == 1
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_blur_chunk_body_matches_jax():
    """Portrait blur through the planar chunk body (the chunk's blurred
    coarse backgrounds into the fused tail, coarse mode) against the JAX
    chunk body, two 4-frame chunks at 64x128."""
    h, w, k = 64, 128, 4
    refine = RefineConfig("guided")
    _, jplan = _jax_body(PLANAR2, refine, h, w, 0.25, bg_blur=16)
    _, plan = build_serving_body(
        build_network(PLANAR2, default_variables(PLANAR2)), PLANAR2, refine,
        h, w, 0.25, cdtype=torch.float32, bg_blur=16)
    assert plan.chunk_body is not None and jplan.chunk_body is not None
    jchunk = jax.jit(jplan.chunk_body)
    jvars = jax.tree_util.tree_map(jnp.asarray, default_variables(PLANAR2))
    frames = np.stack([f for f, _ in synthetic_clip(h, w, 2 * k, seed=8)])
    js, ts = jplan.make_state(1), plan.make_state(1)
    diffs = []
    for c in range(2):
        chunk = frames[c * k:(c + 1) * k]
        jo, js = jchunk(jvars, jnp.asarray(chunk[:, None]), js)
        to, ts = plan.chunk_body(torch.from_numpy(chunk), ts)
        diffs.append(np.abs(_bytes(np.asarray(jo)[:, 0])
                            - _bytes(to.numpy())))
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_blur_radius_rounds_half_to_even():
    """blur_rc = max(1, round(bg_blur * net_h / h)) with Python's round,
    as the JAX package: radius 10 at a quarter grid is 2.5 -> 2."""
    from vidmat_torch.ops import guided_filter

    seen = []
    orig = guided_filter.box_blur

    def spy(x, r):
        seen.append(r)
        return orig(x, r)

    import vidmat_torch.pipeline.stepfactory as sf

    sf.box_blur, saved = spy, sf.box_blur
    try:
        for blur, want in ((10, 2), (14, 4), (2, 1)):
            body, plan = build_serving_body(
                build_network(XLA2, default_variables(XLA2)), XLA2,
                RefineConfig(), 64, 128, 0.25, cdtype=torch.float32,
                bg_blur=blur)
            assert plan.pool == 4
            body(torch.zeros((1, 64, 128, 3), dtype=torch.uint8),
                 plan.make_state(1))
            assert seen[-1] == want, (blur, seen)
    finally:
        sf.box_blur = saved


# ---- convert_video: options, precedence, validation ----


def _convert(frames, **kw):
    from vidmat_torch import convert_video

    mcfg = ModelConfig(space_to_depth=2)
    pipe = PipelineConfig(downsample_ratio=0.25, dtype="float32")
    comps = []
    m = convert_video(frames, output_composition=comps.append,
                      model_cfg=mcfg, pipe_cfg=pipe, device="cpu", **kw)
    assert m["frames"] == len(frames) == len(comps)
    return np.stack(comps)


def test_background_precedence_as_jax():
    """bg_blur > bg_video > bg_image > bg_color
    (vidmat/pipeline/video.py:320-330)."""
    rng = _rng(6)
    frames = list(synthetic_frames_only(64, 128, 3, seed=9))
    image = rng.rand(64, 128, 3).astype(np.float32)
    video = [rng.rand(64, 128, 3).astype(np.float32) for _ in range(2)]
    color = (0.1, 0.2, 0.9)
    blur = _convert(frames, bg_blur=16)
    np.testing.assert_array_equal(
        _convert(frames, bg_blur=16, bg_video=video, bg_image=image,
                 bg_color=color), blur)
    vid = _convert(frames, bg_video=video)
    np.testing.assert_array_equal(
        _convert(frames, bg_video=video, bg_image=image, bg_color=color),
        vid)
    img = _convert(frames, bg_image=image)
    np.testing.assert_array_equal(
        _convert(frames, bg_image=image, bg_color=color), img)
    assert not np.array_equal(img, vid) and not np.array_equal(img, blur)


def test_bg_video_cycles_in_lockstep():
    """A 2-frame background clip over 5 frames at chunk 2 (the per-frame
    body, as a background video takes no chunk body; a partial last chunk
    drained): frame i composites over background i % 2, as one body call
    per frame with that background gives."""
    rng = _rng(7)
    h, w = 64, 128
    frames = list(synthetic_frames_only(h, w, 5, seed=10))
    video = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(2)]
    from vidmat_torch import convert_video

    mcfg = ModelConfig(space_to_depth=2)
    pipe = PipelineConfig(downsample_ratio=0.25, dtype="float32",
                          chunk_size=2)
    comps = []
    convert_video(iter(frames), output_composition=comps.append,
                  bg_video=iter(video), model_cfg=mcfg, pipe_cfg=pipe,
                  device="cpu")
    body, plan = build_serving_body(
        build_network(mcfg, default_variables(mcfg)), mcfg, RefineConfig(),
        h, w, 0.25, cdtype=torch.float32, bg_dynamic=True)
    assert plan.chunk_body is None
    st = plan.make_state(1)
    for i, f in enumerate(frames):
        bg = torch.from_numpy(video[i % 2].astype(np.float32) / 255.0)[None]
        out, st = body(torch.from_numpy(f[None]), st, bg)
        np.testing.assert_array_equal(
            out.numpy().view(np.uint8).reshape(h, w, 4), comps[i])


def test_background_options_apply_only_with_composition(monkeypatch):
    import vidmat_torch.pipeline.video as pv
    from vidmat_torch import convert_video

    seen = {}
    orig = pv.VideoPipeline.__init__

    def spy(self, **kw):
        seen.update(kw)
        orig(self, **kw)

    monkeypatch.setattr(pv.VideoPipeline, "__init__", spy)
    frames = list(synthetic_frames_only(32, 48, 1, seed=11))
    image = np.zeros((32, 48, 3), np.float32)
    convert_video(frames, output_alpha=lambda a: None, bg_image=image,
                  bg_blur=8, bg_video=[image], device="cpu")
    assert seen["bg_image"] is None and seen["bg_blur"] is None
    assert seen["bg_video"] is None and seen["bg_color"] is None


def test_background_validation_as_jax():
    net = build_network(XLA2, default_variables(XLA2))
    build = lambda **kw: build_serving_body(  # noqa: E731
        net, XLA2, RefineConfig(), 64, 128, 0.25, cdtype=torch.float32,
        **kw)
    with pytest.raises(ValueError, match="bg_dynamic"):
        build(bg=(0.0, 1.0, 0.0), bg_dynamic=True)
    with pytest.raises(ValueError, match="bg_blur"):
        build(bg=(0.0, 1.0, 0.0), bg_blur=8)
    with pytest.raises(ValueError, match="bg_blur"):
        build(bg_dynamic=True, bg_blur=8)
    with pytest.raises(ValueError, match="bg must be"):
        build(bg=np.zeros((32, 48, 3), np.float32))
    with pytest.raises(ValueError, match="bg_image"):
        from vidmat_torch.io.backgrounds import prepare_bg_image

        prepare_bg_image(np.zeros((32, 48)), 64, 96)


def test_bg_video_chunks_match_jax_loop():
    """K-deep background staging: convert_video with a 3-frame background
    video at chunk 4 over 6 frames (one full chunk of per-frame bodies,
    its 4 backgrounds sent as one chunk, then 2 frames drained) against
    the JAX loop on the same frames: its chunk step (a scan over (frame,
    background) pairs) for the full chunk and its per-frame step for the
    rest, the backgrounds from its own looping source. Composite bytes
    mean |d| <= 0.26 LSB, max <= 2."""
    import jax.numpy as jnp
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import PipelineConfig as JPipelineConfig
    from vidmat.pipeline.video import VideoPipeline as JPipeline
    from vidmat.pipeline.video import _BgFrameSource

    from vidmat_torch import convert_video

    rng = _rng(8)
    h, w, k = 64, 128, 4
    frames = list(synthetic_frames_only(h, w, 6, seed=12))
    video = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(3)]
    comps = []
    convert_video(frames, output_composition=comps.append, bg_video=video,
                  model_cfg=ModelConfig(space_to_depth=2),
                  pipe_cfg=PipelineConfig(downsample_ratio=0.25,
                                          dtype="float32", chunk_size=k),
                  device="cpu")
    jp = JPipeline(model_cfg=JModelConfig(space_to_depth=2),
                   pipe_cfg=JPipelineConfig(downsample_ratio=0.25,
                                            dtype="float32", chunk_size=k),
                   bg_video=video)
    step, chunk_step, plan = jp._build_step(h, w, 0.25)
    assert chunk_step is not None
    bg_src = _BgFrameSource(video, h, w)
    st = plan.make_state(1)
    outs, st = chunk_step(
        jp.variables, jnp.asarray(np.stack([f[None] for f in frames[:k]])),
        jnp.asarray(np.stack([bg_src.next() for _ in range(k)])), st)
    # Without its kernels (the CPU) the JAX body emits (alpha, fgr, rgba).
    want = [np.asarray(outs[2])[i, 0] for i in range(k)]
    for f in frames[k:]:
        o, st = step(jp.variables, jnp.asarray(f[None]), st,
                     jnp.asarray(bg_src.next()))
        want.append(np.asarray(o[2])[0])
    want = np.stack(want)
    d = np.abs(np.stack(comps).astype(int) - want.astype(int))
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())
