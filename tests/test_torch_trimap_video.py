"""Trimap video, mask sources and the segmentation output of the port
against the JAX package on the CPU.

Bodies: the port's plain PyTorch kernel versions against the JAX body
with its Pallas kernels interpreted on the ``conv_impl="xla"`` net
(trimap_prop_demo, fp32, 128x192, ratio 0.25): packed bytes mean |d| <=
0.26 LSB, max <= 2. ``convert_video`` with ``trimap_source`` (a keyframe,
a per-frame stream, trimmed) and ``mask_source``: both packages on the
branch without kernels (``use_pallas=False``, fp32), alpha frame for
frame, the same bar. Sessions: fp32 parity MAD <= 1e-3 per frame. The
segmentation body on seg_demo: sigmoid max |d| <= 1e-4 in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_clip
from vidmat_torch.models.weights import (build_network, default_variables,
                                         seg_default_variables)
from vidmat_torch.pipeline.stepfactory import build_serving_body

H, W, RATIO = 128, 192, 0.25
PROP = ModelConfig(use_trimap=True, space_to_depth=2)
PIPE = PipelineConfig(downsample_ratio=RATIO, dtype="float32",
                      use_pallas=False)


def _clip(n, seed=0, offset=0):
    """n frames, their trimaps (uint8 {0, 128, 255}) and rough masks."""
    frames, tris, masks = [], [], []
    for f, a in list(synthetic_clip(H, W, n + offset, seed=seed))[offset:]:
        a = a[..., 0]
        frames.append(f)
        tris.append(np.where(a > 0.99, 255, np.where(a < 0.01, 0, 128))
                    .astype(np.uint8))
        masks.append((a > 0.5).astype(np.uint8) * 255)
    return frames, tris, masks


def _bytes_close(want, got):
    d = np.abs(np.stack(want).astype(int) - np.stack(got).astype(int))
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_trimap_serving_body_matches_jax():
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(use_trimap=True, space_to_depth=2)
    jbody, jplan = j_build(JNet(jcfg), jcfg, JRefineConfig("guided"), H, W,
                           RATIO, cdtype=jnp.float32, use_pallas=True,
                           pallas_interpret=True)
    variables = default_variables(PROP)
    body, plan = build_serving_body(build_network(PROP, variables), PROP,
                                    RefineConfig("guided"), H, W, RATIO,
                                    cdtype=torch.float32)
    assert plan.packed and jplan.packed and plan.pool == jplan.pool == 4
    jstep = jax.jit(jbody)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    frames, tris, _ = _clip(4, seed=1)
    js, ts = jplan.make_state(1), plan.make_state(1)
    want, got = [], []
    for i, (f, t) in enumerate(zip(frames, tris)):
        if i:
            t = np.full_like(t, 128)  # keyframe, then all-unknown
        x = np.concatenate([f, t[..., None]], -1)[None]
        jo, js = jstep(jvars, jnp.asarray(x), js)
        to, ts = body(torch.from_numpy(x), ts)
        want.append(np.asarray(jo).view(np.uint8))
        got.append(to.numpy().view(np.uint8))
    _bytes_close(want, got)


@pytest.mark.parametrize("family", ["keyframe", "per-frame"])
def test_trimap_session_matches_jax(family):
    """MattingSession.step(frame, trimap), fp32 parity: the propagation
    family with a keyframe trimap on frames 0 and 2 (the session fills
    all-unknown in between), and the per-frame family."""
    from vidmat.api import MattingSession as JSession
    from vidmat.config import ModelConfig as JModelConfig

    from vidmat_torch import MattingSession

    kw = (dict(space_to_depth=2) if family == "keyframe"
          else dict(recurrent=False))
    jsess = JSession(H, W, model_cfg=JModelConfig(use_trimap=True, **kw),
                     downsample_ratio=RATIO)
    sess = MattingSession(H, W, model_cfg=ModelConfig(use_trimap=True, **kw),
                          downsample_ratio=RATIO, device="cpu")
    frames, tris, _ = _clip(4, seed=2)
    mads = []
    for i, (f, t) in enumerate(zip(frames, tris)):
        t = t if family == "per-frame" or i in (0, 2) else None
        ja, jf = jsess.step(f, t)
        ta, tf = sess.step(f, t)
        mads.append(max(float(np.abs(ta - ja).mean()),
                        float(np.abs(tf - jf).mean())))
    assert max(mads) <= 1e-3, mads


class _Collect:
    """A JAX package video writer that keeps the frames it is given."""

    frames = {}

    def __init__(self, path, fps=30.0):
        self.path = path
        _Collect.frames[path] = []

    def write(self, frame):
        _Collect.frames[self.path].append(np.array(frame))

    def close(self):
        pass


@pytest.fixture
def jax_collect(monkeypatch):
    import vidmat.io.writer
    import vidmat.pipeline.video

    _Collect.frames = {}
    monkeypatch.setattr(vidmat.pipeline.video, "VideoWriter", _Collect)
    monkeypatch.setattr(vidmat.io.writer, "VideoWriter", _Collect)
    return _Collect.frames


# name -> (source kind, start_frame, max_frames)
SOURCES = {"keyframe trimap": ("trimap", "keyframe", 0, None),
           "per-frame trimaps": ("trimap", "stream", 0, None),
           "per-frame trimaps, trimmed": ("trimap", "stream", 1, 3),
           "keyframe mask": ("mask", "keyframe", 0, None),
           "per-frame masks, trimmed": ("mask", "stream", 2, 2)}


@pytest.mark.parametrize("name", list(SOURCES))
def test_convert_video_trimap_sources_match_jax(name, jax_collect):
    import vidmat
    from vidmat.config import PipelineConfig as JPipelineConfig

    import vidmat_torch

    kind, shape, start, count = SOURCES[name]
    frames, tris, masks = _clip(5, seed=3)
    src = tris if kind == "trimap" else masks
    src = src[0] if shape == "keyframe" else list(src)
    key = "trimap_source" if kind == "trimap" else "mask_source"
    trim = dict(start_frame=start, max_frames=count)
    got = []
    m = vidmat_torch.convert_video(frames, output_alpha=got.append,
                                   pipe_cfg=PIPE, device="cpu",
                                   **{key: src}, **trim)
    vidmat.convert_video(frames, output_alpha="alpha",
                         pipe_cfg=JPipelineConfig(downsample_ratio=RATIO,
                                                  dtype="float32",
                                                  use_pallas=False),
                         **{key: src}, **trim)
    # The JAX package's tuple path hands its writer (H, W, 1) planes.
    want = [a.reshape(H, W) for a in jax_collect["alpha"]]
    n = len(frames) - start if count is None else count
    assert m["frames"] == len(got) == len(want) == n
    _bytes_close(want, got)


def test_trimap_stream_ended_raises(jax_collect):
    """The per-frame family needs a trimap for every frame; the
    propagation family goes on over all-unknown trimaps."""
    import vidmat

    import vidmat_torch

    frames, tris, _ = _clip(3, seed=4)
    for conv, kw in ((vidmat.convert_video, {}),
                     (vidmat_torch.convert_video, dict(device="cpu"))):
        with pytest.raises(ValueError, match="trimap stream ended"):
            conv(frames, trimap_source=tris[:2], downsample_ratio=1.0,
                 **kw)
    got = []
    m = vidmat_torch.convert_video(
        frames, output_alpha=got.append, trimap_source=tris[:2],
        model_cfg=PROP, pipe_cfg=PIPE, device="cpu")
    assert m["frames"] == len(got) == 3
    with pytest.raises(ValueError, match="not trimap-conditioned"):
        vidmat_torch.convert_video(frames, trimap_source=tris,
                                   model_cfg=ModelConfig(), device="cpu")
    with pytest.raises(ValueError, match="needs trimaps"):
        vidmat_torch.convert_video(frames, model_cfg=PROP, device="cpu")


def test_seg_body_matches_jax():
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    cfg = ModelConfig()
    variables = seg_default_variables(cfg)
    jbody, jplan = j_build(JNet(JModelConfig()), JModelConfig(),
                           JRefineConfig("guided"), H, W, RATIO,
                           cdtype=jnp.float32, use_pallas=False,
                           output_seg=True)
    body, plan = build_serving_body(build_network(cfg, variables), cfg,
                                    RefineConfig("guided"), H, W, RATIO,
                                    cdtype=torch.float32, output_seg=True,
                                    use_pallas=False)
    jstep = jax.jit(jbody)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    js, ts = jplan.make_state(1), plan.make_state(1)
    worst = 0.0
    with jax.default_matmul_precision("float32"):
        for f, _ in synthetic_clip(H, W, 3, seed=5):
            jo, js = jstep(jvars, jnp.asarray(f[None]), js)
            to, ts = body(torch.from_numpy(f[None]), ts)
            assert to.shape == (1, H, W, 1) and to.dtype == torch.float32
            worst = max(worst, float(np.abs(np.asarray(jo)
                                            - to.numpy()).max()))
    assert worst <= 1e-4, worst


def test_segmentation_outputs_match_jax(jax_collect):
    """convert_video(output_segmentation=) and MattingSession(output=
    "seg") on seg_demo, float32 on the CPU as the JAX package runs
    there: the mask bytes within 1, the session's masks MAD <= 1e-3."""
    import vidmat

    import vidmat_torch

    frames, _, _ = _clip(3, seed=6)
    got = []
    m = vidmat_torch.convert_video(frames, output_segmentation=got.append,
                                   downsample_ratio=RATIO, device="cpu")
    vidmat.convert_video(frames, output_segmentation="seg",
                         downsample_ratio=RATIO)
    want = jax_collect["seg"]
    assert m["frames"] == len(got) == len(want) == 3
    assert got[0].shape == (H, W, 3) and got[0].dtype == np.uint8
    d = np.abs(np.stack(want).astype(int) - np.stack(got))
    assert d.max() <= 1, d.max()
    with pytest.raises(ValueError, match="separate convert_video"):
        vidmat_torch.convert_video(frames, output_alpha=got.append,
                                   output_segmentation=got.append,
                                   device="cpu")
    jsess = vidmat.MattingSession(H, W, downsample_ratio=RATIO,
                                  output="seg")
    sess = vidmat_torch.MattingSession(H, W, downsample_ratio=RATIO,
                                       output="seg", device="cpu")
    for f in frames:
        jm, jn = jsess.step(f)
        tm, tn = sess.step(f)
        assert jn is None and tn is None and tm.shape == (H, W, 1)
        assert float(np.abs(tm - jm).mean()) <= 1e-3


@pytest.mark.parametrize("what", ["trimap pin", "seg pass"])
def test_planar_trimap_and_seg_match_matting_network(what):
    """The planar net (plain versions, fp32) against the port's
    MattingNetwork on the same weights: trimap_prop_demo with a trimap
    channel, seg_demo's segmentation pass (through the fused d0 +
    seg_head site). Max |d| <= 1e-4 over 3 recurrent frames."""
    if what == "trimap pin":
        cfg, variables, c, kw = PROP, default_variables(PROP), 4, {}
    else:
        cfg = ModelConfig()
        variables, c = seg_default_variables(cfg), 3
    planar = build_network(dataclasses.replace(cfg, conv_impl="planar"),
                           variables)
    ref = build_network(cfg, variables)
    rng = np.random.RandomState(7)
    ps = planar.init_state(1, 64, 96)
    rs = None
    worst = 0.0
    with torch.inference_mode():
        for _ in range(3):
            x = rng.rand(1, 64, 96, c).astype(np.float32)
            if c == 4:
                x[..., 3] = rng.choice([0.0, 128 / 255, 1.0], (1, 64, 96))
            x = torch.from_numpy(x)
            if what == "seg pass":
                pa, _, ps = planar(x, ps, plain=True, seg=True)
                ra, _, rs = ref(x, rs, seg_pass=True)
            else:
                pa, pf, ps = planar(x, ps, plain=True)
                ra, rf, rs = ref(x, rs)
                worst = max(worst, float((pf - rf).abs().max()))
            worst = max(worst, float((pa - ra).abs().max()))
    assert worst <= 1e-4, worst
