"""The clean-plate family (``plate_demo``: use_bg_plate, s2d=2) in the
port against the JAX package on the CPU.

The plate is an input of the net, never a background: ingested once as
the frames are and appended to the net's input, while the guide, the
tails, the composite and the static-skip delta see the frame alone.
Serving bodies: the JAX body with its kernels in interpret mode against
the port's on the plain versions over a few recurrent frames of the
camouflage clip (synthetic_plate_clip); packed bytes mean |d| <= 0.26 LSB
and max <= 2, as tests/test_torch_tails.py, in bf16 on the planar net
and in fp32 on the F.conv2d net. Sessions in the fp32 parity mode: alpha
and fgr within the parity bar, MAD <= 1e-3 per frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_plate_clip
from vidmat_torch.models.weights import (build_network, default_variables,
                                         plate_default_config)
from vidmat_torch.pipeline.stepfactory import build_serving_body

PLATE = plate_default_config()
PLATE_PLANAR = ModelConfig(use_bg_plate=True, space_to_depth=2,
                           conv_impl="planar")


def _clip(h, w, n, seed=0):
    frames, alphas, plates = zip(*synthetic_plate_clip(h, w, n, seed=seed))
    return np.stack(frames), np.stack(alphas), plates[0]


@pytest.mark.parametrize("kw", [{}, dict(camouflage=False,
                                         plate_jitter=0.05)])
def test_plate_clip_equals_jax(kw):
    from vidmat.io.fixtures import synthetic_plate_clip as j_clip

    for got, want in zip(synthetic_plate_clip(40, 56, 3, seed=2, **kw),
                         j_clip(40, 56, 3, seed=2, **kw)):
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype
            np.testing.assert_array_equal(g, w_)


def test_plate_demo_loads_into_both_nets():
    """plate_demo's 24 packed input channels (RGB + plate RGB, 2x2
    space-to-depth) reach the stem and the d0 cond of both nets, and the
    two nets agree on a 6-channel input in fp32."""
    from vidmat_torch.models.weights import default_checkpoint_path

    assert PLATE.in_channels == 6
    assert default_checkpoint_path(PLATE).endswith("plate_demo.npz")
    variables = default_variables(PLATE)
    net = build_network(PLATE, variables)
    pnet = build_network(PLATE_PLANAR, variables)
    d1_out = PLATE.dec_channels[2]  # a and h of the last decoder stage
    assert net.encoder.stem.conv.weight.shape[1] == 24
    assert pnet.stem_w.shape[1] == 24
    assert net.d0.conv.weight.shape[1] == d1_out + 24
    assert pnet.d0_w.shape[1] == d1_out + 24
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 64, 96, 6).astype(np.float32))
    with torch.inference_mode():
        a, f, _ = net(x, None)
        pa, pf, _ = pnet(x, None, plain=True)
    assert float((a - pa).abs().mean()) < 1e-5
    assert float((f - pf).abs().mean()) < 1e-5


def _jax_body(cfg, h, w, ratio, cdtype, plate, **kw):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(use_bg_plate=True, space_to_depth=2,
                        conv_impl=cfg.conv_impl)
    return j_build(JNet(jcfg, dtype=cdtype if cdtype == jnp.bfloat16
                        else None), jcfg, JRefineConfig("guided"), h, w,
                   ratio, cdtype=cdtype, use_pallas=True,
                   pallas_interpret=True, bg_plate=jnp.asarray(plate), **kw)


def test_plate_chunk_body_bf16_planar_matches_jax():
    """plate_demo on the planar net in bf16 through the chunk body (the
    plate broadcast over the chunk), one 4-frame chunk at 64x128."""
    h, w, k = 64, 128, 4
    frames, _, plate = _clip(h, w, k, seed=1)
    _, jplan = _jax_body(PLATE_PLANAR, h, w, 0.25, jnp.bfloat16, plate,
                         bg=jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    net = build_network(PLATE_PLANAR, default_variables(PLATE_PLANAR),
                        dtype=torch.bfloat16)
    _, plan = build_serving_body(net, PLATE_PLANAR, RefineConfig(), h, w,
                                 0.25, bg=(0.0, 1.0, 0.0), bg_plate=plate)
    assert plan.chunk_body is not None and jplan.chunk_body is not None
    jvars = jax.tree_util.tree_map(jnp.asarray,
                                   default_variables(PLATE_PLANAR))
    jo, _ = jax.jit(jplan.chunk_body)(jvars, jnp.asarray(frames[:, None]),
                                      jplan.make_state(1))
    to, _ = plan.chunk_body(torch.from_numpy(frames), plan.make_state(1))
    d = np.abs(np.asarray(jo)[:, 0].view(np.uint8).astype(int)
               - to.numpy().view(np.uint8).astype(int))
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_plate_body_fp32_matches_jax():
    """plate_demo as F.conv2d in fp32 through the per-frame body (the
    fused packed tail, no background), 3 frames at 64x128."""
    h, w = 64, 128
    frames, _, plate = _clip(h, w, 3, seed=2)
    jbody, jplan = _jax_body(PLATE, h, w, 0.25, jnp.float32, plate)
    body, plan = build_serving_body(
        build_network(PLATE, default_variables(PLATE)), PLATE,
        RefineConfig(), h, w, 0.25, cdtype=torch.float32, bg_plate=plate)
    jbody = jax.jit(jbody)
    jvars = jax.tree_util.tree_map(jnp.asarray, default_variables(PLATE))
    js, ts = jplan.make_state(1), plan.make_state(1)
    diffs = []
    for f in frames:
        jo, js = jbody(jvars, jnp.asarray(f[None]), js)
        to, ts = body(torch.from_numpy(f[None]), ts)
        diffs.append(np.abs(np.asarray(jo).view(np.uint8).astype(int)
                            - to.numpy().view(np.uint8).astype(int)))
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_plate_never_reaches_the_composite(monkeypatch):
    """The fused tail gets the frame's own bytes, the guide comes from the
    ingested frame alone and the static-skip reference holds 3 channels:
    a body that handed the plate (or the frame-plus-plate net input) to
    any of them fails here."""
    import vidmat_torch.pipeline.stepfactory as sf
    from vidmat_torch.ops.guided_filter import gray_guide
    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain

    seen = {}

    def tail(frame, ma, mb, bg, pool):
        seen["tail_frame"] = frame.clone()
        return sf.fused_refine_composite_plain(frame, ma, mb, bg, pool)

    def coeffs(guide, p, r, eps):
        seen["guide"] = guide.clone()
        return sf.guided_filter_coeffs_plain(guide, p, r, eps)

    monkeypatch.setattr(sf, "fused_refine_composite", tail)
    monkeypatch.setattr(sf, "guided_filter_coeffs", coeffs)
    h, w = 64, 128
    frames, _, plate = _clip(h, w, 2, seed=3)
    body, plan = build_serving_body(
        build_network(PLATE, default_variables(PLATE)), PLATE,
        RefineConfig(), h, w, 0.25, cdtype=torch.float32, bg_plate=plate,
        static_skip_eps=0.5 / 255)
    state = plan.make_state(1)
    for f in frames:
        frame = torch.from_numpy(f[None])
        _, state = body(frame, state)
        assert torch.equal(seen["tail_frame"], frame)
        x = ingest_pool_normalize_plain(frame, 4, out_dtype=torch.float32)
        torch.testing.assert_close(seen["guide"], gray_guide(x), atol=0,
                                   rtol=0)
    assert state[1][0].shape == (1, 16, 32, 3)


def test_plate_session_matches_jax():
    """MattingSession(bg_plate=...) with no model_cfg selects plate_demo
    in both packages; the fp32 parity sessions agree per frame."""
    from vidmat.api import MattingSession as JSession

    from vidmat_torch import MattingSession

    h, w = 64, 96
    frames, _, plate = _clip(h, w, 3, seed=4)
    js = JSession(h, w, downsample_ratio=0.5, bg_plate=plate)
    ts = MattingSession(h, w, downsample_ratio=0.5, bg_plate=plate,
                        device="cpu")
    assert ts._stepper.cfg == PLATE
    for f in frames:
        (ja, jf), (ta, tf) = js.step(f), ts.step(f)
        assert ta.shape == (h, w, 1) and tf.shape == (h, w, 3)
        assert np.abs(ta - np.asarray(ja)).mean() <= 1e-3
        assert np.abs(tf - np.asarray(jf)).mean() <= 1e-3


def test_bare_bg_plate_convert_video_matches_jax_body():
    """convert_video(bg_plate=...) with no configuration: plate_demo,
    PipelineConfig() (bf16, auto ratio: full resolution at 96x128), alpha
    bytes against the JAX body convert_video builds, over 4 frames; the
    bf16 serving bar (alpha MAD <= 2e-2 per frame) and bytes mean |d| <=
    0.26, as tests/test_torch_tails.py's defaults test."""
    from vidmat.models.weights import default_variables as j_default
    from vidmat.models.weights import plate_default_config as j_plate_cfg

    from vidmat_torch import convert_video

    h, w = 96, 128
    frames, gt, plate = _clip(h, w, 4, seed=5)
    alphas = []
    m = convert_video(list(frames), output_alpha=alphas.append,
                      bg_plate=plate, device="cpu")
    assert m["frames"] == 4
    jbody, jplan = _jax_body(PLATE, h, w, 1.0, jnp.bfloat16, plate,
                             alpha_only=True)
    assert jplan.full and jplan.alpha_only
    jstep = jax.jit(jbody)
    jvars = jax.tree_util.tree_map(jnp.asarray, j_default(j_plate_cfg()))
    js = jplan.make_state(1)
    diffs = []
    for f, got in zip(frames, alphas):
        jo, js = jstep(jvars, jnp.asarray(f[None]), js)
        diffs.append(np.abs(np.asarray(jo)[0].astype(int)
                            - got.astype(int)))
    d = np.stack(diffs)
    assert d.mean(axis=(1, 2)).max() / 255.0 <= 2e-2
    assert d.mean() <= 0.26, d.mean()


def test_plate_validation_as_jax():
    from vidmat_torch import convert_video
    from vidmat_torch.pipeline.video import VideoPipeline

    plate = np.zeros((64, 128, 3), np.uint8)
    with pytest.raises(ValueError, match="needs the pre-captured"):
        VideoPipeline(PLATE, device="cpu")
    with pytest.raises(ValueError, match="not plate-conditioned"):
        VideoPipeline(ModelConfig(), bg_plate=plate, device="cpu")
    with pytest.raises(ValueError, match="not plate-conditioned"):
        convert_video([plate], model_cfg=ModelConfig(), bg_plate=plate,
                      device="cpu")
    net = build_network(PLATE, default_variables(PLATE))
    with pytest.raises(ValueError, match="needs the pre-captured"):
        build_serving_body(net, PLATE, RefineConfig(), 64, 128, 0.25)
    with pytest.raises(ValueError, match="matching the frame"):
        build_serving_body(net, PLATE, RefineConfig(), 64, 128, 0.25,
                           bg_plate=plate[:32])
    fast = ModelConfig(space_to_depth=2)
    with pytest.raises(ValueError, match="not plate-conditioned"):
        build_serving_body(build_network(fast, default_variables(fast)),
                           fast, RefineConfig(), 64, 128, 0.25,
                           bg_plate=plate)


def test_plate_prepared_to_the_bucket_without_cv2(monkeypatch):
    """A plate at the source size (within 16 px of the bucket) is
    edge-padded as the frames are, with no cv2; one of another size needs
    cv2 and says so when it is missing."""
    import builtins

    from vidmat.pipeline.video import _prepare_plate_u8 as j_prep

    from vidmat_torch.io.backgrounds import prepare_plate_u8

    plate = (np.random.RandomState(6).rand(60, 120, 3) * 255).astype(
        np.uint8)
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    np.testing.assert_array_equal(prepare_plate_u8(plate, 64, 128),
                                  j_prep(plate, 64, 128))
    with pytest.raises(RuntimeError, match="cv2"):
        prepare_plate_u8(plate, 128, 256)
    monkeypatch.undo()
    np.testing.assert_array_equal(prepare_plate_u8(plate, 128, 256),
                                  j_prep(plate, 128, 256))
