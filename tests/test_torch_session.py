"""The port's streaming ``MattingSession`` against the JAX package's on
the CPU.

Parity mode (dtype="float32", the default: float frames, the net as
F.conv2d, no kernels) on synthetic_demo: alpha and fgr MAD <= 1e-3 per
frame over 4 recurrent frames. Serving mode (dtype="bfloat16": uint8
frames, the planar net, the GF coefficients and fused_refine_float) on
fast_demo at 128x192, ratio 0.5, with the JAX package's kernels in
interpret mode: MAD <= 2e-2 per frame. Then the static-scene fast path,
the carry's save/load round trip and the errors of misused options.
"""

import os

import numpy as np
import pytest
import torch

from vidmat_torch import MattingSession
from vidmat_torch.config import ModelConfig
from vidmat_torch.io.fixtures import synthetic_frames_only

S2D2_PLANAR = ModelConfig(space_to_depth=2, conv_impl="planar")


def _frames(h, w, n, seed):
    return list(synthetic_frames_only(h, w, n, seed=seed))


def _jax_session(cfg, h, w, **kw):
    from vidmat.api import MattingSession as JSession
    from vidmat.config import ModelConfig as JModelConfig

    jcfg = JModelConfig(space_to_depth=cfg.space_to_depth,
                        conv_impl=cfg.conv_impl)
    return JSession(h, w, model_cfg=jcfg, **kw)


def _mads(jsess, sess, frames):
    out = []
    for f in frames:
        ja, jf = jsess.step(f)
        ta, tf = sess.step(f)
        assert ta.shape == ja.shape and tf.shape == jf.shape
        assert ta.dtype == np.float32 and tf.dtype == np.float32
        out.append(max(float(np.abs(ta - ja).mean()),
                       float(np.abs(tf - jf).mean())))
    return out


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_parity_session_matches_jax(ratio):
    """Full resolution (the default ratio) and a guided coarse pass."""
    h, w = 96, 128
    frames = _frames(h, w, 4, seed=2)
    jsess = _jax_session(ModelConfig(), h, w, downsample_ratio=ratio)
    sess = MattingSession(h, w, downsample_ratio=ratio, device="cpu")
    mads = _mads(jsess, sess, frames)
    assert max(mads) <= 1e-3, mads


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """The JAX session's serving mode with its Pallas kernels in interpret
    mode (the serving path is TPU-only otherwise), patching
    build_serving_body as tests/unit/test_stepfactory_outputs.py does."""
    from vidmat.pipeline import stepfactory

    orig = stepfactory.build_serving_body

    def patched(*a, **kw):
        kw["pallas_interpret"] = True
        kw.setdefault("use_pallas", True)
        return orig(*a, **kw)

    monkeypatch.setattr(stepfactory, "build_serving_body", patched)


def test_serving_session_matches_jax(jax_kernels_interpreted):
    h, w = 128, 192
    frames = _frames(h, w, 4, seed=3)
    jsess = _jax_session(S2D2_PLANAR, h, w, downsample_ratio=0.5,
                         dtype="bfloat16")
    sess = MattingSession(h, w, model_cfg=S2D2_PLANAR, downsample_ratio=0.5,
                          dtype="bfloat16", device="cpu")
    plan = sess._stepper._plan
    assert plan.pool == 2 and not plan.packed
    assert jsess._stepper._plan.pool == 2
    mads = _mads(jsess, sess, frames)
    assert max(mads) <= 2e-2, mads


def test_static_skip_session(monkeypatch):
    """Identical frames skip the net and the coefficients: the counter
    advances, the outputs stay bit-identical, the tail runs every frame;
    a changed frame recomputes."""
    from vidmat_torch.models.planar import PlanarNetwork
    from vidmat_torch.ops import refine

    h, w = 128, 192
    sess = MattingSession(h, w, model_cfg=S2D2_PLANAR, downsample_ratio=0.5,
                          dtype="bfloat16", static_skip_eps=0.5 / 255,
                          device="cpu")
    st = sess._stepper
    assert st._plan.static_skip
    calls = {"net": 0, "tail": 0}

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(PlanarNetwork, "forward",
                        counting(PlanarNetwork.forward, "net"))
    monkeypatch.setattr(refine, "fused_refine_float_plain",
                        counting(refine.fused_refine_float_plain, "tail"))
    f0, f1 = _frames(h, w, 2, seed=4)
    outs = [sess.step(f0) for _ in range(4)]
    assert st.state[1][3] == 3
    assert calls["net"] == 1 and calls["tail"] == 4, calls
    for a, f in outs[1:]:
        np.testing.assert_array_equal(a, outs[0][0])
        np.testing.assert_array_equal(f, outs[0][1])
    sess.step(f1)
    assert st.state[1][3] == 3 and calls["net"] == 2


def test_save_load_round_trip(tmp_path):
    h, w = 96, 128
    frames = _frames(h, w, 4, seed=5)
    sess = MattingSession(h, w, downsample_ratio=0.5, dtype="bfloat16",
                          static_skip_eps=0.5 / 255, device="cpu")
    for f in frames[:2]:
        sess.step(f)
    path = str(tmp_path / "carry.npz")
    sess.save_state(path, frame_index=2)
    with np.load(path) as z:
        assert sorted(z.files) == ["frame_index", "h1", "h2", "h3"]
    want = [sess.step(f) for f in frames[2:]]
    assert sess.load_state(path) == 2
    # The coefficient cache starts afresh: the next frame recomputes.
    assert sess._stepper.state[1][3] == 0
    assert torch.isinf(sess._stepper.state[1][0]).all()
    got = [sess.step(f) for f in frames[2:]]
    for (wa, wf), (ga, gf) in zip(want, got):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gf, wf)

    other = MattingSession(h, w, downsample_ratio=1.0, device="cpu")
    with pytest.raises(ValueError, match="saved carry field"):
        other.load_state(path)
    assert os.path.isfile(path)


def test_session_options_not_ported_raise():
    """The options this test once found unported (tiling, A.8; the
    segmentation output and trimaps, A.10) are ported; each case now
    raises the JAX package's own error for a misuse: a tile overlap off
    the coarse pool, a segmentation session without a co-trained
    checkpoint, a trimap given to a model that takes none."""
    sess = MattingSession(64, 64, downsample_ratio=0.25, tile_size=32,
                          tile_overlap=6, device="cpu")
    with pytest.raises(ValueError, match="align with the coarse pool"):
        sess.step(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="co-trained"):
        MattingSession(64, 64, model_cfg=ModelConfig(space_to_depth=2),
                       output="seg", device="cpu")
    with pytest.raises(ValueError, match="output"):
        MattingSession(64, 64, output="mask", device="cpu")
    with pytest.raises(ValueError, match="multiples of 16"):
        MattingSession(60, 64, device="cpu")
    sess = MattingSession(64, 64, device="cpu")
    with pytest.raises(ValueError, match="not trimap-conditioned"):
        sess.step(np.zeros((64, 64, 3), np.uint8),
                  trimap=np.zeros((64, 64), np.uint8))
    # Float frames in serving mode go to uint8 as round(clip(v) * 255).
    sess = MattingSession(64, 64, dtype="bfloat16", device="cpu")
    f = np.linspace(-0.1, 1.1, 64 * 64 * 3, dtype=np.float32).reshape(
        64, 64, 3)
    x = sess._stepper._device_frame(f)
    assert x.dtype == torch.uint8
    np.testing.assert_array_equal(
        x[0].numpy(), np.round(np.clip(f, 0, 1) * 255).astype(np.uint8))
