"""The host side of the port's video pipeline on the CPU: staging into
reused chunk buffers (``pad_into`` into slots of a host chunk, one device
chunk, a ring of output buffers), the threaded writer, and the reader's
image sequences, fault hook and dropped-frame count.

``convert_video`` on fast_demo (planar, fp32) at 90x150 (a 96x160 bucket,
ratio 0.5: pool 2, the fused chunk body), chunk 4, 10 frames: two chunks
and a drained partial chunk of 2. Its alpha bytes equal the eager bodies'
(chunk body for the full chunks, per-frame body for the drain) exactly,
and the JAX package's bodies (Pallas in interpret mode) within the
serving bar of tests/test_torch_serving.py: mean |d| <= 0.26 LSB, max <=
2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_frames_only
from vidmat_torch.io.reader import pad_frame

FH, FW, PH, PW, RATIO, K, N = 90, 150, 96, 160, 0.5, 4, 10
CFG = ModelConfig(space_to_depth=2, conv_impl="planar")
PIPE = PipelineConfig(downsample_ratio=RATIO, chunk_size=K, dtype="float32")


def _frames(n=N, seed=5):
    return list(synthetic_frames_only(FH, FW, n, seed=seed))


def _eager_alphas(frames):
    """The alpha bytes of the eager bodies on the padded frames: the chunk
    body over full chunks, the per-frame body over the rest."""
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    net = build_network(CFG, default_variables(CFG))
    body, plan = build_serving_body(net, CFG, RefineConfig("guided"), PH, PW,
                                    RATIO, cdtype=torch.float32,
                                    alpha_only=True)
    assert plan.chunk_body is not None and plan.alpha_only
    padded = np.concatenate([pad_frame(f, PH, PW) for f in frames])
    st = plan.make_state(1)
    outs = []
    full = len(frames) // K * K
    for c in range(0, full, K):
        o, st = plan.chunk_body(torch.from_numpy(padded[c:c + K]), st)
        outs.append(o.numpy())
    for i in range(full, len(frames)):
        o, st = body(torch.from_numpy(padded[i:i + 1]), st)
        outs.append(o.numpy())
    return np.concatenate(outs)[:, :FH, :FW]


def _convert(frames, **kw):
    from vidmat_torch import convert_video

    alphas = []
    m = convert_video(frames, output_alpha=alphas.append, model_cfg=CFG,
                      pipe_cfg=PIPE, device="cpu", **kw)
    return m, alphas


def test_staged_convert_video_equals_eager_bodies_and_jax():
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    from vidmat_torch.models.weights import default_variables

    frames = _frames()
    m, alphas = _convert(frames)
    assert m["frames"] == N and len(alphas) == N and m["dropped_frames"] == 0
    assert m["latency_granularity"].startswith("mixed"), m
    assert "graph_capture_ms" not in m  # no graph on the CPU
    assert m["setup_ms"] > 0
    got = np.stack(alphas)
    assert got.shape == (N, FH, FW) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _eager_alphas(frames))

    jcfg = JModelConfig(space_to_depth=2, conv_impl="planar")
    jbody, jplan = j_build(JNet(jcfg), jcfg, JRefineConfig("guided"), PH, PW,
                           RATIO, cdtype=jnp.float32, use_pallas=True,
                           pallas_interpret=True, alpha_only=True)
    assert jplan.chunk_body is not None
    jvars = jax.tree_util.tree_map(jnp.asarray, default_variables(CFG))
    padded = np.concatenate([pad_frame(f, PH, PW) for f in frames])
    js = jplan.make_state(1)
    want = []
    for c in range(0, 8, K):
        o, js = jax.jit(jplan.chunk_body)(
            jvars, jnp.asarray(padded[c:c + K, None]), js)
        want.append(np.asarray(o)[:, 0])
    for i in range(8, N):
        o, js = jax.jit(jbody)(jvars, jnp.asarray(padded[i:i + 1]), js)
        want.append(np.asarray(o))
    want = np.concatenate(want)[:, :FH, :FW].astype(int)
    d = np.abs(got.astype(int) - want)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_buffers_are_reused_across_chunks_and_runs():
    """Seven chunks go through two host chunks, one device chunk and a
    ring of two output buffers, allocated once per bucket; a second run
    reuses them. Every frame handed to the sink is an owned copy that a
    later chunk does not overwrite, and both runs give the eager bytes."""
    from vidmat_torch.pipeline.video import VideoPipeline

    frames = _frames(7 * K + 1, seed=6)
    want = _eager_alphas(frames)
    pipe = VideoPipeline(model_cfg=CFG, pipe_cfg=PIPE, device="cpu")
    ptrs = None
    for _ in range(2):
        alphas = []
        m = pipe.run(frames, output_alpha=alphas.append)
        assert m["frames"] == len(frames)
        (bucket,) = pipe._step_cache.values()
        now = ([t.data_ptr() for t in bucket.frames.host],
               bucket.frames.dev.data_ptr(),
               [tuple(t.data_ptr() for t in b) for b in bucket.outs.bufs])
        assert len(bucket.outs.bufs) == 2 and all(bucket.outs.free)
        if ptrs is not None:
            assert now == ptrs  # allocated once, reused
        ptrs = now
        ring = [t.numpy() for b in bucket.outs.bufs for t in b]
        assert not any(np.shares_memory(a, r) for a in alphas for r in ring)
        np.testing.assert_array_equal(np.stack(alphas), want)


def test_output_ring_refuses_reuse_before_read():
    from vidmat_torch.pipeline.video import Downloads

    ring = Downloads(2, torch.device("cpu"))
    out = torch.zeros((2, 4, 4), dtype=torch.uint8)
    handles = []
    for _ in range(2):
        i = ring.open(out)
        ring.put(i, 0, out)
        handles.append(ring.close(i, 2, False))
    with pytest.raises(RuntimeError, match="before it was read"):
        ring.open(out)
    ring.read(handles[0])
    ring.release(handles[0])
    assert ring.open(out) == handles[0][0]


def test_threaded_writer_keeps_order_and_raises_on_close(tmp_path):
    pytest.importorskip("cv2")
    from vidmat_torch.io.reader import FrameSource
    from vidmat_torch.io.writer import VideoWriter

    frames = [np.full((8, 12, 3), 10 * i, np.uint8) for i in range(20)]
    w = VideoWriter(str(tmp_path / "seq" / "f_%04d.png"), queue_size=2)
    for f in frames:
        w.write(f)
    w.close()
    back = list(FrameSource(str(tmp_path / "seq" / "f_%04d.png")))
    assert len(back) == 20
    for f, b in zip(frames, back):
        np.testing.assert_array_equal(f, b)

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    w = VideoWriter(str(blocker / "out_%03d.png"))
    for f in frames[:3]:
        w.write(f)
    with pytest.raises(OSError):
        w.close()


def test_frame_source_image_sequences_and_fault_hook(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from vidmat_torch.io.reader import FrameSource, image_sequence

    frames = [np.random.RandomState(i).randint(0, 256, (16, 24, 3), np.uint8)
              for i in range(12)]
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames):  # unpadded numbers: 0, 1, ..., 11
        cv2.imwrite(str(d / f"img_{i}.png"), cv2.cvtColor(f,
                                                          cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(d / "gray_99.png"), frames[0][..., 0])
    assert image_sequence(str(tmp_path / "missing.mp4")) is None
    by_pattern = list(FrameSource(str(d / "img_%d.png")))
    assert len(by_pattern) == 12  # numeric order, not 0, 1, 10, 11, 2, ...
    for f, b in zip(frames, by_pattern):
        np.testing.assert_array_equal(f, b)
    by_dir = list(FrameSource(str(d)))  # by name: gray_99 first
    assert len(by_dir) == 13 and by_dir[0].shape == (16, 24, 3)
    for c in range(3):
        np.testing.assert_array_equal(by_dir[0][..., c], frames[0][..., 0])
    np.testing.assert_array_equal(by_dir[3], frames[10])
    assert len(list(FrameSource(str(d / "img_1*.png")))) == 3

    def hook(i, frame):
        if i % 3 == 1:
            raise ValueError("corrupt")
        return frame[::-1]

    src = FrameSource(frames, fault_hook=hook, start=2, count=5)
    got = list(src)
    assert src.dropped == 2 and len(got) == 5
    np.testing.assert_array_equal(got[0], frames[2][::-1])
    np.testing.assert_array_equal(got[1], frames[3][::-1])
    np.testing.assert_array_equal(got[2], frames[5][::-1])


def test_run_reports_dropped_frames(monkeypatch):
    """Frames the source drops (here a fault hook's) are skipped, the
    stream goes on, and run() counts them as dropped_frames."""
    import functools

    from vidmat_torch.io.reader import FrameSource
    from vidmat_torch.pipeline import video

    frames = _frames(6, seed=7)

    def hook(i, frame):
        if i in (1, 4):
            raise ValueError("corrupt")
        return frame

    monkeypatch.setattr(video, "FrameSource",
                        functools.partial(FrameSource, fault_hook=hook))
    alphas = []
    pipe = video.VideoPipeline(model_cfg=CFG, pipe_cfg=PIPE, device="cpu")
    m = pipe.run(frames, output_alpha=alphas.append)
    assert m["dropped_frames"] == 2 and m["frames"] == 4 and len(alphas) == 4
    kept = [f for i, f in enumerate(frames) if i not in (1, 4)]
    np.testing.assert_array_equal(np.stack(alphas), _eager_alphas(kept))


def test_path_targets_write_through_the_threaded_writer(tmp_path):
    """A path target gets the threaded VideoWriter: every frame of the
    run, in order, equal to what a callable sink receives."""
    pytest.importorskip("cv2")
    from vidmat_torch.io.reader import FrameSource

    from vidmat_torch import convert_video

    frames = _frames(6, seed=8)
    _, alphas = _convert(frames, output_composition=str(tmp_path / "comp.d"))
    out = str(tmp_path / "alpha" / "%05d.png")
    convert_video(frames, output_alpha=out, model_cfg=CFG, pipe_cfg=PIPE,
                  device="cpu")
    back = list(FrameSource(out))
    assert len(back) == 6 and len(os.listdir(tmp_path / "comp.d")) == 6
    for a, b in zip(alphas, back):
        np.testing.assert_array_equal(a, b[..., 0])
