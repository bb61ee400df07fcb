"""The port's live serving driver (``vidmat_torch.pipeline.realtime``) on
the CPU: the latest-wins mailbox's four behaviours
(tests/unit/test_realtime.py:19-47) and its counts under contention; a
float32 90x120 session (served on its /16 bucket, outputs cropped) that
keeps up, drops on overrun, writes cropped outputs, stops at
``max_frames`` and rejects a frame of the wrong size; the clean-plate
family; a camera index without cv2 raising the port's error; and a
lockstep source (frame t+1 only after frame t came out, so none is
dropped) giving the same alpha and composite bytes as the JAX
``RealtimeMatting`` on the same frames: the ``video_1080p`` model in
bf16 at ratio 0.5, the JAX Pallas kernels in interpret mode, mean |d| <=
0.26 LSB, max <= 2."""

import glob
import sys
import threading

import numpy as np
import pytest

from vidmat_torch import RealtimeMatting
from vidmat_torch.io.fixtures import synthetic_frame, synthetic_frames_only
from vidmat_torch.pipeline.realtime import LatestMailbox, _frame_iter


class TestLatestMailbox:
    def test_latest_wins_and_drop_accounting(self):
        box = LatestMailbox()
        for i in range(10):
            box.put(i)
        box.close()
        assert box.get() == 9          # only the newest survives
        assert box.get() is None       # closed and drained
        assert box.produced == 10
        assert box.dropped == 9

    def test_get_blocks_until_put(self):
        box = LatestMailbox()
        t = threading.Timer(0.05, lambda: box.put("x"))
        t.start()
        assert box.get(timeout=5.0) == "x"
        t.join(timeout=5.0)
        assert not t.is_alive()

    def test_get_timeout(self):
        box = LatestMailbox()
        with pytest.raises(TimeoutError):
            box.get(timeout=0.05)

    def test_put_after_close_raises(self):
        box = LatestMailbox()
        box.close()
        with pytest.raises(RuntimeError):
            box.put(1)


def test_mailbox_counts_hold_under_contention():
    """16 producer threads (more than the cores) put into one mailbox
    while a consumer takes, with the interpreter switching threads every
    microsecond: every put is either taken or counted as dropped."""
    box = LatestMailbox()
    taken = []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def consume():
            while True:
                item = box.get(timeout=30.0)
                if item is None:
                    return
                taken.append(item)

        consumer = threading.Thread(target=consume)
        producers = [threading.Thread(target=lambda k=k: [
            box.put((k, i)) for i in range(200)]) for k in range(16)]
        consumer.start()
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=30.0)
        box.close()
        consumer.join(timeout=30.0)
    finally:
        sys.setswitchinterval(prev)
    assert not consumer.is_alive()
    assert not any(t.is_alive() for t in producers)
    assert box.produced == 16 * 200
    assert box.produced == box.dropped + len(taken)
    assert len(set(taken)) == len(taken)


@pytest.fixture(scope="module")
def rt_session():
    """Not a multiple of 16 on purpose: the pad and crop path. The paced
    sources below must stay far slower than a step while other test
    processes load the CPU: float32 (the parity mode) steps fastest here,
    and one intra-op thread keeps the step from contending with them (the
    process's setting is restored after the module)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield RealtimeMatting(90, 120, downsample_ratio=1.0, dtype="float32",
                              device="cpu")
    finally:
        torch.set_num_threads(threads)


def _frames(n, h=90, w=120):
    return [synthetic_frame(h, w, i / n)[0] for i in range(n)]


class TestRealtimeMatting:
    def test_keeps_up_processes_everything(self, rt_session):
        rt_session.reset()
        frames = _frames(6)
        stats = rt_session.run(frames, pace_fps=2.0)
        assert stats["processed"] == stats["produced"] == len(frames)
        assert stats["dropped"] == 0
        assert stats["p50_ms"] > 0 and stats["p99_ms"] >= stats["p50_ms"]

    def test_overrun_drops_not_queues(self, rt_session):
        # All frames land at once; the consumer only ever sees the newest.
        rt_session.reset()
        frames = _frames(30)
        stats = rt_session.run(frames, pace_fps=None)
        assert stats["produced"] == len(frames)
        assert stats["processed"] + stats["dropped"] == stats["produced"]
        assert stats["dropped"] > 0

    def test_outputs_written_and_cropped(self, rt_session, tmp_path):
        rt_session.reset()
        seen = []
        stats = rt_session.run(
            _frames(4), pace_fps=2.0,
            output_alpha=str(tmp_path / "a_%03d.png"),
            output_composition=str(tmp_path / "c_%03d.png"),
            on_frame=lambda a, c: seen.append((a.shape, c.shape, a.dtype,
                                               c.dtype)))
        assert stats["processed"] == 4
        assert len(glob.glob(str(tmp_path / "a_*.png"))) == 4
        assert len(glob.glob(str(tmp_path / "c_*.png"))) == 4
        # Cropped to the source's size, not the /16 bucket.
        assert seen[0] == ((90, 120), (90, 120, 3), np.uint8, np.uint8)

    def test_max_frames_stops_early(self, rt_session):
        rt_session.reset()
        stats = rt_session.run(_frames(10), pace_fps=4.0, max_frames=2)
        assert stats["processed"] == 2
        assert stats["produced"] <= 10

    def test_wrong_frame_size_rejected(self, rt_session):
        rt_session.reset()
        with pytest.raises(ValueError, match="live frame"):
            rt_session.run(_frames(2, h=64, w=64), pace_fps=None)


def test_realtime_with_bg_plate():
    """A bare bg_plate selects the plate family (plate_demo)."""
    from vidmat_torch.io.fixtures import synthetic_plate_clip

    clip = list(synthetic_plate_clip(64, 64, 4, seed=6))
    rt = RealtimeMatting(64, 64, downsample_ratio=1.0, dtype="float32",
                         bg_plate=clip[0][2], device="cpu")
    assert rt._stepper.cfg.use_bg_plate
    stats = rt.run(iter([f for f, _, _ in clip]), pace_fps=1000.0)
    assert stats["processed"] >= 1
    assert stats["produced"] == stats["processed"] + stats["dropped"]


def test_camera_index_without_cv2_raises_the_ports_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    for src in (3, "0"):
        with pytest.raises(RuntimeError, match="needs OpenCV"):
            _frame_iter(src)
    assert list(_frame_iter(iter([1, 2]))) == [1, 2]


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """The JAX stepper's serving mode with its Pallas kernels in interpret
    mode (it is TPU-only otherwise), as tests/test_torch_session.py
    patches it."""
    from vidmat.pipeline import stepfactory

    orig = stepfactory.build_serving_body

    def patched(*a, **kw):
        kw["pallas_interpret"] = True
        kw.setdefault("use_pallas", True)
        return orig(*a, **kw)

    monkeypatch.setattr(stepfactory, "build_serving_body", patched)


def _lockstep(rt, frames):
    """Run ``frames`` through ``rt`` one at a time: frame t+1 is produced
    only after frame t came out, so none is dropped."""
    got, out = [], threading.Event()

    def src():
        for f in frames:
            yield f
            assert out.wait(60.0)
            out.clear()

    def on_frame(a, c):
        got.append((a, c))
        out.set()

    stats = rt.run(src(), on_frame=on_frame)
    assert stats["dropped"] == 0 and stats["processed"] == len(frames)
    return got


def test_lockstep_matches_jax(jax_kernels_interpreted):
    from vidmat.config import preset_video_1080p as jpreset
    from vidmat.pipeline.realtime import RealtimeMatting as JRealtime

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import default_variables

    mcfg = preset_video_1080p()[0]
    variables = default_variables(mcfg)
    frames = list(synthetic_frames_only(90, 120, 4, seed=3))
    kw = dict(variables=variables, downsample_ratio=0.5, dtype="bfloat16")
    want = _lockstep(JRealtime(90, 120, model_cfg=jpreset()[0], **kw),
                     frames)
    got = _lockstep(RealtimeMatting(90, 120, model_cfg=mcfg, device="cpu",
                                    **kw), frames)
    for (ta, tc), (ja, jc) in zip(got, want):
        assert ta.shape == (90, 120) and tc.shape == (90, 120, 3)
        for t, j in ((ta, ja), (tc, jc)):
            d = np.abs(t.astype(int) - np.asarray(j).astype(int))
            assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())
