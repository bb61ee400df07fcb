"""The port's spans (``vidmat_torch.utils.profiling``) on the CPU: nesting
and self time, one ring per thread, the wrap count, recording off, the
spans ``convert_video`` and ``MultiStreamMatting.step`` record, the
graph capture times read from the ``capture`` span, and the operator's
``maybe_profile`` trace carrying them. Small shapes, a few seconds.
"""

import contextlib
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import vidmat_torch
from vidmat_torch.io.fixtures import synthetic_frames_only
from vidmat_torch.parallel import multistream
from vidmat_torch.pipeline import video
from vidmat_torch.utils import profiling


def _mine(since: int, thread=None) -> dict:
    """{name: [(start, end, self ns)]} of the spans this thread (or the
    ring ``thread``) closed that started at ``since`` or later."""
    sp = profiling.spans()
    if thread is None:
        ring = profiling._local.ring
        thread = ring.id
    keep = (sp.thread == thread) & (sp.start >= since)
    self_ns = sp.self_ns()
    out = {}
    for n, s, e, st in zip(sp.name[keep], sp.start[keep], sp.end[keep],
                           self_ns[keep]):
        out.setdefault(sp.names[n], []).append((int(s), int(e), int(st)))
    return out


def _counts(got: dict) -> dict:
    return {k: len(v) for k, v in got.items()}


@pytest.fixture(autouse=True)
def spans_on():
    profiling.enable_spans(True)
    with profiling.annotate("warm"):   # this thread's ring exists
        pass
    yield
    profiling.enable_spans(True)


def test_nesting_and_self_time():
    t0 = time.perf_counter_ns()
    with profiling.annotate("outer"):
        with profiling.annotate("inner"):
            time.sleep(0.004)
        with profiling.annotate("inner"):
            time.sleep(0.002)
        time.sleep(0.003)
    got = _mine(t0)
    assert _counts(got) == {"outer": 1, "inner": 2}
    (o_s, o_e, o_self), = got["outer"]
    inner = got["inner"]
    assert all(o_s <= s <= e <= o_e for s, e, _ in inner)
    # An inner span has no children: its self time is its duration.
    assert all(st == e - s for s, e, st in inner)
    assert o_self == (o_e - o_s) - sum(e - s for s, e, _ in inner)
    assert 2.5e6 <= o_self <= 2e7
    sp = profiling.spans()
    seq = sp.seq[(sp.thread == profiling._local.ring.id) & (sp.start >= t0)]
    par = sp.parent[(sp.thread == profiling._local.ring.id)
                    & (sp.start >= t0)]
    outer = seq[par == -1]
    assert len(outer) == 1 and (par[par != -1] == outer[0]).all()


def test_threads_keep_their_own_spans():
    t0 = time.perf_counter_ns()
    rings = {}
    go = threading.Barrier(2)

    def work(tag, n):
        go.wait()
        for _ in range(n):
            with profiling.annotate(tag):
                with profiling.annotate("child"):
                    pass
        rings[tag] = profiling._local.ring.id

    ts = [threading.Thread(target=work, args=(t, n))
          for t, n in (("left", 30), ("right", 50))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    left, right = (_mine(t0, rings[t]) for t in ("left", "right"))
    assert _counts(left) == {"left": 30, "child": 30}
    assert _counts(right) == {"right": 50, "child": 50}
    assert rings["left"] != rings["right"]
    sp = profiling.spans()
    assert sp.thread_names.keys() >= set(rings.values())


def test_a_full_ring_counts_what_it_overwrote(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    got = {}

    def work():
        for i in range(20):
            with profiling.annotate("wrap"):
                pass
        got["id"] = profiling._local.ring.id

    t = threading.Thread(target=work)
    t.start()
    t.join()
    sp = profiling.spans()
    mine = sp.thread == got["id"]
    assert sp.overwritten[got["id"]] == 12
    # The ring keeps the newest 8, in order.
    assert list(sp.seq[mine]) == list(range(12, 20))


def test_spans_off_record_nothing():
    t0 = time.perf_counter_ns()
    n0 = len(profiling.spans().seq)
    profiling.enable_spans(False)
    with profiling.annotate("off"):
        pass
    with profiling.annotate("off_timed", timed=True) as span:
        time.sleep(0.002)
    profiling.enable_spans(True)
    assert span.ms >= 2.0
    assert _mine(t0) == {}
    assert len(profiling.spans().seq) == n0


def test_convert_video_records_its_host_stages():
    """9 frames at chunk 4: two full chunks and a one-frame tail."""
    mcfg, pcfg = vidmat_torch.preset_video_1080p()
    pcfg = __import__("dataclasses").replace(pcfg, chunk_size=4,
                                             dtype="float32")
    frames = list(synthetic_frames_only(64, 64, 9))
    alphas = []
    t0 = time.perf_counter_ns()
    m = vidmat_torch.convert_video(frames, output_alpha=alphas.append,
                                   model_cfg=mcfg, pipe_cfg=pcfg,
                                   device="cpu")
    assert m["frames"] == 9 and len(alphas) == 9
    got = _counts(_mine(t0))
    assert {k: got.get(k, 0) for k in ("pad", "enqueue", "eager",
                                        "d2h_wait", "sink")} == {
        "pad": 9, "enqueue": 3, "eager": 3, "d2h_wait": 3, "sink": 9}
    assert got["source_wait"] == 10      # 9 frames and the end
    assert got["slot_wait"] == 3
    assert got["build"] >= 1
    # Every eager body runs inside an enqueue.
    spans = _mine(t0)
    enq = spans["enqueue"]
    assert all(any(a <= s and e <= b for a, b, _ in enq)
               for s, e, _ in spans["eager"])


def test_multistream_step_records_its_host_stages():
    m, _, _ = vidmat_torch.preset_multistream()
    ms = vidmat_torch.MultiStreamMatting(2, 64, 64, cfg=m,
                                         downsample_ratio=0.5,
                                         bg_color=(0.0, 1.0, 0.0),
                                         dtype="float32", device="cpu")
    batch = np.stack(list(synthetic_frames_only(64, 64, 2)))
    t0 = time.perf_counter_ns()
    alpha, rgba = ms.step(batch)
    assert rgba.shape == (2, 64, 64, 4)
    got = _counts(_mine(t0))
    assert {k: got.get(k, 0) for k in ("pad", "enqueue", "d2h_wait",
                                        "unpack")} == {
        "pad": 2, "enqueue": 1, "d2h_wait": 1, "unpack": 1}
    assert got["eager"] == 1 and got["slot_wait"] == 2


class _FakeGraph:
    """A stand-in for ``ChunkGraph`` on the CPU: takes a known time to
    "capture", then replays the body eagerly on the static inputs."""

    CAPTURE_S = 0.004

    def __init__(self, body, static_in, state):
        time.sleep(self.CAPTURE_S)
        self.body = body
        self.ins = static_in if isinstance(static_in, tuple) else (
            static_in,)
        self.state = state

    def __call__(self, state):
        return self.body(*self.ins, state)

    def launches_per_replay(self):
        return {}


def _capture_spans_ms(since: int):
    return [(e - s) * 1e-6 for s, e, _ in _mine(since).get("capture", [])]


def test_convert_reports_graph_capture_ms_from_the_capture_span(
        monkeypatch):
    """The capture branch (CUDA only) with a stand-in graph and device:
    ``graph_capture_ms`` is reported, and is the capture span's time."""
    monkeypatch.setattr(video, "ChunkGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "stand-in")
    mcfg, pcfg = vidmat_torch.preset_video_1080p()
    pcfg = __import__("dataclasses").replace(pcfg, chunk_size=2,
                                             dtype="float32")
    pipe = video.VideoPipeline(mcfg, pcfg, device="cpu")
    pipe._build_step(64, 64, pcfg.downsample_ratio, alpha_only=True)
    pipe.device = types.SimpleNamespace(type="cuda")
    alphas = []
    t0 = time.perf_counter_ns()
    m = pipe.run(list(synthetic_frames_only(64, 64, 6)),
                 output_alpha=alphas.append)
    assert len(alphas) == 6 and m["graph_replays"] == 2
    cap = _capture_spans_ms(t0)
    assert len(cap) == 1 and cap[0] >= _FakeGraph.CAPTURE_S * 1e3
    assert m["graph_capture_ms"] == pytest.approx(cap[0], abs=1e-9)


def test_multistream_reports_capture_ms_from_the_capture_span(monkeypatch):
    monkeypatch.setattr(multistream, "ChunkGraph", _FakeGraph)
    m, _, _ = vidmat_torch.preset_multistream()
    ms = vidmat_torch.MultiStreamMatting(2, 64, 64, cfg=m,
                                         downsample_ratio=0.5,
                                         bg_color=(0.0, 1.0, 0.0),
                                         dtype="float32", device="cpu")
    batch = np.stack(list(synthetic_frames_only(64, 64, 2)))
    ms.step(batch)
    sh = ms._shards[0]
    sh.pos = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"),
                                   active=contextlib.nullcontext)
    t0 = time.perf_counter_ns()
    ms.step(batch)
    cap = _capture_spans_ms(t0)
    assert len(cap) == 1 and cap[0] >= _FakeGraph.CAPTURE_S * 1e3
    assert ms.capture_ms == pytest.approx(cap[0], abs=1e-9)
    assert sh.capture_ms == ms.capture_ms


def test_maybe_profile_writes_the_spans_into_its_trace(tmp_path):
    with profiling.maybe_profile(1, str(tmp_path)):
        with profiling.annotate("op_span"):
            torch.ones(256).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("name") == "op_span"]
    assert len(mine) == 1
    pid = mine[0]["pid"]
    rows = [e for e in events if e.get("ph") == "M"
            and e.get("name") == "process_name" and e.get("pid") == pid]
    assert rows and rows[0]["args"]["name"] == "vidmat_torch spans"
    # On the profiler's clock: the span holds the torch op run inside it.
    ops = [e for e in events if e.get("ph") == "X" and e.get("pid") != pid
           and e.get("name") in ("aten::sum", "aten::ones")]
    assert ops
    s, d = mine[0]["ts"], mine[0]["dur"]
    assert all(s - 50 <= e["ts"] and e["ts"] + e["dur"] <= s + d + 50
               for e in ops)
