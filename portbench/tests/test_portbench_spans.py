"""The span readers (``portbench/spans.py`` and the ``metrics/`` files that
read it) on a synthetic trace and synthetic spans: the clock fit, idle
time split by innermost span, self time, rebuilds and the readers'
None where a ring overwrote spans of the window or the program has none.
"""

import types

import numpy as np
import pytest

from portbench import harness, spans
from portbench.metrics import (host_ms_per_frame, idle_ms_per_frame,
                               rebuilds, setup_phase_ms)
from vidmat_torch.utils.profiling import Spans

#: the trace's clock less perf_counter's in the synthetic runs
OFFSET = 1_790_000_000_123_456_789


def make_spans(rows, names, guess_error=300_000, overwritten=0):
    """A ``Spans`` of one thread (ring 0) from rows (name, start, end,
    parent seq), seq in row order; its clock pair misses OFFSET by
    ``guess_error`` ns."""
    ids = {n: i for i, n in enumerate(names)}
    a = np.array([(ids[n], s, e, p) for n, s, e, p in rows], np.int64)
    perf = 10_000_000_000
    return Spans(list(names), thread=np.zeros(len(rows), np.int64),
                 seq=np.arange(len(rows), dtype=np.int64) + overwritten,
                 name=a[:, 0], start=a[:, 1], end=a[:, 2], parent=a[:, 3],
                 overwritten={0: overwritten},
                 clock={0: (perf, perf + OFFSET + guess_error)},
                 thread_names={0: "MainThread"})


def make_run(trace, window_s, frames, metric=""):
    obs = types.SimpleNamespace(trace=trace, window_s=window_s,
                                frames=frames)
    return types.SimpleNamespace(obs=obs, frames=frames,
                                 metric={"name": metric})


def dispatches(n=400, seed=5):
    """n dispatches 4 ms apart on perf_counter: set-up spans before them
    (build, eager with a kernel_load inside), then a slot_wait, a pad,
    an enqueue holding a cudaGraphLaunch, a d2h_wait holding a
    cudaEventSynchronize each; the device busy during each enqueue's
    replay. Returns (rows, host calls, device ops, window start and
    end) on the trace's clock."""
    rng = np.random.default_rng(seed)
    t0 = 20_000_000_000
    rows = [("build", t0 - 900_000_000, t0 - 800_000_000, -1),
            ("eager", t0 - 700_000_000, t0 - 600_000_000, -1),
            ("kernel_load", t0 - 690_000_000, t0 - 650_000_000, 1)]
    host, dev = [], []
    for i in range(n):
        t = t0 + i * 4_000_000 + int(rng.integers(0, 50_000))
        rows.append(("slot_wait", t, t + 20_000, -1))
        rows.append(("pad", t + 30_000, t + 530_000, -1))
        e0 = t + 600_000
        rows.append(("enqueue", e0, e0 + 200_000, -1))
        m = int(rng.integers(0, 192_001))
        host.append(("cudaGraphLaunch", e0 + m + OFFSET, 8_000))
        w0 = e0 + 300_000
        rows.append(("d2h_wait", w0, w0 + 2_500_000, -1))
        m = int(rng.integers(0, 2_480_001))
        host.append(("cudaEventSynchronize", w0 + m + OFFSET, 20_000))
        dev.append(("kernel", e0 + 150_000 + OFFSET, 2_500_000))
    end = t0 + n * 4_000_000 + OFFSET
    host.append(("cudaDeviceSynchronize", end - 10_000, 10_000))
    return rows, host, dev, t0 + OFFSET, end


NAMES = ("build", "eager", "kernel_load", "slot_wait", "pad", "enqueue",
         "d2h_wait", "capture", "sink", "outer", "inner")


def test_clock_fit_recovers_a_planted_offset():
    rows, host, dev, lo, hi = dispatches()
    sp = make_spans(rows, NAMES, guess_error=300_000)
    v, why = spans.compute(harness.Trace(dev, host), (hi - lo) * 1e-9, sp)
    assert v is not None, why
    assert v.fit.launches == (400, 400) and v.fit.syncs == (400, 400)
    # The guess was 300 us off; the fit takes it back to within 1 us.
    assert abs(v.fit.residual_ns + 300_000) < 1_000
    assert v.fit.width_ns < 1_000


def use(monkeypatch, sp):
    """Readers read ``sp`` as the program's spans, from a fresh cache."""
    monkeypatch.setattr(spans, "read_spans", lambda: sp)
    monkeypatch.setattr(spans, "_last", [lambda: None, None])


def test_idle_split_by_innermost_span_and_the_none_bucket(monkeypatch):
    rows, host, dev, lo, hi = dispatches(n=50)
    sp = make_spans(rows, NAMES, guess_error=0)
    tr = harness.Trace(dev, host)
    v, _ = spans.compute(tr, (hi - lo) * 1e-9, sp)
    # A dispatch of 4 ms (plus its start's jitter): the device is busy
    # 2.5 ms from 150 us into the enqueue; the rest is idle. Idle under
    # pad 0.5 ms, the enqueue's first 150 us, the slot wait's 20 us; the
    # d2h_wait ends 150 us after the device, then none till the next.
    n = 50
    assert v.idle_ns["pad"] == pytest.approx(n * 500_000, abs=n * 1_000)
    assert v.idle_ns["enqueue"] == pytest.approx(n * 150_000, abs=n * 1_000)
    assert v.idle_ns["slot_wait"] == pytest.approx(n * 20_000, abs=n * 1_000)
    assert v.idle_ns["d2h_wait"] == pytest.approx(n * 150_000,
                                                  abs=n * 1_000)
    total = (hi - lo) - tr.busy_s() * 1e9
    assert sum(v.idle_ns.values()) == pytest.approx(total, rel=1e-9)
    assert v.idle_ns["none"] == pytest.approx(
        total - sum(x for k, x in v.idle_ns.items() if k != "none"))
    run = make_run(tr, (hi - lo) * 1e-9, n * 4,
                   "idle_ms_per_frame.pad.convert_1080p")
    use(monkeypatch, sp)
    assert idle_ms_per_frame.read(run) == pytest.approx(
        v.idle_ns["pad"] * 1e-6 / (n * 4))
    run.metric["name"] = "idle_ms_per_frame.sink.convert_1080p"
    assert idle_ms_per_frame.read(run) == 0.0


def test_innermost_segments_and_idle_gaps_by_hand():
    # outer [0, 100) holds inner [20, 50) and [60, 70); then a gap, then
    # a top-level span [120, 130).
    start = np.array([0, 20, 60, 120])
    end = np.array([100, 50, 70, 130])
    segs = spans.innermost(start, end, ["outer", "inner", "inner", "sink"],
                           -10, 140)
    assert segs == [(-10, 0, "none"), (0, 20, "outer"), (20, 50, "inner"),
                    (50, 60, "outer"), (60, 70, "inner"),
                    (70, 100, "outer"), (100, 120, "none"),
                    (120, 130, "sink"), (130, 140, "none")]
    gaps = spans.idle([(10, 30), (65, 125)], -10, 140)
    assert gaps == [(-10, 10), (30, 65), (125, 140)]
    assert spans.split(segs, gaps) == {"none": 10 + 10, "outer": 10 + 10,
                                       "inner": 20 + 5, "sink": 5}


def test_self_time_of_nested_spans(monkeypatch):
    rows, host, dev, lo, hi = dispatches(n=20)
    # Wrap each pad in an outer span 100 us longer on each side.
    more = []
    for i, r in enumerate(rows):
        if r[0] == "pad":
            more.append(("outer", r[1] - 10_000, r[2] + 10_000, -1))
        more.append(r)
    parents = []
    for i, r in enumerate(more):
        p = i - 1 if r[0] == "pad" and more[i - 1][0] == "outer" else r[3]
        parents.append((r[0], r[1], r[2], p))
    sp = make_spans(parents, NAMES, guess_error=0)
    v, _ = spans.compute(harness.Trace(dev, host), (hi - lo) * 1e-9, sp)
    assert v.host_ns["pad"] == pytest.approx(20 * 500_000)
    assert v.host_ns["outer"] == pytest.approx(20 * 20_000)
    # Set-up: eager's self time is its 100 ms less its kernel_load's 40.
    assert v.setup_ns == pytest.approx({"build": 100e6, "eager": 60e6,
                                        "kernel_load": 40e6})
    run = make_run(harness.Trace(dev, host), (hi - lo) * 1e-9, 80,
                   "host_ms_per_frame.pad.convert_1080p")
    use(monkeypatch, sp)
    assert host_ms_per_frame.read(run) == pytest.approx(20 * 0.5 / 80)
    run.metric["name"] = "setup_phase_ms.eager.convert_1080p"
    assert setup_phase_ms.read(run) == pytest.approx(60.0)


def test_rebuilds_count_eager_capture_and_loads_in_the_window(monkeypatch):
    rows, host, dev, lo, hi = dispatches(n=30)
    t = rows[-1][1]
    rows += [("eager", t + 100, t + 200, -1), ("capture", t + 300, t + 400,
                                                 -1)]
    sp = make_spans(rows, NAMES, guess_error=0)
    tr = harness.Trace(dev, host)
    v, _ = spans.compute(tr, (hi - lo) * 1e-9, sp)
    assert v.rebuilds == 2      # the set-up's eager and load are before it
    run = make_run(tr, (hi - lo) * 1e-9, 120, "rebuilds.convert_1080p")
    use(monkeypatch, sp)
    assert rebuilds.read(run) == 2.0


def test_readers_return_none_on_a_wrap_and_without_spans(monkeypatch,
                                                         capsys):
    rows, host, dev, lo, hi = dispatches(n=30)
    # The ring kept only the window's second half.
    kept = [r for r in rows if r[1] + OFFSET > (lo + hi) / 2]
    sp = make_spans(kept, NAMES, guess_error=0, overwritten=len(rows))
    tr = harness.Trace(dev, host)
    v, why = spans.compute(tr, (hi - lo) * 1e-9, sp)
    assert v is None and "overwrote" in why
    for got in (sp, None):
        use(monkeypatch, got)
        for mod, name in ((host_ms_per_frame, "host_ms_per_frame.pad.x"),
                          (idle_ms_per_frame, "idle_ms_per_frame.none.x"),
                          (rebuilds, "rebuilds.x"),
                          (setup_phase_ms, "setup_phase_ms.build.x")):
            run = make_run(tr, (hi - lo) * 1e-9, 120, name)
            assert mod.read(run) is None
    err = capsys.readouterr().err
    assert "overwrote" in err and "records no spans" in err
    # A run whose recorder did not run reads nothing either.
    assert host_ms_per_frame.read(make_run(None, 1.0, 10, "x.pad.y")) is None
