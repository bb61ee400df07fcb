"""The program's spans (``vidmat_torch.utils.profiling``) on the device
trace's clock, and what the span readers of ``metrics/`` read from them.

Spans are timed on ``time.perf_counter_ns()``; the recorder's events on
the profiler's clock. The offset between the two starts from the pair of
readings each span ring takes when it is made (the profiler's clock reads
Unix-epoch nanoseconds; the monotonic base is tried too), then is fitted
to the host's CUDA runtime calls the recorder keeps: every
``cudaGraphLaunch`` of the window falls inside an ``enqueue`` span and
every ``cudaEventSynchronize`` inside a ``slot_wait`` or ``d2h_wait``
span, both of the dispatching thread (the thread with the most
``enqueue`` spans in the window). The fit takes the middle of the
offsets that place the most calls, nearest the first guess; the residual
is the fitted offset less that guess.

The window on the trace's clock ends at the last host call's end (the
driver's closing synchronize) and lasts the run's ``window_s``. Each
span readers' quantity comes from ``view(run)``, computed once a run;
it is None, with the reason on standard error, where the program has no
spans (an older program), the recorder did not run, the dispatching
thread's ring overwrote spans of the window, or the fit placed under
``MIN_PLACED`` of the launches.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LAUNCH = "cudaGraphLaunch"
SYNC = "cudaEventSynchronize"
WAITS = ("slot_wait", "d2h_wait")
#: how far from its first guess the fit looks, ns
SEARCH_NS = 2_000_000
#: least share of the window's launches the fit must place in enqueue
MIN_PLACED = 0.9
#: spans that start in the window only when something is built again
REBUILDS = ("eager", "capture", "kernel_load")
NONE = "none"


@dataclasses.dataclass
class Fit:
    """The offset that maps perf_counter_ns onto the trace's clock."""

    offset_ns: float
    guess_ns: int
    width_ns: float           # the range of offsets that place as many
    launches: Tuple[int, int]   # (placed, in the window)
    syncs: Tuple[int, int]

    @property
    def residual_ns(self) -> float:
        return self.offset_ns - self.guess_ns


@dataclasses.dataclass
class View:
    """What the span readers read, times in ns."""

    host_ns: Dict[str, float]    # self time in the window, dispatching thread
    idle_ns: Dict[str, float]    # idle device time by innermost span
    # self time of the spans started before the window, every thread;
    # None where a ring overwrote spans
    setup_ns: Optional[Dict[str, float]]
    rebuilds: int
    fit: Fit


def read_spans():
    """The program's spans, or None where the program records none."""
    from vidmat_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    return profiling.spans()


def _place(calls: np.ndarray, a: np.ndarray, b: np.ndarray, guess: float,
           search: float) -> List[Tuple[float, float]]:
    """For each call (start, end) the offsets d in guess +- search that put
    it inside a span [a + d, b + d] (spans sorted, disjoint): one interval
    per span it can fall in."""
    out = []
    for s, e in calls:
        lo = int(np.searchsorted(b, e - guess - search))
        hi = int(np.searchsorted(a, s - guess + search, side="right"))
        for j in range(lo, hi):
            d0 = max(e - b[j], guess - search)
            d1 = min(s - a[j], guess + search)
            if d0 <= d1:
                out.append((d0, d1))
    return out


def _best(intervals: Sequence[Tuple[float, float]], guess: float
          ) -> Tuple[float, float, int]:
    """(middle, width, count) of the offset range that the most intervals
    share; of equal counts the nearest ``guess``."""
    if not intervals:
        return guess, 0.0, 0
    iv = np.asarray(intervals, dtype=np.float64)
    pos = np.concatenate([iv[:, 0], iv[:, 1]])
    step = np.concatenate([np.ones(len(iv)), -np.ones(len(iv))])
    order = np.lexsort((-step, pos))      # opens before closes at a tie
    pos, step = pos[order], step[order]
    count = np.cumsum(step)
    top = count.max()
    best = None
    for i in np.flatnonzero(count == top):
        lo, hi = pos[i], pos[i + 1]
        mid = (lo + hi) / 2
        if best is None or abs(mid - guess) < abs(best[0] - guess):
            best = (mid, hi - lo)
    return best[0], best[1], int(top)


def fit_clock(host: Sequence[tuple], enqueue: np.ndarray,
              waits: np.ndarray, guesses: Sequence[int],
              search: float = SEARCH_NS) -> Optional[Fit]:
    """The offset from perf_counter_ns to the trace's clock. ``host``: the
    recorder's host calls (name, start, duration) in the window;
    ``enqueue`` and ``waits``: (n, 2) arrays of the dispatching thread's
    spans (start, end), sorted; ``guesses``: first offsets to try."""
    launches = np.array([(s, s + d) for n, s, d in host
                         if n.startswith(LAUNCH)], dtype=np.float64)
    syncs = np.array([(s, s + d) for n, s, d in host
                      if n.startswith(SYNC)], dtype=np.float64)
    if not len(launches):
        return None
    best = None
    for g in guesses:
        iv = _place(launches, enqueue[:, 0], enqueue[:, 1], g, search)
        if len(syncs) and len(waits):
            iv += _place(syncs, waits[:, 0], waits[:, 1], g, search)
        mid, width, n = _best(iv, g)
        if best is None or n > best[2]:
            best = (mid, width, n, g)
    mid, width, _, g = best

    def placed(calls, spans):
        if not len(calls) or not len(spans):
            return 0
        k = np.searchsorted(spans[:, 0] + mid, calls[:, 0], side="right") - 1
        ok = k >= 0
        ok[ok] &= calls[ok, 1] <= spans[k[ok], 1] + mid
        return int(ok.sum())

    return Fit(mid, int(g), width, (placed(launches, enqueue), len(launches)),
               (placed(syncs, waits), len(syncs)))


def innermost(start: np.ndarray, end: np.ndarray, names: Sequence[str],
              lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """The segments of [lo, hi) labelled with the innermost open span of
    one thread (whose spans nest), ``NONE`` where none is open:
    (start, end, name), in order."""
    out: List[Tuple[float, float, str]] = []
    stack: List[int] = []
    cur = lo

    def emit(t, name):
        nonlocal cur
        a, b = max(cur, lo), min(t, hi)
        if b > a:
            out.append((a, b, name))
        cur = max(cur, t)

    for i in np.lexsort((-end, start)):
        while stack and end[stack[-1]] <= start[i]:
            j = stack.pop()
            emit(end[j], names[j])
        emit(start[i], names[stack[-1]] if stack else NONE)
        stack.append(i)
    while stack:
        j = stack.pop()
        emit(end[j], names[j])
    emit(hi, NONE)
    return out


def idle(busy: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The gaps of [lo, hi) outside the busy intervals (sorted, disjoint)."""
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def split(segments: Sequence[Tuple[float, float, str]],
          gaps: Sequence[Tuple[float, float]]) -> Dict[str, float]:
    """The gaps' time by the label of the segments over them (both
    sorted; the segments cover the gaps)."""
    out: Dict[str, float] = {}
    j = 0
    for gs, ge in gaps:
        while j < len(segments) and segments[j][1] <= gs:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < ge:
            s, e, n = segments[k]
            d = min(e, ge) - max(s, gs)
            if d > 0:
                out[n] = out.get(n, 0.0) + d
            k += 1
    return out


def compute(trace, window_s: float, sp) -> Tuple[Optional[View], str]:
    """The view of one run's trace and spans, or None and why. Trace
    times are taken relative to the window's end (whole nanoseconds since
    the epoch are beyond float64's exact integers)."""
    if not trace.host:
        return None, "the recorder kept no host calls"
    base = max(s + d for _, s, d in trace.host)
    lo, hi = -window_s * 1e9, 0.0
    host = [(n, s - base, d) for n, s, d in trace.host
            if lo <= s - base <= hi]
    busy = [(s - base, e - base) for s, e in trace.busy()]
    names = sp.names
    start = sp.start.astype(np.float64)
    end = sp.end.astype(np.float64)
    # Each ring's first guess of the offset picks the dispatching thread.
    guess = {t: w - p - base for t, (p, w) in sp.clock.items()}
    shift = np.array([guess[t] for t in sp.thread], np.float64)
    enq = sp.of("enqueue")
    near = enq & (end + shift >= lo) & (start + shift <= hi)
    if not near.any():
        return None, "no enqueue span in the window"
    threads, counts = np.unique(sp.thread[near], return_counts=True)
    main = int(threads[np.argmax(counts)])
    mine = sp.thread == main

    def pairs(mask):
        m = mine & mask
        o = np.argsort(start[m])
        return np.stack([start[m][o], end[m][o]], axis=1)

    # The oldest span a full ring kept starts inside the window (by the
    # first guess, as far off as the fit looks): the window lost spans.
    if sp.overwritten.get(main, 0) and (
            start[mine].min() + guess[main] > lo - SEARCH_NS):
        return None, ("the dispatching thread's span ring overwrote spans "
                      "of the window")
    waits = np.isin(sp.name, [names.index(w) for w in WAITS if w in names])
    fit = fit_clock(host, pairs(enq), pairs(waits), [guess[main], -base])
    if fit is None:
        return None, "no cudaGraphLaunch in the window"
    placed, total = fit.launches
    if placed < MIN_PLACED * total:
        return None, (f"the clock fit placed {placed} of {total} launches "
                      "in enqueue spans")
    s_t, e_t = start + fit.offset_ns, end + fit.offset_ns
    segs = innermost(s_t[mine], e_t[mine],
                     [names[n] for n in sp.name[mine]], lo, hi)
    host_ns: Dict[str, float] = {}
    for s, e, n in segs:
        host_ns[n] = host_ns.get(n, 0.0) + (e - s)
    setup: Optional[Dict[str, float]] = None
    if not any(sp.overwritten.values()):
        setup = {}
        before = s_t < lo
        for n, v in zip(sp.name[before], sp.self_ns()[before]):
            setup[names[n]] = setup.get(names[n], 0.0) + float(v)
    rebuilds = int(sum(((s_t >= lo) & (s_t <= hi) & sp.of(n)).sum()
                       for n in REBUILDS))
    return View(host_ns, split(segs, idle(busy, lo, hi)), setup, rebuilds,
                fit), ""


_last: list = [lambda: None, None]   # [weak ref to a trace, its view]


def view(run) -> Optional[View]:
    """The run's view (computed once a run), or None with the reason on
    standard error."""
    tr = run.obs.trace
    if tr is None:
        return None
    if _last[0]() is not tr:
        sp = read_spans()
        if sp is None:
            got = (None, "the program records no spans")
        else:
            got = compute(tr, run.obs.window_s, sp)
        _last[:] = [weakref.ref(tr), got]
        v, why = got
        if v is None:
            print(f"spans: {why}", file=sys.stderr)
        else:
            f = v.fit
            print(f"spans: clock fit residual {f.residual_ns:.0f} ns "
                  f"(width {f.width_ns:.0f} ns); "
                  f"launches in enqueue {f.launches[0]}/{f.launches[1]}, "
                  f"syncs in waits {f.syncs[0]}/{f.syncs[1]}",
                  file=sys.stderr)
    return _last[1][0]
