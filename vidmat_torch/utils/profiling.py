"""Tracing and profiling hooks (counterpart of vidmat/utils/profiling.py).

- ``annotate(name)``: a span of the program's host work, as a context
  manager (``spanned(name)``: the same around each call of a function). Spans record by default, each into a bounded ring of the
  thread that opens it: preallocated numpy arrays of ``RING`` spans
  holding the name's id, the start and the end on
  ``time.perf_counter_ns()`` and the enclosing span of the same thread.
  A full ring overwrites its oldest spans and counts them.
  ``enable_spans(False)`` turns recording off (a span then costs one flag
  test); ``spans()`` returns what the rings hold. A span's self time is
  its duration less its children's; a count is the number of spans of a
  name.
- ``maybe_profile(n, logdir)``: context manager tracing the enclosed block
  with ``torch.profiler`` (CPU and, on the card, CUDA activity) when
  n > 0, and writing a Chrome trace (chrome://tracing, Perfetto) into
  ``logdir``, with the block's spans as a process row of their own on
  the profiler's clock.
- ``FrameTimer``: a per-frame latency ring buffer for p50/p99 without
  tracing overhead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

#: spans a thread's ring holds before it overwrites its oldest
RING = 1 << 18

_on = True
_ids: Dict[str, int] = {}
_names: List[str] = []
_rings: List["_Ring"] = []
_lock = threading.Lock()
_made = 0   # rings made so far: a ring's id
_local = threading.local()
#: rings kept after their thread ended; the oldest such go beyond this
_MAX_RINGS = 64


def _clock_pair() -> Tuple[int, int]:
    """(perf_counter_ns, time_ns): the midpoint of two
    ``time.perf_counter_ns()`` readings and the ``time.time_ns()`` reading
    taken between them."""
    p0 = time.perf_counter_ns()
    w = time.time_ns()
    p1 = time.perf_counter_ns()
    return (p0 + p1) // 2, w


class _Ring:
    """One thread's spans, slot ``seq % capacity`` for its seq-th span;
    ``stack`` holds (seq, start) of each open span, outermost first."""

    __slots__ = ("n", "stack", "mask", "arrays", "seq", "name", "start",
                 "end", "parent", "thread", "clock", "id")

    def __init__(self, capacity: int):
        if capacity & (capacity - 1):
            raise ValueError(f"the ring's capacity must be a power of 2; "
                             f"got {capacity}")
        self.n = 0
        self.stack: List[int] = []
        self.mask = capacity - 1
        self.arrays = {"seq": np.full(capacity, -1, np.int64),
                       "name": np.zeros(capacity, np.int64),
                       "start": np.zeros(capacity, np.int64),
                       "end": np.zeros(capacity, np.int64),
                       "parent": np.zeros(capacity, np.int64)}
        # Item writes through memoryviews cost a fraction of numpy's.
        for k, a in self.arrays.items():
            setattr(self, k, memoryview(a))
        self.thread = threading.current_thread()
        self.clock = _clock_pair()
        self.id = -1


def _ring() -> _Ring:
    global _made
    r = _Ring(RING)
    with _lock:
        dead = [x for x in _rings if not x.thread.is_alive()]
        for x in dead[:max(0, len(_rings) + 1 - _MAX_RINGS)]:
            _rings.remove(x)
        _rings.append(r)
        r.id = _made
        _made += 1
    _local.ring = r
    return r


class _Span:
    """A span of one name, shared by every call and thread: what an open
    span needs (its seq, its start) waits on its thread's ring's stack,
    so a span allocates nothing (no garbage collection it sets off)."""

    __slots__ = ("nid",)

    def __init__(self, nid: int):
        self.nid = nid

    def __enter__(self):
        try:
            r = _local.ring
        except AttributeError:
            r = _ring()
        s = r.n
        r.n = s + 1
        st = r.stack
        st.append(s)
        st.append(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        self._close(time.perf_counter_ns())
        return False

    def _close(self, t1: int) -> None:
        r = _local.ring
        st = r.stack
        t0 = st.pop()
        s = st.pop()
        i = s & r.mask
        r.name[i] = self.nid
        r.start[i] = t0
        r.end[i] = t1
        r.parent[i] = st[-2] if st else -1
        r.seq[i] = s


class _Timed(_Span):
    """A span that keeps its start and end (``.ms``), recorded or not."""

    __slots__ = ("record", "t0", "t1")

    def __init__(self, nid: int, record: bool):
        super().__init__(nid)
        self.record = record

    def __enter__(self):
        if self.record:
            super().__enter__()
            self.t0 = _local.ring.stack[-1]
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.record:
            self._close(self.t1)
        return False

    @property
    def ms(self) -> float:
        """The span's duration, once closed."""
        return (self.t1 - self.t0) * 1e-6


class _Off:
    """The span while recording is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_spans: Dict[str, _Span] = {}


def _name_id(name: str) -> int:
    with _lock:
        nid = _ids.get(name)
        if nid is None:
            nid = _ids[name] = len(_names)
            _names.append(name)
            _spans[name] = _Span(nid)
    return nid


def annotate(name: str, timed: bool = False):
    """A span named ``name`` around the enclosed host work. ``timed``: the
    span also times itself while recording is off (``.ms`` once closed,
    for callers that report the duration)."""
    if timed:
        return _Timed(_name_id(name), _on)
    if not _on:
        return _OFF
    span = _spans.get(name)
    if span is None:
        _name_id(name)
        span = _spans[name]
    return span


def spanned(name: str):
    """Decorator: each call of the function is one span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable_spans(on: bool = True) -> None:
    """Record spans (the default), or not."""
    global _on
    _on = bool(on)


@dataclasses.dataclass
class Spans:
    """The spans the rings hold, one entry each (open spans are left
    out). Times are ``time.perf_counter_ns()``; ``parent`` is the seq of
    the enclosing span of the same thread, -1 at the top."""

    names: List[str]          # name id -> name
    thread: np.ndarray        # the recording thread's ring id
    seq: np.ndarray           # the span's number on its thread
    name: np.ndarray          # name id
    start: np.ndarray
    end: np.ndarray
    parent: np.ndarray
    overwritten: Dict[int, int]   # ring id -> spans the full ring overwrote
    clock: Dict[int, Tuple[int, int]]  # ring id -> its _clock_pair()
    thread_names: Dict[int, str]  # ring id -> its thread's name

    def of(self, name: str) -> np.ndarray:
        """Mask of the spans named ``name``."""
        nid = self.names.index(name) if name in self.names else -2
        return self.name == nid

    def self_ns(self) -> np.ndarray:
        """Each span's duration less its children's."""
        dur = self.end - self.start
        out = dur.copy()
        if not len(dur):
            return out
        _, tix = np.unique(self.thread, return_inverse=True)
        key = tix.astype(np.int64) << 40 | self.seq
        order = np.argsort(key)
        has = self.parent >= 0
        pkey = tix[has].astype(np.int64) << 40 | self.parent[has]
        at = np.searchsorted(key[order], pkey)
        at = np.minimum(at, len(key) - 1)
        found = key[order][at] == pkey
        np.subtract.at(out, order[at[found]], dur[has][found])
        return out


def spans() -> Spans:
    """A copy of every ring's closed spans, ordered by thread and seq."""
    with _lock:
        rings = list(_rings)
        names = list(_names)
    cols = {k: [] for k in ("thread", "seq", "name", "start", "end",
                            "parent")}
    over, clocks, tnames = {}, {}, {}
    for r in rings:
        a = {k: v.copy() for k, v in r.arrays.items()}
        ok = a["seq"] >= 0
        order = np.argsort(a["seq"][ok])
        ident = r.id
        for k in ("seq", "name", "start", "end", "parent"):
            cols[k].append(a[k][ok][order])
        cols["thread"].append(np.full(int(ok.sum()), ident, np.int64))
        over[ident] = max(0, r.n - (r.mask + 1))
        clocks[ident] = r.clock
        tnames[ident] = r.thread.name
    arrs = {k: (np.concatenate(v) if v else np.zeros(0, np.int64))
            for k, v in cols.items()}
    return Spans(names, overwritten=over, clock=clocks,
                 thread_names=tnames, **arrs)


#: the marker whose position in a profiler trace puts spans on its clock
CLOCK_MARK = "vidmat_spans_clock"


def _chrome_spans(path: str, mark_ns: int, t_begin: int, t_end: int) -> int:
    """Add the spans closed in [t_begin, t_end] to the Chrome trace at
    ``path`` as a process of their own, placed by the last
    ``CLOCK_MARK`` event, inside which perf_counter_ns() read
    ``mark_ns``. Returns their number."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    mark = [e for e in events if e.get("name") == CLOCK_MARK
            and e.get("ph") == "X"]
    if not mark:
        return 0
    # The marker's middle on the profiler's clock (us) against the
    # reading taken inside it (ns): off by at most half its duration.
    last = max(mark, key=lambda e: e["ts"])
    at_us = last["ts"] + last.get("dur", 0.0) / 2
    base_ns = mark_ns
    sp = spans()
    keep = (sp.start >= t_begin) & (sp.end <= t_end)
    pid = max((e["pid"] for e in events if isinstance(e.get("pid"), int)),
              default=0) + 1
    out = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": "vidmat_torch spans"}}]
    for ident, tname in sp.thread_names.items():
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": ident, "args": {"name": tname}})
    for t, n, s, e in zip(sp.thread[keep], sp.name[keep], sp.start[keep],
                          sp.end[keep]):
        out.append({"ph": "X", "name": sp.names[n], "pid": pid,
                    "tid": int(t), "ts": at_us + (int(s) - base_ns) / 1e3,
                    "dur": (int(e) - int(s)) / 1e3})
    trace["traceEvents"] = events + out
    with open(path, "w") as f:
        json.dump(trace, f)
    return int(keep.sum())


@contextlib.contextmanager
def maybe_profile(num_frames: int, logdir: str = "vidmat_trace"):
    """Trace the enclosed block with torch.profiler when num_frames > 0;
    the Chrome trace is written to ``logdir``/trace.json, with the
    block's spans as a process of their own on the profiler's clock."""
    if not num_frames:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t_begin = time.perf_counter_ns()
        for _ in range(2):   # the first call warms record_function up
            with record_function(CLOCK_MARK):
                mark_ns = time.perf_counter_ns()
        yield
        t_end = time.perf_counter_ns()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    n = _chrome_spans(path, mark_ns, t_begin, t_end)
    print(f"profile trace written to {path} ({n} spans)")


class FrameTimer:
    """Ring buffer of per-frame wall times; O(1) memory for long videos."""

    def __init__(self, capacity: int = 4096):
        self.buf = np.zeros(capacity, np.float64)
        self.n = 0
        self.capacity = capacity
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.buf[self.n % self.capacity] = now - self._last
            self.n += 1
        self._last = now

    def percentiles(self, ps=(50, 99)) -> dict:
        if not self.n:
            return {f"p{p}_ms": 0.0 for p in ps}
        valid = self.buf[:min(self.n, self.capacity)]
        return {f"p{p}_ms": float(np.percentile(valid, p) * 1e3) for p in ps}
