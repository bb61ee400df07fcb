"""Tracing and profiling hooks (counterpart of vidmat/utils/profiling.py).

- ``maybe_profile(n, logdir)``: context manager tracing the enclosed block
  with ``torch.profiler`` (CPU and, on the card, CUDA activity) when
  n > 0, and writing a Chrome trace (chrome://tracing, Perfetto) into
  ``logdir``.
- ``annotate(name)``: a stage annotation (``torch.profiler.record_function``)
  that shows up on the trace timeline.
- ``FrameTimer``: a per-frame latency ring buffer for p50/p99 without
  tracing overhead.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np


@contextlib.contextmanager
def maybe_profile(num_frames: int, logdir: str = "vidmat_trace"):
    """Trace the enclosed block with torch.profiler when num_frames > 0;
    the Chrome trace is written to ``logdir``/trace.json."""
    if not num_frames:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")


def annotate(name: str):
    """Stage annotation context (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)


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
