"""One run of one cell: find its files by name, drive it, read its metrics,
check its outputs against the reference, print the result line.

The device's busy time comes from ``torch.profiler`` recording CUDA
activity only (kernels, copies, sets, and the host's CUDA runtime calls:
no shapes, no stacks, no torch ops), started before the window and read
after it. A ``--trace 1`` run reads the same recorder for its per-layer
metrics and its breakdown; it records no host ops, which would slow the
host path that the device waits on in a host-fed cell.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: what a run writes: caches and the traced runs' summaries
STATE_DIR = os.path.join(ROOT, ".portbench")

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vidmat")


class CellError(RuntimeError):
    """The cell cannot run here; the message says why."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_file(*parts: str) -> str:
    return os.path.join(BENCH_DIR, *parts)


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with the files its names lead to."""

    spec: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> List[dict]:
        """The metric entries this cell reports: the end-to-end ones, or
        with ``trace`` the per-layer ones."""
        if not trace:
            return [m for m in self.spec["end_to_end"]
                    if self.name in m.get("workloads", [self.name])]
        e2e = {m["name"] for m in self.metrics(False)}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def find_cell(name: str, spec: Optional[dict] = None) -> Cell:
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    work = [w for w in spec["workloads"] if w["name"] == name]
    if not work:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]]
    if not conf:
        raise CellError(f"no configuration {w['config']!r}")
    return Cell(spec, w, load_json(os.path.join(ROOT, conf[0]["file"])),
                load_json(bench_file("traffic", f"{w['traffic']}.json")),
                load_json(bench_file("limits", f"{name}.json")))


# ---- the recorder ----


@dataclasses.dataclass
class Trace:
    """What the recorder read: device operations and the host's CUDA
    runtime calls, each (name, start ns, duration ns), on the profiler's
    clock."""

    device: List[tuple]
    host: List[tuple]

    def busy(self) -> List[tuple]:
        """The device's busy intervals: the union of every operation's,
        overlaps counted once, sorted."""
        merged: List[list] = []
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            e = s + d
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def device_s(self, match: Callable[[str], bool]) -> float:
        """The summed device time of the operations whose name matches."""
        return sum(d for n, _, d in self.device if match(n)) * 1e-9


class Recorder:
    """torch.profiler over CUDA activity."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            record_shapes=False, with_stack=False,
                            profile_memory=False)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> Trace:
        import warnings

        from torch.autograd import DeviceType

        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle.
            warnings.simplefilter("ignore", UserWarning)
            self.prof.stop()
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns(), e.duration_ns())
            if e.device_type() != DeviceType.CUDA:
                host.append(item)
            elif not getattr(e, "is_user_annotation", lambda: False)():
                dev.append(item)
        return Trace(dev, host)


# ---- what a driver hands back ----


@dataclasses.dataclass
class Observation:
    """A driven window. Indices count dispatches from the run's first
    (warm-up included); a dispatch is one frame of a conversion or one
    round of S streams."""

    frames: int                   # frames whose output came back in time
    attempted: int                # frames sent in the window
    window_s: float
    setup_s: float
    samples: Dict[int, np.ndarray]    # index -> (S, h, w, C) uint8
    pool: np.ndarray              # (P, S, h, w, 3) uint8: index i is i % P
    trace: Optional[Trace] = None
    variables: Optional[dict] = None


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    record: bool = True

    def note(self, what: str) -> None:
        """Print how far into the run a step of set-up ended."""
        print(f"setup: {what} at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr)


class Sampler:
    """Which of the window's dispatches are kept for the check: gaps drawn
    from the seed, ``every`` apart on average."""

    def __init__(self, seed: int, every: int):
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.every = max(1, int(every))
        self.next = self._gap() - 1

    def _gap(self) -> int:
        return int(self.rng.integers(1, 2 * self.every))

    def keep(self, j: int) -> bool:
        if j < self.next:
            return False
        self.next = j + self._gap()
        return True


# ---- metrics ----


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    obs: Observation
    metric: dict

    @property
    def frames(self) -> int:
        return self.obs.frames


def read_metric(cell: Cell, obs: Observation, m: dict) -> Optional[float]:
    """The reader ``metrics/<first part of the name>.py`` on this run."""
    family = m["name"].split(".", 1)[0]
    mod = importlib.import_module(f"portbench.metrics.{family}")
    return mod.read(Run(cell, obs, m))


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the innermost CUDA runtime call around its
    middle (none: the host was working outside CUDA calls)."""
    per: Dict[str, int] = {}
    for n, _, d in tr.device:
        per[n] = per.get(n, 0) + d
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    busy = tr.busy()
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    hosts = sorted(tr.host, key=lambda e: e[1])
    starts = np.array([h[1] for h in hosts], dtype=np.int64)
    out = []
    for gap, at in gaps:
        mid = at + gap // 2
        k = int(np.searchsorted(starts, mid, side="right"))
        inner = None
        for n, s, d in hosts[max(0, k - 2000):k]:
            if s <= mid <= s + d and (inner is None or d < inner[1]):
                inner = (n, d)
        out.append([inner[0] if inner else "host outside CUDA calls",
                    gap * 1e-9])
    return {"device_ops": [[n, d * 1e-9] for n, d in ops],
            "idle_gaps": out}


def write_trace_slice(tr: Trace, path: str, seconds: float = 2.0) -> None:
    """A Chrome trace of the first ``seconds`` of the window."""
    t0 = min((e[1] for e in tr.device), default=0)
    end = t0 + int(seconds * 1e9)
    ev = [{"name": n, "ph": "X", "ts": s / 1e3, "dur": d / 1e3, "pid": pid,
           "tid": 0}
          for pid, evs in ((0, tr.device), (1, tr.host))
          for n, s, d in evs if t0 <= s < end]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


# ---- the run ----


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN)


def check_no_jax() -> None:
    bad = loaded_forbidden()
    if bad:
        raise CellError("modules of JAX or the JAX package were loaded: "
                        + ", ".join(bad))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def drive(ctx: Context) -> Observation:
    traffic = ctx.cell.traffic
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return mod.drive(ctx)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Drive the cell, read its metrics, check its outputs; returns the
    result (without printing it)."""
    import torch

    from portbench import check

    # The recorder runs where a metric of this run reads the device's
    # trace, and in every traced run.
    record = device == "cuda" and (trace or any(
        m["source"] == "device_trace" for m in cell.metrics(False)))
    ctx = Context(cell, int(seed), float(seconds), bool(trace), device,
                  time.perf_counter() if t_start is None else t_start,
                  record)
    obs = drive(ctx)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name()
    else:
        peak, kind = 0, "cpu"
    check_no_jax()
    metrics = {}
    for m in cell.metrics(trace):
        v = read_metric(cell, obs, m)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": False, "attempted": obs.attempted,
              "failed": obs.attempted - obs.frames, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": int(cell.workload["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace and obs.trace is not None:
        result["device"]["busy_s"] = obs.trace.busy_s()
        result["device"]["window_s"] = obs.window_s
        result["breakdown"] = breakdown(obs.trace)
        write_trace_slice(obs.trace, os.path.join(
            STATE_DIR, "traces", f"{cell.name}-{seed}.json"))
    if cuda:
        result["device"]["power_limit"] = power_limit()
    obs.trace = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = check.check(cell, obs, device)
    print(f"check: {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    result["failed"] += failed
    result["correct"] = (result["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    check_no_jax()
    return result


def main(args, require_card: bool = True) -> int:
    """Run one cell once and print its result line; the exit code."""
    try:
        cell = find_cell(args.workload)
    except (CellError, OSError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell.workload["chips"])
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        print(f"portbench: {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         t_start=args.t_start)
    except CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
