"""The benchmark on the card: each cell's run.py end to end, a short
window, untraced and traced. Marked ``cuda``: without a CUDA device they
skip (decided in the fixture). On the card:
``python -m pytest portbench/tests/test_portbench_card.py -m cuda``."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def run_cell(name, trace, seed=2**31 + 99):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", name, "--seed", str(seed), "--seconds", "2",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct(card, name, trace):
    cell = harness.find_cell(name)
    r = run_cell(name, trace)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in cell.metrics(bool(trace))}
    dev = r["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        for m, v in r["metrics"].items():
            if m.startswith(("roofline_pct", "mfu")):
                assert 0 < v["value"] <= 100
