"""BENCHMARK.json against the benchmark's contract, and every cell finding
its files by name."""

import dataclasses
import importlib
import json
import os
import re

import numpy as np
import pytest

from portbench import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert m["unit"] != "%" or not m["name"].startswith(
            "roofline_pct") or m["better"] == "higher"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = harness.find_cell(name)
    reported = {m["name"] for m in cell.metrics(False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.metrics(True)
    drv = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    assert callable(drv.drive)
    for m in cell.metrics(False) + cell.metrics(True):
        family = m["name"].split(".", 1)[0]
        mod = importlib.import_module(f"portbench.metrics.{family}")
        assert callable(mod.read)
        if family == "roofline_pct":
            layer = importlib.import_module(
                f"portbench.layers.{m['name'].split('.')[1]}")
            assert layer.work(cell.config, cell.traffic)
    assert cell.limits["limits"]


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_published_preset(name):
    from vidmat_torch import config as vc

    entry = [c for c in SPEC["configs"] if c["name"] == name][0]
    cfg = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    m, p = vc.PRESETS[name]()
    as_json = json.loads(json.dumps({"model": dataclasses.asdict(m),
                                     "pipeline": dataclasses.asdict(p)}))
    assert cfg["model"] == as_json["model"]
    assert cfg["pipeline"] == as_json["pipeline"]
    assert entry["reduced"] == []
    ckpt = {1: "synthetic_demo", 2: "fast_demo"}[m.space_to_depth]
    z = np.load(os.path.join(harness.ROOT, "vidmat_torch", "checkpoints",
                             f"{ckpt}.npz"))
    shipped = {k: list(z[k].shape) for k in z.files}
    assert cfg["variables"] == shipped


def test_multistream_traffic_is_the_published_stream_config():
    from vidmat_torch.config import preset_multistream

    m, p, s = preset_multistream()
    cell = harness.find_cell("video_1080p.multistream_8")
    tr = cell.traffic
    assert (tr["streams"], *tr["frame_hw"]) == (s.num_streams, s.height,
                                                s.width)
    assert tr["chunk_size"] == p.chunk_size == 1
    assert cell.config["pipeline"]["downsample_ratio"] == s.downsample_ratio
