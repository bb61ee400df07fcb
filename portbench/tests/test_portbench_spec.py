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
    net = importlib.import_module(f"portbench.layers.{cell.config['net']}")
    assert net.work(cell.config, cell.traffic)
    assert net.flops_per_frame(cell.config, cell.traffic) > 0
    ref = importlib.import_module(f"portbench.{cell.config['reference']}")
    assert callable(ref.run) and callable(ref.head_output)
    assert callable(ref.alpha_channels) and ref.HEAD
    for m in cell.metrics(False) + cell.metrics(True):
        family = m["name"].split(".", 1)[0]
        mod = importlib.import_module(f"portbench.metrics.{family}")
        assert callable(mod.read)
        if family == "roofline_pct":
            layer = importlib.import_module(
                f"portbench.layers.{m['name'].split('.')[1]}")
            assert layer.work(cell.config, cell.traffic)
    assert cell.limits["limits"]


#: a public file of weights: what the ``source`` of a configuration without
#: a shipped checkpoint names, the file its ``variables`` are copied from
WEIGHTS_FILE = re.compile(
    r"https://\S+\.(pth|pt|ckpt|safetensors|npz|onnx)(\s|$|[;,)])")


def check_published(entry: dict, cfg: dict, presets) -> None:
    """A configuration file against what it names: its model and pipeline
    are its preset's (``presets[cfg["name"]]()``), uncut, and its
    variables' shapes are the shipped checkpoint's (``"checkpoint"``:
    ``vidmat_torch/checkpoints/<name>.npz``). A file that names no
    checkpoint states the shapes itself, copied from the public weights
    file its ``source`` names; nothing of the port stands in for them."""
    m, p = presets[cfg["name"]]()[:2]
    as_json = json.loads(json.dumps({"model": dataclasses.asdict(m),
                                     "pipeline": dataclasses.asdict(p)}))
    assert cfg["model"] == as_json["model"]
    assert cfg["pipeline"] == as_json["pipeline"]
    assert entry["reduced"] == []
    if cfg["checkpoint"] is None:
        assert WEIGHTS_FILE.search(cfg["source"]), cfg["source"]
        assert cfg["variables"]
        for path, shape in cfg["variables"].items():
            assert shape and all(type(d) is int and d > 0 for d in shape), \
                path
    else:
        z = np.load(os.path.join(harness.ROOT, "vidmat_torch", "checkpoints",
                                 f"{cfg['checkpoint']}.npz"))
        shipped = {k: list(z[k].shape) for k in z.files}
        assert cfg["variables"] == shipped


def config_file(name: str):
    entry = [c for c in SPEC["configs"] if c["name"] == name][0]
    return entry, harness.load_json(os.path.join(harness.ROOT,
                                                 entry["file"]))


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_published_preset(name):
    from vidmat_torch import config as vc

    entry, cfg = config_file(name)
    check_published(entry, cfg, vc.PRESETS)


def test_config_without_checkpoint_states_its_shapes():
    """The ``"checkpoint": null`` branch takes the file's own shapes only
    where its ``source`` names the public weights file they come from:
    video_1080p's, which names none, fails without its checkpoint, and
    passes with a weights file named; a shape of 0 fails."""
    from vidmat_torch import config as vc

    entry, cfg = config_file("video_1080p")
    assert cfg["checkpoint"] == "fast_demo"
    cfg = dict(cfg, checkpoint=None)
    with pytest.raises(AssertionError):
        check_published(entry, cfg, vc.PRESETS)
    cfg["source"] += "; https://example.org/video_1080p/weights.npz"
    check_published(entry, cfg, vc.PRESETS)
    wrong = dict(cfg["variables"], **{"params/head/bias": [0]})
    with pytest.raises(AssertionError):
        check_published(entry, dict(cfg, variables=wrong), vc.PRESETS)


def test_multistream_traffic_is_the_published_stream_config():
    from vidmat_torch.config import preset_multistream

    m, p, s = preset_multistream()
    cell = harness.find_cell("video_1080p.multistream_8")
    tr = cell.traffic
    assert (tr["streams"], *tr["frame_hw"]) == (s.num_streams, s.height,
                                                s.width)
    assert tr["chunk_size"] == p.chunk_size == 1
    assert cell.config["pipeline"]["downsample_ratio"] == s.downsample_ratio
