"""A second architecture fits the benchmark with files of its own: the
stand-in of ``other_arch.py``, found by the names its configuration
states, goes through the seeded weights, the ``mfu`` and roofline
counting, the configuration check and the test sizes on the CPU; and no
generic file of the benchmark names the planar net's parts."""

import ast
import copy
import json
import os
import sys

import numpy as np
import pytest

from portbench import frames, harness, weights
from portbench.tests import other_arch, small
from portbench.tests.test_portbench_spec import check_published
from portbench.yardstick import BF16_FLOPS_PER_S

CELL = "other_arch.convert_alpha"
TRAFFIC = harness.load_json(harness.bench_file("traffic",
                                               "convert_alpha.json"))


@pytest.fixture
def other(monkeypatch):
    """The stand-in, importable by the names its configuration states."""
    cfg = other_arch.CONFIG
    monkeypatch.setitem(sys.modules, f"portbench.{cfg['reference']}",
                        other_arch)
    monkeypatch.setitem(sys.modules, f"portbench.layers.{cfg['net']}",
                        other_arch)
    return copy.deepcopy(cfg)


def test_seeded_weights_calibrate_the_last_channel_as_alpha(other):
    h, w = other["frame_hw"]
    pool = frames.make_streams(7, 2, weights.CALIBRATION_FRAMES, h, w,
                               TRAFFIC["scene"], "cpu")
    var = weights.make_variables(other["variables"], 2**33 + 1, "cpu",
                                 other, TRAFFIC, pool)
    assert {f"params/{k}/{leaf}": list(v.shape)
            for k, leaves in var["params"].items()
            for leaf, v in leaves.items()} == other["variables"]
    out = other_arch.forward(var, pool[-1])
    mean = out.mean(dim=(0, 2, 3)).double().numpy()
    std = out.std(dim=(0, 2, 3)).double().numpy()
    np.testing.assert_allclose(mean, [0, 0, 0, weights.ALPHA_MEAN],
                               atol=1e-5)
    np.testing.assert_allclose(std, [weights.FGR_STD] * 3
                               + [weights.ALPHA_STD], rtol=1e-4)


def test_mfu_and_roofline_count_the_named_net(other):
    cell = harness.Cell({}, {"name": CELL, "chips": 1}, other, TRAFFIC, {})
    trace = harness.Trace(device=[("other_arch_dw", 0, 2_000_000),
                                  ("other_arch_head", 2_000_000, 1_000_000),
                                  ("Memcpy HtoD", 3_000_000, 1_000_000)],
                          host=[])
    obs = harness.Observation(frames=10, attempted=10, window_s=1.0,
                              setup_s=0.0, samples={}, pool=None,
                              trace=trace)
    h, w = other["frame_hw"]
    flops = 2.0 * (9 * 3 + 3 * 4) * h * w
    assert harness.read_metric(cell, obs, {"name": "mfu.other"}) == \
        pytest.approx(100.0 * flops * 10 / (4e-3 * BF16_FLOPS_PER_S))
    work = other_arch.work(other, TRAFFIC)
    least = sum(u.least_s for u in work) / other["pipeline"]["chunk_size"]
    got = harness.read_metric(cell, obs,
                              {"name": "roofline_pct.other_arch.other"})
    assert got == pytest.approx(100.0 * least * 10 / 3e-3)


def test_configuration_check_takes_its_stated_shapes(other):
    """No shipped checkpoint: the check holds the file's own shapes, which
    its ``source`` says whence, and asks nothing of the stand-in's code."""
    entry = {"name": other["name"], "reduced": []}
    check_published(entry, other, other_arch.PRESETS)
    wrong = dict(other["variables"], **{"params/head/bias": []})
    for bad in (dict(other, variables=wrong), dict(other, variables={}),
                dict(other, source="a stand-in with no weights file")):
        with pytest.raises(AssertionError):
            check_published(entry, bad, other_arch.PRESETS)


def test_sizes_are_found_by_the_cell_name(other, tmp_path, monkeypatch):
    """A benchmark tree of the stand-in's files alone: its cell is found,
    its sizes file read and applied, a cell without one left out."""
    bench = tmp_path / "portbench"
    files = {
        "configs/other_arch.json": other,
        "traffic/convert_alpha.json": TRAFFIC,
        f"limits/{CELL}.json": {"limits": {"max_lsb": 1.0}},
        f"sizes/{CELL}.json": {"small": [[32, 48], 4, 1, 2],
                               "control": [[64, 96], 4, 1, 4]},
    }
    for path, content in files.items():
        (bench / path).parent.mkdir(parents=True, exist_ok=True)
        (bench / path).write_text(json.dumps(content))
    spec = {"configs": [{"name": "other_arch",
                         "file": "portbench/configs/other_arch.json"}],
            "workloads": [{"name": CELL, "config": "other_arch",
                           "traffic": "convert_alpha", "chips": 1},
                          {"name": "other_arch.unsized",
                           "config": "other_arch",
                           "traffic": "convert_alpha", "chips": 1}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench))
    assert small.sized_cells() == [CELL]
    sizes = small.by_kind("control")
    assert sizes == {CELL: [[64, 96], 4, 1, 4]}
    cell = small.small_cell(CELL, sizes=sizes)
    assert cell.config["frame_hw"] == [64, 96]
    assert cell.config["pipeline"]["chunk_size"] == 4
    assert cell.traffic["pool_frames"] == 4


#: the planar net's names, which only its own files may use
PLANAR_NAMES = ("enc_channels", "dec_channels", "PlanarNetwork", "fast_demo",
                "synthetic_demo")
#: its files: the net layer, the reference, the configuration
PLANAR_FILES = ("layers/net.py", "reference.py", "configs/video_1080p.json")
GENERIC = sorted(
    os.path.relpath(os.path.join(d, f), harness.BENCH_DIR)
    for d, dirs, fs in os.walk(harness.BENCH_DIR)
    if not os.path.relpath(d, harness.BENCH_DIR).startswith("tests")
    and "__pycache__" not in d for f in fs)
GENERIC = [p for p in GENERIC if p not in PLANAR_FILES]


def words(path: str):
    """The names and strings of a Python file (its syntax tree's
    identifiers, attributes, imports, arguments and constants), or the
    text of any other file."""
    text = open(os.path.join(harness.BENCH_DIR, path)).read()
    if not path.endswith(".py"):
        yield text
        return
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, ast.alias):
            yield node.name
            yield node.asname or ""
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.arg):
            yield node.arg
        elif isinstance(node, ast.keyword):
            yield node.arg or ""
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


@pytest.mark.parametrize("path", GENERIC)
def test_generic_file_names_no_planar_part(path):
    found = sorted({n for w in words(path) for n in PLANAR_NAMES if n in w})
    assert not found, f"{path} names {found}"


def test_the_scan_sees_the_planar_names():
    """The scan finds the names where they belong."""
    for path in PLANAR_FILES[:2]:
        assert {n for w in words(path) for n in PLANAR_NAMES if n in w}
    assert any("fast_demo" in w for w in words(PLANAR_FILES[2]))
