"""Cells cut to a size a CPU test can run: the same files, the frames
and the streams fewer and smaller, the chunks shorter.

A cell's test sizes are a file of its own, ``sizes/<cell>.json``, found
by the cell's name as its limits are: ``{"small": [frame size, pool
frames, streams, chunk], "control": [...]}``. The CPU tests run over the
cells of BENCHMARK.json that have one."""

from __future__ import annotations

import copy
import os
from typing import Dict, List

from portbench import harness


def cell_sizes(name: str) -> dict:
    """The cell's ``sizes/<cell>.json``."""
    return harness.load_json(harness.bench_file("sizes", f"{name}.json"))


def sized_cells() -> List[str]:
    """The workloads of BENCHMARK.json that have a sizes file, sorted."""
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    return sorted(w["name"] for w in spec["workloads"]
                  if os.path.exists(harness.bench_file(
                      "sizes", f"{w['name']}.json")))


def by_kind(kind: str) -> Dict[str, list]:
    return {name: cell_sizes(name)[kind] for name in sized_cells()}


#: frame size, pool frames, streams, chunk of each cell at the small size
SMALL = by_kind("small")

#: the control's size: larger, since the control alone runs (the
#: reference twice), and a max over more values is nearer the card's
CONTROL = by_kind("control")


def small_cell(name: str, dtype: str = None, sizes=SMALL) -> harness.Cell:
    cell = harness.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    hw, pool, streams, chunk = sizes[name]
    if "frame_hw" in cell.traffic:
        cell.traffic["frame_hw"] = hw
    else:
        cell.config["frame_hw"] = hw
    cell.traffic.update(pool_frames=pool, check_every=3)
    if "streams" in cell.traffic:
        cell.traffic["streams"] = streams
    else:
        cell.config["pipeline"]["chunk_size"] = chunk
    if dtype:
        cell.config["pipeline"]["dtype"] = dtype
    return cell


def run_small(name: str, seed: int = 2**31 + 17,
              seconds: float = 1.5) -> dict:
    """One run of the small cell on the CPU; the result."""
    import torch

    torch.set_num_threads(4)
    return harness.execute(small_cell(name), seed, seconds, False,
                           device="cpu")
