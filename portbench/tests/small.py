"""Cells cut to a size a CPU test can run: the same files, the frames
and the streams fewer and smaller, the chunks shorter."""

from __future__ import annotations

import copy

from portbench import harness

#: frame size, pool frames, streams, chunk of each cell at the small size
SMALL = {
    "video_1080p.convert_alpha": ([120, 256], 6, 1, 2),
    "video_1080p.multistream_8": ([128, 256], 6, 2, 1),
}


#: the control's size: larger, since the control alone runs (the
#: reference twice), and a max over more values is nearer the card's
CONTROL = {
    "video_1080p.convert_alpha": ([376, 640], 6, 1, 4),
    "video_1080p.multistream_8": ([512, 896], 6, 4, 1),
}


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
