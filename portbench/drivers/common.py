"""What the drivers share: the program's configuration as the file states
it, and the seeded inputs."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from portbench import frames, weights
from portbench.yardstick import frame_hw


def program_configs(config: dict):
    """The port's ModelConfig and PipelineConfig with the file's values."""
    from vidmat_torch.config import ModelConfig, PipelineConfig, RefineConfig

    model = {k: tuple(v) if isinstance(v, list) else v
             for k, v in config["model"].items()}
    pipe = dict(config["pipeline"])
    pipe["refine"] = RefineConfig(**pipe["refine"])
    return ModelConfig(**model), PipelineConfig(**pipe)


def build_program(device) -> None:
    """Build the program's kernels and host staging library where they are
    not built yet (all sources at once: each builds at its first use
    otherwise, one after the other)."""
    if device != "cuda":
        return
    from vidmat_torch.io import native
    from vidmat_torch.ops import _build

    _build.build()
    native.have_native()


def inputs(cell, seed: int, device) -> Tuple[np.ndarray, dict]:
    """The frames, (pool, streams, h, w, 3) uint8 in host memory, and the
    variables, both from the seed."""
    tr = cell.traffic
    fh, fw = frame_hw(cell.config, tr)
    pool = frames.make_streams(seed, int(tr.get("streams", 1)),
                               int(tr["pool_frames"]), fh, fw, tr["scene"],
                               device)
    variables = weights.make_variables(cell.config["variables"], seed,
                                       device, cell.config, tr,
                                       pool[:weights.CALIBRATION_FRAMES])
    return pool, variables
