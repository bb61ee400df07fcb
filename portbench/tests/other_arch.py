"""A stand-in architecture for the tests that show a second one fits the
benchmark with files of its own: one 3x3 depthwise convolution with ReLU
on the RGB frame, then a 1x1 head to four channels, the foreground
residual first and the alpha last.

It gives what a configuration's modules give: what a reference module
gives ``weights.py`` (``HEAD``, ``alpha_channels``, ``head_output``), what
a net layer module gives the roofline and ``mfu`` readers (``matches``,
``work``, ``flops_per_frame``), and, for the configuration check, its
presets (``PRESETS``). ``CONFIG`` is a configuration file's content that
names it, as ``reference_other_arch`` and as the net ``other_arch``, with
no shipped checkpoint: its ``variables`` stand for shapes copied from the
weights file its ``source`` names."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from portbench.yardstick import BF16_FLOPS_PER_S, PLANE_BYTES, Work, geometry


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    kernel: int = 3
    out_channels: int = 4


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    downsample_ratio: float = 1.0
    chunk_size: int = 2


PRESETS = {"other_arch": lambda: (ModelConfig(), PipelineConfig())}


CONFIG = {
    "name": "other_arch",
    "source": "a stand-in, its shapes as https://example.org/other_arch.pth"
              " would state them",
    "reference": "reference_other_arch",
    "checkpoint": None,
    "net": "other_arch",
    "model": dataclasses.asdict(ModelConfig()),
    "pipeline": dataclasses.asdict(PipelineConfig()),
    "frame_hw": [48, 64],
    "variables": {"params/dw/bias": [3], "params/dw/kernel": [3, 3, 1, 3],
                  "params/head/bias": [4],
                  "params/head/kernel": [1, 1, 3, 4]},
}


# ---- the reference module's calibration hooks ----

HEAD = "params/head"


def alpha_channels(n: int) -> np.ndarray:
    return np.arange(n) == n - 1


def _weight(variables: dict, name: str) -> torch.Tensor:
    return torch.as_tensor(variables["params"][name]["kernel"]).permute(
        3, 2, 0, 1)


def forward(variables: dict, frame: np.ndarray) -> torch.Tensor:
    """(N, h, w, 3) uint8 -> the head's raw output (N, 4, h, w)."""
    p = variables["params"]
    x = torch.from_numpy(np.ascontiguousarray(frame)).permute(
        0, 3, 1, 2).float() / 255.0
    y = F.relu(F.conv2d(x, _weight(variables, "dw"),
                        torch.as_tensor(p["dw"]["bias"]), padding=1,
                        groups=3))
    return F.conv2d(y, _weight(variables, "head"),
                    torch.as_tensor(p["head"]["bias"]))


def head_output(variables: dict, config: dict, traffic: dict,
                frames: np.ndarray, device) -> torch.Tensor:
    return forward(variables, frames[-1])


# ---- the net layer module's counts ----


def matches(name: str) -> bool:
    return name.startswith("other_arch_")


def work(config: dict, traffic: dict):
    geo = geometry(config, traffic)
    px = geo.frames * geo.grid_h * geo.grid_w
    return [Work("dw", (px * 3 * 2 + 9 * 3) * PLANE_BYTES, 2.0 * 9 * 3 * px,
                 BF16_FLOPS_PER_S),
            Work("head", (px * (3 + 4) + 3 * 4) * PLANE_BYTES,
                 2.0 * 3 * 4 * px, BF16_FLOPS_PER_S)]


def flops_per_frame(config: dict, traffic: dict) -> float:
    geo = geometry(config, traffic)
    return 2.0 * (9 * 3 + 3 * 4) * geo.grid_h * geo.grid_w
