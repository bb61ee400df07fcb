"""Device resolution shared by the port's public entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to ``"cuda"`` and raise when no CUDA device is
    present: a run that silently fell back to the CPU would report CPU
    numbers as the port's. Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels on the CPU (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
