"""Resize operations with the JAX package's pinned semantics
(counterpart of vidmat/ops/resize.py).

Bilinear, half-pixel centers (``align_corners=False``), no antialias,
edge-clamped: the sampling ``jax.image.resize(method="bilinear",
antialias=False)`` implements.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def downsample_ratio_shape(h: int, w: int, ratio: float) -> tuple[int, int]:
    """Coarse-pass shape for a downsample ratio, snapped to multiples of 16
    so the encoder's stride-16 features stay integral."""
    def snap(x: int) -> int:
        return max(16, int(round(x * ratio / 16.0)) * 16)
    return snap(h), snap(w)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample (half-pixel centers, no antialias). NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialias. NHWC in and out."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
