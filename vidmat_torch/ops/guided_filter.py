"""Guided-filter statistics in plain PyTorch (counterpart of
vidmat/ops/guided_filter.py: ``gray_guide``, the edge-truncated box mean
and ``box_blur``, the portrait-blur background).

The box mean sums the (2r+1)^2 window with zero padding, rows first, then
columns, each pass adding the 2r+1 shifted terms in ascending order, and
multiplies by 1 / (number of in-image pixels in the window). The CUDA
kernel ``csrc/gf_coeffs.cu`` adds in the same order, so the two agree to
the last bit wherever the compiler keeps each operation rounded.

All arrays NHWC float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _luma_weights(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # Made once per device: a host-to-device copy inside a captured CUDA
    # graph (the pipeline's chunk body) is not allowed.
    return torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=device)


def gray_guide(rgb: torch.Tensor) -> torch.Tensor:
    """Luma projection used as the guide. NHWC (..., 3) -> (..., 1)."""
    return (rgb * _luma_weights(rgb.dtype, rgb.device)).sum(dim=-1,
                                                            keepdim=True)


def box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """Zero-padded (2r+1)^2 window sum of an NHWC tensor, rows then
    columns."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 0, 0, r, r))
    s = xp[:, 0:h]
    for d in range(1, 2 * r + 1):
        s = s + xp[:, d:d + h]
    sp = F.pad(s, (0, 0, r, r))
    t = sp[:, :, 0:w]
    for d in range(1, 2 * r + 1):
        t = t + sp[:, :, d:d + w]
    return t


def inv_window_count(h: int, w: int, r: int, device="cpu") -> torch.Tensor:
    """1 / (in-image pixels of each window), (1, H, W, 1) float32: the
    separable count (min(i+r, H-1) - max(i-r, 0) + 1) * (same for j)."""
    def counts(n):
        i = torch.arange(n, device=device)
        return torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0) + 1
    cnt = (counts(h)[:, None] * counts(w)[None, :]).to(torch.float32)
    return (1.0 / cnt)[None, :, :, None]


def box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-truncated (2r+1)^2 box mean of an NHWC tensor."""
    _, h, w, _ = x.shape
    return box_sum(x, r) * inv_window_count(h, w, r, x.device)


def box_blur(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Edge-truncated (2r+1)^2 mean blur of an NHWC tensor: the background
    of the portrait-blur path, taken at the coarse grid
    (vidmat/ops/guided_filter.py ``box_blur``; plain XLA there too)."""
    return box_mean(x, radius)


def guided_upsample(rgb_full: torch.Tensor, alpha_lr: torch.Tensor,
                    fgr_lr: torch.Tensor, radius: int = 4, eps: float = 1e-4,
                    kernels: bool = True):
    """Fast guided upsample of coarse (alpha, fgr) to the full-resolution
    grid (vidmat/ops/guided_filter.py ``guided_upsample``): the statistics
    at the coarse grid against the bilinearly downsampled luma guide, the
    coefficients bilinearly upsampled, ``mean_a * guide_full + mean_b``,
    clipped. The serving path where the coarse grid is no integer pool of
    the frame.

    rgb_full (N, H, W, 3) float in [0, 1]; alpha_lr (N, h, w, 1), fgr_lr
    (N, h, w, 3). kernels: the coefficients through the GF kernel wrapper
    (``ops.gf.guided_filter_coeffs``: the CUDA kernel on CUDA tensors),
    else its plain version. Returns (alpha (N, H, W, 1), fgr (N, H, W, 3))
    float32."""
    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
    from vidmat_torch.ops.resize import resize_bilinear

    _, h, w, _ = rgb_full.shape
    _, hl, wl, _ = alpha_lr.shape
    guide_full = gray_guide(rgb_full.float())
    guide = resize_bilinear(guide_full, hl, wl).contiguous()
    p = torch.cat([alpha_lr, fgr_lr], dim=-1).float()
    coeffs = guided_filter_coeffs if kernels else guided_filter_coeffs_plain
    ma, mb = coeffs(guide, p, radius, eps)
    out = (resize_bilinear(ma, h, w) * guide_full
           + resize_bilinear(mb, h, w))
    return out[..., 0:1].clamp(0.0, 1.0), out[..., 1:4].clamp(0.0, 1.0)
