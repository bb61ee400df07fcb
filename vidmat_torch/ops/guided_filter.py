"""Guided-filter statistics in plain PyTorch (counterpart of
vidmat/ops/guided_filter.py: ``gray_guide``, the edge-truncated box mean,
``box_blur``, the portrait-blur background, and the full-resolution
``guided_filter``).

The box mean sums the (2r+1)^2 window with zero padding, rows first, then
columns, each pass adding the 2r+1 shifted terms in ascending order, and
multiplies by 1 / (number of in-image pixels in the window). The CUDA
kernel ``csrc/gf_coeffs.cu`` adds in the same order, so the two agree to
the last bit wherever the compiler keeps each operation rounded.

All arrays NHWC float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vidmat_torch._device import device_constant


@device_constant
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


def window_count(h: int, w: int, r: int, device="cpu") -> torch.Tensor:
    """In-image pixels of each window, (1, H, W, 1) float32: the separable
    count (min(i+r, H-1) - max(i-r, 0) + 1) * (same for j)."""
    def counts(n):
        i = torch.arange(n, device=device)
        return torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0) + 1
    cnt = (counts(h)[:, None] * counts(w)[None, :]).to(torch.float32)
    return cnt[None, :, :, None]


def inv_window_count(h: int, w: int, r: int, device="cpu") -> torch.Tensor:
    """1 / ``window_count``, (1, H, W, 1) float32."""
    return 1.0 / window_count(h, w, r, device)


def box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-truncated (2r+1)^2 box mean of an NHWC tensor."""
    _, h, w, _ = x.shape
    return box_sum(x, r) * inv_window_count(h, w, r, x.device)


def box_blur(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Edge-truncated (2r+1)^2 mean blur of an NHWC tensor: the background
    of the portrait-blur path, taken at the coarse grid
    (vidmat/ops/guided_filter.py ``box_blur``; plain XLA there too)."""
    return box_mean(x, radius)


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 4,
                  eps: float = 1e-4) -> torch.Tensor:
    """Full-resolution guided filter of ``src`` guided by ``guide``
    (vidmat/ops/guided_filter.py ``guided_filter``):
    ``mean(a) * I + mean(b)`` with ``a = cov(I, p) / (var(I) + eps)`` and
    ``b = mean(p) - a * mean(I)``, every mean the edge-truncated box mean
    divided by its window count as the JAX package divides. Plain PyTorch
    on the card and on the CPU (XLA box sums there: no TPU kernel).

    guide (N, H, W, 1), typically ``gray_guide`` of the frame; src (N, H,
    W, C), alpha or alpha and foreground stacked. Computed in float32,
    returned in ``src``'s dtype."""
    _, h, w, _ = guide.shape
    cnt = window_count(h, w, radius, guide.device)

    def mean(x):
        return box_sum(x, radius) / cnt

    i = guide.float()
    p = src.float()
    mean_i = mean(i)
    mean_p = mean(p)
    var_i = mean(i * i) - mean_i * mean_i
    cov_ip = mean(i * p) - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return (mean(a) * i + mean(b)).to(src.dtype)


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
