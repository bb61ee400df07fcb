"""Fused guided refine + composite + RGBA pack (counterpart of
vidmat/ops/pallas/refine_kernel.py ``fused_refine_composite``).

Replaces the TPU kernel ``fused_refine_composite``
(vidmat/ops/pallas/refine_kernel.py:302, pallas_call at :366), in its
color and no-background modes; the per-pixel image and coarse-background
modes are not ported yet (ROADMAP A.9). The CUDA kernel is
``csrc/refine_composite.cu``; it is bound by bytes.
``fused_refine_composite`` launches it for CUDA tensors and runs
``fused_refine_composite_plain`` for CPU tensors.

Output: (N, H, W) uint32 words, little-endian R | G<<8 | B<<16 | A<<24.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from vidmat_torch.ops import _build
from vidmat_torch.ops.resize import resize_bilinear


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("refine_composite").vm_refine_composite
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _check_shapes(frame_u8, a_lr, b_lr, pool):
    n, h, w, _ = frame_u8.shape
    if (a_lr.shape != (n, h // pool, w // pool, 4) or b_lr.shape != a_lr.shape
            or h % pool or w % pool):
        raise ValueError("coeff grids must be (N, H/pool, W/pool, 4)")


def pack_rgba(rgba_u8: torch.Tensor) -> torch.Tensor:
    """(..., 4) uint8 [R, G, B, A] -> (...) uint32 little-endian words."""
    return rgba_u8.contiguous().view(torch.uint32)[..., 0]


def fused_refine_composite_plain(frame_u8: torch.Tensor, a_lr: torch.Tensor,
                                 b_lr: torch.Tensor,
                                 bg: Optional[Sequence[float]] = None,
                                 pool: int = 4) -> torch.Tensor:
    """Plain PyTorch version: bilinear upsample of the coefficient grids
    (F.interpolate, half-pixel, no antialias), guided apply, composite,
    round-half-to-even quantize, pack."""
    _check_shapes(frame_u8, a_lr, b_lr, pool)
    _, h, w, _ = frame_u8.shape
    A = resize_bilinear(a_lr.float(), h, w)
    B = resize_bilinear(b_lr.float(), h, w)
    f = frame_u8[..., :3].float()
    guide = (0.299 * f[..., 0:1] + 0.587 * f[..., 1:2]
             + 0.114 * f[..., 2:3]) * (1.0 / 255.0)
    out = (A * guide + B).clamp(0.0, 1.0)
    alpha, fgr = out[..., 0:1], out[..., 1:4]
    if bg is None:
        rgb = fgr * alpha
    else:
        bgc = torch.as_tensor(bg, dtype=torch.float32, device=fgr.device)
        rgb = fgr * alpha + bgc * (1.0 - alpha)
    rgba = torch.cat([rgb, alpha], dim=-1)
    q = torch.round(rgba.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return pack_rgba(q)


def fused_refine_composite(frame_u8: torch.Tensor, a_lr: torch.Tensor,
                           b_lr: torch.Tensor,
                           bg: Optional[Sequence[float]] = None,
                           pool: int = 4) -> torch.Tensor:
    """Coefficient upsample + guided apply + composite + RGBA pack.

    frame_u8: (N, H, W, 3) uint8; a_lr/b_lr: (N, H/pool, W/pool, 4)
    float32 (channels [alpha, r, g, b]); bg: (3,) color or None
    (premultiplied). Returns (N, H, W) uint32.

    CUDA tensors launch ``csrc/refine_composite.cu``; CPU tensors take the
    plain version."""
    if frame_u8.device.type == "cpu":
        return fused_refine_composite_plain(frame_u8, a_lr, b_lr, bg, pool)
    if frame_u8.device.type != "cuda" or {a_lr.device, b_lr.device} != {
            frame_u8.device}:
        raise ValueError("frame and coefficient grids must share a CUDA "
                         "device")
    if (frame_u8.dtype != torch.uint8 or frame_u8.shape[-1] != 3
            or a_lr.dtype != torch.float32 or b_lr.dtype != torch.float32):
        raise ValueError("frame (N, H, W, 3) uint8, grids float32")
    _check_shapes(frame_u8, a_lr, b_lr, pool)
    n, h, w, _ = frame_u8.shape
    frame_u8 = frame_u8.contiguous()
    a_lr = a_lr.contiguous()
    b_lr = b_lr.contiguous()
    if a_lr.data_ptr() % 16 or b_lr.data_ptr() % 16:
        raise ValueError("coefficient grids must be 16-byte aligned")
    out = torch.empty((n, h, w), dtype=torch.uint32, device=frame_u8.device)
    bg_arr = None
    if bg is not None:
        bg_arr = ctypes.cast((ctypes.c_float * 3)(*[float(v) for v in bg]),
                             ctypes.c_void_p)
    stream = torch.cuda.current_stream(frame_u8.device).cuda_stream
    err = _kernel()(frame_u8.data_ptr(), a_lr.data_ptr(), b_lr.data_ptr(),
                    out.data_ptr(), n, h, w, pool, bg_arr, stream)
    _build.check(err, "fused_refine_composite")
    fused_refine_composite.launches += 1
    return out


fused_refine_composite.launches = 0
