"""Fused guided refine tails (counterpart of
vidmat/ops/pallas/refine_kernel.py).

Both tails upsample the coarse guided-filter coefficient grids by
``pool`` (bilinear, half-pixel, edge-clamped, rows then columns) and apply
them to the luma guide of the full-resolution uint8 frame:

``fused_refine_composite`` replaces the TPU kernel of the same name
(refine_kernel.py:302, pallas_call at :366) in all four of its background
modes, dispatched on the background's rank as the TPU kernel's wrapper
does (:327-343): a (3,) color, an (H, W, 3) image shared by the batch, an
(N, H/pool, W/pool, 3) coarse background per frame (upsampled inside the
kernel like the coefficient grids and clipped: the portrait-blur path),
or None (premultiplied). It also takes (N, H, W, 3) images, one per frame
(pool > 1). It composites, quantizes and packs RGBA words. CUDA kernel:
``csrc/refine_composite.cu``.

``fused_refine_float`` replaces ``fused_refine_float`` (refine_kernel.py:
193, pallas_call at :214), the float-output tail of the streaming session
and of raw-foreground output: float32 alpha and foreground, no composite.
CUDA kernel: ``csrc/refine_float.cu``.

The two kernels share ``csrc/refine_common.cuh`` (the upsample and the
guide) and are bound by bytes. Each wrapper launches its kernel for CUDA
tensors and runs its ``*_plain`` version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from vidmat_torch.ops import _build
from vidmat_torch.ops.composite import composite_rgba_packed_plain
from vidmat_torch.ops.resize import resize_bilinear


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("refine_composite").vm_refine_composite
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _float_kernel():
    fn = _build.load("refine_float").vm_refine_float
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


def _check_shapes(frame_u8, a_lr, b_lr, pool):
    n, h, w, _ = frame_u8.shape
    if (a_lr.shape != (n, h // pool, w // pool, 4) or b_lr.shape != a_lr.shape
            or h % pool or w % pool):
        raise ValueError("coeff grids must be (N, H/pool, W/pool, 4)")


def _check_cuda_inputs(frame_u8, a_lr, b_lr, pool):
    """Device, dtype, shape and alignment checks of both kernel wrappers;
    returns the contiguous inputs."""
    if frame_u8.device.type != "cuda" or {a_lr.device, b_lr.device} != {
            frame_u8.device}:
        raise ValueError("frame and coefficient grids must share a CUDA "
                         "device")
    if (frame_u8.dtype != torch.uint8 or frame_u8.shape[-1] != 3
            or a_lr.dtype != torch.float32 or b_lr.dtype != torch.float32):
        raise ValueError("frame (N, H, W, 3) uint8, grids float32")
    _check_shapes(frame_u8, a_lr, b_lr, pool)
    frame_u8 = frame_u8.contiguous()
    a_lr = a_lr.contiguous()
    b_lr = b_lr.contiguous()
    if a_lr.data_ptr() % 16 or b_lr.data_ptr() % 16:
        raise ValueError("coefficient grids must be 16-byte aligned")
    return frame_u8, a_lr, b_lr


Background = Union[None, Sequence[float], np.ndarray, torch.Tensor]

#: background modes of fused_refine_composite, in the kernel's terms
BG_MODES = ("none", "color", "image", "per_frame", "coarse")


def background_mode(bg: Background, n: int, h: int, w: int,
                    pool: int) -> str:
    """The mode of ``fused_refine_composite``'s background, by its rank
    and shape (refine_kernel.py:327-343): None -> "none", (3,) ->
    "color", (H, W, 3) -> "image", (N, H/pool, W/pool, 3) -> "coarse",
    (N, H, W, 3) at pool > 1 -> "per_frame". Raises on any other shape."""
    if bg is None:
        return "none"
    shape = tuple(bg.shape) if hasattr(bg, "shape") else np.shape(bg)
    if shape == (3,):
        return "color"
    if shape == (h, w, 3):
        return "image"
    if shape == (n, h // pool, w // pool, 3):
        return "coarse"
    if shape == (n, h, w, 3):
        return "per_frame"
    raise ValueError(
        f"background must be (3,), ({h}, {w}, 3), ({n}, {h // pool}, "
        f"{w // pool}, 3) or ({n}, {h}, {w}, 3); got {shape}")


def fused_refine_float_plain(frame_u8: torch.Tensor, a_lr: torch.Tensor,
                             b_lr: torch.Tensor, pool: int = 4
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: bilinear upsample of the coefficient grids
    (F.interpolate, half-pixel, no antialias), guided apply, clip.
    Returns (alpha (N, H, W, 1), fgr (N, H, W, 3)) float32."""
    _check_shapes(frame_u8, a_lr, b_lr, pool)
    _, h, w, _ = frame_u8.shape
    A = resize_bilinear(a_lr.float(), h, w)
    B = resize_bilinear(b_lr.float(), h, w)
    f = frame_u8[..., :3].float()
    guide = (0.299 * f[..., 0:1] + 0.587 * f[..., 1:2]
             + 0.114 * f[..., 2:3]) * (1.0 / 255.0)
    out = (A * guide + B).clamp(0.0, 1.0)
    return out[..., 0:1].contiguous(), out[..., 1:4].contiguous()


def fused_refine_composite_plain(frame_u8: torch.Tensor, a_lr: torch.Tensor,
                                 b_lr: torch.Tensor, bg: Background = None,
                                 pool: int = 4) -> torch.Tensor:
    """Plain PyTorch version: the float tail, then composite,
    round-half-to-even quantize and pack; a coarse background is first
    upsampled (``resize_bilinear``) and clipped to [0, 1]."""
    alpha, fgr = fused_refine_float_plain(frame_u8, a_lr, b_lr, pool)
    n, h, w, _ = frame_u8.shape
    if background_mode(bg, n, h, w, pool) == "coarse":
        bg = resize_bilinear(torch.as_tensor(bg, dtype=torch.float32,
                                             device=frame_u8.device),
                             h, w).clamp(0.0, 1.0)
    return composite_rgba_packed_plain(fgr, alpha, bg)


def fused_refine_composite(frame_u8: torch.Tensor, a_lr: torch.Tensor,
                           b_lr: torch.Tensor, bg: Background = None,
                           pool: int = 4) -> torch.Tensor:
    """Coefficient upsample + guided apply + composite + RGBA pack.

    frame_u8: (N, H, W, 3) uint8; a_lr/b_lr: (N, H/pool, W/pool, 4)
    float32 (channels [alpha, r, g, b]); bg: see ``background_mode``
    (an image or coarse background on CUDA is a float32 tensor on the
    frame's device). Returns (N, H, W) uint32.

    CUDA tensors launch ``csrc/refine_composite.cu``; CPU tensors take the
    plain version."""
    if frame_u8.device.type == "cpu":
        return fused_refine_composite_plain(frame_u8, a_lr, b_lr, bg, pool)
    frame_u8, a_lr, b_lr = _check_cuda_inputs(frame_u8, a_lr, b_lr, pool)
    n, h, w, _ = frame_u8.shape
    mode = background_mode(bg, n, h, w, pool)
    color = img = coarse = None
    if mode == "color":
        color = ctypes.cast((ctypes.c_float * 3)(*[float(v) for v in bg]),
                            ctypes.c_void_p)
    elif mode != "none":
        if (not torch.is_tensor(bg) or bg.dtype != torch.float32
                or bg.device != frame_u8.device):
            raise ValueError(f"a {mode} background must be a float32 tensor "
                             f"on {frame_u8.device}")
        bg = bg.contiguous()
        if mode == "coarse":
            coarse = bg.data_ptr()
        else:
            img = bg.data_ptr()
    out = torch.empty((n, h, w), dtype=torch.uint32, device=frame_u8.device)
    stream = torch.cuda.current_stream(frame_u8.device).cuda_stream
    err = _kernel()(frame_u8.data_ptr(), a_lr.data_ptr(), b_lr.data_ptr(),
                    out.data_ptr(), n, h, w, pool, color, img,
                    int(mode == "per_frame"), coarse, stream)
    _build.check(err, "fused_refine_composite")
    fused_refine_composite.launches += 1
    fused_refine_composite.mode_launches[mode] += 1
    return out


def fused_refine_float(frame_u8: torch.Tensor, a_lr: torch.Tensor,
                       b_lr: torch.Tensor, pool: int = 4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coefficient upsample + guided apply emitting float32.

    frame_u8: (N, H, W, 3) uint8; a_lr/b_lr: (N, H/pool, W/pool, 4)
    float32 (channels [alpha, r, g, b]). Returns (alpha (N, H, W, 1),
    fgr (N, H, W, 3)) float32 in [0, 1]; no composite, no quantization.

    CUDA tensors launch ``csrc/refine_float.cu``; CPU tensors take the
    plain version."""
    if frame_u8.device.type == "cpu":
        return fused_refine_float_plain(frame_u8, a_lr, b_lr, pool)
    frame_u8, a_lr, b_lr = _check_cuda_inputs(frame_u8, a_lr, b_lr, pool)
    n, h, w, _ = frame_u8.shape
    alpha = torch.empty((n, h, w, 1), dtype=torch.float32,
                        device=frame_u8.device)
    fgr = torch.empty((n, h, w, 3), dtype=torch.float32,
                      device=frame_u8.device)
    stream = torch.cuda.current_stream(frame_u8.device).cuda_stream
    err = _float_kernel()(frame_u8.data_ptr(), a_lr.data_ptr(),
                          b_lr.data_ptr(), alpha.data_ptr(), fgr.data_ptr(),
                          n, h, w, pool, stream)
    _build.check(err, "fused_refine_float")
    fused_refine_float.launches += 1
    return alpha, fgr


fused_refine_composite.launches = 0
#: launches per background mode (their sum is ``launches``)
fused_refine_composite.mode_launches = dict.fromkeys(BG_MODES, 0)
fused_refine_float.launches = 0
