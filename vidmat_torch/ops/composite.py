"""Compositing of full-resolution float mattes (counterpart of
vidmat/ops/composite.py and vidmat/ops/pallas/composite_kernel.py).

``composite_rgba_packed`` replaces the TPU kernel of the same name
(vidmat/ops/pallas/composite_kernel.py:95, pallas_call at :78) in all four
of its modes: a (3,) color, no background (premultiplied), one (H, W, 3)
image shared by the batch, and per-frame (N, H, W, 3) images. The CUDA
kernel is ``csrc/composite.cu``; it is bound by bytes. The wrapper calls
the op ``vidmat_torch::composite_rgba_packed`` (``ops/library.py``), which
launches it for CUDA tensors and runs ``composite_rgba_packed_plain`` for
CPU tensors. It packs the unfused serving tails (full-resolution net,
bilinear and unfused guided upsampling).

``composite_rgba`` is the JAX package's XLA composite (uint8 RGBA, no
kernel): the raw-foreground output computes it beside the quantized
alpha and foreground.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Union

import numpy as np
import torch

from vidmat_torch._device import device_constant
from vidmat_torch.ops import _build, library

Background = Union[None, Sequence[float], torch.Tensor]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("composite").vm_composite_rgba_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def pack_rgba(rgba_u8: torch.Tensor) -> torch.Tensor:
    """(..., 4) uint8 [R, G, B, A] -> (...) uint32 little-endian words
    (int32 while a program is traced, ``library.words``)."""
    return library.words(rgba_u8.contiguous().view(torch.int32)[..., 0])


@device_constant
def _color_tensor(color: tuple, device: torch.device) -> torch.Tensor:
    # Made once per device: a host-to-device copy inside a captured CUDA
    # graph (the pipeline's chunk) is not allowed.
    return torch.tensor(color, dtype=torch.float32, device=device)


def _bg_tensor(bg: Background, like: torch.Tensor) -> torch.Tensor:
    """The background as a float32 tensor on ``like``'s device: (3,),
    (H, W, 3) or (N, H, W, 3). A color given as numbers is made once per
    device."""
    if not torch.is_tensor(bg) and np.ndim(bg) == 1:
        t = _color_tensor(tuple(float(v) for v in bg), like.device)
    else:
        t = torch.as_tensor(bg, dtype=torch.float32, device=like.device)
    n, h, w, _ = like.shape
    if t.shape not in ((3,), (h, w, 3), (n, h, w, 3)):
        raise ValueError(f"background must be (3,), ({h}, {w}, 3) or "
                         f"({n}, {h}, {w}, 3); got {tuple(t.shape)}")
    return t


def composite_rgba(fgr: torch.Tensor, alpha: torch.Tensor,
                   bg: Background = None) -> torch.Tensor:
    """Composite fgr over bg with alpha: (N, H, W, 4) uint8 RGBA with
    ``round(clip(v) * 255)``. fgr (N, H, W, 3), alpha (N, H, W, 1) in
    [0, 1]; bg (3,) color, (H, W, 3) or (N, H, W, 3) image, or None
    (premultiplied)."""
    fgr, alpha = fgr.float(), alpha.float()
    if bg is None:
        rgb = fgr * alpha
    else:
        rgb = fgr * alpha + _bg_tensor(bg, fgr) * (1.0 - alpha)
    rgba = torch.cat([rgb, alpha], dim=-1)
    return torch.round(rgba.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def composite_rgba_packed_plain(fgr: torch.Tensor, alpha: torch.Tensor,
                                bg: Background = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``composite_rgba`` (the RGB
    term with alpha as given, then ``round(clip(.) * 255)``) packed as
    R | G<<8 | B<<16 | A<<24. Returns (N, H, W) uint32."""
    return pack_rgba(composite_rgba(fgr, alpha, bg))


def composite_rgba_packed(fgr: torch.Tensor, alpha: torch.Tensor,
                          bg: Background = None) -> torch.Tensor:
    """Composite + quantize + RGBA pack.

    fgr: (N, H, W, 3) float32; alpha: (N, H, W, 1) float32; bg: (3,)
    color, (H, W, 3) image shared by the batch, (N, H, W, 3) per-frame
    images, or None (premultiplied). Returns (N, H, W) uint32
    (little-endian R | G<<8 | B<<16 | A<<24).

    Calls ``vidmat_torch::composite_rgba_packed`` (``ops/library.py``):
    CUDA tensors launch ``csrc/composite.cu``; CPU tensors take the plain
    version."""
    if alpha.device != fgr.device or fgr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported devices {fgr.device}, {alpha.device}")
    if fgr.device.type == "cuda" and (
            fgr.dim() != 4 or fgr.shape[-1] != 3
            or alpha.shape != fgr.shape[:3] + (1,)
            or fgr.dtype != torch.float32 or alpha.dtype != torch.float32):
        raise ValueError("fgr (N, H, W, 3) and alpha (N, H, W, 1), float32")
    color = img = None
    if bg is not None and (bg.dim() if torch.is_tensor(bg)
                           else np.ndim(bg)) == 1:
        if len(bg) != 3:
            raise ValueError("a background color has 3 values")
        color = [float(v) for v in bg]
    elif bg is not None:
        img = _bg_tensor(bg, fgr)
    return library.words(torch.ops.vidmat_torch.composite_rgba_packed.default(
        fgr, alpha, img, color))


def _launch_composite_rgba_packed(fgr, alpha, img, color):
    """The CUDA implementation of the op: one launch of the kernel on the
    current stream."""
    n, h, w, _ = fgr.shape
    fgr = fgr.contiguous()
    alpha = alpha.contiguous()
    c_color = None
    if color is not None:
        c_color = ctypes.cast((ctypes.c_float * 3)(*color), ctypes.c_void_p)
    if img is not None:
        img = img.contiguous()
    out = torch.empty((n, h, w), dtype=torch.int32, device=fgr.device)
    stream = torch.cuda.current_stream(fgr.device).cuda_stream
    err = _kernel()(fgr.data_ptr(), alpha.data_ptr(), c_color,
                    None if img is None else img.data_ptr(),
                    int(img is not None and img.dim() == 4),
                    out.data_ptr(), n, h, w, stream)
    _build.check(err, "composite_rgba_packed")
    composite_rgba_packed.launches += 1
    return out


composite_rgba_packed.launches = 0
