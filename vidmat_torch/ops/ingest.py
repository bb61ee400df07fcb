"""Fused frame ingest: uint8 -> area pool -> normalize -> bf16 (counterpart
of vidmat/ops/pallas/ingest_kernel.py).

Replaces the TPU kernel ``ingest_pool_normalize``
(vidmat/ops/pallas/ingest_kernel.py:140, pallas_call at :122). The CUDA
kernel is ``csrc/ingest.cu``; it is bound by bytes (the u8 frame read
once, the pooled grid written once). ``ingest_pool_normalize`` launches it
for CUDA tensors and runs ``ingest_pool_normalize_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from vidmat_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("ingest").vm_ingest_pool_normalize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def _norm_params(c: int, scale, offset) -> tuple[list, list]:
    scale = [1.0 / 255.0] * c if scale is None else [float(v) for v in scale]
    offset = [0.0] * c if offset is None else [float(v) for v in offset]
    if len(scale) != c or len(offset) != c:
        raise ValueError(f"scale/offset need {c} values")
    return scale, offset


@functools.lru_cache(maxsize=None)
def _norm_tensors(scale: tuple, offset: tuple, device: torch.device):
    # Made once per device: a host-to-device copy inside a captured CUDA
    # graph (the pipeline's chunk) is not allowed.
    return (torch.tensor(scale, dtype=torch.float32, device=device),
            torch.tensor(offset, dtype=torch.float32, device=device))


def ingest_pool_normalize_plain(frames_u8: torch.Tensor, pool: int = 1,
                                scale: Optional[Sequence[float]] = None,
                                offset: Optional[Sequence[float]] = None,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W, C) uint8 -> (N, H/pool, W/pool, C).

    Exact integer s x s sums, then f32 ``sum * (1/s^2) * scale + offset``
    with each operation rounded, then the cast to ``out_dtype``."""
    n, h, w, c = frames_u8.shape
    if h % pool or w % pool:
        raise ValueError(f"frame {h}x{w} not divisible by pool {pool}")
    scale, offset = _norm_params(c, scale, offset)
    x = frames_u8.to(torch.int32).reshape(
        n, h // pool, pool, w // pool, pool, c).sum((2, 4)).float()
    if pool > 1:
        x = x * (1.0 / (pool * pool))
    scale_t, offset_t = _norm_tensors(tuple(scale), tuple(offset),
                                      frames_u8.device)
    return (x * scale_t + offset_t).to(out_dtype)


def ingest_pool_normalize(frames_u8: torch.Tensor, pool: int = 1,
                          scale: Optional[Sequence[float]] = None,
                          offset: Optional[Sequence[float]] = None,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused ingest: (N, H, W, C) uint8 -> (N, H/pool, W/pool, C) in
    ``out_dtype`` (bfloat16 or float32), normalized per channel as
    ``x * scale + offset`` (default: scale 1/255, offset 0).

    CUDA tensors launch ``csrc/ingest.cu``; CPU tensors take the plain
    version."""
    if frames_u8.device.type == "cpu":
        return ingest_pool_normalize_plain(frames_u8, pool, scale, offset,
                                           out_dtype)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {frames_u8.device}")
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4:
        raise ValueError("frames must be (N, H, W, C) uint8")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    n, h, w, c = frames_u8.shape
    if h % pool or w % pool or not 1 <= c <= 4:
        raise ValueError(f"frame {tuple(frames_u8.shape)} / pool {pool}")
    scale, offset = _norm_params(c, scale, offset)
    frames_u8 = frames_u8.contiguous()
    out = torch.empty((n, h // pool, w // pool, c), dtype=out_dtype,
                      device=frames_u8.device)
    params = (ctypes.c_float * (2 * c))(*scale, *offset)
    stream = torch.cuda.current_stream(frames_u8.device).cuda_stream
    err = _kernel()(frames_u8.data_ptr(), out.data_ptr(), n, h, w, c, pool,
                    ctypes.cast(params, ctypes.c_void_p),
                    int(out_dtype == torch.float32), stream)
    _build.check(err, "ingest_pool_normalize")
    ingest_pool_normalize.launches += 1
    return out


ingest_pool_normalize.launches = 0
