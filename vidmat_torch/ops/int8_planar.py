"""The int8-stored planar conv probe (counterpart of the TPU kernel in
tools/bench_int8_planes.py: ``int8_conv``, pallas_call at :82).

The probe asks whether storing the planar net's activations as int8
(half the bytes of bf16) would pay once each layer dequantizes its input
and requantizes its output. One layer is a 3x3, 16 -> 16 conv:

  dequantize  int8 x -> bf16(bf16(x) * bf16(1 / q))
  conv        bf16 weights (16, 16, 3, 3), float32 sums, zero padding
  ReLU
  requantize  clip(round(acc * q), -127, 127) -> int8 (half to even)

``int8_conv`` launches ``csrc/int8_conv.cu`` (an implicit GEMM on the
bf16 tensor cores) for CUDA tensors, raises on what the kernel does not
take, and runs ``int8_conv_plain`` for CPU tensors. The kernel reads the
weights packed by ``pack_conv_weight`` (``packed``; packed here when not
given); on the CPU a given ``packed`` is unpacked and used in place of
``w``, as the kernel uses it. ``.launches`` counts kernel launches. The
TPU kernel's pitched planes with their zero ring and interior mask are
NCHW tensors here, the ring being the conv's zero padding. The probe that
times it is ``vidmat_torch/tools/bench_int8_planes.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from vidmat_torch.ops import _build
from vidmat_torch.ops.planar import pack_conv_weight

CHANNELS = 16
#: shape of pack_conv_weight(w) for the probe's (16, 16, 3, 3) weights
PACKED_SHAPE = (CHANNELS, 9 * CHANNELS + 8)
#: the probe's quantization factor (tools/bench_int8_planes.py)
Q = 64.0


@functools.lru_cache(maxsize=None)
def _dequant_scale(q: float) -> float:
    """1 / q as the bf16 value the TPU kernel multiplies by."""
    return float(torch.tensor(1.0 / q, dtype=torch.bfloat16))


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    q: float = Q) -> torch.Tensor:
    """Plain PyTorch version. x: (N, 16, H, W) int8; w: (16, 16, 3, 3)
    bf16. Returns (N, 16, H, W) int8."""
    xb = (x.float() * _dequant_scale(q)).to(torch.bfloat16).float()
    acc = F.conv2d(xb, w.float(), None, 1, 1)
    return torch.round(torch.relu(acc) * q).clamp(-127, 127).to(torch.int8)


def unpack_conv_weight(packed: torch.Tensor) -> torch.Tensor:
    """The (16, 16, 3, 3) weights that ``pack_conv_weight`` packed into
    ``packed``: the values the kernel reads."""
    return (packed[:, :9 * CHANNELS].reshape(CHANNELS, 3, 3, CHANNELS)
            .permute(0, 3, 1, 2).contiguous())


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("int8_conv").vm_int8_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    return fn


def int8_conv(x: torch.Tensor, w: torch.Tensor, q: float = Q,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One int8-stored 3x3 conv layer (see the module docstring).

    CUDA tensors launch ``csrc/int8_conv.cu`` on ``packed``
    (``pack_conv_weight(w)``, packed here when not given); CPU tensors
    take the plain version."""
    if packed is not None and (
            tuple(packed.shape) != PACKED_SHAPE
            or packed.dtype != torch.bfloat16 or packed.device != w.device
            or not packed.is_contiguous() or packed.data_ptr() % 16):
        raise ValueError("packed weights must be pack_conv_weight(w), "
                         "contiguous and 16-byte aligned")
    if x.device.type == "cpu":
        return int8_conv_plain(
            x, w if packed is None else unpack_conv_weight(packed), q)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"unsupported devices {x.device}, {w.device}")
    if (x.dtype != torch.int8 or x.dim() != 4 or x.shape[1] != CHANNELS
            or w.dtype != torch.bfloat16
            or tuple(w.shape) != (CHANNELS, CHANNELS, 3, 3)):
        raise ValueError("x (N, 16, H, W) int8 and w (16, 16, 3, 3) bf16")
    x = x.contiguous()
    wp = pack_conv_weight(w) if packed is None else packed
    n, _, h, wd = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), wp.data_ptr(), out.data_ptr(), n, h, wd,
                    _dequant_scale(q), float(q), stream)
    _build.check(err, "int8_conv")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
