"""Fast guided-filter coefficients (counterpart of
vidmat/ops/pallas/gf_kernel.py).

Replaces the TPU kernel ``guided_filter_coeffs``
(vidmat/ops/pallas/gf_kernel.py:123, pallas_calls at :139 and :152 — one
function, two variants of the same math). The CUDA kernel is
``csrc/gf_coeffs.cu``: one launch, statistics, a and b and their box means
in shared memory per output tile; it is bound by bytes, and bit-exact to
the plain version. ``guided_filter_coeffs`` calls the op
``vidmat_torch::guided_filter_coeffs`` (``ops/library.py``), which
launches it for CUDA tensors and runs ``guided_filter_coeffs_plain`` for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vidmat_torch.ops import _build, library
from vidmat_torch.ops.guided_filter import box_mean


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("gf_coeffs").vm_gf_coeffs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    return fn


#: The radii the kernel takes: a block's shared memory grows with the
#: radius (csrc/gf_coeffs.cu), and every radius up to this one fits.
MAX_RADIUS = 8


def guided_filter_coeffs_plain(guide: torch.Tensor, p: torch.Tensor,
                               radius: int = 4, eps: float = 1e-4):
    """Plain PyTorch version. guide (N, H, W, 1), p (N, H, W, C) float32
    -> (mean_a, mean_b), each (N, H, W, C). The guide's statistics are
    computed once and shared across the C channels."""
    I = guide.float()
    p = p.float()
    mean_I = box_mean(I, radius)
    corr_II = box_mean(I * I, radius)
    var_I = corr_II - mean_I * mean_I
    mean_p = box_mean(p, radius)
    corr_Ip = box_mean(I * p, radius)
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    return box_mean(a, radius), box_mean(b, radius)


def guided_filter_coeffs(guide: torch.Tensor, p: torch.Tensor,
                         radius: int = 4, eps: float = 1e-4):
    """(mean_a, mean_b) of the fast guided filter at the coarse grid.

    guide: (N, H, W, 1) float32 coarse guide
    p:     (N, H, W, 4) float32 signals (alpha + 3 fgr channels)
    Returns (mean_a, mean_b), each (N, H, W, 4) float32; the output at any
    resolution is ``upsample(mean_a) * guide_full + upsample(mean_b)``.

    Calls ``vidmat_torch::guided_filter_coeffs`` (``ops/library.py``):
    CUDA tensors launch ``csrc/gf_coeffs.cu`` (radius 0 to
    ``MAX_RADIUS``; a larger one raises); CPU tensors take the plain
    version."""
    if guide.device != p.device or guide.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported devices {guide.device}, {p.device}")
    if guide.device.type == "cuda":
        n, h, w, c = p.shape
        if (guide.shape != (n, h, w, 1) or c != 4
                or guide.dtype != torch.float32
                or p.dtype != torch.float32):
            raise ValueError("guide (N, H, W, 1) and p (N, H, W, 4), "
                             "float32")
        if not 0 <= int(radius) <= MAX_RADIUS:
            raise ValueError(f"radius {radius}: the kernel takes 0 to "
                             f"{MAX_RADIUS} (its block's shared memory)")
    return torch.ops.vidmat_torch.guided_filter_coeffs.default(
        guide, p, int(radius), float(eps))


def _launch_guided_filter_coeffs(guide, p, radius, eps):
    """The CUDA implementation of the op: one launch of the kernel on the
    current stream."""
    n, h, w, c = p.shape
    guide = guide.contiguous()
    p = p.contiguous()
    if p.data_ptr() % 16:  # one float4 per pixel
        p = p.clone()
    mean_a = torch.empty((n, h, w, c), dtype=torch.float32, device=p.device)
    mean_b = torch.empty_like(mean_a)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = _kernel()(guide.data_ptr(), p.data_ptr(), mean_a.data_ptr(),
                    mean_b.data_ptr(), n, h, w, int(radius), float(eps),
                    stream)
    _build.check(err, "guided_filter_coeffs")
    guided_filter_coeffs.launches += 1
    return mean_a, mean_b


guided_filter_coeffs.launches = 0
