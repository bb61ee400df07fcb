"""Planar conv kernels (counterpart of vidmat/ops/pallas/planar.py).

Replaces the four TPU kernels of the ``conv_impl="planar"`` network:

  planar_conv      vidmat/ops/pallas/planar.py:188 (pallas_call :222)
  planar_conv2     planar.py:315 (pallas_call :352)
  planar_conv_gru  planar.py:454 (pallas_call :487)
  planar_gru       planar.py:549 (pallas_call :565)

The TPU layout does not come across: the JAX kernels run on flattened,
pitch-aligned ``(C, TOTAL)`` planes with zero margins, an interior mask and
stride-2 convs repacked by space-to-depth. Here every activation is a plain
contiguous NCHW tensor; a stride-2 conv is computed directly (the same sum
of the same products), zero padding stands for the planes' zero pad ring,
and a conv over a channel concatenation takes the list of inputs, so the
concatenation never materializes.

The numerics do come across. Weights are the conv kernels cast to the plane
dtype unscaled, shaped (C_out, sum C_in, k, k) with the input channels in
list order; products accumulate in float32; then ``acc * scale + bias`` in
float32 as two rounded operations (the folded BatchNorm); then the ReLU;
then the cast to the plane dtype (bfloat16 or float32). In the fused
kernels an intermediate is cast to the plane dtype exactly where the JAX
kernel casts it, and is zero outside the image.

Each ``planar_*`` wrapper launches its CUDA kernel (``csrc/planar_conv.cu``,
``csrc/planar_conv2.cu``, ``csrc/planar_gru.cu``) for CUDA tensors, raises
on what the kernel does not take, and runs its ``*_plain`` twin for CPU
tensors only. ``.launches`` counts kernel launches. On bfloat16 planes
all four run on the tensor cores (``csrc/planar_mma.cuh``), planar_conv
with its weights packed once into the kernel's staged layout
(``pack_conv_weight``); ``planar_conv_plan``, ``planar_conv2_plan`` and
``planar_gru_plan`` report the tile, block count and shared memory such a
launch takes. The bf16 kernels give the values of one fixed summation
order, ``seq_conv_f32``'s; the plain twins reach it with
``sequential=True`` and otherwise sum with ``F.conv2d``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vidmat_torch.ops import _build

_ACTS = {"none": 0, "relu": 1}
_MAX_INPUTS = 3


# ---- plain PyTorch versions (the CPU path and the kernels' reference) ----


def seq_conv_f32(xs: Sequence[torch.Tensor], w: torch.Tensor, stride: int
                 ) -> torch.Tensor:
    """The float32 conv of ``_conv_f32`` summed in one fixed order, the
    CUDA-core kernels': input channel (across ``xs`` in list order), then
    ky, then kx, each product added to a float32 sum that starts from 0.
    k in {1, 3} (zero padding k // 2), stride 1 or 2, up to three inputs.
    On operands in bfloat16 every product is exact in float32, so each
    step is one rounding whether or not the multiply-add is fused, on any
    device: this is the order the bf16 kernels must reproduce, where
    cuDNN's summation order changes with the shape."""
    x = torch.cat([t.float() for t in xs], dim=1) if len(xs) > 1 \
        else xs[0].float()
    k = w.shape[-1]
    n, c, hh, ww = x.shape
    oh, ow = (hh - 1) // stride + 1, (ww - 1) // stride + 1
    xp = F.pad(x, (k // 2,) * 4)
    wf = w.float()
    acc = torch.zeros((n, w.shape[0], oh, ow), device=x.device)
    for ci in range(c):
        for ky in range(k):
            for kx in range(k):
                win = xp[:, ci:ci + 1, ky:ky + stride * (oh - 1) + 1:stride,
                         kx:kx + stride * (ow - 1) + 1:stride]
                acc.addcmul_(win, wf[:, ci, ky, kx].view(1, -1, 1, 1))
    return acc


def _conv_f32(xs: Sequence[torch.Tensor], w: torch.Tensor, stride: int,
              sequential: bool = False) -> torch.Tensor:
    """float32 sum of products of a conv over the concatenated inputs
    (operands in the plane dtype, so every product is exact in float32):
    ``F.conv2d`` (cuDNN on the card, in an order of its choosing), or with
    ``sequential`` ``seq_conv_f32``."""
    if sequential:
        return seq_conv_f32(xs, w, stride)
    x = torch.cat([t.float() for t in xs], dim=1) if len(xs) > 1 \
        else xs[0].float()
    return F.conv2d(x, w.float(), None, stride, w.shape[-1] // 2)


def _affine_act(acc, scale, bias, act: str) -> torch.Tensor:
    out = acc * scale.view(1, -1, 1, 1)
    out = out + bias.view(1, -1, 1, 1)
    return torch.relu(out) if act == "relu" else out


def planar_conv_plain(xs: Sequence[torch.Tensor], w: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      stride: int = 1, act: str = "relu", *,
                      sequential: bool = False) -> torch.Tensor:
    """Conv (k in {1, 3}, zero padding k//2, stride 1 or 2) over the
    channel concatenation of ``xs``, then ``acc * scale + bias``, then
    ``act``, cast to the inputs' dtype. xs: [(N, C_i, H, W)]; w: (C_out,
    sum C_i, k, k); scale, bias: (C_out,) float32. ``sequential`` sums in
    the fixed order of ``seq_conv_f32`` (every ``*_plain`` twin takes it):
    the bf16 kernels' oracle on the card."""
    out = _affine_act(_conv_f32(xs, w, stride, sequential), scale, bias, act)
    return out.to(xs[0].dtype)


def planar_conv2_plain(xs, w1, scale1, bias1, w2, scale2, bias2,
                       stride: int = 1, act: str = "relu",
                       act2: str = "none", *,
                       sequential: bool = False) -> torch.Tensor:
    """Two chained 3x3 convs: the first as planar_conv (stride 1 or 2), its
    output cast to the plane dtype and zero outside the image (the zero
    padding of the second conv), then a 3x3 stride-1 conv with its own
    affine and activation."""
    mid = planar_conv_plain(xs, w1, scale1, bias1, stride, act,
                            sequential=sequential)
    return planar_conv_plain([mid], w2, scale2, bias2, 1, act2,
                             sequential=sequential)


def planar_gru_plain(x, h, wg, bg, wc, bc, *,
                     sequential: bool = False) -> torch.Tensor:
    """One ConvGRU step on (N, C, H, W) x and h (models/layers.py
    ConvGRUCell), with the JAX kernel's cast points:

      r, z = sigmoid(conv3x3([x, h]) + bg)       float32
      rh   = (r * h) cast to h's dtype
      c    = tanh(conv3x3([x, rh]) + bc)          float32
      h'   = ((1 - z) * h + z * c) cast to h's dtype

    wg: (2C, 2C, 3, 3), wc: (C, 2C, 3, 3) in the plane dtype; bg (2C,),
    bc (C,) float32."""
    c = h.shape[1]
    rz = torch.sigmoid(_conv_f32([x, h], wg, 1, sequential)
                       + bg.view(1, -1, 1, 1))
    r, z = rz[:, :c], rz[:, c:]
    hf = h.float()
    rh = (r * hf).to(h.dtype)
    cand = torch.tanh(_conv_f32([x, rh], wc, 1, sequential)
                      + bc.view(1, -1, 1, 1))
    return ((1.0 - z) * hf + z * cand).to(h.dtype)


def planar_conv_gru_plain(xs, w, scale, bias, h, wg, bg, wc, bc, *,
                          sequential: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder stage: 3x3 ConvBNAct(ReLU) over the inputs, cast to the
    plane dtype, split into [a | b] halves, h' = ConvGRU(b, h). Returns
    (a, h')."""
    mid = planar_conv_plain(xs, w, scale, bias, 1, "relu",
                            sequential=sequential)
    half = mid.shape[1] // 2
    a, b = mid[:, :half].contiguous(), mid[:, half:].contiguous()
    return a, planar_gru_plain(b, h, wg, bg, wc, bc, sequential=sequential)


# ---- kernel wrappers ----


@functools.lru_cache(maxsize=None)
def _fn(lib: str, sym: str, argtypes: tuple):
    fn = getattr(_build.load(lib), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_planes(xs, w, scale, bias, stride=1):
    """Device, dtype, shape and contiguity checks shared by the wrappers;
    returns (n, h, w, dtype flag)."""
    if not 1 <= len(xs) <= _MAX_INPUTS:
        raise ValueError(f"1..{_MAX_INPUTS} input tensors, got {len(xs)}")
    x0 = xs[0]
    dev = x0.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x0.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported plane dtype {x0.dtype}")
    n, _, hh, ww = x0.shape
    for t in xs:
        if (t.device != dev or t.dtype != x0.dtype or t.dim() != 4
                or (t.shape[0], t.shape[2], t.shape[3]) != (n, hh, ww)
                or not t.is_contiguous()):
            raise ValueError("inputs must be contiguous (N, C_i, H, W) on one "
                             "device, of one dtype")
    cin = sum(t.shape[1] for t in xs)
    k = w.shape[-1]
    if (w.dim() != 4 or w.shape[1] != cin or w.shape[2] != k or k not in (1, 3)
            or w.dtype != x0.dtype or w.device != dev
            or not w.is_contiguous()):
        raise ValueError(f"weights must be contiguous (C_out, {cin}, k, k), "
                         "k in (1, 3), in the plane dtype")
    _check_affine(w.shape[0], dev, scale, bias)
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}")
    return n, hh, ww, int(x0.dtype == torch.float32)


def _check_affine(c, dev, *vs):
    for v in vs:
        if (v.shape != (c,) or v.dtype != torch.float32 or v.device != dev
                or not v.is_contiguous()):
            raise ValueError(f"affine vectors must be ({c},) float32")


def _inputs(xs):
    ptrs = (ctypes.c_void_p * _MAX_INPUTS)(*[t.data_ptr() for t in xs])
    cins = (ctypes.c_int * _MAX_INPUTS)(*[t.shape[1] for t in xs])
    return (ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(cins, ctypes.c_void_p), len(xs))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_INVALID_VALUE = 1  # cudaErrorInvalidValue: shapes the kernel refuses


def _check_launch(err: int, what: str) -> None:
    if err == _INVALID_VALUE:
        raise ValueError(f"{what}: shapes the kernel cannot take (no tile "
                         "fits in shared memory, or the grid is too large)")
    _build.check(err, what)


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """Conv weights (C_out, C_in, k, k) in the staged layout of the
    tensor-core planar_conv (``csrc/planar_mma.cuh``): (up(C_out, 8),
    k*k*kp + 8) with kp = up(C_in, 16), row n holding w[n, ci, ky, kx] at
    column (ky*k + kx)*kp + ci; padding channels, padding rows and the 8
    trailing columns are zero. Packed once (``PlanarNetwork`` does it at
    build), each block of the kernel copies its rows in 16-byte vectors."""
    cout, cin, k, _ = w.shape
    kp = -(-cin // 16) * 16
    taps = k * k
    out = torch.zeros((-(-cout // 8) * 8, taps * kp + 8), dtype=w.dtype,
                      device=w.device)
    out[:cout, :taps * kp].view(cout, taps, kp)[:, :, :cin] = (
        w.permute(0, 2, 3, 1).reshape(cout, taps, cin))
    return out


def _out_hw(h, w, k, stride):
    p = k // 2
    return (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1


def planar_conv(xs: Sequence[torch.Tensor], w: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor, stride: int = 1,
                act: str = "relu", packed: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Fused multi-input conv + affine + activation (planar_conv_plain).
    CUDA tensors launch ``csrc/planar_conv.cu``; bfloat16 planes read the
    weights as ``packed`` (``pack_conv_weight(w)``, packed here when not
    given)."""
    xs = list(xs)
    if _on_cpu(*xs, w, scale, bias):
        return planar_conv_plain(xs, w, scale, bias, stride, act)
    n, h, wd, f32 = _check_planes(xs, w, scale, bias, stride)
    cout, cin, k = w.shape[0], w.shape[1], w.shape[-1]
    wp = None
    if not f32:
        wp = pack_conv_weight(w) if packed is None else packed
        kp = -(-cin // 16) * 16
        if (wp.shape != (-(-cout // 8) * 8, k * k * kp + 8)
                or wp.dtype != w.dtype or wp.device != w.device
                or not wp.is_contiguous() or wp.data_ptr() % 16):
            raise ValueError("packed weights must be pack_conv_weight(w), "
                             "contiguous and 16-byte aligned")
    oh, ow = _out_hw(h, wd, k, stride)
    out = torch.empty((n, cout, oh, ow), dtype=xs[0].dtype,
                      device=xs[0].device)
    ptrs, cins, n_in = _inputs(xs)
    err = _fn("planar_conv", "vm_planar_conv", (_P, _P, _I) + (_P,) * 5
              + (_I,) * 8 + (_P,))(
        ptrs, cins, n_in, w.data_ptr(), None if wp is None else
        wp.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n,
        h, wd, cout, k, stride, _ACTS[act], f32, _stream(out))
    _check_launch(err, "planar_conv")
    planar_conv.launches += 1
    return out


def planar_conv2(xs: Sequence[torch.Tensor], w1: torch.Tensor,
                 scale1: torch.Tensor, bias1: torch.Tensor, w2: torch.Tensor,
                 scale2: torch.Tensor, bias2: torch.Tensor, stride: int = 1,
                 act: str = "relu", act2: str = "none") -> torch.Tensor:
    """Fused conv -> affine -> act -> 3x3 conv -> affine -> act2 with the
    intermediate kept in shared memory (planar_conv2_plain). CUDA tensors
    launch ``csrc/planar_conv2.cu``."""
    xs = list(xs)
    if _on_cpu(*xs, w1, scale1, bias1, w2, scale2, bias2):
        return planar_conv2_plain(xs, w1, scale1, bias1, w2, scale2, bias2,
                                  stride, act, act2)
    n, h, wd, f32 = _check_planes(xs, w1, scale1, bias1, stride)
    cmid, cout = w1.shape[0], w2.shape[0]
    if (w1.shape[-1] != 3 or w2.shape != (cout, cmid, 3, 3)
            or w2.dtype != w1.dtype or w2.device != w1.device
            or not w2.is_contiguous()):
        raise ValueError(f"both convs must be 3x3, the second ({cout}, "
                         f"{cmid}, 3, 3)")
    _check_affine(cout, w2.device, scale2, bias2)
    oh, ow = _out_hw(h, wd, 3, stride)
    out = torch.empty((n, cout, oh, ow), dtype=xs[0].dtype,
                      device=xs[0].device)
    ptrs, cins, n_in = _inputs(xs)
    err = _fn("planar_conv2", "vm_planar_conv2", (_P, _P, _I) + (_P,) * 7
              + (_I,) * 9 + (_P,))(
        ptrs, cins, n_in, w1.data_ptr(), scale1.data_ptr(), bias1.data_ptr(),
        w2.data_ptr(), scale2.data_ptr(), bias2.data_ptr(), out.data_ptr(),
        n, h, wd, cmid, cout, stride, _ACTS[act], _ACTS[act2], f32,
        _stream(out))
    _check_launch(err, "planar_conv2")
    planar_conv2.launches += 1
    return out


def _check_gru(h, wg, bg, wc, bc, n, hh, ww):
    c = h.shape[1]
    if (h.dim() != 4 or (h.shape[0], h.shape[2], h.shape[3]) != (n, hh, ww)
            or not h.is_contiguous() or h.device.type != "cuda"):
        raise ValueError(f"h must be contiguous ({n}, C, {hh}, {ww})")
    for wt, co in ((wg, 2 * c), (wc, c)):
        if (wt.shape != (co, 2 * c, 3, 3) or wt.dtype != h.dtype
                or wt.device != h.device or not wt.is_contiguous()):
            raise ValueError(f"GRU weights must be ({co}, {2 * c}, 3, 3) in "
                             "the plane dtype")
    _check_affine(2 * c, h.device, bg)
    _check_affine(c, h.device, bc)
    return c


def planar_conv_gru(xs: Sequence[torch.Tensor], w: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, h: torch.Tensor,
                    wg: torch.Tensor, bg: torch.Tensor, wc: torch.Tensor,
                    bc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused decoder stage (planar_conv_gru_plain): conv + split + ConvGRU
    in one launch; the conv's output never reaches device memory except
    its first half ``a``. CUDA tensors launch ``csrc/planar_gru.cu``."""
    xs = list(xs)
    if _on_cpu(*xs, w, scale, bias, h, wg, bg, wc, bc):
        return planar_conv_gru_plain(xs, w, scale, bias, h, wg, bg, wc, bc)
    n, hh, ww, f32 = _check_planes(xs, w, scale, bias)
    feats = w.shape[0]
    c = _check_gru(h, wg, bg, wc, bc, n, hh, ww)
    if w.shape[-1] != 3 or feats != 2 * c or h.dtype != xs[0].dtype:
        raise ValueError(f"conv must be 3x3 with {2 * c} outputs, h in the "
                         "plane dtype")
    a = torch.empty((n, c, hh, ww), dtype=xs[0].dtype, device=h.device)
    h_new = torch.empty_like(h)
    ptrs, cins, n_in = _inputs(xs)
    err = _fn("planar_gru", "vm_planar_conv_gru", (_P, _P, _I) + (_P,) * 10
              + (_I,) * 5 + (_P,))(
        ptrs, cins, n_in, w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        h.data_ptr(), wg.data_ptr(), bg.data_ptr(), wc.data_ptr(),
        bc.data_ptr(), a.data_ptr(), h_new.data_ptr(), n, hh, ww, c, f32,
        _stream(h))
    _check_launch(err, "planar_conv_gru")
    planar_conv_gru.launches += 1
    return a, h_new


def planar_gru(x: torch.Tensor, h: torch.Tensor, wg: torch.Tensor,
               bg: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor
               ) -> torch.Tensor:
    """Standalone ConvGRU step (planar_gru_plain), x and h (N, C, H, W).
    CUDA tensors launch ``csrc/planar_gru.cu``."""
    if _on_cpu(x, h, wg, bg, wc, bc):
        return planar_gru_plain(x, h, wg, bg, wc, bc)
    if x.shape != h.shape or x.dtype != h.dtype or x.device != h.device \
            or not x.is_contiguous():
        raise ValueError("x and h must be contiguous, of one shape and dtype")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported plane dtype {h.dtype}")
    n, _, hh, ww = h.shape
    c = _check_gru(h, wg, bg, wc, bc, n, hh, ww)
    h_new = torch.empty_like(h)
    err = _fn("planar_gru", "vm_planar_gru", (_P,) * 7 + (_I,) * 5 + (_P,))(
        x.data_ptr(), h.data_ptr(), wg.data_ptr(), bg.data_ptr(),
        wc.data_ptr(), bc.data_ptr(), h_new.data_ptr(), n, hh, ww, c,
        int(h.dtype == torch.float32), _stream(h))
    _check_launch(err, "planar_gru")
    planar_gru.launches += 1
    return h_new


def planar_conv_plan(cins: Sequence[int], n: int, h: int, w: int,
                     cout: int, k: int, stride: int) -> dict:
    """The launch planar_conv makes for bfloat16 planes of these shapes
    (inputs of ``cins`` channels, (n, h, w) each): {"tile": (rows, cols),
    "nb": output channels per block, "blocks", "smem": bytes}; tile (0, 0)
    if none fits. Needs the built kernel."""
    cins = list(cins)
    arr = (ctypes.c_int * _MAX_INPUTS)(*cins)
    plan = (ctypes.c_int * 5)()
    err = _fn("planar_conv", "vm_planar_conv_plan", (_P,) + (_I,) * 7
              + (_P,))(ctypes.cast(arr, ctypes.c_void_p), len(cins), n, h, w,
                       cout, k, stride, ctypes.cast(plan, ctypes.c_void_p))
    _check_launch(err, "planar_conv_plan")
    return {"tile": (plan[0], plan[1]), "nb": plan[2], "blocks": plan[3],
            "smem": plan[4]}


def planar_conv2_plan(cins: Sequence[int], n: int, h: int, w: int, cmid: int,
                      cout: int, stride: int) -> dict:
    """The launch planar_conv2 makes for bfloat16 planes of these shapes
    (inputs of ``cins`` channels, (n, h, w) each): {"tile": edge, "blocks",
    "smem": bytes}; tile 0 if no tile fits. Needs the built kernel."""
    cins = list(cins)
    arr = (ctypes.c_int * _MAX_INPUTS)(*cins)
    plan = (ctypes.c_int * 3)()
    err = _fn("planar_conv2", "vm_planar_conv2_plan", (_P,) + (_I,) * 7
              + (_P,))(ctypes.cast(arr, ctypes.c_void_p), len(cins), n, h, w,
                       cmid, cout, stride, ctypes.cast(plan, ctypes.c_void_p))
    _check_launch(err, "planar_conv2_plan")
    return dict(zip(("tile", "blocks", "smem"), plan))


def planar_gru_plan(fused: bool, cin: int, n: int, h: int, w: int,
                    c: int) -> dict:
    """The launch planar_conv_gru (``fused``, ``cin`` input channels) or
    planar_gru makes for bfloat16 planes of these shapes, as
    planar_conv2_plan."""
    plan = (ctypes.c_int * 3)()
    err = _fn("planar_gru", "vm_planar_gru_plan", (_I,) * 6 + (_P,))(
        int(fused), cin, n, h, w, c, ctypes.cast(plan, ctypes.c_void_p))
    _check_launch(err, "planar_gru_plan")
    return dict(zip(("tile", "blocks", "smem"), plan))


planar_conv.launches = 0
planar_conv2.launches = 0
planar_conv_gru.launches = 0
planar_gru.launches = 0


def fold_bn(bn_scale: torch.Tensor, bn_bias: torch.Tensor,
            bn_mean: torch.Tensor, bn_var: torch.Tensor, eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm -> per-channel affine (scale, bias), (C,)
    float32: ``inv = gamma / sqrt(var + eps)``, ``bias = beta - mean * inv``
    (vidmat/ops/pallas/planar.py fold_bn, the same float32 operations)."""
    inv = bn_scale.float() / torch.sqrt(bn_var.float() + eps)
    return inv, bn_bias.float() - bn_mean.float() * inv
