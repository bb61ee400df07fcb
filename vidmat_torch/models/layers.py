"""Core layers of the matting network (counterpart of
vidmat/models/layers.py), NCHW.

Module and parameter names mirror the Flax modules so the weight bridge
(``vidmat_torch.models.weights``) is a mechanical rename: Flax
``stem/conv/kernel`` is ``stem.conv.weight`` here.

Numerics follow Flax under a compute dtype: the conv runs in the input's
dtype with the weights cast to it, and BatchNorm (inference, running
statistics) is computed in float32 and cast back, as Flax promotes the
normalisation to its float32 statistics.

In training mode (``bn_train=True``) BatchNorm computes Flax's
``nn.BatchNorm(use_running_average=False, momentum=0.99)`` with
``use_fast_variance``: per call, the batch mean over N, H and W, the
biased variance ``max(0, E[x^2] - E[x]^2)`` (both means accumulated in
float64, then float32), and the normalisation with those in float32.
The running statistics are not written by the module: each call reports
its batch statistics to the innermost ``batch_statistics()`` scope, and
the caller folds them in with ``ema_update`` (``running = 0.99 * running
+ 0.01 * batch``, the biased variance included), as Flax returns the
mutated collection. ``F.batch_norm(training=True)`` would
compute another function: it updates ``running_var`` with the unbiased
variance and weighs the new value, not the old one, by its momentum.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Module):
    """Conv2d with symmetric padding k//2 on both sides (the JAX package
    pads explicitly, so a stride-2 conv samples the same pixels as
    ``padding=1`` here). Weights stay float32 and are cast to the input's
    dtype at call time."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride
        self.padding = kernel // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding)


#: Flax's BatchNorm momentum: the weight of the old running value.
BN_MOMENTUM = 0.99

_SCOPE = threading.local()


@contextlib.contextmanager
def batch_statistics():
    """Collect the batch statistics of every training-mode BatchNorm run
    in the scope: yields a list that receives ``(module, mean, var)`` per
    call (detached float32 (C,) tensors), in call order. A recomputation
    under ``torch.utils.checkpoint`` that opens its own scope reports
    there, so a frame's statistics are counted once."""
    prev = getattr(_SCOPE, "sink", None)
    sink: List[Tuple[nn.Module, torch.Tensor, torch.Tensor]] = []
    _SCOPE.sink = sink
    try:
        yield sink
    finally:
        _SCOPE.sink = prev


def ema_update(running: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """Flax's running-statistic update: ``0.99 * running + 0.01 * batch``."""
    return BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch


def clip_ties_half(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: equal values to a clamp, but a value
    exactly at a bound passes half the gradient (max then min split ties),
    where ``torch.clamp`` passes all of it. Training paths use it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def abs_ties_one(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with its gradient: +1 at exactly 0, where
    ``torch.abs`` gives 0. Training losses use it."""
    return torch.where(x >= 0, x, -x)


class BatchNorm(nn.Module):
    """BatchNorm in float32: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, cast back to the input dtype (the order Flax computes it in).
    Inference (``bn_train=False``) normalises with the running statistics;
    training with the batch's (see the module docstring)."""

    def __init__(self, c: int, eps: float = 1e-5, bn_train: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps
        self.bn_train = bn_train

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn_train:
            return self._train_forward(x)
        return self.normalize(x, self.running_mean, self.running_var)

    def normalize(self, x: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor) -> torch.Tensor:
        """``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
        cast back to x's dtype; the statistics and parameters are read on
        x's device."""
        shape, dev = (1, -1, 1, 1), x.device
        mul = torch.rsqrt(var.to(dev) + self.eps) * self.weight.to(dev)
        y = (x.float() - mean.to(dev).view(shape)) * mul.view(shape)
        return (y + self.bias.to(dev).view(shape)).to(x.dtype)

    def batch_stats(self, sums: torch.Tensor, count) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
        """The batch's (mean, var), float32 (C,), from the float64 (2, C)
        sums of x and x^2 over ``count`` values a channel; reported to the
        innermost ``batch_statistics()`` scope. A sharded step passes the
        sums and count of every position (``parallel/spatial.py``)."""
        mean = sums[0] / count
        mean2 = sums[1] / count
        # jnp.maximum's tie rule (half the gradient at var == 0).
        var = torch.maximum(mean2 - mean * mean, mean.new_zeros(())).float()
        mean = mean.float()
        sink = getattr(_SCOPE, "sink", None)
        if sink is not None:
            sink.append((self, mean.detach(), var.detach()))
        return mean, var

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(
            x, *self.batch_stats(batch_moments(x), x.numel() // x.shape[1]))


def batch_moments(x: torch.Tensor) -> torch.Tensor:
    """The float64 (2, C) sums of x and x^2 over N, H and W (x NCHW).

    They accumulate in float64: E[x^2] - E[x]^2 cancels where the mean is
    large against the spread, and float32 sums lose the variance there
    (by ~1e-4 relative at a mean of 6 std, in JAX as in PyTorch, each
    with its own summation order)."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(0, 2, 3), dtype=torch.float64),
                        (xf * xf).sum(dim=(0, 2, 3), dtype=torch.float64)])


class ConvBNAct(nn.Module):
    """Conv -> (BatchNorm) -> (ReLU)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 use_bn: bool = True, act: bool = True, bn_eps: float = 1e-5,
                 bn_train: bool = False):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, bias=not use_bn)
        self.bn = BatchNorm(cout, bn_eps, bn_train) if use_bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class ConvGRUCell(nn.Module):
    """Convolutional GRU:
      r, z = sigmoid(split(conv3x3([x, h])))
      c    = tanh(conv3x3([x, r * h]))
      h'   = (1 - z) * h + z * c
    """

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.gates = Conv(cin + features, 2 * features, 3)
        self.cand = Conv(cin + features, features, 3)
        self.features = features

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h = h.to(x.dtype)
        rz = torch.sigmoid(self.gates(torch.cat([x, h], dim=1)))
        r, z = torch.split(rz, self.features, dim=1)
        c = torch.tanh(self.cand(torch.cat([x, r * h], dim=1)))
        return (1.0 - z) * h + z * c


class BottleneckGate(nn.Module):
    """1x1 projection modulated by a sigmoid gate computed from the global
    average pool."""

    def __init__(self, cin: int, features: int, bn_eps: float = 1e-5,
                 bn_train: bool = False):
        super().__init__()
        self.proj = ConvBNAct(cin, features, kernel=1, bn_eps=bn_eps,
                              bn_train=bn_train)
        self.gate = Conv(cin, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.proj(x)
        g = self.gate(x.mean(dim=(2, 3), keepdim=True))
        return a * torch.sigmoid(g)
