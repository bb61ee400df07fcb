"""Core layers of the matting network (counterpart of
vidmat/models/layers.py), NCHW.

Module and parameter names mirror the Flax modules so the weight bridge
(``vidmat_torch.models.weights``) is a mechanical rename: Flax
``stem/conv/kernel`` is ``stem.conv.weight`` here.

Numerics follow Flax under a compute dtype: the conv runs in the input's
dtype with the weights cast to it, and BatchNorm (inference, running
statistics) is computed in float32 and cast back, as Flax promotes the
normalisation to its float32 statistics.
"""

from __future__ import annotations

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


class BatchNorm(nn.Module):
    """Inference BatchNorm over running statistics, in float32:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast back to the
    input dtype (the order Flax computes it in)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class ConvBNAct(nn.Module):
    """Conv -> (BatchNorm) -> (ReLU)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 use_bn: bool = True, act: bool = True, bn_eps: float = 1e-5):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, bias=not use_bn)
        self.bn = BatchNorm(cout, bn_eps) if use_bn else None
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

    def __init__(self, cin: int, features: int, bn_eps: float = 1e-5):
        super().__init__()
        self.proj = ConvBNAct(cin, features, kernel=1, bn_eps=bn_eps)
        self.gate = Conv(cin, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.proj(x)
        g = self.gate(x.mean(dim=(2, 3), keepdim=True))
        return a * torch.sigmoid(g)
