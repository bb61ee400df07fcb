"""The recurrent matting network (counterpart of
vidmat/models/matting_net.py).

The public layout is the JAX package's: frames, alpha, foreground and the
recurrent state are NHWC. Inside, the network runs NCHW views of those
tensors (a permuted NHWC tensor is a channels-last NCHW tensor, which
cuDNN takes as it is).

Architecture:
  encoder: conv stem + 3 conv stages at strides 2/4/8/16
  bottleneck: global-context gate
  decoder: 3 upsample stages with skip concat + split-half ConvGRU
           (recurrent state = the GRU half-channels at strides 8/4/2),
           final full-res stage conditioned on the raw frame
  heads: alpha (1ch) + foreground residual (3ch); with a co-trained
         checkpoint also ``seg_head`` (segmentation logits, 1ch)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from vidmat_torch.config import ModelConfig
from vidmat_torch.models.layers import (BottleneckGate, Conv, ConvBNAct,
                                        ConvGRUCell, clip_ties_half)
from vidmat_torch.ops.resize import upsample2x


class RecurrentState(NamedTuple):
    """Per-stream temporal state: ConvGRU hidden maps at strides 8/4/2,
    NHWC.

    Shapes for an (N, H, W, C) input with space-to-depth factor s:
      h3: (N, H/(8s), W/(8s), dec_channels[0] // 2)
      h2: (N, H/(4s), W/(4s), dec_channels[1] // 2)
      h1: (N, H/(2s), W/(2s), dec_channels[2] // 2)
    """

    h3: torch.Tensor
    h2: torch.Tensor
    h1: torch.Tensor


def init_state(cfg: ModelConfig, batch: int, height: int, width: int,
               dtype=torch.float32, device="cpu") -> RecurrentState:
    """Zero temporal state for a (batch, height, width) stream (height and
    width are the FRAME dims; space_to_depth shifts the grids down)."""
    d = cfg.dec_channels
    s = cfg.space_to_depth

    def z(div, c):
        return torch.zeros((batch, height // (div * s), width // (div * s),
                            c), dtype=dtype, device=device)

    return RecurrentState(h3=z(8, d[0] // 2), h2=z(4, d[1] // 2),
                          h1=z(2, d[2] // 2))


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW (N, C, H, W) -> (N, r*r*C, H/r, W/r), channel order [dy, dx, c]
    (c fastest), as the JAX package packs NHWC."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of space_to_depth. NCHW."""
    n, c4, h, w = x.shape
    c = c4 // (r * r)
    x = x.reshape(n, r, r, c, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * r, w * r)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, bn_train: bool = False):
        super().__init__()
        c, e, s = cfg.enc_channels, cfg.bn_eps, cfg.space_to_depth

        def cba(cin, cout, stride=1):
            return ConvBNAct(cin, cout, stride=stride, bn_eps=e,
                             bn_train=bn_train)

        self.stem = cba(cfg.in_channels * s * s, c[0], 2)
        self.s2a = cba(c[0], c[1], 2)
        self.s2b = cba(c[1], c[1])
        self.s3a = cba(c[1], c[2], 2)
        self.s3b = cba(c[2], c[2])
        self.s4a = cba(c[2], c[3], 2)
        self.s4b = cba(c[3], c[3])

    def forward(self, x):
        f1 = self.stem(x)
        f2 = self.s2b(self.s2a(f1))
        f3 = self.s3b(self.s3a(f2))
        f4 = self.s4b(self.s4a(f3))
        return f1, f2, f3, f4


class DecoderStage(nn.Module):
    """Upsample 2x -> concat skip -> conv -> split-half ConvGRU (the GRU
    runs on the second half of the channels only)."""

    def __init__(self, cin: int, skip: int, features: int, recurrent: bool,
                 bn_eps: float = 1e-5, bn_train: bool = False):
        super().__init__()
        self.conv = ConvBNAct(cin + skip, features, bn_eps=bn_eps,
                              bn_train=bn_train)
        self.recurrent = recurrent
        self.features = features
        if recurrent:
            self.gru = ConvGRUCell(features // 2, features // 2)

    def forward(self, x, skip, h: Optional[torch.Tensor]):
        x = self.conv(torch.cat([upsample2x(x), skip], dim=1))
        if not self.recurrent:
            return x, None
        a, b = torch.split(x, self.features // 2, dim=1)
        if h is None:
            h = torch.zeros_like(b)
        h_new = self.gru(b, h)
        return torch.cat([a, h_new], dim=1), h_new


class MattingNetwork(nn.Module):
    """Recurrent encoder-decoder matting network.

    forward(frame, state) -> (alpha, fgr, new_state)
      frame: (N, H, W, cfg.in_channels) in [0, 1], H and W divisible by
             16 * space_to_depth; cast to the compute dtype, except for
             the RGB the foreground residual is added to.
      state: RecurrentState (NHWC) or None (cold start, zeros).
      alpha: (N, H, W, 1) float32 in [0, 1]
      fgr:   (N, H, W, 3) float32 in [0, 1]

    This is the network as plain convolutions (``conv_impl="xla"``). The
    same variables run through the planar conv kernels as
    ``vidmat_torch.models.planar.PlanarNetwork``, which ``build_network``
    returns for ``conv_impl="planar"``; this module computes the same
    function whatever ``conv_impl`` says. With ``cfg.use_trimap`` the
    fourth input channel is the trimap in [0, 1]: where it is >= 0.75 the
    alpha is pinned to 1, where <= 0.25 to 0, as in the JAX network.

    forward(frame, state, seg_pass=True) -> (seg_logits (N, H, W, 1)
    float32, None, new_state): the segmentation pass of a co-trained
    network (``with_seg``): the same trunk, with ``seg_head`` in place of
    the matting head; the state advances as in the matting pass.

    ``bn_train=True`` is the training network (the JAX package's
    ``MattingNetwork(cfg, bn_train=True)``): every BatchNorm normalises
    with the batch's statistics and reports them to
    ``layers.batch_statistics()``, and the head's clips pass half the
    gradient at a bound, as ``jnp.clip`` does.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 dtype: Optional[torch.dtype] = None,
                 with_seg: bool = False, bn_train: bool = False):
        super().__init__()
        self.cfg = cfg
        # Compute dtype: None = float32 (parity path); torch.bfloat16 for
        # serving (parameters stay float32 and are cast per layer).
        self.dtype = dtype
        c, d, e = cfg.enc_channels, cfg.dec_channels, cfg.bn_eps
        s = cfg.space_to_depth
        self.bn_train = bn_train
        bt = bn_train
        self.encoder = Encoder(cfg, bt)
        self.bottleneck = BottleneckGate(c[3], c[3], bn_eps=e, bn_train=bt)
        self.d3 = DecoderStage(c[3], c[2], d[0], cfg.recurrent, e, bt)
        self.d2 = DecoderStage(d[0], c[1], d[1], cfg.recurrent, e, bt)
        self.d1 = DecoderStage(d[1], c[0], d[2], cfg.recurrent, e, bt)
        cond_ch = cfg.in_channels * s * s if s > 1 else 3
        self.d0 = ConvBNAct(d[2] + cond_ch, d[3], bn_eps=e, bn_train=bt)
        self.head = Conv(d[3], 4 * s * s, 3)
        self.seg_head = Conv(d[3], s * s, 3) if with_seg else None

    def forward(self, frame: torch.Tensor,
                state: Optional[RecurrentState] = None,
                seg_pass: bool = False):
        cfg = self.cfg
        s = cfg.space_to_depth
        x = frame.permute(0, 3, 1, 2)
        rgb = x[:, :3]
        if self.dtype is not None:
            x = x.to(self.dtype)
        x_in = space_to_depth(x, s) if s > 1 else x

        f1, f2, f3, f4 = self.encoder(x_in)
        b4 = self.bottleneck(f4)

        h3 = h2 = h1 = None
        if state is not None:
            h3, h2, h1 = (t.permute(0, 3, 1, 2) for t in state)
        y, n3 = self.d3(b4, f3, h3)
        y, n2 = self.d2(y, f2, h2)
        y, n1 = self.d1(y, f1, h1)

        cond = x_in if s > 1 else rgb
        y = self.d0(torch.cat([upsample2x(y), cond.to(y.dtype)], dim=1))

        new_state = state
        if cfg.recurrent:
            new_state = RecurrentState(*(t.permute(0, 2, 3, 1)
                                         for t in (n3, n2, n1)))
        if seg_pass:
            if self.seg_head is None:
                raise ValueError("the segmentation pass needs a co-trained "
                                 "network (a seg_head in its variables)")
            seg = self.seg_head(y)
            if s > 1:
                seg = depth_to_space(seg, s)
            return seg.float().permute(0, 2, 3, 1), None, new_state
        out = self.head(y)
        if s > 1:
            out = depth_to_space(out, s)
        return (*self.alpha_fgr(out.float(), x, rgb), new_state)

    def alpha_fgr(self, out: torch.Tensor, x: torch.Tensor,
                  rgb: torch.Tensor):
        """The head's float32 output at frame resolution (NCHW) -> (alpha,
        fgr) NHWC; x is the NCHW input in the compute dtype, rgb its RGB
        (float input)."""
        if self.bn_train:
            alpha = clip_ties_half(out[:, 0:1], 0.0, 1.0)
            fgr = clip_ties_half(out[:, 1:4] + rgb.float(), 0.0, 1.0)
        else:
            alpha = out[:, 0:1].clamp(0.0, 1.0)
            fgr = (out[:, 1:4] + rgb.float()).clamp(0.0, 1.0)
        if self.cfg.use_trimap and x.shape[1] >= 4:
            # Known foreground and background are pinned; only the
            # unknown band is predicted (vidmat/models/matting_net.py).
            tri = x[:, 3:4]
            alpha = torch.where(tri >= 0.75, 1.0,
                                torch.where(tri <= 0.25, 0.0, alpha))
        return alpha.permute(0, 2, 3, 1), fgr.permute(0, 2, 3, 1)
