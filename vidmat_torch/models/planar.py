"""The planar-kernel network (counterpart of vidmat/models/planar.py,
``build_planar_forward``).

It runs the same variables as ``MattingNetwork``, with every conv and GRU
of the net through the four planar kernels (``vidmat_torch.ops.planar``):

  encoder     stem (planar_conv, stride 2), then s2a+s2b, s3a+s3b, s4a+s4b
              (planar_conv2: a stride-2 conv and a 3x3 in one launch)
  bottleneck  proj (planar_conv, 1x1) times a sigmoid gate of the global
              mean (plain torch: f32 mean, sigmoid, product, cast)
  decoder     d3, d2, d1: 2x upsample of the previous stage, then
              planar_conv_gru (conv + split + ConvGRU in one launch)
  full res    d0 + head (planar_conv2, act2 none), depth-to-space, clip,
              the foreground residual; a trimap-conditioned model pins the
              alpha to the trimap's known regions. ``seg=True`` (a
              co-trained network) fuses d0 + seg_head instead and returns
              the segmentation logits

BatchNorm is folded once at build time (``folded_planar_params``); on
bfloat16 planes every conv weight a planar_conv call takes is also packed
once into its tensor-core layout (``ops.pack_conv_weight``). The
glue (2x bilinear upsample with half-pixel centers, space-to-depth,
depth-to-space, clip) is plain torch on NCHW tensors. The JAX package's
upsample is two banded matmuls with a cast to the plane dtype between
them; ``upsample2x`` here rounds at the same place.

``fuse_pairs=False`` runs each pair as two planar_conv launches and each
decoder stage as planar_conv, a split and planar_gru, the JAX package's
unfused chain. With ``fuse_pairs=True`` every site fuses: the JAX fit
rules (``conv2_fits``, ``conv_gru_fits``) bound a fused site's halo by the
TPU's lane chunk and are not ported; the CUDA kernels tile the image in
two dimensions and size their shared memory per launch.

``encode`` is the stateless half and takes a batch of frames; ``decode``
is the recurrent half, one batch of states at a time: the stage-steps
``decode_stage`` (d3, d2, d1) and ``decode_head`` in order, which a
chunk's wavefront (``pipeline/wavefront.py``) issues on their own
streams. ``plain=True`` calls the kernels' plain PyTorch versions on
any device (the reference the kernel path is held against on the
card).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vidmat_torch.config import ModelConfig
from vidmat_torch.models.matting_net import depth_to_space, space_to_depth
from vidmat_torch.ops import planar as ops

_KERNELS = {"conv": ops.planar_conv, "conv2": ops.planar_conv2,
            "conv_gru": ops.planar_conv_gru, "gru": ops.planar_gru}
_PLAIN = {"conv": ops.planar_conv_plain, "conv2": ops.planar_conv2_plain,
          "conv_gru": ops.planar_conv_gru_plain, "gru": ops.planar_gru_plain}


class PlanarState(NamedTuple):
    """Recurrent carry: the GRU hidden maps at strides 8/4/2 (of the
    s2d-packed grid), NCHW in the plane dtype."""

    h3: torch.Tensor
    h2: torch.Tensor
    h1: torch.Tensor


class PlanarEncoding(NamedTuple):
    """``encode``'s output for a batch of frames, NCHW: the packed input
    (the full-res stage's conditioning), the frame's RGB in float32, the
    trimap channel of a trimap-conditioned model (else None), the encoder
    skips f1..f3 and the gated bottleneck b4."""

    x_in: torch.Tensor
    rgb: torch.Tensor
    tri: Optional[torch.Tensor]
    f1: torch.Tensor
    f2: torch.Tensor
    f3: torch.Tensor
    b4: torch.Tensor

    def frame(self, i: int) -> "PlanarEncoding":
        """The encoding of frame i alone (batch 1)."""
        return PlanarEncoding(*(None if t is None else t[i:i + 1]
                                for t in self))


def planar_init_state(cfg: ModelConfig, batch: int, height: int, width: int,
                      dtype=torch.bfloat16, device="cpu") -> PlanarState:
    """Zero carry for a (batch, height, width) stream (height and width are
    FRAME dims, before space-to-depth)."""
    d, s = cfg.dec_channels, cfg.space_to_depth

    def z(c, div):
        return torch.zeros((batch, c, height // (div * s), width // (div * s)),
                           dtype=dtype, device=device)

    return PlanarState(h3=z(d[0] // 2, 8), h2=z(d[1] // 2, 4),
                       h1=z(d[2] // 2, 2))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample, half-pixel centers, NCHW: rows then columns,
    each pass in float32 and cast to the input's dtype (as the JAX planar
    glue rounds between its two matmuls)."""
    dt = x.dtype
    t = F.interpolate(x.float(), scale_factor=(2.0, 1.0), mode="bilinear",
                      align_corners=False).to(dt)
    return F.interpolate(t.float(), scale_factor=(1.0, 2.0), mode="bilinear",
                         align_corners=False).to(dt)


class PlanarNetwork(nn.Module):
    """forward(frame, state) -> (alpha, fgr, new_state), the contract of
    ``MattingNetwork``: frame (N, H, W, C) in [0, 1] with H and W divisible
    by 16 * space_to_depth; alpha (N, H, W, 1) and fgr (N, H, W, 3) float32;
    state a PlanarState or None (cold start).

    params: ``folded_planar_params(cfg, variables, dtype)``; dtype: the
    plane dtype (bfloat16 for serving, float32 for parity)."""

    def __init__(self, cfg: ModelConfig,
                 params: Dict[str, Dict[str, torch.Tensor]],
                 dtype: torch.dtype = torch.float32, fuse_pairs: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.fuse_pairs = fuse_pairs
        self._sites = {}
        for site, tensors in params.items():
            tensors = dict(tensors)
            w = tensors.get("w")
            if dtype == torch.bfloat16 and w is not None and w.dim() == 4:
                tensors["wp"] = ops.pack_conv_weight(w)
            self._sites[site] = tuple(tensors)
            for key, t in tensors.items():
                self.register_buffer(f"{site}_{key}", t.contiguous())

    def _p(self, site: str) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"{site}_{k}") for k in self._sites[site]}

    def _conv(self, k, xs, site: str, stride: int = 1, act: str = "relu"):
        """planar_conv of ``site`` (the kernel with its packed weights, or
        the plain version)."""
        p = self._p(site)
        extra = {"packed": p["wp"]} if k is _KERNELS and "wp" in p else {}
        return k["conv"](xs, p["w"], p["scale"], p["bias"], stride, act,
                         **extra)

    def init_state(self, batch: int, height: int, width: int) -> PlanarState:
        return planar_init_state(self.cfg, batch, height, width, self.dtype,
                                 self.head_w.device)

    def encode(self, frame: torch.Tensor, plain: bool = False
               ) -> PlanarEncoding:
        """Stateless half: packing, encoder and gated bottleneck for a
        batch of frames (N, H, W, C)."""
        k = _PLAIN if plain else _KERNELS
        s = self.cfg.space_to_depth
        x = frame.permute(0, 3, 1, 2)
        rgb = x[:, :3].float()
        # The trimap channel as the frame gives it (vidmat/models/
        # planar.py:321), before the cast to the plane dtype.
        tri = (x[:, 3:4] if self.cfg.use_trimap and x.shape[1] >= 4
               else None)
        x = x.to(self.dtype)
        x_in = (space_to_depth(x, s) if s > 1 else x).contiguous()

        def cba(xs, site, stride=1, act="relu"):
            return self._conv(k, xs, site, stride, act)

        def enc_stage(f, a, b):
            if self.fuse_pairs:
                pa, pb = self._p(a), self._p(b)
                return k["conv2"]([f], pa["w"], pa["scale"], pa["bias"],
                                  pb["w"], pb["scale"], pb["bias"], 2,
                                  "relu", "relu")
            return cba([cba([f], a, 2)], b)

        f1 = cba([x_in], "stem", 2)
        f2 = enc_stage(f1, "s2a", "s2b")
        f3 = enc_stage(f2, "s3a", "s3b")
        f4 = enc_stage(f3, "s4a", "s4b")

        proj = cba([f4], "proj")
        g = self._p("gate")
        gmean = f4.float().sum((2, 3)) / float(f4.shape[2] * f4.shape[3])
        # (N, C) x (C, F) as a broadcast product and sum: no library GEMM
        # on the planar body for a 64 x 64 product.
        gate = torch.sigmoid((gmean[:, :, None] * g["w"]).sum(1) + g["b"])
        b4 = (proj.float() * gate[:, :, None, None]).to(self.dtype)
        return PlanarEncoding(x_in, rgb, tri, f1, f2, f3, b4)

    #: decode's ConvGRU stage-steps in order, each with its skip
    STAGES = (("d3", "f3"), ("d2", "f2"), ("d1", "f1"))

    def decode_stage(self, j: int, enc: PlanarEncoding, xs, h_prev,
                     plain: bool = False):
        """Stage-step j of ``STAGES``: the 2x upsample of the previous
        stage-step's outputs xs ([b4] before d3), then the conv and ConvGRU
        over them and the skip. Returns (xs, h_new): the outputs the next
        stage-step takes and the new hidden map (None on a non-recurrent
        model)."""
        k = _PLAIN if plain else _KERNELS
        name, skip = self.STAGES[j]
        skip = getattr(enc, skip)
        ups = [upsample2x(t) for t in xs] + [skip]
        p = self._p(name)
        if not self.cfg.recurrent:
            return [self._conv(k, ups, name)], None
        g = self._p(f"{name}_gru")
        gw = (g["wg"], g["bg"], g["wc"], g["bc"])
        half = p["w"].shape[0] // 2
        if h_prev is None:
            n, _, hh, ww = skip.shape
            h_prev = torch.zeros((n, half, hh, ww), dtype=self.dtype,
                                 device=skip.device)
        if self.fuse_pairs:
            a, h_new = k["conv_gru"](ups, p["w"], p["scale"], p["bias"],
                                     h_prev, *gw)
        else:
            mid = self._conv(k, ups, name)
            a = mid[:, :half].contiguous()
            h_new = k["gru"](mid[:, half:].contiguous(), h_prev, *gw)
        return [a, h_new], h_new

    def decode_head(self, enc: PlanarEncoding, xs, plain: bool = False,
                    seg: bool = False):
        """The last stage-step: the 2x upsample of d1's outputs, d0 and the
        head at full resolution, depth-to-space, the clip and the
        foreground residual. Returns (alpha (N, H, W, 1), fgr (N, H, W,
        3)) float32, or with ``seg`` (seg_logits (N, H, W, 1), None)."""
        k = _PLAIN if plain else _KERNELS
        s = self.cfg.space_to_depth
        # rgb is a channel slice of the permuted frame: the kernels take
        # contiguous planes.
        cond = enc.x_in if s > 1 else enc.rgb.to(self.dtype).contiguous()
        ups = [upsample2x(t) for t in xs] + [cond]
        head = "seg_head" if seg else "head"
        if head not in self._sites:
            raise ValueError("the segmentation pass needs a co-trained "
                             "network (a seg_head in its variables)")
        d0, hd = self._p("d0"), self._p(head)
        if self.fuse_pairs:
            out = k["conv2"](ups, d0["w"], d0["scale"], d0["bias"], hd["w"],
                             hd["scale"], hd["bias"], 1, "relu", "none")
        else:
            y = self._conv(k, ups, "d0")
            out = self._conv(k, [y], head, 1, "none")
        og = out.float()
        if s > 1:
            og = depth_to_space(og, s)
        if seg:
            return og[:, 0:1].permute(0, 2, 3, 1), None
        alpha = og[:, 0:1].clamp(0.0, 1.0)
        fgr = (og[:, 1:4] + enc.rgb).clamp(0.0, 1.0)
        if enc.tri is not None:
            # Known foreground and background are pinned.
            alpha = torch.where(enc.tri >= 0.75, 1.0,
                                torch.where(enc.tri <= 0.25, 0.0, alpha))
        return alpha.permute(0, 2, 3, 1), fgr.permute(0, 2, 3, 1)

    def new_state(self, hs, state: Optional[PlanarState]):
        """The carry after a frame whose stage-steps gave the hidden maps
        hs (d3, d2, d1): ``state`` itself on a non-recurrent model."""
        return PlanarState(*hs) if self.cfg.recurrent else state

    def decode(self, enc: PlanarEncoding, state: Optional[PlanarState],
               plain: bool = False, seg: bool = False):
        """Recurrent half: the stage-steps d3, d2, d1 and the full-res
        head in order, on one batch of encodings. Returns (alpha, fgr,
        new_state), or with ``seg`` (seg_logits (N, H, W, 1) float32,
        None, new_state)."""
        hs = (None,) * len(self.STAGES) if state is None else tuple(state)
        xs, new = [enc.b4], []
        for j, h in enumerate(hs):
            xs, h = self.decode_stage(j, enc, xs, h, plain)
            new.append(h)
        alpha, fgr = self.decode_head(enc, xs, plain, seg)
        return alpha, fgr, self.new_state(new, state)

    def forward(self, frame: torch.Tensor,
                state: Optional[PlanarState] = None, plain: bool = False,
                seg: bool = False):
        return self.decode(self.encode(frame, plain), state, plain, seg)
