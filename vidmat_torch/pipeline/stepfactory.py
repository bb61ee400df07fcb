"""The serving step body (counterpart of vidmat/pipeline/stepfactory.py).

The body maps one uint8 frame batch through the serving chain:

  ingest (area pool + normalize, CUDA kernel)
  -> recurrent matting net (bf16, s2d-aware edge padding): the planar conv
     kernels for conv_impl="planar" (the preset), F.conv2d for "xla"
  -> guided-filter coefficients at the coarse grid (CUDA kernel)
  -> fused refine + composite + RGBA pack at full resolution (CUDA kernel)

On the planar net the plan also carries ``chunk_body``, which runs the
stateless stages (ingest, encoder and bottleneck, guided-filter
coefficients, the fused tail) once over a K-frame chunk and only the
recurrent decoder per frame (vidmat/pipeline/stepfactory.py:656-693).

Only the branch the ``video_1080p`` preset takes is ported: an integer
coarse pool > 1, guided refinement, packed output (optionally reduced to
the alpha byte), a color background or none. Every other combination
raises NotImplementedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.models.planar import PlanarNetwork
from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                 guided_filter_coeffs_plain)
from vidmat_torch.ops.guided_filter import gray_guide
from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                     ingest_pool_normalize_plain)
from vidmat_torch.ops.refine import (fused_refine_composite,
                                     fused_refine_composite_plain)
from vidmat_torch.ops.resize import downsample_ratio_shape


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Static facts about a built serving body that call sites need."""

    net_h: int          # coarse grid fed to the network (pre-s2d-padding)
    net_w: int
    state_h: int        # recurrent-state grid (coarse + s2d padding)
    state_w: int
    pool: int           # integer area-pool factor
    alpha_only: bool    # body returns (N, H, W) uint8 alpha, not packed
    # Zero recurrent carry for a batch size (None when non-recurrent).
    make_state: Callable = None
    # chunk_body(frames_u8 (K, h, w, 3), state) -> (out (K, h, w), state):
    # the K frames in one call, stateless stages batched (planar net only).
    chunk_body: Optional[Callable] = None


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def alpha_byte(packed: torch.Tensor) -> torch.Tensor:
    """The alpha byte of packed words, (N, H, W) uint8: the high byte of
    each little-endian word, i.e. ``packed >> 24``."""
    return packed.view(torch.uint8).reshape(*packed.shape, 4)[..., 3]


def build_serving_body(
    net: torch.nn.Module,
    model_cfg: ModelConfig,
    refine: RefineConfig,
    h: int,
    w: int,
    ratio: float,
    *,
    cdtype: torch.dtype = torch.bfloat16,
    bg: Optional[Sequence[float]] = None,
    need_fgr: bool = False,
    alpha_only: bool = False,
    tile_size: Optional[int] = None,
    static_skip_eps: Optional[float] = None,
    kernels: bool = True,
) -> Tuple[Callable, ServingPlan]:
    """Build the serving body for a static (h, w, ratio) bucket.

    net:      the network (``build_network``: a PlanarNetwork for
              conv_impl="planar", else a MattingNetwork) on the device the
              body runs on, built with compute dtype ``cdtype``.
    bg:       (3,) float background color, or None (premultiplied output).
    alpha_only: return the (N, h, w) uint8 alpha byte instead of the
              packed words (a 4x smaller device-to-host copy).
    kernels:  True (serving): the stages call the kernel wrappers, which
              launch the CUDA kernels on CUDA tensors and run the plain
              versions on CPU tensors. False: the stages (and the planar
              net's convs) call the plain PyTorch versions on any device,
              the reference the kernel path is held against on the card.

    Returns (body, plan) where
      body(frame_u8 (N, h, w, 3) uint8, state) -> (out, new_state)
      out = (N, h, w) uint8 alpha   if plan.alpha_only
          | (N, h, w) uint32 packed RGBA (R | G<<8 | B<<16 | A<<24)
    """
    if model_cfg.use_trimap:
        raise _unported("trimap-conditioned serving", "A.10")
    if model_cfg.use_bg_plate:
        raise _unported("clean-plate conditioning", "A.9")
    if need_fgr:
        raise _unported("raw-foreground output (the float tail)", "A.6")
    if tile_size:
        raise _unported("tiled refinement", "A.8")
    if static_skip_eps is not None:
        raise _unported("the static-scene fast path", "A.6")
    if refine.mode == "errormap":
        raise _unported("error-map refinement", "A.11")
    if refine.mode != "guided":
        raise _unported(f"refine mode {refine.mode!r} (unfused tails)",
                        "A.4")
    if bg is not None and (torch.is_tensor(bg) and bg.dim() != 1
                           or len(bg) != 3):
        raise _unported("image and per-frame backgrounds", "A.9")
    net_h, net_w = ((h, w) if ratio >= 1.0
                    else downsample_ratio_shape(h, w, ratio))
    full = (net_h, net_w) == (h, w)
    pool = (h // net_h if (not full and h % net_h == 0 and w % net_w == 0
                           and h // net_h == w // net_w) else 0)
    if pool < 2:
        raise _unported(
            f"a coarse pass that is not an integer pool > 1 ({h}x{w} -> "
            f"{net_h}x{net_w}; unfused guided, bilinear and full-res tails)",
            "A.4")
    bg = None if bg is None else [float(v) for v in bg]

    # space_to_depth models need the coarse grid padded to 16*s2d.
    mult = 16 * model_cfg.space_to_depth
    pad_nh = -net_h % mult
    pad_nw = -net_w % mult
    state_h, state_w = net_h + pad_nh, net_w + pad_nw

    if kernels:
        ingest, gf_coeffs, tail = (ingest_pool_normalize,
                                   guided_filter_coeffs,
                                   fused_refine_composite)
    else:
        ingest, gf_coeffs, tail = (ingest_pool_normalize_plain,
                                   guided_filter_coeffs_plain,
                                   fused_refine_composite_plain)

    planar = isinstance(net, PlanarNetwork)

    def make_state(batch: int):
        if not model_cfg.recurrent:
            return None
        if planar:
            return net.init_state(batch, state_h, state_w)
        from vidmat_torch.models.matting_net import init_state

        dev = next(net.parameters()).device
        return init_state(model_cfg, batch, state_h, state_w, cdtype, dev)

    def net_apply(xp, state):
        if planar:
            return net(xp, state, plain=not kernels)
        return net(xp, state)

    def prep_net_input(x):
        """Edge-pad the coarse frame (N, net_h, net_w, C) to the s2d grid
        at the bottom and right."""
        if not (pad_nh or pad_nw):
            return x
        xp = F.pad(x.permute(0, 3, 1, 2), (0, pad_nw, 0, pad_nh),
                   mode="replicate")
        return xp.permute(0, 2, 3, 1)

    def finish(frame_u8, x, alpha, fgr):
        """Coefficients and the fused tail on coarse alpha/fgr."""
        alpha = alpha[:, :net_h, :net_w].float()
        fgr = fgr[:, :net_h, :net_w].float()
        # The guide comes from the ingested coarse frame (RGB channels).
        guide = gray_guide(x[..., :3].float())
        p = torch.cat([alpha, fgr], dim=-1)
        ma, mb = gf_coeffs(guide, p, refine.guided_radius, refine.guided_eps)
        out = tail(frame_u8[..., :3], ma, mb, bg, pool)
        return alpha_byte(out) if alpha_only else out

    @torch.inference_mode()
    def body(frame_u8: torch.Tensor, state):
        x = ingest(frame_u8, pool=pool, out_dtype=cdtype)
        alpha, fgr, new_state = net_apply(prep_net_input(x), state)
        return finish(frame_u8, x, alpha, fgr), new_state

    @torch.inference_mode()
    def chunk_body(frames_u8: torch.Tensor, state):
        x = ingest(frames_u8, pool=pool, out_dtype=cdtype)
        enc = net.encode(prep_net_input(x), plain=not kernels)
        alphas, fgrs = [], []
        for i in range(frames_u8.shape[0]):
            alpha, fgr, state = net.decode(enc.frame(i), state,
                                           plain=not kernels)
            alphas.append(alpha)
            fgrs.append(fgr)
        return finish(frames_u8, x, torch.cat(alphas), torch.cat(fgrs)), \
            state

    plan = ServingPlan(net_h=net_h, net_w=net_w, state_h=state_h,
                       state_w=state_w, pool=pool, alpha_only=alpha_only,
                       make_state=make_state,
                       chunk_body=chunk_body if planar else None)
    return body, plan
