"""The serving step body (counterpart of vidmat/pipeline/stepfactory.py).

The body maps one frame batch through the serving chain:

  ingest: area pool + normalize (CUDA kernel) at an integer pool; else
          a cast to the compute dtype and, below full resolution, a
          bilinear resize
  -> recurrent matting net (s2d-aware edge padding): the planar conv
     kernels for conv_impl="planar", F.conv2d for "xla"
  -> the tail, by the branch the JAX package takes:
     fused packed   integer pool > 1, guided, packed output: GF
                    coefficients (CUDA kernel) and fused refine +
                    composite + RGBA pack (CUDA kernel)
     fused float    the same pool, float output or raw foreground: GF
                    coefficients and fused_refine_float (CUDA kernel)
     unfused        full resolution (no refinement; with
                    ``refine_at_full`` the guided filter at the frame's
                    grid, the GF kernel's coefficients), bilinear upsample
                    (refine "none"), guided refinement at a ratio that
                    is not an integer pool (``guided_upsample``: the GF
                    kernel, bilinear upsample, apply), or tiled guided
                    refinement off the fused tails
                    (``refine.tiling.tiled_guided_upsample``); then one
                    ``finish_float``: float output, packed words through
                    composite_rgba_packed (CUDA kernel), or the uint8
                    tuple (alpha, fgr, rgba) for raw-foreground output

On the planar net the fused packed plan also carries ``chunk_body``,
which runs the stateless stages (ingest, encoder and bottleneck, GF
coefficients, the fused tail) once over a K-frame chunk and only the
recurrent decoder per frame (vidmat/pipeline/stepfactory.py:656-693);
on the card the frames' decoder stage-steps run as a wavefront on side
streams (``pipeline/wavefront.py``).
The fused packed plan carries its two stages too (``fused_stage0``:
ingest, the net and the coefficient grids; ``fused_stage1``: the fused
tail; :500-541): the per-frame body is the one after the other, and the
chunk body ends in stage 1, so the 2-stage pipeline of
``parallel/pp.py`` serves the bytes one device serves.
``static_skip_eps`` gives the fused tails the static-scene fast path
(:608-654); a body built with ``export=True`` takes its branch with
``torch.cond`` (the exported bundle's step, ``deploy.py``).

Backgrounds (:199-204, 320-335, 536-551, 636-641, 687-700): a color or an
(h, w, 3) image baked into the body; a per-call image (``bg_dynamic``, a
video background); or a portrait blur (``bg_blur``), the edge-truncated box
mean of the ingested coarse frame, which the fused packed tail upsamples
inside its kernel (coarse mode) and the other tails upsample with
``resize_bilinear`` and composite as per-frame images. A clean plate
(``bg_plate``, the plate-conditioned family) is ingested once at build
time and appended to the net's input; the guide, the tails, the composite
and the static-skip delta see the frame's channels only (:403-432).

Tiling (``tile_size``, ``tile_overlap``; :251-262, 471-498, 560-567):
the fused tails take the guided-filter statistics per coarse tile, all
tiles as one batch of the GF kernel, and feather-blend the coefficient
grids at the coarse grid (exact: the guided apply is pointwise in (A, b)
and the guide is shared), then run the whole-frame tail once. They stay
fused only where the tile and the overlap are multiples of the pool;
otherwise, and without the kernels, the tail is the unfused
``tiled_guided_upsample``, which raises on a misaligned overlap.

Trimap-conditioned models (``model_cfg.use_trimap``) take (N, h, w, 4)
frames: RGB and the trimap byte ({0, 128, 255}), ingested together; the
guide, the tails and the composite see the RGB only (:348-351, 478-482,
518-545). ``output_seg`` builds the segmentation body instead (:442-459):
ingest, the trunk with the co-trained ``seg_head`` (the state advances as
in the matting pass), a bilinear upsample of the logits and a sigmoid.

Error-map refinement (``refine.mode="errormap"``, :575-581): below full
resolution the error-map refiner (``refine/errormap.py``) refines the
upsampled alpha in its worst patches, or, with no refiner, the bilinear
tail runs; either way through ``finish_float`` (no fused tail).

``use_pallas=False`` takes the branch the JAX package takes without its
kernels: no fused tail, no packed output (the uint8 tuple), every stage
and the net on its plain version (:227-244). The JAX package's
scoped-VMEM fit rule for the fused tails (``refine_tiles_fit``) is a TPU
limit the CUDA kernels do not have: every integer pool > 1 takes a fused
tail.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from vidmat_torch._device import full_fp32, in_full_fp32
from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.models.planar import PlanarNetwork
from vidmat_torch.ops.composite import (composite_rgba,
                                        composite_rgba_packed,
                                        composite_rgba_packed_plain)
from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                 guided_filter_coeffs_plain)
from vidmat_torch.ops.guided_filter import (box_blur, gray_guide,
                                            guided_upsample)
from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                     ingest_pool_normalize_plain)
from vidmat_torch.ops.refine import (Background, fused_refine_composite,
                                     fused_refine_composite_plain,
                                     fused_refine_float,
                                     fused_refine_float_plain)
from vidmat_torch.ops.resize import downsample_ratio_shape, resize_bilinear
from vidmat_torch.pipeline.wavefront import decode_frames
from vidmat_torch.refine.tiling import (TileLayout, tile_frame,
                                        tiled_guided_upsample, untile_frame)


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Static facts about a built serving body that call sites need."""

    net_h: int          # coarse grid fed to the network (pre-s2d-padding)
    net_w: int
    state_h: int        # recurrent-state grid (coarse + s2d padding)
    state_w: int
    pool: int           # integer area-pool factor (0 = non-integer ratio)
    packed: bool        # body returns (N, H, W) uint32 packed RGBA
    alpha_only: bool    # body returns (N, H, W) uint8 alpha (packed >> 24)
    static_skip: bool   # carry is (net_state, coefficient cache); the net
    #                     is skipped on static frames (static_skip_eps)
    full: bool          # network runs at full resolution (no coarse pass)
    # Zero carry for a batch size (None when non-recurrent and no cache).
    make_state: Callable = None
    # chunk_body(frames_u8 (K, h, w, 3), state) -> (out (K, h, w), state):
    # the K frames in one call, stateless stages batched (planar net on
    # the fused packed tail only).
    chunk_body: Optional[Callable] = None
    # The stage split of the fused packed tail (None elsewhere); the
    # one-shot body and chunk_body are composed of these, so the 2-stage
    # pipeline (parallel/pp.py) serves what one device serves:
    #   fused_stage0(frame_u8, state) -> ((ma, mb), new_state), with
    #     bg_blur ((ma, mb, coarse_bg), new_state): ingest, the net and
    #     the coefficient grids (N, net_h, net_w, 4) float32; the coarse
    #     background (N, net_h, net_w, 3) float32
    #   fused_stage1(frame_u8, ma, mb, bgv) -> (N, h, w) uint32 packed
    #     words (the alpha byte is not taken here)
    fused_stage0: Optional[Callable] = None
    fused_stage1: Optional[Callable] = None


def alpha_byte(packed: torch.Tensor) -> torch.Tensor:
    """The alpha byte of packed words, (N, H, W) uint8: the high byte of
    each little-endian word, i.e. ``packed >> 24``."""
    return packed.view(torch.uint8).reshape(*packed.shape, 4)[..., 3]


def _net_device(net: torch.nn.Module) -> torch.device:
    return next(itertools.chain(net.parameters(), net.buffers())).device


def build_serving_body(
    net: torch.nn.Module,
    model_cfg: ModelConfig,
    refine: RefineConfig,
    h: int,
    w: int,
    ratio: float,
    *,
    cdtype: torch.dtype = torch.bfloat16,
    bg: Background = None,
    bg_dynamic: bool = False,
    bg_blur: Optional[int] = None,
    bg_plate=None,
    need_fgr: bool = False,
    alpha_only: bool = False,
    tile_size: Optional[int] = None,
    tile_overlap: int = 64,
    static_skip_eps: Optional[float] = None,
    float_frames: bool = False,
    float_output: bool = False,
    output_seg: bool = False,
    use_pallas: Optional[bool] = None,
    kernels: bool = True,
    refiner: Optional[torch.nn.Module] = None,
    refine_at_full: bool = False,
    export: bool = False,
) -> Tuple[Callable, ServingPlan]:
    """Build the serving body for a static (h, w, ratio) bucket.

    net:      the network (``build_network``: a PlanarNetwork for
              conv_impl="planar", else a MattingNetwork) on the device the
              body runs on, built with compute dtype ``cdtype``.
    bg:       (3,) float background color, (h, w, 3) float image in
              [0, 1] (array or tensor), or None (premultiplied output).
    bg_dynamic: per-call background (a video background): the body takes
              a third argument, an (N, h, w, 3) float32 [0, 1] tensor on
              the device of which it composites over ``bg_frame[0]``;
              single-frame serving (N = 1); no ``chunk_body``; ``bg``
              must be None.
    bg_blur:  portrait blur: composite over the edge-truncated box mean of
              the source frame, radius ``bg_blur`` full-resolution pixels,
              taken on the ingested coarse frame (radius
              ``max(1, round(bg_blur * net_h / h))``). Exclusive with
              ``bg`` and ``bg_dynamic``; ignored with ``float_output``.
    bg_plate: the clean plate of the plate-conditioned family
              (``model_cfg.use_bg_plate``, which requires it): ([N,] h, w,
              3) uint8, or float in [0, 1]. Ingested once here as the
              frames are and appended to the net's input.
    need_fgr: the caller needs the raw foreground: the output is the uint8
              tuple (alpha, fgr, rgba) (the packed word carries composited
              RGB).
    alpha_only: packed paths return the (N, h, w) uint8 alpha byte instead
              of the packed words (a 4x smaller device-to-host copy).
    tile_size, tile_overlap: tiled refinement at full resolution (see
              the module docstring); tile_size None = untiled.
    static_skip_eps: the static-scene fast path of the fused tails (see
              ``PipelineConfig.static_skip_eps``); batch 1 only.
    float_frames: the body takes (N, h, w, 3) float32 frames in [0, 1]
              (the fp32 parity contract of the streaming stepper); no
              fused tail.
    float_output: return (alpha (N, h, w, 1), fgr (N, h, w, 3)) float32,
              no composite, no quantization (the streaming contract).
    output_seg: the segmentation body: returns (mask (N, h, w, 1) float32
              probability, new_state); needs a net holding ``seg_head``.
    use_pallas: None or True: the kernels' branches; False: the JAX
              package's branch without kernels (implies kernels=False).
    kernels:  True (serving): the stages call the kernel wrappers, which
              launch the CUDA kernels on CUDA tensors and run the plain
              versions on CPU tensors. False: the stages (and the planar
              net's convs) call the plain PyTorch versions on any device,
              the reference the kernel path is held against on the card.
    refiner:  the error-map refiner (``refine.errormap.ErrorMapRefiner``
              on the net's device) for refine.mode == "errormap": below
              full resolution the alpha is its patch-refined upsample and
              the foreground the bilinear one (stepfactory.py:575-578);
              None takes the bilinear tail, as in the JAX package. Its
              convolutions run in full float32 in every body.
    refine_at_full: where the network runs at full resolution, guided
              refinement still runs (refine.mode "guided"): edge-aware
              smoothing with the frame as the guide, ``guided_upsample``
              at the frame's own grid (stepfactory.py:582-585).
    export:   the body is to be traced by ``torch.export`` (``deploy.py``):
              the static-skip branch is a ``torch.cond`` on the device
              and the skip count a tensor (the live body takes the branch
              on the host and counts in Python).

    Returns (body, plan) where
      body(frame (N, h, w, C) uint8 (float32 with float_frames), state
           [, bg_frame with bg_dynamic]) -> (out, new_state)
      C is 3, or 4 for a trimap-conditioned model (RGB, then the trimap
      byte, normalized with the RGB)
      out = (N, h, w) uint8 alpha           if plan.alpha_only
          | (N, h, w) uint32 packed RGBA    if plan.packed
                (R | G<<8 | B<<16 | A<<24)
          | (alpha (N, h, w, 1), fgr (N, h, w, 3)) float32  if float_output
          | (alpha_u8 (N, h, w, 1), fgr_u8 (N, h, w, 3), rgba (N, h, w, 4))
    """
    if refine.mode not in ("guided", "none", "errormap"):
        raise ValueError(f"unknown refine mode {refine.mode!r}")
    if bg_dynamic and bg is not None:
        raise ValueError("bg_dynamic takes bg per call; build with bg=None")
    if bg_blur and (bg is not None or bg_dynamic):
        raise ValueError("bg_blur composites over a blur of the source "
                         "frame; it is mutually exclusive with bg / "
                         "bg_dynamic")
    if bg_plate is not None and not model_cfg.use_bg_plate:
        raise ValueError(
            "bg_plate given but the model is not plate-conditioned: build "
            "with ModelConfig(use_bg_plate=True) (shipped plate_demo at "
            "space_to_depth=2), or drop bg_plate")
    if model_cfg.use_bg_plate and bg_plate is None:
        raise ValueError(
            "model_cfg.use_bg_plate=True needs the pre-captured clean "
            "background plate: pass bg_plate=<(h, w, 3) image> (the scene "
            "without the subject)")
    dev = _net_device(net)
    if bg is not None:
        bg_t = torch.as_tensor(bg, dtype=torch.float32)
        if tuple(bg_t.shape) == (3,):
            bg = [float(v) for v in bg_t]
        elif tuple(bg_t.shape) == (h, w, 3):
            bg = bg_t.to(dev).contiguous()
        else:
            raise ValueError(f"bg must be (3,) or ({h}, {w}, 3); got "
                             f"{tuple(bg_t.shape)}")
    if bg_plate is not None:
        bg_plate = torch.as_tensor(bg_plate)
        if bg_plate.dim() == 3:
            bg_plate = bg_plate[None]
        if tuple(bg_plate.shape[-3:]) != (h, w, 3):
            raise ValueError(
                f"bg_plate must be ([N,] {h}, {w}, 3) matching the frame "
                f"bucket; got {tuple(bg_plate.shape)} (resize the plate to "
                "the stream resolution on the host first)")
    net_h, net_w = ((h, w) if ratio >= 1.0
                    else downsample_ratio_shape(h, w, ratio))
    full = (net_h, net_w) == (h, w)
    pool = (h // net_h if (not full and h % net_h == 0 and w % net_w == 0
                           and h // net_h == w // net_w) else 0)

    # The branch the JAX package takes (stepfactory.py:227-278, 317-318,
    # 525): with its kernels, or without them (use_pallas=False).
    pallas = use_pallas is not False
    kernels = kernels and pallas
    use_packed = pallas and not need_fgr and not float_output
    kernel_tail_ok = (pallas and pool > 1 and refine.mode == "guided"
                      and not float_frames)
    use_fused = use_packed and kernel_tail_ok
    use_float_tail = not use_packed and kernel_tail_ok
    # Tiled: per-coarse-tile statistics and the blended coefficient grids
    # feed the whole-frame fused tails where the geometry aligns with the
    # pool (stepfactory.py:259-262, 278).
    if tile_size and kernel_tail_ok:
        geom_ok = tile_size % pool == 0 and tile_overlap % pool == 0
        use_fused = use_fused and geom_ok
        use_float_tail = use_float_tail and geom_ok
    fused_tiled = bool(tile_size) and (use_fused or use_float_tail)
    use_static_skip = (static_skip_eps is not None and not float_frames
                       and (use_fused or use_float_tail))
    use_alpha_only = alpha_only and use_packed
    # Portrait blur (stepfactory.py:320-335): a no-op with float_output,
    # whose contract emits no composite.
    use_bg_blur = bool(bg_blur) and not float_output
    blur_rc = max(1, round(bg_blur * net_h / h)) if use_bg_blur else 0

    # space_to_depth models need the coarse grid padded to 16*s2d.
    mult = 16 * model_cfg.space_to_depth
    pad_nh = -net_h % mult
    pad_nw = -net_w % mult
    state_h, state_w = net_h + pad_nh, net_w + pad_nw

    if kernels:
        ingest, gf_coeffs, packed_tail, float_tail, composite = (
            ingest_pool_normalize, guided_filter_coeffs,
            fused_refine_composite, fused_refine_float,
            composite_rgba_packed)
    else:
        ingest, gf_coeffs, packed_tail, float_tail, composite = (
            ingest_pool_normalize_plain, guided_filter_coeffs_plain,
            fused_refine_composite_plain, fused_refine_float_plain,
            composite_rgba_packed_plain)

    planar = isinstance(net, PlanarNetwork)

    def make_net_state(batch: int):
        if not model_cfg.recurrent:
            return None
        if planar:
            return net.init_state(batch, state_h, state_w)
        from vidmat_torch.models.matting_net import init_state

        return init_state(model_cfg, batch, state_h, state_w, cdtype, dev)

    def make_state(batch: int):
        if not use_static_skip:
            return make_net_state(batch)
        if batch != 1:
            raise ValueError("static_skip_eps is a batch-1 serving feature; "
                             "use the plain body for batched serving")
        # The reference frame starts at +inf: the first frame's delta is
        # +inf and takes the compute branch even on near-black content. It
        # holds the ingested channels (the trimap too: a trimap change
        # forces a recompute).
        ingest_c = 4 if model_cfg.use_trimap else 3
        cache = (torch.full((1, net_h, net_w, ingest_c), float("inf"),
                            dtype=cdtype, device=dev),
                 torch.zeros((1, net_h, net_w, 4), device=dev),   # mean_a
                 torch.zeros((1, net_h, net_w, 4), device=dev),   # mean_b
                 torch.zeros((), dtype=torch.int64, device=dev) if export
                 else 0)                                          # skips
        return make_net_state(1), cache

    seg_kw = {}
    if output_seg:
        seg_kw = {"seg": True} if planar else {"seg_pass": True}

    def net_apply(xp, state):
        if planar:
            return net(xp, state, plain=not kernels, **seg_kw)
        return net(xp, state, **seg_kw)

    def ingest_x(frame):
        """(N, h, w, C) frame -> (N, net_h, net_w, C) coarse frame in the
        compute dtype (stepfactory.py:374-401)."""
        if pool and not float_frames and pallas:
            return ingest(frame, pool=pool, out_dtype=cdtype)
        x = frame.float() if float_frames else frame.float() * (1.0 / 255.0)
        if full:
            return x.to(cdtype)
        if pool:
            # Area pool in float32, then the cast.
            n, _, _, c = x.shape
            return x.reshape(n, net_h, pool, net_w, pool, c).mean(
                (2, 4)).to(cdtype)
        # The cast first, then the resize, in the compute dtype.
        return resize_bilinear(x.to(cdtype), net_h, net_w)

    # The clean plate through the frames' own ingest, once, in the body's
    # frame contract (uint8, or float in [0, 1] with float_frames).
    cond_const = None
    if bg_plate is not None:
        if float_frames:
            plate_in = (bg_plate.float() / 255.0
                        if bg_plate.dtype == torch.uint8
                        else bg_plate.float())
        else:
            plate_in = (bg_plate if bg_plate.dtype == torch.uint8
                        else torch.round(bg_plate.float().clamp(0.0, 1.0)
                                         * 255.0).to(torch.uint8))
        cond_const = ingest_x(plate_in.to(dev).contiguous())

    def bg_from_x(x):
        """The portrait-blur background (N, net_h, net_w, 3) float32: box
        blur of the ingested coarse frame's RGB."""
        return box_blur(x[..., :3].float(), blur_rc)

    def prep_net_input(x):
        """Append the clean plate (if any) to the coarse frame (N, net_h,
        net_w, C) and edge-pad it to the s2d grid at the bottom and
        right."""
        if cond_const is not None:
            cc = cond_const.to(x.dtype)
            if cc.shape[0] == 1 and x.shape[0] != 1:
                cc = cc.expand(x.shape[0], -1, -1, -1)
            x = torch.cat([x, cc], dim=-1)
        if not (pad_nh or pad_nw):
            return x
        xp = F.pad(x.permute(0, 3, 1, 2), (0, pad_nw, 0, pad_nh),
                   mode="replicate")
        return xp.permute(0, 2, 3, 1)

    def net_from_x(x, state):
        alpha, fgr, new_state = net_apply(prep_net_input(x), state)
        return (alpha[:, :net_h, :net_w].float(),
                fgr[:, :net_h, :net_w].float(), new_state)

    if output_seg:
        @torch.inference_mode()
        def seg_body(frame, state):
            """Segmentation: ingest, the trunk with seg_head, the logits
            upsampled bilinearly, a sigmoid (stepfactory.py:446-453)."""
            x = ingest_x(frame)
            logits, _, new_state = net_apply(prep_net_input(x), state)
            logits = logits[:, :net_h, :net_w].float()
            if not full:
                logits = resize_bilinear(logits, h, w)
            return torch.sigmoid(logits), new_state

        if cdtype == torch.float32:
            seg_body = in_full_fp32(seg_body)
        return seg_body, ServingPlan(
            net_h=net_h, net_w=net_w, state_h=state_h, state_w=state_w,
            pool=pool, packed=False, alpha_only=False, static_skip=False,
            full=full, make_state=make_net_state)

    lr_layout = (TileLayout(net_h, net_w, tile_size // pool,
                            tile_overlap // pool) if fused_tiled else None)

    def coeffs(x, alpha, fgr, guide=None):
        """Guided-filter coefficient grids at the coarse grid for the
        fused tails; the guide comes from the ingested coarse frame's RGB
        (or is given). Tiled: the statistics per coarse tile, all tiles
        as one batch, and the coefficient grids feather-blended
        (stepfactory.py: 471-498)."""
        if guide is None:
            guide = gray_guide(x[..., :3].float())
        p = torch.cat([alpha, fgr], dim=-1)
        if lr_layout is None:
            return gf_coeffs(guide, p, refine.guided_radius,
                             refine.guided_eps)
        ma, mb = gf_coeffs(tile_frame(guide, lr_layout),
                           tile_frame(p, lr_layout), refine.guided_radius,
                           refine.guided_eps)
        return (untile_frame(ma, lr_layout, x.shape[0]),
                untile_frame(mb, lr_layout, x.shape[0]))

    def stage0(frame_u8, state):
        """Ingest, the net and the coefficient grids, with bg_blur the
        coarse background too (stepfactory.py:527-532)."""
        x = ingest_x(frame_u8)
        alpha, fgr, new_state = net_from_x(x, state)
        ma, mb = coeffs(x, alpha, fgr)
        if use_bg_blur:
            return (ma, mb, bg_from_x(x)), new_state
        return (ma, mb), new_state

    def stage1(frame_u8, ma, mb, bgv):
        """The fused refine + composite + pack on the frame's RGB; a
        coarse background (bg_blur) is upsampled in the kernel."""
        return packed_tail(frame_u8[..., :3], ma, mb, bgv, pool)

    def fused_out(frame_u8, ma, mb, bgv):
        out = stage1(frame_u8, ma, mb, bgv)
        return alpha_byte(out) if use_alpha_only else out

    def finish_float(alpha, fgr, bgv):
        """Output packaging once full-resolution float alpha and fgr
        exist (stepfactory.py:588-606)."""
        if float_output:
            return alpha, fgr
        if use_packed:
            out = composite(fgr, alpha, bgv)
            return alpha_byte(out) if use_alpha_only else out
        rgba = composite_rgba(fgr, alpha, bgv)
        alpha_u8 = torch.round(alpha * 255.0).to(torch.uint8)
        fgr_u8 = torch.round(fgr * 255.0).to(torch.uint8)
        return alpha_u8, fgr_u8, rgba

    def rgb_full(frame):
        """The frame's RGB as float in [0, 1]."""
        return (frame[..., :3].float() if float_frames
                else frame[..., :3].float() * (1.0 / 255.0))

    @torch.inference_mode()
    def body_impl(frame, state, bgv):
        if use_fused:
            # The two stages; with bg_blur the coarse background is a
            # stage-0 product, upsampled inside the refine kernel (coarse
            # mode).
            grids, new_state = stage0(frame, state)
            if use_bg_blur:
                ma, mb, bgv = grids
            else:
                ma, mb = grids
            return fused_out(frame, ma, mb, bgv), new_state
        x = ingest_x(frame)
        alpha, fgr, new_state = net_from_x(x, state)
        if use_bg_blur:
            bgv = resize_bilinear(bg_from_x(x), h, w)
        if use_float_tail:
            alpha, fgr = float_tail(frame[..., :3], *coeffs(x, alpha, fgr),
                                    pool)
        elif not full and refine.mode == "guided":
            rgb = rgb_full(frame)
            if tile_size and pool:
                # Tiled full-resolution refinement off the fused tails
                # (stepfactory.py:560-569).
                alpha, fgr = tiled_guided_upsample(
                    rgb, alpha, fgr, tile_size, tile_overlap,
                    refine.guided_radius, refine.guided_eps,
                    kernels=kernels)
            else:
                alpha, fgr = guided_upsample(rgb, alpha, fgr,
                                             refine.guided_radius,
                                             refine.guided_eps,
                                             kernels=kernels)
        elif not full and refine.mode == "errormap" and refiner is not None:
            # The refiner sees the ingested coarse RGB in float32 and the
            # full-resolution frame in [0, 1] (stepfactory.py:575-578).
            with full_fp32():
                alpha, _ = refiner(rgb_full(frame), x[..., :3].float(),
                                   alpha)
            fgr = resize_bilinear(fgr, h, w)
        elif not full:
            alpha = resize_bilinear(alpha, h, w)
            fgr = resize_bilinear(fgr, h, w)
        elif refine_at_full and refine.mode == "guided":
            alpha, fgr = guided_upsample(rgb_full(frame), alpha, fgr,
                                         refine.guided_radius,
                                         refine.guided_eps, kernels=kernels)
        return finish_float(alpha, fgr, bgv), new_state

    def static_out(frame_u8, x, ma, mb, bgv):
        """The tail of a static-skip step: on the current frame, from the
        cached (or new) coefficients."""
        if use_bg_blur:
            # The blur of the current frame, not of the coefficients'
            # reference: the tail always runs on the current frame.
            bgv = (bg_from_x(x) if use_fused
                   else resize_bilinear(bg_from_x(x), h, w))
        if use_fused:
            return fused_out(frame_u8, ma, mb, bgv)
        return finish_float(*float_tail(frame_u8[..., :3], ma, mb, pool),
                            bgv)

    @torch.inference_mode()
    def body_static(frame_u8, state, bgv):
        """The net and the coefficients run only when the coarse frame
        changed against the frame the cached coefficients came from
        (stepfactory.py:608-654). The branch is taken on the host: one
        scalar read back per frame."""
        net_state, (ref_x, ma, mb, skips) = state
        x = ingest_x(frame_u8)
        delta = (x.float() - ref_x.float()).abs().mean()
        changed = bool(delta > static_skip_eps)
        if changed:
            alpha, fgr, net_state = net_from_x(x, net_state)
            ma, mb = coeffs(x, alpha, fgr)
            ref_x = x
        else:
            skips += 1
        return static_out(frame_u8, x, ma, mb, bgv), (
            net_state, (ref_x, ma, mb, skips))

    @torch.inference_mode()
    def body_static_cond(frame_u8, state, bgv):
        """``body_static`` with the branch taken on the device
        (``torch.cond``), for ``torch.export``: the two branches return
        new tensors of the same shapes (flat: the tracer checks the
        strides of its branches' outputs symbolically and refuses those
        of dense 4-d tensors), the net's state flattened."""
        net_state, (ref_x, ma, mb, skips) = state
        x = ingest_x(frame_u8)
        delta = (x.float() - ref_x.float()).abs().mean()
        leaves, spec = tree_flatten(net_state)
        shapes = [t.shape for t in (ref_x, ma, mb, skips, *leaves)]
        # The guide outside the branch: a branch holds no constant of its
        # own (gray_guide's weights).
        guide = gray_guide(x[..., :3].float())

        def flat(*ts):
            return tuple(t.reshape(-1).clone() for t in ts)

        def compute(x, guide, ref_x, ma, mb, skips, *leaves):
            alpha, fgr, ns = net_from_x(x, tree_unflatten(list(leaves),
                                                          spec))
            return flat(x, *coeffs(x, alpha, fgr, guide), skips,
                        *tree_flatten(ns)[0])

        def skip(x, guide, ref_x, ma, mb, skips, *leaves):
            return flat(ref_x, ma, mb, skips + 1, *leaves)

        ref_x, ma, mb, skips, *leaves = (
            t.reshape(shape) for t, shape in zip(torch.cond(
                delta > static_skip_eps, compute, skip,
                (x, guide, ref_x, ma, mb, skips, *leaves)), shapes))
        return static_out(frame_u8, x, ma, mb, bgv), (
            tree_unflatten(leaves, spec), (ref_x, ma, mb, skips))

    chunk_body = None
    if use_fused and planar and not use_static_skip and not bg_dynamic:
        # Stage 0 over the chunk with its stateless parts batched (ingest,
        # encoder, the coefficients; the decoder per frame, as a wavefront
        # of stage-steps on the card), then stage 1 once
        # (stepfactory.py:578-591).
        @torch.inference_mode()
        def chunk_body(frames_u8: torch.Tensor, state):
            x = ingest_x(frames_u8)
            enc = net.encode(prep_net_input(x), plain=not kernels)
            alphas, fgrs, state, overlapped = decode_frames(
                net, enc, state, plain=not kernels)
            # The name binds the plan's callable (the float32 wrapper where
            # there is one), which carries the count.
            chunk_body.overlapped_steps += overlapped
            ma, mb = coeffs(x, torch.cat(alphas)[:, :net_h, :net_w],
                            torch.cat(fgrs)[:, :net_h, :net_w])
            return fused_out(frames_u8, ma, mb,
                             bg_from_x(x) if use_bg_blur else bg), state

    impl = (body_impl if not use_static_skip
            else body_static_cond if export else body_static)
    fused_stage0 = fused_stage1 = None
    if use_fused:
        fused_stage0 = torch.inference_mode()(stage0)
        fused_stage1 = torch.inference_mode()(stage1)
    if cdtype == torch.float32:
        # fp32 serving and the session's parity mode: no TF32 convolutions
        # on the card (the JAX package pins float32).
        impl = in_full_fp32(impl)
        if chunk_body is not None:
            chunk_body = in_full_fp32(chunk_body)
        if use_fused:
            fused_stage0 = in_full_fp32(fused_stage0)
            fused_stage1 = in_full_fp32(fused_stage1)
    if chunk_body is not None:
        # Stage-steps issued on a side stream (pipeline/wavefront.py): 4 a
        # frame on the card, 0 on the CPU; ChunkGraph adds a replay's.
        chunk_body.overlapped_steps = 0
    if bg_dynamic:
        def body(frame, state, bg_frame):
            # bg_frame: (N, h, w, 3) float32 in [0, 1]; the tails take one
            # (h, w, 3) image (single-frame serving).
            return impl(frame, state, bg_frame[0])
    else:
        def body(frame, state):
            return impl(frame, state, bg)

    plan = ServingPlan(net_h=net_h, net_w=net_w, state_h=state_h,
                       state_w=state_w, pool=pool, packed=use_packed,
                       alpha_only=use_alpha_only,
                       static_skip=use_static_skip, full=full,
                       make_state=make_state, chunk_body=chunk_body,
                       fused_stage0=fused_stage0, fused_stage1=fused_stage1)
    return body, plan
