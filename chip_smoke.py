#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vidmat_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. build every CUDA kernel from vidmat_torch/csrc (one nvcc per source,
     in parallel); print the card's name and power limit as nvidia-smi
     reports them
  2. each kernel against its plain PyTorch version on the card, at the
     shapes and on the inputs the 1080p main path gives it (ingest
     bit-exact, guided-filter coefficients bit-exact in one launch with no
     scratch, refine/composite bytes within +-1; ingest and the packed
     tail at one frame and at the 4-frame chunk; the planar kernels at
     their 9 call sites, and planar_gru at the 3 sites of the unfused
     network, within 1-2 bf16 units in the last place of the plain twin
     summing in the kernels' fixed order (sequential=True; float32 planes
     against the cuDNN twin), see close(), with the count of values
     unequal to that twin and cuDNN's distance logged per site;
     fused_refine_float max |d| <= 1e-5 at 1088x1920 pool 4 (the strip
     body), at pools 2 and 8 and on a ragged last strip, and its
     per-pixel body (a frame one byte off alignment) equal to the strip
     body; composite_rgba_packed bit-exact in its four modes at 480x864,
     at 1088x1920 on 1 and 2 frames and on a ragged 37x53, and its
     scalar path (buffers one element off alignment) equal to its 16-byte
     groups; fused_refine_composite's image and coarse modes bytes
     within +-1 at 1088x1920, on 4-frame batches with a shared and a
     per-frame image, the count of refine bytes unequal to the plain twin
     logged per case; int8_conv within 1 int8 unit, fewer than 1e-3 of its
     values unequal to the plain twin (the count logged per case), at
     8x16x144x240, on a ragged 37x53 and 20x72 (W not a multiple of 16)
     and on 2x16x144x240 one byte off alignment: the scalar staging
     path), plus ragged shapes per kernel (the planar ones at the plate
     family's 24 input channels too); then the same at the multistream
     round's launch shapes, N = 8 streams of 1088x1920: ingest and GF
     bit-exact, the planar kernels at the per-frame body's 9 sites over
     the batch (the decoder on a carry that is not zero) with 0 bf16
     values unequal to the sequential order, the packed tail over a
     color and in coarse mode within 1 byte, the float tail within 1e-5
  3. the serving chunk body (ingest, planar encoder, per-frame decoder,
     guided-filter coefficients, fused tail) at 1920x1088 on fast_demo in
     bf16, kernel path against the same body on the plain versions, over
     8 recurrent frames (alpha bytes: mean |d| <= 0.5 LSB, max <= 2); then
     the fp32 body on the card against the CPU at 128x192
  4. the main path: convert_video on 64 synthetic 1920x1080 frames on the
     planar preset (chunk 4: the first chunk through the eager chunk
     body, then one CUDA graph launch per chunk); launch counts are set to
     0 just before and read just after (planar_conv 32, planar_conv2 112,
     planar_conv_gru 192, ingest / GF / refine 16 each: the graph's
     replays count the launches they make); alpha MAD against the
     fixture's ground truth held within 5e-3 of the JAX package's MAD on
     the same clip; every alpha byte equal to the eager chunk body's on
     the same frames. Then the conv_impl="xla" path on 16 frames (its
     three kernels launch, the planar ones do not; no chunk body: four
     per-frame bodies a chunk, one graph)
  5. the unfused planar network (fuse_pairs=False: planar_conv pairs,
     planar_conv + planar_gru stages) at 1080p over 4 frames against the
     fused one; planar_gru launches
  S. MattingSession(1088, 1920) on the video_1080p model in bf16 (ingest,
     planar net, GF coefficients, fused_refine_float per frame; the
     steps after the first replay a captured step): 16 frames against
     the same session on the plain versions (alpha and fgr mean |d| <=
     2e-3, max <= 8e-3), launch counts (per replay), the per-frame host
     split into pinned H2D, replay and D2H (.cpu(), and beside it reused
     pinned buffers plus a host copy); the captured step against an
     eager session across a reset and a load_state (0 values unequal,
     returned arrays untouched); static skip on 4 identical frames (3
     skips, the net once, bit-identical outputs, no graph);
     convert_video with output_foreground on 8 preset frames (the float
     tail, not the fused packed one)
  C. convert_video on clip_480p (synthetic_demo at full resolution through
     the planar kernels, composite_rgba_packed) over 100 synthetic 480x864
     frames: launch counts, fps, alpha MAD within 1e-4 of the JAX
     package's on the same clip; the planar kernels against their plain
     versions at this net's 9 call sites (s2d=1, the rgb plane at d0 +
     head), and the run's alpha bytes against the same frames through the
     serving body on the plain versions (worst-frame mean |d| <= 0.5 LSB,
     max <= 2). Then the JAX package's defaults (ModelConfig(),
     PipelineConfig(): auto ratio, unfused guided tail) on 16 frames at
     1080p: GF and composite_rgba_packed launch, the ingest and fused
     tails do not; the GF kernel against plain on the coarse grid this
     path gives it, and the alpha bytes against the plain body as above
  Graph paths (phases 4, S, C, B, K, A, E): every path without a chunk
     body runs K per-frame bodies a chunk as one CUDA graph (static skip
     excepted); each run is held to the same run through the eager
     bodies (0 output bytes unequal), its graph replayed on every full
     chunk after the first, its launches per replay times the chunks
     equal to the run's launches; capture ms and fps are logged per path
     and written to graphs.json in the output directory
  B. backgrounds and the plate family through convert_video on 1920x1080
     frames: (a) bg_image, (b) bg_video (3 backgrounds cycled, the
     per-frame bodies, staged 4 deep; the H2D share of its float32
     backgrounds), (c)
     bg_blur=16 on the video_1080p preset (chunk 4; fused_refine_composite
     in image mode once per chunk for (a), per frame for (b), in coarse
     mode once per chunk for (c)); (d) bg_blur with output_foreground
     (fused_refine_float) and on the JAX defaults (composite_rgba_packed
     over per-frame images); (e) plate_demo on the planar net over the
     camouflage clean-plate clip (alpha MAD within min(a third, 5e-3) of
     the JAX package's; the planar kernels at its 9 sites against plain);
     (f) a bare bg_plate (the F.conv2d family). Each: launch counts, fps,
     output bytes against the plain body (worst-frame mean |d| <= 0.5
     LSB, max <= 2)
  Q. the int8 planes probe (vidmat_torch/tools/bench_int8_planes.py):
     bf16-planes (planar_conv) and int8-planes (int8_conv) ms per
     layer-batch beside their bytes bounds; after phase 6, the int8 leg's
     ratio to the bf16 leg and to phase 6's cuDNN bf16 conv
  6. each kernel timed with CUDA events at the main-path shapes (L2
     flushed before every launch, the card kept busy while the host
     enqueues it), beside its bound, its plain version's
     time and, for the planar kernels and int8_conv, cuDNN's F.conv2d for
     the same convs (a yardstick the port never calls); ingest, GF and the
     packed tail (its three modes) at one frame and at the 4-frame chunk
     the main path launches them on (the kernels line carries the launch
     shape); a floor line (an empty kernel launch, and a device-to-device
     copy_ moving the bytes of the packed tail's and ingest's chunk, of
     the float tail's 1088x1920 frame, of composite's 480x864 and
     1088x1920 frames and of int8_conv's 8x16x144x240 layer-batch: what
     this harness reads for no work and for pure
     streaming), each of those rows with its ratio to its copy; for the
     tensor-core planar
     kernels also the tile edge, block count and shared memory each
     site's launch chose; then the rows at the multistream round's
     shapes (N = 8: ingest, GF, the packed tail over a color and in
     coarse mode, the float tail, the planar kernels at their 9 sites)
  7. where a frame's time goes on the planar chunk body: host time per
     stage (pad and stage, H2D, replay enqueue, D2H wait) for the graph
     with the pipeline's staging, twice; the body's wall time, eager and
     replayed; device time by kernel group, by kernel (the body's six:
     ingest, GF, refine and the three tensor-core planar kernels, each
     required) and by kernel file (torch.profiler); checks that the planar
     body launches no library convolution or GEMM and that the port
     kernels the device ran in 4 replays equal the wrappers' booked
     launches; fps of convert_video on 64 frames, twice; the device's busy
     share under VideoPipeline.run (profiler device time over the run's
     wall time)
  I. matte_image at 512x512 (preset_pr1_image) for the base, trimap and
     plate families and a mask, card against CPU (MAD <= 1e-4) under
     PyTorch's default flags, ms per image; the fp32 repair (the session's
     parity mode card against CPU, max |d| <= 1e-4, with TF32 left
     allowed logged beside it)
  K. video_4k (ratio 0.125, tiles of 1024 with an overlap of 128, chunk
     1): phase 2's checks of ingest, GF (15 coarse tiles in one launch)
     and the packed tail at the launch shapes of 3840x2176 frames (pool
     8); convert_video on the 3840x2160 crops of 16 synthetic frames (no
     integer pool: GF and composite_rgba_packed, untiled, as in the JAX
     package) and on the 3840x2176 frames (the tiled fused tail): fps and
     set-up, launches per frame (2 / 4 / 3 / 1 / 1 / 1 for planar_conv /
     planar_conv2 / planar_conv_gru / ingest / GF / refine at 2176),
     bytes against the plain body (worst-frame mean |d| <= 0.5 LSB, max
     <= 2), at 2176 the tiled alpha against the untiled fused tail (on a
     noise frame max <= 3, mean < 0.05 LSB, JAX's own case; on the clip
     logged), the per-stage host times (pad, H2D, enqueue or replay, D2H
     wait) of the eager body and of its graph, the tiled run's peak
     device memory, and device time by kernel; the bf16
     MattingSession(2176, 3840) tiled against its plain twin (alpha and
     fgr mean |d| <= 2e-3, max <= 8e-3)
  A. trimap video and segmentation on 1920x1080 frames: trimap_prop_demo
     through the planar net on the video_1080p pipeline from a keyframe
     trimap and from a keyframe mask (4-channel ingest, the chunk graph),
     the same checkpoint as F.conv2d with per-frame trimaps, and
     output_segmentation with seg_demo through the planar net: launches,
     fps, bytes against the plain body (mean <= 0.5 LSB, max <= 2)
  E. convert_video with preset_video_1080p_errormap on 16 frames of the
     1920x1088 hard clip (synthetic_demo through the planar net, the
     error-map refiner, composite_rgba_packed): launches, fps, the graph;
     alpha MAD within 5e-3 of the JAX package's
     (tests/torch_reference_mad.py errormap_1080p); unknown-band MAD
     below the guided tail's on the same model; per frame the kernel
     path against the plain body (on frames whose 256 patch selections
     agree worst-frame mean <= 0.5 LSB, max <= 2; where they differ, the
     plain grid's K-th minus (K+1)-th score beside the error maps'
     difference); the refiner in full float32 under PyTorch's default
     flags (card against CPU, max |d| <= 1e-4, TF32 logged); the
     refiner's device time (profiler) and its stages
  M. MultiStreamMatting on the multistream preset: 8 streams of
     1088x1920 (fast_demo, ratio 0.25, bf16, chunk 1), one graph replay a
     round: (a) bg_color (the packed fused tail), 16 rounds: aggregate
     and per-stream fps, each stage of a round waited (pad into the
     pinned slot, H2D, replay enqueue, replay, D2H wait, unpack), capture
     ms, launches per replay; (b) no background (the float tail), 8
     rounds; (c) chunk 4 against chunk 1 with resets planted mid-chunk
     (0 bytes unequal); (d) reset isolation (streams not reset equal the
     run without resets, 0 bytes unequal; a reset stream a fresh
     one-stream instance, within 1); (e) serve on 8 sources of 24 frames
     (10 for two): frames delivered per stream, the summary, the bytes
     of (a)'s rounds; (f) bg_blur=16, trimap_demo on 4-channel frames and
     plate_demo with a plate per stream, 4 rounds each. Each path: its
     graph against its eager bodies (0 bytes unequal), streams against a
     one-stream instance (max 1), the plain twin in the kernels' order
     (worst stream-frame mean <= 0.5 LSB, max <= 2), launches (counts set
     to 0 just before) equal to the replay's per round
  R. RealtimeMatting(1080, 1920) on the video_1080p model at ratio 0.25,
     bf16: a lockstep source (none dropped) against a VideoStepper with
     the same finish (0 bytes unequal), launches; an unpaced 64-frame
     source and one paced at 30 fps (0 dropped): produced, processed,
     dropped, p50 / p99 ms
  P. serving over several mesh positions, each position a CUDA stream of
     the one card: (a) make_mesh over the visible cards and over two
     positions of cuda:0; (b) MultiStreamMatting on the multistream
     preset (8 x 1088x1920) split over two positions, 16 rounds: bytes
     within 1 of the one-position instance, graphs equal to the eager
     bodies, launches per position, aggregate fps host-fed and on a
     device-resident ring beside one position's; (c) PipelinedMatting
     (1088, 1920) on video_1080p: step / flush and convert at chunk 1 and
     4 within 1 of a one-stream instance, the one-frame skew, launches
     per stage position, t_stage0 / t_stage1 / the composed body and the
     pipelined rate (vidmat_torch/tools/bench_pp_stages.py); (d)
     PipelinedStreams(2) on four positions over a color and with
     bg_blur=16 (coarse-mode launches); (e) the CLI's multistream --pp on
     one card exits naming the cards it needs; the kernels against plain
     at the positions' launch shapes (4 streams, 1 frame)
  D. AOT serving bundles (vidmat_torch/deploy.py, torch.export with the
     kernels as vidmat_torch:: custom ops): video_1080p exported on the
     card with chunk 4, each program's vidmat_torch:: node counts (the
     six main-path kernels at the live chunk graph's launches per replay,
     no aten convolution); the bundle loaded in a fresh process by the
     loader alone (no module of the model definition imported) and its
     convert over 64 synthetic 1920x1080 frames against convert_video on
     the same frames (0 alpha and composite bytes unequal, launches per
     replay equal); export s, load ms, fps beside convert_video's; then
     bg_blur=16, alpha_only, need_fgr, num_streams=8, video_4k tiled,
     video_1080p_errormap, seg and static skip, a step or two each
     against the live body (0 bytes unequal); a CPU bundle refused
  L. python -m vidmat_torch.cli export and bench --quick as subprocesses;
     VideoEval on the card over 16 1080p frames against its CPU run
     (relative |d| <= 1e-5, Grad 1e-4), ms per frame
  T. bench_torch.py's 1080p, 480p, e2e, 4k, 4k_tiled and multistream
     records
  G. training (vidmat_torch/train) on the fast_demo recipe's model
     (video_1080p: s2d=2): one float32 train step at 64x64, T=2, N=2
     with the Laplacian and boundary terms, card against CPU (per-leaf
     gradients |dg|/|g| <= 1e-4, loss and terms 1e-5 relative, running
     statistics 1e-5), no hand-written kernel launched over the step;
     remat on and off (statistics equal, gradients within 1e-5); 50 steps of the recipe on one 128x128 batch
     (T=4, N=2), the loss falling; six train_on_clips steps interleaving
     segmentation every third; ``python -m vidmat_torch.cli train``
     writing an .npz that convert_video serves; step ms, clips/s and
     peak memory at 64, 128, 256 (T=4, N=2) and 512 px (T=4, N=4), the
     device's busy share of a step at 128 and 512 px
  U. A.16 on the card: make_chunk_step (fast_demo, F.conv2d, 1088x1920,
     K=4, float32) equal to four network calls and within 1e-4 of the
     CPU; the full-resolution guided_filter at 1x1088x1920 (3-channel
     src) within 1e-5 of the CPU, its ms; the 34 subpackage exports;
     every shipped .npz through models.load_checkpoint with its
     template; tools/eval_errormap at 1088x1920 (2 frames, one seed)
     card against CPU (MADs 1e-4, Grad 1e-4 relative); no hand-written
     kernel launched over them. Then build_serving_body(refine_at_full=
     True) on clip_480p's model at 480x864 (bf16, guided, packed words)
     over 10 frames: GF (gf_coeffs.cu) and composite_rgba_packed once a
     frame, as the captured 10-frame chunk replays them; bytes against
     the plain body (worst-frame mean |d| <= 0.5 LSB, max <= 2); the
     graph's bytes equal to the eager body's; output unequal to
     refine_at_full=False's; GF at this launch shape within 1e-4 of its
     plain twin and composite_rgba_packed bit-exact, and GF's cold-L2 ms
     beside its bytes bound and plain ms (the kernels line's
     "guided_filter_coeffs (full res)" row); tiled_apply card vs CPU
  H. sharded training (``mesh=``) on the fast_demo model at 512x512,
     T=4, N=4, positions repeating the card: the step on ('data',) (4),
     ('spatial',) (4) and ('data', 'spatial') (2, 2) against the
     unsharded step (loss and terms 2e-5 relative, running statistics
     1e-5, gradients per leaf within the larger of 1e-4 and the
     unsharded step's own spread between cuDNN and the native
     convolution, no hand-written kernel launched),
     the seg step on (2, 2), three train_on_clips steps (losses 1e-4
     relative); the median ms of 5 steps and peak memory, sharded beside
     unsharded; then two processes on the card (gloo, CUDA tensors through
     the host) on ('spatial',) (2) (one position a process) and
     ('spatial', 'data') (2, 2) (each group across both), held against
     the one-process step on the same mesh shape at the same bars, both
     processes' results equal, their step ms beside the one-process
     step's

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Details (profile, per-site times,
compiler reports) go to chiprun_out/chip_smoke/. Exits nonzero without a
CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 (non-tensor) peak and
# dense bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

FRAME_H, FRAME_W = 1080, 1920   # source frames
H, W = 1088, 1920               # /16 bucket the pipeline pads to
RATIO = 0.25                    # -> pool 4, 272x480 coarse grid
N_FRAMES = 64
# Alpha MAD of the JAX package on the same 64-frame clip and configuration
# (tests/torch_reference_mad.py, CPU): the port's MAD is held to it.
JAX_REFERENCE_MAD = 0.08868
# The same for clip_480p: 100 synthetic 480x864 frames (seed 0),
# synthetic_demo at full resolution (tests/torch_reference_mad.py
# clip_480p, CPU).
CLIP_H, CLIP_W, CLIP_FRAMES = 480, 864, 100
JAX_REFERENCE_MAD_480P = 0.00030
# The port's MAD on that clip is held within this of the JAX package's: a
# third of the quantity, so a wrong kernel cannot hide in it.
CLIP_MAD_TOL = 1e-4
SESSION_FRAMES = 16
CHUNK = 4
IMAGE_SIZE = 512  # the preset_pr1_image rung
# The planar kernels' call sites on the main path, in call order: the
# encoder per 4-frame chunk, the decoder and full-res stage per frame.
SITES = [("stem", "conv"), ("s2", "conv2"), ("s3", "conv2"), ("s4", "conv2"),
         ("proj", "conv"), ("d3", "conv_gru"), ("d2", "conv_gru"),
         ("d1", "conv_gru"), ("d0_head", "conv2")]
# planar_gru's sites: the decoder stages of the unfused network.
GRU_SITES = [("d3_gru", "gru"), ("d2_gru", "gru"), ("d1_gru", "gru")]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_build():
    from vidmat_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[1] built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(paths):
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"    ptxas {name}: {line.strip()}")


@functools.lru_cache(maxsize=4)
def _clip(n, seed):
    from concurrent.futures import ThreadPoolExecutor

    from vidmat_torch.io.fixtures import synthetic_frame

    with ThreadPoolExecutor(4) as ex:
        pairs = list(ex.map(lambda i: synthetic_frame(
            FRAME_H, FRAME_W, i / max(n, 1), seed), range(n)))
    return tuple(f for f, _ in pairs), tuple(a[..., 0] for _, a in pairs)


def clip(n, seed=0):
    """n synthetic source frames and their ground-truth alphas (the
    frames of ``synthetic_clip``, made on 4 host threads: numpy releases
    the GIL; the last few clips are kept, phases 4 and D share one)."""
    frames, alphas = _clip(n, seed)
    return list(frames), list(alphas)


def padded_clip(n, seed=0):
    """(n, H, W, 3) uint8: synthetic frames edge-padded to the bucket."""
    import numpy as np

    from vidmat_torch.io.reader import pad_frame

    return np.concatenate([pad_frame(f, H, W) for f in clip(n, seed)[0]])


def main_path_inputs(net, frame_u8, state_hw):
    """Ingest / net / guide tensors for one main-path frame, by the plain
    versions (the kernels' inputs, independent of the kernels)."""
    import torch
    import torch.nn.functional as F

    from vidmat_torch.ops.gf import guided_filter_coeffs_plain
    from vidmat_torch.ops.guided_filter import gray_guide
    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain

    pool = 4
    x = ingest_pool_normalize_plain(frame_u8, pool=pool)
    nh, nw = x.shape[1:3]
    sh, sw = state_hw
    xp = F.pad(x.permute(0, 3, 1, 2), (0, sw - nw, 0, sh - nh),
               mode="replicate").permute(0, 2, 3, 1)
    with torch.inference_mode():
        alpha, fgr, _ = net(xp, net.init_state(1, sh, sw), plain=True)
    guide = gray_guide(x.float())
    p = torch.cat([alpha[:, :nh, :nw], fgr[:, :nh, :nw]], -1).float()
    ma, mb = guided_filter_coeffs_plain(guide, p)
    return guide.contiguous(), p.contiguous(), ma, mb


def gf_one_launch(guide, p, *args):
    """guided_filter_coeffs(guide, p, *args), checking that the call
    launches its kernel once and allocates nothing beside its two
    outputs (no scratch grid): its peak growth is at most what allocating
    two tensors like its outputs takes (the caching allocator rounds
    large blocks up)."""
    import torch

    from vidmat_torch.ops.gf import guided_filter_coeffs

    torch.cuda.synchronize()
    before, mem = guided_filter_coeffs.launches, torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ka, kb = guided_filter_coeffs(guide, p, *args)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - mem
    assert guided_filter_coeffs.launches == before + 1
    mem = torch.cuda.memory_allocated()
    like = (torch.empty_like(ka), torch.empty_like(kb))
    outputs = torch.cuda.memory_allocated() - mem
    del like
    assert grew <= outputs + 1024, (grew, outputs, nbytes(ka, kb))
    return ka, kb


def phase_kernels(net, net_unfused, dev):
    """Each kernel against its plain version at the main-path shapes: one
    frame, and ingest and the packed tail also at the 4-frame chunk the
    main path launches them on."""
    import torch

    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
    from vidmat_torch.ops.guided_filter import gray_guide
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    frame = torch.from_numpy(padded_clip(1, seed=11)).to(dev)
    errs = {}

    got = ingest_pool_normalize(frame, pool=4)
    want = ingest_pool_normalize_plain(frame, pool=4)
    torch.cuda.synchronize()
    errs["ingest_pool_normalize"] = float(
        (got.float() - want.float()).abs().max())
    assert torch.equal(got, want), "ingest: not bit-exact"

    mult = 16 * net.cfg.space_to_depth
    nh, nw = H // 4, W // 4
    guide, p, _, _ = main_path_inputs(
        net, frame, (nh + (-nh) % mult, nw + (-nw) % mult))
    ka, kb = gf_one_launch(guide, p)
    pa, pb = guided_filter_coeffs_plain(guide, p)
    torch.cuda.synchronize()
    errs["guided_filter_coeffs"] = float(max((ka - pa).abs().max(),
                                             (kb - pb).abs().max()))
    assert torch.equal(ka, pa) and torch.equal(kb, pb), errs

    ma, mb = pa, pb
    for bg in (None, (0.0, 1.0, 0.0)):
        k = fused_refine_composite(frame, ma, mb, bg, 4)
        q = fused_refine_composite_plain(frame, ma, mb, bg, 4)
        d = (k.view(torch.uint8).int() - q.view(torch.uint8).int()).abs()
        errs["fused_refine_composite"] = max(
            errs.get("fused_refine_composite", 0.0), float(d.max()))
        log(f"    refine bg={bg}: bytes mean |d| {float(d.float().mean()):.3g}"
            f" max {int(d.max())}, {int((d > 0).sum())} of {d.numel()} "
            "bytes unequal to the plain twin")
    assert errs["fused_refine_composite"] <= 1, errs

    # The main path's launch shape: one 4-frame chunk, whose frames (and so
    # whose coefficient grids, filtered with each frame's own guide) differ.
    chunk = torch.from_numpy(padded_clip(CHUNK, seed=11)).to(dev)
    x4 = ingest_pool_normalize(chunk, pool=4)
    want4 = ingest_pool_normalize_plain(chunk, pool=4)
    torch.cuda.synchronize()
    assert torch.equal(x4, want4), "ingest: not bit-exact on the chunk"
    ma4, mb4 = guided_filter_coeffs_plain(
        gray_guide(want4.float()).contiguous(),
        p.expand(CHUNK, -1, -1, -1).contiguous())
    assert not torch.equal(ma4[0], ma4[-1])
    for bg in (None, (0.0, 1.0, 0.0)):
        k = fused_refine_composite(chunk, ma4, mb4, bg, 4)
        q = fused_refine_composite_plain(chunk, ma4, mb4, bg, 4)
        d = (k.view(torch.uint8).int() - q.view(torch.uint8).int()).abs()
        errs["fused_refine_composite"] = max(
            errs["fused_refine_composite"], float(d.max()))
        log(f"    refine bg={bg} {CHUNK} frames: bytes mean |d| "
            f"{float(d.float().mean()):.3g} max {int(d.max())}, "
            f"{int((d > 0).sum())} of {d.numel()} bytes unequal to the "
            "plain twin")
    assert errs["fused_refine_composite"] <= 1, errs
    log(f"    ingest bit-exact to plain at 1 frame and at the {CHUNK}-frame "
        "chunk")

    # Ragged shapes: edge tiles, 4-channel ingest, f32 ingest output.
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (2, 100, 152, 4), generator=g,
                        dtype=torch.uint8).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(ingest_pool_normalize(img, 2, out_dtype=dt),
                           ingest_pool_normalize_plain(img, 2, out_dtype=dt))
    gi = torch.rand((2, 37, 53, 1), generator=g).to(dev)
    pi = torch.rand((2, 37, 53, 4), generator=g).to(dev)
    for r in (2, 4, 8):
        ka, kb = gf_one_launch(gi, pi, r, 1e-3)
        pa, pb = guided_filter_coeffs_plain(gi, pi, r, 1e-3)
        assert torch.equal(ka, pa) and torch.equal(kb, pb), r
    log("    guided_filter_coeffs bit-exact to plain at the main-path grid "
        "and at 2x37x53 (r 2, 4, 8), one launch and no scratch per call")
    fr = torch.randint(0, 256, (2, 36, 300, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    a = (torch.rand((2, 9, 75, 4), generator=g) * 2 - 0.5).to(dev)
    b = (torch.rand((2, 9, 75, 4), generator=g) - 0.5).to(dev)
    d = (fused_refine_composite(fr, a, b, (0.3, 0.2, 0.1), 4).view(
        torch.uint8).int() - fused_refine_composite_plain(
        fr, a, b, (0.3, 0.2, 0.1), 4).view(torch.uint8).int()).abs()
    log(f"    refine ragged 2x36x300: max |d| {int(d.max())}, "
        f"{int((d > 0).sum())} of {d.numel()} bytes unequal to the plain "
        "twin")
    assert int(d.max()) <= 1, int(d.max())
    torch.cuda.synchronize()
    sites = capture_sites(net, net_unfused, coarse_input(net, chunk))
    errs.update(planar_kernel_checks(sites, dev))
    log(f"[2] kernels vs plain on the card: {json.dumps(errs)} "
        "(ragged shapes agree too)")
    return errs, (frame, guide, p, ma, mb), sites


COMPOSITE_MODES = ("color", "none", "image", "per_frame")


def composite_bg(mode, n, h, w, g, dev):
    """The background of one composite_rgba_packed mode."""
    import torch

    if mode == "color":
        return (0.2, 0.9, 0.4)
    if mode == "none":
        return None
    shape = (h, w, 3) if mode == "image" else (n, h, w, 3)
    return torch.rand(shape, generator=g).to(dev)


def offset_copy(t, offset=1):
    """t's values in a buffer ``offset`` elements past an aligned start:
    the kernels' bodies for misaligned inputs (the float tail's per-pixel
    body, composite's scalar path)."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def phase_tail_kernels(inputs, dev):
    """fused_refine_float and composite_rgba_packed against their plain
    versions. The float tail on the main-path frame and coefficient grids
    (1088x1920, pool 4: the warp-strip body), on random grids at pool 4
    with a ragged last strip (36x300, 1 and 2 frames), at pools 2 and 8,
    and on the pool-4 inputs from a frame one byte off alignment (the
    per-pixel body), whose output must equal the strip body's. Composite
    in all four modes at 480x864 (random mattes, alpha partly outside
    [0, 1]), at 1088x1920 on 1 and 2 frames (the float tail's output), on
    a ragged 37x53 (a scalar tail, groups straddling frames) and from
    buffers one element off alignment (the scalar path), whose bytes must
    equal the aligned call's. Returns {kernel name: max |d|}."""
    import torch

    from vidmat_torch.ops.composite import (composite_rgba_packed,
                                            composite_rgba_packed_plain)
    from vidmat_torch.ops.refine import (fused_refine_float,
                                         fused_refine_float_plain)

    frame, _, _, ma, mb = inputs
    g = torch.Generator().manual_seed(12)

    def refine_err(fr, a, b, pool):
        ka, kf = fused_refine_float(fr, a, b, pool)
        pa, pf = fused_refine_float_plain(fr, a, b, pool)
        assert ka.shape == pa.shape and kf.shape == pf.shape
        assert bool(torch.isfinite(ka).all() and torch.isfinite(kf).all())
        return float(max((ka - pa).abs().max(), (kf - pf).abs().max())), \
            (ka, kf)

    err_path, (alpha, fgr) = refine_err(frame, ma, mb, 4)
    errs = {"main path 1088x1920 pool 4": err_path}
    for label, n, h, w, pool in (("ragged 36x300 pool 4", 2, 36, 300, 4),
                                 ("1 frame 36x300 pool 4", 1, 36, 300, 4),
                                 ("pool 2 36x52", 2, 36, 52, 2),
                                 ("pool 8 64x296", 2, 64, 296, 8)):
        fr = torch.randint(0, 256, (n, h, w, 3), generator=g,
                           dtype=torch.uint8).to(dev)
        hl, wl = h // pool, w // pool
        a = (torch.rand((n, hl, wl, 4), generator=g) * 2 - 0.5).to(dev)
        b = (torch.rand((n, hl, wl, 4), generator=g) - 0.5).to(dev)
        errs[label], strip = refine_err(fr, a, b, pool)
        if label.startswith("ragged"):
            # The per-pixel body on the same values equals the strip's.
            errs["per-pixel body"], pixel = refine_err(offset_copy(fr), a,
                                                       b, pool)
            assert all(torch.equal(s, p) for s, p in zip(strip, pixel))
    log("    fused_refine_float max |d| to plain: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + "; the per-pixel body equals the strip body")
    errs = {"fused_refine_float": max(errs.values())}
    assert errs["fused_refine_float"] <= 1e-5, errs

    def mattes(n, h, w):
        return (torch.rand((n, h, w, 3), generator=g).to(dev),
                (torch.rand((n, h, w, 1), generator=g) * 1.2 - 0.1).to(dev))

    cases = [("480x864", *mattes(2, CLIP_H, CLIP_W)),
             ("1 frame 1088x1920", fgr, alpha),
             ("2 frames 1088x1920", fgr.expand(2, -1, -1, -1).contiguous(),
              alpha.expand(2, -1, -1, -1).contiguous()),
             ("ragged 37x53", *mattes(2, 37, 53))]
    worst = 0
    for label, f, al in cases:
        n, h, w, _ = f.shape
        for mode in COMPOSITE_MODES:
            bg = composite_bg(mode, n, h, w, g, dev)
            k = composite_rgba_packed(f, al, bg)
            p = composite_rgba_packed_plain(f, al, bg)
            assert k.shape == (n, h, w) and k.dtype == torch.uint32
            d = int((k.view(torch.uint8).int()
                     - p.view(torch.uint8).int()).abs().max())
            worst = max(worst, d)
            assert d == 0, (label, mode, d)
            if label.startswith("ragged"):
                bg_o = bg if bg is None or isinstance(bg, tuple) else \
                    offset_copy(bg)
                assert torch.equal(k, composite_rgba_packed(
                    offset_copy(f), offset_copy(al), bg_o)), mode
    torch.cuda.synchronize()
    errs["composite_rgba_packed"] = float(worst)
    log(f"    composite_rgba_packed bit-exact in modes {COMPOSITE_MODES} at "
        f"{', '.join(c[0] for c in cases)}, and from misaligned buffers "
        "(the scalar path)")
    return errs, (alpha, fgr)


def phase_bg_kernels(inputs, dev):
    """fused_refine_composite's image and coarse modes and int8_conv
    against their plain versions: the modes on the main-path frame and
    coefficient grids (1088x1920, pool 4; the coarse background is the
    portrait blur of the ingested frame), an image shared by a 4-frame
    batch and one image per frame, and a ragged shape; int8_conv at the
    probe's 8x16x144x240, two shapes whose W is not a multiple of 16 and
    an input one byte off alignment. Returns ({row name: max |d|}, the
    timing inputs)."""
    import torch

    from vidmat_torch.ops.guided_filter import box_blur
    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain
    from vidmat_torch.ops.int8_planar import int8_conv, int8_conv_plain
    from vidmat_torch.ops.planar import pack_conv_weight
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    frame, _, _, ma, mb = inputs
    g = torch.Generator().manual_seed(13)
    image = torch.rand((H, W, 3), generator=g).to(dev)
    coarse = box_blur(ingest_pool_normalize_plain(frame, 4).float(), 4)
    chunk = torch.from_numpy(padded_clip(CHUNK, seed=12)).to(dev)
    ma4 = ma.expand(CHUNK, -1, -1, -1).contiguous()
    mb4 = mb.expand(CHUNK, -1, -1, -1).contiguous()
    fr = torch.randint(0, 256, (2, 36, 300, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    ra = (torch.rand((2, 9, 75, 4), generator=g) * 2 - 0.5).to(dev)
    rb = (torch.rand((2, 9, 75, 4), generator=g) - 0.5).to(dev)
    cases = [
        ("image", "1088x1920", frame, ma, mb, image),
        ("coarse", "1088x1920", frame, ma, mb, coarse),
        ("image", "shared by 4 frames", chunk, ma4, mb4, image),
        ("per_frame", "4 frames", chunk, ma4, mb4,
         torch.rand((CHUNK, H, W, 3), generator=g).to(dev)),
        ("image", "ragged 36x300", fr, ra, rb,
         (torch.rand((36, 300, 3), generator=g) * 1.2 - 0.1).to(dev)),
        ("coarse", "ragged 36x300", fr, ra, rb,
         (torch.rand((2, 9, 75, 3), generator=g) * 1.2 - 0.1).to(dev)),
    ]
    errs = {}
    for mode, label, f, a, b, bg in cases:
        k = fused_refine_composite(f, a, b, bg, 4)
        q = fused_refine_composite_plain(f, a, b, bg, 4)
        d = (k.view(torch.uint8).int() - q.view(torch.uint8).int()).abs()
        row = ("fused_refine_composite (coarse)" if mode == "coarse"
               else "fused_refine_composite (image)")
        errs[row] = max(errs.get(row, 0.0), float(d.max()))
        log(f"    refine {mode} {label}: bytes mean |d| "
            f"{float(d.float().mean()):.3g} max {int(d.max())}, "
            f"{int((d > 0).sum())} of {d.numel()} bytes unequal to the "
            "plain twin")
    assert max(errs.values()) <= 1, errs

    w8 = (torch.randn((16, 16, 3, 3), generator=g) * 0.2).to(
        dev, torch.bfloat16)
    w8p = pack_conv_weight(w8)

    def int8_input(shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    x8 = int8_input((8, 16, 144, 240))
    worst = 0
    for label, x in (("8x16x144x240", x8),
                     ("ragged 1x16x37x53", int8_input((1, 16, 37, 53))),
                     ("ragged 2x16x20x72", int8_input((2, 16, 20, 72))),
                     ("2x16x144x240 one byte off alignment",
                      offset_copy(int8_input((2, 16, 144, 240))))):
        d = (int8_conv(x, w8, packed=w8p).int()
             - int8_conv_plain(x, w8).int()).abs()
        worst = max(worst, int(d.max()))
        unequal = int((d > 0).sum())
        log(f"    int8_conv {label}: max |d| {int(d.max())} int8 unit, "
            f"{unequal} of {d.numel()} values unequal to the plain twin")
        assert unequal < 1e-3 * d.numel(), (label, unequal)
    assert worst <= 1, worst
    errs["int8_conv"] = float(worst)
    torch.cuda.synchronize()
    log(f"[2] background modes and int8_conv vs plain: {json.dumps(errs)}")
    return errs, (image, coarse, x8, w8, w8p)


def planar_ops():
    """op key -> (kernel wrapper, plain version)."""
    from vidmat_torch.ops import planar as P

    return {"conv": (P.planar_conv, P.planar_conv_plain),
            "conv2": (P.planar_conv2, P.planar_conv2_plain),
            "conv_gru": (P.planar_conv_gru, P.planar_conv_gru_plain),
            "gru": (P.planar_gru, P.planar_gru_plain)}


def close(got, want, ulps):
    """max |d| of a planar kernel's output against its plain version, after
    checking |d| <= ulps * 2^-7 * |want| + 2^-10 * max |want| in bf16 (the
    two sum the same float32 products in another order; a fused kernel
    rounds an intermediate too), 1e-5 * |want| + 1e-6 * max |want| in
    float32 (as tests/test_torch_cuda.py)."""
    import torch

    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if want.dtype == torch.bfloat16:
        tol = ulps * 2.0 ** -7 * w.abs() + 2.0 ** -10 * top
    else:
        tol = 1e-5 * w.abs() + 1e-6 * top
    d = (g - w).abs()
    assert bool(torch.isfinite(g).all()), "non-finite kernel output"
    assert bool((d <= tol).all()), (float(d.max()), top,
                                    int((d > tol).sum()))
    return float(d.max())


def coarse_input(net, chunk_u8):
    """The main path's network input for a chunk of padded frames: the
    plain ingest at pool 4, edge-padded to the s2d grid."""
    import torch.nn.functional as F

    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain

    x = ingest_pool_normalize_plain(chunk_u8, pool=4)
    mult = 16 * net.cfg.space_to_depth
    nh, nw = x.shape[1:3]
    return F.pad(x.permute(0, 3, 1, 2), (0, -nw % mult, 0, -nh % mult),
                 mode="replicate").permute(0, 2, 3, 1)


@contextlib.contextmanager
def recording_planar(calls):
    """Within: every planar call the networks make through their plain
    versions is appended to ``calls`` as (op key, args)."""
    import vidmat_torch.models.planar as pm

    saved = dict(pm._PLAIN)

    def recorder(key, fn):
        def rec(*args):
            calls.append((key, args))
            return fn(*args)
        return rec

    for key, fn in saved.items():
        pm._PLAIN[key] = recorder(key, fn)
    try:
        yield
    finally:
        pm._PLAIN.update(saved)


@contextlib.contextmanager
def sequential_twins():
    """Within: the planar plain versions sum in the kernels' fixed order
    (``sequential=True``, their oracle in phase 2)."""
    import vidmat_torch.models.planar as pm

    saved = dict(pm._PLAIN)
    pm._PLAIN.update({k: functools.partial(fn, sequential=True)
                      for k, fn in saved.items()})
    try:
        yield
    finally:
        pm._PLAIN.update(saved)


def capture_sites(net, net_unfused, xp, batch_decode=False):
    """The arguments of every planar call the network input ``xp`` (a
    chunk of frames, s2d-padded) gives: the encoder over the chunk, the
    decoder on its first frame and, unless ``net_unfused`` is None, the
    unfused network's planar_gru calls, recorded through the plain
    versions. ``batch_decode``: the decoder over the whole batch (the
    multistream round's per-frame body), on the carry one decode of the
    same batch left (a hidden state that is not zero), of any decoder
    (planar_conv stages without recurrence). Returns {site: (op key,
    args)}."""
    import torch

    calls = []
    with torch.inference_mode(), recording_planar(calls):
        enc = net.encode(xp, plain=True)
        st = net.init_state(xp.shape[0] if batch_decode else 1,
                            *xp.shape[1:3])
        if batch_decode:
            n = len(calls)
            _, _, st = net.decode(enc, st, plain=True)
            del calls[n:]
        net.decode(enc if batch_decode else enc.frame(0), st, plain=True)
        fused = list(calls)
        calls.clear()
        if net_unfused is not None:
            enc = net_unfused.encode(xp, plain=True)
            net_unfused.decode(enc.frame(0), st, plain=True)
    # A non-recurrent decoder (trimap_demo) calls planar_conv at d3..d1.
    assert len(fused) == len(SITES) and (batch_decode or [
        k for k, _ in fused] == [k for _, k in SITES]), fused
    gru = [c for c in calls if c[0] == "gru"]
    assert len(gru) == (0 if net_unfused is None else len(GRU_SITES))
    return {name: call for (name, _), call in zip(SITES + GRU_SITES,
                                                  fused + gru)}


def check_planar(key, args):
    """One planar kernel call against its plain version: bf16 planes
    against the sequential-order twin (``sequential=True``, the order the
    bf16 kernels reproduce), float32 ones against the cuDNN twin, each
    within close()'s bars. Returns (max |d|, values unequal to the
    sequential twin, max |d| to the cuDNN twin), the last two for bf16
    only (else None)."""
    import torch

    ulps = {"conv": 1, "conv2": 2, "conv_gru": 2, "gru": 1}
    kern, plain = planar_ops()[key]
    got = kern(*args)
    bf16 = got[0].dtype == torch.bfloat16 if key == "conv_gru" \
        else got.dtype == torch.bfloat16
    want = plain(*args, sequential=bf16)
    if key != "conv_gru":
        got, want = (got,), (want,)
    e = max(close(a, b, ulps[key]) for a, b in zip(got, want))
    if not bf16:
        return e, None, None
    unequal = sum(int((a != b).sum()) for a, b in zip(got, want))
    lib = plain(*args)
    lib = (lib,) if key != "conv_gru" else lib
    return e, unequal, max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(got, lib))


def planar_kernel_checks(sites, dev, ragged=True):
    """Each planar kernel against its plain version at its call sites and
    (with ``ragged``) on ragged shapes (check_planar); returns {kernel
    name: max |d|}. Logs per site the values unequal to the sequential
    twin (expected 0) and, as information, the cuDNN twin's max |d|."""
    import torch

    ops = planar_ops()
    errs = {}
    for site, (key, args) in sites.items():
        kern = ops[key][0]
        e, unequal, lib = check_planar(key, args)
        errs[kern.__name__] = max(errs.get(kern.__name__, 0.0), e)
        x0 = args[0] if key == "gru" else args[0][0]
        if unequal is None:
            log(f"    {site:8s} {kern.__name__:16s} {tuple(x0.shape)} "
                f"max |d| {e:.3g} vs the cuDNN twin (float32)")
            continue
        log(f"    {site:8s} {kern.__name__:16s} {tuple(x0.shape)} "
            f"max |d| {e:.3g} vs the sequential twin, {unequal} values "
            f"unequal; cuDNN twin max |d| {lib:.3g}")
    if not ragged:
        torch.cuda.synchronize()
        return errs

    # Ragged shapes (tile edges cut the image), both plane dtypes, batch 2.
    g = torch.Generator().manual_seed(7)

    def rnd(*shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dt)

    def aff(c):
        return ((torch.rand(c, generator=g) + 0.5).to(dev),
                (torch.randn(c, generator=g) * 0.1).to(dev))

    ragged_unequal = {}
    for dt in (torch.bfloat16, torch.float32):
        xs = [rnd(2, 5, 13, 21, dt=dt), rnd(2, 3, 13, 21, dt=dt)]
        w1 = rnd(6, 8, 3, 3, dt=dt, scale=72 ** -0.5)
        w2 = rnd(4, 6, 3, 3, dt=dt, scale=54 ** -0.5)
        h = rnd(2, 3, 13, 21, dt=dt, scale=0.5)
        wg = rnd(6, 6, 3, 3, dt=dt, scale=54 ** -0.5)
        wc = rnd(3, 6, 3, 3, dt=dt, scale=54 ** -0.5)
        (s1, b1), (s2, b2), (_, bg), (_, bc) = aff(6), aff(4), aff(6), aff(3)
        # The plate family's widths: a 24-channel stem, and d0 + head over
        # three inputs (a, h1, the 24-channel cond).
        x24 = rnd(2, 24, 13, 21, dt=dt)
        w24 = rnd(16, 24, 3, 3, dt=dt, scale=216 ** -0.5)
        xs3 = [rnd(2, 12, 13, 21, dt=dt), rnd(2, 12, 13, 21, dt=dt), x24]
        w48 = rnd(16, 48, 3, 3, dt=dt, scale=432 ** -0.5)
        w16 = rnd(16, 16, 3, 3, dt=dt, scale=144 ** -0.5)
        (s16, b16) = aff(16)
        cases = [("conv", ([x24], w24, s16, b16, 2, "relu")),
                 ("conv2", (xs3, w48, s16, b16, w16, s16, b16, 1, "relu",
                            "none")),
                 ("conv", (xs, w1, s1, b1, 2, "relu")),
                 ("conv", (xs, w1, s1, b1, 1, "none")),
                 ("conv2", (xs, w1, s1, b1, w2, s2, b2, 2, "relu", "none")),
                 ("conv2", (xs, w1, s1, b1, w2, s2, b2, 1, "relu", "relu")),
                 ("conv_gru", (xs, w1, s1, b1, h, wg, bg, wc, bc)),
                 ("gru", (h.clone(), h, wg, bg, wc, bc))]
        for key, args in cases:
            _, unequal, _ = check_planar(key, args)
            if unequal is not None:
                ragged_unequal[key] = ragged_unequal.get(key, 0) + unequal
    torch.cuda.synchronize()
    log(f"    ragged bf16 cases, values unequal to the sequential twin: "
        f"{ragged_unequal}")
    return errs


def phase_body(net, dev):
    """Serving chunk body on the kernels against the chunk body on the
    plain versions, 8 recurrent frames at 1088x1920, bf16."""
    import numpy as np
    import torch

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    mcfg, pcfg = preset_video_1080p()
    _, plan = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO)
    _, plan_p = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO,
                                   kernels=False)
    assert plan.pool == 4 and plan.chunk_body is not None, plan
    padded = padded_clip(2 * CHUNK, seed=2)
    sk, sp = plan.make_state(1), plan_p.make_state(1)
    worst_mean = worst_max = 0.0
    for c in range(2):
        f = torch.from_numpy(padded[c * CHUNK:(c + 1) * CHUNK]).to(dev)
        ok_, sk = plan.chunk_body(f, sk)
        op_, sp = plan_p.chunk_body(f, sp)
        for i in range(CHUNK):
            ak = ok_[i].view(torch.uint8).reshape(H, W, 4)[..., 3].int()
            ap = op_[i].view(torch.uint8).reshape(H, W, 4)[..., 3].int()
            d = (ak - ap).abs().float()
            worst_mean = max(worst_mean, float(d.mean()))
            worst_max = max(worst_max, float(d.max()))
    torch.cuda.synchronize()
    log(f"[3] serving chunk body kernels vs plain, 8 frames: alpha bytes "
        f"worst-frame mean |d| {worst_mean:.4g}, max {worst_max:.0f}")
    assert worst_mean <= 0.5 and worst_max <= 2, (worst_mean, worst_max)

    # The card against the CPU on a small input, fp32: the CPU body is the
    # one the tests hold to the JAX package
    # (tests/test_torch_planar_serving.py).
    from vidmat_torch.io.fixtures import synthetic_frames_only
    from vidmat_torch.models.weights import build_network, default_variables

    variables = default_variables(mcfg)
    frames = np.stack(list(synthetic_frames_only(128, 192, 2 * CHUNK,
                                                 seed=3)))
    outs = {}
    for d in (dev, torch.device("cpu")):
        net32 = build_network(mcfg, variables, device=d)
        _, plan32 = build_serving_body(net32, mcfg, pcfg.refine, 128, 192,
                                       RATIO, cdtype=torch.float32)
        st = plan32.make_state(1)
        outs[d.type] = []
        for c in range(2):
            f = torch.from_numpy(frames[c * CHUNK:(c + 1) * CHUNK]).to(d)
            o, st = plan32.chunk_body(f, st)
            outs[d.type].append(o.cpu().view(torch.uint8).int())
    d = (torch.cat(outs["cuda"]) - torch.cat(outs["cpu"])).abs().float()
    log(f"    fp32 128x192 card vs CPU, 8 frames: packed bytes mean |d| "
        f"{float(d.mean()):.4g}, max {float(d.max()):.0f}")
    assert float(d.mean()) <= 0.26 and float(d.max()) <= 2
    return {"alpha_mean_abs_lsb": worst_mean, "alpha_max_abs_lsb": worst_max}


# Launches on the main path: 64 frames = 16 chunks of 4; per chunk one
# ingest, stem, proj, three encoder pairs, GF and tail; per frame three
# decoder stages and d0 + head.
MAIN_PATH_LAUNCHES = {
    "ingest_pool_normalize": 16, "guided_filter_coeffs": 16,
    "fused_refine_composite": 16, "planar_conv": 32, "planar_conv2": 112,
    "planar_conv_gru": 192, "planar_gru": 0}


def eager_chunk_alphas(net, frames):
    """Alpha bytes of the eager chunk body (alpha-only, the main path's
    plan) over ``frames`` (a multiple of 4) on the card, cropped to the
    source frame: what the graph's replays are held to."""
    import numpy as np
    import torch

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.io.reader import pad_frame
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    mcfg, pcfg = preset_video_1080p()
    _, plan = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO,
                                 alpha_only=True)
    st = plan.make_state(1)
    outs = []
    for c in range(0, len(frames), CHUNK):
        x = torch.from_numpy(np.concatenate(
            [pad_frame(f, H, W) for f in frames[c:c + CHUNK]])).to(
                torch.device("cuda"))
        o, st = plan.chunk_body(x, st)
        outs.append(o[:, :FRAME_H, :FRAME_W].cpu().numpy())
    return np.concatenate(outs)


def phase_main_path(kernels, net):
    """convert_video on 64 synthetic 1920x1080 frames: the main path
    (planar preset, chunk 4: the first chunk eager, then one CUDA graph
    launch per chunk); every alpha byte against the eager chunk body's;
    then the conv_impl="xla" path on 16."""
    import numpy as np
    import torch

    from vidmat_torch import convert_video, preset_video_1080p
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.utils.metrics import mad

    frames, gt = clip(N_FRAMES, seed=0)
    preset = dict(zip(("model_cfg", "pipe_cfg"), preset_video_1080p()))
    convert_video(frames[:8], output_alpha=lambda a: None,
                  **preset)  # warm-up
    alphas = []
    zero_counts(kernels)
    m = convert_video(frames, output_alpha=alphas.append, **preset)
    launches = counts(kernels)
    bench = convert_video(frames, **preset)  # packed words D2H
    assert m["frames"] == N_FRAMES and len(alphas) == N_FRAMES, m
    assert alphas[0].shape == (FRAME_H, FRAME_W)
    assert m["graph_capture_ms"] > 0, m
    alpha_mad = float(np.mean([mad(a.astype(np.float32) / 255.0, g)
                               for a, g in zip(alphas, gt)]))
    eager = eager_chunk_alphas(net, frames)
    unequal = int((np.stack(alphas) != eager).sum())
    log(f"[4] convert_video {N_FRAMES}x{FRAME_W}x{FRAME_H} alpha-only, "
        f"planar preset (graph replays): fps {m['fps']:.2f}, p50 "
        f"{m['p50_ms']:.3f} ms ({m.get('latency_granularity', 'per-frame')})"
        f", set-up {m['setup_ms']:.1f} ms of which graph capture "
        f"{m['graph_capture_ms']:.1f} ms (both in the first observation, "
        f"so in fps), alpha MAD vs ground truth {alpha_mad:.5f} (JAX reference "
        f"{JAX_REFERENCE_MAD}); launches {launches}; alpha bytes unequal "
        f"to the eager chunk body's: {unequal} of {eager.size}")
    log(f"    benchmark mode (packed RGBA D2H): fps {bench['fps']:.2f}, "
        f"p50 {bench['p50_ms']:.3f} ms")
    assert launches == dict(MAIN_PATH_LAUNCHES, fused_refine_float=0,
                            composite_rgba_packed=0, int8_conv=0), launches
    assert abs(alpha_mad - JAX_REFERENCE_MAD) <= 5e-3, alpha_mad
    assert unequal == 0, unequal
    per = m["graph_launches_per_replay"]
    assert m["graph_replays"] == N_FRAMES // CHUNK - 1, m
    assert {k: v * (N_FRAMES // CHUNK) for k, v in per.items()} == {
        k: v for k, v in launches.items() if v}, (per, launches)
    GRAPHS["4: main path (chunk body)"] = dict(
        per_replay=per, capture_ms=m["graph_capture_ms"], fps=m["fps"],
        frames=N_FRAMES, chunk=CHUNK, unequal=unequal,
        capture_cost=capture_cost(net, torch.device("cuda")))

    # Slice 1's configuration: the net as F.conv2d, the three other
    # kernels still on the path.
    # No chunk body: four per-frame bodies a chunk, one graph.
    xla = ModelConfig(space_to_depth=2, conv_impl="xla")
    preset["model_cfg"] = xla
    convert_video(frames[:4], output_alpha=lambda a: None, **preset)
    zero_counts(kernels)
    xouts = []
    mx = convert_video(frames[:16], output_alpha=xouts.append, **preset)
    xla_launches = counts(kernels)
    log(f"    conv_impl='xla', 16 frames: fps {mx['fps']:.2f}; launches "
        f"{xla_launches}")
    graph_check("4: conv_impl='xla' (per-frame bodies)", mx, xla_launches,
                xouts, lambda sink: convert_video(
                    frames[:16], output_alpha=sink, **preset), CHUNK)
    assert xla_launches == dict(
        ingest_pool_normalize=16, guided_filter_coeffs=16,
        fused_refine_composite=16, planar_conv=0, planar_conv2=0,
        planar_conv_gru=0, planar_gru=0, fused_refine_float=0,
        composite_rgba_packed=0, int8_conv=0), xla_launches
    return m, bench, launches, alpha_mad


def capture_cost(net, dev, rounds=3):
    """Why a capture takes what it takes: the main path's chunk body
    captured ``rounds`` times each way, alternating, as ``ChunkGraph``
    captures (the caching allocators left as they are) and after emptying
    the device and pinned-host caches as ``torch.cuda.graph`` does on
    entry; the capture's ms, and the ms of the pinned input chunks a new
    bucket then allocates (2 x 25 MB). Returns {way: (capture ms, pinned
    allocation ms) lists}."""
    import torch

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.pipeline.graph import ChunkGraph
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.video import Uploads

    mcfg, pcfg = preset_video_1080p()
    _, plan = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO,
                                 alpha_only=True)
    xin = torch.zeros((CHUNK, H, W, 3), dtype=torch.uint8, device=dev)
    _, st = plan.chunk_body(xin, plan.make_state(1))  # warm-up
    up = Uploads((CHUNK, H, W, 3), torch.uint8, dev)
    res = {"kept": ([], []), "emptied": ([], [])}
    for _ in range(rounds):
        for way in res:
            del up  # its pinned chunks go back to the host cache
            torch.cuda.synchronize()
            if way == "emptied":
                torch.cuda.empty_cache()
                host_empty = getattr(torch._C, "_host_emptyCache", None)
                if host_empty is not None:  # not in every release
                    host_empty()
            t0 = time.perf_counter()
            ChunkGraph(plan.chunk_body, xin, st)
            t1 = time.perf_counter()
            up = Uploads((CHUNK, H, W, 3), torch.uint8, dev)
            t2 = time.perf_counter()
            res[way][0].append((t1 - t0) * 1e3)
            res[way][1].append((t2 - t1) * 1e3)
    log("    capture cost, the main path's chunk body: " + "; ".join(
        f"{way}: capture {', '.join(f'{v:.1f}' for v in c)} ms, then a "
        f"bucket's pinned chunks {', '.join(f'{v:.1f}' for v in a)} ms"
        for way, (c, a) in res.items()))
    return res


def phase_unfused(net, net_unfused, dev):
    """The unfused planar network (fuse_pairs=False) against the fused one
    at 1080p over 4 recurrent frames, bf16: the same math with the same
    casts, so the outputs agree to float32 rounding."""
    import torch
    import torch.nn.functional as F

    from vidmat_torch.ops.ingest import ingest_pool_normalize
    from vidmat_torch.ops.planar import planar_gru

    x = ingest_pool_normalize(
        torch.from_numpy(padded_clip(CHUNK, seed=5)).to(dev), pool=4)
    mult = 16 * net.cfg.space_to_depth
    nh, nw = x.shape[1:3]
    xp = F.pad(x.permute(0, 3, 1, 2), (0, -nw % mult, 0, -nh % mult),
               mode="replicate").permute(0, 2, 3, 1)
    sf = net.init_state(1, *xp.shape[1:3])
    su = net_unfused.init_state(1, *xp.shape[1:3])
    worst = 0.0
    planar_gru.launches = 0
    with torch.inference_mode():
        for i in range(CHUNK):
            af, ff, sf = net(xp[i:i + 1], sf)
            au, fu, su = net_unfused(xp[i:i + 1], su)
            worst = max(worst, float((af - au).abs().max()),
                        float((ff - fu).abs().max()))
    launches = planar_gru.launches
    torch.cuda.synchronize()
    log(f"[5] unfused planar net vs fused, 4 frames at 1080p: alpha/fgr "
        f"max |d| {worst:.3g}; planar_gru launches {launches}")
    assert launches == 3 * CHUNK, launches
    assert worst <= 1e-6, worst
    return launches


def counts(kernels):
    return {fn.__name__: fn.launches for fn in kernels}


def zero_counts(kernels):
    for fn in kernels:
        fn.launches = 0
        for mode in getattr(fn, "mode_launches", {}):
            fn.mode_launches[mode] = 0


class eager_bodies:
    """Within: every pipeline chunk and session step through the eager
    bodies (no CUDA graph), the reference the graphs are held to."""

    def __enter__(self):
        from vidmat_torch.pipeline.stepper import VideoStepper
        from vidmat_torch.pipeline.video import VideoPipeline

        self.classes = (VideoPipeline, VideoStepper)
        for c in self.classes:
            c.capture = False

    def __exit__(self, *exc):
        for c in self.classes:
            c.capture = True


# Each graph path's numbers (launches per replay, capture ms, fps, bytes
# unequal to the eager bodies), written to graphs.json in OUT_DIR.
GRAPHS = {}


def graph_check(label, m, launches, outs, rerun, k, setup=None):
    """Hold a convert_video run that replayed a CUDA graph per full chunk to
    the eager bodies: ``rerun(sink)`` repeats the same call with every
    chunk eager, and every output byte of ``outs`` must equal its own.
    Checks that every full chunk after the first (the warm-up) replayed
    the graph, and that the run's launches ``launches`` are the graph's
    launches per replay once per chunk (the frame count a multiple of the
    chunk ``k``; the eager warm-up launches as a replay does; ``setup``:
    launches the bucket's build makes once, e.g. the plate's ingest).
    Logs launches per replay, the capture ms, and fps: of the run, of the
    eager rerun and of a second graph run after it (those two with the
    pinned buffers of the runs before them cached: the comparable
    pair)."""
    import numpy as np

    eager = []
    with eager_bodies():
        me = rerun(lambda a: eager.append(np.array(a)))
    m2 = rerun(lambda a: None)
    n = m["frames"]
    assert len(eager) == len(outs) == n and n % k == 0, (len(eager), n, k)
    assert "graph_launches_per_replay" not in me, me
    unequal = sum(int((np.asarray(a) != b).sum()) for a, b in zip(outs,
                                                                   eager))
    total = sum(int(np.asarray(a).size) for a in outs)
    per = m["graph_launches_per_replay"]
    want = {name: per.get(name, 0) * (n // k) + (setup or {}).get(name, 0)
            for name in launches}
    log(f"    {label}: graph replays {m['graph_replays']} of {n // k} "
        f"chunks, launches per replay {per}, capture "
        f"{m['graph_capture_ms']:.1f} ms, fps {m['fps']:.2f}; then eager "
        f"{me['fps']:.2f}, graph again {m2['fps']:.2f} (capture "
        f"{m2['graph_capture_ms']:.1f} ms); output bytes unequal to the "
        f"eager bodies' {unequal} of {total}")
    assert m["graph_replays"] == n // k - 1, m
    assert launches == want, (label, launches, want)
    assert unequal == 0, (label, unequal)
    GRAPHS[label] = dict(per_replay=per, capture_ms=m["graph_capture_ms"],
                         fps=m["fps"], eager_fps=me["fps"],
                         graph_fps=m2["fps"],
                         capture_ms2=m2["graph_capture_ms"], frames=n,
                         chunk=k, unequal=unequal)
    return GRAPHS[label]


# Per frame of the planar net: stem and proj, three encoder pairs and
# d0 + head, three decoder stages.
PLANAR_PER_FRAME = {"planar_conv": 2, "planar_conv2": 4,
                    "planar_conv_gru": 3, "planar_gru": 0}


def expect(kernels, per_frame, frames):
    """Launch counts of ``frames`` frames of a per-frame path that
    launches ``per_frame`` (kernel name -> launches per frame; others 0)."""
    return {fn.__name__: frames * per_frame.get(fn.__name__, 0)
            for fn in kernels}


def step_split(stepper, frames):
    """Per-frame host ms of the stages of ``VideoStepper.step`` on its
    captured step, each waited for: "h2d" (the frame into the pinned slot
    and to the device), "replay" (the graph) and "d2h" (alpha and fgr back
    with ``.cpu()``, as ``step`` does), over ``frames`` from a fresh
    carry; and "d2h_pinned", the alternative: the same copies into reused
    pinned buffers, then a host copy the caller would own."""
    import numpy as np
    import torch

    t = {"h2d": 0.0, "replay": 0.0, "d2h": 0.0, "d2h_pinned": 0.0}
    stepper.reset()
    pinned = None
    for f in frames:
        a = time.perf_counter()
        x = stepper._device_frame(f)
        torch.cuda.synchronize()
        b = time.perf_counter()
        alpha, fgr = stepper._run(x)
        torch.cuda.synchronize()
        c = time.perf_counter()
        alpha[0].cpu().numpy(), fgr[0].cpu().numpy()
        d = time.perf_counter()
        if pinned is None:
            pinned = [torch.empty(o.shape[1:], dtype=o.dtype,
                                  pin_memory=True) for o in (alpha, fgr)]
        e = time.perf_counter()
        for p, o in zip(pinned, (alpha, fgr)):
            p.copy_(o[0], non_blocking=True)
        torch.cuda.synchronize()
        [np.array(p.numpy()) for p in pinned]
        g = time.perf_counter()
        t["h2d"] += b - a
        t["replay"] += c - b
        t["d2h"] += d - c
        t["d2h_pinned"] += g - e
    return {k: v * 1e3 / len(frames) for k, v in t.items()}


def session_graph_check(kw, frames, dev):
    """The captured session step against an eager session (capture off)
    on the same frames, across a reset and a load_state: every output
    byte equal; the arrays a step returned are not touched by the next
    step. Returns the number of unequal values (0)."""
    import numpy as np

    from vidmat_torch import MattingSession

    sess, eager = MattingSession(H, W, **kw), MattingSession(H, W, **kw)
    eager._stepper.capture = False
    carry = os.path.join(OUT_DIR, "session_carry.npz")
    unequal = 0

    def both(fs):
        nonlocal unequal
        for f in fs:
            got, want = sess.step(f), eager.step(f)
            unequal += sum(int((g != w).sum()) for g, w in zip(got, want))

    both(frames[:6])
    kept = sess.step(frames[6])
    eager.step(frames[6])
    snapshot = [np.array(a) for a in kept]
    sess.reset()
    eager.reset()  # the step after a reset equals a new session's first
    both(frames[7:11])
    assert all(np.array_equal(a, b) for a, b in zip(kept, snapshot)), \
        "a returned array was overwritten"
    sess.save_state(carry, frame_index=11)
    both(frames[11:13])
    assert sess.load_state(carry) == 11 and eager.load_state(carry) == 11
    both(frames[13:])
    assert sess._stepper._graph is not None, "no captured step"
    assert eager._stepper._graph is None
    return unequal


def phase_session(kernels, dev):
    """Path A: MattingSession(1088, 1920) on the video_1080p model
    (fast_demo, s2d=2, planar) at ratio 0.25 in bf16, one frame per step:
    ingest, planar net, GF coefficients, fused_refine_float. 16 frames
    against the same stepper on the plain versions; launch counts; the
    per-frame host split (each stage waited for). Then static skip on four
    identical frames and convert_video(output_foreground) on 8 preset
    frames."""
    import numpy as np

    from vidmat_torch import MattingSession, convert_video, preset_video_1080p
    from vidmat_torch.pipeline.stepper import VideoStepper

    mcfg, pcfg = preset_video_1080p()
    frames = padded_clip(SESSION_FRAMES, seed=6)
    kw = dict(model_cfg=mcfg, downsample_ratio=RATIO, dtype="bfloat16")
    sess = MattingSession(H, W, **kw)
    plain = VideoStepper(mcfg, H, W, downsample_ratio=RATIO,
                         dtype="bfloat16", device=dev, kernels=False)
    for st in (sess, plain):  # warm-up
        st.step(frames[0])
        st.reset()
    zero_counts(kernels)
    t0 = time.perf_counter()
    outs = [sess.step(f) for f in frames]
    wall = (time.perf_counter() - t0) * 1e3 / SESSION_FRAMES
    launches = counts(kernels)
    per = sess._stepper._graph.launches_per_replay()
    assert {k: v * SESSION_FRAMES for k, v in per.items()} == {
        k: v for k, v in launches.items() if v}, (per, launches)
    split = step_split(sess._stepper, frames)
    s_unequal = session_graph_check(kw, frames, dev)
    worst_mean = worst_max = 0.0
    for f, (ka, kf) in zip(frames, outs):
        assert ka.shape == (H, W, 1) and kf.shape == (H, W, 3)
        assert ka.dtype == np.float32 and np.isfinite(ka).all() \
            and np.isfinite(kf).all()
        pa, pf = plain.step(f)
        for k, p in ((ka, pa), (kf, pf)):
            d = np.abs(k - p)
            worst_mean = max(worst_mean, float(d.mean()))
            worst_max = max(worst_max, float(d.max()))
    log(f"[S] MattingSession 1088x1920 bf16, {SESSION_FRAMES} frames, "
        f"kernels vs plain: alpha/fgr worst-frame mean |d| {worst_mean:.3g}, "
        f"max {worst_max:.3g}; launches {launches}")
    log(f"    per frame {wall:.3f} ms through step() (the captured step: "
        f"launches per replay {per}, capture "
        f"{sess._stepper.capture_ms:.1f} ms); its stages, each waited: "
        f"pinned H2D {split['h2d']:.3f} + replay {split['replay']:.3f} + "
        f"D2H {split['d2h']:.3f} ms (.cpu() of alpha + fgr float32, 33.4 "
        f"MB; into reused pinned buffers and a host copy "
        f"{split['d2h_pinned']:.3f} ms)")
    log(f"    captured step vs an eager session, 16 frames across a reset "
        f"and a load_state: {s_unequal} values unequal")
    assert s_unequal == 0, s_unequal
    GRAPHS["S: session step"] = dict(
        per_replay=per, capture_ms=sess._stepper.capture_ms, split=split,
        step_ms=wall, unequal=s_unequal)
    want = expect(kernels, dict(PLANAR_PER_FRAME, ingest_pool_normalize=1,
                                guided_filter_coeffs=1, fused_refine_float=1),
                  SESSION_FRAMES)
    assert launches == want, (launches, want)
    assert worst_mean <= 2e-3 and worst_max <= 8e-3, (worst_mean, worst_max)

    skip = MattingSession(H, W, static_skip_eps=0.5 / 255, **kw)
    zero_counts(kernels)
    souts = [skip.step(frames[0]) for _ in range(4)]
    skip_launches = counts(kernels)
    skips = skip._stepper.state[1][3]
    log(f"    static skip, 4 identical frames: {skips} skipped; launches "
        f"{skip_launches} (eager: its branch is taken on the host)")
    assert skips == 3, skips
    assert skip._stepper._graph is None
    want = expect(kernels, PLANAR_PER_FRAME, 1)
    want.update(ingest_pool_normalize=4, guided_filter_coeffs=1,
                fused_refine_float=4)
    assert skip_launches == want, (skip_launches, want)
    for a, f in souts[1:]:
        assert np.array_equal(a, souts[0][0]) and np.array_equal(
            f, souts[0][1]), "static skip: outputs differ"

    src = clip(8, seed=6)[0]
    fgrs, alphas = [], []
    zero_counts(kernels)
    m = convert_video(src, output_foreground=fgrs.append,
                      output_alpha=alphas.append, model_cfg=mcfg,
                      pipe_cfg=pcfg)
    fg_launches = counts(kernels)
    log(f"    convert_video output_foreground, 8 preset frames: fps "
        f"{m['fps']:.2f}; launches {fg_launches}")
    assert m["frames"] == 8 and len(fgrs) == 8 and len(alphas) == 8
    assert fgrs[0].shape == (FRAME_H, FRAME_W, 3) and fgrs[0].dtype == np.uint8
    assert fg_launches["fused_refine_float"] == 8, fg_launches
    assert fg_launches["fused_refine_composite"] == 0, fg_launches
    graph_check("S: output_foreground (per-frame float tail)", m,
                fg_launches, fgrs, lambda sink: convert_video(
                    src, output_foreground=sink, output_alpha=lambda a: None,
                    model_cfg=mcfg, pipe_cfg=pcfg), CHUNK)
    return dict(launches=launches, split=split, wall_ms=wall,
                mean=worst_mean, max=worst_max)


def plain_twin(net, mcfg, pcfg, frames, alphas, dev):
    """Run ``frames`` (source frames, as convert_video took them) through
    the serving body on the plain versions, built as convert_video builds
    its own (bucket, ratio, alpha-only output) on ``net`` (the same
    weights), and hold the kernel run's alpha bytes ``alphas`` to it.
    Returns (worst-frame mean |d|, max |d|) in LSB."""
    import numpy as np
    import torch

    from vidmat_torch.io.reader import pad_frame
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.video import auto_downsample_ratio

    fh, fw = frames[0].shape[:2]
    ph, pw = fh + (-fh) % 16, fw + (-fw) % 16
    ratio = pcfg.downsample_ratio
    if ratio is None:
        ratio = auto_downsample_ratio(fh, fw)
    body, plan = build_serving_body(net, mcfg, pcfg.refine, ph, pw, ratio,
                                    alpha_only=True, kernels=False)
    state = plan.make_state(1)
    worst_mean = worst_max = 0.0
    for f, a in zip(frames, alphas):
        out, state = body(torch.from_numpy(pad_frame(f, ph, pw)).to(dev),
                          state)
        d = np.abs(out[0, :fh, :fw].cpu().numpy().astype(np.int16)
                   - a.astype(np.int16))
        worst_mean = max(worst_mean, float(d.mean()))
        worst_max = max(worst_max, float(d.max()))
    assert worst_mean <= 0.5 and worst_max <= 2, (worst_mean, worst_max)
    return worst_mean, worst_max


def phase_clip_480p(kernels, dev):
    """clip_480p through convert_video (synthetic_demo at full resolution:
    the planar net on the frame itself, then composite_rgba_packed) on 100
    synthetic 480x864 frames; then the JAX package's defaults on 16 frames
    at 1080p (F.conv2d net at an auto ratio, guided_upsample through the
    GF kernel, composite_rgba_packed). Each run is held to the same frames
    through the plain versions, and the kernels to their plain versions at
    the call sites these paths add (the s2d=1 planar net at 480x864, GF on
    the defaults' coarse grid). Returns (result, {kernel name: max |d|})."""
    import numpy as np
    import torch

    import vidmat_torch.ops.gf as gf
    from vidmat_torch import (ModelConfig, PipelineConfig, convert_video,
                              preset_clip_480p)
    from vidmat_torch.io.fixtures import synthetic_clip
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.utils.metrics import mad

    frames, gt = [], []
    for f, a in synthetic_clip(CLIP_H, CLIP_W, CLIP_FRAMES, seed=0):
        frames.append(f)
        gt.append(a[..., 0])
    mcfg, pcfg = preset_clip_480p()
    convert_video(frames[:10], output_alpha=lambda a: None, model_cfg=mcfg,
                  pipe_cfg=pcfg)  # warm-up
    alphas = []
    zero_counts(kernels)
    m = convert_video(frames, output_alpha=lambda a: alphas.append(a.copy()),
                      model_cfg=mcfg, pipe_cfg=pcfg)
    launches = counts(kernels)
    assert m["frames"] == CLIP_FRAMES and alphas[0].shape == (CLIP_H, CLIP_W)
    alpha_mad = float(np.mean([mad(a.astype(np.float32) / 255.0, g)
                               for a, g in zip(alphas, gt)]))
    log(f"[C] convert_video clip_480p, {CLIP_FRAMES}x{CLIP_W}x{CLIP_H} "
        f"alpha-only: fps {m['fps']:.2f}, p50 {m['p50_ms']:.3f} ms "
        f"({m.get('latency_granularity', 'per-frame')}), alpha MAD vs ground "
        f"truth {alpha_mad:.5f} (JAX reference {JAX_REFERENCE_MAD_480P}); "
        f"launches {launches}")
    want = expect(kernels, dict(PLANAR_PER_FRAME, composite_rgba_packed=1),
                  CLIP_FRAMES)
    assert launches == want, (launches, want)
    assert abs(alpha_mad - JAX_REFERENCE_MAD_480P) <= CLIP_MAD_TOL, alpha_mad
    graph_check("C: clip_480p (per-frame bodies)", m, launches, alphas,
                lambda sink: convert_video(frames, output_alpha=sink,
                                           model_cfg=mcfg, pipe_cfg=pcfg),
                pcfg.chunk_size)

    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    # The full-resolution input (the body's cast of frame / 255, no pad:
    # 480x864 is on the 16 grid) of the run's first frame.
    x0 = (torch.from_numpy(frames[0])[None].to(dev).float()
          * (1.0 / 255.0)).to(torch.bfloat16)
    log("    planar kernels vs plain at the s2d=1 net's sites (480x864):")
    errs = planar_kernel_checks(capture_sites(net, None, x0), dev,
                                ragged=False)
    twin = plain_twin(net, mcfg, pcfg, frames, alphas, dev)
    log(f"    clip_480p kernels vs plain, {CLIP_FRAMES} frames: alpha bytes "
        f"worst-frame mean |d| {twin[0]:.4g}, max {twin[1]:.0f}")

    # The JAX package's defaults: ModelConfig() / PipelineConfig().
    src, src_gt = clip(16, seed=0)
    convert_video(src[:2], output_alpha=lambda a: None)  # warm-up
    dalphas = []
    zero_counts(kernels)
    md = convert_video(src, output_alpha=lambda a: dalphas.append(a.copy()))
    dl = counts(kernels)
    d_mad = float(np.mean([mad(a.astype(np.float32) / 255.0, g)
                           for a, g in zip(dalphas, src_gt)]))
    log(f"    defaults (ModelConfig(), PipelineConfig()), 16 frames at "
        f"1920x1080: fps {md['fps']:.2f}, alpha MAD vs ground truth "
        f"{d_mad:.5f}; launches {dl}")
    assert md["frames"] == 16 and dalphas[0].shape == (FRAME_H, FRAME_W)
    assert dl == expect(kernels, dict(guided_filter_coeffs=1,
                                      composite_rgba_packed=1), 16), dl
    graph_check("C: JAX defaults (chunk 1)", md, dl, dalphas,
                lambda sink: convert_video(src, output_alpha=sink), 1)

    # The plain twin records the GF call of its first frame (guided_upsample
    # looks the plain version up in ops.gf at each call).
    dcfg = ModelConfig()
    dnet = build_network(dcfg, default_variables(dcfg), dtype=torch.bfloat16,
                         device=dev)
    gf_plain = gf.guided_filter_coeffs_plain
    gf_calls = []

    def record(*args):
        if not gf_calls:
            gf_calls.append(args)
        return gf_plain(*args)

    gf.guided_filter_coeffs_plain = record
    try:
        dtwin = plain_twin(dnet, dcfg, PipelineConfig(), src, dalphas, dev)
    finally:
        gf.guided_filter_coeffs_plain = gf_plain
    guide, p, r, eps = gf_calls[0]
    ka, kb = gf.guided_filter_coeffs(guide, p, r, eps)
    pa, pb = gf_plain(guide, p, r, eps)
    torch.cuda.synchronize()
    errs["guided_filter_coeffs"] = float(max((ka - pa).abs().max(),
                                             (kb - pb).abs().max()))
    log(f"    defaults kernels vs plain, 16 frames: alpha bytes worst-frame "
        f"mean |d| {dtwin[0]:.4g}, max {dtwin[1]:.0f}; GF coefficients on "
        f"the {tuple(guide.shape[1:3])} grid: max |d| "
        f"{errs['guided_filter_coeffs']:.3g}")
    assert errs["guided_filter_coeffs"] <= 1e-4, errs
    return dict(launches=launches, fps=m["fps"], mad=alpha_mad,
                default_launches=dl, default_fps=md["fps"],
                default_mad=d_mad), errs


# Alpha MAD of the JAX package on 16 frames of the 1920x1080 camouflage
# clean-plate clip (synthetic_plate_clip, seed 0) with its true plate,
# plate_demo, bf16, ratio 0.25, guided (tests/torch_reference_mad.py
# plate_1080p, CPU). The port's is held within a third of it, or 5e-3 if
# that is smaller.
JAX_REFERENCE_MAD_PLATE = 0.02043
PLATE_MAD_TOL = min(JAX_REFERENCE_MAD_PLATE / 3, 5e-3)
BG_FRAMES = 16


def chunked(kernels, frames, **extra):
    """Launch counts of ``frames`` frames of the planar preset's chunk
    body (chunk 4): per chunk ingest, stem, proj, three encoder pairs, GF
    and the fused tail; per frame three decoder stages and d0 + head."""
    per_chunk = dict(ingest_pool_normalize=1, guided_filter_coeffs=1,
                     fused_refine_composite=1, planar_conv=2, planar_conv2=3)
    per_frame = dict(planar_conv2=1, planar_conv_gru=3)
    c = frames // CHUNK
    want = {fn.__name__: c * per_chunk.get(fn.__name__, 0)
            + frames * per_frame.get(fn.__name__, 0) for fn in kernels}
    want.update(extra)
    return want


def twin_bytes(net, mcfg, pcfg, frames, outs, dev, bgs=None, **kw):
    """Hold a convert_video run's output frames ``outs`` (as its callback
    received them: RGBA, or the alpha plane with ``alpha_only``) to the
    same source frames through the per-frame serving body on the plain
    versions, built as the pipeline builds its own (bucket, ratio and the
    options ``kw``) on ``net`` (the same weights); ``bgs``: the per-frame
    backgrounds of a background video. Returns (worst-frame mean |d|, max
    |d|) in LSB, after checking mean <= 0.5 and max <= 2."""
    import numpy as np
    import torch

    from vidmat_torch.io.reader import pad_frame
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.video import auto_downsample_ratio

    fh, fw = frames[0].shape[:2]
    ph, pw = fh + (-fh) % 16, fw + (-fw) % 16
    ratio = pcfg.downsample_ratio
    if ratio is None:
        ratio = auto_downsample_ratio(fh, fw)
    body, plan = build_serving_body(net, mcfg, pcfg.refine, ph, pw, ratio,
                                    kernels=False, **kw)
    state = plan.make_state(1)
    worst_mean = worst_max = 0.0
    for i, (f, got) in enumerate(zip(frames, outs)):
        args = (torch.from_numpy(pad_frame(f, ph, pw)).to(dev), state)
        if bgs is not None:
            args += (torch.from_numpy(bgs[i]).to(dev),)
        out, state = body(*args)
        if isinstance(out, tuple):
            want = out[2][0]
        elif plan.alpha_only:
            want = out[0]
        else:
            want = out[0].view(torch.uint8).reshape(ph, pw, 4)
        d = np.abs(want[:fh, :fw].cpu().numpy().astype(np.int16)
                   - got.astype(np.int16))
        worst_mean = max(worst_mean, float(d.mean()))
        worst_max = max(worst_max, float(d.max()))
    assert worst_mean <= 0.5 and worst_max <= 2, (worst_mean, worst_max)
    return worst_mean, worst_max


def plate_input(net, chunk_u8, plate_u8):
    """The plate net's input for a chunk of padded frames: the plain
    ingest of the frames and of the plate (one, or one per frame) at pool
    4, concatenated, edge-padded to the s2d grid."""
    import torch
    import torch.nn.functional as F

    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain

    x = ingest_pool_normalize_plain(chunk_u8, pool=4)
    p = ingest_pool_normalize_plain(plate_u8, pool=4)
    x = torch.cat([x, p.expand(x.shape[0], -1, -1, -1)], -1)
    mult = 16 * net.cfg.space_to_depth
    nh, nw = x.shape[1:3]
    return F.pad(x.permute(0, 3, 1, 2), (0, -nw % mult, 0, -nh % mult),
                 mode="replicate").permute(0, 2, 3, 1)


def phase_backgrounds(kernels, gpu, dev):
    """Backgrounds and the plate family through convert_video on 1920x1080
    synthetic frames: (a) bg_image, (b) bg_video, (c) bg_blur on the
    video_1080p preset (chunk 4), (d) bg_blur with output_foreground on
    the preset and with the composition on the JAX defaults (the unfused
    tail: composite_rgba_packed over per-frame images), (e) plate_demo on
    the planar net with a color composition, (f) a bare bg_plate (the
    F.conv2d family at the defaults). Each run's launch counts (set to 0
    just before, read just after), its fps, and its output bytes against
    the same frames through the plain body; (e) also the alpha MAD against
    the fixture and the planar kernels at the plate net's 9 sites.
    Returns {path: result}."""
    import numpy as np
    import torch

    from vidmat_torch import (ModelConfig, PipelineConfig, convert_video,
                              preset_video_1080p)
    from vidmat_torch.io.backgrounds import (prepare_bg_image,
                                             prepare_plate_u8)
    from vidmat_torch.io.fixtures import synthetic_plate_clip
    from vidmat_torch.models.weights import (build_network,
                                             default_variables,
                                             plate_default_config)
    from vidmat_torch.pipeline.video import Uploads
    from vidmat_torch.utils.metrics import mad

    refine = next(fn for fn in kernels
                  if fn.__name__ == "fused_refine_composite")
    mcfg, pcfg = preset_video_1080p()
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    frames = clip(BG_FRAMES, seed=4)[0]
    rng = np.random.RandomState(4)
    image = rng.rand(H, W, 3).astype(np.float32)
    video = [(rng.rand(H, W, 3) * 255).astype(np.uint8) for _ in range(3)]
    res = {}

    def run(name, src, want, twin_kw, n=BG_FRAMES, bgs=None, twin_net=net,
            twin_cfg=(mcfg, pcfg), target="output_composition", setup=None,
            **kw):
        kw.setdefault("model_cfg", mcfg)
        kw.setdefault("pipe_cfg", pcfg)
        convert_video(src[:4], **{target: lambda a: None}, **kw)  # warm-up
        outs = []
        zero_counts(kernels)
        m = convert_video(src[:n], **{target: lambda a: outs.append(
            a.copy())}, **kw)
        launches = counts(kernels)
        modes = {k: v for k, v in refine.mode_launches.items() if v}
        assert m["frames"] == n and len(outs) == n, m
        assert launches == want, (name, launches, want)
        twin = twin_bytes(twin_net, *twin_cfg, src[:n], outs, dev, bgs=bgs,
                          **twin_kw)
        log(f"[B] ({name}) {n} frames: fps {m['fps']:.2f} ({gpu}); refine "
            f"modes {modes}; bytes vs plain twin worst-frame mean |d| "
            f"{twin[0]:.4g}, max {twin[1]:.0f}; launches {launches}")
        cfg = kw["pipe_cfg"] or PipelineConfig()
        graph_check(f"B: {name}", m, launches, outs,
                    lambda sink: convert_video(src[:n], **{target: sink},
                                               **kw),
                    max(1, cfg.chunk_size), setup=setup)
        res[name] = dict(fps=m["fps"], launches=launches, modes=modes,
                         twin=twin, outs=outs)
        return res[name]

    run("a: bg_image", frames, chunked(kernels, BG_FRAMES),
        dict(bg=prepare_bg_image(image, H, W)), bg_image=image)
    assert res["a: bg_image"]["modes"] == {"image": BG_FRAMES // CHUNK}

    n = BG_FRAMES // 2
    bgs = [prepare_bg_image(video[i % 3], H, W)[None] for i in range(n)]
    run("b: bg_video", frames, expect(kernels, dict(
        PLANAR_PER_FRAME, ingest_pool_normalize=1, guided_filter_coeffs=1,
        fused_refine_composite=1), n), dict(bg_dynamic=True), n=n, bgs=bgs,
        bg_video=video)
    assert res["b: bg_video"]["modes"] == {"image": n}
    # H2D of the float32 backgrounds (the JAX package sends float32 too)
    # through the pipeline's staging, K deep (one copy a chunk), per frame
    # against the frame time of the bg_video run.
    up = Uploads((CHUNK, H, W, 3), torch.float32, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(0, n, CHUNK):
        slot = up.slot()
        for j in range(CHUNK):
            slot[j].copy_(torch.from_numpy(bgs[c + j][0]))
        up.send(CHUNK)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3 / n
    frame_ms = 1e3 / res["b: bg_video"]["fps"]
    res["b: bg_video"].update(bg_h2d_ms=h2d_ms, frame_ms=frame_ms)
    log(f"    bg_video: staging and H2D of the {bgs[0].nbytes / 1e6:.1f} MB "
        f"float32 backgrounds, {CHUNK} a copy, {h2d_ms:.3f} ms a frame, "
        f"waited, = {100 * h2d_ms / frame_ms:.1f}% of the {frame_ms:.3f} ms "
        f"frame time")

    run("c: bg_blur", frames, chunked(kernels, BG_FRAMES),
        dict(bg_blur=16), bg_blur=16)
    assert res["c: bg_blur"]["modes"] == {"coarse": BG_FRAMES // CHUNK}

    run("d: bg_blur + output_foreground", frames, expect(kernels, dict(
        PLANAR_PER_FRAME, ingest_pool_normalize=1, guided_filter_coeffs=1,
        fused_refine_float=1), n), dict(bg_blur=16, need_fgr=True), n=n,
        bg_blur=16, output_foreground=lambda a: None)
    dcfg, dpipe = ModelConfig(), PipelineConfig()
    dnet = build_network(dcfg, default_variables(dcfg), dtype=torch.bfloat16,
                         device=dev)
    run("d: bg_blur, defaults", frames, expect(kernels, dict(
        guided_filter_coeffs=1, composite_rgba_packed=1), n),
        dict(bg_blur=16), n=n, twin_net=dnet, twin_cfg=(dcfg, dpipe),
        model_cfg=dcfg, pipe_cfg=dpipe, bg_blur=16)

    pframes, pgt, plates = zip(*synthetic_plate_clip(FRAME_H, FRAME_W,
                                                     BG_FRAMES, seed=0))
    pframes, plate = list(pframes), plates[0]
    pcfg_e = ModelConfig(use_bg_plate=True, space_to_depth=2,
                         conv_impl="planar")
    pnet = build_network(pcfg_e, default_variables(pcfg_e),
                         dtype=torch.bfloat16, device=dev)
    plate_u8 = prepare_plate_u8(plate, H, W)
    e = run("e: plate_demo, planar", pframes,
            chunked(kernels, BG_FRAMES,
                    ingest_pool_normalize=BG_FRAMES // CHUNK + 1),
            dict(bg=(0.0, 1.0, 0.0), bg_plate=plate_u8), twin_net=pnet,
            twin_cfg=(pcfg_e, pcfg), model_cfg=pcfg_e, bg_plate=plate,
            setup=dict(ingest_pool_normalize=1))  # the plate's ingest
    assert e["modes"] == {"color": BG_FRAMES // CHUNK}
    e["mad"] = float(np.mean([mad(o[..., 3].astype(np.float32) / 255.0,
                                  g[..., 0]) for o, g in zip(e["outs"],
                                                             pgt)]))
    log(f"    plate alpha MAD vs ground truth {e['mad']:.5f} (JAX reference "
        f"{JAX_REFERENCE_MAD_PLATE}, bound +-{PLATE_MAD_TOL:.4g})")
    assert abs(e["mad"] - JAX_REFERENCE_MAD_PLATE) <= PLATE_MAD_TOL, e["mad"]
    chunk = torch.from_numpy(np.concatenate(
        [prepare_plate_u8(f, H, W)[None] for f in pframes[:CHUNK]])).to(dev)
    log("    planar kernels vs plain at the plate net's sites (1088x1920, "
        "24 input channels):")
    sites = capture_sites(pnet, None, plate_input(
        pnet, chunk, torch.from_numpy(plate_u8[None]).to(dev)))
    e["errs"] = planar_kernel_checks(sites, dev, ragged=False)

    fcfg = plate_default_config()
    fnet = build_network(fcfg, default_variables(fcfg), dtype=torch.bfloat16,
                         device=dev)
    run("f: bare bg_plate", pframes, expect(kernels, dict(
        guided_filter_coeffs=1, composite_rgba_packed=1), n),
        dict(bg_plate=plate_u8, alpha_only=True), n=n, twin_net=fnet,
        twin_cfg=(fcfg, PipelineConfig()), target="output_alpha",
        model_cfg=None, pipe_cfg=None, bg_plate=plate)
    for r in res.values():
        r.pop("outs")
    return res


# The video_4k preset (vidmat/config.py:188-193) at ratio 0.125. The coarse
# grid snaps to multiples of 16: 3840x2176 frames (bench.py's 4K shape)
# give 272x480, pool 8, which the s2d=2 net pads to 288x480 (the 1080p
# state grid); tiles of 1024 with an overlap of 128, so coarse tiles of 128
# with an overlap of 16: 3 x 5 = 15 tiles in one GF launch. 3840x2160
# frames (their /16 bucket keeps 2160) snap to the same 272x480 grid, no
# integer pool of 2160: the untiled guided tail, as in the JAX package.
H4K, W4K, RATIO_4K = 2176, 3840, 0.125
H4K_SRC = 2160
TILE_4K, OVERLAP_4K = 1024, 128
K_FRAMES = 16


def frames_4k(n, seed=8):
    """n synthetic 3840x2176 frames of the moving-disk clip and their
    ground-truth alphas, made on 4 host threads (numpy releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from vidmat_torch.io.fixtures import synthetic_frame

    with ThreadPoolExecutor(4) as ex:
        out = list(ex.map(lambda i: synthetic_frame(H4K, W4K, i / n, seed),
                          range(n)))
    return [f for f, _ in out], [a[..., 0] for _, a in out]


def inputs_4k(net, dev):
    """The 4K path's tail-kernel inputs for one frame, by the plain
    versions: the frame (1, 2176, 3840, 3) u8, the guide and signals cut
    into the 15 coarse tiles ((15, 128, 128, 1) and (..., 4) f32), and the
    blended coefficient grids (1, 272, 480, 4) f32."""
    import torch
    import torch.nn.functional as F

    from vidmat_torch.ops.gf import guided_filter_coeffs_plain
    from vidmat_torch.ops.guided_filter import gray_guide
    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain
    from vidmat_torch.refine.tiling import (TileLayout, tile_frame,
                                            untile_frame)

    frame = torch.from_numpy(frames_4k(1, seed=13)[0][0][None]).to(dev)
    x = ingest_pool_normalize_plain(frame, pool=8)
    nh, nw = x.shape[1:3]
    xp = F.pad(x.permute(0, 3, 1, 2), (0, -nw % 32, 0, -nh % 32),
               mode="replicate").permute(0, 2, 3, 1)
    with torch.inference_mode():
        alpha, fgr, _ = net(xp, net.init_state(1, *xp.shape[1:3]),
                            plain=True)
    lay = TileLayout(nh, nw, TILE_4K // 8, OVERLAP_4K // 8)
    guide = tile_frame(gray_guide(x.float()), lay)
    p = tile_frame(torch.cat([alpha[:, :nh, :nw], fgr[:, :nh, :nw]],
                             -1).float(), lay)
    ta, tb = guided_filter_coeffs_plain(guide, p)
    return dict(frame=frame, guide=guide, p=p,
                ma=untile_frame(ta, lay, 1).contiguous(),
                mb=untile_frame(tb, lay, 1).contiguous(), layout=lay)


def phase_4k_kernels(net, dev):
    """Phase 2 at the 4K path's launch shapes: ingest at pool 8 on one
    3840x2176 frame (bit-exact), the GF kernel on the 15-tile batch
    (bit-exact, one launch), the packed tail at pool 8 (bytes within +-1).
    Returns (errs {row: max |d|}, inputs)."""
    import torch

    from vidmat_torch.ops.gf import guided_filter_coeffs_plain
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    inp = inputs_4k(net, dev)
    fr, gd, p = inp["frame"], inp["guide"], inp["p"]
    xi = ingest_pool_normalize(fr, pool=8)
    d_ing = float((xi.float() - ingest_pool_normalize_plain(
        fr, pool=8).float()).abs().max())
    ka, kb = gf_one_launch(gd, p)
    pa, pb = guided_filter_coeffs_plain(gd, p)
    d_gf = max(float((ka - pa).abs().max()), float((kb - pb).abs().max()))
    out = fused_refine_composite(fr, inp["ma"], inp["mb"], None, 8)
    want = fused_refine_composite_plain(fr, inp["ma"], inp["mb"], None, 8)
    db = (out.view(torch.uint8).int() - want.view(torch.uint8).int()).abs()
    torch.cuda.synchronize()
    log(f"[2] 4K launch shapes: ingest pool 8 {tuple(fr.shape)} max |d| "
        f"{d_ing:.3g}; GF on {tuple(gd.shape[:3])} tiles max |d| "
        f"{d_gf:.3g} (one launch); refine pool 8 bytes max |d| "
        f"{int(db.max())}, unequal {int((db > 0).sum())} of {db.numel()}")
    assert d_ing == 0 and d_gf == 0 and int(db.max()) <= 1
    return {"ingest_pool_normalize (4K)": d_ing,
            "guided_filter_coeffs (4K tiled)": d_gf,
            "fused_refine_composite (4K)": float(db.max())}, inp


def phase_4k(kernels, gpu, dev):
    """Phase K: convert_video with video_4k, a sink keeping every alpha,
    (a) on the 3840x2160 crops of 16 synthetic frames (the untiled guided
    tail the JAX package takes there: GF and composite_rgba_packed) and
    (b) on the 3840x2176 frames (the tiled fused tail): fps (set-up in the
    first observation) and setup_ms; launches per frame against what the
    wrappers book; the bytes against the same frames through the plain
    body; for (b) the tiled alpha against the untiled fused tail, the
    per-stage host times of the per-frame body with the pipeline's
    staging and its device time by kernel; then the bf16
    MattingSession(2176, 3840) with tiling against its plain twin."""
    import dataclasses

    import numpy as np
    import torch

    from vidmat_torch import MattingSession, convert_video, preset_video_4k
    from vidmat_torch.io.native import pad_into
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.graph import ChunkGraph, per_frame_chunk
    from vidmat_torch.pipeline.stepper import VideoStepper
    from vidmat_torch.pipeline.video import Downloads, Uploads
    from vidmat_torch.utils.metrics import mad

    mcfg, pcfg = preset_video_4k()
    t0 = time.perf_counter()
    frames, gt = frames_4k(K_FRAMES)
    log(f"[K] {K_FRAMES} frames {W4K}x{H4K} made in "
        f"{time.perf_counter() - t0:.1f} s")
    preset = dict(model_cfg=mcfg, pipe_cfg=pcfg)
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)

    # (a) 3840x2160: no integer pool, the untiled guided tail.
    crops = [f[:H4K_SRC] for f in frames]
    convert_video(crops[:2], output_alpha=lambda a: None, **preset)
    src_alphas = []
    zero_counts(kernels)
    ms = convert_video(crops, output_alpha=src_alphas.append, **preset)
    src_launches = counts(kernels)
    assert ms["frames"] == K_FRAMES and len(src_alphas) == K_FRAMES, ms
    assert src_launches == expect(kernels, dict(
        PLANAR_PER_FRAME, guided_filter_coeffs=1, composite_rgba_packed=1),
        K_FRAMES), src_launches
    src_twin = twin_bytes(net, mcfg, pcfg, crops, src_alphas, dev,
                          alpha_only=True, tile_size=pcfg.tile_size,
                          tile_overlap=pcfg.tile_overlap)
    graph_check(f"K: video_4k {W4K}x{H4K_SRC} (untiled, chunk 1)", ms,
                src_launches, src_alphas, lambda sink: convert_video(
                    crops, output_alpha=sink, **preset), 1)
    log(f"[K] (a) convert_video video_4k on {W4K}x{H4K_SRC}, {K_FRAMES} "
        f"frames (coarse grid 272x480, no integer pool: the untiled "
        f"guided tail): fps {ms['fps']:.2f} (set-up {ms['setup_ms']:.1f} "
        f"ms), p50 {ms['p50_ms']:.3f} ms; bytes vs the plain body "
        f"worst-frame mean |d| {src_twin[0]:.4g}, max {src_twin[1]:.0f}; "
        f"launches {src_launches} ({gpu})")

    # (b) 3840x2176: pool 8, the tiled fused tail.
    convert_video(frames[:2], output_alpha=lambda a: None, **preset)
    alphas = []
    zero_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    m = convert_video(frames, output_alpha=alphas.append, **preset)
    launches = counts(kernels)
    peak_gb = (torch.cuda.max_memory_reserved() - reserved0) / 1e9
    want = expect(kernels, dict(PLANAR_PER_FRAME, ingest_pool_normalize=1,
                                guided_filter_coeffs=1,
                                fused_refine_composite=1), K_FRAMES)
    assert m["frames"] == K_FRAMES and len(alphas) == K_FRAMES, m
    assert alphas[0].shape == (H4K, W4K)
    assert launches == want, (launches, want)
    twin = twin_bytes(net, mcfg, pcfg, frames, alphas, dev, alpha_only=True,
                      tile_size=pcfg.tile_size,
                      tile_overlap=pcfg.tile_overlap)
    untiled = []
    upcfg = dataclasses.replace(pcfg, tile_size=None)
    mu = convert_video(frames, output_alpha=untiled.append, model_cfg=mcfg,
                       pipe_cfg=upcfg)
    d = np.abs(np.stack(alphas).astype(np.int16) - np.stack(untiled))
    # JAX's own tiled-vs-untiled check is on a uniform-noise frame
    # (tests/unit/test_fused_tiled_tail.py:49-65); on the moving-disk clip
    # the tiles' edge statistics move more bytes, in the JAX package too
    # (tests/test_torch_tiling.py::test_tiled_alpha_near_untiled), so the
    # clip's distance is logged, not bounded.
    noise = [np.random.RandomState(0).randint(0, 255, (H4K, W4K, 3),
                                              np.uint8)]
    nt, nu = [], []
    convert_video(noise, output_alpha=nt.append, **preset)
    convert_video(noise, output_alpha=nu.append, model_cfg=mcfg,
                  pipe_cfg=upcfg)
    dn = np.abs(nt[0].astype(np.int16) - nu[0])
    alpha_mad = float(np.mean([mad(a.astype(np.float32) / 255.0, g)
                               for a, g in zip(alphas, gt)]))
    log(f"[K] (b) convert_video video_4k on {W4K}x{H4K}, {K_FRAMES} "
        f"frames: fps "
        f"{m['fps']:.2f} (set-up {m['setup_ms']:.1f} ms in the first "
        f"observation), p50 {m['p50_ms']:.3f} ms; untiled (tile_size=None) "
        f"fps {mu['fps']:.2f}; launches {launches} ({gpu})")
    log(f"    bytes vs the plain body worst-frame mean |d| {twin[0]:.4g}, "
        f"max {twin[1]:.0f}; tiled vs untiled alpha on a noise frame mean "
        f"|d| {float(dn.mean()):.4g}, max {int(dn.max())}; on the clip mean "
        f"|d| {float(d.mean()):.4g}, max {int(d.max())}, unequal "
        f"{int((d > 0).sum())} of {d.size}; alpha MAD vs ground truth "
        f"{alpha_mad:.5f} (untiled "
        f"{float(np.mean([mad(a.astype(np.float32) / 255.0, g) for a, g in zip(untiled, gt)])):.5f})")
    assert int(dn.max()) <= 3 and float(dn.mean()) < 0.05, (dn.max(),
                                                            dn.mean())
    log(f"    the tiled run's device memory above what was reserved before "
        f"it (the graph's pool included): peak {peak_gb:.3f} GB")
    gk = graph_check(f"K: video_4k {W4K}x{H4K} (tiled, chunk 1)", m,
                    launches, alphas, lambda sink: convert_video(
                        frames, output_alpha=sink, **preset), 1)
    gk["peak_reserved_gb"] = peak_gb

    # Host stages of the per-frame body with the pipeline's staging, each
    # waited; then the body alone on a device-resident frame.
    body, plan = build_serving_body(net, mcfg, pcfg.refine, H4K, W4K,
                                    RATIO_4K, alpha_only=True,
                                    tile_size=pcfg.tile_size,
                                    tile_overlap=pcfg.tile_overlap)
    up, outs = Uploads((1, H4K, W4K, 3), torch.uint8, dev), Downloads(1, dev)
    st = plan.make_state(1)
    t = {"pad": 0.0, "h2d": 0.0, "enqueue": 0.0, "d2h": 0.0}
    for i, f in enumerate(frames[:2] + frames):
        a = time.perf_counter()
        pad_into(f, up.slot().numpy()[0])
        b = time.perf_counter()
        x = up.send(1)
        torch.cuda.synchronize()
        c = time.perf_counter()
        out, st = body(x, st)
        e0 = time.perf_counter()
        j = outs.open(out)
        outs.put(j, 0, out)
        handle = outs.close(j, 1, False)
        outs.read(handle)
        outs.release(handle)
        e = time.perf_counter()
        if i >= 2:  # two unrecorded frames
            for k, v in zip(t, (b - a, c - b, e0 - c, e - e0)):
                t[k] += v * 1e3 / K_FRAMES
    # The same stages with the body as the pipeline now runs it: one
    # replay of its captured graph a frame.
    graph = ChunkGraph(per_frame_chunk(body), up.dev, st)
    st = graph.state
    tg = {"pad": 0.0, "h2d": 0.0, "replay": 0.0, "d2h": 0.0}
    for i, f in enumerate(frames[:2] + frames):
        a = time.perf_counter()
        pad_into(f, up.slot().numpy()[0])
        b = time.perf_counter()
        up.send(1)
        torch.cuda.synchronize()
        c = time.perf_counter()
        out, st = graph(st)
        e0 = time.perf_counter()
        j = outs.open(out)
        outs.put(j, 0, out)
        handle = outs.close(j, 1, False)
        outs.read(handle)
        outs.release(handle)
        e = time.perf_counter()
        if i >= 2:
            for k, v in zip(tg, (b - a, c - b, e0 - c, e - e0)):
                tg[k] += v * 1e3 / K_FRAMES
    log(f"[K] per 4K frame through the captured graph, stages each "
        f"waited: pad_into {tg['pad']:.3f} + H2D {tg['h2d']:.3f} + replay "
        f"enqueue {tg['replay']:.3f} + D2H wait {tg['d2h']:.3f} = "
        f"{sum(tg.values()):.3f} ms (eager body: {sum(t.values()):.3f})")
    gk["split"] = tg
    gk["eager_split"] = t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        _, st = body(x, st)
    torch.cuda.synchronize()
    body_ms = (time.perf_counter() - t0) * 1e3 / 8
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        settle()
        for _ in range(4):
            _, st = body(x, st)
        settle()
    by_kernel = {}
    kern_ms, copy_ms = device_ms(prof, by_kernel)
    ours = sum(by_kernel.values()) / 4
    log(f"[K] per 4K frame, stages each waited: pad_into {t['pad']:.3f} + "
        f"H2D {t['h2d']:.3f} + body enqueue {t['enqueue']:.3f} + D2H wait "
        f"{t['d2h']:.3f} = {sum(t.values()):.3f} ms; the body alone "
        f"{body_ms:.3f} ms wall; device kernels {kern_ms / 4:.3f} ms/frame "
        f"(port kernels {ours:.3f}: " + ", ".join(
            f"{k} {v / 4:.4f}" for k, v in sorted(by_kernel.items()))
        + f"; other PyTorch kernels {kern_ms / 4 - ours:.3f})")

    # The bf16 session at 4K with tiling (the tiled float tail) against
    # its plain twin.
    kw = dict(downsample_ratio=RATIO_4K, tile_size=TILE_4K,
              tile_overlap=OVERLAP_4K)
    sess = MattingSession(H4K, W4K, model_cfg=mcfg, dtype="bfloat16", **kw)
    plain = VideoStepper(mcfg, H4K, W4K, dtype="bfloat16", device=dev,
                         kernels=False, **kw)
    assert sess._stepper._plan.pool == 8 and not sess._stepper._plan.packed
    zero_counts(kernels)
    worst_mean = worst_max = 0.0
    t0 = time.perf_counter()
    souts = [sess.step(f) for f in frames[:4]]
    sess_ms = (time.perf_counter() - t0) * 1e3 / 4
    s_launches = counts(kernels)
    for f, (ka, kf) in zip(frames[:4], souts):
        pa, pf = plain.step(f)
        for k, p_ in ((ka, pa), (kf, pf)):
            dd = np.abs(k - p_)
            worst_mean = max(worst_mean, float(dd.mean()))
            worst_max = max(worst_max, float(dd.max()))
    log(f"[K] MattingSession({H4K}, {W4K}) bf16 tiled, 4 frames: "
        f"{sess_ms:.2f} ms a step (the first builds); kernels vs plain "
        f"alpha/fgr worst-frame mean |d| {worst_mean:.3g}, max "
        f"{worst_max:.3g}; launches {s_launches}")
    assert s_launches == expect(kernels, dict(
        PLANAR_PER_FRAME, ingest_pool_normalize=1, guided_filter_coeffs=1,
        fused_refine_float=1), 4), s_launches
    assert worst_mean <= 2e-3 and worst_max <= 8e-3, (worst_mean, worst_max)
    return dict(fps=m["fps"], setup_ms=m["setup_ms"], launches=launches,
                src=dict(fps=ms["fps"], setup_ms=ms["setup_ms"],
                         launches=src_launches, twin=src_twin),
                twin=twin, tiled_vs_untiled=(float(d.mean()), int(d.max())),
                noise_tiled_vs_untiled=(float(dn.mean()), int(dn.max())),
                stages=t, body_ms=body_ms, by_kernel=by_kernel,
                session=dict(mean=worst_mean, max=worst_max, ms=sess_ms))


def phase_trimap(kernels, gpu, dev):
    """Phase A: trimap video, mask sources and the segmentation output on
    1920x1080 frames. (a) trimap_prop_demo through the planar net on the
    video_1080p pipeline (chunk 4, the chunk body and its graph) with a
    keyframe trimap; (b) the same from a keyframe mask; (c) the same
    checkpoint as F.conv2d with a per-frame trimap stream (the per-frame
    body); (d) output_segmentation with seg_demo through the planar net
    at ratio 0.25. Launch counts, fps, and the bytes against the same
    frames through the plain body (worst-frame mean |d| <= 0.5 LSB, max
    <= 2)."""
    import numpy as np
    import torch

    from vidmat_torch import ModelConfig, convert_video, preset_video_1080p
    from vidmat_torch.models.weights import (build_network,
                                             default_variables,
                                             seg_default_variables)
    from vidmat_torch.io.reader import pad_frame
    from vidmat_torch.pipeline.stepper import VideoStepper
    from vidmat_torch.pipeline.trimap import trimap_from_mask
    from vidmat_torch.pipeline.video import attach_trimap

    _, pcfg = preset_video_1080p()
    frames, gt = clip(BG_FRAMES, seed=5)
    tris = [np.where(a > 0.99, 255, np.where(a < 0.01, 0, 128)).astype(
        np.uint8) for a in gt]
    mask = (gt[0] > 0.5).astype(np.uint8) * 255
    res = {}

    def run(name, mcfg, src_kw, per_frame, want, n=BG_FRAMES):
        net = build_network(mcfg, default_variables(mcfg),
                            dtype=torch.bfloat16, device=dev)
        convert_video(frames[:4], output_alpha=lambda a: None,
                      model_cfg=mcfg, pipe_cfg=pcfg, **src_kw)  # warm-up
        outs = []
        zero_counts(kernels)
        m = convert_video(frames[:n], output_alpha=outs.append,
                          model_cfg=mcfg, pipe_cfg=pcfg, **src_kw)
        launches = counts(kernels)
        assert m["frames"] == n and len(outs) == n, m
        assert launches == want, (name, launches, want)
        with_tri = [attach_trimap(f, t, i) for i, (f, t) in enumerate(
            zip(frames[:n], per_frame))]
        twin = twin_bytes(net, mcfg, pcfg, with_tri, outs, dev,
                          alpha_only=True)
        log(f"[A] ({name}) {n} frames: fps {m['fps']:.2f} ({gpu}); bytes "
            f"vs plain twin worst-frame mean |d| {twin[0]:.4g}, max "
            f"{twin[1]:.0f}; launches {launches}")
        graph_check(f"A: {name}", m, launches, outs,
                    lambda sink: convert_video(
                        frames[:n], output_alpha=sink, model_cfg=mcfg,
                        pipe_cfg=pcfg, **src_kw), pcfg.chunk_size)
        res[name] = dict(fps=m["fps"], launches=launches, twin=twin)

    prop = ModelConfig(use_trimap=True, space_to_depth=2, conv_impl="planar")
    unknown = np.full(tris[0].shape, 128, np.uint8)
    run("a: keyframe trimap, planar", prop, dict(trimap_source=tris[0]),
        [tris[0]] + [unknown] * (BG_FRAMES - 1),
        chunked(kernels, BG_FRAMES))
    run("b: keyframe mask, planar", prop, dict(mask_source=mask),
        [trimap_from_mask(mask)] + [unknown] * (BG_FRAMES - 1),
        chunked(kernels, BG_FRAMES))
    n = BG_FRAMES // 2
    run("c: per-frame trimaps, F.conv2d",
        ModelConfig(use_trimap=True, space_to_depth=2),
        dict(trimap_source=tris), tris, expect(kernels, dict(
            ingest_pool_normalize=1, guided_filter_coeffs=1,
            fused_refine_composite=1), n), n=n)

    # (d) the segmentation stream: bf16 on the card through the planar
    # net, against a plain segmentation stepper on the same frames.
    scfg = ModelConfig(conv_impl="planar")
    convert_video(frames[:2], output_segmentation=lambda a: None,
                  model_cfg=scfg, downsample_ratio=RATIO)
    segs = []
    zero_counts(kernels)
    m = convert_video(frames[:n], output_segmentation=lambda a: segs.append(
        a.copy()), model_cfg=scfg, downsample_ratio=RATIO)
    launches = counts(kernels)
    assert m["frames"] == n and len(segs) == n, m
    assert launches == expect(kernels, dict(PLANAR_PER_FRAME,
                                            ingest_pool_normalize=1),
                              n), launches
    plain = VideoStepper(scfg, H, W, variables=seg_default_variables(scfg),
                         downsample_ratio=RATIO, dtype="bfloat16",
                         output="seg", device=dev, kernels=False)
    worst_mean = worst_max = 0.0
    for f, got in zip(frames[:n], segs):
        mask_p, _ = plain.step(pad_frame(f, H, W)[0])
        want = np.round(mask_p[:FRAME_H, :, 0] * 255.0).astype(np.int16)
        dd = np.abs(want - got[..., 0].astype(np.int16))
        worst_mean = max(worst_mean, float(dd.mean()))
        worst_max = max(worst_max, float(dd.max()))
    # The stream's session steps replay a captured step after the first.
    eager = []
    with eager_bodies():
        me = convert_video(frames[:n],
                           output_segmentation=lambda a: eager.append(
                               a.copy()),
                           model_cfg=scfg, downsample_ratio=RATIO)
    unequal = sum(int((a != b).sum()) for a, b in zip(segs, eager))
    log(f"[A] (d: output_segmentation, seg_demo, planar) {n} frames: fps "
        f"{m['fps']:.2f} (eager steps {me['fps']:.2f}); mask bytes vs plain "
        f"worst-frame mean |d| {worst_mean:.4g}, max {worst_max:.0f}; "
        f"launches {launches}; bytes unequal to the eager steps' {unequal}")
    assert worst_mean <= 0.5 and worst_max <= 2, (worst_mean, worst_max)
    assert unequal == 0, unequal
    res["d: output_segmentation"] = dict(fps=m["fps"], launches=launches,
                                         twin=(worst_mean, worst_max))
    return res


# Alpha MAD and unknown-band MAD of the JAX package on 16 frames of the
# 1920x1088 hard clip (synthetic_hard_clip, seed 0), synthetic_demo, bf16,
# ratio 0.25, error-map refinement with errormap_demo
# (tests/torch_reference_mad.py errormap_1080p, CPU). The port's alpha MAD
# is held within 5e-3 of it.
JAX_REFERENCE_MAD_ERRORMAP = 0.00804
JAX_REFERENCE_UNK_ERRORMAP = 0.03305
ERR_FRAMES = 16


def hard_frames(n, seed=0):
    """The first n frames of the n-frame hard clip at 1920x1088 and their
    ground-truth alphas, made on 4 host threads (numpy releases the
    GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from vidmat_torch.io.fixtures import synthetic_hard_frame

    with ThreadPoolExecutor(4) as ex:
        pairs = list(ex.map(lambda i: synthetic_hard_frame(
            H, W, i * (1.0 / n), seed), range(n)))
    return [f for f, _ in pairs], [a[..., 0] for _, a in pairs]


def refiner_stage_ms(ref, rgb, rgb_lr, alpha_lr, iters=20):
    """Median device ms (CUDA events) of the refiner's stages on one
    frame's inputs, each run alone: error head, selection (the error map
    onto the patch grid and the stable sort), gather (the alpha upsample
    and the indexed patches), patch net, scatter (the feathered add and
    the clip)."""
    import numpy as np
    import torch

    from vidmat_torch.ops.resize import resize_bilinear
    from vidmat_torch.refine.errormap import _grid_view, select_patches

    n, hf, wf, _ = rgb.shape
    p, k = ref.patch_size, ref.num_patches
    gh, gw = hf // p, wf // p
    st = {}

    def head():
        st["err"] = ref.error_head(rgb_lr.permute(0, 3, 1, 2),
                                   alpha_lr.permute(0, 3, 1, 2)).permute(
                                       0, 2, 3, 1)

    def select():
        grid = resize_bilinear(st["err"], gh, gw).reshape(n, gh * gw)
        st["idx"] = select_patches(grid, k)

    def gather():
        idx = st["idx"]
        st["ib"] = torch.arange(n, device=idx.device)[:, None].expand(n, k)
        st["iy"], st["ix"] = idx // gw, idx % gw
        st["up"] = resize_bilinear(alpha_lr, hf, wf)
        src = torch.cat([rgb, st["up"]], dim=-1)
        st["patches"] = _grid_view(src, p)[st["ib"], st["iy"], :, st["ix"]]

    def net():
        res = ref.refine_net(st["patches"].reshape(n * k, p, p, 4).permute(
            0, 3, 1, 2))
        st["res"] = res.permute(0, 2, 3, 1).reshape(n, k, p, p, 1)

    def scatter():
        alpha = st["up"].clone()
        grid = _grid_view(alpha, p)
        ib, iy, ix = st["ib"], st["iy"], st["ix"]
        grid[ib, iy, :, ix] = grid[ib, iy, :, ix] + st["res"] * ref.feather
        alpha.clamp(0.0, 1.0)

    out = {}
    with torch.inference_mode(), full_fp32_scope():
        for name, fn in (("error head", head), ("selection", select),
                         ("gather", gather), ("patch net", net),
                         ("scatter", scatter)):
            fn()
            ts = []
            for _ in range(iters):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                fn()
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            out[name] = float(np.median(ts))
    return out


def full_fp32_scope():
    from vidmat_torch._device import full_fp32

    return full_fp32()


def phase_errormap(kernels, gpu, dev):
    """Phase E: convert_video with preset_video_1080p_errormap on 16 frames
    of the 1920x1088 hard clip (synthetic_demo through the planar net,
    the error-map refiner, composite_rgba_packed; four per-frame bodies a
    chunk, one graph): launches, fps and the graph against the eager
    bodies; the alpha MAD within 5e-3 of the JAX package's on the same
    clip; the unknown-band MAD below the guided tail's on the same base
    model; per frame the kernel path's alpha bytes against the plain body
    (on frames whose patch selections agree: worst-frame mean <= 0.5 LSB,
    max <= 2; where they differ, the plain grid's margin between its K-th
    and (K+1)-th scores beside the two error maps' difference); the
    refiner full float32 under PyTorch's default flags (card against the
    CPU on the same inputs, max |d| <= 1e-4, TF32 logged beside it); the
    refiner's device time (profiler) and its stages (CUDA events)."""
    import dataclasses

    import numpy as np
    import torch

    from vidmat_torch import (RefineConfig, convert_video,
                              preset_video_1080p_errormap)
    from vidmat_torch.models.weights import (build_network, build_refiner,
                                             default_refiner_variables,
                                             default_variables)
    from vidmat_torch.ops.resize import resize_bilinear
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.trimap import alpha_to_trimap
    from vidmat_torch.refine.errormap import select_patches

    mcfg, pcfg = preset_video_1080p_errormap()
    t0 = time.perf_counter()
    frames, gt = hard_frames(ERR_FRAMES)
    log(f"[E] {ERR_FRAMES} hard frames {W}x{H} made in "
        f"{time.perf_counter() - t0:.1f} s")
    preset = dict(model_cfg=mcfg, pipe_cfg=pcfg)
    convert_video(frames[:4], output_alpha=lambda a: None, **preset)
    alphas = []
    zero_counts(kernels)
    m = convert_video(frames, output_alpha=alphas.append, **preset)
    launches = counts(kernels)
    assert m["frames"] == ERR_FRAMES and alphas[0].shape == (H, W), m
    assert launches == expect(kernels, dict(
        PLANAR_PER_FRAME, ingest_pool_normalize=1, composite_rgba_packed=1),
        ERR_FRAMES), launches
    g = graph_check("E: video_1080p_errormap (per-frame bodies)", m,
                    launches, alphas, lambda sink: convert_video(
                        frames, output_alpha=sink, **preset), CHUNK)

    guided = []
    gcfg = dataclasses.replace(pcfg, refine=RefineConfig(mode="guided"))
    mg = convert_video(frames, output_alpha=guided.append, model_cfg=mcfg,
                       pipe_cfg=gcfg)

    def mads(outs):
        whole, band = [], []
        for a, t in zip(outs, gt):
            d = np.abs(a.astype(np.float32) / 255.0 - t)
            whole.append(d.mean())
            band.append(d[alpha_to_trimap(t)[..., 0] == 0.5].mean())
        return float(np.mean(whole)), float(np.mean(band))

    em, gd = mads(alphas), mads(guided)
    log(f"[E] convert_video video_1080p_errormap, {ERR_FRAMES}x{W}x{H} "
        f"hard clip: fps {m['fps']:.2f} ({gpu}), launches {launches}; "
        f"alpha MAD vs ground truth {em[0]:.5f} (JAX reference "
        f"{JAX_REFERENCE_MAD_ERRORMAP}), unknown-band MAD {em[1]:.5f} (JAX "
        f"{JAX_REFERENCE_UNK_ERRORMAP}); the guided tail on the same model "
        f"(the fused chunk body, fps {mg['fps']:.2f}): alpha MAD "
        f"{gd[0]:.5f}, unknown-band MAD {gd[1]:.5f}")
    assert abs(em[0] - JAX_REFERENCE_MAD_ERRORMAP) <= 5e-3, em
    assert em[1] < gd[1], (em, gd)

    # The kernel path against the plain body, frame by frame, with each
    # body's patch selection (a hook on the error head) and coarse alpha
    # (a hook on the refiner's inputs). Two plain bodies: the planar twins
    # summing in cuDNN's order (as the other phases' twins), and in the
    # kernels' fixed order (sequential=True, their oracle in phase 2).
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    rcfg = pcfg.refine
    ref = build_refiner(default_refiner_variables(), rcfg.errormap_patches,
                        rcfg.errormap_patch_size, device=dev)
    rec = {}
    hooks = [ref.error_head.register_forward_hook(
        lambda mod, args, out: rec.__setitem__("err", out)),
        ref.register_forward_pre_hook(
            lambda mod, args: rec.__setitem__("args", args))]
    bodies = {}
    for name, kern in (("kernels", True), ("cudnn", False),
                       ("sequential", False)):
        body, plan = build_serving_body(net, mcfg, rcfg, H, W, RATIO,
                                        alpha_only=True, kernels=kern,
                                        refiner=ref)
        bodies[name] = [body, plan.make_state(1)]
    k, p = ref.num_patches, ref.patch_size
    stats = {name: dict(mean=0.0, max=0.0, lr=0.0, differing=[])
             for name in ("cudnn", "sequential")}
    for i, f in enumerate(frames):
        x = torch.from_numpy(f[None]).to(dev)
        got = {}
        for name, bs in bodies.items():
            with (sequential_twins() if name == "sequential"
                  else contextlib.nullcontext()):
                out, bs[1] = bs[0](x, bs[1])
            err = rec["err"].permute(0, 2, 3, 1)
            grid = resize_bilinear(err, H // p, W // p).reshape(-1)
            got[name] = (out[0].cpu().numpy().astype(np.int16), err, grid,
                         set(select_patches(grid[None], k)[0].tolist()),
                         rec["args"][2].clone())
        for name, st in stats.items():
            d = np.abs(got["kernels"][0] - got[name][0])
            st["lr"] = max(st["lr"], 255.0 * float(
                (got["kernels"][4] - got[name][4]).abs().max()))
            diff_slots = len(got["kernels"][3] - got[name][3])
            if diff_slots == 0:
                st["mean"] = max(st["mean"], float(d.mean()))
                st["max"] = max(st["max"], float(d.max()))
                continue
            srt = torch.sort(got[name][2], descending=True).values
            st["differing"].append(i)
            log(f"    frame {i}, {name} twin: {diff_slots} of {k} selected "
                f"slots differ; the plain grid's K-th minus (K+1)-th score "
                f"{float(srt[k - 1] - srt[k]):.3g}, the error maps' max |d| "
                f"{float((got['kernels'][1] - got[name][1]).abs().max()):.3g}"
                f"; alpha bytes mean |d| {float(d.mean()):.4g}, max "
                f"{int(d.max())}")
    for name, st in stats.items():
        log(f"[E] kernel path vs the plain body ({name} order), "
            f"{ERR_FRAMES} frames: coarse alpha max |d| {st['lr']:.3g} LSB; "
            f"selections differ on {len(st['differing'])} frames "
            f"{st['differing']}; on the others alpha bytes worst-frame mean "
            f"|d| {st['mean']:.4g}, max {st['max']:.0f}")
    # The bar holds against the kernels' own order. Against cuDNN's the
    # patch net amplifies the bf16 coarse alpha's one-unit differences
    # inside the refined patches (logged above).
    seq = stats["sequential"]
    assert seq["mean"] <= 0.5 and seq["max"] <= 2, seq

    # Full float32 under PyTorch's default flags: the bf16 body's refiner
    # on the card against the same module on the CPU on its inputs.
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False  # PyTorch's defaults
    try:
        bodies["kernels"][0](torch.from_numpy(frames[0][None]).to(dev),
                             bodies["kernels"][1])
        args = [a.detach().clone() for a in rec["args"]]
        for h_ in hooks:
            h_.remove()
        cpu_ref = build_refiner(default_refiner_variables(), k, p)
        want = cpu_ref(*(a.cpu() for a in args))

        def picked(err):
            grid = resize_bilinear(err, H // p, W // p).reshape(1, -1)
            return set(select_patches(grid, k)[0].tolist())

        def worst(outs):
            """max |d| of (alpha, error map) against the CPU; the alpha's
            only where both picked the same patches (else None)."""
            d = [float((o.cpu() - w).abs().max()) for o, w in zip(outs,
                                                                  want)]
            if picked(outs[1].cpu()) != picked(want[1]):
                d[0] = None
            return d

        from vidmat_torch._device import full_fp32

        with full_fp32():
            scoped = worst(ref(*args))
        tf32 = worst(ref(*args))
        assert cudnn.allow_tf32 and not matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    log(f"    the refiner card vs CPU on frame 0's inputs under the default "
        f"flags: alpha / error map max |d| {scoped[0]} / {scoped[1]:.3g} "
        f"(the body's full_fp32 scope); TF32 allowed {tf32[0]} / "
        f"{tf32[1]:.3g} (alpha None: other patches picked)")
    assert scoped[1] <= 1e-4 and (scoped[0] or 0.0) <= 1e-4, scoped

    # The refiner's device time: the profiler over 5 calls, and its
    # stages by CUDA events.
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        settle()
        with full_fp32():
            for _ in range(5):
                ref(*args)
        settle()
    kern_ms, copy_ms = device_ms(prof)
    stages = refiner_stage_ms(ref, *args)
    log(f"    refiner device time {kern_ms / 5:.4f} ms a frame (profiler, "
        f"kernels; copies {copy_ms / 5:.4f}); stages alone (CUDA events): "
        + ", ".join(f"{s_} {v:.4f}" for s_, v in stages.items()))
    return dict(fps=m["fps"], launches=launches, mad=em[0], unk=em[1],
                guided_mad=gd[0], guided_unk=gd[1], guided_fps=mg["fps"],
                twin=stats,
                fp32=scoped, tf32=tf32, refiner_ms=kern_ms / 5,
                stages=stages, graph=g)


def phase_int8_probe(kernels):
    """The int8 planes probe (vidmat_torch/tools/bench_int8_planes.py) with
    3 repeats: both legs' ms per layer-batch beside their bytes bounds.
    Returns (result, int8_conv launches in the probe)."""
    from vidmat_torch.ops.int8_planar import int8_conv
    from vidmat_torch.tools import bench_int8_planes as bench

    zero_counts(kernels)
    int8_conv.launches = 0
    res = bench.run(repeats=3)
    launches = int8_conv.launches
    plane = 8 * 16 * bench.H * bench.W
    bounds = {"bf16-planes": 2 * 2 * plane / HBM_BYTES_PER_S * 1e3,
              "int8-planes": 2 * plane / HBM_BYTES_PER_S * 1e3}
    for name, r in res.items():
        log(f"[Q] {name}: {r['ms']:.4f} ms/layer-batch (n={r['n']}, "
            f"{r['min']:.4f}-{r['max']:.4f}), bytes bound "
            f"{bounds[name]:.4f} ms")
    log(f"    int8_conv launches in the probe: {launches}")
    assert set(res) == set(bounds) and launches > 0, (res, launches)
    return res, launches


def time_cold(fn, iters=50):
    """Median device time (ms) of fn() with the L2 cache flushed before
    each call, by CUDA events around the call alone. A device-side spin
    (~1 ms) after the flush keeps the card busy while the host enqueues
    the start event and fn's launches, so the interval holds the device's
    work and not the host's launch overhead (without it a short kernel
    reads as its Python wrapper's time)."""
    import torch

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def site_cost(key, args):
    """(bytes, multiply-adds) of one planar call: inputs and weights read
    once, outputs written once; the conv MACs it needs."""
    def n(t):
        return t.numel() * t.element_size()

    if key == "gru":
        x, h, wg, bg, wc, bc = args
        px, c = x.shape[0] * x.shape[2] * x.shape[3], h.shape[1]
        return (n(x) + 2 * n(h) + n(wg) + n(bg) + n(wc) + n(bc),
                px * 9 * (2 * c * 2 * c + c * 2 * c))
    xs = args[0]
    b_in = sum(n(t) for t in xs)
    nb, _, hh, ww = xs[0].shape
    w = args[1]
    cout, cin, k = w.shape[0], w.shape[1], w.shape[-1]
    if key == "conv":
        stride = args[4]
        px = nb * (hh // stride) * (ww // stride)
        return (b_in + n(w) + 8 * cout + px * cout * xs[0].element_size(),
                px * cout * cin * k * k)
    if key == "conv2":
        w2, stride = args[4], args[7]
        px = nb * (hh // stride) * (ww // stride)
        c2 = w2.shape[0]
        return (b_in + n(w) + n(w2) + 8 * (cout + c2)
                + px * c2 * xs[0].element_size(),
                px * (cout * cin * k * k + c2 * cout * 9))
    h, wg, wc = args[4], args[5], args[7]
    c, px = h.shape[1], nb * hh * ww
    return (b_in + n(w) + 8 * cout + 3 * n(h) + n(wg) + n(wc)
            + 4 * 3 * c,
            px * 9 * (cout * cin + 2 * c * 2 * c + c * 2 * c))


def site_plan(key, args):
    """The launch a bf16 tensor-core planar call makes at this site
    ({"tile", "blocks", "smem"}, and "nb", the output channels per block,
    for planar_conv)."""
    from vidmat_torch.ops.planar import (planar_conv2_plan, planar_conv_plan,
                                         planar_gru_plan)

    if key == "conv":
        xs, w, stride = args[0], args[1], args[4]
        n, _, hh, ww = xs[0].shape
        return planar_conv_plan([t.shape[1] for t in xs], n, hh, ww,
                                w.shape[0], w.shape[-1], stride)
    if key == "conv2":
        xs, w1, w2, stride = args[0], args[1], args[4], args[7]
        n, _, hh, ww = xs[0].shape
        return planar_conv2_plan([t.shape[1] for t in xs], n, hh, ww,
                                 w1.shape[0], w2.shape[0], stride)
    if key == "conv_gru":
        h = args[4]
        n, c, hh, ww = h.shape
        return planar_gru_plan(True, sum(t.shape[1] for t in args[0]), n,
                               hh, ww, c)
    n, c, hh, ww = args[1].shape
    return planar_gru_plan(False, c, n, hh, ww, c)


def kernel_call(key, args):
    """The planar kernel call of a site as the network makes it: planar_conv
    on bf16 planes with its weights packed beforehand."""
    import torch

    from vidmat_torch.ops.planar import pack_conv_weight

    kern = planar_ops()[key][0]
    if key == "conv" and args[1].dtype == torch.bfloat16:
        wp = pack_conv_weight(args[1])
        return lambda: kern(*args, packed=wp)
    return lambda: kern(*args)


def library_call(key, args):
    """One cuDNN F.conv2d pass over the same convs (inputs concatenated
    beforehand, no epilogue): the yardstick of a planar call."""
    import torch
    import torch.nn.functional as F

    if key == "gru":
        x, h = args[0], args[1]
        xh = torch.cat([x, h], 1)
        wg, wc = args[2], args[4]
        return lambda: (F.conv2d(xh, wg, None, 1, 1),
                        F.conv2d(xh, wc, None, 1, 1))
    xcat = torch.cat(list(args[0]), 1)
    w = args[1]
    k = w.shape[-1]
    if key == "conv":
        stride = args[4]
        return lambda: F.conv2d(xcat, w, None, stride, k // 2)
    if key == "conv2":
        w2, stride = args[4], args[7]
        mid = F.conv2d(xcat, w, None, stride, k // 2)
        return lambda: (F.conv2d(xcat, w, None, stride, k // 2),
                        F.conv2d(mid, w2, None, 1, 1))
    h, wg, wc = args[4], args[5], args[7]
    c = h.shape[1]
    bh = torch.cat([F.conv2d(xcat, w, None, 1, 1)[:, c:], h], 1)
    return lambda: (F.conv2d(xcat, w, None, 1, 1),
                    F.conv2d(bh, wg, None, 1, 1),
                    F.conv2d(bh, wc, None, 1, 1))


def tail_rows(inputs, bg_inputs, tail):
    """Phase 6's rows of the non-planar kernels: {row name: {"1 frame":
    case, and where the path launches another shape, that shape's label:
    case}}, each case a dict of kernel and plain calls, bytes (inputs read
    once, outputs written once) and operations with their peak. The main
    path launches ingest, GF and the packed tail on 4-frame chunks and
    MattingSession the float tail on one frame."""
    import torch
    import torch.nn.functional as F

    from vidmat_torch.ops.composite import (composite_rgba_packed,
                                            composite_rgba_packed_plain)
    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.int8_planar import int8_conv, int8_conv_plain
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain,
                                         fused_refine_float,
                                         fused_refine_float_plain)

    frame, guide, p, ma, mb = inputs
    image, coarse_bg, x8, w8, w8p = bg_inputs
    dev = frame.device
    chunk = torch.from_numpy(padded_clip(CHUNK, seed=12)).to(dev)

    def four(t):
        return t.expand(CHUNK, *t.shape[1:]).contiguous()

    shapes = {"1 frame": (frame, guide, p, ma, mb, coarse_bg),
              f"{CHUNK} frames": (chunk, four(guide), four(p), four(ma),
                                  four(mb), four(coarse_bg))}
    refine_ops = 8 * 9 + 6 + 16 + 9 + 12
    r = 4
    taps = 2 * (2 * r + 1)
    rows = {name: {} for name in (
        "ingest_pool_normalize", "guided_filter_coeffs",
        "fused_refine_composite", "fused_refine_composite (image)",
        "fused_refine_composite (coarse)")}
    for label, (fr, gd, pp, a, b, cbg) in shapes.items():
        x = ingest_pool_normalize(fr, pool=4)
        packed = fused_refine_composite(fr, a, b, None, 4)
        px = fr.shape[0] * fr.shape[1] * fr.shape[2]
        coarse = gd.shape[0] * gd.shape[1] * gd.shape[2]
        rows["ingest_pool_normalize"][label] = dict(
            kernel=lambda fr=fr: ingest_pool_normalize(fr, pool=4),
            plain=lambda fr=fr: ingest_pool_normalize_plain(fr, pool=4),
            bytes=nbytes(fr, x),
            # one add per input byte, 3 multiplies + 1 add per output value
            ops=fr.numel() + 4 * x.numel(), peak=F32_FLOPS_PER_S)
        rows["guided_filter_coeffs"][label] = dict(
            kernel=lambda gd=gd, pp=pp: guided_filter_coeffs(gd, pp),
            plain=lambda gd=gd, pp=pp: guided_filter_coeffs_plain(gd, pp),
            bytes=nbytes(gd, pp, a, b),
            # window sums of 10 statistics and 8 coefficients, 5 products,
            # 8 + 10 scalings, ~6 ops per channel for a, b
            ops=coarse * (18 * taps + 5 + 18 + 24), peak=F32_FLOPS_PER_S)
        # The packed tail without a background (the main path's), with an
        # (H, W, 3) image shared by the batch (bg_image), and with a coarse
        # background upsampled and clipped in the kernel (bg_blur: 3
        # channels x 3 lerps x 3 ops, 3 clips x 2).
        for name, bg, extra, ops in (
                ("fused_refine_composite", None, (), refine_ops),
                ("fused_refine_composite (image)", image, (image,),
                 refine_ops),
                ("fused_refine_composite (coarse)", cbg, (cbg,),
                 refine_ops + 27 + 6)):
            rows[name][label] = dict(
                kernel=lambda fr=fr, a=a, b=b, bg=bg: fused_refine_composite(
                    fr, a, b, bg, 4),
                plain=lambda fr=fr, a=a, b=b, bg=bg:
                    fused_refine_composite_plain(fr, a, b, bg, 4),
                bytes=nbytes(fr, a, b, *extra, packed),
                # 8 channels x 3 lerps x 3 ops, luma 6, 4 apply x 2 +
                # clips, composite 3 x 3, 4 quantizes x 3
                ops=px * ops, peak=F32_FLOPS_PER_S)

    # composite_rgba_packed on its paths: clip_480p's 480x864 frame and
    # the defaults' 1088x1920 one, premultiplied (no background), on the
    # float tail's mattes (cropped for 480x864).
    alpha, fgr = tail
    px = frame.shape[1] * frame.shape[2]
    x8b = x8.to(torch.bfloat16)
    q8 = int8_conv(x8, w8)
    rows.update({
        # 2 ops per multiply-add against the bf16 tensor-core peak; the
        # library yardstick is cuDNN's bf16 conv without the quantization.
        "int8_conv": {"1 frame": dict(
            kernel=lambda: int8_conv(x8, w8, packed=w8p),
            plain=lambda: int8_conv_plain(x8, w8),
            library=lambda: F.conv2d(x8b, w8, None, 1, 1),
            bytes=nbytes(x8, w8, q8),
            ops=2 * x8.numel() * 16 * 9, peak=BF16_FLOPS_PER_S)},
        "fused_refine_float": {"1 frame": dict(
            kernel=lambda: fused_refine_float(frame, ma, mb, 4),
            plain=lambda: fused_refine_float_plain(frame, ma, mb, 4),
            bytes=nbytes(frame, ma, mb, alpha, fgr),
            # 8 channels x 3 lerps x 3 ops, luma 6, 4 apply x 2 + clips
            ops=px * (8 * 9 + 6 + 16), peak=F32_FLOPS_PER_S)},
    })
    for label, (hh, ww) in (("480x864", (CLIP_H, CLIP_W)),
                            ("1088x1920", (H, W))):
        f = fgr[:, :hh, :ww].contiguous()
        a = alpha[:, :hh, :ww].contiguous()
        out = composite_rgba_packed(f, a)
        rows["composite_rgba_packed" + ("" if label == "480x864"
                                        else f" {label}")] = {"1 frame": dict(
            kernel=lambda f=f, a=a: composite_rgba_packed(f, a),
            plain=lambda f=f, a=a: composite_rgba_packed_plain(f, a),
            bytes=nbytes(f, a, out),
            # 3 products, 4 quantizes x 3 (clip, scale, round), 4 packs
            ops=a.numel() * (3 + 12 + 4), peak=F32_FLOPS_PER_S)}
    return rows


def rows_4k(inp):
    """Phase 6's rows of the kernels at the 4K path's launch shapes (one
    3840x2176 frame at pool 8; the GF kernel on the 15 coarse tiles)."""
    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    fr, gd, p, a, b = (inp[k] for k in ("frame", "guide", "p", "ma", "mb"))
    x = ingest_pool_normalize(fr, pool=8)
    ta, tb = guided_filter_coeffs(gd, p)
    packed = fused_refine_composite(fr, a, b, None, 8)
    px = fr.shape[1] * fr.shape[2]
    taps = 2 * (2 * 4 + 1)
    return {
        "ingest_pool_normalize (4K)": {"1 frame": dict(
            kernel=lambda: ingest_pool_normalize(fr, pool=8),
            plain=lambda: ingest_pool_normalize_plain(fr, pool=8),
            bytes=nbytes(fr, x), ops=fr.numel() + 4 * x.numel(),
            peak=F32_FLOPS_PER_S)},
        "guided_filter_coeffs (4K tiled)": {"1 frame": dict(
            kernel=lambda: guided_filter_coeffs(gd, p),
            plain=lambda: guided_filter_coeffs_plain(gd, p),
            bytes=nbytes(gd, p, ta, tb),
            ops=gd.numel() * (18 * taps + 5 + 18 + 24),
            peak=F32_FLOPS_PER_S)},
        "fused_refine_composite (4K)": {"1 frame": dict(
            kernel=lambda: fused_refine_composite(fr, a, b, None, 8),
            plain=lambda: fused_refine_composite_plain(fr, a, b, None, 8),
            bytes=nbytes(fr, a, b, packed),
            ops=px * (8 * 9 + 6 + 16 + 9 + 12), peak=F32_FLOPS_PER_S)},
    }


def time_case(case):
    """Cold-L2 times of one case of a row, beside its bound."""
    ms = time_cold(case["kernel"])
    plain_ms = time_cold(case["plain"], iters=10)
    lib_ms = time_cold(case["library"]) if "library" in case else None
    t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = case["ops"] / case["peak"] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=case["bytes"], ops=case["ops"])


def floor_line(moved):
    """What this harness reads for no work and for pure streaming: an
    empty kernel launch, and for each {label: bytes} a device-to-device
    copy_ that moves as many bytes (half read, half written). Not a
    library column: a copy is not the same function."""
    import torch

    res = {"empty_ms": time_cold(lambda: torch.cuda._sleep(0))}
    parts = [f"empty kernel launch {res['empty_ms']:.4f} ms"]
    for label, nb in moved.items():
        src = torch.ones(nb // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        ms = time_cold(lambda: dst.copy_(src))
        rate = 2 * src.numel() / (ms * 1e-3)
        res[label] = dict(copy_ms=ms, copy_bytes=2 * src.numel(),
                          copy_rate=rate)
        parts.append(
            f"copy_ moving {label}'s {2 * src.numel() / 1e6:.2f} MB "
            f"{ms:.4f} ms = {rate / 1e12:.3f} TB/s "
            f"({100 * rate / HBM_BYTES_PER_S:.1f}% of "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; bound "
            f"{2 * src.numel() / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    log(f"[6] floor (cold L2): {'; '.join(parts)}")
    return res


def phase_timing(inputs, sites, tail, bg_inputs, inp4k, inputs8, sites8):
    rows = tail_rows(inputs, bg_inputs, tail)
    rows.update(rows_4k(inp4k))
    rows.update(rows_n8(inputs8))
    chunk = f"{CHUNK} frames"
    n8 = f"{MS_STREAMS} frames"
    # A copy_ of the bytes of each bytes-bound tail row at its launch shape.
    floor = floor_line({
        f"{name} ({label})": rows[name][label]["bytes"]
        for name, label in (("fused_refine_composite", chunk),
                            ("ingest_pool_normalize", chunk),
                            ("fused_refine_float", "1 frame"),
                            ("composite_rgba_packed", "1 frame"),
                            ("composite_rgba_packed 1088x1920", "1 frame"),
                            ("int8_conv", "1 frame"),
                            ("ingest_pool_normalize (4K)", "1 frame"),
                            ("fused_refine_composite (4K)", "1 frame"),
                            ("ingest_pool_normalize (8 streams)", n8),
                            ("fused_refine_composite (8 streams)", n8),
                            ("fused_refine_float (8 streams)", n8))})
    out = {"floor": floor}
    for name, cases in rows.items():
        res = {label: time_case(case) for label, case in cases.items()}
        for label, t in res.items():
            lib = ("none computes the same function in one PyTorch call"
                   if t["library_ms"] is None
                   else f"cuDNN conv {t['library_ms']:.4f} ms")
            copy = floor.get(f"{name} ({label})")
            if copy:
                t["copy_ratio"] = t["ms"] / copy["copy_ms"]
            log(f"[6] {name} ({label}): {t['ms']:.4f} ms (cold L2), plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
                f"{t['bound_by']} ({t['bytes'] / 1e6:.2f} MB, "
                f"{t['ops'] / 1e6:.1f} Mop, {100 * t['bound_ms'] / t['ms']:.0f}"
                f"% of the bound"
                + (f", {t['copy_ratio']:.2f}x a copy_ of its bytes"
                   if copy else "") + f"); library call: {lib}")
        # The kernels line carries the shape the row's path launches (the
        # last case), and the one-frame time beside it where there is one.
        launch = list(res)[-1]
        out[name] = dict(res[launch], shape=launch)
        if "1 frame" in res:
            out[name].update(ms_1frame=res["1 frame"]["ms"],
                             bound_ms_1frame=res["1 frame"]["bound_ms"])
    out.update(time_sites(sites, "planar_sites.json"))
    out.update({f"{k} (8 streams)": v for k, v in time_sites(
        sites8, "planar_sites_8streams.json", f" x{MS_STREAMS}").items()})
    return out


def time_sites(sites, fname, tag=""):
    """Planar kernels: per call site, with the launch the tensor-core
    kernels chose there, then summed per kernel (one call at each of its
    sites: a chunk's encoder calls and one frame's decoder on the main
    path; the whole batch's at the multistream round). Operations count 2
    per multiply-add against the bf16 tensor-core peak; bytes against
    HBM. Writes the per-site rows to ``fname`` in OUT_DIR; returns {kernel
    name: summed row}."""
    ops = planar_ops()
    per_site = {}
    for site, (key, args) in sites.items():
        kern, plain = ops[key]
        nb, macs = site_cost(key, args)
        t_bytes = nb / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * macs / BF16_FLOPS_PER_S * 1e3
        row = dict(kernel=kern.__name__,
                   ms=time_cold(kernel_call(key, args)),
                   plain_ms=time_cold(lambda: plain(*args), iters=10),
                   library_ms=time_cold(library_call(key, args)),
                   t_bytes=t_bytes, t_ops=t_ops, bytes=nb, macs=macs,
                   plan=site_plan(key, args))
        per_site[site] = row
        p = row["plan"]
        plan = (f"; tile {p['tile']}"
                + (f", {p['nb']} output channels a block" if "nb" in p
                   else "")
                + f", {p['blocks']} blocks, {p['smem'] / 1024:.1f} KB shared")
        log(f"[6] {site + tag:8s} {kern.__name__:16s} {row['ms']:.4f} ms "
            f"(cold L2), plain {row['plain_ms']:.4f}, cuDNN conv(s) "
            f"{row['library_ms']:.4f}, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nb / 1e6:.2f} MB, {macs / 1e6:.1f} M MAC){plan}")
    out = {}
    for name in sorted({r["kernel"] for r in per_site.values()}):
        rs = [r for r in per_site.values() if r["kernel"] == name]
        t_bytes = sum(r["t_bytes"] for r in rs)
        t_ops = sum(r["t_ops"] for r in rs)
        out[name] = dict(
            ms=sum(r["ms"] for r in rs),
            plain_ms=sum(r["plain_ms"] for r in rs),
            library_ms=sum(r["library_ms"] for r in rs),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            sites=len(rs))
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        json.dump(per_site, f, indent=1)
    return out


# Kernel names of the port (the profiler's device events; a name matches
# its instantiations, e.g. planar_gru_kernel_mma<true>) and their files.
# The first six are the bf16 chunk body's; the float32 planar kernels
# follow (a name matches the first key it contains).
PORT_KERNELS = {"ingest_kernel": "ingest.cu", "gf_kernel": "gf_coeffs.cu",
                "refine_composite_kernel": "refine_composite.cu",
                "planar_conv_kernel_mma": "planar_conv.cu",
                "planar_conv2_kernel_mma": "planar_conv2.cu",
                "planar_gru_kernel_mma": "planar_gru.cu",
                "planar_conv_kernel": "planar_conv.cu",
                "planar_conv2_kernel": "planar_conv2.cu",
                "planar_gru_kernel": "planar_gru.cu"}
# The kernel each wrapper of the chunk body launches (one per call).
WRAPPER_KERNEL = {"ingest_pool_normalize": "ingest_kernel",
                  "guided_filter_coeffs": "gf_kernel",
                  "fused_refine_composite": "refine_composite_kernel",
                  "planar_conv": "planar_conv_kernel_mma",
                  "planar_conv2": "planar_conv2_kernel_mma",
                  "planar_conv_gru": "planar_gru_kernel_mma"}
LIBRARY_CONV = ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad",
                "dgrad", "nchwtonhwc", "nhwctonchw", "cutlass")


def device_ms(prof, by_kernel=None):
    """Device time (ms) in a profiler window: kernels, and copies (the
    memcpy and memset events), summed over the window."""
    import torch

    kern = copy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        if "memcpy" in ev.key.lower() or "memset" in ev.key.lower():
            copy += ms
        else:
            kern += ms
            ours = next((o for o in PORT_KERNELS if o in ev.key), None)
            if by_kernel is not None and ours:
                by_kernel[ours] = by_kernel.get(ours, 0.0) + ms
    return kern, copy


def settle():
    """Launch one small kernel that is not the port's, wait for the device,
    then 50 ms more. Inside a profiler window, before and after the work it
    reads: device events near the window's edges can go unrecorded (phase
    7 once lost the first 1.3 of 4 graph replays' kernels from a window
    opened right before them, and after the 50 ms wait alone the first
    replay's ingest, the window's first kernel)."""
    import torch

    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    time.sleep(0.05)


def kernels_after_pause(prof):
    """The device kernels of a profiler window after its longest pause
    between two port kernels (a settle()): invocations of each port
    kernel (PORT_KERNELS' keys) and the device ms of every kernel after
    it."""
    import torch

    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and "memcpy" not in ev.key.lower()
                  and "memset" not in ev.key.lower()),
                 key=lambda ev: ev.time_range.start)
    port = [ev for ev in evs if any(o in ev.key for o in PORT_KERNELS)]
    gap, cut = max((b.time_range.start - a.time_range.end, a.time_range.end)
                   for a, b in zip(port, port[1:]))
    seen, ms = {}, 0.0
    for ev in evs:
        if ev.time_range.start <= cut:
            continue
        ms += ev.time_range.elapsed_us() / 1e3
        ours = next((o for o in PORT_KERNELS if o in ev.key), None)
        if ours:
            seen[ours] = seen.get(ours, 0) + 1
    return seen, ms


def staging_rates():
    """Host copy rates behind the pipeline's staging on this machine: one
    1080p frame (6.2 MB) edge-padded by pad_into into a pinned and into a
    pageable (1088, 1920, 3) buffer; the same frame copied by numpy (one
    thread) and by PyTorch (its intra-op threads) into each, and by
    PyTorch with its 8 edge rows filled by a second copy_ (the same
    padding as pad_into at this size); an owned copy of one 2.1 MB alpha
    frame by numpy and by PyTorch. Median ms of 20 calls."""
    import numpy as np
    import torch

    from vidmat_torch.io.native import pad_into

    frame = clip(1, seed=9)[0][0]
    alpha = np.ascontiguousarray(frame[..., 0])
    pinned = torch.empty((H, W, 3), dtype=torch.uint8, pin_memory=True)
    bufs = {"pinned": pinned, "pageable": torch.empty((H, W, 3),
                                                      dtype=torch.uint8)}
    src = torch.from_numpy(frame)

    def ms(fn):
        fn()
        t = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            t.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(t))

    rows = {}
    for name, buf in bufs.items():
        arr = buf.numpy()
        rows[f"pad_into {name}"] = ms(lambda: pad_into(frame, arr))
        rows[f"numpy copy {name}"] = ms(
            lambda: np.copyto(arr[:FRAME_H], frame))
        rows[f"torch copy_ {name}"] = ms(lambda: buf[:FRAME_H].copy_(src))
        rows[f"torch copy_ + edge rows {name}"] = ms(lambda: (
            buf[:FRAME_H].copy_(src),
            buf[FRAME_H:].copy_(buf[FRAME_H - 1:FRAME_H].expand(
                H - FRAME_H, W, 3))))
    rows["owned alpha copy numpy"] = ms(lambda: np.array(alpha))
    rows["owned alpha copy torch"] = ms(
        lambda: torch.from_numpy(alpha).clone())
    log(f"    staging rates (1080p frame {frame.nbytes / 1e6:.1f} MB; "
        f"torch intra-op threads {torch.get_num_threads()}, os.cpu_count "
        f"{os.cpu_count()}), median ms: " + "; ".join(
            f"{k} {v:.3f}" for k, v in rows.items()))
    return rows


def phase_profile(net, dev):
    """Where a frame's time goes on the planar chunk body. (a) Host time of
    each stage, each waited, over 8 chunks, twice: the graph with the
    pipeline's staging (pad_into into a reused pinned chunk, one H2D, one
    replay, D2H into a reused pinned buffer). (b) Wall time of the body
    alone on device-resident chunks, eager and as graph replays, and
    device time by kernel group and kernel from torch.profiler (full table
    in chiprun_out/chip_smoke/profile.txt); fails if the planar body
    launches a library convolution or GEMM, or if the port kernels the
    device ran in 4 graph replays differ from the launches the wrappers
    book for them. (c) fps of convert_video over 64 frames, twice, each
    call building its network and bucket and capturing its graph: over
    run()'s window and over the whole call. (d) The device's busy share
    under VideoPipeline.run (what convert_video runs, its graph captured
    by a warm run): device time from the profiler over the run / the
    run's wall time."""
    import numpy as np
    import torch

    from vidmat_torch import convert_video
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.io.native import pad_into
    from vidmat_torch.io.reader import pad_frame
    from vidmat_torch.pipeline.graph import ChunkGraph
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.video import Downloads, Uploads, VideoPipeline

    mcfg, pcfg = preset_video_1080p()
    _, plan = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO,
                                 alpha_only=True)
    body = plan.chunk_body
    frames = clip(CHUNK, seed=3)[0]
    n = 8  # chunks
    st = plan.make_state(1)
    host = np.concatenate([pad_frame(f, H, W) for f in frames])
    dev_chunk = torch.from_numpy(host).to(dev)
    for _ in range(2):
        _, st = body(dev_chunk, st)
    up, outs = Uploads((CHUNK, H, W, 3), torch.uint8, dev), Downloads(
        CHUNK, dev)
    up.dev.copy_(dev_chunk)
    graph = ChunkGraph(body, up.dev, plan.make_state(1))
    torch.cuda.synchronize()

    gst = graph.state

    def new_chunk(t):
        nonlocal gst
        a = time.perf_counter()
        slot = up.slot().numpy()
        for i, f in enumerate(frames):
            pad_into(f, slot[i])
        b = time.perf_counter()
        up.send(CHUNK)
        c = time.perf_counter()
        out, gst = graph(gst)
        d = time.perf_counter()
        i = outs.open(out)
        outs.put(i, 0, out)
        handle = outs.close(i, CHUNK, False)
        outs.read(handle)
        outs.release(handle)
        e = time.perf_counter()
        for k, v in zip(t, (b - a, c - b, d - c, e - d)):
            t[k] += v

    rates = staging_rates()
    per = 1e3 / (n * CHUNK)
    split = []
    for _ in range(2):
        t = {"pad": 0.0, "h2d": 0.0, "body": 0.0, "d2h": 0.0}
        new_chunk(dict(t))  # one unrecorded chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            new_chunk(t)
        seq = (time.perf_counter() - t0) * per
        r = dict({k: v * per for k, v in t.items()}, seq=seq)
        split.append(r)
        log(f"[7] per frame, chunk {CHUNK}, graph with the pipeline's "
            f"staging, sequential (each stage waited): {r['seq']:.3f} ms = "
            + " + ".join(f"{lab} {r[k]:.3f}" for lab, k in zip(
                ("pad_into pinned slots", "H2D enqueue", "replay enqueue",
                 "D2H wait"), ("pad", "h2d", "body", "d2h"))))

    # (b) the body alone on a device-resident chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        _, st = body(dev_chunk, st)
    torch.cuda.synchronize()
    body_only = (time.perf_counter() - t0) * per
    up.dev.copy_(dev_chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        _, gst = graph(gst)
    torch.cuda.synchronize()
    graph_only = (time.perf_counter() - t0) * per

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        settle()
        for _ in range(4):
            _, st = body(dev_chunk, st)
        settle()
    avgs = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(avgs.table(sort_by="cuda_time_total", row_limit=60))
    groups = {"port kernels": 0.0, "library convolutions": 0.0,
              "other": 0.0}
    by_kernel, by_file = {}, {}
    library = []
    for ev in avgs:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / (4 * CHUNK) / 1e3
        ours = next((o for o in PORT_KERNELS if o in ev.key), None)
        if ours:
            groups["port kernels"] += ms
            by_kernel[ours] = by_kernel.get(ours, 0.0) + ms
            f = PORT_KERNELS[ours]
            by_file[f] = by_file.get(f, 0.0) + ms
        elif any(c in ev.key.lower() for c in LIBRARY_CONV):
            groups["library convolutions"] += ms
            library.append(ev.key)
        else:
            groups["other"] += ms
    dev_ms = sum(groups.values())
    # The launch counts the wrappers book per replay, held to the kernels
    # the device ran in 4 replays. The profiler drops the first kernel of
    # the first graph launch in a window now and then (the first replay's
    # ingest, in two windows of three on an H100 80GB HBM3), so the window
    # opens with a warm replay, then a 50 ms pause, and the 4 replays
    # after that pause are counted.
    booked = {WRAPPER_KERNEL[fn.__name__]: 4 * k
              for fn, k, _ in graph.per_replay}
    with torch.profiler.profile(activities=acts) as gprof:
        settle()
        _, gst = graph(gst)
        settle()
        for _ in range(4):
            _, gst = graph(gst)
        settle()
    ran, g_kern = kernels_after_pause(gprof)
    g_kern /= 4 * CHUNK
    log(f"    body alone on device-resident chunks: eager {body_only:.3f} "
        f"ms/frame wall, graph replays {graph_only:.3f} ms/frame wall; "
        f"device kernels (eager) {dev_ms:.3f} ms/frame (busy "
        f"{100 * dev_ms / body_only:.1f}% of the eager body's wall, "
        f"{100 * dev_ms / graph_only:.1f}% of the replays'): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    log(f"    graph replays under the profiler: device kernels "
        f"{g_kern:.3f} ms/frame; port kernel invocations in 4 replays "
        f"{dict(sorted(ran.items()))}, booked by the wrappers "
        f"{dict(sorted(booked.items()))}")
    log("    port kernels per frame: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sorted(by_kernel.items())))
    log("    port kernels per frame by file: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sorted(by_file.items())))
    assert dev_ms > 0, "the profiler saw no device time"
    assert not library, f"library convolutions on the planar body: {library}"
    assert all(k in by_kernel for k in list(PORT_KERNELS)[:6]), by_kernel
    assert set(booked) == set(list(PORT_KERNELS)[:6]), booked
    assert ran == booked, (ran, booked)

    # (c) convert_video, building its network and bucket and capturing
    # its graph in the call: fps over run()'s window (set-up and capture
    # in the first observation) and over the whole call.
    clip64 = clip(N_FRAMES, seed=0)[0]
    preset = dict(zip(("model_cfg", "pipe_cfg"), preset_video_1080p()))
    fps = []
    for _ in range(2):
        t0 = time.perf_counter()
        m = convert_video(clip64, output_alpha=lambda a: None, **preset)
        fps.append(dict(
            fps=m["fps"], wall_fps=N_FRAMES / (time.perf_counter() - t0),
            setup_ms=m["setup_ms"], graph_capture_ms=m["graph_capture_ms"]))
    log(f"    {N_FRAMES} frames alpha-only, convert_video fps (run()'s "
        f"window, set-up in it) / fps of the whole call: " + ", ".join(
            f"{r['fps']:.2f} / {r['wall_fps']:.2f} (set-up "
            f"{r['setup_ms']:.1f} ms, of which capture "
            f"{r['graph_capture_ms']:.1f})" for r in fps))

    # (d) the device's busy share under the run
    pipe = VideoPipeline(**preset, device=dev)
    pipe.run(clip64[:8], output_alpha=lambda a: None)  # builds, captures
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as rprof:
        settle()
        t0 = time.perf_counter()
        pipe.run(clip64, output_alpha=lambda a: None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        settle()
    kern, copy = device_ms(rprof)
    busy = dict(wall_ms=wall, kernels_ms=kern, copies_ms=copy,
                busy=(kern + copy) / wall)
    log(f"    busy share under convert_video ({N_FRAMES} frames, profiler "
        f"on): wall {wall:.1f} ms, device kernels {kern:.1f} ms + copies "
        f"{copy:.1f} ms = {100 * (kern + copy) / wall:.1f}% busy "
        f"({100 * kern / wall:.1f}% in kernels)")
    assert busy["busy"] > 0, busy
    with open(os.path.join(OUT_DIR, "profile_by_file.json"), "w") as f:
        json.dump(dict(by_file=by_file, groups=groups, body_ms=body_only,
                       graph_body_ms=graph_only, split=split, fps=fps,
                       busy=busy, staging_rates=rates), f, indent=1)


def phase_image(dev):
    """matte_image at 512x512 (the preset_pr1_image rung: float32, full
    resolution, no refinement) on the card for the base, trimap and plate
    families and a rough mask, each against the same call on the CPU
    (alpha and fgr MAD <= 1e-4), under PyTorch's default flags (cuDNN may
    take TF32; the port scopes its fp32 paths to full float32); ms per
    image through matte_image (weights loaded and the net built per call)
    and through a built ImageStepper. Then the fp32 repair:
    MattingSession(128, 192, dtype="float32") on the card against the CPU
    over 4 frames (max |d| <= 1e-4), with the port's scope and, logged
    beside it, with the scope removed (TF32 allowed)."""
    import numpy as np
    import torch

    from vidmat_torch import (MattingSession, ModelConfig, matte_image,
                              preset_pr1_image)
    from vidmat_torch import _device
    from vidmat_torch.io.fixtures import (synthetic_frame,
                                          synthetic_frames_only,
                                          synthetic_plate_frame)
    from vidmat_torch.models.weights import plate_default_config
    from vidmat_torch.pipeline.stepper import ImageStepper
    from vidmat_torch.pipeline.trimap import trimap_from_mask

    _, pcfg = preset_pr1_image()
    assert pcfg.dtype == "float32" and pcfg.refine.mode == "none"
    s = IMAGE_SIZE
    frame, gt = synthetic_frame(s, s, 0.3, seed=21)
    mask = np.where(gt[..., 0] > 0.5, 255, 0).astype(np.uint8)
    pframe, _, plate = synthetic_plate_frame(s, s, 0.2, seed=22)
    tri_cfg = ModelConfig(recurrent=False, use_trimap=True)
    cases = {
        "synthetic_demo": (frame, {}, ModelConfig()),
        "trimap_demo, trimap": (frame, dict(trimap=trimap_from_mask(mask)),
                                tri_cfg),
        "trimap_demo, mask": (frame, dict(mask=mask), tri_cfg),
        "plate_demo": (pframe, dict(bg_plate=plate), plate_default_config()),
    }
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False  # PyTorch's defaults
    res = {}
    try:
        for name, (img, kw, cfg) in cases.items():
            ca, cf = matte_image(img, device="cpu", **kw)
            ga, gf = matte_image(img, **kw)
            stepper = ImageStepper(cfg, device=dev)
            step_kw = dict(kw)
            if "mask" in step_kw:
                step_kw = dict(trimap=trimap_from_mask(step_kw.pop("mask")))
            stepper(img, **step_kw)
            t_call, t_step = [], []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                matte_image(img, **kw)
                t1 = time.perf_counter()
                stepper(img, **step_kw)
                t_step.append(time.perf_counter() - t1)
                t_call.append(t1 - t0)
            d_a, d_f = np.abs(ga - ca), np.abs(gf - cf)
            res[name] = dict(mad_alpha=float(d_a.mean()),
                             mad_fgr=float(d_f.mean()),
                             max_alpha=float(d_a.max()),
                             max_fgr=float(d_f.max()),
                             ms_call=1e3 * float(np.median(t_call)),
                             ms_stepper=1e3 * float(np.median(t_step)))
            r = res[name]
            log(f"[I] matte_image {s}x{s} {name}: card vs CPU alpha MAD "
                f"{r['mad_alpha']:.3g} (max {r['max_alpha']:.3g}), fgr MAD "
                f"{r['mad_fgr']:.3g} (max {r['max_fgr']:.3g}); "
                f"{r['ms_call']:.2f} ms per call, {r['ms_stepper']:.2f} ms "
                "per image on a built ImageStepper (H2D, forward, D2H)")
            assert ga.shape == (s, s, 1) and gf.shape == (s, s, 3)
            assert r["mad_alpha"] <= 1e-4 and r["mad_fgr"] <= 1e-4, (name, r)
            if "trimap" in name:
                tri = trimap_from_mask(mask)
                assert (ga[tri >= 0.75] == 1).all() and (
                    ga[tri <= 0.25] == 0).all()

        frames = list(synthetic_frames_only(128, 192, 4, seed=23))
        ref = MattingSession(128, 192, dtype="float32", device="cpu")
        want = [ref.step(f) for f in frames]

        def worst():
            sess = MattingSession(128, 192, dtype="float32", device=dev)
            d = [0.0, 0.0]
            for f, w in zip(frames, want):
                for j, (a, b) in enumerate(zip(sess.step(f), w)):
                    d[j] = max(d[j], float(np.abs(a - b).max()))
            return d

        scoped = worst()
        full_fp32 = _device.full_fp32
        _device.full_fp32 = contextlib.nullcontext
        try:
            tf32 = worst()
        finally:
            _device.full_fp32 = full_fp32
        log(f"    fp32 repair: MattingSession(128, 192, float32) card vs "
            f"CPU, 4 frames, max |d| alpha / fgr: full float32 (the port's "
            f"scope) {scoped[0]:.3g} / {scoped[1]:.3g}; TF32 allowed (scope "
            f"removed) {tf32[0]:.3g} / {tf32[1]:.3g}; process flags after: "
            f"cudnn.allow_tf32={cudnn.allow_tf32}, "
            f"matmul.allow_tf32={matmul.allow_tf32}")
        assert max(scoped) <= 1e-4, scoped
        assert cudnn.allow_tf32 and not matmul.allow_tf32
        res["fp32 repair"] = dict(scoped=scoped, tf32=tf32)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    return res


# The multistream preset (vidmat/config.py:196-207): 8 streams of
# 1088x1920, the video_1080p model at ratio 0.25, bf16, chunk 1: each round
# the per-frame body on an (8, 1088, 1920, 3) batch. Stream i shows frame
# (r + 2 i) mod 16 of a 16-frame synthetic clip at round r.
MS_STREAMS, MS_ROUNDS, MS_POOL = 8, 16, 16
GREEN = (0.0, 1.0, 0.0)
RT_FRAMES = 16


def stream_pool(n=MS_POOL, seed=21):
    """n synthetic 1920x1080 source frames and their ground-truth alphas,
    made on 4 host threads (numpy releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from vidmat_torch.io.fixtures import synthetic_frame

    with ThreadPoolExecutor(4) as ex:
        out = list(ex.map(lambda i: synthetic_frame(FRAME_H, FRAME_W, i / n,
                                                    seed), range(n)))
    return [f for f, _ in out], [a[..., 0] for _, a in out]


def ms_round(pool, r, s=MS_STREAMS):
    """Round r's source frames: stream i shows pool[(r + 2 i) mod n]."""
    return [pool[(r + 2 * i) % len(pool)] for i in range(s)]


def ms_batch(pool, r):
    """Round r as an (8, 1088, 1920, C) uint8 batch padded to the bucket."""
    from vidmat_torch.io.native import pad_stack

    return pad_stack(ms_round(pool, r), H, W)


def byte_diff(got, want):
    """(max |d|, values unequal, mean |d|) of two uint8 arrays."""
    import numpy as np

    unequal = int(np.count_nonzero(got != want))
    if not unequal:
        return 0, 0, 0.0
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), unequal, float(d.mean())


def ms_build(kernels=True, num_streams=MS_STREAMS, **kw):
    """MultiStreamMatting on the multistream preset (num_streams x
    1088x1920, fast_demo, ratio 0.25, bf16, chunk 1), with the options
    ``kw``. kernels=False: the same bodies on the plain versions (the
    class's build_serving_body called with kernels=False), every dispatch
    eager."""
    import vidmat_torch.parallel.multistream as msm
    from vidmat_torch import preset_multistream

    m, p, sc = preset_multistream()
    assert (sc.num_streams, sc.height, sc.width) == (MS_STREAMS, H, W), sc
    args = dict(cfg=m, downsample_ratio=sc.downsample_ratio,
                refine=p.refine, dtype=p.dtype, chunk=p.chunk_size)
    args.update(kw)
    if kernels:
        return msm.MultiStreamMatting(num_streams, sc.height, sc.width,
                                      **args)
    orig = msm.build_serving_body
    msm.build_serving_body = functools.partial(orig, kernels=False)
    try:
        twin = msm.MultiStreamMatting(num_streams, sc.height, sc.width,
                                      **args)
    finally:
        msm.build_serving_body = orig
    twin.capture = False
    return twin


def ms_steps(ms, batches, resets=None):
    """``ms.step`` over the rounds ``batches`` (K at a time at chunk K)
    with reset rows {round: streams}; returns each round's host outputs
    and each dispatch's seconds."""
    import numpy as np

    k, outs, secs = ms.chunk, [], []
    for r0 in range(0, len(batches), k):
        rows = np.zeros((k, ms.s), bool)
        for j in range(k):
            rows[j, list((resets or {}).get(r0 + j, ()))] = True
        t0 = time.perf_counter()
        if k == 1:
            outs.append(ms.step(batches[r0], rows[0]))
        else:
            a, o = ms.step(np.stack(batches[r0:r0 + k]), rows)
            outs.extend((a[j], o[j]) for j in range(k))
        secs.append(time.perf_counter() - t0)
    return outs, secs


def ms_path(label, kernels, batches, kw, one_streams=(3,), one_kw=None,
            plain_rounds=2, site_input=None):
    """One multistream serving path on ``batches``: the graph run (the
    first round eager, then the captured round replayed), its launches
    (counts set to 0 just before it and read just after: each replay's
    launches once per round), the same rounds through the eager bodies (0
    bytes unequal), the streams ``one_streams`` each through a one-stream
    instance (options ``one_kw(i)``, default ``kw``; bytes within 1), and
    the first ``plain_rounds`` rounds through the plain twin summing in
    the kernels' order (worst stream-frame mean |d| <= 0.5 LSB, max <=
    2). ``site_input(net)``: the net input of round 0 (coarse, s2d
    padded), for a model whose planar sites phase 2 does not hold at N =
    8: each planar call of its round against the sequential order (0 bf16
    values unequal). Logs and returns the numbers and the graph run's
    outputs."""
    import numpy as np

    from vidmat_torch.ops.refine import fused_refine_composite

    ms = ms_build(**kw)
    zero_counts(kernels)
    outs, secs = ms_steps(ms, batches)
    launches = counts(kernels)
    modes = {k: v for k, v in fused_refine_composite.mode_launches.items()
             if v}
    g = ms._shards[0].graphs[ms.chunk]
    per = g.launches_per_replay()
    rounds = len(batches)
    assert {k: v * rounds for k, v in per.items()} == {
        k: v for k, v in launches.items() if v}, (label, per, launches)
    fps = MS_STREAMS * (rounds - 1) / sum(secs[1:])

    eager = ms_build(**kw)
    eager.capture = False
    e_outs, e_secs = ms_steps(eager, batches)
    assert not eager._shards[0].graphs
    unequal = sum(byte_diff(g_, e_)[1] for o, e in zip(outs, e_outs)
                  for g_, e_ in zip(o, e))
    e_fps = MS_STREAMS * (rounds - 1) / sum(e_secs[1:])
    del e_outs

    one_max = one_unequal = 0
    for i in one_streams:
        one = ms_build(num_streams=1, **(one_kw(i) if one_kw else kw))
        for r, b in enumerate(batches):
            for g_, w in zip(one.step(b[i:i + 1]), outs[r]):
                m, u, _ = byte_diff(g_[0], w[i])
                one_max, one_unequal = max(one_max, m), one_unequal + u

    twin = ms_build(kernels=False, **kw)
    worst_mean = worst_max = 0.0
    with sequential_twins():
        for r in range(plain_rounds):
            for g_, w in zip(twin.step(batches[r]), outs[r]):
                for i in range(MS_STREAMS):
                    m, _, mean = byte_diff(w[i], g_[i])
                    worst_mean = max(worst_mean, mean)
                    worst_max = max(worst_max, m)
    log(f"[M] ({label}) {rounds} rounds of {MS_STREAMS} x {W}x{H}: "
        f"{fps:.2f} frames/s aggregate ({fps / MS_STREAMS:.2f} a stream) "
        f"over the rounds after the first (which took "
        f"{1e3 * secs[0]:.1f} ms: the eager warm-up and the capture, "
        f"{ms.capture_ms:.1f} ms), eager bodies {e_fps:.2f}; launches "
        f"per replay {per}, refine modes {modes}; bytes unequal to the "
        f"eager bodies {unequal}; streams {list(one_streams)} through a "
        f"one-stream instance: max |d| {one_max}, {one_unequal} bytes "
        f"unequal; plain twin (sequential order), {plain_rounds} rounds: "
        f"worst stream-frame mean |d| {worst_mean:.4g}, max {worst_max}")
    assert unequal == 0, (label, unequal)
    assert one_max <= 1, (label, one_max)
    assert worst_mean <= 0.5 and worst_max <= 2, (label, worst_mean,
                                                    worst_max)
    for o in outs[0]:
        assert o.dtype == np.uint8 and o.shape[:3] == (MS_STREAMS, H, W)
    if site_input is not None:
        import torch

        from vidmat_torch.models.weights import (build_network,
                                                 default_variables)

        net = build_network(kw["cfg"], default_variables(kw["cfg"]),
                            dtype=torch.bfloat16, device="cuda")
        sites = capture_sites(net, None, site_input(net), batch_decode=True)
        site_unequal = {}
        for site, (key, args) in sites.items():
            _, u, _ = check_planar(key, args)
            site_unequal[site] = u
        log(f"    ({label}) planar sites at N = {MS_STREAMS}, bf16 values "
            f"unequal to the sequential order: {site_unequal}")
        assert not any(site_unequal.values()), site_unequal
    GRAPHS[f"M: {label}"] = dict(
        per_replay=per, capture_ms=ms.capture_ms, fps=fps, eager_fps=e_fps,
        first_round_ms=1e3 * secs[0], rounds=rounds, unequal=unequal,
        one_stream_max=one_max, one_stream_unequal=one_unequal,
        plain_mean=worst_mean, plain_max=worst_max)
    return dict(GRAPHS[f"M: {label}"], launches=launches, modes=modes,
                outs=outs, ms=ms)


def ms_split(ms, pool, rounds):
    """Per round ms of the captured round's stages, each waited: "pad" (the
    8 source frames edge-padded into the pinned slot), "h2d", "enqueue"
    (the replay's host time), "replay" (waited on the device), "d2h" (the
    packed words into pinned buffers, waited) and "unpack" (to owned
    RGBA on the host)."""
    import numpy as np
    import torch

    from vidmat_torch.io.native import unpack_rgba

    t = dict(pad=0.0, h2d=0.0, enqueue=0.0, replay=0.0, d2h=0.0,
             unpack=0.0)
    reset = np.zeros(ms.s, bool)
    sh = ms._shards[0]
    downs = sh.staging(1)[2]
    for r in range(rounds):
        a = time.perf_counter()
        ms._stage(1, [ms_round(pool, r)], reset)
        b = time.perf_counter()
        sh.send(1)
        torch.cuda.synchronize()
        c = time.perf_counter()
        out = sh.run(1)
        d = time.perf_counter()
        torch.cuda.synchronize()
        e = time.perf_counter()
        i = downs.open(out)
        downs.put(i, 0, out)
        handle = downs.close(i, out.shape[0], False)
        arr = downs.read(handle)
        f = time.perf_counter()
        unpack_rgba(arr)
        downs.release(handle)
        g = time.perf_counter()
        for k, v in zip(t, (b - a, c - b, d - c, e - d, f - e, g - f)):
            t[k] += v
    return {k: 1e3 * v / rounds for k, v in t.items()}


def phase_multistream(kernels, gpu, dev, pool):
    """Phase M: MultiStreamMatting on the multistream preset, 8 streams of
    1088x1920 (fast_demo, ratio 0.25, bf16, chunk 1), one graph replay a
    round. (a) bg_color, the packed fused tail, 16 rounds: fps, the stages
    of a round, every stream against a one-stream instance; (b) no
    background (the float tail at N = 8), 8 rounds; (c) chunk 4 against
    chunk 1 with resets planted mid-chunk (0 bytes unequal); (d) reset
    isolation (the streams not reset equal the run without resets, 0
    bytes unequal; a reset stream equals a fresh one-stream instance
    from its reset on, within 1); (e) serve on 8 sources of 24 frames (10
    for two of them); (f) bg_blur=16, trimap_demo on 4-channel frames and
    plate_demo with a plate per stream, 4 rounds each. Each path through
    ms_path's checks. Returns the numbers."""
    import dataclasses

    import numpy as np
    import torch

    from vidmat_torch import ModelConfig
    from vidmat_torch.io.native import pad_stack
    from vidmat_torch.models.weights import plate_default_config

    frames, alphas = pool
    batches = [ms_batch(frames, r) for r in range(MS_ROUNDS)]
    res = {}
    a = ms_path("a: bg_color, packed tail", kernels, batches,
                dict(bg_color=GREEN), one_streams=range(MS_STREAMS))
    res["a"] = a
    assert a["modes"].get("color") == MS_ROUNDS, a["modes"]
    for name in ("ingest_pool_normalize", "guided_filter_coeffs",
                 "fused_refine_composite", "planar_conv", "planar_conv2",
                 "planar_conv_gru"):
        assert a["launches"][name] > 0, (name, a["launches"])
    split = [ms_split(a["ms"], frames, MS_ROUNDS) for _ in range(2)]
    for sp in split:
        log(f"    per round (8 frames), graph, each stage waited: "
            f"{sum(sp.values()):.3f} ms = pad into the pinned slot "
            f"{sp['pad']:.3f} + H2D {sp['h2d']:.3f} + replay enqueue "
            f"{sp['enqueue']:.3f} + replay (device) {sp['replay']:.3f} + "
            f"D2H wait {sp['d2h']:.3f} + unpack {sp['unpack']:.3f} "
            f"({gpu})")
    res["split"] = split

    b = ms_path("b: no background, float tail", kernels, batches[:8], {})
    assert b["launches"]["fused_refine_float"] == 8, b["launches"]
    assert b["launches"]["fused_refine_composite"] == 0, b["launches"]
    assert b["outs"][0][1].shape == (MS_STREAMS, H, W, 3)
    res["b"] = b
    del b["outs"]

    # (d) resets at rounds 2 (stream 6) and 5 (stream 3); (c) the same
    # through chunk 4 (both mid-chunk).
    resets = {2: (6,), 5: (3,)}
    reset_at = {6: 2, 3: 5}
    d_outs, _ = ms_steps(ms_build(bg_color=GREEN), batches[:8], resets)
    kept = reset_unequal = 0
    one_max = one_unequal = 0
    for i in range(MS_STREAMS):
        start = reset_at.get(i, 8)
        for r in range(start):
            kept += sum(byte_diff(x[i], y[i])[1]
                        for x, y in zip(d_outs[r], a["outs"][r]))
        if start < 8:
            one = ms_build(num_streams=1, bg_color=GREEN)
            for r in range(start, 8):
                for x, y in zip(one.step(batches[r][i:i + 1]), d_outs[r]):
                    m, u, _ = byte_diff(x[0], y[i])
                    one_max, one_unequal = max(one_max, m), one_unequal + u
    log(f"[M] (d: reset isolation) streams 6 and 3 reset at rounds 2 and "
        f"5 of 8: bytes unequal to the run without resets, before each "
        f"stream's reset and on the streams not reset: {kept}; the reset "
        f"streams from their reset on against a fresh one-stream "
        f"instance: max |d| {one_max}, {one_unequal} bytes unequal")
    assert kept == 0 and one_max <= 1, (kept, one_max)
    c = ms_build(bg_color=GREEN, chunk=4)
    zero_counts(kernels)
    c_outs, _ = ms_steps(c, batches[:8], resets)
    c_launches = counts(kernels)
    c_unequal = sum(byte_diff(x, y)[1] for o, p in zip(c_outs, d_outs)
                    for x, y in zip(o, p))
    c_per = c._shards[0].graphs[4].launches_per_replay()
    log(f"[M] (c: chunk 4) 2 dispatches of 4 rounds (the first eager, the "
        f"second one replay of the 4-round graph, capture "
        f"{c.capture_ms:.1f} ms, launches per replay {c_per}) against "
        f"chunk 1, the same resets: {c_unequal} bytes unequal; launches "
        f"{c_launches}")
    assert c_unequal == 0, c_unequal
    assert {k: 2 * v for k, v in c_per.items()} == {
        k: v for k, v in c_launches.items() if v}, (c_per, c_launches)
    GRAPHS["M: c: chunk 4"] = dict(per_replay=c_per,
                                   capture_ms=c.capture_ms,
                                   unequal=c_unequal)
    del d_outs, c_outs

    # (e) serve: streams 6 and 7 end after 10 frames. Rounds before 16
    # show the frames of (a)'s rounds: their bytes must equal (a)'s.
    lengths = [24] * 6 + [10] * 2
    srcs = [[frames[(r + 2 * i) % len(frames)] for r in range(n)]
            for i, n in enumerate(lengths)]
    got = {i: [] for i in range(MS_STREAMS)}
    mism = []

    def on_output(i, n, alpha, out):
        got[i].append(n)
        if n < MS_ROUNDS:
            mism.append(byte_diff(out, a["outs"][n][1][i])[1]
                        + byte_diff(alpha, a["outs"][n][0][i])[1])

    e = ms_build(bg_color=GREEN)
    t0 = time.perf_counter()
    summary = e.serve(srcs, on_output=on_output)
    wall = time.perf_counter() - t0
    log(f"[M] (e: serve) 8 sources of {lengths} {FRAME_W}x{FRAME_H} "
        f"frames: "
        f"{summary['stream_fps']:.2f} frames/s aggregate "
        f"({summary['fps']:.2f} rounds/s, p50 {summary['p50_ms']:.3f} ms, "
        f"p99 {summary['p99_ms']:.3f} ms a round, first round included), "
        f"wall {wall:.2f} s; batch_steps {summary['batch_steps']}; frames "
        f"delivered {[len(v) for v in got.values()]}; bytes unequal to "
        f"(a)'s rounds {sum(mism)} ({gpu})")
    # The round in which the last streams end still runs (their slots
    # recycle with a reset flag) and delivers nothing, as in the JAX
    # package.
    assert summary["batch_steps"] == max(lengths) + 1, summary
    assert summary["stream_fps"] == summary["fps"] * MS_STREAMS, summary
    assert all(got[i] == list(range(n)) for i, n in enumerate(lengths)), got
    assert sum(mism) == 0 and len(mism) == sum(min(n, MS_ROUNDS)
                                               for n in lengths)
    res["e"] = dict(summary=summary, wall=wall)
    del a["outs"]

    # (f) 4 rounds each.
    blur = ms_path("f: bg_blur=16", kernels, batches[:4], dict(bg_blur=16))
    assert blur["modes"].get("coarse") == 4, blur["modes"]
    tri_cfg = ModelConfig(use_trimap=True, recurrent=False,
                          conv_impl="planar")

    def with_trimap(r):
        src = ms_round(frames, r)
        al = ms_round(alphas, r)
        tri = [np.where(x > 0.99, 255, np.where(x < 0.01, 0, 128)).astype(
            np.uint8)[..., None] for x in al]
        return pad_stack([np.concatenate([f, t], -1)
                          for f, t in zip(src, tri)], H, W)

    tri_batches = [with_trimap(r) for r in range(4)]
    tri = ms_path("f: trimap_demo, 4-channel frames", kernels, tri_batches,
                  dict(cfg=tri_cfg, bg_color=GREEN),
                  site_input=lambda net: coarse_input(
                      net, torch.from_numpy(tri_batches[0]).cuda()))
    plate_cfg = dataclasses.replace(plate_default_config(),
                                    conv_impl="planar")
    plates = pad_stack([frames[2 * i + 1] for i in range(MS_STREAMS)], H,
                       W)
    plate = ms_path("f: plate_demo, a plate per stream", kernels,
                    batches[:4], dict(cfg=plate_cfg, bg_color=GREEN,
                                      bg_plate=plates),
                    one_kw=lambda i: dict(cfg=plate_cfg, bg_color=GREEN,
                                          bg_plate=plates[i]),
                    site_input=lambda net: plate_input(
                        net, torch.from_numpy(batches[0]).cuda(),
                        torch.from_numpy(plates).cuda()))
    for r in (blur, tri, plate):
        del r["outs"], r["ms"]
    res["f"] = dict(blur=blur, trimap=tri, plate=plate)
    del a["ms"]
    return res


def phase_realtime(kernels, gpu, dev, pool):
    """Phase R: RealtimeMatting(1080, 1920) on the video_1080p model at
    ratio 0.25 in bf16 (ingest, planar net, GF, fused_refine_float; the
    step captured at the warm-up). (a) A lockstep source (frame t+1 only
    after frame t came out, so none is dropped): alpha and composite
    bytes equal to a VideoStepper stepped frame by frame with the same
    finish, launches (counts set to 0 just before); (b) an unpaced
    64-frame source; (c) a source paced at 30 fps: 0 dropped. Logs
    produced, processed, dropped and p50 / p99 ms."""
    import threading

    import numpy as np

    from vidmat_torch import RealtimeMatting, preset_video_1080p
    from vidmat_torch.pipeline.stepper import VideoStepper

    frames = pool[0]
    mcfg = preset_video_1080p()[0]
    rt = RealtimeMatting(FRAME_H, FRAME_W, model_cfg=mcfg,
                         downsample_ratio=RATIO, dtype="bfloat16")
    got, done = [], threading.Event()

    def lockstep():
        for f in frames[:RT_FRAMES]:
            yield f
            if not done.wait(60.0):
                raise TimeoutError("no output within 60 s")
            done.clear()

    def on_frame(a8, comp):
        got.append((a8, comp))
        done.set()

    zero_counts(kernels)
    sa = rt.run(lockstep(), on_frame=on_frame)
    launches = counts(kernels)
    per = rt._stepper._graph.launches_per_replay()
    # The warm-up's eager step launches as a replay does.
    want = expect(kernels, dict(PLANAR_PER_FRAME, ingest_pool_normalize=1,
                                guided_filter_coeffs=1, fused_refine_float=1),
                  RT_FRAMES + 1)
    st = VideoStepper(mcfg, H, W, downsample_ratio=RATIO, dtype="bfloat16",
                      device=dev)
    unequal = 0
    for f, (a8, comp) in zip(frames, got):
        wa, wc = rt._finish(*st.step_device(f))
        unequal += int((wa != a8).sum()) + int((wc != comp).sum())
        assert a8.shape == (FRAME_H, FRAME_W) and comp.shape == (
            FRAME_H, FRAME_W, 3)
    rt.reset()
    sb = rt.run([frames[j % len(frames)] for j in range(64)])
    rt.reset()
    sc = rt.run([frames[j % len(frames)] for j in range(32)], pace_fps=30.0)

    def line(s):
        return (f"produced {s['produced']}, processed {s['processed']}, "
                f"dropped {s['dropped']}, {s['achieved_fps']:.2f} fps, "
                f"p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms")

    log(f"[R] RealtimeMatting 1920x1080 (bucket {W}x{H}) video_1080p bf16: "
        f"(a) lockstep {RT_FRAMES} frames: {line(sa)}; alpha and composite "
        f"bytes unequal to a VideoStepper with the same finish {unequal}; "
        f"launches {launches} (per replay {per}, capture "
        f"{rt._stepper.capture_ms:.1f} ms); (b) unpaced 64 frames: "
        f"{line(sb)}; (c) paced 30 fps, 32 frames: {line(sc)} ({gpu})")
    assert sa["dropped"] == 0 and sa["processed"] == RT_FRAMES, sa
    assert launches == want, (launches, want)
    assert unequal == 0, unequal
    assert sb["produced"] == 64 and sb["processed"] + sb["dropped"] == 64
    assert sc["dropped"] == 0 and sc["processed"] == 32, sc
    GRAPHS["R: realtime step"] = dict(per_replay=per,
                                      capture_ms=rt._stepper.capture_ms,
                                      lockstep=sa, unpaced=sb, paced=sc,
                                      unequal=unequal)
    return dict(launches=launches, lockstep=sa, unpaced=sb, paced=sc)


# Phase P (A.12 over several positions): the multistream preset split
# over two positions of the card (two streams of it), the 2-stage pipeline
# of the video_1080p model on two positions, PipelinedStreams(2) on four,
# and the command line's multistream --pp, which needs two cards a stream.
PP_FRAMES = 30


def position_kernel_checks(net, batch, label):
    """Phase 2's checks at a mesh position's launch shape (``batch``: the
    (N, 1088, 1920, 3) uint8 frames on the card it serves): ingest
    bit-exact, the planar kernels at the per-frame body's 9 sites over
    the batch (the decoder on a carry that is not zero) with 0 bf16
    values unequal to the sequential order, GF bit-exact in one launch,
    the packed tail over a color and in coarse mode (bg_blur=16) within 1
    byte. Returns {kernel: max |d|}."""
    import torch

    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
    from vidmat_torch.ops.guided_filter import box_blur, gray_guide
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    x = ingest_pool_normalize(batch, pool=4)
    want = ingest_pool_normalize_plain(batch, pool=4)
    assert torch.equal(x, want), f"ingest at {label}: not bit-exact"
    errs = {"ingest_pool_normalize": 0.0}
    xp = coarse_input(net, batch)
    unequal = {}
    for site, (key, args) in capture_sites(net, None, xp,
                                           batch_decode=True).items():
        e, u, _ = check_planar(key, args)
        name = planar_ops()[key][0].__name__
        errs[name] = max(errs.get(name, 0.0), e)
        unequal[site] = u
    assert not any(unequal.values()), (label, unequal)
    nh, nw = x.shape[1:3]
    with torch.inference_mode():
        st = net.init_state(batch.shape[0], *xp.shape[1:3])
        alpha, fgr, _ = net(xp, st, plain=True)
    guide = gray_guide(want.float()).contiguous()
    p = torch.cat([alpha[:, :nh, :nw], fgr[:, :nh, :nw]], -1).float()
    # One launch (phase 2 checks it allocates no scratch: the allocator's
    # peak, which cached blocks of earlier phases blur here).
    n0 = guided_filter_coeffs.launches
    ka, kb = guided_filter_coeffs(guide, p.contiguous())
    assert guided_filter_coeffs.launches == n0 + 1, label
    ma, mb = guided_filter_coeffs_plain(guide, p.contiguous())
    assert torch.equal(ka, ma) and torch.equal(kb, mb), f"GF at {label}"
    errs["guided_filter_coeffs"] = 0.0
    for mode, bg in (("color", GREEN), ("coarse", box_blur(want.float(),
                                                           4))):
        k = fused_refine_composite(batch, ma, mb, bg, 4)
        q = fused_refine_composite_plain(batch, ma, mb, bg, 4)
        d = int((k.view(torch.uint8).int()
                 - q.view(torch.uint8).int()).abs().max())
        errs["fused_refine_composite"] = max(
            errs.get("fused_refine_composite", 0.0), float(d))
        assert d <= 1, (label, mode, d)
    torch.cuda.synchronize()
    log(f"    [P] kernels at {label} against plain: {json.dumps(errs)}; "
        f"bf16 planar values unequal to the sequential order {unequal}")
    return errs


def device_ring_fps(run, batches, streams, n=32):
    """Frames a second of ``run(device batch)`` chained over n dispatches
    between two synchronizations (after two warm-up dispatches: the eager
    one and the capture)."""
    import torch

    ring = [torch.from_numpy(b).cuda() for b in batches[:4]]
    for i in range(2):
        run(ring[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        run(ring[i % 4])
    torch.cuda.synchronize()
    return streams * n / (time.perf_counter() - t0)


def phase_pp(kernels, gpu, dev, net, pool):
    """Phase P: A.12's serving over several positions, positions repeating
    the card (two CUDA streams of it). (a) make_mesh over the visible
    cards and over two positions of cuda:0; (b) MultiStreamMatting on the
    multistream preset, 8 x 1088x1920, split over two positions, 16
    rounds: every byte within 1 of the one-position instance, graph
    replays equal to the eager bodies (0 bytes unequal), launches per
    position, aggregate fps host-fed and device-resident beside the
    one-position instance's; (c) PipelinedMatting(1088, 1920) on the
    video_1080p model over a color, step / flush over 30 frames and
    convert at chunk 1 and 4 (30 frames: not a multiple of 4): every
    frame within 1 of a one-stream MultiStreamMatting, the one-frame
    skew, launches per position; t_stage0, t_stage1 and the composed
    body (vidmat_torch/tools/bench_pp_stages.py), the pipelined rate on
    two positions beside one position's; (d) PipelinedStreams(2) on four
    positions, 8 rounds, over a color and with bg_blur=16: within 1 of
    the 2-stream instance, coarse-mode launches counted; (e) python -m
    vidmat_torch.cli multistream --pp on one card exits naming the cards
    it needs. The kernels at the positions' launch shapes (4 streams a
    position; 1 frame a stage) against their plain versions. Returns the
    numbers."""
    import io

    import numpy as np
    import torch

    from vidmat_torch import cli, preset_video_1080p
    from vidmat_torch.models.weights import default_variables
    from vidmat_torch.ops.refine import fused_refine_composite
    from vidmat_torch.parallel.mesh import make_mesh
    from vidmat_torch.parallel.multistream import MultiStreamMatting
    from vidmat_torch.parallel.pp import PipelinedMatting, PipelinedStreams
    from vidmat_torch.tools import bench_pp_stages

    t_phase = time.perf_counter()
    res = {}
    every = make_mesh()
    assert every.size == torch.cuda.device_count() and all(
        d.type == "cuda" for d in every.devices.flat), every
    two = make_mesh(("stream",), devices=["cuda:0"] * 2)
    assert list(two.devices) == [torch.device("cuda", 0)] * 2, two
    try:
        make_mesh(("stream", "pp"), (3, 2), devices=["cuda:0"] * 4)
        raise AssertionError("a 3x2 mesh over 4 devices did not raise")
    except ValueError as e:
        assert "!= 4 devices" in str(e), e
    log(f"[P] (a) make_mesh(): {every}; two positions: {two}")

    frames, _ = pool
    batches = [ms_batch(frames, r) for r in range(MS_ROUNDS)]
    errs = position_kernel_checks(
        net, torch.from_numpy(batches[0][:MS_STREAMS // 2]).cuda(),
        f"{MS_STREAMS // 2} x {W}x{H} (a meshed round's position)")
    one = ms_build(bg_color=GREEN)
    one_outs, one_secs = ms_steps(one, batches)
    meshed = ms_build(bg_color=GREEN, mesh=two)
    zero_counts(kernels)
    outs, secs = ms_steps(meshed, batches)
    launches = {k: v for k, v in counts(kernels).items() if v}
    per_pos = [dict(p.launches) for p in meshed.positions]
    per_replay = [sh.graphs[1].launches_per_replay()
                  for sh in meshed._shards]
    assert {k: sum(p.get(k, 0) for p in per_pos)
            for k in launches} == launches, (per_pos, launches)
    for p, rep in zip(per_pos, per_replay):
        assert p == {k: v * MS_ROUNDS for k, v in rep.items()}, (p, rep)
        for name in ("ingest_pool_normalize", "guided_filter_coeffs",
                     "fused_refine_composite", "planar_conv",
                     "planar_conv2", "planar_conv_gru"):
            assert p.get(name, 0) > 0, (name, p)
    one_max = max(byte_diff(g, w)[0] for o, q in zip(outs, one_outs)
                  for g, w in zip(o, q))
    eager = ms_build(bg_color=GREEN, mesh=two)
    eager.capture = False
    e_outs, _ = ms_steps(eager, batches)
    unequal = sum(byte_diff(g, w)[1] for o, q in zip(outs, e_outs)
                  for g, w in zip(o, q))
    fps = MS_STREAMS * (MS_ROUNDS - 1) / sum(secs[1:])
    one_fps = MS_STREAMS * (MS_ROUNDS - 1) / sum(one_secs[1:])
    reset = torch.zeros(MS_STREAMS, dtype=torch.uint8, device=dev)
    ring = {name: device_ring_fps(lambda b, m=m: m.step_device(b, reset),
                                  batches, MS_STREAMS)
            for name, m in (("two positions", meshed),
                            ("one position", one))}
    del outs, one_outs, e_outs
    log(f"[P] (b) MultiStreamMatting multistream preset, {MS_STREAMS} x "
        f"{W}x{H} over two positions of cuda:0, {MS_ROUNDS} rounds: max "
        f"|d| to the one-position instance {one_max}; bytes unequal to the "
        f"eager bodies {unequal}; launches per position {per_pos} (per "
        f"replay {per_replay}); capture {meshed.capture_ms:.1f} ms; "
        f"host-fed {fps:.2f} frames/s aggregate (one position {one_fps:.2f}, "
        f"ratio {fps / one_fps:.3f}); device-resident ring {ring} ({gpu})")
    assert one_max <= 1 and unequal == 0, (one_max, unequal)
    GRAPHS["P: multistream over 2 positions"] = dict(
        per_replay=per_replay, capture_ms=meshed.capture_ms, fps=fps,
        one_position_fps=one_fps, ring_fps=ring, one_max=one_max,
        unequal=unequal)
    res["b"] = dict(launches=per_pos, fps=fps, one_fps=one_fps, ring=ring)
    del meshed, eager, one

    mcfg, pcfg = preset_video_1080p()
    kw = dict(cfg=mcfg, variables=default_variables(mcfg),
              downsample_ratio=pcfg.downsample_ratio, refine=pcfg.refine)
    pp2 = make_mesh(("pp",), devices=["cuda:0"] * 2)
    clip = [batches[r % MS_ROUNDS][r // MS_ROUNDS] for r in range(PP_FRAMES)]
    for name, e in position_kernel_checks(
            net, torch.from_numpy(clip[0][None]).cuda(),
            f"1 x {W}x{H} (a stage's position)").items():
        errs[name] = max(errs[name], e)
    one = MultiStreamMatting(1, H, W, device=dev, bg_color=GREEN, **kw)
    t0 = time.perf_counter()
    ref = [one.step(f[None]) for f in clip]
    one_fps = PP_FRAMES / (time.perf_counter() - t0)
    pp = PipelinedMatting(H, W, pp2, bg_color=GREEN, **kw)
    zero_counts(kernels)
    got = [pp.step(f) for f in clip]
    assert got[0] is None and all(g is not None for g in got[1:])
    got = got[1:] + [pp.flush()]
    launches = {k: v for k, v in counts(kernels).items() if v}
    per_pos = [dict(p.launches) for p in pp.positions]
    assert per_pos[1] == {"fused_refine_composite": PP_FRAMES + 1}, per_pos
    assert set(per_pos[0]) == {"ingest_pool_normalize",
                               "guided_filter_coeffs", "planar_conv",
                               "planar_conv2", "planar_conv_gru"}, per_pos
    assert {k: sum(p.get(k, 0) for p in per_pos)
            for k in launches} == launches, (per_pos, launches)
    primed = pp.step(clip[0]) is not None
    step_max = max(byte_diff(g[i], w[i][0])[0] for g, w in zip(got, ref)
                   for i in range(2))
    conv = {}
    for k in (1, 4):
        ppk = pp if k == 1 else PipelinedMatting(H, W, pp2, bg_color=GREEN,
                                                 chunk=k, **kw)
        for n in (PP_FRAMES, 8):
            t0 = time.perf_counter()
            outs = list(ppk.convert(clip[:n]))
            secs = time.perf_counter() - t0
            assert len(outs) == n, (k, n, len(outs))
            d = max(byte_diff(g[i], w[i][0])[0] for g, w in zip(outs, ref)
                    for i in range(2))
            conv[f"chunk {k}, {n} frames"] = dict(max=d, fps=n / secs)
            assert d <= 1, (k, n, d)
    row = pp._rows[0]
    g0, g1 = row.g0, row.g1
    log(f"[P] (c) PipelinedMatting({H}, {W}) video_1080p over a color on "
        f"two positions of cuda:0: step / flush over {PP_FRAMES} frames "
        f"(the first step None, each later one the frame before): max |d| "
        f"to a one-stream MultiStreamMatting {step_max}; a step after the "
        f"flush returns at once: {primed}; launches per position {per_pos}"
        f" (per replay: stage 0 {g0.launches_per_replay()}, stage 1 "
        f"{g1.launches_per_replay()}; capture ms {row.capture_ms}); "
        f"convert {conv}; host-fed one-stream "
        f"MultiStreamMatting {one_fps:.2f} fps ({gpu})")
    assert step_max <= 1 and primed, (step_max, primed)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_pp_stages.main(["--chunk", "4", "--repeats", "5"])
    stages = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"[P] (c) vidmat_torch/tools/bench_pp_stages.py: "
        f"{json.dumps(stages)}")
    GRAPHS["P: PipelinedMatting stage 0"] = dict(
        per_replay=g0.launches_per_replay(), capture_ms=row.capture_ms[0],
        fps=conv[f"chunk 1, {PP_FRAMES} frames"]["fps"],
        one_position_fps=one_fps)
    GRAPHS["P: PipelinedMatting stage 1"] = dict(
        per_replay=g1.launches_per_replay(), capture_ms=row.capture_ms[1])
    res["c"] = dict(launches=per_pos, convert=conv, one_fps=one_fps,
                    stages=stages)
    del pp, one, ref

    four = make_mesh(("stream", "pp"), (2, 2), devices=["cuda:0"] * 4)
    rounds = [b[:2] for b in batches[:8]]
    res["d"] = {}
    for label, extra in (("color", dict(bg_color=GREEN)),
                         ("bg_blur=16", dict(bg_blur=16))):
        un = MultiStreamMatting(2, H, W, device=dev, **kw, **extra)
        ref = [un.step(r) for r in rounds]
        pps = PipelinedStreams(2, H, W, four, **kw, **extra)
        zero_counts(kernels)
        outs = list(pps.convert(rounds))
        modes = {k: v for k, v in
                 fused_refine_composite.mode_launches.items() if v}
        per_pos = [dict(p.launches) for p in pps.positions]
        d = max(byte_diff(g, w)[0] for o, q in zip(outs, ref)
                for g, w in zip(o, q))
        log(f"[P] (d) PipelinedStreams(2) on four positions of cuda:0, "
            f"{label}, 8 rounds: max |d| to the 2-stream instance {d}; "
            f"refine modes {modes}; launches per position {per_pos}")
        want_mode = "coarse" if "blur" in label else "color"
        # 8 rounds and the drain's one: 9 dispatches a row, 2 rows.
        assert d <= 1 and modes == {want_mode: 18}, (d, modes)
        res["d"][label] = dict(max=d, modes=modes)

    try:
        cli.main(["multistream", "a.mp4", "--output-dir",
                  os.path.join(OUT_DIR, "pp"), "--pp"])
        raise AssertionError("multistream --pp ran on one card")
    except SystemExit as e:
        msg = str(e)
    n = torch.cuda.device_count()
    log(f"[P] (e) python -m vidmat_torch.cli multistream a.mp4 --pp on "
        f"{n} card(s): exits {msg!r}")
    assert n >= 2 or msg == (f"--pp needs 2 devices per stream (2 for 1 "
                             f"streams); {n} visible"), msg
    log(f"[P] phase P took {time.perf_counter() - t_phase:.1f} s; kernel "
        f"checks {json.dumps(errs)}")
    return res


def phase_kernels_n8(net, dev, pool):
    """Phase 2 at the multistream round's launch shapes, N = 8 streams of
    1088x1920 (round 0 of phase M): ingest (bit-exact), the planar kernels
    at the per-frame body's 9 call sites over the whole batch (the decoder
    on a carry that is not zero) against the sequential order (0 bf16
    values unequal), GF (bit-exact, one launch), the packed tail over a
    color and in coarse mode (bg_blur=16) within 1 byte, and the float
    tail within 1e-5. Returns ({row name: max |d|}, the timing inputs,
    the planar sites)."""
    import torch

    from vidmat_torch.ops.gf import guided_filter_coeffs_plain
    from vidmat_torch.ops.guided_filter import box_blur, gray_guide
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain,
                                         fused_refine_float,
                                         fused_refine_float_plain)

    batch = torch.from_numpy(ms_batch(pool[0], 0)).to(dev)
    x = ingest_pool_normalize(batch, pool=4)
    want = ingest_pool_normalize_plain(batch, pool=4)
    assert torch.equal(x, want), "ingest: not bit-exact at N = 8"
    errs = {"ingest_pool_normalize (8 streams)": 0.0}
    xp = coarse_input(net, batch)
    sites = capture_sites(net, None, xp, batch_decode=True)
    for site, (key, args) in sites.items():
        kern = planar_ops()[key][0]
        e, unequal, lib = check_planar(key, args)
        row = f"{kern.__name__} (8 streams)"
        errs[row] = max(errs.get(row, 0.0), e)
        x0 = args[0] if key == "gru" else args[0][0]
        log(f"    N=8 {site:8s} {kern.__name__:16s} {tuple(x0.shape)} max "
            f"|d| {e:.3g} vs the sequential twin, {unequal} values unequal; "
            f"cuDNN twin max |d| {lib:.3g}")
        assert unequal == 0, (site, unequal)
    nh, nw = x.shape[1:3]
    with torch.inference_mode():
        st = net.init_state(MS_STREAMS, *xp.shape[1:3])
        alpha, fgr, _ = net(xp, st, plain=True)
    guide = gray_guide(want.float()).contiguous()
    p = torch.cat([alpha[:, :nh, :nw], fgr[:, :nh, :nw]], -1).float()
    p = p.contiguous()
    ka, kb = gf_one_launch(guide, p)
    ma, mb = guided_filter_coeffs_plain(guide, p)
    assert torch.equal(ka, ma) and torch.equal(kb, mb), "GF at N = 8"
    errs["guided_filter_coeffs (8 streams)"] = 0.0
    coarse = box_blur(want.float(), 4)
    for row, bg in (("fused_refine_composite (8 streams)", GREEN),
                    ("fused_refine_composite (coarse, 8 streams)", coarse)):
        k = fused_refine_composite(batch, ma, mb, bg, 4)
        q = fused_refine_composite_plain(batch, ma, mb, bg, 4)
        d = (k.view(torch.uint8).int() - q.view(torch.uint8).int()).abs()
        errs[row] = float(d.max())
        log(f"    N=8 {row}: bytes mean |d| {float(d.float().mean()):.3g} "
            f"max {int(d.max())}, {int((d > 0).sum())} of {d.numel()} "
            "bytes unequal to the plain twin")
    ka_, kf = fused_refine_float(batch, ma, mb, 4)
    pa, pf = fused_refine_float_plain(batch, ma, mb, 4)
    errs["fused_refine_float (8 streams)"] = float(max(
        (ka_ - pa).abs().max(), (kf - pf).abs().max()))
    torch.cuda.synchronize()
    log(f"[2] N = {MS_STREAMS} launch shapes (multistream round) vs plain: "
        f"{json.dumps(errs)}")
    assert errs["fused_refine_composite (8 streams)"] <= 1, errs
    assert errs["fused_refine_composite (coarse, 8 streams)"] <= 1, errs
    assert errs["fused_refine_float (8 streams)"] <= 1e-5, errs
    return errs, dict(batch=batch, x=x, guide=guide, p=p, ma=ma, mb=mb,
                      coarse=coarse, alpha=pa, fgr=pf), sites


def rows_n8(inp):
    """Phase 6's rows of the tail kernels at the multistream round's launch
    shapes (8 x 1088x1920, pool 4): ingest, GF, the packed tail over a
    color and in coarse mode, and the float tail (no background)."""
    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain,
                                         fused_refine_float,
                                         fused_refine_float_plain)

    fr, x, gd, pp, a, b, cbg = (inp[k] for k in (
        "batch", "x", "guide", "p", "ma", "mb", "coarse"))
    label = f"{MS_STREAMS} frames"
    px = fr.shape[0] * fr.shape[1] * fr.shape[2]
    packed = fused_refine_composite(fr, a, b, GREEN, 4)
    refine_ops = 8 * 9 + 6 + 16 + 9 + 12
    taps = 2 * (2 * 4 + 1)
    return {
        "ingest_pool_normalize (8 streams)": {label: dict(
            kernel=lambda: ingest_pool_normalize(fr, pool=4),
            plain=lambda: ingest_pool_normalize_plain(fr, pool=4),
            bytes=nbytes(fr, x), ops=fr.numel() + 4 * x.numel(),
            peak=F32_FLOPS_PER_S)},
        "guided_filter_coeffs (8 streams)": {label: dict(
            kernel=lambda: guided_filter_coeffs(gd, pp),
            plain=lambda: guided_filter_coeffs_plain(gd, pp),
            bytes=nbytes(gd, pp, a, b),
            ops=gd.numel() * (18 * taps + 5 + 18 + 24),
            peak=F32_FLOPS_PER_S)},
        "fused_refine_composite (8 streams)": {label: dict(
            kernel=lambda: fused_refine_composite(fr, a, b, GREEN, 4),
            plain=lambda: fused_refine_composite_plain(fr, a, b, GREEN, 4),
            bytes=nbytes(fr, a, b, packed), ops=px * refine_ops,
            peak=F32_FLOPS_PER_S)},
        "fused_refine_composite (coarse, 8 streams)": {label: dict(
            kernel=lambda: fused_refine_composite(fr, a, b, cbg, 4),
            plain=lambda: fused_refine_composite_plain(fr, a, b, cbg, 4),
            bytes=nbytes(fr, a, b, cbg, packed), ops=px * (refine_ops + 33),
            peak=F32_FLOPS_PER_S)},
        "fused_refine_float (8 streams)": {label: dict(
            kernel=lambda: fused_refine_float(fr, a, b, 4),
            plain=lambda: fused_refine_float_plain(fr, a, b, 4),
            bytes=nbytes(fr, a, b, inp["alpha"], inp["fgr"]),
            ops=px * (8 * 9 + 6 + 16), peak=F32_FLOPS_PER_S)},
    }


def phase_bench():
    """bench_torch.py's 1080p, 480p, e2e, 4k, 4k_tiled and multistream
    records, each on its own line (the port's bench run in this
    process)."""
    import io

    import bench_torch

    recs = {}
    for mode in ("1080p", "480p", "e2e", "4k", "4k_tiled", "multistream"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            assert bench_torch.main(["--mode", mode]) == 0
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"[T] bench_torch.py --mode {mode} ({time.perf_counter() - t0:.1f}"
            f" s): {json.dumps(rec)}")
        assert rec["value"] > 0 and rec["device"] != "cpu", rec
        recs[mode] = rec
    return recs


# AOT serving bundles (vidmat_torch/deploy.py): the main path's bundle is
# exported at the 1920x1080 stream (the 1088x1920 bucket) with chunk 4,
# loaded in a fresh process by the loader alone and run over the phase's
# frames; each variant below is exported with its step program only and
# run for a step or two against its live body.
D_FRAMES = 64
D_EVAL_FRAMES = 16
D_SKIP_EPS = 0.5 / 255

# The loader-only run: a fresh interpreter that imports the bundle loader
# and nothing of the model definition, converts the frames saved by the
# parent and saves what it wrote.
LOADER_CHILD = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
t0 = time.perf_counter()
from vidmat_torch.deploy import ServingBundle
t1 = time.perf_counter()
b = ServingBundle(sys.argv[2], device="cuda")
load_ms = (time.perf_counter() - t1) * 1e3
import_ms = (t1 - t0) * 1e3
frames = np.load(sys.argv[3], mmap_mode="r")
alphas, comps = [], []
m = b.convert(iter(frames), output_alpha=alphas.append,
              output_composition=comps.append)
np.save(sys.argv[4], np.stack(alphas))
np.save(sys.argv[5], np.stack(comps))
bad = sorted(k for k in sys.modules
             if k.startswith(("vidmat_torch.models", "jax", "vidmat."))
             or k in ("vidmat", "vidmat_torch.pipeline.stepfactory"))
print(json.dumps({"load_ms": load_ms, "import_ms": import_ms,
                  "metrics": m, "bad_modules": bad,
                  "per_replay": b.launches_per_replay("chunk")}))
"""


def bundle_variants():
    """label -> (height, width, export_bundle arguments, frames): each
    variant's bundle at its preset's stream, its step program only."""
    import dataclasses

    import numpy as np

    from vidmat_torch.config import (ModelConfig, preset_video_1080p,
                                     preset_video_1080p_errormap,
                                     preset_video_4k)

    mcfg, pcfg = preset_video_1080p()
    step = dataclasses.replace(pcfg, chunk_size=1)
    base = dict(model_cfg=mcfg, pipe_cfg=step)
    frames = clip(3, seed=5)[0]
    m4k, p4k = preset_video_4k()
    merr, perr = preset_video_1080p_errormap()
    return {
        "bg_blur=16": (FRAME_H, FRAME_W, dict(base, bg_blur=16), frames[:2]),
        "alpha_only": (FRAME_H, FRAME_W, dict(base, alpha_only=True),
                       frames[:2]),
        "need_fgr": (FRAME_H, FRAME_W, dict(base, need_fgr=True),
                     frames[:2]),
        "num_streams=8": (FRAME_H, FRAME_W, dict(base, num_streams=8),
                          [np.stack([frames[(r + i) % 3] for i in range(8)])
                           for r in range(2)]),
        "video_4k tiled": (H4K, W4K, dict(
            model_cfg=m4k, pipe_cfg=dataclasses.replace(p4k, chunk_size=1)),
            frames_4k(2)[0]),
        "video_1080p_errormap": (H, W, dict(
            model_cfg=merr, pipe_cfg=dataclasses.replace(perr, chunk_size=1)),
            hard_frames(2)[0]),
        "seg": (FRAME_H, FRAME_W, dict(
            model_cfg=ModelConfig(conv_impl="planar"), pipe_cfg=step,
            output="seg"), frames[:2]),
        "static skip": (FRAME_H, FRAME_W, dict(
            base, pipe_cfg=dataclasses.replace(
                step, static_skip_eps=D_SKIP_EPS)),
            [frames[0], frames[0], frames[1]]),
    }


def bundle_variant_check(label, h, w, kw, frames, tmp, dev):
    """Export one variant on the card, load it, step it over ``frames``
    and hold every output byte to its live body's
    (``deploy.serving_body``). Returns (export s, bytes unequal, ms per
    step)."""
    import numpy as np
    import torch

    from vidmat_torch.deploy import ServingBundle, export_bundle, serving_body

    path = os.path.join(tmp, label.replace(" ", "_").replace("=", ""))
    t0 = time.perf_counter()
    export_bundle(path, h, w, device=dev, **kw)
    export_s = time.perf_counter() - t0
    bundle = ServingBundle(path, device=dev)
    body, plan, _, _ = serving_body(h, w, device=dev, **kw)
    s = kw.get("num_streams", 1)
    state = plan.make_state(s)
    unequal = 0
    step_ms = []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = bundle.step(f)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        x = f if s > 1 else f[None]
        padded = np.stack([np.pad(xi, ((0, bundle._ph - h),
                                       (0, bundle._pw - w), (0, 0)),
                                  mode="edge") for xi in x])
        out, state = body(torch.from_numpy(padded).to(dev), state)
        want = bundle._unpack(out)
        if s == 1:
            want = {k: v[0] for k, v in want.items()}
        assert sorted(got) == sorted(want), (label, sorted(got))
        for k in got:
            assert got[k].dtype == want[k].dtype, (label, k)
            unequal += int(np.sum(got[k] != want[k]))
    graphed = "step" in bundle._graphs
    log(f"[D] {label}: {h}x{w}, export {export_s:.1f} s, output "
        f"{bundle.manifest['output']}, {len(frames)} steps "
        f"({'eager, then graph replays' if graphed else 'eager'}) "
        f"{', '.join(f'{t:.2f}' for t in step_ms)} ms, bytes unequal to "
        f"the live body: {unequal}")
    if torch.device(dev).type == "cuda":
        assert graphed != bundle.manifest["static_skip"], label
    return export_s, unequal, step_ms


def phase_deploy(kernels, gpu, dev):
    """Phase D: AOT serving bundles on the card. The main path's bundle
    (video_1080p, chunk 4): each program's count of vidmat_torch:: nodes
    (the six main-path kernels, at the live chunk body's launches per
    replay, and no aten convolution); loaded in a fresh process by the
    loader alone, convert over the phase's 64 frames against convert_video
    on the same frames (0 alpha and composite bytes unequal), its
    launches per replay equal to the live graph's; export s, load ms,
    fps beside convert_video's. Then one step or two of each variant
    against its live body (0 bytes unequal), and a CPU bundle refused on
    the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vidmat_torch import convert_video, preset_video_1080p
    from vidmat_torch.deploy import ServingBundle, export_bundle
    from vidmat_torch.ops import library

    tmp = tempfile.mkdtemp(prefix="vidmat_bundles_")
    try:
        mcfg, pcfg = preset_video_1080p()
        path = os.path.join(tmp, "video_1080p")
        t0 = time.perf_counter()
        export_bundle(path, FRAME_H, FRAME_W, model_cfg=mcfg, pipe_cfg=pcfg,
                      device=dev)
        export_s = time.perf_counter() - t0
        nodes = {}
        for prog in ("step", "chunk"):
            ep = torch.export.load(os.path.join(path, f"{prog}.pt2"))
            nodes[prog] = library.program_ops(ep.graph_module)
        log(f"[D] video_1080p bundle exported in {export_s:.1f} s "
            f"({FRAME_W}x{FRAME_H}, bucket {W}x{H}, chunk {CHUNK}); "
            f"vidmat_torch:: nodes per program: {json.dumps(nodes)}")

        frames, gt = clip(D_FRAMES, seed=0)
        convert_video(frames[:8], output_alpha=lambda a: None,
                      model_cfg=mcfg, pipe_cfg=pcfg)  # warm-up
        alphas, comps = [], []
        zero_counts(kernels)
        live = convert_video(frames, output_alpha=alphas.append,
                             output_composition=comps.append,
                             model_cfg=mcfg, pipe_cfg=pcfg)
        live_launches = counts(kernels)
        per = live["graph_launches_per_replay"]
        chunk_nodes = {k: v for k, v in nodes["chunk"].items()}
        assert set(library.MAIN_PATH) <= set(chunk_nodes), chunk_nodes
        assert "aten.convolution" not in chunk_nodes, chunk_nodes
        assert "aten.convolution" not in nodes["step"], nodes["step"]
        assert chunk_nodes == per, (chunk_nodes, per)

        src = os.path.join(tmp, "frames.npy")
        np.save(src, np.stack(frames))
        got_a, got_c = (os.path.join(tmp, f"{k}.npy") for k in ("a", "c"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", LOADER_CHILD, ROOT, path, src, got_a,
             got_c], capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        child = json.loads(res.stdout.strip().splitlines()[-1])
        ba, bc = np.load(got_a), np.load(got_c)
        unequal_a = int(np.sum(ba != np.stack(alphas)))
        unequal_c = int(np.sum(bc != np.stack(comps)))
        bm = child["metrics"]
        log(f"[D] loader-only process ({child_s:.1f} s, its modules of the "
            f"model definition: {child['bad_modules']}): import of the "
            f"loader (torch included) {child['import_ms']:.1f} ms, load "
            f"{child['load_ms']:.1f} ms, convert {bm['frames']} frames fps "
            f"{bm['fps']:.2f} (p50 {bm['p50_ms']:.3f} ms) beside "
            f"convert_video's {live['fps']:.2f} (p50 "
            f"{live['p50_ms']:.3f} ms) on the same frames and preset "
            f"(alpha and composition out, {gpu}); bytes unequal to "
            f"convert_video: alpha {unequal_a} of {ba.size}, composite "
            f"{unequal_c} of {bc.size}; launches per replay "
            f"{child['per_replay']} (convert_video's graph: {per}); "
            f"convert_video's launches {live_launches}")
        assert child["bad_modules"] == [], child["bad_modules"]
        assert bm["frames"] == D_FRAMES, bm
        assert unequal_a == 0 and unequal_c == 0, (unequal_a, unequal_c)
        assert child["per_replay"] == per, (child["per_replay"], per)

        variants = {}
        for label, (h, w, kw, fr) in bundle_variants().items():
            variants[label] = bundle_variant_check(label, h, w, kw, fr, tmp,
                                                   dev)
            assert variants[label][1] == 0, (label, variants[label])

        cpu_path = os.path.join(tmp, "cpu")
        export_bundle(cpu_path, 48, 64, device="cpu")
        try:
            ServingBundle(cpu_path, device=dev)
        except RuntimeError as e:
            assert "platform" in str(e), e
            log(f"[D] a CPU bundle on the card: refused ({e})")
        else:
            raise AssertionError("a CPU bundle was served on the card")
        return dict(export_s=export_s, load_ms=child["load_ms"],
                    import_ms=child["import_ms"],
                    bundle_fps=bm["fps"], convert_video_fps=live["fps"],
                    nodes=nodes, per_replay=per, variants=variants,
                    alphas=alphas[:D_EVAL_FRAMES], gt=gt[:D_EVAL_FRAMES])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_cli_eval(dev, alphas, gt):
    """Phase L: ``python -m vidmat_torch.cli export`` and ``bench
    --quick`` as subprocesses on the card; VideoEval on the card over 16
    1080p frames against its CPU run (the CPU tests' bars: MAD, MSE, SAD
    and dtSSD within 1e-5 relative, Grad 1e-4), ms per frame."""
    import shutil
    import tempfile

    import torch

    from vidmat_torch.eval import VideoEval

    tmp = tempfile.mkdtemp(prefix="vidmat_cli_")
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "vidmat_torch.cli", "export",
             os.path.join(tmp, "b"), "--height", str(FRAME_H), "--width",
             str(FRAME_W), "--preset", "video_1080p", "--chunk", str(CHUNK)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        export_s = time.perf_counter() - t0
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        manifest = json.loads(res.stdout)
        assert manifest["platforms"] == ["cuda"] and manifest[
            "chunk"] == CHUNK, manifest
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "vidmat_torch.cli", "bench", "--quick"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        bench_s = time.perf_counter() - t0
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        assert rec["value"] > 0 and rec["device"] != "cpu", rec
        log(f"[L] cli export ({export_s:.1f} s, compute capability "
            f"{manifest['compute_capability']}, torch "
            f"{manifest['torch_version']}); cli bench --quick "
            f"({bench_s:.1f} s): {json.dumps(rec)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = ("mad", "mse", "sad", "grad", "dtssd")
    rows = {}
    for d in (dev, "cpu"):
        ev = VideoEval(metrics=metrics, device=d)
        ev.update(alphas[0], gt[0])  # warm-up
        ev = VideoEval(metrics=metrics, device=d)
        if d == dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, g in zip(alphas, gt):
            ev.update(a, g)
        ms = (time.perf_counter() - t0) * 1e3 / len(alphas)
        rows[str(d)] = (ev.frames, ev.summary(), ms)
    worst = 0.0
    for rc, rh in zip(rows[str(dev)][0], rows["cpu"][0]):
        assert sorted(rc) == sorted(rh)
        for k, v in rh.items():
            rel = abs(rc[k] - v) / max(abs(v), 1e-12)
            assert rel <= (1e-4 if k == "grad" else 1e-5), (k, rc[k], v)
            worst = max(worst, rel)
    log(f"[L] VideoEval {len(alphas)} frames {FRAME_W}x{FRAME_H} "
        f"({', '.join(metrics)}): card {rows[str(dev)][2]:.2f} ms per "
        f"frame, CPU {rows['cpu'][2]:.2f}; worst relative |d| card vs CPU "
        f"{worst:.2e}; summary {json.dumps(rows[str(dev)][1])}")
    return rows[str(dev)][2]


# Training (phase G): the fast_demo recipe's model (video_1080p: s2d=2,
# encoder (16, 24, 40, 64), decoder (48, 32, 24, 16)).
G_RECIPE_STEPS = 50
G_LR = 2e-4
# (size, T, N) of the logged step times; the last is reported only.
G_SIZES = ((64, 4, 2), (128, 4, 2), (256, 4, 2), (512, 4, 4))


def _capture_optimizer():
    """An optimizer that keeps the gradients in its state and returns zero
    updates: a step's gradients, read per leaf."""
    import torch

    from vidmat_torch.train import optim

    return optim.GradientTransformation(
        lambda p: {"g": optim.tree_map(optim.zeros_like, p)},
        lambda g, s, p=None: (optim.tree_map(torch.zeros_like, g),
                              {"g": g}))


def _flat_host(tree):
    from vidmat_torch.models.weights import (flatten_variables,
                                             numpy_variables)

    return flatten_variables(numpy_variables(tree))


def _grad_step(mcfg, variables, batch, dev, **kw):
    """One train step with the capturing optimizer: (grads, metrics,
    batch_stats) on the host."""
    from vidmat_torch.train.loop import TrainState, make_train_step

    opt = _capture_optimizer()
    step = make_train_step(mcfg, optimizer=opt, device=dev, **kw)
    st, m = step(TrainState(variables=variables,
                            opt_state=opt.init(variables["params"])), *batch)
    return (_flat_host(st.opt_state["g"]),
            {k: float(v) for k, v in m.items()},
            _flat_host(st.variables["batch_stats"]))


def _rel(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def train_step_times(mcfg, dev, size, t, n, steps=5, warmup=2,
                     profile=False):
    """Median synchronised ms of the fast_demo recipe's step (clip, Adam
    with warm-up and cosine decay) at (size, T, N), clips/s and the peak
    device memory of the steps above what was allocated before the
    training state was made; with ``profile`` also the device time and
    work items (kernels and copies) of one step (torch.profiler) and
    their share of the median step (the device's busy share)."""
    import numpy as np
    import torch

    from vidmat_torch.models.weights import init_params
    from vidmat_torch.train import optim
    from vidmat_torch.train.data import synthetic_clip_batches
    from vidmat_torch.train.loop import TrainState, make_train_step, to_device

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(
        optim.warmup_cosine_decay_schedule(0.0, G_LR, 5, 4000,
                                           end_value=G_LR * 1e-2)))
    step = make_train_step(mcfg, optimizer=opt, device=dev)
    v = to_device(init_params(mcfg, seed=0), dev)
    state = TrainState(variables=v, opt_state=opt.init(v["params"]))
    batch = [torch.from_numpy(x).to(dev) for x in next(
        synthetic_clip_batches(t=t, n=n, h=size, w=size, seed=1))]
    for _ in range(warmup):
        state, m = step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    row = dict(size=size, T=t, N=n, step_ms=ms, clips_per_s=n * 1e3 / ms,
               peak_mib=(torch.cuda.max_memory_allocated() - base) / 2 ** 20,
               loss=float(m["loss"]))
    if profile:
        # Where a step's time goes: the device time and work items of one
        # profiled step against the unprofiled step's wall time (the
        # device's busy share; the profiler slows the host, not the
        # device).
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle()
            t0 = time.perf_counter()
            state, m = step(state, *batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            settle()
        kern, copy = device_ms(prof)
        items = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
        row.update(prof_wall_ms=wall, device_ms=kern + copy,
                   kernel_ms=kern, device_items=items,
                   busy=(kern + copy) / ms)
    return row


def phase_train(kernels, gpu, dev):
    """Phase G: training (vidmat_torch/train) on the card, the fast_demo
    recipe's model. (a) one float32 train step at 64x64, T=2, N=2 with
    the Laplacian and boundary terms, card against the same step on the
    CPU (per-leaf gradients |dg|/|g| <= 1e-4, loss and terms 1e-5
    relative, running statistics 1e-5), with every hand-written kernel's
    launch count 0 over the step (training runs F.conv2d through
    autograd); (b) remat on and off (cuDNN deterministic): running
    statistics equal, gradients within 1e-5 (the order of autograd's
    sums over frames); (c) 50 steps of the recipe
    (clip, Adam, warm-up and cosine decay at lr 2e-4) on one fixed batch
    at 128x128, T=4, N=2: the loss falls; (d) six steps of train_on_clips
    interleaving segmentation every third step (order mat, mat, seg,
    mat, mat, seg); (e) ``python -m vidmat_torch.cli train --steps 5`` in
    a subprocess, its .npz served by convert_video; (f) step ms (median
    of 5, synchronised), clips/s and peak memory at 64, 128 and 256 px
    (T=4, N=2) and 512 px (T=4, N=4, reported only)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import vidmat_torch
    from vidmat_torch.config import ModelConfig, preset_video_1080p
    from vidmat_torch.models.weights import init_params, load_npz
    from vidmat_torch.train import optim
    from vidmat_torch.train.data import (synthetic_clip_batches,
                                         synthetic_seg_batches)
    from vidmat_torch.train.loop import (TrainState, make_train_step,
                                         to_device, train_on_clips)

    t_phase = time.perf_counter()
    mcfg, _ = preset_video_1080p()
    variables = init_params(mcfg, seed=0)
    batch = next(synthetic_clip_batches(t=2, n=2, h=64, w=64, seed=3))
    kw = dict(laplacian_weight=0.5, boundary_weight=2.0)
    zero_counts(kernels)
    g_dev, m_dev, s_dev = _grad_step(mcfg, variables, batch, dev, **kw)
    step_launches = counts(kernels)
    g_cpu, m_cpu, s_cpu = _grad_step(mcfg, variables, batch, "cpu", **kw)
    worst_g = max(_rel(g_dev[k], g_cpu[k]) for k in g_cpu)
    worst_m = max(abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                  for k in m_cpu)
    worst_s = max(float(np.abs(s_dev[k] - s_cpu[k]).max()) for k in s_cpu)
    log(f"[G] (a) one train step 64x64 T=2 N=2 (video_1080p model, "
        f"laplacian 0.5, boundary 2.0), card against CPU: worst per-leaf "
        f"|dg|/|g| {worst_g:.3e}, loss and terms {worst_m:.3e} relative, "
        f"running stats {worst_s:.3e}; loss {m_dev['loss']:.6f}; kernel "
        f"launches over the step {step_launches}")
    assert set(g_dev) == set(g_cpu) and set(m_dev) == set(m_cpu)
    assert worst_g <= 1e-4 and worst_m <= 1e-5 and worst_s <= 1e-5, (
        worst_g, worst_m, worst_s)
    assert not any(step_launches.values()), step_launches

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        runs = [_grad_step(mcfg, variables, batch, dev, remat=r, **kw)
                for r in (True, False)]
    (g1, m1, s1), (g0, m0, s0) = runs
    remat_g = max(_rel(g1[k], g0[k]) for k in g0)
    remat_s = sum(int(np.sum(s1[k] != s0[k])) for k in s0)
    log(f"[G] (b) remat on against off (cuDNN deterministic): worst "
        f"per-leaf |dg|/|g| {remat_g:.3e}, running-stat values unequal "
        f"{remat_s}, loss {m1['loss']:.8f} / {m0['loss']:.8f}")
    # The recompute folds nothing in (statistics equal); the gradients
    # differ only by the order autograd sums the frames' contributions.
    assert remat_g <= 1e-5 and remat_s == 0, (remat_g, remat_s)

    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(
        optim.warmup_cosine_decay_schedule(
            0.0, G_LR, min(100, max(1, G_RECIPE_STEPS // 10)),
            G_RECIPE_STEPS, end_value=G_LR * 1e-2)))
    step = make_train_step(mcfg, optimizer=opt, device=dev)
    v = to_device(variables, dev)
    state = TrainState(variables=v, opt_state=opt.init(v["params"]))
    fixed = [torch.from_numpy(x).to(dev) for x in next(
        synthetic_clip_batches(t=4, n=2, h=128, w=128, seed=0))]
    losses, times = [], []
    for _ in range(G_RECIPE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, *fixed)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    first, last = losses[0], float(np.mean(losses[-5:]))
    log(f"[G] (c) fast_demo recipe, {G_RECIPE_STEPS} steps on one batch "
        f"128x128 T=4 N=2: loss {first:.5f} -> {losses[-1]:.5f} (mean of "
        f"the last 5 {last:.5f}, {last / first:.3f}x); step ms median "
        f"{np.median(times[5:]):.2f} (the first {times[0]:.1f})")
    assert np.all(np.isfinite(losses)) and last < 0.9 * first, losses

    cfg = ModelConfig()
    kinds = []
    st = train_on_clips(
        cfg, synthetic_clip_batches(t=2, n=2, h=64, w=64, seed=1),
        num_steps=6, variables=init_params(cfg, seed=2), device=dev,
        seg_data_iter=synthetic_seg_batches(t=2, n=2, h=64, w=64, seed=2),
        seg_every=3, callback=lambda i, m: kinds.append(
            "seg" if "seg_bce" in m else "mat"))
    log(f"[G] (d) train_on_clips, seg every 3rd step: {kinds}; the tree "
        f"grafted a seg_head: {'seg_head' in st.variables['params']}")
    assert kinds == ["mat", "mat", "seg", "mat", "mat", "seg"], kinds
    assert "seg_head" in st.variables["params"]

    tmp = tempfile.mkdtemp(prefix="vidmat_train_")
    try:
        out = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "vidmat_torch.cli", "train", "--steps",
             "5", "--size", "64", "--clip-len", "2", "--batch", "2",
             "--out", out], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        assert res.stdout.strip().splitlines()[-1] == (
            f"saved checkpoint to {out}.npz"), res.stdout[-2000:]
        from vidmat_torch.io.fixtures import synthetic_frames_only

        alphas = []
        cv = vidmat_torch.convert_video(
            list(synthetic_frames_only(64, 64, 4)),
            output_alpha=alphas.append, variables=load_npz(out + ".npz"))
        assert cv["frames"] == 4 and all(np.isfinite(a).all()
                                         for a in alphas)
        log(f"[G] (e) cli train --steps 5 ({cli_s:.1f} s in its process): "
            f"{res.stdout.strip().splitlines()[-1]}; convert_video on it: "
            f"{cv['frames']} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows = [train_step_times(mcfg, dev, *s, profile=s[0] in (128, 512))
            for s in G_SIZES]
    for r in rows:
        log(f"[G] (f) train step {r['size']}x{r['size']} T={r['T']} "
            f"N={r['N']}: {r['step_ms']:.2f} ms (median of 5, "
            f"synchronised), {r['clips_per_s']:.2f} clips/s, peak "
            f"{r['peak_mib']:.1f} MiB ({gpu})")
        if "busy" in r:
            log(f"[G] (f) one step profiled at {r['size']}x{r['size']} "
                f"({r['prof_wall_ms']:.2f} ms under the profiler): device "
                f"{r['device_ms']:.2f} ms (kernels {r['kernel_ms']:.2f}), "
                f"{r['device_items']} device work items; busy "
                f"{100 * r['busy']:.1f}% of the unprofiled step")
    with open(os.path.join(OUT_DIR, "train.json"), "w") as f:
        json.dump(rows, f, indent=1)
    log(f"[G] phase G took {time.perf_counter() - t_phase:.1f} s")
    return rows


# Phase U (A.16): the names the JAX package's subpackages export
# (vidmat/{models,utils,pipeline,io,ops,refine,parallel,train}/__init__.py),
# 34 in all.
SUBPACKAGE_EXPORTS = {
    "models": ("MattingNetwork", "RecurrentState", "init_params",
               "flax_to_torch_state", "save_checkpoint", "load_checkpoint"),
    "utils": ("mad", "sad"),
    "pipeline": ("ImageStepper", "VideoStepper"),
    "io": ("FrameSource", "VideoReader", "read_image", "VideoWriter",
           "write_image", "synthetic_clip", "synthetic_frame"),
    "ops": ("resize_bilinear", "upsample2x", "downsample_ratio_shape",
            "guided_filter", "composite_rgba"),
    "refine": ("tile_frame", "untile_frame", "TileLayout",
               "ErrorMapRefiner"),
    "parallel": ("make_mesh", "MultiStreamMatting", "PipelinedMatting",
                 "PipelinedStreams"),
    "train": ("matting_loss", "TrainState", "make_train_step",
              "train_on_clips"),
}
U_ERRORMAP = ["--size", f"{H}x{W}", "--frames", "2", "--seeds", "987654"]


def close_reports(got, want):
    """Worst difference of two eval_errormap reports: the MADs absolute,
    the Grad sums (about 1e4 at 1080p, float32 sums) relative; raises
    unless the keys and the settings are equal."""
    assert list(got) == list(want), (list(got), list(want))
    worst = 0.0
    for k, w in want.items():
        if not isinstance(w, dict):
            assert got[k] == w, (k, got[k], w)
            continue
        assert list(got[k]) == list(w), k
        for m, x in w.items():
            worst = max(worst, abs(got[k][m] - x) / max(1.0, abs(x)))
    return worst


U_FULL_FRAMES = 10   # clip_480p's chunk


def u_refine_at_full(kernels, gpu, dev):
    """Phase U, part B: ``build_serving_body(refine_at_full=True)`` on
    clip_480p's model (synthetic_demo, the planar net, ratio 1.0) at
    480x864, bf16, guided, packed words, over 10 frames of the clip.
    Returns {"errs", "time", "launches", "path"}: the GF kernel's max |d|
    to its plain twin at this launch shape, its phase 6 row there, and
    its launches over the eager run."""
    import numpy as np
    import torch

    import vidmat_torch.ops.composite as composite
    import vidmat_torch.ops.gf as gf
    import vidmat_torch.pipeline.stepfactory as sf
    from vidmat_torch import preset_clip_480p
    from vidmat_torch.config import RefineConfig
    from vidmat_torch.io.fixtures import synthetic_clip
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.graph import ChunkGraph, per_frame_chunk

    mcfg, _ = preset_clip_480p()
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    frames = torch.from_numpy(np.stack([f for f, _ in synthetic_clip(
        CLIP_H, CLIP_W, U_FULL_FRAMES, seed=0)])).to(dev)

    def build(**kw):
        return sf.build_serving_body(net, mcfg, RefineConfig("guided"),
                                     CLIP_H, CLIP_W, 1.0,
                                     cdtype=torch.bfloat16, **kw)

    body, plan = build(refine_at_full=True)
    assert plan.full and plan.packed and plan.chunk_body is None
    chunk = per_frame_chunk(body)
    chunk(frames[:1], plan.make_state(1))   # warm-up
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    out, _ = chunk(frames, plan.make_state(1))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / U_FULL_FRAMES
    launches = counts(kernels)
    want = expect(kernels, dict(PLANAR_PER_FRAME, guided_filter_coeffs=1,
                                composite_rgba_packed=1), U_FULL_FRAMES)
    assert launches == want, (launches, want)

    static = frames.clone()
    graph = ChunkGraph(chunk, static, plan.make_state(1))
    per = graph.launches_per_replay()
    assert per == {k: v for k, v in launches.items() if v}, (per, launches)
    zero = plan.make_state(1)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_out, _ = graph(zero)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / U_FULL_FRAMES)
    unequal = int((g_out != out).sum())

    # The plain body's GF and composite calls of frame 0 are recorded
    # (guided_upsample looks the plain GF up at each call; the body binds
    # the plain composite when it is built).
    calls = {}
    gf_plain, comp_plain = (gf.guided_filter_coeffs_plain,
                            sf.composite_rgba_packed_plain)

    def rec(name, fn):
        def run(*args):
            calls.setdefault(name, args)
            return fn(*args)
        return run

    gf.guided_filter_coeffs_plain = rec("gf", gf_plain)
    sf.composite_rgba_packed_plain = rec("comp", comp_plain)
    try:
        plain, pplan = build(refine_at_full=True, kernels=False)
        off, oplan = build(refine_at_full=False)
        got = out.view(torch.uint8).reshape(U_FULL_FRAMES, CLIP_H, CLIP_W,
                                            4)
        st, ost = pplan.make_state(1), oplan.make_state(1)
        worst_mean = worst_max = 0.0
        differs = 0
        for j in range(U_FULL_FRAMES):
            p_out, st = plain(frames[j:j + 1], st)
            o_out, ost = off(frames[j:j + 1], ost)
            d = (p_out.view(torch.uint8).reshape(CLIP_H, CLIP_W, 4).int()
                 - got[j].int()).abs()
            worst_mean = max(worst_mean, float(d.float().mean()))
            worst_max = max(worst_max, float(d.max()))
            differs += int((o_out != out[j:j + 1]).sum())
    finally:
        gf.guided_filter_coeffs_plain = gf_plain
        sf.composite_rgba_packed_plain = comp_plain
    guide, p, r, eps = calls["gf"]
    ka, kb = gf.guided_filter_coeffs(guide, p, r, eps)
    pa, pb = gf.guided_filter_coeffs_plain(guide, p, r, eps)
    fgr, alpha, bgv = calls["comp"]
    kc = composite.composite_rgba_packed(fgr, alpha, bgv)
    pc = composite.composite_rgba_packed_plain(fgr, alpha, bgv)
    torch.cuda.synchronize()
    e_gf = float(max((ka - pa).abs().max(), (kb - pb).abs().max()))
    e_comp = int((kc != pc).sum())
    taps = 2 * (2 * r + 1)
    row = time_case(dict(
        kernel=lambda: gf.guided_filter_coeffs(guide, p, r, eps),
        plain=lambda: gf.guided_filter_coeffs_plain(guide, p, r, eps),
        bytes=nbytes(guide, p, ka, kb),
        ops=guide.numel() * (18 * taps + 5 + 18 + 24),
        peak=F32_FLOPS_PER_S))

    log(f"[U] (g) refine_at_full=True, clip_480p's model {CLIP_W}x{CLIP_H} "
        f"bf16, guided, packed, {U_FULL_FRAMES} frames: launches {launches}; "
        f"a 10-frame graph replays {per} ({unequal} of {out.numel()} words "
        f"unequal to the eager body); {eager_ms:.3f} ms a frame eager, "
        f"{min(times):.3f} ms replayed ({gpu}); against the plain body: "
        f"worst-frame mean |d| {worst_mean:.4g} LSB, max {worst_max:.0f}; "
        f"words unequal to refine_at_full=False {differs}")
    log(f"[U] (h) at this launch shape, guide {tuple(guide.shape)}, src "
        f"{tuple(p.shape)}: GF max |d| to plain {e_gf:.3g}; "
        f"composite_rgba_packed words unequal to plain {e_comp}; [6] "
        f"guided_filter_coeffs (full res): {row['ms']:.4f} ms (cold L2), "
        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']} ({row['bytes'] / 1e6:.2f} MB, "
        f"{row['ops'] / 1e6:.1f} Mop; {100 * row['bound_ms'] / row['ms']:.0f}"
        f"% of the bound; {gpu})")
    assert unequal == 0, unequal
    assert worst_mean <= 0.5 and worst_max <= 2, (worst_mean, worst_max)
    assert differs > 0
    assert e_gf <= 1e-4 and e_comp == 0, (e_gf, e_comp)
    return dict(errs={"guided_filter_coeffs (full res)": e_gf,
                      "composite_rgba_packed": 0.0},
                time=dict(row, shape="1 frame"),
                launches=launches["guided_filter_coeffs"],
                path=(f"build_serving_body(refine_at_full=True) clip_480p, "
                      f"{U_FULL_FRAMES} frames at {CLIP_W}x{CLIP_H}"))


def phase_a16(kernels, gpu, dev):
    """Phase U: A.16's one-card surface on the card. (a) make_chunk_step
    with fast_demo (s2d=2, F.conv2d) at 1088x1920, K=4, float32: equal
    (0, cuDNN deterministic) to four calls of the network built from the
    same weights, and within 1e-4 of the chunk step on the CPU; ms of
    the chunk (median of 5, synchronised); (b) the full-resolution
    guided_filter at 1x1088x1920 with a 3-channel src, within 1e-5 of the
    CPU, its ms (cold L2, median of 50); (c) the 34 subpackage exports;
    (d) every shipped .npz through models.load_checkpoint with its
    template; (e) tools/eval_errormap on the card at 1088x1920, 2 frames,
    one seed, held to the same report on the CPU (MADs within 1e-4, Grad
    within 1e-4 relative); (f) no hand-written kernel launched over (a),
    (b) and (e) (plain PyTorch, as the JAX package runs them in XLA)."""
    import dataclasses
    import importlib

    import numpy as np
    import torch

    from vidmat_torch._device import full_fp32
    from vidmat_torch.config import ModelConfig, preset_video_1080p
    from vidmat_torch.models import weights
    from vidmat_torch.models.matting_net import MattingNetwork, init_state
    from vidmat_torch.ops import guided_filter
    from vidmat_torch.ops.guided_filter import gray_guide
    from vidmat_torch.pipeline.scan import make_chunk_step
    from vidmat_torch.tools import eval_errormap
    from vidmat_torch.train.refine import init_refiner_params

    t_phase = time.perf_counter()
    mcfg, _ = preset_video_1080p()
    cfg = dataclasses.replace(mcfg, conv_impl="xla")
    variables = weights.default_variables(mcfg)
    frames = np.random.RandomState(16).rand(CHUNK, 1, H, W, 3).astype(
        np.float32)
    zero_counts(kernels)

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        step = make_chunk_step(MattingNetwork(cfg), device=dev)
        alphas, fgrs, _ = step(variables, frames,
                               init_state(cfg, 1, H, W, device=dev))
        net = weights.build_network(cfg, variables, device=dev)
        state = init_state(cfg, 1, H, W, device=dev)
        ref_a, ref_f = [], []
        with torch.no_grad(), full_fp32():
            for x in torch.from_numpy(frames).to(dev):
                a, f, state = net(x, state)
                ref_a.append(a)
                ref_f.append(f)
        d_net = max(float((alphas - torch.stack(ref_a)).abs().max()),
                    float((fgrs - torch.stack(ref_f)).abs().max()))
    frames_dev = torch.from_numpy(frames).to(dev)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(variables, frames_dev, init_state(cfg, 1, H, W, device=dev))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    cpu_a, cpu_f, _ = make_chunk_step(MattingNetwork(cfg), device="cpu")(
        variables, frames, init_state(cfg, 1, H, W))
    d_cpu = max(float((alphas.cpu() - cpu_a).abs().max()),
                float((fgrs.cpu() - cpu_f).abs().max()))
    log(f"[U] (a) make_chunk_step fast_demo F.conv2d {W}x{H} K={CHUNK} "
        f"float32: max |d| to four network calls {d_net:.3e} (cuDNN "
        f"deterministic), to the CPU chunk step {d_cpu:.3e}; chunk "
        f"{float(np.median(times)):.2f} ms (frames on the card; median of 5, "
        f"synchronised; {gpu})")
    assert d_net == 0.0 and d_cpu <= 1e-4, (d_net, d_cpu)

    rgb = torch.from_numpy(frames[0]).to(dev)
    guide = gray_guide(rgb)
    src = torch.from_numpy(np.random.RandomState(17).rand(1, H, W, 3)
                           .astype(np.float32)).to(dev)
    out = guided_filter(guide, src)
    want = guided_filter(guide.cpu(), src.cpu())
    d_gf = float((out.cpu() - want).abs().max())
    gf_ms = time_cold(lambda: guided_filter(guide, src))
    log(f"[U] (b) guided_filter 1x{H}x{W}, 3-channel src, r=4, eps=1e-4: "
        f"max |d| card vs CPU {d_gf:.3e}; {gf_ms:.4f} ms (cold L2, median "
        f"of 50; plain PyTorch; {gpu})")
    assert out.shape == src.shape and d_gf <= 1e-5, d_gf

    names = 0
    for pkg, exported in SUBPACKAGE_EXPORTS.items():
        mod = importlib.import_module(f"vidmat_torch.{pkg}")
        for name in exported:
            names += 1
            obj = getattr(mod, name)
            assert obj.__name__ == name, (pkg, name, obj)
    assert names == 34 and callable(importlib.import_module(
        "vidmat_torch.ops").guided_filter)

    loaded = []
    for table, seg in ((weights._DEFAULT_CKPTS, False),
                       (weights._SEG_CKPTS, True)):
        for (tri, plate, s2d, rec), name in table.items():
            c = ModelConfig(use_trimap=tri, use_bg_plate=plate,
                            space_to_depth=s2d, recurrent=rec)
            path = weights.default_checkpoint_path(c, seg=seg)
            v = weights.load_checkpoint(
                path, template=weights.init_params(c, with_seg=seg))
            loaded.append(f"{name} "
                          f"{len(weights.flatten_variables(v))}")
    v = weights.load_checkpoint(weights.default_refiner_path(),
                                template=init_refiner_params())
    loaded.append(f"errormap_demo {len(weights.flatten_variables(v))}")
    log(f"[U] (c) {names} subpackage names resolve; "
        f"(d) load_checkpoint with templates (leaves): {', '.join(loaded)}")
    assert len(loaded) == 7

    t0 = time.perf_counter()
    card = eval_errormap.evaluate(eval_errormap.parse_args(
        [*U_ERRORMAP, "--device", torch.device(dev).type]))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = eval_errormap.evaluate(eval_errormap.parse_args(
        [*U_ERRORMAP, "--device", "cpu"]))
    cpu_s = time.perf_counter() - t0
    worst = close_reports(card, cpu)
    launches = counts(kernels)
    log(f"[U] (e) eval_errormap {W}x{H}, 2 frames, one seed: card "
        f"{card_s:.1f} s, CPU {cpu_s:.1f} s; worst |d| (Grad relative) "
        f"{worst:.3e}; card report {json.dumps(card)}")
    log(f"[U] (f) hand-written kernel launches over (a), (b) and (e): "
        f"{launches}")
    assert worst <= 1e-4, (card, cpu)
    assert not any(launches.values()), launches

    full = u_refine_at_full(kernels, gpu, dev)
    from vidmat_torch.refine.tiling import tiled_apply

    x = torch.from_numpy(np.random.RandomState(18).rand(
        1, CLIP_H, CLIP_W, 3).astype(np.float32))

    def box(t):
        return torch.nn.functional.avg_pool2d(
            t.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)

    d_tile = float((tiled_apply(box, x.to(dev), 256, 32).cpu()
                    - tiled_apply(box, x, 256, 32)).abs().max())
    log(f"[U] (i) tiled_apply of a 3x3 box mean, 1x{CLIP_H}x{CLIP_W}, tiles "
        f"of 256 overlapping 32: max |d| card vs CPU {d_tile:.3e}")
    assert d_tile <= 1e-5, d_tile
    log(f"[U] phase U took {time.perf_counter() - t_phase:.1f} s")
    return full


# Phase H (A.12's sharded training): the fast_demo model's step sharded
# over meshes whose positions repeat the card, at 512x512, T=4, N=4,
# against the unsharded step on the same card.
H_SIZE, H_T, H_N = 512, 4, 4
H_MESHES = ((("data",), (4,)), (("spatial",), (4,)),
            (("data", "spatial"), (2, 2)))


def _h_grad_step(kind, mcfg, variables, batch, dev, mesh=None):
    """One step (``kind`` "mat" or "seg") with the capturing optimizer,
    unsharded on ``dev`` or over ``mesh``: (grads, metrics, batch_stats)
    on the host."""
    from vidmat_torch.train.loop import (TrainState, make_seg_train_step,
                                         make_train_step)

    opt = _capture_optimizer()
    make = make_train_step if kind == "mat" else make_seg_train_step
    step = make(mcfg, optimizer=opt, mesh=mesh,
                device=dev if mesh is None else None)
    st, m = step(TrainState(variables=variables,
                            opt_state=opt.init(variables["params"])), *batch)
    return (_flat_host(st.opt_state["g"]),
            {k: float(v) for k, v in m.items()},
            _flat_host(st.variables["batch_stats"]))


def _h_worst(got, want):
    """(worst per-leaf max|dg| / max|g|, worst loss or term relative,
    worst running-statistic |d|) of two ``_h_grad_step`` results."""
    import numpy as np

    (g, m, s), (g0, m0, s0) = got, want
    assert set(g) == set(g0) and set(m) == set(m0) and set(s) == set(s0)
    return (max(float(np.abs(g[k] - g0[k]).max()
                      / max(np.abs(g0[k]).max(), 1e-30)) for k in g0),
            max(abs(m[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0),
            max(float(np.abs(s[k] - s0[k]).max()) for k in s0))


def _h_step_ms(mcfg, variables, batch, dev, mesh=None, steps=5):
    """Median synchronised ms of ``steps`` train steps (the default
    optimizer, after one warm-up step) and their peak device memory above
    what was allocated before, MiB."""
    import numpy as np
    import torch

    from vidmat_torch.train.loop import (TrainState, make_optimizer,
                                         make_train_step, to_device)

    opt = make_optimizer()
    step = make_train_step(mcfg, optimizer=opt, mesh=mesh,
                           device=dev if mesh is None else None)
    v = to_device(variables, dev)
    state = TrainState(variables=v, opt_state=opt.init(v["params"]))
    state, _ = step(state, *batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)),
            (torch.cuda.max_memory_allocated() - base) / 2 ** 20)


# Phase H (e): the two-process job. Each worker is ``python chip_smoke.py
# --h-worker <process> <port> <out dir>``: a process with positions on
# cuda:0 that joins a gloo group of two on localhost (NCCL refuses two
# ranks on one card), so the halos, sums and gathers cross the process
# boundary through the host. ('spatial',) (2) is the torchrun layout, one
# position a process; on ('spatial', 'data') (2, 2) each process holds
# 'spatial' position i of both data groups.
H2_MESHES = ((("spatial",), (2,)), (("spatial", "data"), (2, 2)))
H2_TIMEOUT_S = 420


def h_worker(pid: int, port: int, out: str) -> int:
    """One process of phase H's two-process job: the matting step (with
    the capturing optimizer) and its ms on each mesh of ``H2_MESHES``,
    written to <out>/h<pid>.npz and .json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import init_params
    from vidmat_torch.parallel import collectives
    from vidmat_torch.parallel.mesh import make_mesh
    from vidmat_torch.parallel.spatial import Layout
    from vidmat_torch.pipeline.graph import kernel_wrappers
    from vidmat_torch.train.data import synthetic_clip_batches

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=pid)
    try:
        dev = torch.device("cuda", 0)
        kernels = kernel_wrappers()
        mcfg, _ = preset_video_1080p()
        variables = init_params(mcfg, seed=0)
        batch = next(synthetic_clip_batches(seed=5, t=H_T, n=H_N, h=H_SIZE,
                                            w=H_SIZE))
        saved, report = {}, {"pid": pid, "transport": (
            "nccl" if collectives._nccl() else
            "gloo over TCP on localhost, CUDA tensors staged through the "
            "host")}
        for axes, shape in H2_MESHES:
            name = f"{axes} {shape}"
            mesh = make_mesh(axes, shape, devices=[dev] * (
                int(math.prod(shape)) // 2))
            lay = Layout(mesh)
            per = H_N // lay.d
            rows = np.concatenate([np.arange(g * per, (g + 1) * per)
                                   for g in lay.rows])
            mine = [torch.from_numpy(x[:, rows]).to(dev) for x in batch]
            zero_counts(kernels)
            g, m, st = _h_grad_step("mat", mcfg, variables, mine, dev, mesh)
            launches = counts(kernels)
            ms, peak = _h_step_ms(mcfg, variables, mine, dev, mesh)
            saved.update({f"{name}/g/{k}": v for k, v in g.items()})
            saved.update({f"{name}/s/{k}": v for k, v in st.items()})
            report[name] = dict(metrics=m, launches=launches, ms=ms,
                                peak_mib=peak, pids=lay.pids.tolist(),
                                rows=lay.rows)
        np.savez(os.path.join(out, f"h{pid}.npz"), **saved)
        with open(os.path.join(out, f"h{pid}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


def h_two_process(gpu, dev, variables, mcfg, batch, spread):
    """Phase H (e): the two workers on cuda:0, each mesh held against the
    one-process step on the same mesh shape over positions repeating
    cuda:0 (loss and terms 2e-5, statistics 1e-5, gradients within the
    larger of 1e-4 and the unsharded step's float32 spread), no
    hand-written kernel launched; the step ms of both beside each
    other."""
    import socket

    import numpy as np
    import torch

    from vidmat_torch.parallel.mesh import make_mesh

    out = os.path.join(OUT_DIR, "h_workers")
    os.makedirs(out, exist_ok=True)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    logs = [open(os.path.join(out, f"h{i}.log"), "w") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--h-worker", str(i),
         str(port), out], stdout=logs[i], stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        for p in procs:
            p.wait(timeout=H2_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for i, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"h{i}.log")) as f:
                log(f.read()[-4000:])
        assert p.returncode == 0, (i, p.returncode)
    reports = []
    for i in range(2):
        with open(os.path.join(out, f"h{i}.json")) as f:
            reports.append(json.load(f))
    got = [np.load(os.path.join(out, f"h{i}.npz")) for i in range(2)]
    log(f"[H] (e) two processes on cuda:0 ({wall:.1f} s with their start); "
        f"halos, sums and gathers carried by {reports[0]['transport']}")
    res = {}
    for axes, shape in H2_MESHES:
        name = f"{axes} {shape}"
        one = make_mesh(axes, shape, devices=[dev] * int(math.prod(shape)))
        ref = _h_grad_step("mat", mcfg, variables, batch, dev, one)
        ms1, peak1 = _h_step_ms(mcfg, variables, batch, dev, one)
        r0, r1 = reports[0][name], reports[1][name]
        assert all(len(set(row)) == 2 for row in r0["pids"]), r0["pids"]
        assert r0["metrics"] == r1["metrics"], (r0, r1)
        for k in got[0].files:
            if k.startswith(name):
                assert np.array_equal(got[0][k], got[1][k]), k
        mine = ({k.split("/", 2)[2]: got[0][k] for k in got[0].files
                 if k.startswith(f"{name}/g/")}, r0["metrics"],
                {k.split("/", 2)[2]: got[0][k] for k in got[0].files
                 if k.startswith(f"{name}/s/")})
        wg, wm, ws = _h_worst(mine, ref)
        res[name] = dict(grad=wg, loss=wm, stats=ws, ms=[r0["ms"],
                                                         r1["ms"]],
                         ms_one_process=ms1, peak_mib=r0["peak_mib"],
                         peak_mib_one_process=peak1,
                         launches=[r0["launches"], r1["launches"]])
        log(f"[H] (e) {name} over two processes (groups {r0['rows']} / "
            f"{r1['rows']}) against the one-process step on the same mesh "
            f"shape: worst per-leaf max|dg|/max|g| {wg:.3e}, loss and terms "
            f"{wm:.3e} relative, running stats {ws:.3e}; both processes' "
            f"results equal; step {r0['ms']:.2f} / {r1['ms']:.2f} ms (the "
            f"two processes, median of 5, synchronised) against "
            f"{ms1:.2f} ms in one process; peak {r0['peak_mib']:.1f} "
            f"against {peak1:.1f} MiB; kernel launches {r0['launches']} "
            f"({gpu})")
        assert wm <= 2e-5 and ws <= 1e-5, res
        assert wg <= max(1e-4, spread["mat"]), (res, spread)
        assert not any(r0["launches"].values()) and not any(
            r1["launches"].values()), res
    return res


def phase_sharded_train(kernels, gpu, dev):
    """Phase H: sharded training (A.12's last part) on the card, the
    fast_demo model (video_1080p: s2d=2) at 512x512, T=4, N=4, over
    meshes whose positions repeat the card (the caller's stream):
    ('data',) (4), ('spatial',) (4) and ('data', 'spatial') (2, 2).
    (a) each sharded step (Laplacian and boundary terms on) against the
    unsharded step on the card: loss and terms within 2e-5 relative,
    running statistics within 1e-5, no hand-written kernel launched over
    the sharded steps; gradients per leaf max|dg| / max|g| within the
    larger of 1e-4 and the unsharded step's own float32 spread: the
    worst per-leaf gap between the unsharded step through cuDNN and
    through PyTorch's native convolution (cuDNN off), in this run. At
    512 px the order of float32 sums alone moves the deepest leaves by
    more than 1e-4 (in float64 the sharded gradients equal the unsharded
    ones, tests/test_torch_train_mesh.py); (b) the seg step on the (2, 2)
    mesh, the same bars; (c) three train_on_clips steps on the (2, 2)
    mesh within 1e-4 relative of the unsharded run's losses;
    (d) the median ms of 5 steps and the peak memory of each, sharded
    beside unsharded; (e) the two-process job (``h_two_process``)."""
    import torch

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import graft_seg_params, init_params
    from vidmat_torch.parallel.mesh import make_mesh
    from vidmat_torch.train.data import (synthetic_clip_batches,
                                         synthetic_seg_batches)
    from vidmat_torch.train.loop import train_on_clips

    t_phase = time.perf_counter()
    mcfg, _ = preset_video_1080p()
    variables = init_params(mcfg, seed=0)
    sv = graft_seg_params(variables, mcfg)
    meshes = {f"{axes} {shape}": make_mesh(axes, shape, devices=[
        dev] * int(math.prod(shape))) for axes, shape in H_MESHES}
    both_name = "('data', 'spatial') (2, 2)"
    both = meshes[both_name]
    size = dict(t=H_T, n=H_N, h=H_SIZE, w=H_SIZE)
    batch = [torch.from_numpy(x).to(dev) for x in next(
        synthetic_clip_batches(seed=5, **size))]
    sbatch = [torch.from_numpy(x).to(dev) for x in next(
        synthetic_seg_batches(seed=6, **size))]
    res, spread = {}, {}
    for kind, v, b in (("mat", variables, batch), ("seg", sv, sbatch)):
        ref = _h_grad_step(kind, mcfg, v, b, dev)
        with torch.backends.cudnn.flags(enabled=False):
            spread[kind] = _h_worst(_h_grad_step(kind, mcfg, v, b, dev),
                                    ref)[0]
        zero_counts(kernels)
        for name, mesh in meshes.items():
            if kind == "mat" or mesh is both:
                res[f"{kind} {name}"] = _h_worst(
                    _h_grad_step(kind, mcfg, v, b, dev, mesh), ref)
        launches = counts(kernels)
        assert not any(launches.values()), launches
    for kind, x in spread.items():
        log(f"[H] (a) the unsharded {kind} step's float32 spread, cuDNN "
            f"against the native convolution: worst per-leaf "
            f"max|dg|/max|g| {x:.3e}")
    for name, (wg, wm, ws) in res.items():
        log(f"[H] (a, b) {name} {H_SIZE}x{H_SIZE} T={H_T} N={H_N} against "
            f"unsharded: worst per-leaf max|dg|/max|g| {wg:.3e}, loss and "
            f"terms {wm:.3e} relative, running stats {ws:.3e}")
    log(f"[H] (a) hand-written kernel launches over the sharded steps "
        f"{launches}")
    assert all(wm <= 2e-5 and ws <= 1e-5 for wg, wm, ws in res.values()), \
        res
    assert all(wg <= max(1e-4, spread[name.split()[0]])
               for name, (wg, _, _) in res.items()), (res, spread)

    losses = {}
    for name, kw in (("unsharded", dict(device=dev)), ("mesh", dict(
            mesh=both))):
        seen = []
        train_on_clips(mcfg, synthetic_clip_batches(seed=7, **size),
                       num_steps=3, variables=variables,
                       callback=lambda i, m: seen.append(m["loss"]), **kw)
        losses[name] = seen
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"],
                                                    losses["unsharded"]))
    log(f"[H] (c) train_on_clips, 3 steps on the (2, 2) mesh: losses "
        f"{losses['mesh']} against unsharded {losses['unsharded']}, worst "
        f"{worst:.3e} relative")
    assert worst <= 1e-4, losses

    rows = {"unsharded": _h_step_ms(mcfg, variables, batch, dev)}
    rows.update({name: _h_step_ms(mcfg, variables, batch, dev, mesh)
                 for name, mesh in meshes.items()})
    for name, (ms, peak) in rows.items():
        log(f"[H] (d) train step {H_SIZE}x{H_SIZE} T={H_T} N={H_N}, "
            f"{name}: {ms:.2f} ms (median of 5, synchronised), peak "
            f"{peak:.1f} MiB ({gpu})")
    two = h_two_process(gpu, dev, variables, mcfg, batch, spread)
    with open(os.path.join(OUT_DIR, "train_mesh.json"), "w") as f:
        json.dump({"accuracy": res, "spread": spread, "losses": losses,
                   "ms_peak_mib": rows, "two_processes": two}, f, indent=1)
    log(f"[H] phase H took {time.perf_counter() - t_phase:.1f} s")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--h-worker"]:
        return h_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.graph import kernel_wrappers

    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__}, cuda {torch.version.cuda}")
    phase_build()
    dev = torch.device("cuda")
    mcfg, _ = preset_video_1080p()
    variables = default_variables(mcfg)
    net = build_network(mcfg, variables, dtype=torch.bfloat16, device=dev)
    net_u = build_network(mcfg, variables, dtype=torch.bfloat16, device=dev,
                          fuse_pairs=False)
    errs, inputs, sites = phase_kernels(net, net_u, dev)
    tail_errs, tail = phase_tail_kernels(inputs, dev)
    errs.update(tail_errs)
    bg_errs, bg_inputs = phase_bg_kernels(inputs, dev)
    errs.update(bg_errs)
    errs4k, inp4k = phase_4k_kernels(net, dev)
    errs.update(errs4k)
    t0 = time.perf_counter()
    pool = stream_pool()
    log(f"[M] {MS_POOL} stream frames 1920x1080 made in "
        f"{time.perf_counter() - t0:.1f} s")
    errs8, inputs8, sites8 = phase_kernels_n8(net, dev, pool)
    errs.update(errs8)
    log(f"[2] the N = 8 checks, their frames included, took "
        f"{time.perf_counter() - t0:.1f} s")
    phase_body(net, dev)
    kernels = kernel_wrappers()
    _, _, launches, _ = phase_main_path(kernels, net)
    gru_launches = phase_unfused(net, net_u, dev)
    session = phase_session(kernels, dev)
    clip480, clip_errs = phase_clip_480p(kernels, dev)
    for name, e in clip_errs.items():
        errs[name] = max(errs[name], e)
    bgs = phase_backgrounds(kernels, gpu, dev)
    for name, e in bgs["e: plate_demo, planar"]["errs"].items():
        errs[name] = max(errs[name], e)
    k4 = phase_4k(kernels, gpu, dev)
    phase_trimap(kernels, gpu, dev)
    errormap = phase_errormap(kernels, gpu, dev)
    t0 = time.perf_counter()
    multi = phase_multistream(kernels, gpu, dev, pool)
    t1 = time.perf_counter()
    phase_realtime(kernels, gpu, dev, pool)
    log(f"[M] phase M took {t1 - t0:.1f} s, phase R "
        f"{time.perf_counter() - t1:.1f} s")
    phase_pp(kernels, gpu, dev, net, pool)
    del pool
    t0 = time.perf_counter()
    deploy = phase_deploy(kernels, gpu, dev)
    t1 = time.perf_counter()
    phase_cli_eval(dev, deploy["alphas"], deploy["gt"])
    log(f"[D] phase D took {t1 - t0:.1f} s, phase L "
        f"{time.perf_counter() - t1:.1f} s")
    probe, int8_launches = phase_int8_probe(kernels)
    times = phase_timing(inputs, sites, tail, bg_inputs, inp4k, inputs8,
                         sites8)
    int8_ms = probe["int8-planes"]["ms"]
    log(f"[Q] int8 leg {int8_ms:.4f} ms = "
        f"{int8_ms / probe['bf16-planes']['ms']:.3f}x the bf16 leg "
        f"({probe['bf16-planes']['ms']:.4f}), "
        f"{int8_ms / times['int8_conv']['library_ms']:.3f}x phase 6's cuDNN "
        f"bf16 conv of the layer ({times['int8_conv']['library_ms']:.4f}, "
        "cold L2)")
    phase_profile(net, dev)
    phase_image(dev)
    phase_bench()
    phase_train(kernels, gpu, dev)
    full = phase_a16(kernels, gpu, dev)
    phase_sharded_train(kernels, gpu, dev)
    # B.6 at the full-resolution body's launch shape (phase U (h)).
    full_row = "guided_filter_coeffs (full res)"
    times[full_row] = full["time"]
    for name, e in full["errs"].items():
        errs[name] = max(errs.get(name, 0.0), e)
    with open(os.path.join(OUT_DIR, "graphs.json"), "w") as f:
        json.dump(dict(GRAPHS, errormap={
            k: v for k, v in errormap.items() if k != "graph"}), f,
            indent=1, default=str)
    log("graph paths (capture ms; fps of the run, then eager and graph "
        "again): " + "; ".join(
            f"{k} {v['capture_ms']:.1f}; {v.get('fps', 0):.2f}, "
            f"{v.get('eager_fps', 0):.2f} / {v.get('graph_fps', 0):.2f}"
            for k, v in GRAPHS.items()))

    main_path = f"convert_video, planar preset, {N_FRAMES} frames"
    # Each kernel's launches on the path that runs it (the counts of that
    # path's run, set to 0 just before it).
    paths = {
        "planar_gru": (gru_launches, "unfused planar net, 4 frames"),
        "fused_refine_float": (
            session["launches"]["fused_refine_float"],
            f"MattingSession 1088x1920 bf16 (video_1080p model), "
            f"{SESSION_FRAMES} frames"),
        "composite_rgba_packed": (
            clip480["launches"]["composite_rgba_packed"],
            f"convert_video clip_480p, {CLIP_FRAMES} frames at "
            f"{CLIP_W}x{CLIP_H}"),
        "fused_refine_composite (image)": (
            bgs["a: bg_image"]["modes"]["image"],
            f"convert_video bg_image, planar preset, {BG_FRAMES} frames"),
        "fused_refine_composite (coarse)": (
            bgs["c: bg_blur"]["modes"]["coarse"],
            f"convert_video bg_blur=16, planar preset, {BG_FRAMES} frames"),
        "int8_conv": (int8_launches,
                      "vidmat_torch/tools/bench_int8_planes.py, 3 repeats"),
        full_row: (full["launches"], full["path"]),
    }
    path4k = f"convert_video video_4k, {K_FRAMES} frames at {W4K}x{H4K}"
    for name, fn in (("ingest_pool_normalize (4K)", "ingest_pool_normalize"),
                     ("guided_filter_coeffs (4K tiled)",
                      "guided_filter_coeffs"),
                     ("fused_refine_composite (4K)",
                      "fused_refine_composite")):
        paths[name] = (k4["launches"][fn], path4k)
    # The N = 8 rows: launches of phase M's paths (each run with the
    # counts set to 0 just before it).
    path_m = (f"MultiStreamMatting multistream preset, {MS_STREAMS} x "
              f"{W}x{H}")
    for fn in ("ingest_pool_normalize", "guided_filter_coeffs",
               "fused_refine_composite", "planar_conv", "planar_conv2",
               "planar_conv_gru"):
        paths[f"{fn} (8 streams)"] = (multi["a"]["launches"][fn],
                                      f"{path_m}, bg_color, {MS_ROUNDS} "
                                      "rounds")
    paths["fused_refine_float (8 streams)"] = (
        multi["b"]["launches"]["fused_refine_float"],
        f"{path_m}, no background, 8 rounds")
    paths["fused_refine_composite (coarse, 8 streams)"] = (
        multi["f"]["blur"]["modes"]["coarse"],
        f"{path_m}, bg_blur=16, 4 rounds")

    meta = {
        "ingest_pool_normalize": ("vidmat_torch/csrc/ingest.cu",
                                  "vidmat/ops/pallas/ingest_kernel.py:140"),
        "guided_filter_coeffs": ("vidmat_torch/csrc/gf_coeffs.cu",
                                 "vidmat/ops/pallas/gf_kernel.py:123"),
        "fused_refine_composite": ("vidmat_torch/csrc/refine_composite.cu",
                                   "vidmat/ops/pallas/refine_kernel.py:302"),
        "fused_refine_composite (image)": (
            "vidmat_torch/csrc/refine_composite.cu",
            "vidmat/ops/pallas/refine_kernel.py:302"),
        "fused_refine_composite (coarse)": (
            "vidmat_torch/csrc/refine_composite.cu",
            "vidmat/ops/pallas/refine_kernel.py:302"),
        "ingest_pool_normalize (4K)": (
            "vidmat_torch/csrc/ingest.cu",
            "vidmat/ops/pallas/ingest_kernel.py:140"),
        "guided_filter_coeffs (4K tiled)": (
            "vidmat_torch/csrc/gf_coeffs.cu",
            "vidmat/ops/pallas/gf_kernel.py:123"),
        "fused_refine_composite (4K)": (
            "vidmat_torch/csrc/refine_composite.cu",
            "vidmat/ops/pallas/refine_kernel.py:302"),
        "planar_conv": ("vidmat_torch/csrc/planar_conv.cu",
                        "vidmat/ops/pallas/planar.py:188"),
        "planar_conv2": ("vidmat_torch/csrc/planar_conv2.cu",
                         "vidmat/ops/pallas/planar.py:315"),
        "planar_conv_gru": ("vidmat_torch/csrc/planar_gru.cu",
                            "vidmat/ops/pallas/planar.py:454"),
        "planar_gru": ("vidmat_torch/csrc/planar_gru.cu",
                       "vidmat/ops/pallas/planar.py:549"),
        "fused_refine_float": ("vidmat_torch/csrc/refine_float.cu",
                               "vidmat/ops/pallas/refine_kernel.py:193"),
        "composite_rgba_packed": ("vidmat_torch/csrc/composite.cu",
                                  "vidmat/ops/pallas/composite_kernel.py:95"),
        "int8_conv": ("vidmat_torch/csrc/int8_conv.cu",
                      "tools/bench_int8_planes.py:81"),
    }
    meta.update({f"{k} (8 streams)": meta[k] for k in (
        "ingest_pool_normalize", "guided_filter_coeffs",
        "fused_refine_composite", "fused_refine_float", "planar_conv",
        "planar_conv2", "planar_conv_gru")})
    meta["fused_refine_composite (coarse, 8 streams)"] = meta[
        "fused_refine_composite"]
    meta[full_row] = meta["guided_filter_coeffs"]
    rows = []
    for name, (src, rep) in meta.items():
        t = times[name]
        n, path = paths[name] if name in paths else (launches[name],
                                                      main_path)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": n, "path": path,
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     **{k: t[k] for k in ("shape", "ms_1frame",
                                          "bound_ms_1frame") if k in t}})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
