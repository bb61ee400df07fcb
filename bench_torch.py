#!/usr/bin/env python3
"""Benchmark of the PyTorch port (vidmat_torch) on one CUDA card.

    python3 bench_torch.py [--mode 1080p|4k|4k_tiled|480p|e2e|multistream]
                           [--quick]
                           [--chunk K]
                           [--net planar|xla] [--bg-blur RADIUS]
                           [--device cuda|cpu]

The port's counterpart of ``bench.py`` (the JAX package's bench, which
stays as it is); it imports neither ``jax`` nor ``vidmat``. It runs on
the card, and raises without one unless given ``--device cpu`` (the
plain PyTorch path: numbers of the host's CPU, not of a card). It uses
the shipped weights: throughput does not depend on them.

Modes:
  1080p (default)  the ``video_1080p`` preset at 1088x1920 on a
      device-resident ring of 4 chunks, through the callable the pipeline
      dispatches per chunk: one copy into the captured graph's input
      chunk and one graph replay (``pipeline.graph.ChunkGraph``) on the
      card; the eager chunk body on the CPU. Amortized timing: (T_long -
      T_short) / (frames_long - frames_short) over chains that end in
      ``torch.cuda.synchronize()``, median over repeats. Also
      ``p50_ms_per_frame``, the same timing through the per-frame body.
  480p  the ``clip_480p`` preset at 480x864 (chunk 10: its per-frame
      body ten times a dispatch, one graph replay on the card, as the
      pipeline runs it).
  4k_tiled  the ``video_4k`` preset at 2176x3840 (``bench.py``'s 4K
      shape; ratio 0.125, pool 8, tiles of 1024 with an overlap of 128,
      chunk 1: the per-frame body, tiled guided-filter statistics and the
      whole-frame fused tail, one graph replay a frame on the card), 120
      timed frames.
  4k    the same with tiling dropped (labelled "(tile_size=None
      variant)", as ``bench.py`` labels it).
  e2e   ``VideoPipeline.run`` (what ``convert_video`` runs) on 120
      1920x1080 frames fed from the host, with an alpha sink that drops
      the frames: staging, H2D, the graph, D2H and the sink, no video
      encode (the card's machine has no cv2); ``h2d_ms_per_frame`` is the
      median of 5 pinned copies of one frame.
  multistream  the ``multistream`` preset (``bench.py``'s): 8 streams of
      1088x1920 at ratio 0.25 as one (8, 1088, 1920, 3) batch a round,
      the per-frame body (packed tail, no background) on a
      device-resident ring, one graph replay a round on the card;
      ``value`` is the aggregate fps (8 frames a round), ``p50_ms`` the
      round's time. Chunk 1 only.

--quick runs 256x512 frames (pool 4 at the 1080p ratio and in the
multistream mode, pool 8 in the 4K modes, whose tiles shrink to 128 with
an overlap of 32) and short chains. Prints one JSON line with
``bench.py``'s keys. ``vs_baseline`` is against the repository's 200 fps
target for 1080p (a target, not a measurement of any device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

TARGET_FPS = 200.0  # the repository's 1080p throughput target


def _gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def _device_fields(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev),
                "nvidia_smi": _gpu_line()}
    return {"device": "cpu"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_e2e(dev: torch.device, quick: bool) -> dict:
    """Host-fed end to end through the pipeline, alpha output."""
    from concurrent.futures import ThreadPoolExecutor

    from vidmat_torch.config import PRESETS
    from vidmat_torch.io.fixtures import synthetic_frame
    from vidmat_torch.pipeline.video import VideoPipeline

    h, w, n = (256, 512, 24) if quick else (1080, 1920, 120)
    # synthetic_frames_only's frames, made on 4 host threads (numpy
    # releases the GIL).
    with ThreadPoolExecutor(4) as ex:
        frames = [f for f, _ in ex.map(
            lambda i: synthetic_frame(h, w, i / n), range(n))]
    cfg, pipe = PRESETS["video_1080p"]()
    pipeline = VideoPipeline(model_cfg=cfg, pipe_cfg=pipe, device=dev)
    # The warm run builds the kernels and captures the chunk graph; the
    # timed run reuses the bucket (body, graph, buffers).
    pipeline.run(frames[:2 * pipe.chunk_size], output_alpha=lambda a: None)
    _sync(dev)
    t0 = time.perf_counter()
    m = pipeline.run(frames, output_alpha=lambda a: None)
    wall = time.perf_counter() - t0
    h2d = []
    host = torch.from_numpy(frames[0][None])
    if dev.type == "cuda":
        host = host.pin_memory()
    dst = torch.empty(host.shape, dtype=host.dtype, device=dev)
    for _ in range(5):
        _sync(dev)
        t1 = time.perf_counter()
        dst.copy_(host, non_blocking=True)
        _sync(dev)
        h2d.append(time.perf_counter() - t1)
    fps = n / wall
    return {
        "metric": "e2e host-fed 1080p pipeline throughput "
                  "(staging+H2D+matting+D2H+sink; no encode)",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / TARGET_FPS, 3),
        "p50_ms": round(m.get("p50_ms", 1e3 * wall / n), 2),
        "h2d_ms_per_frame": round(1e3 * float(np.median(h2d)), 3),
        **_device_fields(dev),
        "resolution": f"{w}x{h}",
        "frames": n,
        "encode": "none: an alpha sink that drops the frames (the card's "
                  "machine has no cv2 for mp4)",
        "graph_capture_ms": m.get("graph_capture_ms"),
    }


def _dispatcher(plan, body, chunk: int, h: int, w: int, dev, ring0,
                batch: int = 1):
    """The callable the pipeline dispatches per group of ``chunk`` frames
    on a device chunk, and what it is: the chunk body where the plan has
    one, else ``chunk`` calls of the per-frame body; with ``batch`` > 1
    streams the per-frame body on a (batch, h, w, 3) round. On the card
    one replay of it captured as a CUDA graph, as the pipeline runs it."""
    from vidmat_torch.pipeline.graph import ChunkGraph, per_frame_chunk

    if batch > 1:
        fn = body
        what = eager = f"per-frame body on {batch} streams"
    elif chunk > 1 and plan.chunk_body is not None:
        fn, what, eager = plan.chunk_body, "chunk body", "eager chunk body"
    else:
        fn = per_frame_chunk(body)
        what = eager = "per-frame body" + (f" x{chunk}" if chunk > 1 else "")
    if dev.type != "cuda":
        return fn, eager
    static_in = torch.empty(ring0.shape, dtype=torch.uint8, device=dev)
    static_in.copy_(ring0)
    _, st = fn(static_in, plan.make_state(batch))  # warm-up
    graph = ChunkGraph(fn, static_in, st)

    def replay(frames, state):
        static_in.copy_(frames, non_blocking=True)
        return graph(state)

    return replay, f"one CUDA graph launch per chunk ({what})"


def bench_ring(mode: str, args, dev: torch.device) -> dict:
    from vidmat_torch.config import PRESETS
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    preset_name = {"1080p": "video_1080p", "480p": "clip_480p",
                   "4k": "video_4k", "4k_tiled": "video_4k",
                   "multistream": "multistream"}[mode]
    cfg, pcfg, *scfg = PRESETS[preset_name]()
    label = preset_name
    # Streams a round: the multistream preset's batch of 1088x1920
    # streams (bench.py:534-538), one stream elsewhere.
    batch = scfg[0].num_streams if scfg else 1
    tile = {}
    if mode == "4k_tiled":
        tile = dict(tile_size=pcfg.tile_size, tile_overlap=pcfg.tile_overlap)
    elif mode == "4k":
        label += " (tile_size=None variant)"
    if args.quick:
        h, w, frames_timed, max_pairs = 256, 512, 8, 2
        label += " (256x512 quick shapes)"
        if tile:
            tile = dict(tile_size=128, tile_overlap=32)
            label += " (tile 128, overlap 32)"
    elif mode == "480p":
        h, w, frames_timed, max_pairs = 480, 864, 240, 21
    elif mode in ("4k", "4k_tiled"):
        h, w, frames_timed, max_pairs = 2176, 3840, 120, 21
    elif scfg:
        h, w, frames_timed, max_pairs = (scfg[0].height, scfg[0].width, 120,
                                         21)
    else:
        h, w, frames_timed, max_pairs = 1088, 1920, 240, 21
    ratio = scfg[0].downsample_ratio if scfg else pcfg.downsample_ratio
    if args.net is not None and args.net != cfg.conv_impl:
        cfg = dataclasses.replace(cfg, conv_impl=args.net)
        label += f" (--net={args.net} override)"
    if args.bg_blur:
        label += f" (bg_blur={args.bg_blur} portrait tail)"
    cdtype = torch.bfloat16 if pcfg.dtype == "bfloat16" else torch.float32
    net = build_network(cfg, default_variables(cfg),
                        dtype=cdtype if cdtype == torch.bfloat16 else None,
                        device=dev)
    body, plan = build_serving_body(net, cfg, pcfg.refine, h, w, ratio,
                                    cdtype=cdtype, bg=None,
                                    bg_blur=args.bg_blur, **tile)
    chunk = max(1, args.chunk if args.chunk is not None
                else pcfg.chunk_size)
    if batch > 1 and chunk > 1:
        raise ValueError("--mode multistream dispatches one round (chunk 1)")
    g = torch.Generator().manual_seed(0)

    def make_ring(k):
        return [torch.randint(0, 256, (k * batch, h, w, 3), generator=g,
                              dtype=torch.uint8).to(dev) for _ in range(4)]

    def measure(step_fn, k):
        """Seconds per dispatch of one frame of each of the ``batch``
        streams (a round) in chained dispatches of k rounds, amortized:
        (T_long - T_short) / (rounds_long - rounds_short), median over
        repeats until the interquartile range is within 30% of the
        median (at most max_pairs)."""
        ring = make_ring(k)

        def run_chain(n_frames):
            state = plan.make_state(batch)
            _sync(dev)
            t0 = time.perf_counter()
            for i in range(n_frames // k):
                _, state = step_fn(ring[i % 4], state)
            _sync(dev)
            return time.perf_counter() - t0

        run_chain(2 * k)  # warm-up
        n_timed = frames_timed * (2 if k > 1 else 1)
        n_short = max(1, n_timed // (6 * k)) * k
        n_long = max(n_short // k + 1, n_timed // k) * k
        samples = []
        while True:
            t_short = run_chain(n_short)
            t_long = run_chain(n_long)
            samples.append((t_long - t_short) / (n_long - n_short))
            valid = [p for p in samples if p > 0]
            if len(samples) >= max_pairs:
                break
            if len(valid) >= 9:
                q1, med, q3 = np.percentile(valid, [25, 50, 75])
                if (q3 - q1) <= 0.3 * med:
                    break
        valid = [p for p in samples if p > 0] or samples
        return float(np.median(valid)), valid, len(samples) - len(valid)

    step, dispatch = _dispatcher(plan, body, chunk, h, w, dev,
                                 make_ring(chunk)[0], batch)
    spf, valid, n_dropped = measure(step, chunk)
    fps = batch / spf
    name = mode
    if args.quick:
        name += "-quick"
    result = {
        "metric": f"{name} recurrent matting throughput (frames/sec/gpu)",
        "value": round(fps, 2),
        "unit": "fps/gpu",
        "vs_baseline": round(fps / TARGET_FPS, 3),
        "p50_ms": round(spf * 1e3, 4),
        "fps_min": round(batch / max(valid), 2),
        "fps_max": round(batch / min(valid), 2),
        "n_dropped_samples": n_dropped,
        **_device_fields(dev),
        "resolution": f"{w}x{h}" + (f" x{batch} streams" if batch > 1
                                    else ""),
        "batch": batch,
        "downsample_ratio": ratio,
        "dtype": pcfg.dtype,
        "conv_impl": cfg.conv_impl,
        "preset": label,
        "chunk": chunk,
        "dispatch": dispatch,
        **tile,
        "p50_ms_amortized": round(spf * 1e3, 4),
    }
    if chunk > 1:
        result["latency_granularity"] = f"per-{chunk}-frame-dispatch"
        spf1, _, _ = measure(body, 1)
        result["p50_ms_per_frame"] = round(spf1 * 1e3, 4)
        result["fps_per_frame_dispatch"] = round(1.0 / spf1, 2)
    else:
        result["p50_ms_per_frame"] = result["p50_ms"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="1080p",
                    choices=["1080p", "4k", "4k_tiled", "multistream",
                             "480p", "e2e", "smoke"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--net", default=None, choices=["planar", "xla"],
                    help="override the preset's conv_impl")
    ap.add_argument("--chunk", type=int, default=None,
                    help="frames per dispatch (default: the preset's)")
    ap.add_argument("--bg-blur", type=int, default=None, metavar="RADIUS",
                    help="the portrait-blur tail (coarse-mode refine)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.mode == "smoke":
        print("the port's kernel smoke run is python3 chip_smoke.py",
              file=sys.stderr)
        return 2
    from vidmat_torch._device import resolve_device

    dev = resolve_device(args.device)
    if args.mode == "e2e":
        result = bench_e2e(dev, args.quick)
    else:
        result = bench_ring(args.mode, args, dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
