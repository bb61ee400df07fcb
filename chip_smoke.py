#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vidmat_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. build every CUDA kernel of the serving path from vidmat_torch/csrc
     (one nvcc per source, in parallel); print the card's name and power
     limit as nvidia-smi reports them
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the 1080p main path gives it (ingest bit-exact, guided-filter
     coefficients max |d| <= 1e-4, refine/composite bytes within +-1),
     plus one ragged shape per kernel
  3. the whole serving body at 1920x1088 on fast_demo in bf16, kernel path
     against the same body on the plain versions, over 8 recurrent frames
     (alpha bytes: mean |d| <= 0.5 LSB, max <= 2)
  4. the main path: convert_video on 64 synthetic 1920x1080 frames; the
     kernels' launch counts are set to 0 just before and read just after
     (each must be > 0); prints fps, p50 and alpha MAD against the
     fixture's ground truth, held within 5e-3 of the JAX package's MAD on
     the same clip
  5. each kernel timed with CUDA events at the main-path shapes (L2
     flushed before every launch), beside its byte bound and its plain
     version's time
  6. where a frame's time goes: host time per pipeline stage, the serving
     body's wall time, device time by kernel group (torch.profiler);
     informative, not a check

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Details (profile, compiler
reports) go to chiprun_out/chip_smoke/. Exits nonzero without a CUDA
device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

FRAME_H, FRAME_W = 1080, 1920   # source frames
H, W = 1088, 1920               # /16 bucket the pipeline pads to
RATIO = 0.25                    # -> pool 4, 272x480 coarse grid
N_FRAMES = 64
# Alpha MAD of the JAX package on the same 64-frame clip and configuration
# (tests/torch_reference_mad.py, CPU): the port's MAD is held to it.
JAX_REFERENCE_MAD = 0.08868


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


def clip(n, seed=0):
    """n synthetic source frames and their ground-truth alphas."""
    from vidmat_torch.io.fixtures import synthetic_clip

    frames, alphas = [], []
    for f, a in synthetic_clip(FRAME_H, FRAME_W, n, seed=seed):
        frames.append(f)
        alphas.append(a[..., 0])
    return frames, alphas


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

    from vidmat_torch.models.matting_net import init_state
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
        st = init_state(net.cfg, 1, sh, sw, torch.bfloat16, frame_u8.device)
        alpha, fgr, _ = net(xp, st)
    guide = gray_guide(x.float())
    p = torch.cat([alpha[:, :nh, :nw], fgr[:, :nh, :nw]], -1).float()
    ma, mb = guided_filter_coeffs_plain(guide, p)
    return guide.contiguous(), p.contiguous(), ma, mb


def phase_kernels(net, dev):
    """Each kernel against its plain version at the main-path shapes."""
    import torch

    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
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
    ka, kb = guided_filter_coeffs(guide, p)
    pa, pb = guided_filter_coeffs_plain(guide, p)
    torch.cuda.synchronize()
    errs["guided_filter_coeffs"] = float(max((ka - pa).abs().max(),
                                             (kb - pb).abs().max()))
    assert errs["guided_filter_coeffs"] <= 1e-4, errs

    ma, mb = pa, pb
    for bg in (None, (0.0, 1.0, 0.0)):
        k = fused_refine_composite(frame, ma, mb, bg, 4)
        q = fused_refine_composite_plain(frame, ma, mb, bg, 4)
        d = (k.view(torch.uint8).int() - q.view(torch.uint8).int()).abs()
        errs["fused_refine_composite"] = max(
            errs.get("fused_refine_composite", 0.0), float(d.max()))
        log(f"    refine bg={bg}: bytes mean |d| {float(d.float().mean()):.3g}"
            f" max {int(d.max())}")
    assert errs["fused_refine_composite"] <= 1, errs

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
        ka, kb = guided_filter_coeffs(gi, pi, r, 1e-3)
        pa, pb = guided_filter_coeffs_plain(gi, pi, r, 1e-3)
        e = float(max((ka - pa).abs().max(), (kb - pb).abs().max()))
        assert e <= 1e-4, (r, e)
    fr = torch.randint(0, 256, (2, 36, 300, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    a = (torch.rand((2, 9, 75, 4), generator=g) * 2 - 0.5).to(dev)
    b = (torch.rand((2, 9, 75, 4), generator=g) - 0.5).to(dev)
    d = (fused_refine_composite(fr, a, b, (0.3, 0.2, 0.1), 4).view(
        torch.uint8).int() - fused_refine_composite_plain(
        fr, a, b, (0.3, 0.2, 0.1), 4).view(torch.uint8).int()).abs()
    assert int(d.max()) <= 1, int(d.max())
    torch.cuda.synchronize()
    log(f"[2] kernels vs plain on the card: {json.dumps(errs)} "
        "(ragged shapes agree too)")
    return errs, (frame, guide, p, ma, mb)


def phase_body(net, dev):
    """Serving body on the kernels against the body on the plain versions,
    8 recurrent frames at 1088x1920, bf16."""
    import torch

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    mcfg, pcfg = preset_video_1080p()
    bk, plan = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO)
    bp, _ = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO,
                               kernels=False)
    assert plan.pool == 4, plan
    padded = padded_clip(8, seed=2)
    sk, sp = plan.make_state(1), plan.make_state(1)
    worst_mean = worst_max = 0.0
    for i in range(len(padded)):
        f = torch.from_numpy(padded[i:i + 1]).to(dev)
        ok_, sk = bk(f, sk)
        op_, sp = bp(f, sp)
        ak = ok_.view(torch.uint8).reshape(1, H, W, 4)[..., 3].int()
        ap = op_.view(torch.uint8).reshape(1, H, W, 4)[..., 3].int()
        d = (ak - ap).abs().float()
        worst_mean = max(worst_mean, float(d.mean()))
        worst_max = max(worst_max, float(d.max()))
    torch.cuda.synchronize()
    log(f"[3] serving body kernels vs plain, 8 frames: alpha bytes "
        f"worst-frame mean |d| {worst_mean:.4g}, max {worst_max:.0f}")
    assert worst_mean <= 0.5 and worst_max <= 2, (worst_mean, worst_max)

    # The card against the CPU on a small input, fp32: the CPU body is the
    # one the tests hold to the JAX package (tests/test_torch_serving.py).
    from vidmat_torch.io.fixtures import synthetic_frames_only
    from vidmat_torch.models.weights import build_network, default_variables

    variables = default_variables(mcfg)
    outs = {}
    for d in (dev, torch.device("cpu")):
        net32 = build_network(mcfg, variables, device=d)
        body, plan32 = build_serving_body(net32, mcfg, pcfg.refine, 128, 192,
                                          RATIO, cdtype=torch.float32)
        st = plan32.make_state(1)
        outs[d.type] = []
        for f in synthetic_frames_only(128, 192, 8, seed=3):
            o, st = body(torch.from_numpy(f[None]).to(d), st)
            outs[d.type].append(o.cpu().view(torch.uint8).int())
    d = (torch.stack(outs["cuda"]) - torch.stack(outs["cpu"])).abs().float()
    log(f"    fp32 128x192 card vs CPU, 8 frames: packed bytes mean |d| "
        f"{float(d.mean()):.4g}, max {float(d.max()):.0f}")
    assert float(d.mean()) <= 0.26 and float(d.max()) <= 2
    return {"alpha_mean_abs_lsb": worst_mean, "alpha_max_abs_lsb": worst_max}


def phase_main_path(kernels, device="cuda"):
    """convert_video on 64 synthetic 1920x1080 frames: the main path."""
    import numpy as np

    from vidmat_torch import convert_video
    from vidmat_torch.utils.metrics import mad

    frames, gt = clip(N_FRAMES, seed=0)
    convert_video(frames[:8], output_alpha=lambda a: None,  # warm-up
                  device=device)
    alphas = []
    for fn in kernels:
        fn.launches = 0
    m = convert_video(frames, output_alpha=lambda a: alphas.append(a.copy()),
                      device=device)
    launches = {fn.__name__: fn.launches for fn in kernels}
    bench = convert_video(frames, device=device)  # packed words D2H
    assert m["frames"] == N_FRAMES and len(alphas) == N_FRAMES, m
    assert alphas[0].shape == (FRAME_H, FRAME_W)
    alpha_mad = float(np.mean([mad(a.astype(np.float32) / 255.0, g)
                               for a, g in zip(alphas, gt)]))
    log(f"[4] convert_video {N_FRAMES}x{FRAME_W}x{FRAME_H} alpha-only: "
        f"fps {m['fps']:.2f}, p50 {m['p50_ms']:.3f} ms "
        f"({m.get('latency_granularity', 'per-frame')}), "
        f"alpha MAD vs ground truth {alpha_mad:.5f} (JAX reference "
        f"{JAX_REFERENCE_MAD}); launches {launches}")
    log(f"    benchmark mode (packed RGBA D2H): fps {bench['fps']:.2f}, "
        f"p50 {bench['p50_ms']:.3f} ms")
    assert device == "cpu" or all(v > 0 for v in launches.values()), \
        launches
    assert abs(alpha_mad - JAX_REFERENCE_MAD) <= 5e-3, alpha_mad
    return m, bench, launches, alpha_mad


def time_cold(fn, iters=50):
    """Median device time (ms) of fn() with the L2 cache flushed before
    each call, by CUDA events around the call alone."""
    import torch

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
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


def phase_timing(inputs):
    import torch

    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    frame, guide, p, ma, mb = inputs
    x = ingest_pool_normalize(frame, pool=4)
    packed = fused_refine_composite(frame, ma, mb, None, 4)
    px = frame.shape[1] * frame.shape[2]
    coarse = guide.shape[1] * guide.shape[2]
    r = 4
    taps = 2 * (2 * r + 1)
    rows = {
        "ingest_pool_normalize": dict(
            kernel=lambda: ingest_pool_normalize(frame, pool=4),
            plain=lambda: ingest_pool_normalize_plain(frame, pool=4),
            bytes=nbytes(frame, x),
            # one add per input byte, 3 multiplies + 1 add per output value
            ops=frame.numel() + 4 * x.numel()),
        "guided_filter_coeffs": dict(
            kernel=lambda: guided_filter_coeffs(guide, p),
            plain=lambda: guided_filter_coeffs_plain(guide, p),
            bytes=nbytes(guide, p, ma, mb),
            # window sums of 10 statistics and 8 coefficients, 5 products,
            # 8 + 10 scalings, ~6 ops per channel for a, b
            ops=coarse * (18 * taps + 5 + 18 + 24)),
        "fused_refine_composite": dict(
            kernel=lambda: fused_refine_composite(frame, ma, mb, None, 4),
            plain=lambda: fused_refine_composite_plain(frame, ma, mb, None, 4),
            bytes=nbytes(frame, ma, mb, packed),
            # 8 channels x 3 lerps x 3 ops, luma 6, 4 apply x 2 + clips,
            # composite 3 x 3, 4 quantizes x 3
            ops=px * (8 * 9 + 6 + 16 + 9 + 12)),
    }
    out = {}
    for name, row in rows.items():
        ms = time_cold(row["kernel"])
        plain_ms = time_cold(row["plain"], iters=10)
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["ops"] / F32_FLOPS_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         bytes=row["bytes"], ops=row["ops"])
        log(f"[5] {name}: {ms:.4f} ms (cold L2), plain {plain_ms:.4f} ms, "
            f"bound {out[name]['bound_ms']:.4f} ms by "
            f"{out[name]['bound_by']} ({row['bytes'] / 1e6:.2f} MB, "
            f"{row['ops'] / 1e6:.1f} Mop); library call: none computes "
            "the same function in one PyTorch call")
    return out


def phase_profile(net, dev):
    """Where a frame's time goes: host time of each pipeline stage, wall
    time of the serving body alone, and device time by kernel group from
    torch.profiler (full table in chiprun_out/chip_smoke/profile.txt)."""
    import torch

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.io.reader import pad_frame
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.video import _Transfers

    mcfg, pcfg = preset_video_1080p()
    body, plan = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO,
                                    alpha_only=True)
    frames = clip(4, seed=3)[0]
    xfer = _Transfers(dev)
    n = 32
    st = plan.make_state(1)
    fr = [xfer.to_device(pad_frame(f, H, W)) for f in frames]
    for f in fr:
        _, st = body(f, st)
    torch.cuda.synchronize()

    t = {"pad": 0.0, "h2d": 0.0, "body": 0.0, "d2h": 0.0}
    t0 = time.perf_counter()
    for i in range(n):
        a = time.perf_counter()
        host = pad_frame(frames[i % 4], H, W)
        b = time.perf_counter()
        x = xfer.to_device(host)
        c = time.perf_counter()
        out, st = body(x, st)
        d = time.perf_counter()
        xfer.wait(xfer.to_host(out))
        e = time.perf_counter()
        t["pad"] += b - a
        t["h2d"] += c - b
        t["body"] += d - c
        t["d2h"] += e - d
    seq = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for i in range(n):
        _, st = body(fr[i % 4], st)
    torch.cuda.synchronize()
    body_only = (time.perf_counter() - t0) / n

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(16):
            _, st = body(fr[i % 4], st)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(avgs.table(sort_by="cuda_time_total", row_limit=60))
    groups = {"port kernels": 0.0, "convolutions": 0.0, "other": 0.0}
    ours = ("ingest_kernel", "gf_ab_kernel", "gf_box_kernel",
            "refine_composite_kernel")
    for ev in avgs:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = ("port kernels" if any(o in ev.key for o in ours)
             else "convolutions" if any(c in ev.key.lower() for c in (
                 "conv", "xmma", "gemm", "cudnn", "nchwtonhwc",
                 "nhwctonchw")) else "other")
        groups[k] += ev.self_device_time_total / 16 / 1e3
    dev_ms = sum(groups.values())
    log(f"[6] per frame, sequential (pad, H2D, body, D2H each waited): "
        f"{seq * 1e3:.3f} ms = pad {t['pad'] / n * 1e3:.3f} + H2D enqueue "
        f"{t['h2d'] / n * 1e3:.3f} + body enqueue {t['body'] / n * 1e3:.3f}"
        f" + D2H wait {t['d2h'] / n * 1e3:.3f}")
    log(f"    body alone on device-resident frames: {body_only * 1e3:.3f} "
        f"ms/frame wall; device kernels {dev_ms:.3f} ms/frame (busy "
        f"{100 * dev_ms / (body_only * 1e3):.1f}% of the body's wall): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.ops.gf import guided_filter_coeffs
    from vidmat_torch.ops.ingest import ingest_pool_normalize
    from vidmat_torch.ops.refine import fused_refine_composite

    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__}, cuda {torch.version.cuda}")
    phase_build()
    dev = torch.device("cuda")
    mcfg, _ = preset_video_1080p()
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    errs, inputs = phase_kernels(net, dev)
    phase_body(net, dev)
    kernels = [ingest_pool_normalize, guided_filter_coeffs,
               fused_refine_composite]
    _, _, launches, _ = phase_main_path(kernels)
    times = phase_timing(inputs)
    try:
        phase_profile(net, dev)
    except Exception as e:  # the breakdown is informative, not a check
        log(f"[6] profile unavailable: {e!r}")

    meta = {
        "ingest_pool_normalize": ("vidmat_torch/csrc/ingest.cu",
                                  "vidmat/ops/pallas/ingest_kernel.py:140"),
        "guided_filter_coeffs": ("vidmat_torch/csrc/gf_coeffs.cu",
                                 "vidmat/ops/pallas/gf_kernel.py:123"),
        "fused_refine_composite": ("vidmat_torch/csrc/refine_composite.cu",
                                   "vidmat/ops/pallas/refine_kernel.py:302"),
    }
    rows = []
    for name, (src, rep) in meta.items():
        t = times[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
