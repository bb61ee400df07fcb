#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vidmat_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. build every CUDA kernel from vidmat_torch/csrc (one nvcc per source,
     in parallel); print the card's name and power limit as nvidia-smi
     reports them
  2. each kernel against its plain PyTorch version on the card, at the
     shapes and on the inputs the 1080p main path gives it (ingest
     bit-exact, guided-filter coefficients max |d| <= 1e-4,
     refine/composite bytes within +-1; the planar kernels at their 9
     call sites, and planar_gru at the 3 sites of the unfused network,
     within 1-2 bf16 units in the last place, see close()), plus ragged
     shapes per kernel
  3. the serving chunk body (ingest, planar encoder, per-frame decoder,
     guided-filter coefficients, fused tail) at 1920x1088 on fast_demo in
     bf16, kernel path against the same body on the plain versions, over
     8 recurrent frames (alpha bytes: mean |d| <= 0.5 LSB, max <= 2); then
     the fp32 body on the card against the CPU at 128x192
  4. the main path: convert_video on 64 synthetic 1920x1080 frames on the
     planar preset (chunk 4); launch counts are set to 0 just before and
     read just after (planar_conv 32, planar_conv2 112, planar_conv_gru
     192, ingest / GF / refine 16 each); alpha MAD against the fixture's
     ground truth held within 5e-3 of the JAX package's MAD on the same
     clip. Then the conv_impl="xla" path on 16 frames (its three kernels
     launch, the planar ones do not)
  5. the unfused planar network (fuse_pairs=False: planar_conv pairs,
     planar_conv + planar_gru stages) at 1080p over 4 frames against the
     fused one; planar_gru launches
  6. each kernel timed with CUDA events at the main-path shapes (L2
     flushed before every launch, the card kept busy while the host
     enqueues it), beside its bound, its plain version's
     time and, for the planar kernels, cuDNN's F.conv2d for the same
     convs (a yardstick the port never calls)
  7. where a frame's time goes on the planar chunk body: host time per
     stage, the body's wall time, device time by kernel group
     (torch.profiler); checks that the planar body launches no library
     convolution or GEMM

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Details (profile, per-site times,
compiler reports) go to chiprun_out/chip_smoke/. Exits nonzero without a
CUDA device.
"""

from __future__ import annotations

import json
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
CHUNK = 4
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


def phase_kernels(net, net_unfused, dev):
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
    chunk = torch.from_numpy(padded_clip(CHUNK, seed=11)).to(dev)
    sites = capture_sites(net, net_unfused, chunk)
    errs.update(planar_kernel_checks(sites, dev))
    log(f"[2] kernels vs plain on the card: {json.dumps(errs)} "
        "(ragged shapes agree too)")
    return errs, (frame, guide, p, ma, mb), sites


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


def capture_sites(net, net_unfused, chunk_u8):
    """The arguments of every planar call on the main path for one 4-frame
    chunk (encoder over the chunk, decoder on its first frame), and of the
    unfused network's planar_gru calls, recorded through the plain
    versions. Returns {site: (op key, args)}."""
    import torch
    import torch.nn.functional as F

    import vidmat_torch.models.planar as pm
    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain

    x = ingest_pool_normalize_plain(chunk_u8, pool=4)
    mult = 16 * net.cfg.space_to_depth
    nh, nw = x.shape[1:3]
    xp = F.pad(x.permute(0, 3, 1, 2), (0, -nw % mult, 0, -nh % mult),
               mode="replicate").permute(0, 2, 3, 1)
    calls = []
    saved = dict(pm._PLAIN)

    def recorder(key, fn):
        def rec(*args):
            calls.append((key, args))
            return fn(*args)
        return rec

    for key, fn in saved.items():
        pm._PLAIN[key] = recorder(key, fn)
    with torch.inference_mode():
        st = net.init_state(1, *xp.shape[1:3])
        net.decode(net.encode(xp, plain=True).frame(0), st, plain=True)
        fused = list(calls)
        calls.clear()
        enc = net_unfused.encode(xp, plain=True)
        net_unfused.decode(enc.frame(0), st, plain=True)
    pm._PLAIN.update(saved)
    assert [k for k, _ in fused] == [k for _, k in SITES], fused
    gru = [c for c in calls if c[0] == "gru"]
    assert len(gru) == len(GRU_SITES)
    return {name: call for (name, _), call in zip(SITES + GRU_SITES,
                                                  fused + gru)}


def planar_kernel_checks(sites, dev):
    """Each planar kernel against its plain version at its call sites and
    on ragged shapes; returns {kernel name: max |d|}."""
    import torch

    ops = planar_ops()
    ulps = {"conv": 1, "conv2": 2, "conv_gru": 2, "gru": 1}
    errs = {}
    for site, (key, args) in sites.items():
        kern, plain = ops[key]
        got, want = kern(*args), plain(*args)
        if key != "conv_gru":
            got, want = (got,), (want,)
        e = max(close(a, b, ulps[key]) for a, b in zip(got, want))
        errs[kern.__name__] = max(errs.get(kern.__name__, 0.0), e)
        x0 = args[0] if key == "gru" else args[0][0]
        log(f"    {site:8s} {kern.__name__:16s} {tuple(x0.shape)} "
            f"max |d| {e:.3g}")

    # Ragged shapes (tile edges cut the image), both plane dtypes, batch 2.
    g = torch.Generator().manual_seed(7)

    def rnd(*shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dt)

    def aff(c):
        return ((torch.rand(c, generator=g) + 0.5).to(dev),
                (torch.randn(c, generator=g) * 0.1).to(dev))

    for dt in (torch.bfloat16, torch.float32):
        xs = [rnd(2, 5, 13, 21, dt=dt), rnd(2, 3, 13, 21, dt=dt)]
        w1 = rnd(6, 8, 3, 3, dt=dt, scale=72 ** -0.5)
        w2 = rnd(4, 6, 3, 3, dt=dt, scale=54 ** -0.5)
        h = rnd(2, 3, 13, 21, dt=dt, scale=0.5)
        wg = rnd(6, 6, 3, 3, dt=dt, scale=54 ** -0.5)
        wc = rnd(3, 6, 3, 3, dt=dt, scale=54 ** -0.5)
        (s1, b1), (s2, b2), (_, bg), (_, bc) = aff(6), aff(4), aff(6), aff(3)
        cases = [("conv", (xs, w1, s1, b1, 2, "relu")),
                 ("conv", (xs, w1, s1, b1, 1, "none")),
                 ("conv2", (xs, w1, s1, b1, w2, s2, b2, 2, "relu", "none")),
                 ("conv2", (xs, w1, s1, b1, w2, s2, b2, 1, "relu", "relu")),
                 ("conv_gru", (xs, w1, s1, b1, h, wg, bg, wc, bc)),
                 ("gru", (h.clone(), h, wg, bg, wc, bc))]
        for key, args in cases:
            kern, plain = ops[key]
            got, want = kern(*args), plain(*args)
            if key != "conv_gru":
                got, want = (got,), (want,)
            for a, b in zip(got, want):
                close(a, b, ulps[key])
    torch.cuda.synchronize()
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


def phase_main_path(kernels):
    """convert_video on 64 synthetic 1920x1080 frames: the main path
    (planar preset, chunk 4); then the conv_impl="xla" path on 16."""
    import numpy as np

    from vidmat_torch import convert_video
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.utils.metrics import mad

    frames, gt = clip(N_FRAMES, seed=0)
    convert_video(frames[:8], output_alpha=lambda a: None)  # warm-up
    alphas = []
    for fn in kernels:
        fn.launches = 0
    m = convert_video(frames, output_alpha=lambda a: alphas.append(a.copy()))
    launches = {fn.__name__: fn.launches for fn in kernels}
    bench = convert_video(frames)  # packed words D2H
    assert m["frames"] == N_FRAMES and len(alphas) == N_FRAMES, m
    assert alphas[0].shape == (FRAME_H, FRAME_W)
    alpha_mad = float(np.mean([mad(a.astype(np.float32) / 255.0, g)
                               for a, g in zip(alphas, gt)]))
    log(f"[4] convert_video {N_FRAMES}x{FRAME_W}x{FRAME_H} alpha-only, "
        f"planar preset: fps {m['fps']:.2f}, p50 {m['p50_ms']:.3f} ms "
        f"({m.get('latency_granularity', 'per-frame')}), "
        f"alpha MAD vs ground truth {alpha_mad:.5f} (JAX reference "
        f"{JAX_REFERENCE_MAD}); launches {launches}")
    log(f"    benchmark mode (packed RGBA D2H): fps {bench['fps']:.2f}, "
        f"p50 {bench['p50_ms']:.3f} ms")
    assert launches == MAIN_PATH_LAUNCHES, launches
    assert abs(alpha_mad - JAX_REFERENCE_MAD) <= 5e-3, alpha_mad

    # Slice 1's configuration: the net as F.conv2d, the three other
    # kernels still on the path.
    xla = ModelConfig(space_to_depth=2, conv_impl="xla")
    convert_video(frames[:4], output_alpha=lambda a: None, model_cfg=xla)
    for fn in kernels:
        fn.launches = 0
    mx = convert_video(frames[:16], output_alpha=lambda a: None,
                       model_cfg=xla)
    xla_launches = {fn.__name__: fn.launches for fn in kernels}
    log(f"    conv_impl='xla', 16 frames: fps {mx['fps']:.2f}; launches "
        f"{xla_launches}")
    for name, n in xla_launches.items():
        assert (n > 0) == (not name.startswith("planar_")), xla_launches
    return m, bench, launches, alpha_mad


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


def phase_timing(inputs, sites):
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
            ops=frame.numel() + 4 * x.numel(), peak=F32_FLOPS_PER_S),
        "guided_filter_coeffs": dict(
            kernel=lambda: guided_filter_coeffs(guide, p),
            plain=lambda: guided_filter_coeffs_plain(guide, p),
            bytes=nbytes(guide, p, ma, mb),
            # window sums of 10 statistics and 8 coefficients, 5 products,
            # 8 + 10 scalings, ~6 ops per channel for a, b
            ops=coarse * (18 * taps + 5 + 18 + 24), peak=F32_FLOPS_PER_S),
        "fused_refine_composite": dict(
            kernel=lambda: fused_refine_composite(frame, ma, mb, None, 4),
            plain=lambda: fused_refine_composite_plain(frame, ma, mb, None, 4),
            bytes=nbytes(frame, ma, mb, packed),
            # 8 channels x 3 lerps x 3 ops, luma 6, 4 apply x 2 + clips,
            # composite 3 x 3, 4 quantizes x 3
            ops=px * (8 * 9 + 6 + 16 + 9 + 12), peak=F32_FLOPS_PER_S),
    }
    out = {}
    for name, row in rows.items():
        ms = time_cold(row["kernel"])
        plain_ms = time_cold(row["plain"], iters=10)
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["ops"] / row["peak"] * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         bytes=row["bytes"], ops=row["ops"])
        log(f"[6] {name}: {ms:.4f} ms (cold L2), plain {plain_ms:.4f} ms, "
            f"bound {out[name]['bound_ms']:.4f} ms by "
            f"{out[name]['bound_by']} ({row['bytes'] / 1e6:.2f} MB, "
            f"{row['ops'] / 1e6:.1f} Mop); library call: none computes "
            "the same function in one PyTorch call")

    # Planar kernels: per call site, then summed per kernel (one call at
    # each of its sites: a chunk's encoder calls, one frame's decoder).
    # Operations count 2 per multiply-add against the bf16 tensor-core
    # peak; bytes against HBM.
    ops = planar_ops()
    per_site = {}
    for site, (key, args) in sites.items():
        kern, plain = ops[key]
        nb, macs = site_cost(key, args)
        t_bytes = nb / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * macs / BF16_FLOPS_PER_S * 1e3
        row = dict(kernel=kern.__name__,
                   ms=time_cold(lambda: kern(*args)),
                   plain_ms=time_cold(lambda: plain(*args), iters=10),
                   library_ms=time_cold(library_call(key, args)),
                   t_bytes=t_bytes, t_ops=t_ops, bytes=nb, macs=macs)
        per_site[site] = row
        log(f"[6] {site:8s} {kern.__name__:16s} {row['ms']:.4f} ms (cold "
            f"L2), plain {row['plain_ms']:.4f}, cuDNN conv(s) "
            f"{row['library_ms']:.4f}, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nb / 1e6:.2f} MB, {macs / 1e6:.1f} M MAC)")
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
    with open(os.path.join(OUT_DIR, "planar_sites.json"), "w") as f:
        json.dump(per_site, f, indent=1)
    return out


# Kernel names of the port (the profiler's device events).
PORT_KERNELS = ("ingest_kernel", "gf_ab_kernel", "gf_box_kernel",
                "refine_composite_kernel", "planar_conv_kernel",
                "planar_conv2_kernel", "planar_gru_kernel")
LIBRARY_CONV = ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad",
                "dgrad", "nchwtonhwc", "nhwctonchw", "cutlass")


def phase_profile(net, dev):
    """Where a frame's time goes on the planar chunk body: host time of
    each pipeline stage, wall time of the body alone, device time by
    kernel group from torch.profiler (full table in
    chiprun_out/chip_smoke/profile.txt). Fails if the planar body launches
    a library convolution or GEMM (the port's net runs on its own
    kernels)."""
    import numpy as np
    import torch

    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.io.reader import pad_frame
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.video import _Transfers

    mcfg, pcfg = preset_video_1080p()
    _, plan = build_serving_body(net, mcfg, pcfg.refine, H, W, RATIO,
                                 alpha_only=True)
    body = plan.chunk_body
    frames = clip(CHUNK, seed=3)[0]
    xfer = _Transfers(dev)
    n = 8  # chunks
    st = plan.make_state(1)
    host = np.concatenate([pad_frame(f, H, W) for f in frames])
    dev_chunk = xfer.to_device(host)
    for _ in range(2):
        _, st = body(dev_chunk, st)
    torch.cuda.synchronize()

    t = {"pad": 0.0, "h2d": 0.0, "body": 0.0, "d2h": 0.0}
    t0 = time.perf_counter()
    for _ in range(n):
        a = time.perf_counter()
        hc = np.concatenate([pad_frame(f, H, W) for f in frames])
        b = time.perf_counter()
        x = xfer.to_device(hc)
        c = time.perf_counter()
        out, st = body(x, st)
        d = time.perf_counter()
        xfer.wait(xfer.to_host(out))
        e = time.perf_counter()
        t["pad"] += b - a
        t["h2d"] += c - b
        t["body"] += d - c
        t["d2h"] += e - d
    per = 1e3 / (n * CHUNK)
    seq = (time.perf_counter() - t0) * per
    t0 = time.perf_counter()
    for _ in range(n):
        _, st = body(dev_chunk, st)
    torch.cuda.synchronize()
    body_only = (time.perf_counter() - t0) * per

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            _, st = body(dev_chunk, st)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(avgs.table(sort_by="cuda_time_total", row_limit=60))
    groups = {"port kernels": 0.0, "library convolutions": 0.0,
              "other": 0.0}
    by_kernel = {}
    library = []
    for ev in avgs:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / (4 * CHUNK) / 1e3
        ours = next((o for o in PORT_KERNELS if o in ev.key), None)
        if ours:
            groups["port kernels"] += ms
            by_kernel[ours] = by_kernel.get(ours, 0.0) + ms
        elif any(c in ev.key.lower() for c in LIBRARY_CONV):
            groups["library convolutions"] += ms
            library.append(ev.key)
        else:
            groups["other"] += ms
    dev_ms = sum(groups.values())
    log(f"[7] per frame, chunk {CHUNK}, sequential (pad, H2D, body, D2H "
        f"each waited): {seq:.3f} ms = pad {t['pad'] * per:.3f} + H2D "
        f"enqueue {t['h2d'] * per:.3f} + body enqueue "
        f"{t['body'] * per:.3f} + D2H wait {t['d2h'] * per:.3f}")
    log(f"    body alone on device-resident chunks: {body_only:.3f} "
        f"ms/frame wall; device kernels {dev_ms:.3f} ms/frame (busy "
        f"{100 * dev_ms / body_only:.1f}% of the body's wall): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    log("    port kernels per frame: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sorted(by_kernel.items())))
    assert dev_ms > 0, "the profiler saw no device time"
    assert not library, f"library convolutions on the planar body: {library}"
    assert all(k in by_kernel for k in PORT_KERNELS[:6]), by_kernel


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
    from vidmat_torch.ops import planar as P
    from vidmat_torch.ops.gf import guided_filter_coeffs
    from vidmat_torch.ops.ingest import ingest_pool_normalize
    from vidmat_torch.ops.refine import fused_refine_composite

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
    phase_body(net, dev)
    kernels = [ingest_pool_normalize, guided_filter_coeffs,
               fused_refine_composite, P.planar_conv, P.planar_conv2,
               P.planar_conv_gru, P.planar_gru]
    _, _, launches, _ = phase_main_path(kernels)
    gru_launches = phase_unfused(net, net_u, dev)
    times = phase_timing(inputs, sites)
    phase_profile(net, dev)

    main_path = f"convert_video, planar preset, {N_FRAMES} frames"
    meta = {
        "ingest_pool_normalize": ("vidmat_torch/csrc/ingest.cu",
                                  "vidmat/ops/pallas/ingest_kernel.py:140"),
        "guided_filter_coeffs": ("vidmat_torch/csrc/gf_coeffs.cu",
                                 "vidmat/ops/pallas/gf_kernel.py:123"),
        "fused_refine_composite": ("vidmat_torch/csrc/refine_composite.cu",
                                   "vidmat/ops/pallas/refine_kernel.py:302"),
        "planar_conv": ("vidmat_torch/csrc/planar_conv.cu",
                        "vidmat/ops/pallas/planar.py:188"),
        "planar_conv2": ("vidmat_torch/csrc/planar_conv2.cu",
                         "vidmat/ops/pallas/planar.py:315"),
        "planar_conv_gru": ("vidmat_torch/csrc/planar_gru.cu",
                            "vidmat/ops/pallas/planar.py:454"),
        "planar_gru": ("vidmat_torch/csrc/planar_gru.cu",
                       "vidmat/ops/pallas/planar.py:549"),
    }
    rows = []
    for name, (src, rep) in meta.items():
        t = times[name]
        n, path = launches[name], main_path
        if name == "planar_gru":
            n, path = gru_launches, "unfused planar net, 4 frames"
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": n, "path": path,
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
