"""The 2-stage split of the serving chain on one device (counterpart of
tools/bench_pp_stages.py): t_stage0 (ingest, the planar net, the GF
coefficients: ``ServingPlan.fused_stage0``), t_stage1 (the fused refine
and composite: ``fused_stage1``) and the composed per-frame body, at the
video_1080p preset (1088x1920, ratio 0.25, bf16).

    python -m vidmat_torch.tools.bench_pp_stages [--chunk 4]
    python -m vidmat_torch.tools.bench_pp_stages --quick --device cpu

Each stage runs K frames a dispatch (stage 0 and the body frame by frame,
the state carried; stage 1 frame by frame on fixed grids), on the card as
one CUDA graph replay a dispatch; a time is the amortized (T_long -
T_short) / frames of chained dispatches between two synchronizations,
the median over repeats. On the card it also times the pipelined rate:
``PipelinedMatting`` on two positions of one card (two streams of it,
chunk 1, ``step_device``) beside one position (``MultiStreamMatting`` of
one stream, ``step_device``), both over a green background. Prints one
JSON object; ``--quick`` uses 128x256 frames at ratio 0.5 and fewer
repeats (a few seconds on the CPU; CPU numbers are not the card's).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="128x256 frames at ratio 0.5 (CPU / debug)")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from vidmat_torch._device import resolve_device
    from vidmat_torch.config import PRESETS
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.graph import ChunkGraph, per_frame_chunk
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cfg, pcfg = PRESETS["video_1080p"]()
    h, w = (128, 256) if args.quick else (1088, 1920)
    ratio = 0.5 if args.quick else pcfg.downsample_ratio
    repeats = 1 if args.quick else args.repeats
    k = max(1, args.chunk)
    variables = default_variables(cfg)
    net = build_network(cfg, variables, dtype=torch.bfloat16, device=dev)
    body, plan = build_serving_body(net, cfg, pcfg.refine, h, w, ratio,
                                    cdtype=torch.bfloat16, bg=None)
    assert plan.fused_stage0 is not None, "preset must take the fused tail"
    stage0, stage1 = plan.fused_stage0, plan.fused_stage1

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 255, (k, 1, h, w, 3), np.uint8)).to(dev)
    (ma, mb), _ = stage0(frames[0], plan.make_state(1))

    def chain_s0(fr, st):
        outs = []
        for j in range(fr.shape[0]):
            grids, st = stage0(fr[j], st)
            outs.append(grids[0])
        return torch.stack(outs), st

    def chain_s1(fr, st):
        return torch.stack([stage1(fr[j], ma, mb, None)
                            for j in range(fr.shape[0])]), st

    chain_full = per_frame_chunk(body)
    targets = [("composed body (t0+t1)",
                lambda fr, st: chain_full(fr.flatten(0, 1), st)),
               ("stage0: ingest+net+coeffs", chain_s0),
               ("stage1: fused refine+composite", chain_s1)]

    def dispatcher(fn):
        """fn as one call a K-frame dispatch: a graph replay on the card
        (after an eager warm-up), else the eager call."""
        st = plan.make_state(1)
        _, st = fn(frames, st)  # warm-up
        if not cuda:
            return lambda: fn(frames, st)
        g = ChunkGraph(fn, frames, st)
        return lambda: g(g.state)

    def per_frame_s(run, n_short=2 if args.quick else 6,
                    n_long=4 if args.quick else 36, frames_per_run=k):
        samples = []
        for _ in range(repeats):
            ts = []
            for n in (n_short, n_long):
                sync()
                t0 = time.perf_counter()
                for _ in range(n):
                    run()
                sync()
                ts.append(time.perf_counter() - t0)
            spf = (ts[1] - ts[0]) / ((n_long - n_short) * frames_per_run)
            if spf > 0:
                samples.append(spf)
        return samples

    rows = []
    for label, fn in targets:
        s = per_frame_s(dispatcher(fn))
        rows.append({"label": label,
                     "ms_per_frame": (round(float(np.median(s)) * 1e3, 4)
                                      if s else float("nan")),
                     "n_valid": len(s)})
    t_full, t0_, t1_ = (r["ms_per_frame"] for r in rows)
    record = {
        "resolution": f"{w}x{h}", "chunk": k, "stages": rows,
        "projection": {
            "pp_steady_ms_per_frame": round(max(t0_, t1_), 4),
            "projected_speedup_vs_1_position": round(
                t_full / max(t0_, t1_), 3)},
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "gpu": gpu_line() if cuda else None,
    }
    if cuda:
        from vidmat_torch.parallel.mesh import make_mesh
        from vidmat_torch.parallel.multistream import MultiStreamMatting
        from vidmat_torch.parallel.pp import PipelinedMatting

        kw = dict(cfg=cfg, variables=variables, downsample_ratio=ratio,
                  bg_color=(0.0, 1.0, 0.0))
        pp = PipelinedMatting(h, w, make_mesh(("pp",),
                                              devices=[dev, dev]), **kw)
        one = MultiStreamMatting(1, h, w, device=dev, **kw)
        ring = [torch.from_numpy(rng.randint(0, 255, (1, 1, h, w, 3),
                                             np.uint8)).to(dev)
                for _ in range(4)]
        reset = torch.zeros(1, dtype=torch.uint8, device=dev)
        it = {"pp": 0, "one": 0}

        def run_pp():
            pp.step_device(ring[it["pp"] % 4])
            it["pp"] += 1

        def run_one():
            one.step_device(ring[it["one"] % 4][0], reset)
            it["one"] += 1

        for run in (run_pp, run_one):
            run()
            run()  # the eager warm-up, then the capture
        fps = {}
        for name, run in (("two positions of one card", run_pp),
                          ("one position", run_one)):
            s = per_frame_s(run, 24, 240, frames_per_run=1)
            fps[name] = round(1.0 / float(np.median(s)), 2) if s else None
        record["pipelined_fps"] = fps
        record["pipelined_launches"] = {
            f"position {i}": dict(p.launches)
            for i, p in enumerate(pp.positions)}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
