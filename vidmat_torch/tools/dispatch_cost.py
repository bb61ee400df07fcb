"""Host cost of the kernels' custom-op dispatch on the eager serving
paths, on one CUDA card.

The kernel wrappers call ``vidmat_torch::*`` ops (``ops/library.py``),
which adds the dispatcher's per-call host time where a body runs
eagerly: the first chunk of a bucket, a partial last chunk (per-frame
bodies), and static skip. A captured graph's replay does not go through
it. This script measures those paths and the ones chip_smoke.py's phases
4, S and C report, for the package under ``--root`` (default: this
checkout), so that two trees can be compared in one run on one card:

    python vidmat_torch/tools/dispatch_cost.py --root PARENT_TREE

Prints one JSON object: ``4``: convert_video on 64 synthetic 1920x1080
frames of the video_1080p preset (fps; graph replays after the first
chunk) and the eager chunk body (host enqueue ms and wall ms of one
4-frame chunk, and of one per-frame body, medians of 20); ``S``:
MattingSession(1088, 1920) bf16 step ms (medians of 16; captured) and the
static-skip session's step on a repeated frame (eager); ``C``:
convert_video on 100 synthetic 480x864 frames of clip_480p (fps). Times
are the host's clock around synchronized calls unless named enqueue.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _median_ms(fn, n, sync):
    """(median enqueue ms, median wall ms) of n calls of fn."""
    enq, wall = [], []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        enq.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(enq), statistics.median(wall)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here,
                    help="directory holding the vidmat_torch to measure")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    import vidmat_torch
    from vidmat_torch import (MattingSession, convert_video,
                              preset_clip_480p, preset_video_1080p)
    from vidmat_torch.io.fixtures import synthetic_frames_only
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    assert os.path.dirname(vidmat_torch.__file__).startswith(
        os.path.abspath(args.root)), vidmat_torch.__file__
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0)}

    mcfg, pcfg = preset_video_1080p()
    frames = list(synthetic_frames_only(1080, 1920, 64))
    convert_video(frames[:8], output_alpha=lambda a: None, model_cfg=mcfg,
                  pipe_cfg=pcfg)
    m = convert_video(frames, output_alpha=lambda a: None, model_cfg=mcfg,
                      pipe_cfg=pcfg)
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    body, plan = build_serving_body(net, mcfg, pcfg.refine, 1088, 1920, 0.25,
                                    bg=(0.0, 1.0, 0.0))
    x = torch.from_numpy(np.stack([np.pad(f, ((0, 8), (0, 0), (0, 0)),
                                          mode="edge")
                                   for f in frames[:4]])).to(dev)
    state = plan.make_state(1)
    with torch.inference_mode():
        plan.chunk_body(x, state)
        body(x[:1], state)
        chunk = _median_ms(lambda: plan.chunk_body(x, state), 20, sync)
        frame = _median_ms(lambda: body(x[:1], state), 20, sync)
    out["4"] = {"fps": m["fps"], "eager_chunk_enqueue_ms": chunk[0],
                "eager_chunk_ms": chunk[1], "eager_frame_enqueue_ms":
                frame[0], "eager_frame_ms": frame[1]}

    sess = MattingSession(1088, 1920, model_cfg=mcfg, downsample_ratio=0.25,
                          dtype="bfloat16")
    f0 = np.pad(frames[0], ((0, 8), (0, 0), (0, 0)), mode="edge")
    sess.step(f0)
    step = _median_ms(lambda: sess.step(f0), 16, sync)
    skip = MattingSession(1088, 1920, model_cfg=mcfg, downsample_ratio=0.25,
                          dtype="bfloat16", static_skip_eps=0.5 / 255)
    skip.step(f0)
    skipped = _median_ms(lambda: skip.step(f0), 16, sync)
    out["S"] = {"step_ms": step[1], "static_skip_step_ms": skipped[1],
                "static_skip_step_enqueue_ms": skipped[0]}

    mc, pc = preset_clip_480p()
    small = list(synthetic_frames_only(480, 864, 100))
    convert_video(small[:8], output_alpha=lambda a: None, model_cfg=mc,
                  pipe_cfg=pc)
    mcl = convert_video(small, output_alpha=lambda a: None, model_cfg=mc,
                        pipe_cfg=pc)
    out["C"] = {"fps": mcl["fps"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
