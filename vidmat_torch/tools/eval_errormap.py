"""Error-map refinement against the guided tail and the bilinear floor on
hard content (counterpart of tools/eval_errormap.py): alpha MAD and Grad
on the full frame and in the trimap's unknown band (the alphamatting.com
/ DIM region protocol, ``eval.metrics.trimap_unknown_region``).

The three tails consume the same coarse network outputs (same weights,
same recurrent trajectory: a serving body per mode steps the same
frames), so the comparison isolates the refinement stage. The bodies are
the float32 ones without the hand-written kernels (``use_pallas=False``,
``kernels=False``, ``float_output=True``), as the JAX tool builds its
bodies; this is an evaluation tool, not a serving path.

Usage: python -m vidmat_torch.tools.eval_errormap [--size 1088x1920]
           [--frames 6] [--seeds 987654 24680] [--ckpt synthetic_demo]
           [--ratio 0.25] [--hard2] [--device cuda|cpu]

Prints the JAX tool's JSON report, key for key. ``--hard2`` (the JPEG
round trip) needs cv2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1088x1920")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[987654, 24680])
    ap.add_argument("--ckpt", default="synthetic_demo")
    ap.add_argument("--ratio", type=float, default=0.25)
    ap.add_argument("--hard2", action="store_true",
                    help="use the extended HARD2 protocol (motion blur, "
                         "exposure drift, JPEG) on top of the hair/"
                         "occluder/pan/noise base")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def evaluate(args: argparse.Namespace) -> dict:
    """The report: per tail, the mean over every frame of alpha MAD and
    Grad on the full frame and in the unknown band."""
    import numpy as np
    import torch

    from vidmat_torch._device import full_fp32, resolve_device
    from vidmat_torch.config import ModelConfig, RefineConfig
    from vidmat_torch.eval.metrics import (_frame_metrics,
                                           _frame_metrics_region,
                                           trimap_unknown_region)
    from vidmat_torch.io.fixtures import HARD2, synthetic_hard_clip
    from vidmat_torch.models.weights import (build_network, build_refiner,
                                             default_refiner_variables,
                                             init_params, load_checkpoint)
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.trimap import alpha_to_trimap

    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.size.split("x"))
    cfg = ModelConfig()
    v = load_checkpoint(os.path.join(CKPT_DIR, f"{args.ckpt}.npz"),
                        template=init_params(cfg))
    net = build_network(cfg, v, device=dev)
    rcfg = RefineConfig()
    # Clamp the patch budget to the frame's patch grid (small sizes).
    n_patches = min(rcfg.errormap_patches,
                    (h // rcfg.errormap_patch_size)
                    * (w // rcfg.errormap_patch_size) // 2)
    refiner = build_refiner(default_refiner_variables(), n_patches,
                            rcfg.errormap_patch_size, device=dev)

    bodies = {}
    for mode in ("guided", "errormap", "bilinear"):
        rc = RefineConfig(mode="none" if mode == "bilinear" else mode,
                          errormap_patches=n_patches,
                          errormap_patch_size=rcfg.errormap_patch_size)
        bodies[mode] = build_serving_body(
            net, cfg, rc, h, w, args.ratio, cdtype=torch.float32, bg=None,
            use_pallas=False, kernels=False, float_output=True,
            refiner=refiner if mode == "errormap" else None)

    fkw = dict(HARD2) if args.hard2 else {}
    acc = {m: {"mad": [], "grad": [], "mad_unk": [], "grad_unk": []}
           for m in bodies}
    with torch.no_grad(), full_fp32():
        for seed in args.seeds:
            states = {m: plan.make_state(1)
                      for m, (_, plan) in bodies.items()}
            for frame, gt in synthetic_hard_clip(h, w, args.frames,
                                                 seed=seed, **fkw):
                f = torch.from_numpy(frame[None]).to(dev)
                gt_t = torch.from_numpy(gt[..., 0]).to(dev)
                region = torch.from_numpy(trimap_unknown_region(
                    alpha_to_trimap(gt[..., 0])).astype(np.float32)).to(dev)
                for m, (body, _) in bodies.items():
                    (alpha, _), states[m] = body(f, states[m])
                    a2 = alpha[0, ..., 0]
                    full = _frame_metrics(a2, gt_t)
                    unk = _frame_metrics_region(a2, gt_t, region)
                    acc[m]["mad"].append(float(full["mad"]))
                    acc[m]["grad"].append(float(full["grad"]))
                    acc[m]["mad_unk"].append(float(unk["mad"]))
                    acc[m]["grad_unk"].append(float(unk["grad"]))

    report = {"size": args.size, "ratio": args.ratio, "ckpt": args.ckpt,
              "hard2": bool(args.hard2),
              "frames": args.frames * len(args.seeds)}
    for m in bodies:
        report[m] = {k: round(float(np.mean(vs)), 5)
                     for k, vs in acc[m].items()}
    return report


def main(argv=None) -> int:
    print(json.dumps(evaluate(parse_args(argv)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
