"""Quality report of the port: every shipped checkpoint scored with the
full matting metric set (``vidmat_torch.eval``) on held-out synthetic
clips, through the port's sessions (counterpart of
tools/quality_report.py).

Writes a markdown table (``docs/QUALITY_TORCH.md`` with --write) in the
literature's units (MAD/MSE x1e3, SAD/Grad/Conn /1e3, dtSSD x1e2).

Held-out protocol: the fixture seeds of the JAX package's report (never
used in training) and its fixtures: the moving-disk clip (the plate
family: the camouflaged clean-plate clip), and the extended hard suite
(``HARD2``; the plate family ``HARD_PLATE``), whose JPEG round trip needs
cv2. The weights are ``vidmat_torch/checkpoints/*.npz``.

Usage: python -m vidmat_torch.tools.quality_report [--write] [--frames N]
           [--size HxW] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HELD_OUT_SEEDS = (987654, 24680, 1357911)
NAMES = ("synthetic_demo", "fast_demo", "trimap_demo", "trimap_prop_demo",
         "plate_demo", "seg_demo")


def _cfgs():
    from vidmat_torch.config import ModelConfig

    return {
        "synthetic_demo": ModelConfig(),
        "fast_demo": ModelConfig(space_to_depth=2),
        "trimap_demo": ModelConfig(recurrent=False, use_trimap=True),
        "trimap_prop_demo": ModelConfig(use_trimap=True, space_to_depth=2),
        "plate_demo": ModelConfig(use_bg_plate=True, space_to_depth=2),
        "seg_demo": ModelConfig(),  # co-trained (matting metrics here)
    }


def _checkpoint(name: str):
    from vidmat_torch.models.weights import load_npz

    return load_npz(os.path.join(REPO, "vidmat_torch", "checkpoints",
                                 f"{name}.npz"))


def eval_hard(name: str, *, frames: int, h: int, w: int,
              device: str = "cuda") -> dict:
    """The extended hard-suite metrics (MAD, Grad, dtSSD) under the
    family's protocol: ``synthetic_hard_clip`` with ``HARD2`` (panning
    multi-octave background, hair filaments, occluder, sensor noise,
    shutter motion blur, exposure drift, JPEG round trip); the plate
    family runs the hard clean-plate clip with ``HARD_PLATE``."""
    from vidmat_torch.api import MattingSession
    from vidmat_torch.eval import VideoEval
    from vidmat_torch.io.fixtures import (HARD2, HARD_PLATE,
                                          synthetic_hard_clip,
                                          synthetic_hard_plate_clip)
    from vidmat_torch.pipeline.stepper import ImageStepper
    from vidmat_torch.pipeline.trimap import alpha_to_trimap

    cfg = _cfgs()[name]
    variables = _checkpoint(name)
    ev = VideoEval(metrics=("mad", "grad", "dtssd"), device=device)
    for seed in HELD_OUT_SEEDS:
        if cfg.use_bg_plate:
            clip = list(synthetic_hard_plate_clip(h, w, frames, seed=seed,
                                                  **HARD_PLATE))
            sess = MattingSession(h, w, model_cfg=cfg, variables=variables,
                                  bg_plate=clip[0][2], device=device)
            for f, gt, _ in clip:
                ev.update(sess.step(f)[0], gt)
        elif cfg.use_trimap and not cfg.recurrent:
            stepper = ImageStepper(cfg, variables=variables, device=device)
            for f, gt in synthetic_hard_clip(h, w, frames, seed=seed,
                                             **HARD2):
                ev.update(stepper(f, alpha_to_trimap(gt[..., 0]))[0], gt)
        else:
            sess = MattingSession(h, w, model_cfg=cfg, variables=variables,
                                  device=device)
            for i, (f, gt) in enumerate(
                    synthetic_hard_clip(h, w, frames, seed=seed, **HARD2)):
                tri = (alpha_to_trimap(gt[..., 0])
                       if cfg.use_trimap and i == 0 else None)
                ev.update(sess.step(f, trimap=tri)[0], gt)
        ev.reset_temporal()
    return ev.summary()


def eval_checkpoint(name: str, *, frames: int, h: int, w: int,
                    device: str = "cuda") -> dict:
    """Run the serving session of one shipped checkpoint over the
    held-out clips and return the scaled metric summary."""
    from vidmat_torch.api import MattingSession
    from vidmat_torch.eval import VideoEval
    from vidmat_torch.io.fixtures import synthetic_clip, synthetic_plate_clip
    from vidmat_torch.pipeline.stepper import ImageStepper
    from vidmat_torch.pipeline.trimap import alpha_to_trimap

    cfg = _cfgs()[name]
    variables = _checkpoint(name)
    ev = VideoEval(metrics=("mad", "mse", "sad", "grad", "conn", "dtssd"),
                   device=device)
    for seed in HELD_OUT_SEEDS:
        if cfg.use_bg_plate:
            # Clean-plate protocol: camouflaged clips (the disk is filled
            # with offset background texture; only the plate finds it)
            # with the true plate conditioning the session.
            clip = list(synthetic_plate_clip(h, w, frames, seed=seed))
            sess = MattingSession(h, w, model_cfg=cfg, variables=variables,
                                  bg_plate=clip[0][2], device=device)
            for frame, gt, _ in clip:
                ev.update(sess.step(frame)[0], gt)
        elif cfg.use_trimap and cfg.recurrent:
            # Propagation protocol: a trimap from the ground truth on
            # frame 0 only; the GRU carries it forward.
            sess = MattingSession(h, w, model_cfg=cfg, variables=variables,
                                  device=device)
            for i, (frame, gt) in enumerate(
                    synthetic_clip(h, w, frames, seed=seed)):
                tri = alpha_to_trimap(gt[..., 0]) if i == 0 else None
                ev.update(sess.step(frame, trimap=tri)[0], gt)
        elif cfg.use_trimap:
            # Trimap protocol: a trimap from the ground truth per frame
            # (the non-recurrent image rung).
            stepper = ImageStepper(cfg, variables=variables, device=device)
            for frame, gt in synthetic_clip(h, w, frames, seed=seed):
                ev.update(stepper(frame, alpha_to_trimap(gt[..., 0]))[0],
                          gt)
        else:
            sess = MattingSession(h, w, model_cfg=cfg, variables=variables,
                                  device=device)
            for frame, gt in synthetic_clip(h, w, frames, seed=seed):
                ev.update(sess.step(frame)[0], gt)
        ev.reset_temporal()  # do not score the clip-boundary cut
    return ev.summary()


DESC = {"synthetic_demo": "base (s2d=1, recurrent)",
        "fast_demo": "serving (s2d=2, recurrent)",
        "trimap_demo": "trimap-conditioned (non-recurrent)",
        "trimap_prop_demo": "keyframe trimap propagation (s2d=2, "
                            "recurrent; trimap on frame 0 only)",
        "plate_demo": "clean-plate conditioned (s2d=2, recurrent; "
                      "camouflaged clips + true plate)",
        "seg_demo": "base + co-trained seg head (matting metrics here)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true",
                    help="write docs/QUALITY_TORCH.md")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", default="96x96")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.size.split("x"))

    rows = []
    for name in NAMES:
        kw = dict(frames=args.frames, h=h, w=w, device=args.device)
        s = eval_checkpoint(name, **kw)
        s["hard"] = eval_hard(name, **kw)
        rows.append((name, s))
        print(name, json.dumps(s))

    header = (
        "# Shipped-checkpoint quality through the PyTorch port "
        "(vidmat_torch.eval, literature units)\n\n"
        f"Held-out synthetic clips (seeds {HELD_OUT_SEEDS}, "
        f"{len(HELD_OUT_SEEDS)}x{args.frames} frames @ {h}x{w}, the "
        "port's float32 sessions on the "
        f"{'card' if args.device == 'cuda' else 'CPU'}), the protocol of "
        "docs/QUALITY.md. Units: MAD/MSE x1e3, SAD/Grad/Conn /1e3, dtSSD "
        "x1e2; lower is better everywhere. **h*** = the extended hard "
        "held-out suite (io/fixtures.synthetic_hard_clip **HARD2**; the "
        "plate family synthetic_hard_plate_clip **HARD_PLATE**). "
        "Regenerate: `python -m vidmat_torch.tools.quality_report "
        f"--device {args.device} --write`.\n\n"
        "| checkpoint | model | MAD | MSE | SAD | Grad | Conn | dtSSD "
        "| hMAD | hGrad | hdtSSD |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for name, s in rows:
        dt = f"{s['dtssd']:.2f}" if "dtssd" in s else "-"
        hd = s["hard"]
        lines.append(
            f"| `{name}` | {DESC[name]} | {s['mad']:.2f} | {s['mse']:.3f} "
            f"| {s['sad']:.3f} | {s['grad']:.3f} | {s['conn']:.4f} "
            f"| {dt} | {hd['mad']:.1f} | {hd['grad']:.3f} "
            f"| {hd['dtssd']:.2f} |")
    text = header + "\n".join(lines) + "\n"
    print("\n" + text)
    if args.write:
        out = os.path.join(REPO, "docs", "QUALITY_TORCH.md")
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
