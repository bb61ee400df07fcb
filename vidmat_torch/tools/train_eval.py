"""Train a model variant on synthetic clips and track held-out MAD: the
recipe behind the shipped checkpoints (counterpart of tools/train_eval.py).

The ``fast_demo`` recipe (the ``video_1080p`` model: s2d=2, encoder
(16, 24, 40, 64), decoder (48, 32, 24, 16)) trains at 128x128, where the
packed feature grids match what the s2d=1 model sees at 64x64, with T=4,
N=2, a linear warm-up and cosine decay over the whole horizon:

    python -m vidmat_torch.tools.train_eval --s2d 2 --size 128 \
        --steps 4000 --out fast_demo.npz

Held-out scoring runs through the port's ``MattingSession`` (and its
``ImageStepper`` for the non-recurrent families) on the fixtures'
held-out seeds; the best-scoring variables are written as the port's
``.npz``. Runs on the card unless ``--device cpu``.
"""

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def evaluate(cfg, variables, trimap_mode: str = "off",
             device="cuda") -> float:
    """Held-out mean MAD — mirrors test_fast_s2d_checkpoint_quality.

    trimap_mode "keyframe"/"mixed": the trimap is given on frame 0 only
    (derived from gt), neutral 0.5 afterwards — scoring exactly the
    propagation capability; "perframe": every frame gets its trimap.
    """
    import numpy as np

    from vidmat_torch.api import MattingSession
    from vidmat_torch.io.fixtures import synthetic_clip
    from vidmat_torch.utils.metrics import mad

    sess = MattingSession(160, 160, variables=variables, model_cfg=cfg,
                          device=device)
    mads = []
    for i, (f, gt) in enumerate(synthetic_clip(160, 160, 6, seed=987654)):
        if trimap_mode == "off":
            tri = None
        else:
            from vidmat_torch.train.data import alpha_to_trimap

            neutral = np.full(gt.shape[:2], 0.5, np.float32)
            tri = (alpha_to_trimap(gt)[..., 0]
                   if (i == 0 or trimap_mode == "perframe") else neutral)
        mads.append(mad(sess.step(f, trimap=tri)[0], gt))
    return float(np.mean(mads))


def evaluate_ambiguous(cfg, variables, device="cuda") -> dict:
    """Held-out twin-disk PROPAGATION score: keyframe trimap on frame 0,
    neutral after. Reports keyframe-mode MAD (should be low), neutral-mode
    MAD (irreducibly high — no hint), and their ratio: the measured value
    of the propagated annotation."""
    import numpy as np

    from vidmat_torch.api import MattingSession
    from vidmat_torch.io.fixtures import synthetic_ambiguous_clip
    from vidmat_torch.train.data import alpha_to_trimap
    from vidmat_torch.utils.metrics import mad

    out = {}
    for mode in ("keyframe", "neutral"):
        sess = MattingSession(160, 160, variables=variables, model_cfg=cfg,
                          device=device)
        mads = []
        for i, (f, gt) in enumerate(
                synthetic_ambiguous_clip(160, 160, 6, seed=24680,
                                         target=1)):
            tri = (alpha_to_trimap(gt)[..., 0]
                   if (i == 0 and mode == "keyframe") else None)
            mads.append(mad(sess.step(f, trimap=tri)[0], gt))
        out[mode] = float(np.mean(mads))
    out["gain"] = out["neutral"] / max(out["keyframe"], 1e-6)
    return out


def evaluate_image(cfg, variables, size: int = 96,
                   device="cuda") -> float:
    """Held-out per-frame MAD for the NON-RECURRENT (single-image) families —
    mirrors tools/quality_report.py's ImageStepper protocol: a gt-derived
    trimap on EVERY frame when the family is trimap-conditioned."""
    import numpy as np

    from vidmat_torch.io.fixtures import synthetic_clip
    from vidmat_torch.pipeline.stepper import ImageStepper
    from vidmat_torch.train.data import alpha_to_trimap
    from vidmat_torch.utils.metrics import mad

    stepper = ImageStepper(cfg, variables=variables, device=device)
    mads = []
    for frame, gt in synthetic_clip(size, size, 6, seed=987654):
        tri = alpha_to_trimap(gt[..., 0]) if cfg.use_trimap else None
        mads.append(mad(stepper(frame, tri)[0], gt))
    return float(np.mean(mads))


def evaluate_ambiguous_image(cfg, variables, size: int = 96,
                             device="cuda") -> float:
    """Twin-disk MAD with a PER-FRAME trimap: on ambiguous content only
    the trimap says which twin is the subject, so this scores whether the
    per-frame annotation is load-bearing for the non-recurrent family."""
    import numpy as np

    from vidmat_torch.io.fixtures import synthetic_ambiguous_clip
    from vidmat_torch.pipeline.stepper import ImageStepper
    from vidmat_torch.train.data import alpha_to_trimap
    from vidmat_torch.utils.metrics import mad

    stepper = ImageStepper(cfg, variables=variables, device=device)
    mads = []
    for f, gt in synthetic_ambiguous_clip(size, size, 6, seed=24680,
                                          target=1):
        mads.append(mad(stepper(f, alpha_to_trimap(gt[..., 0]))[0], gt))
    return float(np.mean(mads))


def evaluate_hard(cfg, variables, size: int = 96,
                  device="cuda") -> float:
    """Held-out mean MAD on the HARD suite (pan + hair + occluder +
    noise; io/fixtures.synthetic_hard_clip) — the realism gate the plain
    disk score cannot provide. Trimap families run
    their own protocol: per-frame gt trimaps (non-recurrent) or a
    frame-0 keyframe (propagation)."""
    import numpy as np

    from vidmat_torch.api import MattingSession
    from vidmat_torch.io.fixtures import synthetic_hard_clip
    from vidmat_torch.train.data import alpha_to_trimap
    from vidmat_torch.utils.metrics import mad

    if cfg.use_trimap and not cfg.recurrent:
        from vidmat_torch.pipeline.stepper import ImageStepper

        stepper = ImageStepper(cfg, variables=variables, device=device)
        return float(np.mean(
            [mad(stepper(f, alpha_to_trimap(gt[..., 0]))[0], gt)
             for f, gt in synthetic_hard_clip(size, size, 8,
                                              seed=987654)]))
    sess = MattingSession(size, size, variables=variables, model_cfg=cfg,
                          device=device)
    mads = []
    for i, (f, gt) in enumerate(synthetic_hard_clip(size, size, 8,
                                                    seed=987654)):
        tri = (alpha_to_trimap(gt[..., 0])
               if cfg.use_trimap and i == 0 else None)
        mads.append(mad(sess.step(f, trimap=tri)[0], gt))
    return float(np.mean(mads))


def evaluate_plate(cfg, variables, size: int = 160,
                   device="cuda") -> dict:
    """Held-out CLEAN-PLATE scores (mirrors evaluate_ambiguous's shape).

    'camo_plate': camouflage clip with the TRUE plate (should be low —
    the plate reveals the texture-matched disk);
    'camo_wrong': same clip with the FIRST FRAME as the plate (a plate
    that claims the subject is background — no usable signal; this is
    the realistic wrong-plate failure mode);
    'plain': ordinary distinct-colored content with the true plate
    (general quality must not regress);
    'gain': camo_wrong / camo_plate — the measured value of plate
    conditioning on content where pixels alone cannot find the subject.
    """
    import numpy as np

    from vidmat_torch.api import MattingSession
    from vidmat_torch.io.fixtures import synthetic_plate_clip
    from vidmat_torch.utils.metrics import mad

    out = {}
    for key, camo, use_true_plate in (("camo_plate", True, True),
                                      ("camo_wrong", True, False),
                                      ("plain", False, True)):
        clip = list(synthetic_plate_clip(size, size, 6, seed=424242,
                                         camouflage=camo))
        plate = clip[0][2] if use_true_plate else clip[0][0]
        sess = MattingSession(size, size, variables=variables,
                              model_cfg=cfg, bg_plate=plate, device=device)
        out[key] = float(np.mean([mad(sess.step(f)[0], gt)
                                  for f, gt, _ in clip]))
    out["gain"] = out["camo_wrong"] / max(out["camo_plate"], 1e-6)
    return out


def evaluate_hard_plate(cfg, variables, size: int = 96,
                        device="cuda") -> float:
    """Held-out mean MAD on the HARD clean-plate suite (io/fixtures.
    synthetic_hard_plate_clip under the canonical HARD_PLATE protocol:
    camouflaged disk + camouflaged filaments, camera drift, shutter
    blur, exposure drift, plate jitter) — the plate family's realism
    gate."""
    import numpy as np

    from vidmat_torch.api import MattingSession
    from vidmat_torch.io.fixtures import HARD_PLATE, synthetic_hard_plate_clip
    from vidmat_torch.utils.metrics import mad

    clip = list(synthetic_hard_plate_clip(size, size, 8, seed=987654,
                                          **HARD_PLATE))
    sess = MattingSession(size, size, variables=variables, model_cfg=cfg,
                          bg_plate=clip[0][2], device=device)
    return float(np.mean([mad(sess.step(f)[0], gt)
                          for f, gt, _ in clip]))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="train a model variant on synthetic clips and track "
                    "held-out MAD")
    ap.add_argument("--s2d", type=int, default=2)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--sizes", type=int, nargs="+", default=None,
                    help="mixed-resolution training: round-robin over "
                         "these sizes")
    ap.add_argument("--clip-len", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-from", default=None,
                    help="checkpoint (.npz) to fine-tune from")
    ap.add_argument("--laplacian", type=float, default=0.0,
                    help="Laplacian-pyramid alpha loss weight")
    ap.add_argument("--boundary", type=float, default=0.0,
                    help="edge-band-restricted alpha L1 weight")
    ap.add_argument("--ambiguous", type=float, default=0.0,
                    help="fraction of trimap batches drawn from the "
                         "twin-disk AMBIGUOUS task (only the trimap says "
                         "which twin is the subject); reported as "
                         "heldout_amb")
    ap.add_argument("--trimap", default="off",
                    choices=["off", "perframe", "keyframe", "mixed"],
                    help="train the trimap-conditioned family: 'keyframe' "
                         "gives the trimap on frame 0 only (propagation), "
                         "'mixed' alternates per-frame/keyframe batches, "
                         "'perframe' every frame")
    ap.add_argument("--hard", type=float, default=0.0,
                    help="fraction of batches drawn from the HARD "
                         "fixture (for --plate, the hard clean-plate "
                         "fixture); heldout_hard joins the selection "
                         "score when > 0")
    ap.add_argument("--octave2", type=float, default=0.0,
                    help="fraction of HARD clips that also carry shutter "
                         "blur, exposure drift and a JPEG round trip")
    ap.add_argument("--plain-weight", type=float, default=1.0,
                    help="weight of the PLAIN held-out MAD in the "
                         "checkpoint-selection score")
    ap.add_argument("--recurrent", type=int, default=1,
                    help="0 trains the NON-RECURRENT (single-image) "
                         "family; held-out scoring switches to the "
                         "per-frame protocol")
    ap.add_argument("--plate", action="store_true",
                    help="train the CLEAN-PLATE conditioned family: clips "
                         "carry the background plate as 3 extra channels")
    ap.add_argument("--camouflage", type=float, default=0.5,
                    help="--plate: fraction of clips with texture-"
                         "camouflaged foreground")
    ap.add_argument("--plate-jitter", type=float, default=0.03,
                    help="--plate: imperfect-capture perturbation on the "
                         "plate channels")
    ap.add_argument("--out", default="fast_demo.npz")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def make_data(args, sizes):
    """The batch iterator of the run: round-robin over ``sizes``, with the
    hard fixture mixed in at ``--hard`` (inside the trimap batcher for the
    trimap families)."""
    import numpy as np

    from vidmat_torch.train.data import synthetic_clip_batches

    hard_iters = None
    if args.plate:
        from vidmat_torch.train.data import synthetic_plate_batches

        iters = [synthetic_plate_batches(t=args.clip_len, n=args.batch,
                                         h=s, w=s,
                                         seed=args.seed + 31 * k,
                                         camouflage=args.camouflage,
                                         plate_jitter=args.plate_jitter)
                 for k, s in enumerate(sizes)]
        if args.hard > 0:
            from vidmat_torch.train.data import synthetic_hard_plate_batches

            hard_iters = [synthetic_hard_plate_batches(
                t=args.clip_len, n=args.batch, h=s, w=s,
                seed=args.seed + 31 * k, plate_jitter=args.plate_jitter,
                octave2=args.octave2) for k, s in enumerate(sizes)]
    elif args.trimap == "off":
        iters = [synthetic_clip_batches(t=args.clip_len, n=args.batch,
                                        h=s, w=s, seed=args.seed + 31 * k)
                 for k, s in enumerate(sizes)]
        if args.hard > 0:
            from vidmat_torch.train.data import synthetic_hard_clip_batches

            hard_iters = [synthetic_hard_clip_batches(
                t=args.clip_len, n=args.batch, h=s, w=s,
                seed=args.seed + 31 * k, octave2=args.octave2)
                for k, s in enumerate(sizes)]
    else:
        from vidmat_torch.train.data import synthetic_trimap_batches

        key_mode = {"perframe": "off", "keyframe": "only",
                    "mixed": "mixed"}[args.trimap]
        iters = [synthetic_trimap_batches(t=args.clip_len, n=args.batch,
                                          h=s, w=s,
                                          seed=args.seed + 31 * k,
                                          keyframe=key_mode,
                                          ambiguous=args.ambiguous,
                                          hard=args.hard,
                                          octave2=args.octave2)
                 for k, s in enumerate(sizes)]
    i = 0
    hrng = np.random.RandomState(args.seed + 5)
    while True:
        src = (hard_iters if hard_iters is not None
               and hrng.rand() < args.hard else iters)
        yield next(src[i % len(src)])
        i += 1


def heldout(args, cfg, variables, device):
    """(record fields, selection score) of the family's held-out
    protocol."""
    if args.plate:
        pl = evaluate_plate(cfg, variables, device=device)
        pl96 = evaluate_plate(cfg, variables, size=96, device=device)
        rec = {"heldout_plate": {k: round(v, 5) for k, v in pl.items()},
               "heldout_plate_96": {k: round(v, 5)
                                    for k, v in pl96.items()}}
        # Camouflage (the new capability) and ordinary content (must not
        # regress), at the fixture's 160 px and at 96 px.
        score = (pl["camo_plate"] + args.plain_weight * pl["plain"]
                 + pl96["camo_plate"] + args.plain_weight * pl96["plain"])
        if args.hard > 0:
            hp = evaluate_hard_plate(cfg, variables, device=device)
            rec["heldout_hard_plate"] = round(hp, 5)
            score += hp
        return rec, score
    if not cfg.recurrent:
        mad = evaluate_image(cfg, variables, device=device)
        rec = {"heldout_mad": round(mad, 5)}
        score = mad
        if args.hard > 0:
            hard = evaluate_hard(cfg, variables, device=device)
            rec["heldout_hard"] = round(hard, 5)
            score += hard
        if args.ambiguous > 0:
            amb = evaluate_ambiguous_image(cfg, variables, device=device)
            rec["heldout_amb_perframe"] = round(amb, 5)
            score += amb
        return rec, score
    # keyframe / mixed checkpoints are scored on propagation (the trimap
    # on frame 0 only), the capability they exist to add.
    mad = evaluate(cfg, variables,
                   trimap_mode=("keyframe" if args.trimap in
                                ("keyframe", "mixed") else args.trimap),
                   device=device)
    rec = {"heldout_mad": round(mad, 5)}
    score = args.plain_weight * mad
    if args.hard > 0:
        hard = evaluate_hard(cfg, variables, device=device)
        rec["heldout_hard"] = round(hard, 5)
        score += hard
    if args.ambiguous > 0:
        amb = evaluate_ambiguous(cfg, variables, device=device)
        rec["heldout_amb"] = {k: round(v, 5) for k, v in amb.items()}
        score += amb["keyframe"]
    return rec, score


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vidmat_torch._device import resolve_device
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import (init_params, load_npz,
                                             numpy_variables,
                                             save_checkpoint)
    from vidmat_torch.train.loop import TrainState, make_train_step, \
        to_device
    from vidmat_torch.train.optim import (adam, chain, clip_by_global_norm,
                                          warmup_cosine_decay_schedule)

    device = resolve_device(args.device)
    print(json.dumps({"device": str(device)}), flush=True)
    if args.plate and args.trimap != "off":
        raise SystemExit("--plate and --trimap train different families; "
                         "pick one")
    cfg = ModelConfig(space_to_depth=args.s2d,
                      use_trimap=args.trimap != "off",
                      use_bg_plate=args.plate,
                      recurrent=bool(args.recurrent))
    if not cfg.recurrent and args.trimap in ("keyframe", "mixed"):
        raise SystemExit("keyframe propagation needs the recurrence; "
                         "use --trimap perframe with --recurrent 0")
    warmup = min(args.warmup, max(1, args.steps // 10))
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup, args.steps, end_value=args.lr * 1e-2)
    opt = chain(clip_by_global_norm(1.0), adam(sched))
    step_fn = make_train_step(cfg, optimizer=opt,
                              laplacian_weight=args.laplacian,
                              boundary_weight=args.boundary, device=device)

    variables = init_params(cfg, seed=args.seed, height=args.size,
                            width=args.size)
    if args.init_from:
        src = load_npz(args.init_from)
        stem = src["params"]["encoder"]["stem"]["conv"]["kernel"]
        want = variables["params"]["encoder"]["stem"]["conv"]["kernel"]
        if stem.shape != want.shape:
            if args.trimap == "off" and not args.plate:
                raise SystemExit(
                    f"--init-from stem is {stem.shape}, config needs "
                    f"{want.shape}: wrong family")
            # A conditioned family from an unconditioned model: graft it,
            # the new conditioning taps zero.
            from vidmat_torch.models.weights import graft_cond_params

            src = graft_cond_params(src, cfg, seed=args.seed)
            print(json.dumps({"init": "grafted unconditioned checkpoint "
                                      + args.init_from}), flush=True)
        variables = src
    variables = to_device(variables, device)
    state = TrainState(variables=variables,
                       opt_state=opt.init(variables["params"]), step=0)

    best = float("inf")
    t0 = time.time()
    for i, (clips, gt_a, gt_f) in enumerate(
            make_data(args, args.sizes or [args.size])):
        if i >= args.steps:
            break
        state, metrics = step_fn(state, clips, gt_a, gt_f)
        if (i + 1) % args.eval_every == 0 or i + 1 == args.steps:
            host = numpy_variables(state.variables)
            rec, score = heldout(args, cfg, host, device)
            rec = {"step": i + 1, "loss": round(float(metrics["loss"]), 5),
                   **rec, "wall_s": round(time.time() - t0, 1)}
            print(json.dumps(rec), flush=True)
            if score < best:
                best = score
                path = save_checkpoint(args.out, host)
                print(f"saved {path} (score {best:.5f})", flush=True)
    print(json.dumps({"final_best_score": round(best, 5)}))


if __name__ == "__main__":
    main()
