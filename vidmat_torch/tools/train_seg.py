"""Co-train the segmentation head: the recipe behind ``seg_demo``
(counterpart of tools/train_seg.py).

A fresh 1-channel ``seg_head`` is grafted onto a matting checkpoint
(matting-neutral at graft time), then matting batches (exact synthetic
alpha) interleave with segmentation batches (binary masks) through the
shared trunk. ``--head-only 1`` fits only the head on the frozen trunk:
the trunk's updates are zero (``multi_transform`` with ``set_to_zero``),
BatchNorm runs on the frozen running statistics, and those are restored
after every step, so the matting weights stay bit-identical to
``--init-from``. Scoring: held-out mask IoU and matting MAD through the
port's ``MattingSession``.

    python -m vidmat_torch.tools.train_seg --steps 1500 \\
        --init-from vidmat_torch/checkpoints/synthetic_demo.npz \\
        --out seg_demo.npz
"""

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def evaluate_seg(cfg, variables, size: int = 96, hard: bool = False,
                 device="cuda"):
    """Held-out (IoU, matting MAD): the seg session (output='seg') against
    the binarized subject coverage, and the matting session against the
    exact alpha. hard=True scores the extended hard suite (HARD2)."""
    import numpy as np

    from vidmat_torch.api import MattingSession
    from vidmat_torch.io.fixtures import (HARD2, synthetic_clip,
                                          synthetic_hard_clip)
    from vidmat_torch.utils.metrics import mad

    seg = MattingSession(size, size, variables=variables, model_cfg=cfg,
                         output="seg", device=device)
    mat = MattingSession(size, size, variables=variables, model_cfg=cfg,
                         device=device)
    clip = (synthetic_hard_clip(size, size, 8, seed=987654, **HARD2)
            if hard else synthetic_clip(size, size, 8, seed=987654))
    ious, mads = [], []
    for f, gt in clip:
        mask, _ = seg.step(f)
        pred = mask[..., 0] > 0.5
        gtb = gt[..., 0] > 0.5
        ious.append((pred & gtb).sum() / max((pred | gtb).sum(), 1))
        mads.append(mad(mat.step(f)[0], gt))
    return float(np.mean(ious)), float(np.mean(mads))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="co-train the segmentation "
                                             "head")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--clip-len", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seg-every", type=int, default=2)
    ap.add_argument("--trunk-lr-scale", type=float, default=0.0,
                    help="with --head-only: > 0 lets the trunk move at "
                         "lr*scale (asymmetric co-training)")
    ap.add_argument("--head-only", type=int, default=0,
                    help="1: fit only the seg_head on a frozen trunk; the "
                         "matting weights stay bit-identical to "
                         "--init-from")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--hard", type=float, default=0.0,
                    help="fraction of clips (matting and seg batches) "
                         "from the HARD fixture; hard IoU and MAD join the "
                         "report and the selection")
    ap.add_argument("--octave2", type=float, default=0.0,
                    help="fraction of HARD clips also carrying shutter "
                         "blur, exposure drift and JPEG")
    ap.add_argument("--sizes", type=int, nargs="+", default=None,
                    help="mixed-resolution round-robin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-from",
                    default=os.path.join(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))), "checkpoints",
                        "synthetic_demo.npz"))
    ap.add_argument("--out", default="seg_demo.npz")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def make_optimizer(args):
    """chain(clip, adam(warm-up cosine)); with --head-only the trunk's
    leaves get zero updates (or their own slower chain)."""
    from vidmat_torch.train import optim

    warmup = max(1, args.steps // 20)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup, args.steps, end_value=args.lr * 1e-2)
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(sched))
    if not args.head_only:
        return opt
    # multi_transform + set_to_zero: the frozen leaves get zero updates.
    if args.trunk_lr_scale > 0:
        tsched = optim.warmup_cosine_decay_schedule(
            0.0, args.lr * args.trunk_lr_scale, warmup, args.steps,
            end_value=args.lr * args.trunk_lr_scale * 1e-2)
        trunk = optim.chain(optim.clip_by_global_norm(1.0),
                            optim.adam(tsched))
    else:
        trunk = optim.set_to_zero()

    def labels(params):
        return {k: optim.tree_map(lambda _, k=k: ("head" if k == "seg_head"
                                                  else "freeze"), v)
                for k, v in params.items()}

    return optim.multi_transform({"head": opt, "freeze": trunk}, labels)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np

    from vidmat_torch._device import resolve_device
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import (graft_seg_params, load_npz,
                                             numpy_variables,
                                             save_checkpoint)
    from vidmat_torch.train.data import (synthetic_clip_batches,
                                         synthetic_hard_clip_batches,
                                         synthetic_seg_batches)
    from vidmat_torch.train.loop import (TrainState, make_seg_train_step,
                                         make_train_step, to_device)

    device = resolve_device(args.device)
    print(json.dumps({"device": str(device)}), flush=True)
    cfg = ModelConfig()
    variables = load_npz(args.init_from)
    if "seg_head" not in variables["params"]:
        # a matting-only checkpoint: graft a fresh (matting-neutral) head
        variables = graft_seg_params(variables, cfg, seed=args.seed)
    variables = to_device(variables, device)
    opt = make_optimizer(args)
    bn0 = variables["batch_stats"]
    step_fn = make_train_step(cfg, optimizer=opt, device=device)
    # head-only: frozen running statistics, the activations inference
    # produces.
    seg_fn = make_seg_train_step(cfg, optimizer=opt,
                                 bn_train=not args.head_only, device=device)
    state = TrainState(variables=variables,
                       opt_state=opt.init(variables["params"]), step=0)

    sizes = args.sizes or [args.size]
    mat_its = [synthetic_clip_batches(t=args.clip_len, n=args.batch,
                                      h=s, w=s, seed=args.seed + 31 * k)
               for k, s in enumerate(sizes)]
    hard_its = ([synthetic_hard_clip_batches(
        t=args.clip_len, n=args.batch, h=s, w=s,
        seed=args.seed + 31 * k, octave2=args.octave2)
        for k, s in enumerate(sizes)] if args.hard > 0 else None)
    seg_its = [synthetic_seg_batches(t=args.clip_len, n=args.batch,
                                     h=s, w=s, seed=args.seed + 17 + 31 * k,
                                     hard=args.hard, octave2=args.octave2)
               for k, s in enumerate(sizes)]
    hrng = np.random.RandomState(args.seed + 5)
    best = float("inf")
    t0 = time.time()
    for i in range(args.steps):
        k = i % len(sizes)
        if args.head_only or (args.seg_every > 0
                              and i % args.seg_every == args.seg_every - 1):
            clips, gt_mask = next(seg_its[k])
            state, metrics = seg_fn(state, clips, gt_mask)
            if args.head_only:
                # restoring the running statistics pins the matting
                # forward bit-identically to --init-from
                state = TrainState(
                    variables={"params": state.variables["params"],
                               "batch_stats": bn0},
                    opt_state=state.opt_state, step=state.step)
        else:
            src = (hard_its if hard_its is not None
                   and hrng.rand() < args.hard else mat_its)
            clips, gt_a, gt_f = next(src[k])
            state, metrics = step_fn(state, clips, gt_a, gt_f)
        if (i + 1) % args.eval_every == 0 or i + 1 == args.steps:
            host = numpy_variables(state.variables)
            iou, mad_ = evaluate_seg(cfg, host, device=device)
            rec = {"step": i + 1,
                   "loss": round(float(metrics["loss"]), 5),
                   "heldout_iou": round(iou, 5),
                   "heldout_mad": round(mad_, 5),
                   "wall_s": round(time.time() - t0, 1)}
            # both capabilities in one score: IoU shortfall + matting MAD
            score = (1.0 - iou) + 10.0 * mad_
            if args.hard > 0:
                hiou, hmad = evaluate_seg(cfg, host, hard=True,
                                          device=device)
                rec["heldout_hard_iou"] = round(hiou, 5)
                rec["heldout_hard_mad"] = round(hmad, 5)
                score += (1.0 - hiou) + 10.0 * hmad
            print(json.dumps(rec), flush=True)
            if score < best:
                best = score
                path = save_checkpoint(args.out, host)
                print(f"saved {path} (score {best:.5f})", flush=True)
    print(json.dumps({"final_best_score": round(best, 5)}))


if __name__ == "__main__":
    main()
