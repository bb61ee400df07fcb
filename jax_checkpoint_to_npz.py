#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX package (``vidmat train``,
``vidmat.models.weights.save_checkpoint``, the shipped ``checkpoints/``)
into the PyTorch port's ``.npz`` checkpoint.

Usage:
  python jax_checkpoint_to_npz.py CKPT_DIR OUT [--s2d N] [--trimap]
      [--plate] [--no-recurrent] [--with-seg | --refiner]

It runs where JAX and orbax are installed, on the CPU (the port itself
never imports them). The checkpoint is restored by
``vidmat.models.weights.load_checkpoint``: as saved, or, where that fails
(a checkpoint that embeds a device's sharding), through that function's
single-device fallback, which needs a template: the network's variables
for the ModelConfig the flags give (``--with-seg`` with the segmentation
head), or with ``--refiner`` the error-map refiner's. The leaves are
written as numpy by the port's ``save_checkpoint`` (``.npz`` appended to
OUT when missing), which ``vidmat_torch.models.load_checkpoint`` and the
port's ``--checkpoint`` options read.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def template(args):
    """The variables the flags describe, for the restore's fallback."""
    import jax.numpy as jnp
    import jax.random as jrandom

    if args.refiner:
        from vidmat.refine.errormap import ErrorMapRefiner

        # Its convolutions' shapes do not depend on the frame's or the
        # patch budget (as vidmat/pipeline/video.py restores it).
        return ErrorMapRefiner(num_patches=8, patch_size=16).init(
            jrandom.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32),
            jnp.zeros((1, 16, 16, 3), jnp.float32),
            jnp.zeros((1, 16, 16, 1), jnp.float32))
    from vidmat.config import ModelConfig
    from vidmat.models.weights import init_params

    cfg = ModelConfig(space_to_depth=args.s2d, use_trimap=args.trimap,
                      use_bg_plate=args.plate,
                      recurrent=not args.no_recurrent)
    return init_params(cfg, with_seg=args.with_seg)


def convert(ckpt: str, out: str, args) -> str:
    """Restore ``ckpt`` and write it as the port's .npz; returns its
    path."""
    import jax
    import numpy as np

    from vidmat.models.weights import load_checkpoint

    try:
        variables = load_checkpoint(ckpt)
    except ValueError:
        variables = load_checkpoint(ckpt, template=template(args))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    from vidmat_torch.models.weights import save_checkpoint

    return save_checkpoint(out, variables)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="orbax checkpoint of the JAX package -> the port's .npz")
    ap.add_argument("ckpt", help="orbax checkpoint directory")
    ap.add_argument("out", help="output .npz path")
    ap.add_argument("--s2d", type=int, default=1,
                    help="space_to_depth of the model (the fallback's "
                         "template)")
    ap.add_argument("--trimap", action="store_true")
    ap.add_argument("--plate", action="store_true")
    ap.add_argument("--no-recurrent", action="store_true")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--with-seg", action="store_true",
                       help="a co-trained checkpoint (with seg_head)")
    group.add_argument("--refiner", action="store_true",
                       help="an error-map refiner checkpoint")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.ckpt):
        ap.error(f"{args.ckpt!r} is not an orbax checkpoint directory")

    # Conversion is host work: never let it take an accelerator.
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    path = convert(os.path.abspath(args.ckpt), args.out, args)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
