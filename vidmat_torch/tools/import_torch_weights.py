"""Import a torch ``.pth`` state dict into the port's ``.npz`` checkpoint
(counterpart of tools/import_torch_weights.py, which writes an orbax
checkpoint).

Usage:
  python -m vidmat_torch.tools.import_torch_weights IN.pth OUT \
      [--trimap] [--no-recurrent] [--map FILE]

The state dict follows the port's module names (``MattingNetwork``'s
``state_dict()``); a ``{"state_dict": ...}`` wrapper is unwrapped. For a
checkpoint with other names, pass ``--map FILE`` with ``src -> dst``
lines. The leaves are those of ``init_params(ModelConfig(use_trimap=...,
recurrent=...))``, filled by ``torch_to_flax_variables``; the file is
written by ``save_checkpoint`` (``.npz`` appended to OUT when missing).
Host work only: it runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def read_remap(path: str) -> dict:
    """``src -> dst`` lines of a remap file as {src: dst}."""
    remap = {}
    with open(path) as f:
        for line in f:
            if "->" in line:
                src, dst = (x.strip() for x in line.split("->"))
                remap[src] = dst
    return remap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="import a torch .pth state dict as the port's .npz")
    ap.add_argument("pth")
    ap.add_argument("out")
    ap.add_argument("--trimap", action="store_true")
    ap.add_argument("--no-recurrent", action="store_true")
    ap.add_argument("--map", help="key remap file: 'src -> dst' per line")
    args = ap.parse_args(argv)

    import torch

    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import (init_params, save_checkpoint,
                                             torch_to_flax_variables)

    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    if args.map:
        remap = read_remap(args.map)
        sd = {remap.get(k, k): v for k, v in sd.items()}

    cfg = ModelConfig(use_trimap=args.trimap,
                      recurrent=not args.no_recurrent)
    variables = torch_to_flax_variables(sd, init_params(cfg))
    path = save_checkpoint(args.out, variables)
    print(f"imported {len(sd)} tensors -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
