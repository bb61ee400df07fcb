"""Debug-mode guards (counterpart of vidmat/utils/debug.py).

- ``debug_mode()``: ``torch.autograd.set_detect_anomaly`` for the scope.
  It traps a NaN or Inf that a BACKWARD pass produces, at the op of the
  forward pass that made it (with that op's stack). It does not check
  forward values: the serving bodies run under ``torch.inference_mode``
  and build no graph, so a NaN there is found only by ``check_finite`` on
  the outputs (the JAX package's ``jax_debug_nans`` traps it at the
  emitting op of the forward pass). The hand-written kernels are not
  checked inside: hold one against its plain twin instead.
- ``check_finite(tree, name)``: an explicit finite check of a dict, tuple
  or list of tensors or arrays (host side; copies device tensors to the
  host).
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Context: anomaly detection for the scope (slow; debug only)."""
    import torch

    with torch.autograd.set_detect_anomaly(nans):
        yield


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (f"[{k!r}]",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def check_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError if any leaf holds NaN or Inf."""
    for path, leaf in _leaves(tree):
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().float().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            keys = "/".join(path)
            raise FloatingPointError(
                f"non-finite values in {name}:{keys} "
                f"(nan={np.isnan(arr).sum()}, inf={np.isinf(arr).sum()})")
