"""Weight bridge from the JAX package's variables to the port's modules
(counterpart of vidmat/models/weights.py).

The Flax tree and the port's module tree carry the same names:
  flax  params/encoder/stem/conv/kernel   (H, W, I, O)
  torch encoder.stem.conv.weight          (O, I, H, W)
  flax  BatchNorm {scale, bias} + batch_stats {mean, var}
  torch bn.{weight, bias, running_mean, running_var}

The shipped checkpoint the port serves (``checkpoints/fast_demo.npz`` in
this package) is the flattened Flax tree, one npz entry per leaf keyed by
its path (``params/encoder/stem/conv/kernel``), so it loads with numpy
alone. Unlike the JAX package's oracle bridge this one keeps the
``seg_head`` subtree.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from vidmat_torch.config import ModelConfig

_CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")

#: ModelConfig axes (use_trimap, use_bg_plate, space_to_depth, recurrent)
#: of the base channel plan -> shipped checkpoint in this package.
_DEFAULT_CKPTS = {
    (False, False, 2, True): "fast_demo",
}


def _walk(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, path)
        else:
            yield path, v


def flatten_variables(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested variables -> {"params/encoder/stem/conv/kernel": array}."""
    return {k: np.asarray(v) for k, v in _walk(variables)}


def unflatten_variables(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of flatten_variables."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return out


def state_dict_from_jax(variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dict of numpy arrays) -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _walk(variables["params"]):
        v = np.asarray(v, np.float32)
        parent, leaf = path.rsplit("/", 1)
        parent = parent.replace("/", ".")
        if leaf == "kernel":  # conv (H, W, I, O) -> (O, I, H, W)
            v = np.transpose(v, (3, 2, 0, 1))
            name = "weight"
        elif leaf == "scale":  # BN gamma
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unhandled flax param leaf: {path}")
        out[f"{parent}.{name}"] = torch.tensor(v)
    for path, v in _walk(variables.get("batch_stats", {})):
        parent, leaf = path.rsplit("/", 1)
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise KeyError(f"unhandled flax batch_stat leaf: {path}")
        out[f"{parent.replace('/', '.')}.{name}"] = torch.tensor(
            np.asarray(v, np.float32))
    return out


def save_npz(path: str, variables: Dict[str, Any]) -> None:
    """Write nested variables as a flat npz (one entry per leaf)."""
    np.savez(path, **flatten_variables(variables))


def load_npz(path: str) -> Dict[str, Any]:
    """Read a flat npz written by save_npz back into nested variables."""
    with np.load(path) as z:
        return unflatten_variables({k: z[k] for k in z.files})


def default_checkpoint_path(cfg: ModelConfig) -> Optional[str]:
    """Path of the shipped checkpoint matching ``cfg`` in this package, or
    None. Only ``fast_demo`` (the serving model, s2d=2) ships with the port
    so far (ROADMAP A.1 lists the others)."""
    base = ModelConfig()
    if (cfg.enc_channels, cfg.dec_channels) != (base.enc_channels,
                                                base.dec_channels):
        return None
    name = _DEFAULT_CKPTS.get((cfg.use_trimap, cfg.use_bg_plate,
                               cfg.space_to_depth, cfg.recurrent))
    if name is None:
        return None
    path = os.path.join(_CKPT_DIR, f"{name}.npz")
    return path if os.path.isfile(path) else None


def default_variables(cfg: ModelConfig) -> Dict[str, Any]:
    """The shipped weights for ``cfg``, or raise: serving random weights
    emits garbage mattes, so it is refused."""
    path = default_checkpoint_path(cfg)
    if path is None:
        raise ValueError(
            f"no shipped checkpoint in the port matches {cfg!r}: pass "
            "variables=... (a nested dict of numpy arrays in the JAX "
            "package's layout). The port ships fast_demo (the s2d=2 "
            "serving model) only.")
    return load_npz(path)


def build_network(cfg: ModelConfig, variables: Dict[str, Any],
                  dtype: Optional[torch.dtype] = None,
                  device="cpu"):
    """A MattingNetwork in eval mode holding ``variables``. A co-trained
    ``seg_head`` is left out: the segmentation pass is not ported yet
    (ROADMAP A.10)."""
    from vidmat_torch.models.matting_net import MattingNetwork

    sd = {k: v for k, v in state_dict_from_jax(variables).items()
          if not k.startswith("seg_head.")}
    net = MattingNetwork(cfg, dtype=dtype)
    net.load_state_dict(sd)
    net.requires_grad_(False)
    return net.eval().to(device)
