"""Weight bridge from the JAX package's variables to the port's modules
(counterpart of vidmat/models/weights.py).

The Flax tree and the port's module tree carry the same names:
  flax  params/encoder/stem/conv/kernel   (H, W, I, O)
  torch encoder.stem.conv.weight          (O, I, H, W)
  flax  BatchNorm {scale, bias} + batch_stats {mean, var}
  torch bn.{weight, bias, running_mean, running_var}

The shipped checkpoints the port serves (in ``checkpoints/`` of this
package: ``fast_demo``, the s2d=2 serving model; ``synthetic_demo``, the
s2d=1 default model; ``plate_demo``, the clean-plate conditioned s2d=2
model; ``trimap_demo``, the per-image trimap model, non-recurrent;
``trimap_prop_demo``, the recurrent s2d=2 trimap-propagation model;
``seg_demo``, the s2d=1 base model co-trained with a segmentation head;
``errormap_demo``, the error-map refiner trained against synthetic_demo's
coarse output) are flattened Flax trees, one npz entry per leaf keyed by its path
(``params/encoder/stem/conv/kernel``), so they load with numpy alone.
Unlike the JAX package's oracle bridge this one keeps the ``seg_head``
subtree: a network built from a co-trained tree has the segmentation
pass.
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
    (False, False, 1, True): "synthetic_demo",
    (False, False, 2, True): "fast_demo",
    (True, False, 1, False): "trimap_demo",
    (True, False, 2, True): "trimap_prop_demo",
    (False, True, 2, True): "plate_demo",
}


#: The same for the co-trained checkpoints (matting weights and seg_head).
_SEG_CKPTS = {
    (False, False, 1, True): "seg_demo",
}


def plate_default_config() -> ModelConfig:
    """The shipped clean-plate family's configuration (``plate_demo``),
    which a bare ``bg_plate=`` argument selects, as in the JAX package.
    Must stay in sync with the ``plate_demo`` axes in ``_DEFAULT_CKPTS``."""
    return ModelConfig(use_bg_plate=True, space_to_depth=2)


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


def default_checkpoint_path(cfg: ModelConfig,
                            seg: bool = False) -> Optional[str]:
    """Path of the shipped checkpoint matching ``cfg`` in this package, or
    None: the JAX package's five entries (``_DEFAULT_CKPTS``), or with
    ``seg`` its co-trained one (``_SEG_CKPTS``). Only the base channel
    plan has shipped weights."""
    base = ModelConfig()
    if (cfg.enc_channels, cfg.dec_channels) != (base.enc_channels,
                                                base.dec_channels):
        return None
    name = (_SEG_CKPTS if seg else _DEFAULT_CKPTS).get(
        (cfg.use_trimap, cfg.use_bg_plate, cfg.space_to_depth,
         cfg.recurrent))
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
            "package's layout). The port ships synthetic_demo (s2d=1), "
            "fast_demo (s2d=2), plate_demo (use_bg_plate, s2d=2), "
            "trimap_demo (use_trimap, recurrent=False) and "
            "trimap_prop_demo (use_trimap, s2d=2) only.")
    return load_npz(path)


def seg_default_variables(cfg: ModelConfig) -> Dict[str, Any]:
    """The shipped co-trained weights (with ``seg_head``) for ``cfg``, or
    raise: a matting-only checkpoint has no segmentation head
    (vidmat/models/weights.py ``seg_default_variables``)."""
    path = default_checkpoint_path(cfg, seg=True)
    if path is None:
        raise ValueError(
            f"no shipped co-trained (seg_head) checkpoint matches {cfg!r}: "
            "pass variables= from a co-training run; the shipped seg "
            "default covers the base plan only (seg_demo)")
    return load_npz(path)


def _conv_weight(kernel, dtype) -> torch.Tensor:
    """Flax conv kernel (KH, KW, I, O) -> (O, I, KH, KW) in ``dtype``,
    unscaled (the planar kernels' weight layout)."""
    k = torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, np.float32)))
    return k.permute(3, 2, 0, 1).contiguous().to(dtype)


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32))


def folded_planar_params(cfg: ModelConfig, variables: Dict[str, Any],
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-site parameters of the planar network, BatchNorm folded once.

    Every conv site maps to {"w": (C_out, C_in, k, k) in ``dtype``,
    "scale", "bias": (C_out,) float32}: a ConvBNAct's kernel cast unscaled
    with its BatchNorm folded into (scale, bias) by ``fold_bn``; the head's
    kernel with scale 1 and its conv bias. Decoder stages add
    "<stage>_gru": {"wg": (2C, 2C, 3, 3), "bg": (2C,), "wc": (C, 2C, 3, 3),
    "bc": (C,)}; the bottleneck gate is {"w": (C, F), "b": (F,)} float32.
    The JAX package's ``fold_bn`` and ``conv_tap_weights`` compute the same
    values in its layout (tests/test_torch_planar.py holds them equal)."""
    from vidmat_torch.ops.planar import fold_bn

    prm, stt = variables["params"], variables["batch_stats"]

    def cba(p, st):
        scale, bias = fold_bn(_f32(p["bn"]["scale"]), _f32(p["bn"]["bias"]),
                              _f32(st["bn"]["mean"]), _f32(st["bn"]["var"]),
                              cfg.bn_eps)
        return {"w": _conv_weight(p["conv"]["kernel"], dtype),
                "scale": scale, "bias": bias}

    out = {}
    for name in ("stem", "s2a", "s2b", "s3a", "s3b", "s4a", "s4b"):
        out[name] = cba(prm["encoder"][name], stt["encoder"][name])
    bp, bs = prm["bottleneck"], stt["bottleneck"]
    out["proj"] = cba(bp["proj"], bs["proj"])
    out["gate"] = {"w": _f32(np.asarray(bp["gate"]["kernel"])[0, 0]),
                   "b": _f32(bp["gate"]["bias"])}
    for name in ("d3", "d2", "d1"):
        out[name] = cba(prm[name]["conv"], stt[name]["conv"])
        if cfg.recurrent:
            gp = prm[name]["gru"]
            out[f"{name}_gru"] = {
                "wg": _conv_weight(gp["gates"]["kernel"], dtype),
                "bg": _f32(gp["gates"]["bias"]),
                "wc": _conv_weight(gp["cand"]["kernel"], dtype),
                "bc": _f32(gp["cand"]["bias"])}
    out["d0"] = cba(prm["d0"], stt["d0"])
    hb = _f32(prm["head"]["bias"])
    out["head"] = {"w": _conv_weight(prm["head"]["kernel"], dtype),
                   "scale": torch.ones_like(hb), "bias": hb}
    if "seg_head" in prm:
        sb = _f32(prm["seg_head"]["bias"])
        out["seg_head"] = {"w": _conv_weight(prm["seg_head"]["kernel"],
                                             dtype),
                           "scale": torch.ones_like(sb), "bias": sb}
    return out


def default_refiner_path() -> str:
    """Path of the shipped error-map refiner (``errormap_demo``)."""
    return os.path.join(_CKPT_DIR, "errormap_demo.npz")


def default_refiner_variables() -> Dict[str, Any]:
    """The shipped error-map refiner's weights, or raise: random-weight
    refinement would silently degrade the alpha, so it is refused
    (vidmat/pipeline/video.py ``_load_default_refiner``)."""
    path = default_refiner_path()
    if not os.path.isfile(path):
        raise ValueError(
            "refine.mode='errormap' needs trained refiner weights: pass "
            "refiner_variables=... (the default checkpoint "
            f"{path} is not present). Random-weight refinement would "
            "silently degrade the alpha, so it is refused.")
    return load_npz(path)


def build_refiner(variables: Dict[str, Any], num_patches: int,
                  patch_size: int, device="cpu"):
    """The error-map refiner (``refine.errormap.ErrorMapRefiner``) in eval
    mode holding ``variables``, the JAX refiner's variables (``params``
    and ``batch_stats``, nested dicts of numpy arrays)."""
    from vidmat_torch.refine.errormap import ErrorMapRefiner

    ref = ErrorMapRefiner(num_patches=num_patches, patch_size=patch_size)
    ref.load_state_dict(state_dict_from_jax(variables))
    ref.requires_grad_(False)
    return ref.eval().to(device)


def build_network(cfg: ModelConfig, variables: Dict[str, Any],
                  dtype: Optional[torch.dtype] = None,
                  device="cpu", fuse_pairs: bool = True):
    """The network for ``cfg`` in eval mode holding ``variables``:
    a PlanarNetwork (the four planar conv kernels, BatchNorm folded) for
    ``conv_impl="planar"``, else a MattingNetwork (F.conv2d). ``dtype``:
    compute (plane) dtype, None = float32. ``fuse_pairs`` selects the
    planar network's fused kernels. A co-trained ``seg_head`` gives the
    network its segmentation pass."""
    from vidmat_torch.models.matting_net import MattingNetwork

    if cfg.conv_impl == "planar":
        from vidmat_torch.models.planar import PlanarNetwork

        net = PlanarNetwork(cfg, folded_planar_params(
            cfg, variables, dtype or torch.float32),
            dtype=dtype or torch.float32, fuse_pairs=fuse_pairs)
        net.requires_grad_(False)
        return net.eval().to(device)
    sd = state_dict_from_jax(variables)
    net = MattingNetwork(cfg, dtype=dtype,
                         with_seg="seg_head" in variables["params"])
    net.load_state_dict(sd)
    net.requires_grad_(False)
    return net.eval().to(device)
