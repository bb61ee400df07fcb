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

import math
import os
import zlib
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


def _module_entries(variables: Dict[str, Any]):
    """(torch name, (collection, Flax path), leaf, is_conv_kernel) for
    every leaf of Flax variables: ``params/.../kernel`` is a conv weight
    to transpose, ``scale`` a BatchNorm weight, ``bias`` a bias, and
    ``batch_stats/.../{mean, var}`` the running statistics."""
    for path, v in _walk(variables["params"]):
        parent, leaf = path.rsplit("/", 1)
        name = {"kernel": "weight", "scale": "weight",
                "bias": "bias"}.get(leaf)
        if name is None:
            raise KeyError(f"unhandled flax param leaf: {path}")
        yield (f"{parent.replace('/', '.')}.{name}", ("params", path), v,
               leaf == "kernel")
    for path, v in _walk(variables.get("batch_stats", {})):
        parent, leaf = path.rsplit("/", 1)
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise KeyError(f"unhandled flax batch_stat leaf: {path}")
        yield (f"{parent.replace('/', '.')}.{name}", ("batch_stats", path),
               v, False)


def state_dict_from_jax(variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dict of numpy arrays) -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, _, v, kernel in _module_entries(variables):
        v = np.asarray(v, np.float32)
        if kernel:  # conv (H, W, I, O) -> (O, I, H, W)
            v = np.transpose(v, (3, 2, 0, 1))
        out[name] = torch.tensor(v)
    return out


def module_tensors(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables whose leaves are tensors -> the module's parameter
    and buffer names, each its leaf or, for a conv kernel, a contiguous
    (O, I, H, W) copy made by autograd: ``torch.func.functional_call``
    runs a module on them and gradients reach the Flax-layout leaves."""
    return {name: v.permute(3, 2, 0, 1).contiguous() if kernel else v
            for name, _, v, kernel in _module_entries(variables)}


def variables_from_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of state_dict_from_jax: a module's state (torch names and
    layouts) -> Flax variables {'params', 'batch_stats'}, nested dicts of
    float32 numpy arrays keyed by the Flax names (a 4-d ``weight`` is a
    conv kernel, a 1-d one a BatchNorm scale)."""
    flat: Dict[str, np.ndarray] = {}
    for name, v in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v, np.float32)
        parent, leaf = name.rsplit(".", 1)
        parent = parent.replace(".", "/")
        if leaf == "weight" and v.ndim == 4:
            flat[f"params/{parent}/kernel"] = np.ascontiguousarray(
                np.transpose(v, (2, 3, 1, 0)))
        elif leaf == "weight":
            flat[f"params/{parent}/scale"] = v
        elif leaf == "bias":
            flat[f"params/{parent}/bias"] = v
        elif leaf == "running_mean":
            flat[f"batch_stats/{parent}/mean"] = v
        elif leaf == "running_var":
            flat[f"batch_stats/{parent}/var"] = v
        else:
            raise KeyError(f"unhandled state_dict entry: {name}")
    out = unflatten_variables(flat)
    out.setdefault("batch_stats", {})
    return out


def numpy_variables(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Variables with tensor leaves (on any device) -> numpy leaves."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)
    return unflatten_variables({k: conv(v) for k, v in _walk(variables)})


# Flax's lecun_normal: a normal truncated at two standard deviations,
# scaled so that its variance is 1 / fan_in (the std of the unit normal
# truncated to [-2, 2] is 0.8796...).
_TRUNC_STD = .87962566103423978


def _leaf_seed(seed: int, name: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(name.encode())) % (1 << 62)


def init_module_variables(module: torch.nn.Module, seed: int = 0,
                          skip: tuple = ()) -> Dict[str, Any]:
    """Flax's default initialisation of ``module``'s leaves, as Flax
    variables: conv kernels ``lecun_normal`` (each drawn from its own
    ``torch.Generator``, seeded by ``seed`` and the leaf's name, so a
    leaf's values do not depend on which other leaves exist), conv biases
    0, BatchNorm scale 1 and bias 0, running statistics 0 and 1. Entries
    whose name starts with one of ``skip`` are left out. JAX's PRNG is not
    reproduced: the values differ from the JAX package's for the same
    seed, their distribution is the same."""
    sd = {}
    for name, v in module.state_dict().items():
        if name.startswith(skip) or name.endswith("num_batches_tracked"):
            continue
        if name.endswith(".weight") and v.ndim == 4:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            g = torch.Generator().manual_seed(_leaf_seed(seed, name))
            v = torch.nn.init.trunc_normal_(
                torch.empty(v.shape), 0.0, std, -2.0 * std, 2.0 * std,
                generator=g)
        sd[name] = v
    return variables_from_state_dict(sd)


def init_params(cfg: ModelConfig = ModelConfig(), seed: int = 0,
                height: int = 64, width: int = 64,
                with_seg: bool = False) -> Dict[str, Any]:
    """Initialise the network's variables {'params', 'batch_stats'}
    (vidmat/models/weights.py ``init_params``), Flax's defaults drawn from
    ``torch.Generator`` s (``init_module_variables``). The shapes do not
    depend on the frame size: ``height`` and ``width`` are accepted for
    the JAX package's signature. ``with_seg`` adds the ``seg_head``; the
    trunk is the same either way."""
    from vidmat_torch.models.matting_net import MattingNetwork

    del height, width
    return init_module_variables(MattingNetwork(cfg, with_seg=True), seed,
                                 skip=() if with_seg else ("seg_head.",))


def graft_seg_params(variables: Dict[str, Any], cfg: ModelConfig,
                     seed: int = 0) -> Dict[str, Any]:
    """Add a fresh ``seg_head`` to a matting checkpoint so it can enter
    segmentation co-training. The matting pass never reads ``seg_head``,
    so matting outputs are bit-identical before and after the graft."""
    params = dict(variables["params"])
    if "seg_head" in params:
        raise ValueError("checkpoint already has a seg_head")
    fresh = init_params(cfg, seed=seed, with_seg=True)
    params["seg_head"] = fresh["params"]["seg_head"]
    return {"params": params, "batch_stats": variables["batch_stats"]}


def graft_cond_params(src: Dict[str, Any], cfg: ModelConfig,
                      src_in_channels: int = 3,
                      seed: int = 0) -> Dict[str, Any]:
    """Transfer a checkpoint into a config with more input-conditioning
    channels (trimap and/or clean background plate), as
    vidmat/models/weights.py ``graft_cond_params``: every leaf of equal
    shape is copied; the stem's kernel (and at s2d > 1 the d0 kernel's
    trailing frame rows) grow from ``src_in_channels`` to
    ``cfg.in_channels`` per s2d position, the new rows zero, so the
    grafted net is exactly the source net until training opens them."""
    cs, ct = src_in_channels, cfg.in_channels
    if ct <= cs:
        raise ValueError(
            f"target config has {ct} input channels, source {cs}: the "
            "graft only adds conditioning channels (use_trimap / "
            "use_bg_plate)")
    s = cfg.space_to_depth
    src_flat = flatten_variables(src)
    tgt_flat = flatten_variables(init_params(cfg, seed=seed))
    if set(src_flat) != set(tgt_flat):
        raise ValueError("source/target trees differ beyond the input "
                         "channel plan: not a graftable pair")
    out = {}
    for key, lt in tgt_flat.items():
        ls = src_flat[key]
        if ls.shape == lt.shape:
            out[key] = ls
        elif (ls.ndim == 4 and ls.shape[:2] == lt.shape[:2]
              and ls.shape[3] == lt.shape[3]
              and lt.shape[2] - ls.shape[2] == s * s * (ct - cs)):
            k = np.zeros(lt.shape, ls.dtype)
            lead = ls.shape[2] - s * s * cs
            k[:, :, :lead] = ls[:, :, :lead]
            for p in range(s * s):
                for c in range(cs):
                    k[:, :, lead + p * ct + c] = ls[:, :, lead + p * cs + c]
            out[key] = k
        else:
            raise ValueError(f"ungraftable shape at {key}: {ls.shape} -> "
                             f"{lt.shape}")
    return unflatten_variables(out)


def randomize_bn_stats(variables: Dict[str, Any], seed: int = 1
                       ) -> Dict[str, Any]:
    """Replace the (0, 1) BatchNorm running statistics with random ones
    (means N(0, 0.1), variances U(0.5, 1.5), drawn from one
    ``np.random.RandomState(seed)`` in the tree's order), so that a
    BatchNorm ordering or eps bug cannot hide behind identity statistics
    (vidmat/models/weights.py ``randomize_bn_stats``)."""
    rng = np.random.RandomState(seed)

    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(
                    np.float32)
            else:
                out[k] = v
        return out

    return {"params": variables["params"],
            "batch_stats": walk(variables["batch_stats"])}


def save_npz(path: str, variables: Dict[str, Any]) -> None:
    """Write nested variables as a flat npz (one entry per leaf)."""
    np.savez(path, **flatten_variables(variables))


def save_checkpoint(path: str, variables: Dict[str, Any]) -> str:
    """Write variables (numpy or tensor leaves, on any device) as the
    port's ``.npz`` checkpoint (``save_npz``) and return the path written
    (``.npz`` appended when missing). The JAX package writes an orbax
    directory; the port's readers (``load_npz``, the CLI's
    ``--checkpoint``) take this file."""
    path = os.path.abspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_npz(path, numpy_variables(variables))
    return path


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
