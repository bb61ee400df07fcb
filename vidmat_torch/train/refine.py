"""Training of the error-map patch refiner (counterpart of
vidmat/train/refine.py): the base matting net is frozen; the refiner
learns to predict where the upsampled coarse alpha is wrong and to fix
the K worst patches at full resolution.

Loss = L1(refined alpha, gt) + L1(error head, |alpha_up - gt| resized to
the coarse grid). The optimizer is plain Adam without clipping, over
every leaf of the refiner's variables: as in the JAX package, whose step
differentiates the whole {'params', 'batch_stats'} tree, the BatchNorm
running statistics (used as a frozen affine) are trained too.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.func import functional_call

from vidmat_torch._device import full_fp32, resolve_device
from vidmat_torch.config import ModelConfig
from vidmat_torch.models.layers import abs_ties_one
from vidmat_torch.models.weights import init_module_variables, module_tensors
from vidmat_torch.ops.resize import resize_bilinear
from vidmat_torch.refine.errormap import ErrorMapRefiner
from vidmat_torch.train.loop import leaf_grads, to_device, to_tensor
from vidmat_torch.train.optim import adam, apply_updates, tree_map


def init_refiner_params(seed: int = 0, num_patches: int = 16,
                        patch_size: int = 16) -> Dict[str, Any]:
    """The refiner's variables with Flax's default initialisation
    (``weights.init_module_variables``)."""
    return init_module_variables(
        ErrorMapRefiner(num_patches=num_patches, patch_size=patch_size),
        seed)


def make_refiner_train_step(refiner: ErrorMapRefiner, optimizer,
                            device="cuda"):
    """step(params, opt_state, rgb_full, rgb_lr, alpha_lr, gt_alpha) ->
    (params, opt_state, loss, terms): ``params`` is the refiner's variables
    tree (its leaves move to the device on the first step); the inputs
    are NHWC float32 arrays or tensors. ``refiner`` gives the patch count
    and size; the step runs a differentiable copy of it."""
    dev = resolve_device(device)
    net = ErrorMapRefiner(num_patches=refiner.num_patches,
                          patch_size=refiner.patch_size,
                          differentiable=True).to(dev)

    def step(params, opt_state, rgb_full, rgb_lr, alpha_lr, gt_alpha):
        params = to_device(params, dev)
        opt_state = to_device(opt_state, dev)
        with full_fp32():
            rgb_full, rgb_lr, alpha_lr, gt_alpha = (
                to_tensor(x, dev)
                for x in (rgb_full, rgb_lr, alpha_lr, gt_alpha))
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            refined, err = functional_call(net, module_tensors(leaves),
                                           (rgb_full, rgb_lr, alpha_lr))
            l_alpha = abs_ties_one(refined - gt_alpha).mean()
            alpha_up = resize_bilinear(alpha_lr, gt_alpha.shape[1],
                                       gt_alpha.shape[2])
            true_err = resize_bilinear(abs_ties_one(alpha_up - gt_alpha),
                                       alpha_lr.shape[1], alpha_lr.shape[2])
            l_err = abs_ties_one(err - true_err).mean()
            loss = l_alpha + l_err
            grads = leaf_grads(loss, leaves)
            with torch.no_grad():
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                params = apply_updates(params, updates)
        return (params, opt_state, loss.detach(),
                {"alpha": l_alpha.detach(), "err": l_err.detach()})

    return step


def train_refiner(base_variables, cfg: ModelConfig = ModelConfig(),
                  num_steps: int = 300, lr: float = 1e-3,
                  full_hw: int = 128, ratio: int = 2,
                  num_patches: int = 16, patch_size: int = 16,
                  seed: int = 0, callback=None, device="cuda"):
    """Train the refiner on synthetic frames against the frozen base net
    (``base_variables``, run as the plain-conv network in float32).
    Returns (refiner module, refiner variables)."""
    from vidmat_torch.io.fixtures import synthetic_frame
    from vidmat_torch.models.matting_net import MattingNetwork
    from vidmat_torch.models.weights import state_dict_from_jax

    dev = resolve_device(device)
    net = MattingNetwork(cfg)
    net.load_state_dict(state_dict_from_jax(base_variables))
    net.requires_grad_(False)
    net = net.eval().to(dev)
    refiner = ErrorMapRefiner(num_patches=num_patches, patch_size=patch_size)
    hf = wf = full_hw
    hl = wl = full_hw // ratio
    rng = np.random.RandomState(seed)

    def batch(n=4):
        rgbs, gts = [], []
        for _ in range(n):
            frame, gt = synthetic_frame(hf, wf, rng.rand(),
                                        seed=int(rng.randint(10000)))
            rgbs.append(frame.astype(np.float32) / 255.0)
            gts.append(gt)
        with torch.no_grad(), full_fp32():
            rgbs = torch.from_numpy(np.stack(rgbs)).to(dev)
            lrs = resize_bilinear(rgbs, hl, wl)
            alpha_lr, _, _ = net(lrs, None)
        return rgbs, lrs, alpha_lr, torch.from_numpy(np.stack(gts)).to(dev)

    params = to_device(init_refiner_params(seed, num_patches, patch_size),
                       dev)
    optimizer = adam(lr)
    opt_state = optimizer.init(params)
    step = make_refiner_train_step(refiner, optimizer, device=dev)

    pool = [batch() for _ in range(16)]
    for i in range(num_steps):
        rgbs, lrs, alpha_lr, gts = pool[i % len(pool)]
        params, opt_state, loss, _ = step(params, opt_state, rgbs, lrs,
                                          alpha_lr, gts)
        if callback is not None:
            callback(i, float(loss))
    return refiner, params
