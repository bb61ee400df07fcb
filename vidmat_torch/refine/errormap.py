"""Error-map-guided patch refinement (counterpart of
vidmat/refine/errormap.py).

  1. ``ErrorHead`` predicts a per-pixel error map from the coarse
     (rgb, alpha) pair at the network's resolution.
  2. The error map is resized bilinearly onto the full-resolution patch
     grid (H // P, W // P) and the K worst slots are selected: a stable
     descending sort, which orders equal scores by slot index as
     ``jax.lax.top_k`` does (the head ends in a ReLU, so flat regions
     tie at exactly 0 and the tie order decides which patches are
     refined).
  3. The K patches of [rgb_full, alpha_up] are gathered by index on the
     device, refined by ``PatchRefineNet`` as one (N*K, 4, P, P) batch and
     added back weighted by a feather, then the alpha is clipped to
     [0, 1].

No host read-back and no per-patch loop: the gather and the scatter index
a view of the frame split into its P-grid, so a call enqueues a fixed
sequence of device work and a CUDA graph can hold it. The patches sit on
the non-overlapping grid and the K slots are distinct, so the scatter has
no order to keep. Convolutions are ``F.conv2d`` (the JAX package runs
them as XLA convolutions, outside any Pallas kernel). Inputs and outputs
are NHWC, as in the JAX module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vidmat_torch.models.layers import Conv, ConvBNAct, clip_ties_half
from vidmat_torch.ops.resize import resize_bilinear


class ErrorHead(nn.Module):
    """Per-pixel refinement need from (rgb_lr, alpha_lr): their
    concatenation, ConvBNAct(4 -> 16), a 3x3 conv to 1, ReLU. NCHW."""

    def __init__(self):
        super().__init__()
        self.c1 = ConvBNAct(4, 16)
        self.c2 = Conv(16, 1, 3)

    def forward(self, rgb_lr: torch.Tensor,
                alpha_lr: torch.Tensor) -> torch.Tensor:
        x = torch.cat([rgb_lr, alpha_lr], dim=1)
        return F.relu(self.c2(self.c1(x)))


class PatchRefineNet(nn.Module):
    """Residual alpha of full-resolution patches of (rgb, alpha_up): three
    ConvBNAct(features) and a 3x3 head to 1. NCHW."""

    def __init__(self, features: int = 24):
        super().__init__()
        self.c1 = ConvBNAct(4, features)
        self.c2 = ConvBNAct(features, features)
        self.c3 = ConvBNAct(features, features)
        self.head = Conv(features, 1, 3)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.head(self.c3(self.c2(self.c1(patches))))


def _feather(p: int, band: int) -> np.ndarray:
    """(p, p, 1) blend weights: a linear ramp over ``band`` pixels at each
    edge, the outer product of the row and column ramps."""
    ramp = np.ones(p, np.float32)
    if band > 0:
        e = np.linspace(1.0 / (band + 1), 1.0, band, dtype=np.float32)
        ramp[:band] = e
        ramp[-band:] = e[::-1]
    return (ramp[:, None] * ramp[None, :])[..., None]


def select_patches(err_grid: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (N, k) of the k largest of each row of ``err_grid`` (N, S),
    largest first, equal values in ascending index order: the order of
    ``jax.lax.top_k``."""
    return torch.sort(err_grid, dim=1, descending=True,
                      stable=True).indices[:, :k]


def _grid_view(x: torch.Tensor, p: int) -> torch.Tensor:
    """(N, H, W, C) -> a view (N, H // p, p, W // p, p, C) of its P-grid."""
    n, h, w, _ = x.shape
    gh, gw = h // p, w // p
    return x[:, :gh * p, :gw * p].unflatten(1, (gh, p)).unflatten(3, (gw, p))


class ErrorMapRefiner(nn.Module):
    """The error-map refinement stage.

    forward(rgb_full (N, H, W, 3), rgb_lr (N, h, w, 3), alpha_lr (N, h, w,
    1)) -> (alpha (N, H, W, 1) in [0, 1], error map (N, h, w, 1)), all
    NHWC float32: ``num_patches`` patches of ``patch_size`` are refined at
    full resolution, the alpha elsewhere is the bilinear upsample. The
    feather is a buffer, made once and moved with the module.

    ``differentiable=True`` is the refiner's trainer's module: the forward
    runs outside inference mode, gradients flow through the error head,
    the patch gather and the scatter (not through the selection, which is
    an index), and the final clip passes half the gradient at a bound, as
    ``jnp.clip``."""

    def __init__(self, num_patches: int = 64, patch_size: int = 16,
                 features: int = 24, differentiable: bool = False):
        super().__init__()
        self.differentiable = differentiable
        self.num_patches = num_patches
        self.patch_size = patch_size
        self.error_head = ErrorHead()
        self.refine_net = PatchRefineNet(features)
        feather = _feather(patch_size, max(2, patch_size // 8))
        self.register_buffer("feather", torch.from_numpy(feather),
                             persistent=False)

    def forward(self, rgb_full: torch.Tensor, rgb_lr: torch.Tensor,
                alpha_lr: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.differentiable:
            return self._refine(rgb_full, rgb_lr, alpha_lr)
        with torch.inference_mode():
            return self._refine(rgb_full, rgb_lr, alpha_lr)

    def _refine(self, rgb_full: torch.Tensor, rgb_lr: torch.Tensor,
                alpha_lr: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        n, hf, wf, _ = rgb_full.shape
        p, k = self.patch_size, self.num_patches
        err = self.error_head(rgb_lr.permute(0, 3, 1, 2),
                              alpha_lr.permute(0, 3, 1, 2)).permute(
                                  0, 2, 3, 1)               # (N, h, w, 1)
        alpha_up = resize_bilinear(alpha_lr, hf, wf)

        gh, gw = hf // p, wf // p
        err_grid = resize_bilinear(err, gh, gw).reshape(n, gh * gw)
        idx = select_patches(err_grid, k)                    # (N, K)
        iy, ix = idx // gw, idx % gw
        ib = torch.arange(n, device=idx.device)[:, None].expand(n, k)

        src = torch.cat([rgb_full, alpha_up], dim=-1)
        patches = _grid_view(src, p)[ib, iy, :, ix]           # (N, K, P, P, 4)
        res = self.refine_net(
            patches.reshape(n * k, p, p, 4).permute(0, 3, 1, 2))
        res = res.permute(0, 2, 3, 1).reshape(n, k, p, p, 1)

        alpha = alpha_up.clone()
        grid = _grid_view(alpha, p)
        grid[ib, iy, :, ix] = grid[ib, iy, :, ix] + res * self.feather
        if self.differentiable:
            return clip_ties_half(alpha, 0.0, 1.0), err
        return alpha.clamp(0.0, 1.0), err
