"""Matting and segmentation losses (counterpart of
vidmat/train/losses.py): alpha L1, gradient, composition and temporal
coherence, with the optional Laplacian-pyramid and boundary-band terms.

Tensors are NHWC, (T, N, H, W, C), as in the JAX package. Gradients follow
JAX's rules at exact ties: ``|x|`` passes +1 at 0 (``abs_ties_one``;
``torch.abs`` passes 0), and the clip in the network's head passes half
the gradient at a bound. Everything here is elementwise work and small
convolutions that autograd differentiates; no kernel is written for it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vidmat_torch.models.layers import abs_ties_one
from vidmat_torch.ops.resize import resize_bilinear

# 5-tap binomial [1 4 6 4 1] / 16, the Burt-Adelson pyramid filter.
_GAUSS5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _l1(x: torch.Tensor) -> torch.Tensor:
    return abs_ties_one(x).mean()


def _sobel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial forward differences on NHWC (T folded into N)."""
    return x[:, 1:] - x[:, :-1], x[:, :, 1:] - x[:, :, :-1]


def _blur_down(x: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap blur (zero padded) and 2x decimation on NHWC: the
    odd sizes round up, as ``[::2]`` does."""
    n, h, w, c = x.shape
    k = torch.tensor(_GAUSS5, dtype=x.dtype, device=x.device)
    xt = x.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    xt = F.conv2d(xt, k.view(1, 1, 5, 1), padding=(2, 0))
    xt = F.conv2d(xt, k.view(1, 1, 1, 5), padding=(0, 2))
    xt = xt[:, :, ::2, ::2]
    return xt.reshape(n, c, xt.shape[2], xt.shape[3]).permute(0, 2, 3, 1)


def laplacian_pyramid_loss(pred: torch.Tensor, gt: torch.Tensor,
                           levels: int = 5) -> torch.Tensor:
    """Multi-scale L1 over Laplacian pyramid bands, band k weighted 2^k;
    pred and gt are (N, H, W, C), the levels capped so the coarsest band
    is at least 4 px. The upsample is the JAX package's bilinear resize
    to the finer level's size (not exactly 2x at odd sizes)."""
    h, w = pred.shape[1], pred.shape[2]
    levels = max(1, min(levels, int(math.log2(min(h, w))) - 1))
    loss = pred.new_zeros(())
    for k in range(levels):
        if k == levels - 1:
            bp, bg = pred, gt
        else:
            dp, dg = _blur_down(pred), _blur_down(gt)
            bp = pred - resize_bilinear(dp, pred.shape[1], pred.shape[2])
            bg = gt - resize_bilinear(dg, gt.shape[1], gt.shape[2])
            pred, gt = dp, dg
        loss = loss + (2.0 ** k) * _l1(bp - bg)
    return loss


def matting_loss(pred_alpha: torch.Tensor, pred_fgr: torch.Tensor,
                 gt_alpha: torch.Tensor, gt_fgr: Optional[torch.Tensor],
                 frames: torch.Tensor, temporal_axis: bool = True,
                 laplacian_weight: float = 0.0,
                 boundary_weight: float = 0.0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The composite matting loss (vidmat/train/losses.py
    ``matting_loss``).

    pred_alpha/gt_alpha: (T, N, H, W, 1); pred_fgr: (T, N, H, W, 3);
    gt_fgr: the ground-truth foreground, or None (the composition term is
    then the gt-alpha-weighted frame reconstruction); frames: (T, N, H, W,
    C), its first three channels RGB. laplacian_weight and
    boundary_weight switch on the pyramid term and the L1 over the 5x5
    dilated edge band of the ground truth. Returns (scalar loss, dict of
    unweighted terms)."""
    t, n = pred_alpha.shape[:2]

    def flat(x):
        return x.reshape((t * n,) + tuple(x.shape[2:]))

    pa, ga = flat(pred_alpha), flat(gt_alpha)
    pf, fr = flat(pred_fgr), flat(frames[..., :3])

    l_alpha = _l1(pa - ga)
    pdy, pdx = _sobel(pa)
    gdy, gdx = _sobel(ga)
    l_grad = _l1(pdy - gdy) + _l1(pdx - gdx)

    if gt_fgr is not None:
        l_fgr = _l1((pf - flat(gt_fgr)) * (ga > 0))
    else:
        l_fgr = _l1(pf * ga - fr * ga)

    if temporal_axis and t > 1:
        l_temp = _l1((pred_alpha[1:] - pred_alpha[:-1])
                     - (gt_alpha[1:] - gt_alpha[:-1]))
    else:
        l_temp = pa.new_zeros(())

    total = l_alpha + l_grad + l_fgr + 5.0 * l_temp
    terms = {"alpha": l_alpha, "grad": l_grad, "fgr": l_fgr,
             "temporal": l_temp}
    if laplacian_weight > 0.0:
        l_lap = laplacian_pyramid_loss(pa, ga)
        total = total + laplacian_weight * l_lap
        terms["laplacian"] = l_lap
    if boundary_weight > 0.0:
        # The non-saturated gt region dilated by a 5x5 max (a {0, 1} band:
        # max_pool2d's padding equals reduce_window's init 0).
        band = ((ga > 0.02) & (ga < 0.98)).to(pa.dtype)
        band = F.max_pool2d(band.permute(0, 3, 1, 2), 5, 1, 2).permute(
            0, 2, 3, 1)
        l_band = ((abs_ties_one(pa - ga) * band).sum()
                  / torch.clamp(band.sum(), min=1.0))
        total = total + boundary_weight * l_band
        terms["boundary"] = l_band
    return total, terms


def segmentation_loss(logits: torch.Tensor, gt_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sigmoid BCE of the segmentation co-training pass
    (vidmat/train/losses.py ``segmentation_loss``); logits and gt_mask
    (T, N, H, W, 1), the mask in {0, 1}. Returns (BCE, {"seg_bce",
    "seg_iou"}); the IoU at logit 0 is a metric only, and 1 for an empty
    union."""
    l = logits.float()
    m = gt_mask.float()
    bce = (torch.maximum(l, l.new_zeros(())) - l * m
           + torch.log1p(torch.exp(-abs_ties_one(l)))).mean()
    pred = (l > 0.0).float()
    inter = (pred * m).sum()
    union = torch.maximum(pred, m).sum()
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-8),
                      torch.ones_like(union))
    return bce, {"seg_bce": bce, "seg_iou": iou.detach()}
