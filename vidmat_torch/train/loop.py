"""The training loop (counterpart of vidmat/train/loop.py): truncated
BPTT of the recurrent net over T frames, the matting loss and the
optimizer step; the segmentation co-training step; ``train_on_clips``.

Variables stay in the JAX package's layout: ``TrainState.variables`` is
{'params', 'batch_stats'}, nested dicts of float32 tensors keyed by the
Flax names, conv kernels (H, W, I, O). The step runs the training network
(``MattingNetwork(cfg, bn_train=True)``, plain ``F.conv2d`` whatever
``cfg.conv_impl`` says: the planar kernels have no backward) through
``torch.func.functional_call`` on views of those leaves, so gradients and
optimizer state are per Flax leaf, as optax's.

BatchNorm statistics are per frame, over N, H and W: each of the T frames
reports its batch statistics (``layers.batch_statistics``) and folds them
into the running statistics once, in frame order, as the JAX step's scan
carries them. With ``remat`` each frame runs under
``torch.utils.checkpoint``: the backward reruns the frame, and the rerun
reports into a scope of its own that is dropped, so no statistic is
counted twice. The step runs in full float32 (``_device.full_fp32``).

``mesh=`` shards the step as the JAX package's ``in_shardings`` do
(``parallel/spatial.py``): the clips' and targets' N axis over 'data'
(the mesh's first axis where there is no 'data', unless that is
'spatial'), their W axis over 'spatial' where the mesh has it; axes of
other names replicate. The frames run over the positions in lock step,
BatchNorm's batch statistics are global over N, H and W (its float64
moments summed over the positions), and the outputs are gathered to the
first position for the unchanged loss, whose boundary and IoU terms are
ratios of global sums. The parameters live once on the first position
and reach the others through ``.to()``, so autograd sums their
gradients; across processes the gradients are then summed and every
process takes the same optimizer step. So the sharded step computes the
unsharded step's function, as GSPMD keeps it. In a job of several
processes each process passes the whole rows of the data groups its
positions belong to (``make_train_step``); a data group's 'spatial'
positions may lie in several processes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from vidmat_torch._device import full_fp32, resolve_device
from vidmat_torch.config import ModelConfig
from vidmat_torch.models.layers import BatchNorm, batch_statistics, ema_update
from vidmat_torch.models.matting_net import (MattingNetwork, RecurrentState,
                                             init_state)
from vidmat_torch.models.weights import module_tensors, to_device
from vidmat_torch.parallel.collectives import sum_over_processes
from vidmat_torch.parallel.mesh import _device
from vidmat_torch.parallel.spatial import Layout, ShardedNetwork
from vidmat_torch.train.losses import matting_loss, segmentation_loss
from vidmat_torch.train.optim import (apply_updates, make_optimizer,
                                      tree_map)

@dataclasses.dataclass
class TrainState:
    variables: Dict[str, Any]  # {'params', 'batch_stats'}
    opt_state: Any
    step: int = 0

    def replace(self, **updates) -> "TrainState":
        """A copy with ``updates`` (flax.struct's ``replace``)."""
        return dataclasses.replace(self, **updates)


def to_tensor(x, device) -> torch.Tensor:
    """An array or tensor as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _nets(cfg, bn_train, device):
    """The training network for a parameter tree (one with and one
    without ``seg_head``), built on first use."""
    cache: Dict[bool, MattingNetwork] = {}

    def get(params) -> MattingNetwork:
        with_seg = "seg_head" in params
        if with_seg not in cache:
            cache[with_seg] = MattingNetwork(
                cfg, with_seg=with_seg, bn_train=bn_train).to(device)
        return cache[with_seg]
    return get


def _forward_clip(cfg, net, params, batch_stats, clips, seg_pass, remat,
                  lay=None):
    """Run the net over the T frames of ``clips`` (T, N, H, W, C) from a
    zero state (over the positions of ``lay`` where one is given).
    Returns the per-frame outputs stacked on T (alpha and fgr, or the seg
    logits and None) and the batch statistics of every frame, in order: a
    list over T of [(BatchNorm module name, mean, var)]."""
    if lay is not None:
        return _forward_clip_mesh(cfg, net, params, batch_stats, clips,
                                  seg_pass, remat, lay)
    t, n, h, w, _ = clips.shape
    tensors = module_tensors({"params": params, "batch_stats": batch_stats})
    names = {id(m): name for name, m in net.named_modules()
             if isinstance(m, BatchNorm)}
    state = init_state(cfg, n, h, w, device=clips.device)

    def frame_step(x, *hidden):
        with batch_statistics() as sink:
            a, f, new = functional_call(
                net, tensors, (x, RecurrentState(*hidden)),
                {"seg_pass": seg_pass})
        stats = [(names[id(m)], mean, var) for m, mean, var in sink]
        return a, f, tuple(new), stats

    outs, fgrs, stats = [], [], []
    for i in range(t):
        if remat:
            a, f, new, st = checkpoint(frame_step, clips[i], *state,
                                       use_reentrant=False)
        else:
            a, f, new, st = frame_step(clips[i], *state)
        state = RecurrentState(*new)
        outs.append(a)
        fgrs.append(f)
        stats.append(st)
    fgr = None if seg_pass else torch.stack(fgrs)
    return torch.stack(outs), fgr, stats


def _forward_clip_mesh(cfg, net, params, batch_stats, clips, seg_pass,
                       remat, lay: Layout):
    """``_forward_clip`` over the positions of ``lay``: clips (T, n, H, W,
    C) are the whole rows of the data groups this process holds a
    position of; the outputs come back whole (every group's rows) on
    ``lay.device``."""
    t, n, h, w, _ = clips.shape
    sharded = ShardedNetwork(net, lay)
    tensors = {f"net.{k}": v for k, v in module_tensors(
        {"params": params, "batch_stats": batch_stats}).items()}
    names = {id(m): name for name, m in net.named_modules()
             if isinstance(m, BatchNorm)}
    fb = lay.frame_bounds(w, cfg.space_to_depth)
    xs = lay.split(clips, 1, 3, fb)
    state = lay.zero_state(cfg, n // len(lay.rows), h, w)

    def frame_step(frames, hidden):
        with batch_statistics() as sink:
            a, f, new = functional_call(sharded, tensors,
                                        (frames, w, hidden),
                                        {"seg_pass": seg_pass})
        stats = [(names[id(m)], mean, var) for m, mean, var in sink]
        return a, f, new, stats

    outs, fgrs, stats = [], [], []
    for i in range(t):
        frames = [[None if x is None else x[i] for x in row] for row in xs]
        if remat:
            a, f, state, st = checkpoint(frame_step, frames, state,
                                         use_reentrant=False)
        else:
            a, f, state, st = frame_step(frames, state)
        outs.append(a)
        fgrs.append(f)
        stats.append(st)

    def whole(per_frame):
        grid = [[None if per_frame[0][r][i] is None
                 else torch.stack([fr[r][i] for fr in per_frame])
                 for i in range(lay.s)] for r in range(len(lay.rows))]
        return lay.join(grid, 1, 3, fb)

    return whole(outs), None if seg_pass else whole(fgrs), stats


def _step_device(device, mesh):
    """The step's device and layout: ``device`` (the card by default)
    without a mesh; with one, the mesh's first position (a ``device``
    elsewhere raises)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device), None
    lay = Layout(mesh)
    if device is not None and _device(device) != lay.device:
        raise ValueError(f"device={device!r} disagrees with the mesh, "
                         f"whose first position is on {lay.device}")
    return lay.device, lay


def _sum_grads(grads, lay):
    """The gradients of a sharded step summed over the processes of the
    job (as they are without a mesh or in one process)."""
    if lay is None or lay.nproc == 1:
        return grads
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, grads)
    it = iter(sum_over_processes(leaves))
    return tree_map(lambda _: next(it), grads)


def _new_batch_stats(batch_stats, stats) -> Dict[str, Any]:
    """Fold each frame's batch statistics into the running ones, frame by
    frame (BatchNorm layers that did not run keep theirs)."""
    flat = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v

    walk(batch_stats, ())
    for frame in stats:
        for name, mean, var in frame:
            path = tuple(name.split("."))
            flat[path + ("mean",)] = ema_update(flat[path + ("mean",)], mean)
            flat[path + ("var",)] = ema_update(flat[path + ("var",)], var)
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def leaf_grads(loss, params) -> Dict[str, Any]:
    """d loss / d params per leaf; a leaf the loss does not reach gets a
    zero tensor (as JAX returns zero cotangents), never None."""
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, params)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, got))
    return tree_map(lambda _: next(it), params)


def _requires_grad(params):
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _finish(state: TrainState, optimizer, params, grads, new_stats,
            metrics) -> tuple:
    with torch.no_grad():
        params = tree_map(torch.Tensor.detach, params)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              params)
        params = apply_updates(params, updates)
    new_state = TrainState(
        variables={"params": params,
                   "batch_stats": tree_map(torch.Tensor.detach, new_stats)},
        opt_state=opt_state, step=state.step + 1)
    return new_state, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, optimizer=None, mesh=None,
                    remat: bool = True, laplacian_weight: float = 0.0,
                    boundary_weight: float = 0.0, device=None):
    """Build the train step.

    train_step(state, clips, gt_alpha, gt_fgr) -> (state, metrics)
      clips:    (T, N, H, W, C) float32 (arrays or tensors)
      gt_alpha: (T, N, H, W, 1)
      gt_fgr:   (T, N, H, W, 3)
    metrics: {"loss", "alpha", "grad", "fgr", "temporal"[, "laplacian",
    "boundary"]}, 0-d tensors on the device. The state's leaves may be
    numpy arrays; they are moved to the device on the first step.

    ``device``: the card by default; with ``mesh=`` (``make_mesh``) the
    step is sharded over its positions (the module docstring), the
    device is this process's first position's. In a job of several
    processes each passes the whole rows (every column) of the data
    groups its positions belong to, in group order, and the step keeps
    its own positions' columns: on a ('data',) mesh its own rows of N; on
    a mesh whose 'spatial' groups span processes (one process a card) the
    rows of each group it holds a position of (with one data group, the
    whole batch). In one process, the whole batch.
    """
    dev, lay = _step_device(device, mesh)
    optimizer = optimizer or make_optimizer()
    nets = _nets(cfg, True, dev)

    def train_step(state: TrainState, clips, gt_alpha, gt_fgr):
        state = dataclasses.replace(
            state, variables=to_device(state.variables, dev),
            opt_state=to_device(state.opt_state, dev))
        with full_fp32():
            clips = to_tensor(clips, dev)
            gt_alpha = to_tensor(gt_alpha, dev)
            gt_fgr = None if gt_fgr is None else to_tensor(gt_fgr, dev)
            params = _requires_grad(state.variables["params"])
            stats0 = state.variables["batch_stats"]
            alphas, fgrs, stats = _forward_clip(
                cfg, nets(params), params, stats0, clips, False, remat, lay)
            if lay is not None:  # every group's rows, for the loss
                clips, gt_alpha, gt_fgr = (
                    None if x is None else lay.whole(x, 1, 3)
                    for x in (clips, gt_alpha, gt_fgr))
            loss, terms = matting_loss(alphas, fgrs, gt_alpha, gt_fgr,
                                       clips,
                                       laplacian_weight=laplacian_weight,
                                       boundary_weight=boundary_weight)
            grads = _sum_grads(leaf_grads(loss, params), lay)
            return _finish(state, optimizer, params, grads,
                           _new_batch_stats(stats0, stats),
                           {"loss": loss, **terms})

    return train_step


def make_seg_train_step(cfg: ModelConfig, optimizer=None, mesh=None,
                        remat: bool = True, bn_train: bool = True,
                        device=None):
    """Build the segmentation co-training step (the shared trunk and
    ``seg_head``, BCE on binary masks).

    seg_step(state, clips, gt_mask) -> (state, metrics)
      clips:   (T, N, H, W, C) float32
      gt_mask: (T, N, H, W, 1) float32 in {0, 1}

    It shares the TrainState and optimizer state with make_train_step:
    the tree is the with_seg tree, and each pass gives zero gradients to
    the other pass's head, so one optimizer drives the interleave.
    bn_train=False runs BatchNorm on the frozen running statistics and
    leaves them as they are (the head-only fit). ``mesh`` and ``device``
    as in ``make_train_step``.
    """
    dev, lay = _step_device(device, mesh)
    optimizer = optimizer or make_optimizer()
    nets = _nets(cfg, bn_train, dev)

    def seg_step(state: TrainState, clips, gt_mask):
        state = dataclasses.replace(
            state, variables=to_device(state.variables, dev),
            opt_state=to_device(state.opt_state, dev))
        with full_fp32():
            clips, gt_mask = to_tensor(clips, dev), to_tensor(gt_mask, dev)
            params = _requires_grad(state.variables["params"])
            stats0 = state.variables["batch_stats"]
            segs, _, stats = _forward_clip(cfg, nets(params), params, stats0,
                                           clips, True, remat, lay)
            if lay is not None:
                gt_mask = lay.whole(gt_mask, 1, 3)
            loss, terms = segmentation_loss(segs, gt_mask)
            grads = _sum_grads(leaf_grads(loss, params), lay)
            return _finish(state, optimizer, params, grads,
                           _new_batch_stats(stats0, stats),
                           {"loss": loss, **terms})

    return seg_step


def train_on_clips(cfg: ModelConfig, data_iter, num_steps: int = 100,
                   lr: float = 1e-4, mesh=None, variables=None,
                   log_every: int = 10, callback=None, seg_data_iter=None,
                   seg_every: int = 0, device=None) -> TrainState:
    """Drive the train step over an iterator of (clips, gt_alpha, gt_fgr)
    numpy batches.

    seg_data_iter + seg_every=K: every K-th step consumes a (clips,
    gt_mask) batch from ``seg_data_iter`` through the segmentation step
    instead. That needs a with_seg tree: it is initialised so when no
    variables are given, and a matting checkpoint gets a fresh
    ``seg_head`` grafted (matting-neutral). ``callback(i, metrics)``
    receives host floats; without one, every ``log_every``-th step
    prints a line. ``mesh`` and ``device`` as in ``make_train_step``; the
    state comes back on the device.
    """
    from vidmat_torch.models.weights import graft_seg_params, init_params

    dev, _ = _step_device(device, mesh)
    seg_on = seg_data_iter is not None and seg_every > 0
    optimizer = make_optimizer(lr)
    variables = (variables if variables is not None
                 else init_params(cfg, with_seg=seg_on))
    if seg_on and "seg_head" not in variables["params"]:
        variables = graft_seg_params(variables, cfg)
    variables = to_device(variables, dev)
    state = TrainState(variables=variables,
                       opt_state=optimizer.init(variables["params"]))
    step_fn = make_train_step(cfg, optimizer, mesh=mesh, device=dev)
    seg_fn = (make_seg_train_step(cfg, optimizer, mesh=mesh, device=dev)
              if seg_on else None)

    for i in range(num_steps):
        if seg_on and i % seg_every == seg_every - 1:
            clips, gt_mask = next(seg_data_iter)
            state, metrics = seg_fn(state, clips, gt_mask)
        else:
            clips, gt_alpha, gt_fgr = next(data_iter)
            state, metrics = step_fn(state, clips, gt_alpha, gt_fgr)
        if callback is not None:
            callback(i, {k: float(v) for k, v in metrics.items()})
        elif i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            extra = (f"seg_bce={m['seg_bce']:.4f}" if "seg_bce" in m
                     else f"alpha={m['alpha']:.4f}")
            print(f"step {i}: loss={m['loss']:.4f} {extra}", flush=True)
    return state
