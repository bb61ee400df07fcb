"""The matting network sharded over the positions of a mesh: the batch
over 'data', the width over 'spatial' (counterpart of GSPMD's
partitioning of the JAX package's sharded programs,
vidmat/train/loop.py:104-121 and tests/unit/test_spatial_sharding.py).

The positions run in lock step, layer by layer: each value of the
network is a grid of slabs, one a position (this process's data groups
by the 'spatial' positions), and a layer runs on every slab before the
next layer starts. At every level of the network each 'spatial' position
holds an even split of that level's width (``Layout.bounds``: columns
``[i * w // S, (i + 1) * w // S)``). A position reads the columns it
needs from the slabs that hold them (``_cols``):

- a convolution (``Conv``: the stride-2 encoder convolutions, the GRU's
  gates and candidate, the heads) reads its window and pads zeros outside
  the frame, as the unsharded convolution does;
- ``upsample2x`` (half-pixel bilinear) reads a margin of one column and
  clamps at the frame's edges only, so every column it keeps is computed
  from the same inputs with the same weights as the unsharded one;
- ``space_to_depth``, ``depth_to_space``, 1x1 convolutions and the
  elementwise ops stay local;
- BatchNorm in training sums its float64 moments and count over every
  position of the job (``collectives.psum``) and reports the statistics
  once; ``BottleneckGate``'s mean over H and W sums over the 'spatial'
  positions of each data group.

In one process the reads and sums are device copies and tensor ops that
autograd follows, and the result is deterministic. Positions run on the
caller's stream of their device (a cross-device ``.to`` orders itself
against both devices' current streams); overlapping the positions'
work is not done yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vidmat_torch.models.layers import batch_moments
from vidmat_torch.models.matting_net import (RecurrentState, depth_to_space,
                                             space_to_depth)
from vidmat_torch.ops.resize import upsample2x
from vidmat_torch.parallel import collectives

Grid = List[List[torch.Tensor]]


class Layout:
    """The positions of a mesh that a sharded forward works on: D data
    groups by S 'spatial' positions.

    The batch axis is 'data', else the mesh's first axis unless that is
    'spatial' (a ('spatial',) mesh shards the width only; the JAX
    package's spec would name 'spatial' twice, which it rejects); the
    width axis is 'spatial' where the mesh has it. Axes of other names
    replicate: the step runs on their index 0, whose result the other
    replicas would repeat. ``rows``: this process's data groups (a
    contiguous block, as many in every process; each group's 'spatial'
    positions in one process); ``devices``: their positions' devices,
    rows by S; ``device``: the first of them, where the gathered outputs,
    the loss and the parameters live."""

    def __init__(self, mesh):
        axes = mesh.axis_names
        data_ax = ("data" if "data" in axes
                   else axes[0] if axes[0] != "spatial" else None)
        sp_ax = "spatial" if "spatial" in axes else None
        index = tuple(slice(None) if a in (data_ax, sp_ax) else 0
                      for a in axes)
        devs, pids = mesh.devices[index], mesh.process_ids[index]
        kept = [a for a in axes if a in (data_ax, sp_ax)]
        if data_ax is None:
            devs, pids = devs[None], pids[None]
        elif sp_ax is None:
            devs, pids = devs[:, None], pids[:, None]
        elif kept[0] != data_ax:
            devs, pids = devs.T, pids.T
        self.d, self.s = devs.shape
        self.nproc = mesh.process_count
        if any(len(set(row)) > 1 for row in pids.tolist()):
            raise ValueError(
                "each 'spatial' group must lie in one process: halos across "
                f"processes are not ported (mesh {dict(mesh.shape)})")
        owner = pids[:, 0]
        counts = np.bincount(owner, minlength=self.nproc)
        if np.any(np.diff(owner) < 0) or len(set(counts.tolist())) > 1:
            raise ValueError(
                "every process must hold an equal, contiguous block of the "
                f"data groups; their processes are {owner.tolist()}")
        self.rows = [int(r) for r in np.flatnonzero(
            owner == mesh.process_index)]
        self.devices = [list(devs[r]) for r in self.rows]
        self.device = self.devices[0][0]

    def bounds(self, w: int) -> List[int]:
        """The columns of a level of width w that each 'spatial' position
        holds: position i holds [bounds[i], bounds[i + 1])."""
        return [i * w // self.s for i in range(self.s + 1)]

    def frame_bounds(self, w: int, s2d: int) -> List[int]:
        """The frame's columns of each position: those of the
        space-to-depth level (width w / s2d) times s2d, so that
        ``space_to_depth`` stays local. Raises ValueError where the
        width does not shard."""
        if w % self.s:
            raise ValueError(
                f"the width {w} must be divisible by the 'spatial' size "
                f"{self.s} (as JAX shards it)")
        if w // (16 * s2d) < self.s:
            raise ValueError(
                f"the width {w} gives {w // (16 * s2d)} columns at stride "
                f"16 (W / (16 * s2d), s2d={s2d}); each of the {self.s} "
                "'spatial' positions needs at least one")
        return [s2d * b for b in self.bounds(w // s2d)]

    def split(self, x: torch.Tensor, n_axis: int, w_axis: int,
              bounds: List[int]) -> Grid:
        """This process's rows of x split into its data groups along
        ``n_axis`` and by ``bounds`` along ``w_axis``, each slab on its
        position's device."""
        k = len(self.rows)
        if x.shape[n_axis] % k:
            raise ValueError(
                f"the batch's {x.shape[n_axis] * self.nproc} rows do not "
                f"split evenly over the 'data' size {self.d}")
        per = x.shape[n_axis] // k
        return [[x.narrow(n_axis, r * per, per).narrow(
                    w_axis, bounds[i], bounds[i + 1] - bounds[i]).to(dev)
                 for i, dev in enumerate(drow)]
                for r, drow in enumerate(self.devices)]

    def join(self, grid: Grid, n_axis: int, w_axis: int) -> torch.Tensor:
        """The whole tensor of a grid on ``device``: the slabs of each
        data group along ``w_axis``, the groups along ``n_axis``, then the
        processes' rows (every process gets it all)."""
        rows = [row[0].to(self.device) if len(row) == 1
                else torch.cat([t.to(self.device) for t in row], w_axis)
                for row in grid]
        return collectives.gather(rows, n_axis, self.device)

    def zero_state(self, cfg, n: int, h: int, w: int,
                   dtype=torch.float32) -> List[List[RecurrentState]]:
        """Each position's slab of the zero recurrent state of an (n, h,
        w) stream (``init_state``, split as the network's levels)."""
        d, s = cfg.dec_channels, cfg.space_to_depth

        def z(div, c, i, dev):
            b = self.bounds(w // (div * s))
            return torch.zeros((n, h // (div * s), b[i + 1] - b[i], c),
                               dtype=dtype, device=dev)

        return [[RecurrentState(z(8, d[0] // 2, i, dev),
                                z(4, d[1] // 2, i, dev),
                                z(2, d[2] // 2, i, dev))
                 for i, dev in enumerate(drow)] for drow in self.devices]


def _each(fn, *grids) -> Grid:
    return [[fn(*slabs) for slabs in zip(*rows)] for rows in zip(*grids)]


def _cols(row, bounds, lo: int, hi: int, dev) -> torch.Tensor:
    """Columns [lo, hi) (within the level) of a width-sharded row of
    slabs, on ``dev``: the pieces of the slabs that hold them, in
    order."""
    pieces = []
    for j, t in enumerate(row):
        a, b = max(lo, bounds[j]), min(hi, bounds[j + 1])
        if a < b:
            pieces.append(t[..., a - bounds[j]:b - bounds[j]].to(dev))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=3)


def _conv(conv, grid: Grid, b_in, b_out, devs) -> Grid:
    """``Conv`` (k x k, its stride, padding k // 2): each position reads
    its window, zeros outside the frame."""
    k, st, p = conv.weight.shape[-1], conv.stride, conv.padding
    w_in = b_in[-1]
    out = []
    for row, drow in zip(grid, devs):
        r = []
        for i, dev in enumerate(drow):
            lo, hi = b_out[i] * st - p, (b_out[i + 1] - 1) * st - p + k
            x = _cols(row, b_in, max(lo, 0), min(hi, w_in), dev)
            if lo < 0 or hi > w_in:
                x = F.pad(x, (max(0, -lo), max(0, hi - w_in)))
            bias = (None if conv.bias is None
                    else conv.bias.to(dev, x.dtype))
            r.append(F.conv2d(x, conv.weight.to(dev, x.dtype), bias, st,
                              (p, 0)))
        out.append(r)
    return out


def _upsample(grid: Grid, b_in, b_out, devs) -> Grid:
    """``upsample2x``: each position reads one column of margin beyond
    what it samples (none past the frame's edges, where the unsharded
    resize clamps) and keeps its own columns."""
    w_in = b_in[-1]
    out = []
    for row, drow in zip(grid, devs):
        r = []
        for i, dev in enumerate(drow):
            a, b = b_out[i], b_out[i + 1]
            lo, hi = max(0, a // 2 - 1), min(w_in, (b - 1) // 2 + 2)
            r.append(upsample2x(_cols(row, b_in, lo, hi, dev))[
                ..., a - 2 * lo:b - 2 * lo])
        out.append(r)
    return out


def _bn(bn, grid: Grid, lay: Layout) -> Grid:
    """BatchNorm; in training with the statistics of every position's
    slab (float64 moments and count summed over the job)."""
    if not bn.bn_train:
        return _each(lambda x: bn.normalize(x, bn.running_mean,
                                            bn.running_var), grid)
    c = grid[0][0].shape[1]
    parts = [torch.cat([batch_moments(x).reshape(-1),
                        x.new_full((1,), x.numel() // c,
                                   dtype=torch.float64)])
             for row in grid for x in row]
    total = collectives.psum(parts, lay.device)
    mean, var = bn.batch_stats(total[:-1].view(2, c), total[-1])
    return _each(lambda x: bn.normalize(x, mean, var), grid)


def _cba(m, grid: Grid, b_in, b_out, lay: Layout) -> Grid:
    """``ConvBNAct``."""
    x = _conv(m.conv, grid, b_in, b_out, lay.devices)
    if m.bn is not None:
        x = _bn(m.bn, x, lay)
    return _each(F.relu, x) if m.act else x


def _gate(g, grid: Grid, b, lay: Layout) -> Grid:
    """``BottleneckGate``: the projection, gated by the sigmoid of a 1x1
    conv of each sample's mean over H and the whole width."""
    a = _cba(g.proj, grid, b, b, lay)
    out = []
    for row, arow, drow in zip(grid, a, lay.devices):
        dev = drow[0]
        total = sum(x.sum(dim=(2, 3), keepdim=True).to(dev) for x in row)
        mean = total / (row[0].shape[2] * b[-1])
        bias = None if g.gate.bias is None else g.gate.bias.to(dev,
                                                               mean.dtype)
        gate = torch.sigmoid(F.conv2d(mean, g.gate.weight.to(dev,
                                                             mean.dtype),
                                      bias))
        out.append([x * gate.to(x.device) for x in arow])
    return out


def _gru(cell, x: Grid, h: Grid, b, devs) -> Grid:
    """``ConvGRUCell``."""
    f = cell.features
    h = _each(lambda h, x: h.to(x.dtype), h, x)
    rz = _each(torch.sigmoid, _conv(
        cell.gates, _each(lambda x, h: torch.cat([x, h], dim=1), x, h), b,
        b, devs))
    r = _each(lambda t: t[:, :f], rz)
    z = _each(lambda t: t[:, f:], rz)
    c = _each(torch.tanh, _conv(
        cell.cand, _each(lambda x, r, h: torch.cat([x, r * h], dim=1),
                         x, r, h), b, b, devs))
    return _each(lambda z, h, c: (1.0 - z) * h + z * c, z, h, c)


def _stage(st, x: Grid, skip: Grid, h: Optional[Grid], b_lo, b_hi,
           lay: Layout):
    """``DecoderStage``."""
    up = _upsample(x, b_lo, b_hi, lay.devices)
    x = _cba(st.conv, _each(lambda u, s: torch.cat([u, s], dim=1), up,
                            skip), b_hi, b_hi, lay)
    if not st.recurrent:
        return x, None
    half = st.features // 2
    a = _each(lambda t: t[:, :half], x)
    g = _each(lambda t: t[:, half:], x)
    if h is None:
        h = _each(torch.zeros_like, g)
    h_new = _gru(st.gru, g, h, b_hi, lay.devices)
    return _each(lambda a, h: torch.cat([a, h], dim=1), a, h_new), h_new


def sharded_forward(net, lay: Layout, frames: Grid, states=None,
                    seg_pass: bool = False):
    """``MattingNetwork.forward`` over a grid of slabs.

    frames: this process's (n, H, w_i, C) NHWC slabs (``Layout.split``
    at ``frame_bounds``); states: a grid of ``RecurrentState`` slabs or
    None. Returns grids of alpha and fgr (or the seg logits and None)
    slabs and of the new state's slabs, as the unsharded forward returns
    the whole tensors."""
    cfg = net.cfg
    s = cfg.space_to_depth
    widths = [sum(t.shape[2] for t in frames[0]) // (s << lv)
              for lv in range(5)]
    b = [lay.bounds(w) for w in widths]
    x = _each(lambda f: f.permute(0, 3, 1, 2), frames)
    rgb = _each(lambda t: t[:, :3], x)
    if net.dtype is not None:
        x = _each(lambda t: t.to(net.dtype), x)
    x_in = _each(lambda t: space_to_depth(t, s), x) if s > 1 else x

    enc = net.encoder
    f1 = _cba(enc.stem, x_in, b[0], b[1], lay)
    f2 = _cba(enc.s2b, _cba(enc.s2a, f1, b[1], b[2], lay), b[2], b[2], lay)
    f3 = _cba(enc.s3b, _cba(enc.s3a, f2, b[2], b[3], lay), b[3], b[3], lay)
    f4 = _cba(enc.s4b, _cba(enc.s4a, f3, b[3], b[4], lay), b[4], b[4], lay)
    b4 = _gate(net.bottleneck, f4, b[4], lay)

    h3 = h2 = h1 = None
    if states is not None:
        h3, h2, h1 = (_each(lambda st: st[k].permute(0, 3, 1, 2), states)
                      for k in range(3))
    y, n3 = _stage(net.d3, b4, f3, h3, b[4], b[3], lay)
    y, n2 = _stage(net.d2, y, f2, h2, b[3], b[2], lay)
    y, n1 = _stage(net.d1, y, f1, h1, b[2], b[1], lay)

    cond = x_in if s > 1 else rgb
    up = _upsample(y, b[1], b[0], lay.devices)
    y = _cba(net.d0, _each(lambda u, c: torch.cat([u, c.to(u.dtype)], dim=1),
                           up, cond), b[0], b[0], lay)

    new_state = states
    if cfg.recurrent:
        new_state = _each(lambda *t: RecurrentState(
            *(v.permute(0, 2, 3, 1) for v in t)), n3, n2, n1)
    if seg_pass:
        if net.seg_head is None:
            raise ValueError("the segmentation pass needs a co-trained "
                             "network (a seg_head in its variables)")
        seg = _conv(net.seg_head, y, b[0], b[0], lay.devices)
        if s > 1:
            seg = _each(lambda t: depth_to_space(t, s), seg)
        return (_each(lambda t: t.float().permute(0, 2, 3, 1), seg), None,
                new_state)
    out = _conv(net.head, y, b[0], b[0], lay.devices)
    if s > 1:
        out = _each(lambda t: depth_to_space(t, s), out)
    pairs = _each(lambda o, x, c: net.alpha_fgr(o.float(), x, c), out, x,
                  rgb)
    return (_each(lambda p: p[0], pairs), _each(lambda p: p[1], pairs),
            new_state)


class ShardedNetwork(nn.Module):
    """A module whose forward is ``sharded_forward`` of ``net`` (its
    submodule): ``torch.func.functional_call`` runs it on a parameter
    tree named ``net.<name>``."""

    def __init__(self, net, lay: Layout):
        super().__init__()
        self.net = net
        self.lay = lay

    def forward(self, frames: Grid, states=None, seg_pass: bool = False):
        return sharded_forward(self.net, self.lay, frames, states, seg_pass)


def apply_sharded(net, mesh, frame: torch.Tensor,
                  state: Optional[RecurrentState] = None,
                  seg_pass: bool = False):
    """``net(frame, state)`` (a ``MattingNetwork``) sharded over ``mesh``:
    the frames' batch over 'data', their width over 'spatial' (the
    counterpart of ``jax.jit(net.apply, in_shardings=...)``). Takes and
    returns whole NHWC tensors (this process's rows in, every process's
    out), on the mesh's first position."""
    lay = Layout(mesh)
    s = net.cfg.space_to_depth
    w = frame.shape[2]
    frames = lay.split(frame, 0, 2, lay.frame_bounds(w, s))
    states = None
    if state is not None:
        parts = [lay.split(t, 0, 2, lay.bounds(w // (div * s)))
                 for t, div in zip(state, (8, 4, 2))]
        states = _each(lambda *t: RecurrentState(*t), *parts)
    alpha, fgr, new = sharded_forward(net, lay, frames, states, seg_pass)
    new_state = (None if new is None else RecurrentState(
        *(lay.join(_each(lambda st: st[k], new), 0, 2) for k in range(3))))
    return (lay.join(alpha, 0, 2),
            None if fgr is None else lay.join(fgr, 0, 2), new_state)
