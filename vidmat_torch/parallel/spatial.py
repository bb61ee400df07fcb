"""The matting network sharded over the positions of a mesh: the batch
over 'data', the width over 'spatial' (counterpart of GSPMD's
partitioning of the JAX package's sharded programs,
vidmat/train/loop.py:104-121 and tests/unit/test_spatial_sharding.py).

The positions run in lock step, layer by layer: each value of the
network is a grid of slabs, one a position (the data groups this process
holds a position of, by the 'spatial' positions; None at another
process's position), and a layer runs on every slab before the next
layer starts. At every level of the network each 'spatial' position
holds an even split of that level's width (``Layout.bounds``: columns
``[i * w // S, (i + 1) * w // S)``). A position reads the columns it
needs from the slabs that hold them (``_read``):

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

A layer's reads are one autograd node (``_Window``): the pieces of this
process's slabs are device copies, and where a data group's positions
lie in several processes (a job of one process a card) the pieces of
other processes' slabs come through one all-gather of the margins, the
backward sending their gradients back. The groups' sums go through an
all-reduce over the job, the outputs' gather through ``_Join``; in one
process neither communicates, and the result is deterministic.
Positions run on the
caller's stream of their device (a cross-device ``.to`` orders itself
against both devices' current streams); overlapping the positions'
work is not done yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
    replicas would repeat.

    A process may hold any of the positions, and a data group's 'spatial'
    positions may lie in several processes (e.g. a job of one process a
    card). ``pids``: the process of each position, D by S;
    ``rows``: the data groups this process holds a position of, in
    order; ``devices``: those groups' positions, rows by S, this
    process's devices and None at other processes' positions;
    ``device``: the first of this process's devices, where the gathered
    outputs, the loss and the parameters live."""

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
        self.rank = mesh.process_index
        self.pids = np.asarray(pids, int)
        mine = self.pids == self.rank
        self.rows = [int(g) for g in np.flatnonzero(mine.any(axis=1))]
        if not self.rows:
            raise ValueError(
                f"process {self.rank} holds no position of the sharded "
                f"step (index 0 of the mesh's other axes; mesh "
                f"{dict(mesh.shape)})")
        self.devices = [[devs[g, i] if mine[g, i] else None
                         for i in range(self.s)] for g in self.rows]
        self.device = next(d for d in self.devices[0] if d is not None)

    def local_keys(self) -> List[Tuple[int, int]]:
        """(data group, 'spatial' index) of this process's positions, in
        grid order (groups, then positions)."""
        return [(g, i) for g, drow in zip(self.rows, self.devices)
                for i, dev in enumerate(drow) if dev is not None]

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
        """This process's slabs of x: x holds the whole rows (every
        column) of the data groups in ``rows``, in order; each group's
        rows are split by ``bounds`` along ``w_axis`` and this process's
        positions keep theirs, on their devices (None at other
        processes' positions)."""
        k = len(self.rows)
        if x.shape[n_axis] % k:
            raise ValueError(
                f"the batch's {x.shape[n_axis] * self.d // k} rows do not "
                f"split evenly over the 'data' size {self.d}")
        per = x.shape[n_axis] // k
        return [[None if dev is None
                 else x.narrow(n_axis, r * per, per).narrow(
                     w_axis, bounds[i], bounds[i + 1] - bounds[i]).to(dev)
                 for i, dev in enumerate(drow)]
                for r, drow in enumerate(self.devices)]

    def join(self, grid: Grid, n_axis: int, w_axis: int,
             bounds: List[int]) -> torch.Tensor:
        """The whole tensor of a grid on ``device``: the slabs of each
        data group along ``w_axis`` (split at ``bounds``), the groups
        along ``n_axis``. Every process gets it all."""
        local = [t for row in grid for t in row if t is not None]
        return _Join.apply(self, n_axis, w_axis, tuple(bounds), *local)

    def whole(self, x: torch.Tensor, n_axis: int,
              w_axis: int) -> torch.Tensor:
        """Every data group's rows of x (the whole batch, on ``device``)
        from this process's (``split``'s contract): x itself in a job of
        one process."""
        if self.nproc == 1:
            return x
        b = self.bounds(x.shape[w_axis])
        return self.join(self.split(x, n_axis, w_axis, b), n_axis, w_axis,
                         b)

    def zero_state(self, cfg, n: int, h: int, w: int,
                   dtype=torch.float32) -> List[List[RecurrentState]]:
        """Each position's slab of the zero recurrent state of an (n, h,
        w) stream (``init_state``, split as the network's levels)."""
        d, s = cfg.dec_channels, cfg.space_to_depth

        def z(div, c, i, dev):
            b = self.bounds(w // (div * s))
            return torch.zeros((n, h // (div * s), b[i + 1] - b[i], c),
                               dtype=dtype, device=dev)

        return [[None if dev is None else
                 RecurrentState(z(8, d[0] // 2, i, dev),
                                z(4, d[1] // 2, i, dev),
                                z(2, d[2] // 2, i, dev))
                 for i, dev in enumerate(drow)] for drow in self.devices]


class _Join(torch.autograd.Function):
    """``Layout.join``: this process's slabs packed into one buffer,
    every process's gathered (``all_gather_flat``; in one process its
    own), the whole tensor assembled from them. The loss is replicated,
    so every process holds the whole gradient of the result: the backward
    returns this process's slabs' parts of it."""

    @staticmethod
    def forward(ctx, lay, n_axis, w_axis, bounds, *local):
        t0 = local[0]
        col = t0.numel() // t0.shape[w_axis]
        widths = [bounds[i + 1] - bounds[i] for i in range(lay.s)]
        sizes = [0] * lay.nproc
        for g in range(lay.d):
            for i in range(lay.s):
                sizes[lay.pids[g, i]] += col * widths[i]
        bufs = collectives.all_gather_flat(torch.cat(
            [t.to(lay.device).reshape(-1) for t in local]), sizes)
        at = [0] * lay.nproc
        rows = []
        for g in range(lay.d):
            row = []
            for i in range(lay.s):
                p, n = lay.pids[g, i], col * widths[i]
                shape = list(t0.shape)
                shape[w_axis] = widths[i]
                row.append(bufs[p][at[p]:at[p] + n].view(shape))
                at[p] += n
            rows.append(torch.cat(row, w_axis))
        ctx.lay, ctx.n_axis, ctx.w_axis, ctx.bounds = (lay, n_axis, w_axis,
                                                       bounds)
        ctx.per = t0.shape[n_axis]
        ctx.devices = [t.device for t in local]
        return torch.cat(rows, n_axis)

    @staticmethod
    def backward(ctx, grad):
        b, per = ctx.bounds, ctx.per
        grads = [grad.narrow(ctx.n_axis, g * per, per).narrow(
                     ctx.w_axis, b[i], b[i + 1] - b[i]).to(dev)
                 for (g, i), dev in zip(ctx.lay.local_keys(), ctx.devices)]
        return (None, None, None, None, *grads)


def _each(fn, *grids) -> Grid:
    return [[None if slabs[0] is None else fn(*slabs)
             for slabs in zip(*rows)] for rows in zip(*grids)]


def _overlaps(bounds, lo: int, hi: int):
    """(j, a, b): the columns [a, b) of [lo, hi) that position j holds."""
    for j in range(len(bounds) - 1):
        a, b = max(lo, bounds[j]), min(hi, bounds[j + 1])
        if a < b:
            yield j, a, b


class _Window(torch.autograd.Function):
    """The columns ``needs[i]`` of a level, for each of this process's
    positions i: the pieces of this process's slabs copied, those of
    other processes' slabs sent through one ``all_gather_flat`` of every
    process's outgoing pieces (margins of a few columns). The backward
    sends the gradients of the received pieces back the same way, and
    each owner adds them to its slabs' gradients. The node returns every
    local window, so its backward runs on every process, and every
    process enters both in the same layer order (the lock step; one
    device thread a process runs its backward in the reverse of that
    order)."""

    @staticmethod
    def forward(ctx, lay, bounds, needs, *local):
        keys = lay.local_keys()
        slabs = dict(zip(keys, local))
        t0 = local[0]
        head, col = tuple(t0.shape[:-1]), t0.numel() // t0.shape[-1]
        pids, me = lay.pids, lay.rank
        plan = [(g, i, j, a, b) for g in range(lay.d) for i in range(lay.s)
                for j, a, b in _overlaps(bounds, *needs[i])
                if pids[g, i] != pids[g, j]]
        sizes = [0] * lay.nproc
        for g, i, j, a, b in plan:
            sizes[pids[g, j]] += col * (b - a)
        out_pieces = [slabs[g, j][..., a - bounds[j]:b - bounds[j]].to(
            lay.device).reshape(-1) for g, i, j, a, b in plan
            if pids[g, j] == me]
        bufs = collectives.all_gather_flat(
            torch.cat(out_pieces) if out_pieces
            else t0.new_zeros(0, device=lay.device), sizes)
        remote, at = {}, [0] * lay.nproc
        for g, i, j, a, b in plan:
            p, n = pids[g, j], col * (b - a)
            if pids[g, i] == me:
                remote[g, i, j] = bufs[p][at[p]:at[p] + n].view(*head, b - a)
            at[p] += n
        wins = []
        for (g, i), t in zip(keys, local):
            wins.append(torch.cat([
                (slabs[g, j][..., a - bounds[j]:b - bounds[j]]
                 if pids[g, j] == me else remote[g, i, j]).to(t.device)
                for j, a, b in _overlaps(bounds, *needs[i])], dim=-1))
        ctx.lay, ctx.bounds, ctx.needs, ctx.plan = lay, bounds, needs, plan
        ctx.head, ctx.col = head, col
        ctx.meta = [(t.device, t.dtype) for t in local]
        return tuple(wins)

    @staticmethod
    def backward(ctx, *grads):
        lay, bounds, needs, head = ctx.lay, ctx.bounds, ctx.needs, ctx.head
        pids, me = lay.pids, lay.rank
        keys = lay.local_keys()
        meta = dict(zip(keys, ctx.meta))
        out = {}

        def add(g, j, a, b, piece):
            if (g, j) not in out:
                dev, dtype = meta[g, j]
                out[g, j] = torch.zeros(
                    (*head, bounds[j + 1] - bounds[j]), dtype=dtype,
                    device=dev)
            out[g, j][..., a - bounds[j]:b - bounds[j]] += piece.to(
                out[g, j].device)

        back = {}
        for (g, i), gw in zip(keys, grads):
            at = 0
            for j, a, b in _overlaps(bounds, *needs[i]):
                piece = gw[..., at:at + b - a]
                at += b - a
                if pids[g, j] == me:
                    add(g, j, a, b, piece)
                else:
                    back[g, i, j] = piece
        sizes = [0] * lay.nproc
        for g, i, j, a, b in ctx.plan:
            sizes[pids[g, i]] += ctx.col * (b - a)
        sent = [back[g, i, j].to(lay.device).reshape(-1)
                for g, i, j, a, b in ctx.plan if pids[g, i] == me]
        dev0, dtype0 = ctx.meta[0]
        bufs = collectives.all_gather_flat(
            torch.cat(sent) if sent
            else torch.zeros(0, dtype=dtype0, device=lay.device), sizes)
        at = [0] * lay.nproc
        for g, i, j, a, b in ctx.plan:
            p, n = pids[g, i], ctx.col * (b - a)
            if pids[g, j] == me:
                add(g, j, a, b, bufs[p][at[p]:at[p] + n].view(*head, b - a))
            at[p] += n
        return (None, None, None, *(out.get(k) for k in keys))


def _read(lay: Layout, grid: Grid, bounds, needs) -> Grid:
    """Each of this process's positions' columns [lo, hi) = needs[i] of a
    width-sharded level, on its device (``_Window``)."""
    local = [t for row in grid for t in row if t is not None]
    wins = iter(_Window.apply(lay, tuple(bounds), tuple(needs), *local))
    return [[None if dev is None else next(wins) for dev in drow]
            for drow in lay.devices]


def _conv(conv, grid: Grid, b_in, b_out, lay: Layout) -> Grid:
    """``Conv`` (k x k, its stride, padding k // 2): each position reads
    its window, zeros outside the frame."""
    k, st, p = conv.weight.shape[-1], conv.stride, conv.padding
    w_in = b_in[-1]
    spans = [(b_out[i] * st - p, (b_out[i + 1] - 1) * st - p + k)
             for i in range(lay.s)]
    wins = _read(lay, grid, b_in, [(max(lo, 0), min(hi, w_in))
                                   for lo, hi in spans])

    def one(x, i):
        lo, hi = spans[i]
        if lo < 0 or hi > w_in:
            x = F.pad(x, (max(0, -lo), max(0, hi - w_in)))
        bias = None if conv.bias is None else conv.bias.to(x.device,
                                                           x.dtype)
        return F.conv2d(x, conv.weight.to(x.device, x.dtype), bias, st,
                        (p, 0))

    return [[None if x is None else one(x, i) for i, x in enumerate(row)]
            for row in wins]


def _upsample(grid: Grid, b_in, b_out, lay: Layout) -> Grid:
    """``upsample2x``: each position reads one column of margin beyond
    what it samples (none past the frame's edges, where the unsharded
    resize clamps) and keeps its own columns."""
    w_in = b_in[-1]
    needs = [(max(0, b_out[i] // 2 - 1), min(w_in, (b_out[i + 1] - 1) // 2
                                              + 2)) for i in range(lay.s)]
    wins = _read(lay, grid, b_in, needs)
    return [[None if x is None else upsample2x(x)[
                ..., b_out[i] - 2 * needs[i][0]:b_out[i + 1] - 2 * needs[i][0]]
             for i, x in enumerate(row)] for row in wins]


def _bn(bn, grid: Grid, lay: Layout) -> Grid:
    """BatchNorm; in training with the statistics of every position's
    slab (float64 moments and count summed over the job: each slab lives
    in one process and counts once)."""
    if not bn.bn_train:
        return _each(lambda x: bn.normalize(x, bn.running_mean,
                                            bn.running_var), grid)
    local = [x for row in grid for x in row if x is not None]
    c = local[0].shape[1]
    parts = [torch.cat([batch_moments(x).reshape(-1),
                        x.new_full((1,), x.numel() // c,
                                   dtype=torch.float64)])
             for x in local]
    total = collectives.psum(parts, lay.device)
    mean, var = bn.batch_stats(total[:-1].view(2, c), total[-1])
    return _each(lambda x: bn.normalize(x, mean, var), grid)


def _cba(m, grid: Grid, b_in, b_out, lay: Layout) -> Grid:
    """``ConvBNAct``."""
    x = _conv(m.conv, grid, b_in, b_out, lay)
    if m.bn is not None:
        x = _bn(m.bn, x, lay)
    return _each(F.relu, x) if m.act else x


def _gate(g, grid: Grid, b, lay: Layout) -> Grid:
    """``BottleneckGate``: the projection, gated by the sigmoid of a 1x1
    conv of each sample's mean over H and the whole width: the sum over
    each data group's 'spatial' positions, every group's partial sums in
    one sum over the job (zeros at the groups a process does not
    hold)."""
    a = _cba(g.proj, grid, b, b, lay)
    sums = [sum(x.sum(dim=(2, 3), keepdim=True).to(lay.device)
                for x in row if x is not None) for row in grid]
    parts = [torch.zeros_like(sums[0])] * lay.d
    for r, t in zip(lay.rows, sums):
        parts[r] = t
    total = collectives.psum([torch.stack(parts)], lay.device)
    h = next(x for x in grid[0] if x is not None).shape[2]
    out = []
    for r, arow in zip(lay.rows, a):
        mean = total[r] / (h * b[-1])
        bias = None if g.gate.bias is None else g.gate.bias.to(lay.device,
                                                               mean.dtype)
        gate = torch.sigmoid(F.conv2d(
            mean, g.gate.weight.to(lay.device, mean.dtype), bias))
        out.append([None if x is None else x * gate.to(x.device)
                    for x in arow])
    return out


def _gru(cell, x: Grid, h: Grid, b, lay: Layout) -> Grid:
    """``ConvGRUCell``."""
    f = cell.features
    h = _each(lambda h, x: h.to(x.dtype), h, x)
    rz = _each(torch.sigmoid, _conv(
        cell.gates, _each(lambda x, h: torch.cat([x, h], dim=1), x, h), b,
        b, lay))
    r = _each(lambda t: t[:, :f], rz)
    z = _each(lambda t: t[:, f:], rz)
    c = _each(torch.tanh, _conv(
        cell.cand, _each(lambda x, r, h: torch.cat([x, r * h], dim=1),
                         x, r, h), b, b, lay))
    return _each(lambda z, h, c: (1.0 - z) * h + z * c, z, h, c)


def _stage(st, x: Grid, skip: Grid, h: Optional[Grid], b_lo, b_hi,
           lay: Layout):
    """``DecoderStage``."""
    up = _upsample(x, b_lo, b_hi, lay)
    x = _cba(st.conv, _each(lambda u, s: torch.cat([u, s], dim=1), up,
                            skip), b_hi, b_hi, lay)
    if not st.recurrent:
        return x, None
    half = st.features // 2
    a = _each(lambda t: t[:, :half], x)
    g = _each(lambda t: t[:, half:], x)
    if h is None:
        h = _each(torch.zeros_like, g)
    h_new = _gru(st.gru, g, h, b_hi, lay)
    return _each(lambda a, h: torch.cat([a, h], dim=1), a, h_new), h_new


def sharded_forward(net, lay: Layout, frames: Grid, width: int,
                    states=None, seg_pass: bool = False):
    """``MattingNetwork.forward`` over a grid of slabs.

    frames: this process's (n, H, w_i, C) NHWC slabs (``Layout.split``
    at ``frame_bounds``) of frames ``width`` wide; states: a grid of
    ``RecurrentState`` slabs or None. Returns grids of alpha and fgr (or
    the seg logits and None) slabs and of the new state's slabs, as the
    unsharded forward returns the whole tensors."""
    cfg = net.cfg
    s = cfg.space_to_depth
    widths = [width // (s << lv) for lv in range(5)]
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
    up = _upsample(y, b[1], b[0], lay)
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
        seg = _conv(net.seg_head, y, b[0], b[0], lay)
        if s > 1:
            seg = _each(lambda t: depth_to_space(t, s), seg)
        return (_each(lambda t: t.float().permute(0, 2, 3, 1), seg), None,
                new_state)
    out = _conv(net.head, y, b[0], b[0], lay)
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

    def forward(self, frames: Grid, width: int, states=None,
                seg_pass: bool = False):
        return sharded_forward(self.net, self.lay, frames, width, states,
                               seg_pass)


def apply_sharded(net, mesh, frame: torch.Tensor,
                  state: Optional[RecurrentState] = None,
                  seg_pass: bool = False):
    """``net(frame, state)`` (a ``MattingNetwork``) sharded over ``mesh``:
    the frames' batch over 'data', their width over 'spatial' (the
    counterpart of ``jax.jit(net.apply, in_shardings=...)``). Takes and
    returns whole NHWC tensors, on this process's first position: in,
    the whole rows of the data groups this process holds a position of
    (``Layout.split``; in one process, the batch); out, every group's."""
    lay = Layout(mesh)
    s = net.cfg.space_to_depth
    w = frame.shape[2]
    fb = lay.frame_bounds(w, s)
    frames = lay.split(frame, 0, 2, fb)
    level = {div: lay.bounds(w // (div * s)) for div in (8, 4, 2)}
    states = None
    if state is not None:
        parts = [lay.split(t, 0, 2, level[div])
                 for t, div in zip(state, (8, 4, 2))]
        states = _each(lambda *t: RecurrentState(*t), *parts)
    alpha, fgr, new = sharded_forward(net, lay, frames, w, states, seg_pass)
    new_state = (None if new is None else RecurrentState(
        *(lay.join(_each(lambda st: st[k], new), 0, 2, level[div])
          for k, div in enumerate((8, 4, 2)))))
    return (lay.join(alpha, 0, 2, fb),
            None if fgr is None else lay.join(fgr, 0, 2, fb), new_state)
