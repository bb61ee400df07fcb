"""Tiled refinement with overlap blending (counterpart of
vidmat/refine/tiling.py).

Tiles become a batch dimension: ``tile_frame`` cuts an (N, H, W, C) frame
into (N * num_tiles, t, t, C), y outer, x inner, then the batch, as the
JAX package orders them; ``untile_frame`` blends them back with a
feathered weight whose sum-of-weights normalizer depends only on the
layout. The blend is the JAX package's static segment decomposition:
along each axis the frame splits into segments with a constant set of
covering tiles, each segment is the sum of its weighted tile slices in
cover order (x within a tile row, then the rows), and the result is
multiplied by the normalizer's reciprocal once.

The geometry is plain Python; the feather weight and the normalizer are
built with numpy on the host once per layout and kept on the device
(a host-to-device copy inside a captured CUDA graph is not allowed, so
the first eager call makes them).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from vidmat_torch._device import device_constant


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """Static tile grid for (h, w) with tile size ``tile`` and overlap
    ``overlap``. Tiles are placed at stride (tile - overlap); the last row
    and column are clamped to the frame (their overlap with the previous
    tile grows)."""

    h: int
    w: int
    tile: int
    overlap: int

    @property
    def tile_h(self) -> int:
        return min(self.tile, self.h)

    @property
    def tile_w(self) -> int:
        return min(self.tile, self.w)

    @property
    def ys(self) -> Tuple[int, ...]:
        return self._starts(self.h, self.tile_h)

    @property
    def xs(self) -> Tuple[int, ...]:
        return self._starts(self.w, self.tile_w)

    def _starts(self, size: int, tile: int) -> Tuple[int, ...]:
        if size <= tile:
            return (0,)
        starts = list(range(0, size - tile, tile - self.overlap))
        starts.append(size - tile)
        return tuple(starts)

    @property
    def num_tiles(self) -> int:
        return len(self.ys) * len(self.xs)


def _ramp(size: int, overlap: int) -> np.ndarray:
    ramp = np.ones(size, np.float32)
    if overlap > 0 and size > overlap * 2:
        e = np.linspace(1.0 / (overlap + 1), 1.0, overlap, dtype=np.float32)
        ramp[:overlap] = e
        ramp[-overlap:] = e[::-1]
    return ramp


def _feather_weight(tile_h: int, tile_w: int, overlap: int) -> np.ndarray:
    """2D feather mask (tile_h, tile_w): a linear ramp over the overlap
    band on each edge."""
    return _ramp(tile_h, overlap)[:, None] * _ramp(tile_w, overlap)[None, :]


def _inv_norm(layout: TileLayout) -> np.ndarray:
    """Reciprocal of the summed feather weights, (1, H, W, 1) float32."""
    th, tw = layout.tile_h, layout.tile_w
    weight = _feather_weight(th, tw, layout.overlap)
    norm = np.zeros((layout.h, layout.w), np.float32)
    for y in layout.ys:
        for x in layout.xs:
            norm[y:y + th, x:x + tw] += weight
    return (1.0 / norm)[None, :, :, None]


@device_constant
def _blend_tensors(layout: TileLayout, dtype: torch.dtype,
                   device: torch.device):
    """(weight (1, th, tw, 1), inv_norm (1, H, W, 1)) on the device."""
    w = _feather_weight(layout.tile_h, layout.tile_w, layout.overlap)
    return (torch.from_numpy(w[None, :, :, None]).to(device),
            torch.from_numpy(_inv_norm(layout)).to(device, dtype))


def _segments(starts: Tuple[int, ...], tsize: int, total: int):
    """[0, total) as maximal segments with a constant set of covering
    tiles: [(seg_start, seg_len, [(tile_idx, local_offset), ...])]."""
    cuts = sorted({0, total} | set(starts) | {s + tsize for s in starts})
    segs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        if a >= total or b <= 0:
            continue
        cover = [(i, a - s) for i, s in enumerate(starts)
                 if s <= a and b <= s + tsize]
        segs.append((a, b - a, cover))
    return segs


def tile_frame(frame: torch.Tensor, layout: TileLayout) -> torch.Tensor:
    """(N, H, W, C) -> (N * num_tiles, tile_h, tile_w, C)."""
    th, tw = layout.tile_h, layout.tile_w
    return torch.cat([frame[:, y:y + th, x:x + tw]
                      for y in layout.ys for x in layout.xs])


def untile_frame(tiles: torch.Tensor, layout: TileLayout,
                 n: int) -> torch.Tensor:
    """Inverse of ``tile_frame`` with the feathered overlap blend:
    (N * num_tiles, tile_h, tile_w, C) -> (N, H, W, C)."""
    th, tw = layout.tile_h, layout.tile_w
    nx = len(layout.xs)
    weight, inv_norm = _blend_tensors(layout, tiles.dtype, tiles.device)
    xsegs = _segments(layout.xs, tw, layout.w)
    ysegs = _segments(layout.ys, th, layout.h)

    def xstrip(iy: int) -> torch.Tensor:
        """Tile row iy composed along x: (n, th, W, C)."""
        parts = []
        for _, slen, cover in xsegs:
            acc = None
            for jx, off in cover:
                t = tiles[(iy * nx + jx) * n:(iy * nx + jx + 1) * n]
                part = (t[:, :, off:off + slen]
                        * weight[:, :, off:off + slen])
                acc = part if acc is None else acc + part
            parts.append(acc)
        return torch.cat(parts, dim=2)

    strips = [xstrip(iy) for iy in range(len(layout.ys))]
    rows = []
    for _, slen, cover in ysegs:
        acc = None
        for iy, off in cover:
            part = strips[iy][:, off:off + slen]
            acc = part if acc is None else acc + part
        rows.append(acc)
    return torch.cat(rows, dim=1) * inv_norm


def tiled_apply(fn, frame: torch.Tensor, tile: int,
                overlap: int) -> torch.Tensor:
    """A stateless per-tile function over a frame with overlap blending
    (vidmat/refine/tiling.py ``tiled_apply``): fn maps (B, tile, tile,
    Cin) to (B, tile, tile, Cout) and is applied to all the tiles of the
    (N, H, W, Cin) frame as one batch."""
    n, h, w, _ = frame.shape
    layout = TileLayout(h, w, tile, overlap)
    return untile_frame(fn(tile_frame(frame, layout)), layout, n)


def tiled_guided_upsample(frame: torch.Tensor, alpha_lr: torch.Tensor,
                          fgr_lr: torch.Tensor, tile: int, overlap: int,
                          radius: int = 4, eps: float = 1e-4,
                          kernels: bool = True):
    """Tiled full-resolution guided refinement with overlap blending: each
    full-resolution tile is refined against its own coarse crop, all
    tiles as one batch (``ops.guided_filter.guided_upsample``: the GF
    kernel wrapper, or its plain version with ``kernels=False``), then
    feather-blended.

    frame: (N, H, W, 3) float32 in [0, 1]; alpha_lr (N, H/pool, W/pool, 1)
    and fgr_lr (..., 3) at an integer pool; tile and overlap divisible by
    the pool. Returns (alpha (N, H, W, 1), fgr (N, H, W, 3)) float32."""
    from vidmat_torch.ops.guided_filter import guided_upsample

    n, h, w, _ = frame.shape
    _, hl, wl, _ = alpha_lr.shape
    pool = h // hl
    if h % hl or w % wl or tile % pool or overlap % pool:
        raise ValueError("tile/overlap must align with the coarse pool")
    layout = TileLayout(h, w, tile, overlap)
    lr_layout = TileLayout(hl, wl, tile // pool, overlap // pool)
    if (len(layout.ys) != len(lr_layout.ys)
            or len(layout.xs) != len(lr_layout.xs)):
        raise ValueError("tile grid mismatch between full and coarse res; "
                         "choose tile/overlap so both grids align")
    a_ref, f_ref = guided_upsample(
        tile_frame(frame, layout), tile_frame(alpha_lr, lr_layout),
        tile_frame(fgr_lr, lr_layout), radius, eps, kernels=kernels)
    return untile_frame(a_ref, layout, n), untile_frame(f_ref, layout, n)
