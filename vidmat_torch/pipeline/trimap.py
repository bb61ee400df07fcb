"""Trimaps: the canonical byte form of a user trimap and a marker for
pre-trimmed trimap streams (counterpart of vidmat/pipeline/trimap.py), the
keyframe test of a trimap source (``single_trimap``), and
trimaps from rough masks and from ground-truth alpha (counterpart of
``trimap_from_mask``, ``alpha_to_trimap`` and ``_box_dilate`` in
vidmat/train/data.py). numpy only (cv2 to read a keyframe file).

The byte convention: uint8 {0, 128, 255} == float {0, 0.5, 1} for
background / unknown / foreground."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vidmat_torch.io.reader import _IMG_EXTS, read_image


class PreTrimmedTrimaps:
    """A per-frame trimap iterable already trimmed to the run's
    [start_frame, start_frame + max_frames) window (the mask_source
    adapter trims the raw mask stream first): the pipeline does not trim
    it again, which would misalign frame i and trimap i."""

    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        return iter(self.frames)


def single_trimap(src) -> Optional[np.ndarray]:
    """A ``trimap_source`` naming one still (keyframe propagation): an
    array, or one image file (read with cv2); None for a per-frame stream
    (video path, image directory or pattern, iterable of frames)."""
    import os

    if isinstance(src, np.ndarray):
        return src
    if (isinstance(src, str) and os.path.isfile(src)
            and os.path.splitext(src)[1].lower() in _IMG_EXTS):
        return read_image(src)
    return None


def canon_trimap_u8(tri: np.ndarray, hw: Tuple[int, int],
                    frame_idx: Optional[int] = None) -> np.ndarray:
    """Validate a user trimap and bring it to the (H, W) uint8 canon.

    Takes (H, W), (H, W, 1) or (H, W, 3) (a trimap stored as video decodes
    3-channel: the first channel is taken), uint8 {0, 128, 255} or float
    {0, 0.5, 1} (as round(clip(v) * 255)). Raises on a resolution other
    than ``hw``."""
    tri = np.asarray(tri)
    if tri.ndim == 3:
        tri = tri[..., 0]
    if tri.ndim != 2 or tri.shape != tuple(hw):
        at = "" if frame_idx is None else f" frame {frame_idx}"
        raise ValueError(
            f"trimap{at} is {tri.shape}, input frame is {tuple(hw)}: "
            "trimaps must match the input resolution frame-for-frame")
    if tri.dtype != np.uint8:
        tri = np.round(np.clip(tri.astype(np.float32), 0.0, 1.0)
                       * 255.0).astype(np.uint8)
    return tri


def _box_dilate(mask: np.ndarray, r: int) -> np.ndarray:
    """Binary box dilation with radius r via an integral image (O(HW))."""
    h, w = mask.shape
    pad = np.pad(mask.astype(np.int32), r)
    ii = pad.cumsum(0).cumsum(1)
    ii = np.pad(ii, ((1, 0), (1, 0)))
    s = (ii[2 * r + 1:, 2 * r + 1:] - ii[:-2 * r - 1, 2 * r + 1:]
         - ii[2 * r + 1:, :-2 * r - 1] + ii[:-2 * r - 1, :-2 * r - 1])
    return s[:h, :w] > 0


def trimap_from_mask(mask: np.ndarray, band=0.04) -> np.ndarray:
    """A {0, 0.5, 1} trimap from a rough segmentation mask.

    The unknown band straddles the mask's boundary: pixels within ``band``
    of both classes become 0.5, the eroded interior stays 1, the far
    exterior 0 (erode / dilate trimap generation).

    mask: (H, W), (H, W, 1) or (H, W, 3); uint8 (>= 128 is foreground) or
    float (>= 0.5). band: the unknown half-width, a float as a fraction of
    the short side or an int in pixels. Returns (H, W, 1) float32."""
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[..., 0]
    fg = (m >= 128) if m.dtype == np.uint8 else (
        m.astype(np.float32) >= 0.5)
    h, w = fg.shape
    r = int(band) if isinstance(band, (int, np.integer)) else max(
        1, int(band * min(h, w)))
    if r < 1:
        raise ValueError(f"band radius resolves to {r} px; it must be >= 1")
    near_fg = _box_dilate(fg, r)
    near_bg = _box_dilate(~fg, r)
    tri = np.where(fg & ~near_bg, 1.0, 0.0).astype(np.float32)
    tri[near_fg & near_bg] = 0.5
    return tri[..., None]


def alpha_to_trimap(alpha: np.ndarray, band: float = 0.08,
                    lo: float = 0.05, hi: float = 0.95) -> np.ndarray:
    """A {0, 0.5, 1} trimap from ground-truth alpha (vidmat/train/data.py
    ``alpha_to_trimap``): definite foreground and background where the
    alpha is saturated, unknown in a box-dilated band around the edge;
    the unknown band of the quality gates.

    alpha: (H, W) or (H, W, 1). band: the dilation radius as a fraction of
    the short side. Returns (H, W, 1) float32."""
    a = alpha[..., 0] if alpha.ndim == 3 else alpha
    h, w = a.shape
    r = max(1, int(band * min(h, w)))
    dilated = _box_dilate((a > lo) & (a < hi), r)
    tri = np.where(a >= hi, 1.0, 0.0).astype(np.float32)
    tri[dilated] = 0.5
    return tri[..., None]
