"""Host-side preparation of backgrounds and clean plates (counterpart of
``_prepare_bg_image``, ``_BgFrameSource`` and ``_prepare_plate_u8`` in
vidmat/pipeline/video.py; numpy only).

Each runs once per stream bucket (or once per frame for a background
video) on the host; the blend itself runs on the device. ``cv2`` is
imported only where a resize is needed: a background or plate whose size
differs from the bucket (a plate within 16 px of it is edge-padded, as the
frames are). Without cv2, pass arrays at the bucket size.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np

from vidmat_torch.io.reader import VideoReader, read_image, require_cv2

Image = Union[str, np.ndarray]


def prepare_bg_image(bg_image: Image, h: int, w: int) -> np.ndarray:
    """A background-replacement image (path or (H, W, 3) array, uint8 or
    float in [0, 1]) as (h, w, 3) float32 in [0, 1]; resized with
    INTER_AREA when its size differs."""
    if isinstance(bg_image, str):
        bg_image = read_image(bg_image)
    bg = np.asarray(bg_image)
    if bg.ndim != 3 or bg.shape[-1] < 3:
        raise ValueError(f"bg_image must be (H, W, 3); got {bg.shape}")
    bg = bg[..., :3]
    if bg.dtype == np.uint8:
        bg = bg.astype(np.float32) / 255.0
    bg = bg.astype(np.float32)
    if bg.shape[:2] != (h, w):
        cv2 = require_cv2(f"resizing a {bg.shape[1]}x{bg.shape[0]} "
                          f"background to the {w}x{h} stream")
        bg = cv2.resize(bg, (w, h), interpolation=cv2.INTER_AREA)
    return bg


class BgFrameSource:
    """Cycled per-frame backgrounds prepared to the stream's (h, w) bucket.

    src: a video path (reopened when exhausted, frames not kept) or an
    iterable of (H, W, 3) frames (the frames seen so far are kept and
    cycled: pass a path for long background clips)."""

    def __init__(self, src: Union[str, Iterable[np.ndarray]], h: int,
                 w: int):
        self.src, self.h, self.w = src, h, w
        self._is_path = isinstance(src, str)
        self._iter = None
        self._cache: list = []
        self._cycling = False
        self._pos = 0

    def _open(self):
        return iter(VideoReader(self.src) if self._is_path else self.src)

    def next(self) -> np.ndarray:
        """(1, h, w, 3) float32 in [0, 1]."""
        if self._cycling:
            f = self._cache[self._pos % len(self._cache)]
            self._pos += 1
            return f
        if self._iter is None:
            self._iter = self._open()
        try:
            raw = next(self._iter)
        except StopIteration:
            if self._is_path:
                self._iter = self._open()  # loop the file
                try:
                    raw = next(self._iter)
                except StopIteration:
                    raise ValueError("bg_video has no frames") from None
            elif self._cache:
                self._cycling = True
                self._pos = 0
                return self.next()
            else:
                raise ValueError("bg_video yielded no frames") from None
        f = prepare_bg_image(raw, self.h, self.w)[None]
        if not self._is_path:
            self._cache.append(f)
        return f


def prepare_plate_u8(bg_plate: Image, h: int, w: int) -> np.ndarray:
    """The clean background plate (path or (H, W, 3) array) as (h, w, 3)
    uint8. A plate at the bucket size passes through; one within 16 px
    below it on each axis (the source size before the bucket's rounding)
    is edge-padded as the frames are; any other size is resized with
    INTER_AREA."""
    if isinstance(bg_plate, str):
        bg_plate = read_image(bg_plate)
    p = np.asarray(bg_plate)
    if p.ndim != 3 or p.shape[-1] < 3:
        raise ValueError(f"bg_plate must be (H, W, 3); got {p.shape}")
    p = p[..., :3]
    if p.dtype != np.uint8:
        p = np.round(np.clip(p.astype(np.float32), 0.0, 1.0)
                     * 255.0).astype(np.uint8)
    ph, pw = p.shape[:2]
    if (ph, pw) != (h, w):
        if 0 <= h - ph < 16 and 0 <= w - pw < 16:
            p = np.pad(p, ((0, h - ph), (0, w - pw), (0, 0)), mode="edge")
        else:
            cv2 = require_cv2(f"resizing a {pw}x{ph} plate to the {w}x{h} "
                              "stream")
            p = cv2.resize(p, (w, h), interpolation=cv2.INTER_AREA)
    return p
