"""Synthetic video fixtures with closed-form ground-truth alpha
(counterpart of the moving-disk clip in vidmat/io/fixtures.py; numpy
only)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_frame(h: int, w: int, t: float, seed: int = 0,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One frame of the moving-disk clip: (frame uint8 (H, W, 3), alpha
    float32 (H, W, 1)); a soft-edged disk orbiting the frame center over a
    low-frequency background texture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.rand(3, 4) * 2 * np.pi
    bg = _texture(xx, yy, h, w, phase)

    cx = w / 2 + 0.25 * w * np.cos(2 * np.pi * t)
    cy = h / 2 + 0.25 * h * np.sin(2 * np.pi * t)
    radius = 0.18 * min(h, w)
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    alpha = np.clip((radius - dist) / 2.0 + 0.5, 0.0, 1.0)[..., None]

    fg_color = np.array([0.9, 0.3, 0.2], np.float32) + 0.1 * np.sin(
        np.stack([xx, yy, xx + yy], axis=-1) / 17.0)
    frame = alpha * fg_color + (1.0 - alpha) * bg
    frame_u8 = np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8)
    return frame_u8, alpha.astype(np.float32)


def synthetic_clip(h: int, w: int, num_frames: int, seed: int = 0,
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (frame_uint8, gt_alpha) pairs for a num_frames clip."""
    for i in range(num_frames):
        yield synthetic_frame(h, w, i / max(num_frames, 1), seed)


def synthetic_frames_only(h: int, w: int, num_frames: int, seed: int = 0
                          ) -> Iterator[np.ndarray]:
    for frame, _ in synthetic_clip(h, w, num_frames, seed):
        yield frame


def _texture(xx: np.ndarray, yy: np.ndarray, h: int, w: int,
             phase: np.ndarray) -> np.ndarray:
    return np.stack([
        0.5 + 0.2 * np.sin(2 * np.pi * xx / w * 3 + phase[c, 0])
        * np.cos(2 * np.pi * yy / h * 2 + phase[c, 1])
        + 0.1 * np.sin(2 * np.pi * (xx + yy) / (h + w) * 5 + phase[c, 2])
        for c in range(3)], axis=-1)
