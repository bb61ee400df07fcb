"""Synthetic video fixtures with closed-form ground-truth alpha
(counterpart of the moving-disk and clean-plate clips in
vidmat/io/fixtures.py; numpy only)."""

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


def synthetic_plate_frame(h: int, w: int, t: float, seed: int = 0,
                          camouflage: bool = True,
                          plate_jitter: float = 0.0,
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One frame of the clean-plate clip: (frame uint8 (H, W, 3), alpha
    float32 (H, W, 1), plate uint8 (H, W, 3)), the plate being the scene's
    background without the foreground.

    camouflage=True fills the orbiting disk with the same background
    texture sampled at a fixed per-seed offset, so only a comparison with
    the plate can find it. plate_jitter scales and noises the returned
    plate by that magnitude (an imperfect capture); the frame still
    composites over the true background."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.rand(3, 4) * 2 * np.pi
    bg = _texture(xx, yy, h, w, phase)

    cx = w / 2 + 0.25 * w * np.cos(2 * np.pi * t)
    cy = h / 2 + 0.25 * h * np.sin(2 * np.pi * t)
    radius = 0.18 * min(h, w)
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    alpha = np.clip((radius - dist) / 2.0 + 0.5, 0.0, 1.0)[..., None]

    if camouflage:
        ox = (0.2 + 0.3 * rng.rand()) * w
        oy = (0.2 + 0.3 * rng.rand()) * h
        fg_fill = _texture(xx + ox, yy + oy, h, w, phase)
    else:
        fg_fill = np.array([0.9, 0.3, 0.2], np.float32) + 0.1 * np.sin(
            np.stack([xx, yy, xx + yy], axis=-1) / 17.0)

    frame = alpha * fg_fill + (1.0 - alpha) * bg
    plate = bg
    if plate_jitter > 0.0:
        jr = np.random.RandomState(seed + 13)
        gain = 1.0 + plate_jitter * (2.0 * jr.rand() - 1.0)
        plate = plate * gain + plate_jitter * jr.randn(h, w, 3).astype(
            np.float32) * 0.5
    frame_u8 = np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8)
    plate_u8 = np.round(np.clip(plate, 0, 1) * 255).astype(np.uint8)
    return frame_u8, alpha.astype(np.float32), plate_u8


def synthetic_plate_clip(h: int, w: int, num_frames: int, seed: int = 0,
                         camouflage: bool = True, plate_jitter: float = 0.0
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
    """Yield (frame_uint8, gt_alpha, plate_uint8) for a clean-plate clip
    (the plate is constant across the clip, as a captured plate is)."""
    for i in range(num_frames):
        yield synthetic_plate_frame(h, w, i / max(num_frames, 1), seed,
                                    camouflage=camouflage,
                                    plate_jitter=plate_jitter)
