"""Output sinks (counterpart of vidmat/io/writer.py).

An output target is either a callable, which receives each (H, W[, C])
uint8 frame, or a path to a video file, written with ``cv2`` where it is
installed."""

from __future__ import annotations

import os
from typing import Callable, Union

import numpy as np


class VideoWriter:
    """Writes (H, W[, C]) uint8 RGB / gray frames to a video file (mp4v)."""

    def __init__(self, path: str, fps: float = 30.0):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "writing a video file needs cv2; pass a callable sink "
                "instead") from e
        self._cv2 = cv2
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, frame: np.ndarray) -> None:
        cv2 = self._cv2
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        frame = np.ascontiguousarray(frame[..., :3])
        if self._writer is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()


class _CallableSink:
    def __init__(self, fn: Callable[[np.ndarray], None]):
        self.write = fn

    def close(self) -> None:
        pass


def open_sink(target: Union[str, Callable], fps: float = 30.0):
    """A writer for an output target: a callable or a video path."""
    if callable(target):
        return _CallableSink(target)
    return VideoWriter(target, fps)
