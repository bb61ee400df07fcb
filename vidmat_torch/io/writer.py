"""Output sinks (counterpart of vidmat/io/writer.py).

An output target is either a callable, which receives each (H, W[, C])
uint8 frame on the pipeline's thread (the port's own contract), or a path,
written by ``VideoWriter`` on an encoder thread fed by a bounded queue so
that encoding overlaps the device's work. Paths need ``cv2``."""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Optional, Union

import numpy as np

from vidmat_torch.io.reader import require_cv2


def write_image(path: str, image: np.ndarray) -> None:
    """Write an (H, W[, 1|3|4]) uint8 or float [0, 1] image (needs cv2)."""
    cv2 = require_cv2(f"writing the image {path!r}")
    img = image
    if img.dtype != np.uint8:
        img = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 3:
        code = (cv2.COLOR_RGBA2BGRA if img.shape[-1] == 4
                else cv2.COLOR_RGB2BGR)
        img = cv2.cvtColor(img, code)
    if not cv2.imwrite(path, img):
        raise OSError(f"cv2 could not write {path!r}")


class VideoWriter:
    """Threaded frame-stream writer; frames are (H, W[, C]) uint8 RGB or
    gray. The target's form picks the output:

      *.mp4 / *.avi ...   a video container (mp4v)
      a directory, a path without extension, or a pattern holding '%'
      (``out/alpha_%05d.png``), or an image path (``out/a.png`` ->
      ``out/a_00000.png`` ...)   a numbered image sequence (PNG keeps
      the alpha channel)

    ``write`` queues the frame (blocking when ``queue_size`` frames wait);
    ``close`` drains the queue, joins the encoder thread and raises the
    error it met, if any."""

    _END = object()

    def __init__(self, path: str, fps: float = 30.0, queue_size: int = 16):
        self._cv2 = require_cv2(f"writing {path!r}")
        self.path = path
        self.fps = fps
        ext = os.path.splitext(path)[1].lower()
        self._seq_pattern: Optional[str] = None
        if "%" in path:
            self._seq_pattern = path
        elif ext in ("", ".d") or os.path.isdir(path):
            self._seq_pattern = os.path.join(path, "%05d.png")
        elif ext in (".png", ".jpg", ".jpeg", ".webp"):
            self._seq_pattern = f"{os.path.splitext(path)[0]}_%05d{ext}"
        self._n = 0
        self._writer = None
        self._error: Optional[BaseException] = None
        self.q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def _encode(self, frame: np.ndarray) -> None:
        cv2 = self._cv2
        if self._seq_pattern is not None:
            p = self._seq_pattern % self._n
            os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
            write_image(p, frame)
            self._n += 1
            return
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

    def _consume(self) -> None:
        while True:
            frame = self.q.get()
            if frame is VideoWriter._END:
                return
            if self._error is None:  # after an error, drain without work
                try:
                    self._encode(frame)
                except BaseException as e:  # surfaced by close()
                    self._error = e

    def write(self, frame: np.ndarray) -> None:
        if frame.dtype != np.uint8:
            frame = np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(
                np.uint8)
        self.q.put(frame)

    def close(self) -> None:
        self.q.put(VideoWriter._END)
        self._thread.join()
        if self._writer is not None:
            self._writer.release()
        if self._error is not None:
            raise self._error


class _CallableSink:
    def __init__(self, fn: Callable[[np.ndarray], None]):
        self.write = fn

    def close(self) -> None:
        pass


def open_sink(target: Union[str, Callable], fps: float = 30.0):
    """A writer for an output target: a callable (called synchronously) or
    a path (``VideoWriter``, threaded)."""
    if callable(target):
        return _CallableSink(target)
    return VideoWriter(target, fps)
