"""Threaded prefetching frame source (counterpart of vidmat/io/reader.py).

Decoding a video file or an image sequence needs ``cv2``; where it is not
installed, pass an iterable of (H, W, 3) uint8 RGB frames. A frame that
``fault_hook`` rejects is dropped and counted, and the stream goes on."""

from __future__ import annotations

import glob
import os
import queue
import re
import threading
from typing import Iterable, Iterator, Optional, Union

import numpy as np

from vidmat_torch.utils.profiling import annotate


def require_cv2(what: str):
    """cv2, imported at the one place that needs it, or a clear error."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{what} needs OpenCV (cv2), which is not installed: pass "
            "arrays at the stream's size instead") from None
    return cv2


def read_image(path: str) -> np.ndarray:
    """Read an image file -> (H, W, 3) uint8 RGB (RGBA with an alpha
    channel, (H, W) for a grayscale file). Needs cv2."""
    cv2 = require_cv2(f"reading the image {path!r}")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3 and img.shape[-1] == 4:
        return cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    if img.ndim == 3:
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


class VideoReader:
    """Iterates (H, W, 3) uint8 RGB frames of a video file (needs cv2);
    ``fps``, ``height`` and ``width`` are the file's."""

    def __init__(self, path: str):
        cv2 = require_cv2(f"decoding the video {path!r}")
        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def close(self) -> None:
        self.cap.release()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            yield self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)
        self.cap.release()


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def image_sequence(path: str):
    """Frame iterator over an image sequence, or None when ``path`` does
    not name one: a directory of image files (sorted by name), a
    printf-style pattern (``frames/f_%05d.png``, sorted by the number the
    field holds) or a glob (``frames/*.png``). Frames with an alpha
    channel are delivered as RGB; grayscale images are broadcast to three
    channels."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if os.path.splitext(f)[1].lower() in _IMG_EXTS)
    elif "%" in os.path.basename(path):
        m = re.search(r"%0?\d*d", path)
        if m is None:
            return None
        rx = re.compile(re.escape(path[:m.start()]) + r"(\d+)"
                        + re.escape(path[m.end():]) + "$")
        matched = []
        for p in glob.glob(re.sub(r"%0?\d*d", "*", path)):
            mm = rx.match(p)
            if mm:
                matched.append((int(mm.group(1)), p))
        files = [p for _, p in sorted(matched)]
    elif any(ch in path for ch in "*?["):
        files = sorted(glob.glob(path))
    else:
        return None
    if not files:
        return None

    def gen():
        for p in files:
            img = read_image(p)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            yield np.ascontiguousarray(img[..., :3])

    return gen()


class FrameSource:
    """One producer thread fills a bounded queue; iteration drains it.

    frames: a video path, an image sequence (see ``image_sequence``) or an
    iterable of frames. ``fault_hook(frame_index, frame) -> frame`` may
    replace a frame or raise; a frame it raises on is skipped and counted
    in ``dropped``. ``start``/``count`` trim the stream: the first
    ``start`` frames are decoded but not delivered, and delivery stops
    after ``count``."""

    _END = object()

    def __init__(self, frames: Union[str, Iterable[np.ndarray]],
                 prefetch: int = 8, fault_hook=None, start: int = 0,
                 count: Optional[int] = None):
        if isinstance(frames, str):
            seq = image_sequence(frames)
            if seq is not None:
                self.fps = 30.0
                self.frames: Iterable[np.ndarray] = seq
            else:
                reader = VideoReader(frames)
                self.fps = reader.fps
                self.frames = reader
        else:
            self.fps = 30.0
            self.frames = frames
        if start < 0 or (count is not None and count < 0):
            raise ValueError("start/count must be non-negative")
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.fault_hook = fault_hook
        self.dropped = 0
        self._start = start
        self._count = count
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        delivered = 0
        try:
            for i, frame in enumerate(self.frames):
                if i < self._start:
                    continue
                if self._count is not None and delivered >= self._count:
                    break
                if self.fault_hook is not None:
                    try:
                        frame = self.fault_hook(i, frame)
                    except Exception:
                        self.dropped += 1
                        continue  # skip the corrupt frame, keep the stream
                self.q.put(frame)
                delivered += 1
        finally:
            self.q.put(self._END)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            with annotate("source_wait"):
                item = self.q.get()
            if item is self._END:
                break
            yield item


def pad_frame(frame: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Edge-pad an (H, W, C) frame at the bottom and right to
    (1, out_h, out_w, C), as vidmat/io/native.py pad_stack does."""
    ph, pw = out_h - frame.shape[0], out_w - frame.shape[1]
    return np.pad(frame, ((0, ph), (0, pw), (0, 0)), mode="edge")[None]
