"""Real-time (live) serving with latest-wins frame scheduling (counterpart
of vidmat/pipeline/realtime.py).

Offline conversion (``pipeline.video``) processes every frame, which is
right for files and wrong for a live feed: when the producer (a camera, a
capture thread) outpaces the step, a queue only grows the latency. Live
serving wants the newest frame, drops stale ones and reports the drops.

- a one-slot latest-wins mailbox between the capture thread and the
  device loop: ``put`` overwrites, and an overwritten frame counts as
  dropped;
- the step is :class:`vidmat_torch.pipeline.stepper.VideoStepper` (the
  serving body: the ingest, planar and tail kernels in bf16) on the /16
  bucket, each frame edge-padded straight into its pinned slot; on CUDA
  its step is a captured graph from the warm-up on, and the composite,
  the crop and the alpha byte are made on the device from its device
  outputs, so only the cropped bytes come back;
- a pacing producer, so a file or a frame list can stand in for a
  camera.

A camera is an integer source (``cv2.VideoCapture``; needs cv2). A path
goes through the port's reader; anything else is iterated as frames.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional, Union

import numpy as np
import torch

from vidmat_torch.config import ModelConfig


class LatestMailbox:
    """One-slot handoff: `put` overwrites (counting the overwritten frame
    as dropped); `get` blocks for a fresh item or channel close."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._item = None
        self._fresh = False
        self._closed = False
        self.dropped = 0
        self.produced = 0

    def put(self, item) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("mailbox is closed")
            if self._fresh:
                self.dropped += 1
            self._item = item
            self._fresh = True
            self.produced += 1
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None):
        """Newest item, or None when the channel is closed and drained."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._fresh or self._closed, timeout=timeout):
                raise TimeoutError("no frame arrived within timeout")
            if not self._fresh:
                return None  # closed and drained
            self._fresh = False
            return self._item


def _frame_iter(source: Union[int, str, Iterable[np.ndarray]]):
    """Resolve a live source: a camera index -> cv2 capture; a path -> the
    video or image-sequence reader; otherwise an iterable of frames."""
    if isinstance(source, int) or (isinstance(source, str)
                                   and source.isdigit()):
        from vidmat_torch.io.reader import require_cv2

        cv2 = require_cv2(f"the camera {source}")
        cap = cv2.VideoCapture(int(source))
        if not cap.isOpened():
            raise RuntimeError(f"cannot open camera {source}")

        def gen():
            # The consumer may abandon the generator early (max_frames):
            # GeneratorExit still releases the capture device.
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            finally:
                cap.release()

        return gen()
    if isinstance(source, str):
        from vidmat_torch.io.reader import VideoReader, image_sequence

        seq = image_sequence(source)
        return seq if seq is not None else iter(VideoReader(source))
    return iter(source)


class RealtimeMatting:
    """Live matting session with latest-wins scheduling.

    >>> rt = RealtimeMatting(192, 256, device="cuda")
    >>> stats = rt.run(frames, output_composition="live.mp4",
    ...                pace_fps=30.0)
    >>> stats["dropped"], stats["achieved_fps"]

    The signature is the JAX package's, plus ``device`` ("cuda", the
    default, raises without a CUDA device; "cpu" runs the plain PyTorch
    versions of the kernels). bg_plate: the clean plate of the
    plate-conditioned family (with model_cfg=None it selects
    ``plate_default_config()``, shipped plate_demo)."""

    def __init__(self, height: int, width: int,
                 model_cfg: Optional[ModelConfig] = None,
                 variables=None, downsample_ratio: float = 1.0,
                 dtype: str = "bfloat16",
                 static_skip_eps: Optional[float] = None,
                 bg_color=(0.0, 1.0, 0.0),
                 bg_plate=None,
                 device="cuda"):
        from vidmat_torch.ops.composite import composite_rgba
        from vidmat_torch.pipeline.stepper import VideoStepper

        if bg_plate is not None and model_cfg is None:
            # A fixed camera is the case a pre-captured plate fits.
            from vidmat_torch.models.weights import plate_default_config

            model_cfg = plate_default_config()
        # Sources come at their own size; serve on the /16 bucket and crop
        # the outputs (as pipeline.video does).
        self.h, self.w = height, width
        self._ph = height + ((-height) % 16)
        self._pw = width + ((-width) % 16)
        self._stepper = VideoStepper(
            model_cfg or ModelConfig(), self._ph, self._pw,
            variables=variables, downsample_ratio=downsample_ratio,
            dtype=dtype, static_skip_eps=static_skip_eps, bg_plate=bg_plate,
            device=device)
        # A color as numbers: composite_rgba makes its tensor once per
        # device, so the finish copies nothing to the device.
        bg = tuple(float(v) for v in bg_color)
        h, w = height, width

        def finish(alpha, fgr):
            """(alpha byte (h, w), composite RGB (h, w, 3)) on the host
            from the step's device outputs."""
            with torch.inference_mode():
                comp = composite_rgba(fgr, alpha, bg)[0, :h, :w, :3]
                a8 = torch.round(alpha[0, :h, :w, 0].clamp(0.0, 1.0)
                                 * 255.0).to(torch.uint8)
                return a8.cpu().numpy(), comp.contiguous().cpu().numpy()

        self._finish = finish

    def reset(self) -> None:
        self._stepper.reset()

    def _step(self, frame: np.ndarray):
        """One live frame (h, w, 3) -> (alpha byte, composite) on the
        host: padded into the stepper's pinned slot, the step, the finish
        on the device."""
        return self._finish(*self._stepper.step_device(frame))

    def run(self, source: Union[int, str, Iterable[np.ndarray]], *,
            output_alpha: Optional[str] = None,
            output_composition: Optional[str] = None,
            pace_fps: Optional[float] = None,
            max_frames: Optional[int] = None,
            fps_hint: float = 30.0,
            frame_timeout: float = 30.0,
            warmup: bool = True,
            on_frame=None) -> dict:
        """Serve a live source until it ends (or ``max_frames`` outputs).

        pace_fps: producer pacing for a file or frame list standing in for
        a camera (None: produce as fast as the source decodes).
        on_frame(alpha_u8 (h, w), comp_u8 (h, w, 3)) is called per
        processed frame. warmup (default True) runs the step once on a
        zero frame before the producer starts (it builds the kernels and,
        on CUDA, captures the step, so the first live frame is a replay),
        then resets the carry; without it the mailbox drops the feed's
        opening frames while the first step builds. Returns the stats:
        produced / processed / dropped, achieved_fps, p50/p99 step latency
        ms, wall_s."""
        from vidmat_torch.io.writer import VideoWriter

        if warmup:
            self._step(np.zeros((self._ph, self._pw, 3), np.uint8))
            self._stepper.reset()  # the dummy frame must not taint state

        box = LatestMailbox()
        stop = threading.Event()

        def produce():
            try:
                t_next = time.perf_counter()
                for frame in _frame_iter(source):
                    if stop.is_set():
                        break
                    if pace_fps:
                        t_next += 1.0 / pace_fps
                        delay = t_next - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    box.put(np.ascontiguousarray(frame))
            finally:
                box.close()

        producer = threading.Thread(target=produce, daemon=True)
        writers = []
        w_alpha = w_comp = None
        if output_alpha:
            w_alpha = VideoWriter(output_alpha, fps=fps_hint)
            writers.append(w_alpha)
        if output_composition:
            w_comp = VideoWriter(output_composition, fps=fps_hint)
            writers.append(w_comp)

        lat = []
        processed = 0
        t_start = time.perf_counter()
        producer.start()
        try:
            while max_frames is None or processed < max_frames:
                frame = box.get(timeout=frame_timeout)
                if frame is None:
                    break  # source ended
                if frame.shape[:2] != (self.h, self.w):
                    raise ValueError(
                        f"live frame is {frame.shape[:2]}, session was "
                        f"built for {(self.h, self.w)}")
                t0 = time.perf_counter()
                a8, comp = self._step(frame)
                lat.append(time.perf_counter() - t0)
                processed += 1
                if w_alpha is not None:
                    w_alpha.write(a8)
                if w_comp is not None:
                    w_comp.write(comp)
                if on_frame is not None:
                    on_frame(a8, comp)
        finally:
            stop.set()
            # put never blocks (it overwrites), so the producer ends at its
            # next frame.
            producer.join(timeout=frame_timeout)
            for wtr in writers:
                wtr.close()

        wall = time.perf_counter() - t_start
        lat_arr = np.asarray(lat) if lat else np.zeros(1)
        return {
            "produced": box.produced,
            "processed": processed,
            "dropped": box.dropped,
            "achieved_fps": processed / wall if wall > 0 else 0.0,
            "p50_ms": float(np.percentile(lat_arr, 50) * 1e3),
            "p99_ms": float(np.percentile(lat_arr, 99) * 1e3),
            "wall_s": wall,
        }
