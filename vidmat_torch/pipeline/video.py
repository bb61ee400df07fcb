"""Video pipeline (counterpart of vidmat/pipeline/video.py).

  - a host thread decodes into a bounded prefetch queue (FrameSource)
  - each frame is edge-padded to the /16 bucket on the host, copied to
    the device from pinned memory, and run through the serving body;
    the recurrent state never leaves the device
  - a one-frame software pipeline: the device-to-host copy of frame t is
    enqueued behind its compute and only waited for after frame t+1 has
    been enqueued, so the host writes frame t while the device computes
    frame t+1
  - chunk_size K groups K frames per dispatch and records one latency
    observation per group. Where the plan has a chunk body (the planar
    net on the fused packed tail), a full chunk is one call: the K frames
    go to the device as one copy, the stateless stages run once over them
    and the recurrent decoder per frame, and the K outputs come back as
    one copy. Otherwise (e.g. ``clip_480p``'s full-resolution tail) the
    per-frame body runs K times. A partial last chunk drains per frame.
  - output_foreground takes the body's uint8 tuple (alpha, fgr, rgba);
    otherwise one packed RGBA word (or the alpha byte) per pixel comes
    back
  - backgrounds of the composition, by precedence bg_blur > bg_video >
    bg_image > bg_color (vidmat/pipeline/video.py:320-330): a blur of the
    source frame made on the device, a per-frame image sent with each
    frame (the per-frame body, in lockstep with the frames, looped if the
    background clip is shorter), one image baked into the body, or a
    color. A clean plate (the plate-conditioned family) is prepared once
    per bucket and baked into the body
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from vidmat_torch._device import resolve_device
from vidmat_torch.config import ModelConfig, PipelineConfig
from vidmat_torch.io.backgrounds import (BgFrameSource, prepare_bg_image,
                                         prepare_plate_u8)
from vidmat_torch.io.reader import FrameSource, pad_frame
from vidmat_torch.io.writer import open_sink
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.ops.composite import unpack_rgba_host
from vidmat_torch.pipeline.stepfactory import build_serving_body
from vidmat_torch.utils.metrics import RunMetrics

Target = Union[str, Callable[[np.ndarray], None]]


def auto_downsample_ratio(h: int, w: int) -> float:
    """Coarse-pass ratio heuristic: aim the network at ~512 px on the
    short side."""
    short = min(h, w)
    if short <= 512:
        return 1.0
    return max(0.125, 512.0 / short)


class _Transfers:
    """Host<->device copies for one device. On CUDA they go through pinned
    memory and are asynchronous on the current stream; a device-to-host
    copy returns a handle that ``wait`` turns into a numpy array."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self.cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def to_host(self, out):
        """Enqueue the copy of a tensor (or a tuple of tensors)."""
        ts = out if isinstance(out, tuple) else (out,)
        if not self.cuda:
            return ts, None, isinstance(out, tuple)
        hosts = []
        for t in ts:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        ev = torch.cuda.Event()
        ev.record()
        return tuple(hosts), ev, isinstance(out, tuple)

    @staticmethod
    def wait(handle):
        """numpy array(s) of a copy enqueued by ``to_host``."""
        hosts, ev, is_tuple = handle
        if ev is not None:
            ev.synchronize()
        arrs = tuple(t.numpy() for t in hosts)
        return arrs if is_tuple else arrs[0]


class VideoPipeline:
    """End-to-end video matting.

    model_cfg / pipe_cfg default to ``ModelConfig()`` and
    ``PipelineConfig()``, as in the JAX package (vidmat/api.py:243,
    vidmat/pipeline/video.py:252); pass a preset's pair for a preset.
    variables: the network's weights as a nested dict of numpy arrays in
    the JAX package's layout; None loads the shipped weights of model_cfg.
    bg_color / bg_image / bg_video / bg_blur: the composition's
    background, as in the JAX package: a color; an image (path or
    (H, W, 3) array, uint8 or float in [0, 1]); a background video (path
    or iterable of frames, one per input frame, looped); the radius in
    full-resolution pixels of a blur of the source frame. Precedence
    bg_blur > bg_video > bg_image > bg_color. A background or plate whose
    size differs from the stream's bucket is resized with cv2.
    bg_plate: the clean plate (path or (H, W, 3) array) of the
    plate-conditioned family (``ModelConfig(use_bg_plate=True)``, which
    requires it): an input of the net, not a background.
    device: "cuda" (default; raises without a CUDA device) or "cpu" (the
    plain PyTorch versions of the kernels)."""

    def __init__(self, model_cfg: Optional[ModelConfig] = None,
                 pipe_cfg: Optional[PipelineConfig] = None,
                 variables=None, downsample_ratio: Optional[float] = None,
                 bg_color: Optional[Tuple[float, float, float]] = None,
                 bg_image: Optional[Union[str, np.ndarray]] = None,
                 bg_video: Optional[Union[str, Iterable[np.ndarray]]] = None,
                 bg_blur: Optional[int] = None,
                 bg_plate: Optional[Union[str, np.ndarray]] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.model_cfg = model_cfg or ModelConfig()
        self.pipe_cfg = pipe_cfg or PipelineConfig()
        if self.model_cfg.use_bg_plate and bg_plate is None:
            raise ValueError(
                "ModelConfig(use_bg_plate=True) needs the pre-captured "
                "clean background plate: pass bg_plate=<image path or "
                "(H, W, 3) array> (the scene without the subject)")
        if bg_plate is not None and not self.model_cfg.use_bg_plate:
            raise ValueError(
                "bg_plate given but the model is not plate-conditioned: "
                "build with ModelConfig(use_bg_plate=True, "
                "space_to_depth=2) (shipped plate_demo), or drop bg_plate")
        self.device = resolve_device(device)
        if variables is None:
            variables = default_variables(self.model_cfg)
        self.cdtype = (torch.bfloat16 if self.pipe_cfg.dtype == "bfloat16"
                       else torch.float32)
        self.net = build_network(
            self.model_cfg, variables,
            dtype=torch.bfloat16 if self.cdtype == torch.bfloat16 else None,
            device=self.device)
        self.downsample_ratio = downsample_ratio
        self.bg_color = bg_color
        self.bg_image = bg_image
        self.bg_video = bg_video
        self.bg_blur = bg_blur
        self.bg_plate = bg_plate
        self._step_cache = {}

    def _build_step(self, h: int, w: int, ratio: float,
                    need_fgr: bool = False, alpha_only: bool = False):
        """The serving body for a (h, w) bucket at a coarse ratio, cached
        per (h, w, ratio, need_fgr, alpha_only)."""
        key = (h, w, ratio, need_fgr, alpha_only)
        if key not in self._step_cache:
            cfg = self.pipe_cfg
            bg = None  # a blur is made on the device, a video sent per frame
            if not (self.bg_blur or self.bg_video is not None):
                bg = (prepare_bg_image(self.bg_image, h, w)
                      if self.bg_image is not None else self.bg_color)
            plate = (prepare_plate_u8(self.bg_plate, h, w)
                     if self.bg_plate is not None else None)
            self._step_cache[key] = build_serving_body(
                self.net, self.model_cfg, cfg.refine, h, w, ratio,
                cdtype=self.cdtype, bg=bg, bg_dynamic=self._bg_dynamic,
                bg_blur=self.bg_blur, bg_plate=plate, need_fgr=need_fgr,
                alpha_only=alpha_only, tile_size=cfg.tile_size,
                static_skip_eps=cfg.static_skip_eps)
        return self._step_cache[key]

    @property
    def _bg_dynamic(self) -> bool:
        """A background video takes the per-frame body with a per-call
        background (a blur takes precedence over it)."""
        return self.bg_video is not None and not self.bg_blur

    def run(self, input_source: Union[str, Iterable[np.ndarray]],
            output_alpha: Optional[Target] = None,
            output_foreground: Optional[Target] = None,
            output_composition: Optional[Target] = None,
            progress: bool = False,
            start_frame: int = 0,
            max_frames: Optional[int] = None) -> dict:
        """Matte a frame stream. Each output target is a video path or a
        callable that receives every (H, W[, C]) uint8 frame. Without
        outputs the frames are processed and only metrics are returned
        (benchmark mode). Returns the metrics dict."""
        source = FrameSource(input_source, start=start_frame,
                             count=max_frames)
        xfer = _Transfers(self.device)
        metrics = RunMetrics()
        writers = {}
        body = plan = state = bg_src = None
        crop = pad = None
        pending = None  # device-to-host handle of the previous frame

        def flush(handle):
            """Write every frame of one device-to-host copy."""
            out = xfer.wait(handle)
            fh, fw = crop  # drop the bucket padding before encode
            if isinstance(out, tuple):  # raw foreground: uint8 tuple
                alpha_u8, fgr_u8, rgba = out
                for i in range(rgba.shape[0]):
                    for name, arr in (("alpha", alpha_u8[i, ..., 0]),
                                      ("fgr", fgr_u8[i]), ("comp", rgba[i])):
                        if name in writers:
                            writers[name].write(arr[:fh, :fw])
                return
            for i in range(out.shape[0]):
                if plan.alpha_only:
                    writers["alpha"].write(out[i, :fh, :fw])
                    continue
                rgba = unpack_rgba_host(out[i:i + 1])[0, :fh, :fw]
                if "alpha" in writers:
                    writers["alpha"].write(rgba[..., 3])
                if "fgr" in writers:
                    writers["fgr"].write(rgba[..., :3])
                if "comp" in writers:
                    writers["comp"].write(rgba)

        def step(host_frames, fn=None):
            """Run (N, h, w, 3) host frames through ``fn`` (the per-frame
            body by default; with a background video, with the next
            background); returns the output's device-to-host handle."""
            nonlocal state
            args = (xfer.to_device(host_frames), state)
            if bg_src is not None:
                args += (xfer.to_device(bg_src.next()),)
            out, state = (fn or body)(*args)
            return xfer.to_host(out)

        k = self.pipe_cfg.chunk_size
        chunk_buf = []
        n = 0
        t_prev = time.perf_counter()
        for frame in source:
            if body is None:
                fh, fw = frame.shape[:2]
                # Ratio: explicit argument > PipelineConfig > heuristic.
                ratio = self.downsample_ratio
                if ratio is None:
                    ratio = self.pipe_cfg.downsample_ratio
                if ratio is None:
                    ratio = auto_downsample_ratio(fh, fw)
                ph, pw = fh + ((-fh) % 16), fw + ((-fw) % 16)
                body, plan = self._build_step(
                    ph, pw, ratio, need_fgr=bool(output_foreground),
                    alpha_only=bool(output_alpha)
                    and not output_foreground and not output_composition)
                state = plan.make_state(1)
                if self._bg_dynamic:
                    bg_src = BgFrameSource(self.bg_video, ph, pw)
                for name, target in (("alpha", output_alpha),
                                     ("fgr", output_foreground),
                                     ("comp", output_composition)):
                    if target:
                        writers[name] = open_sink(target, source.fps)
                crop = (fh, fw)
                pad = (ph, pw)
            host_frame = (pad_frame(frame, *pad)
                          if frame.shape[:2] != pad else frame[None])
            if k > 1:
                chunk_buf.append(host_frame)
                if len(chunk_buf) < k:
                    continue
                if plan.chunk_body is not None:
                    handles = [step(np.concatenate(chunk_buf),
                                    plan.chunk_body)]
                else:
                    handles = [step(f) for f in chunk_buf]
                chunk_buf = []
                if pending is not None:
                    flush(pending)
                for hd in handles[:-1]:
                    flush(hd)
                pending = handles[-1]  # overlap the last copy
                n += k
                t_now = time.perf_counter()
                metrics.record_chunk(t_now - t_prev, k)
                t_prev = t_now
                continue
            handle = step(host_frame)
            if pending is not None:
                flush(pending)  # host writes frame t-1 while t computes
            pending = handle
            n += 1
            t_now = time.perf_counter()
            metrics.record_frame(t_now - t_prev)
            t_prev = t_now
            if progress and n % 50 == 0:
                print(f"frame {n}", flush=True)

        # Drain a partial last chunk per frame; each drained frame records
        # its time so the fps denominator includes the tail.
        for host_frame in chunk_buf:
            handle = step(host_frame)
            if pending is not None:
                flush(pending)
            pending = handle
            n += 1
            t_now = time.perf_counter()
            metrics.record_frame(t_now - t_prev)
            t_prev = t_now
        if pending is not None:
            flush(pending)
        for wtr in writers.values():
            wtr.close()
        out = metrics.summary()
        out["frames"] = n
        if plan is not None and plan.static_skip:
            out["static_skipped"] = state[1][3]
        out["device"] = (torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else "cpu")
        return out
