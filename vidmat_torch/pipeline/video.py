"""Video pipeline (counterpart of vidmat/pipeline/video.py).

  - a host thread decodes into a bounded prefetch queue (FrameSource)
  - staging (per bucket, allocated once and reused by every run): each
    frame is edge-padded by the native ``pad_into`` (``io/native.py``)
    straight into its slot of one of two pinned (K, h, w, 3) host chunks;
    a full chunk goes to one device input chunk as one asynchronous copy,
    and a host chunk is refilled only after the event recorded behind its
    copy has completed. Outputs come back into a small ring of pinned
    buffers, each refilled only after the host has read it; every frame
    handed to a writer is an owned copy. The partial last chunk and the
    per-frame bodies use the same buffers
  - a one-chunk software pipeline: the device-to-host copy of chunk t is
    enqueued behind its compute and only waited for after chunk t+1 has
    been enqueued, so the host writes chunk t while the device computes
    chunk t+1
  - chunk_size K groups K frames per dispatch and records one latency
    observation per group. Where the plan has a chunk body (the planar
    net on the fused packed tail), a full chunk is one call of it: the
    stateless stages run once over the K frames and the recurrent decoder
    per frame. Otherwise the chunk is K calls of the per-frame body
    (``graph.per_frame_chunk``, the JAX package's scan; chunk 1 is its
    per-frame ``step``). On CUDA the first full chunk of a bucket runs
    eagerly (the warm-up) and is then captured as one CUDA graph
    (``graph.ChunkGraph``): each later chunk is one copy in (two with a
    background video), one graph launch and one copy out, on one
    stream. The static-skip body picks its branch on the host, so it
    stays eager. A partial last chunk drains per frame, eagerly. Set-up
    (building a bucket's body, pinning its buffers, capturing its graph)
    falls in the first latency observation, as in the JAX package's
    loop, and is also reported as ``setup_ms`` (the capture also as
    ``graph_capture_ms``)
  - output_foreground takes the body's uint8 tuple (alpha, fgr, rgba);
    otherwise one packed RGBA word (or the alpha byte) per pixel comes
    back
  - backgrounds of the composition, by precedence bg_blur > bg_video >
    bg_image > bg_color (vidmat/pipeline/video.py:320-330): a blur of the
    source frame made on the device, a per-frame image (in lockstep with
    the frames, looped if the background clip is shorter; staged K deep
    like the frames, one copy per chunk), one image baked into the body,
    or a color. A clean plate (the plate-conditioned family) is prepared once
    per bucket and baked into the body
  - trimap-conditioned models take ``trimap_source``: a per-frame trimap
    stream, trimmed as the input is, or one keyframe trimap (the
    recurrent propagation family: later frames get all-unknown trimaps).
    Each trimap rides its frame as a fourth uint8 channel through the
    same staging (vidmat/pipeline/video.py:178-205, 404-496)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from vidmat_torch._device import resolve_device
from vidmat_torch.config import ModelConfig, PipelineConfig, StreamConfig
from vidmat_torch.io.backgrounds import (BgFrameSource, prepare_bg_image,
                                         prepare_plate_u8)
from vidmat_torch.io.native import pad_into, unpack_rgba
from vidmat_torch.io.reader import FrameSource
from vidmat_torch.io.writer import open_sink
from vidmat_torch.models.weights import (build_network, build_refiner,
                                         default_refiner_variables,
                                         default_variables)
from vidmat_torch.ops.resize import downsample_ratio_shape
from vidmat_torch.pipeline.graph import ChunkGraph, per_frame_chunk
from vidmat_torch.pipeline.stepfactory import (ServingPlan,
                                               build_serving_body)
from vidmat_torch.pipeline.trimap import (PreTrimmedTrimaps, canon_trimap_u8,
                                          single_trimap)
from vidmat_torch.utils.metrics import RunMetrics
from vidmat_torch.utils.profiling import annotate, spanned

Target = Union[str, Callable[[np.ndarray], None]]


def auto_downsample_ratio(h: int, w: int) -> float:
    """Coarse-pass ratio heuristic: aim the network at ~512 px on the
    short side."""
    short = min(h, w)
    if short <= 512:
        return 1.0
    return max(0.125, 512.0 / short)


def attach_trimap(frame: np.ndarray, tri, frame_idx: int) -> np.ndarray:
    """The frame with its trimap as a fourth uint8 channel ((H, W[, 1 or
    3]) trimap, uint8 {0, 128, 255} or float {0, 0.5, 1})."""
    tri = canon_trimap_u8(tri, frame.shape[:2], frame_idx=frame_idx)
    return np.concatenate([frame, tri[..., None]], axis=-1)


class Uploads:
    """Two host buffers of one shape (pinned on CUDA) and one device buffer.
    ``slot`` gives the host buffer to fill next, waiting first for the
    copy last made out of it; ``send`` copies its first n entries to the
    device buffer (asynchronously on CUDA, on the current stream)."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(2)]
        self.events = ([torch.cuda.Event() for _ in range(2)]
                       if self.cuda else None)
        self.dev = torch.empty(shape, dtype=dtype, device=device)
        self.i = 0

    @spanned("slot_wait")
    def slot(self) -> torch.Tensor:
        if self.cuda:
            self.events[self.i].synchronize()
        return self.host[self.i]

    def send(self, n: int) -> torch.Tensor:
        i, self.i = self.i, self.i ^ 1
        self.dev[:n].copy_(self.host[i][:n], non_blocking=True)
        if self.cuda:
            self.events[i].record()
        return self.dev[:n]


class Downloads:
    """A ring of host buffers (pinned on CUDA) for the body's outputs, each
    K frames deep, allocated at the first output. A handle covers the
    frames copied into one buffer; ``read`` waits for the copies and
    returns numpy views, and a buffer is given out again only after
    ``release`` (the host has read it). Two are enough for the pipeline,
    which holds one group's handle while the next group's copy goes
    out."""

    DEPTH = 2

    def __init__(self, k: int, device: torch.device):
        self.k = k
        self.cuda = device.type == "cuda"
        self.bufs = [None] * self.DEPTH
        self.free = [True] * self.DEPTH
        self.events = ([torch.cuda.Event() for _ in range(self.DEPTH)]
                       if self.cuda else None)
        self.i = 0

    def open(self, out) -> int:
        """The next buffer, for outputs shaped like ``out``."""
        i = self.i
        if not self.free[i]:
            raise RuntimeError("output buffer reused before it was read")
        self.i = (i + 1) % len(self.bufs)
        ts = out if isinstance(out, tuple) else (out,)
        if self.bufs[i] is None:
            self.bufs[i] = tuple(
                torch.empty((self.k, *t.shape[1:]), dtype=t.dtype,
                            pin_memory=self.cuda) for t in ts)
        self.free[i] = False
        return i

    def put(self, i: int, at: int, out) -> None:
        """Enqueue the copy of ``out`` (N frames) to frames at.. of
        buffer i."""
        ts = out if isinstance(out, tuple) else (out,)
        for buf, t in zip(self.bufs[i], ts):
            buf[at:at + t.shape[0]].copy_(t, non_blocking=True)

    def close(self, i: int, n: int, is_tuple: bool):
        if self.cuda:
            self.events[i].record()
        return i, n, is_tuple

    @spanned("d2h_wait")
    def read(self, handle):
        i, n, is_tuple = handle
        if self.cuda:
            self.events[i].synchronize()
        arrs = tuple(t[:n].numpy() for t in self.bufs[i])
        return arrs if is_tuple else arrs[0]

    def release(self, handle) -> None:
        self.free[handle[0]] = True


@dataclasses.dataclass
class Bucket:
    """The serving body of one (h, w, ratio, outputs) bucket and the
    buffers it reuses across runs."""

    body: Callable
    plan: ServingPlan
    frames: Uploads
    outs: Downloads
    # One full chunk: the plan's chunk body, or K calls of the per-frame
    # body; fn(frames[, bgs], state) -> (out, state).
    chunk: Callable
    bgs: Optional[Uploads] = None
    graph: Optional[ChunkGraph] = None


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
    ``pipe_cfg.use_pallas=False`` runs the net as F.conv2d and every stage
    on its plain version (the JAX package's branch without kernels).
    refiner_variables: the error-map refiner's weights (nested dict of
    numpy arrays in the JAX package's layout) for
    ``refine.mode="errormap"``; None loads the shipped errormap_demo;
    ignored in the other modes. A ``StreamConfig`` raises TypeError: it
    is served by ``MultiStreamMatting``.
    device: "cuda" (default; raises without a CUDA device) or "cpu" (the
    plain PyTorch versions of the kernels)."""

    #: replay one CUDA graph per full chunk on CUDA (False: every chunk
    #: through the eager bodies, the reference the graphs are held to)
    capture = True

    def __init__(self, model_cfg: Optional[ModelConfig] = None,
                 pipe_cfg: Optional[PipelineConfig] = None,
                 variables=None, downsample_ratio: Optional[float] = None,
                 bg_color: Optional[Tuple[float, float, float]] = None,
                 bg_image: Optional[Union[str, np.ndarray]] = None,
                 bg_video: Optional[Union[str, Iterable[np.ndarray]]] = None,
                 bg_blur: Optional[int] = None,
                 bg_plate: Optional[Union[str, np.ndarray]] = None,
                 refiner_variables=None,
                 device: Union[str, torch.device] = "cuda"):
        if isinstance(pipe_cfg, StreamConfig):
            # The JAX package fails here on a missing attribute; the port
            # names the class that serves the configuration.
            raise TypeError(
                "a StreamConfig configures multi-stream serving: serve it "
                "with vidmat_torch.MultiStreamMatting(s.num_streams, "
                "s.height, s.width, ...), not convert_video / "
                "VideoPipeline")
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
        net_cfg = self.model_cfg
        if self.pipe_cfg.use_pallas is False:
            # Without kernels the JAX package runs the net as plain
            # convolutions (its planar forward needs its kernels).
            net_cfg = dataclasses.replace(net_cfg, conv_impl="xla")
        with annotate("build"):
            self.net = build_network(
                net_cfg, variables,
                dtype=(torch.bfloat16 if self.cdtype == torch.bfloat16
                       else None),
                device=self.device)
        self.downsample_ratio = downsample_ratio
        self.bg_color = bg_color
        self.bg_image = bg_image
        self.bg_video = bg_video
        self.bg_blur = bg_blur
        self.bg_plate = bg_plate
        self._step_cache = {}
        # The error-map refiner's patch budget and size, and its weights
        # (ignored outside errormap mode, as in the JAX package).
        self._refiner_k = self._refiner_p = None
        self._refiner_vars = refiner_variables
        if self.pipe_cfg.refine.mode == "errormap":
            self._refiner_k = self.pipe_cfg.refine.errormap_patches
            self._refiner_p = self.pipe_cfg.refine.errormap_patch_size

    @spanned("build")
    def _build_step(self, h: int, w: int, ratio: float,
                    need_fgr: bool = False, alpha_only: bool = False
                    ) -> Bucket:
        """The serving body for a (h, w) bucket at a coarse ratio and its
        staging buffers, cached per (h, w, ratio, need_fgr, alpha_only)."""
        key = (h, w, ratio, need_fgr, alpha_only)
        if key not in self._step_cache:
            cfg = self.pipe_cfg
            bg = None  # a blur is made on the device, a video sent per frame
            if not (self.bg_blur or self.bg_video is not None):
                bg = (prepare_bg_image(self.bg_image, h, w)
                      if self.bg_image is not None else self.bg_color)
            plate = (prepare_plate_u8(self.bg_plate, h, w)
                     if self.bg_plate is not None else None)
            body, plan = build_serving_body(
                self.net, self.model_cfg, cfg.refine, h, w, ratio,
                cdtype=self.cdtype, bg=bg, bg_dynamic=self._bg_dynamic,
                bg_blur=self.bg_blur, bg_plate=plate, need_fgr=need_fgr,
                alpha_only=alpha_only, tile_size=cfg.tile_size,
                tile_overlap=cfg.tile_overlap,
                static_skip_eps=cfg.static_skip_eps,
                use_pallas=cfg.use_pallas,
                refiner=self._refiner_for(h, w, ratio))
            k = max(1, cfg.chunk_size)
            c = 4 if self.model_cfg.use_trimap else 3
            chunk = (plan.chunk_body if k > 1 and plan.chunk_body is not None
                     else per_frame_chunk(body, self._bg_dynamic))
            self._step_cache[key] = Bucket(
                body, plan, Uploads((k, h, w, c), torch.uint8, self.device),
                Downloads(k, self.device), chunk,
                bgs=(Uploads((k, h, w, 3), torch.float32, self.device)
                     if self._bg_dynamic else None))
        return self._step_cache[key]

    def _refiner_for(self, h: int, w: int, ratio: float):
        """The error-map refiner of a bucket (vidmat/pipeline/video.py:
        331-351): None outside errormap mode and where the net runs at
        full resolution. The patch budget is clamped to half the frame's
        patch slots where it exceeds them (and stays clamped, as in the
        JAX package); without ``refiner_variables`` the shipped
        errormap_demo is loaded, or a ValueError raised."""
        if self._refiner_k is None:
            return None
        net_hw = ((h, w) if ratio >= 1.0
                  else downsample_ratio_shape(h, w, ratio))
        if net_hw == (h, w):
            return None
        p = self._refiner_p
        slots = (h // p) * (w // p)
        if self._refiner_k > slots:
            self._refiner_k = max(1, slots // 2)
        if self._refiner_vars is None:
            self._refiner_vars = default_refiner_variables()
        return build_refiner(self._refiner_vars, self._refiner_k, p,
                             device=self.device)

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
            max_frames: Optional[int] = None,
            trimap_source=None) -> dict:
        """Matte a frame stream. Each output target is a video path or a
        callable that receives every (H, W[, C]) uint8 frame (an owned
        array). Without outputs the frames are processed and only metrics
        are returned (benchmark mode). Frames the source drops are counted
        as ``dropped_frames``. ``trimap_source`` (trimap-conditioned
        models, which require it): a per-frame trimap stream (video path,
        image directory or pattern, iterable), trimmed as the input is, or
        one keyframe trimap (image path or array; the recurrent family
        only). Returns the metrics dict."""
        cfg = self.model_cfg
        if cfg.use_trimap and trimap_source is None:
            raise ValueError(
                "model_cfg.use_trimap=True needs trimaps: pass "
                "trimap_source=<video path / PNG dir-or-pattern / frame "
                "iterable> consumed in lockstep with the input, or, for "
                "the recurrent propagation family, a single keyframe "
                "trimap (image path or (H, W) array)")
        if trimap_source is not None and not cfg.use_trimap:
            raise ValueError(
                "trimap_source given but the model is not trimap-"
                "conditioned: build with ModelConfig(use_trimap=True) "
                "(recurrent propagation, shipped trimap_prop_demo) or "
                "ModelConfig(use_trimap=True, recurrent=False) (per-frame "
                "trimaps, shipped trimap_demo), or drop trimap_source")
        source = FrameSource(input_source, start=start_frame,
                             count=max_frames)
        tri_iter = None
        if trimap_source is not None:
            keyframe = single_trimap(trimap_source)
            if keyframe is not None:
                if not cfg.recurrent:
                    raise ValueError(
                        "a single keyframe trimap needs the recurrent "
                        "trimap-propagation family (ModelConfig(use_trimap"
                        "=True), shipped trimap_prop_demo): the "
                        "non-recurrent per-frame family has no temporal "
                        "state to carry it forward")
                tri_iter = iter([keyframe])
            elif isinstance(trimap_source, PreTrimmedTrimaps):
                # Already trimmed to the run's window (mask_source).
                tri_iter = iter(trimap_source)
            else:
                # Trimmed as the input is, so frame i pairs with trimap i.
                tri_iter = iter(FrameSource(trimap_source, start=start_frame,
                                            count=max_frames))
        metrics = RunMetrics()
        writers = {}
        b: Optional[Bucket] = None
        state = bg_src = crop = host = None
        pending = None  # device-to-host handle of the previous group
        capture_ms = None
        replays = 0

        def flush(handle):
            """Write every frame of one device-to-host copy (owned copies:
            the buffer is refilled after this returns). The copies are
            numpy's, on this thread: PyTorch's intra-op threads, spinning
            after each copy, would take the cores the staging threads and
            this loop run on."""
            out = b.outs.read(handle)
            fh, fw = crop  # drop the bucket padding before encode
            if isinstance(out, tuple):  # raw foreground: uint8 tuple
                alpha_u8, fgr_u8, rgba = out
                for i in range(rgba.shape[0]):
                    for name, arr in (("alpha", alpha_u8[i, ..., 0]),
                                      ("fgr", fgr_u8[i]), ("comp", rgba[i])):
                        if name in writers:
                            with annotate("sink"):
                                writers[name].write(np.array(arr[:fh, :fw]))
            else:
                for i in range(out.shape[0]):
                    if b.plan.alpha_only:
                        with annotate("sink"):
                            writers["alpha"].write(np.array(out[i, :fh, :fw]))
                        continue
                    if not writers:
                        continue
                    rgba = unpack_rgba(out[i, :fh, :fw])
                    for name, arr in (("alpha", rgba[..., 3]),
                                      ("fgr", rgba[..., :3]), ("comp", rgba)):
                        if name in writers:
                            with annotate("sink"):
                                writers[name].write(arr)
            b.outs.release(handle)

        def send_bgs(n):
            """The next n backgrounds of a background video, staged and
            sent to the device as one copy; None without one."""
            if bg_src is None:
                return None
            slot = b.bgs.slot()
            for j in range(n):
                slot[j].copy_(torch.from_numpy(bg_src.next()[0]))
            return b.bgs.send(n)

        @spanned("eager")
        def frame_body(frames, bgs):
            """Run the per-frame body eagerly over the (N, h, w, C) device
            frames in order; returns their device-to-host handle."""
            nonlocal state
            i = None
            for j in range(frames.shape[0]):
                args = (frames[j:j + 1], state)
                if bgs is not None:
                    args += (bgs[j:j + 1],)
                out, state = b.body(*args)
                if i is None:
                    i = b.outs.open(out)
                b.outs.put(i, j, out)
            return b.outs.close(i, frames.shape[0], isinstance(out, tuple))

        def chunk_body(frames, bgs):
            """One full chunk: the graph's replay once captured; eagerly
            (and then captured, on CUDA) before."""
            nonlocal state, capture_ms, replays
            if b.graph is not None:
                out, state = b.graph(state)
                replays += 1
            else:
                ins = (frames,) if bgs is None else (frames, bgs)
                with annotate("eager"):
                    out, state = b.chunk(*ins, state)
            i = b.outs.open(out)
            b.outs.put(i, 0, out)
            handle = b.outs.close(i, frames.shape[0], isinstance(out, tuple))
            if (b.graph is None and self.device.type == "cuda"
                    and self.capture and not b.plan.static_skip):
                ins = (b.frames.dev if bgs is None
                       else (b.frames.dev, b.bgs.dev))
                with annotate("capture", timed=True) as span:
                    b.graph = ChunkGraph(b.chunk, ins, state)
                state = b.graph.state
                capture_ms = span.ms
            return handle

        def observe(k):
            nonlocal t_prev
            t_now = time.perf_counter()
            if k > 1:
                metrics.record_chunk(t_now - t_prev, k)
            else:
                metrics.record_frame(t_now - t_prev)
            t_prev = t_now

        k = max(1, self.pipe_cfg.chunk_size)
        staged = n = 0
        setup_ms = 0.0
        t_prev = time.perf_counter()
        for frame in source:
            if tri_iter is not None:
                tri = next(tri_iter, None)
                if tri is None:
                    if not cfg.recurrent:
                        raise ValueError(
                            f"trimap stream ended at frame {n + staged} but "
                            "the input continues: the per-frame trimap "
                            "family needs a trimap for every converted "
                            "frame (the recurrent propagation family "
                            "continues on all-unknown trimaps instead)")
                    # Past the annotated prefix: all-unknown (128), the
                    # GRU carries the constraint forward.
                    tri = np.full(frame.shape[:2], 128, np.uint8)
                frame = attach_trimap(frame, tri, n + staged)
            if b is None:
                t0 = time.perf_counter()
                fh, fw = frame.shape[:2]
                # Ratio: explicit argument > PipelineConfig > heuristic.
                ratio = self.downsample_ratio
                if ratio is None:
                    ratio = self.pipe_cfg.downsample_ratio
                if ratio is None:
                    ratio = auto_downsample_ratio(fh, fw)
                ph, pw = fh + ((-fh) % 16), fw + ((-fw) % 16)
                b = self._build_step(
                    ph, pw, ratio, need_fgr=bool(output_foreground),
                    alpha_only=bool(output_alpha)
                    and not output_foreground and not output_composition)
                state = b.plan.make_state(1)
                if self._bg_dynamic:
                    bg_src = BgFrameSource(self.bg_video, ph, pw)
                for name, target in (("alpha", output_alpha),
                                     ("fgr", output_foreground),
                                     ("comp", output_composition)):
                    if target:
                        writers[name] = open_sink(target, source.fps)
                crop = (fh, fw)
                # Set-up (the body, the staging buffers' pinning) stays in
                # the first observation and is also reported apart.
                setup_ms = (time.perf_counter() - t0) * 1e3
            if staged == 0:
                host = b.frames.slot().numpy()
            pad_into(frame, host[staged])
            staged += 1
            if staged < k:
                continue
            with annotate("enqueue"):
                frames = b.frames.send(k)
                handle = chunk_body(frames, send_bgs(k))
            staged = 0
            if pending is not None:
                flush(pending)  # the host writes group t-1 while t computes
            pending = handle
            n += k
            observe(k)
            if progress and n % 50 < k:
                print(f"frame {n}", flush=True)

        # Drain a partial last chunk per frame; each drained frame records
        # its time so the fps denominator includes the tail.
        if staged:
            for j in range(staged):
                with annotate("enqueue"):
                    if j == 0:
                        frames = b.frames.send(staged)
                        bgs = send_bgs(staged)
                    handle = frame_body(frames[j:j + 1],
                                        None if bgs is None
                                        else bgs[j:j + 1])
                if pending is not None:
                    flush(pending)
                pending = handle
                n += 1
                observe(1)
        if pending is not None:
            flush(pending)
        for wtr in writers.values():
            wtr.close()
        out = metrics.summary()
        out["frames"] = n
        out["dropped_frames"] = source.dropped
        out["setup_ms"] = setup_ms
        if capture_ms is not None:
            out["graph_capture_ms"] = capture_ms
            out["setup_ms"] += capture_ms
        if b is not None and b.graph is not None:
            out["graph_replays"] = replays
            out["graph_launches_per_replay"] = b.graph.launches_per_replay()
        if b is not None and b.plan.static_skip:
            out["static_skipped"] = state[1][3]
        out["device"] = (torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else "cpu")
        return out
