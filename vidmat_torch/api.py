"""Public API of the port (counterpart of vidmat/api.py ``matte_image``,
``convert_video`` and ``MattingSession``).

``matte_image`` mattes one image in float32: the recurrent base model for
one frame from a zero state, the trimap model (``trimap_demo``) given a
trimap or a rough mask, or the clean-plate model given a plate.
``convert_video`` serves the JAX package's defaults (``ModelConfig()``,
``PipelineConfig()``) when given no configuration, and the presets
(``preset_video_1080p``, ``preset_video_4k``, ``preset_clip_480p``,
``preset_video_1080p_errormap`` with the error-map refiner) when given
theirs; trimap video (``trimap_source``, or rough masks through
``mask_source``) and the segmentation stream (``output_segmentation``).
``MattingSession`` streams float mattes one frame at a time (tiled, with
trimaps, or the segmentation mask with ``output="seg"``). Both take the
clean-plate family (``bg_plate``, shipped ``plate_demo``);
``convert_video`` composites over a color, an image, a background video
or a blur of the source frame. The signatures are the JAX package's, plus
``device``; a ``StreamConfig`` raises TypeError naming
``MultiStreamMatting``, the class that serves it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig

Target = Union[str, Callable[[np.ndarray], None]]


def matte_image(image: np.ndarray, trimap: Optional[np.ndarray] = None,
                variables=None, cfg: Optional[ModelConfig] = None,
                mask: Optional[np.ndarray] = None,
                mask_band: float = 0.04,
                bg_plate: Optional[np.ndarray] = None,
                device: Union[str, torch.device] = "cuda",
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Single-image matting in float32 (the ``preset_pr1_image`` rung).

    image:  (H, W, 3) float [0, 1] or uint8 RGB; H and W need not be
            multiples of 16 (padded inside).
    trimap: optional (H, W[, 1]) trimap {0, 0.5, 1}.
    mask:   optional rough binary mask (H, W); turned into a trimap with an
            unknown band of half-width ``mask_band`` across its boundary
            (``pipeline.trimap.trimap_from_mask``) and matted with the
            trimap family. Exclusive with trimap.
    bg_plate: optional clean background plate (H, W, 3): selects the
            plate-conditioned family (shipped plate_demo).
    device: "cuda" (default; raises without a CUDA device) or "cpu".
    Returns (alpha (H, W, 1), fgr (H, W, 3)) float32 in [0, 1] on the
    host.

    With ``variables=None`` the shipped checkpoint is loaded: synthetic_demo
    (the recurrent base model, run for one frame from a zero state),
    trimap_demo with a trimap or mask, plate_demo with a plate. The
    signature and the choice are the JAX package's, plus ``device``."""
    from vidmat_torch.pipeline.stepper import ImageStepper

    if mask is not None:
        if trimap is not None:
            raise ValueError("pass either trimap or mask, not both")
        from vidmat_torch.pipeline.trimap import trimap_from_mask

        trimap = trimap_from_mask(mask, band=mask_band)
    if cfg is None:
        if bg_plate is not None:
            if trimap is not None:
                raise ValueError(
                    "no shipped checkpoint combines trimap AND plate "
                    "conditioning: pass cfg/variables explicitly for a "
                    "custom-trained combined model")
            from vidmat_torch.models.weights import plate_default_config

            cfg = plate_default_config()
        elif variables is None and trimap is None:
            cfg = ModelConfig()  # recurrent base: shipped synthetic_demo
        else:
            cfg = ModelConfig(recurrent=False, use_trimap=trimap is not None)
    stepper = ImageStepper(cfg, variables=variables, device=device)
    return stepper(image, trimap, bg_plate=bg_plate)


def _mask_to_trimap_source(mask_source, band: float, start: int = 0,
                           count: Optional[int] = None):
    """A mask source as a trimap source (vidmat/api.py:75-100): one
    keyframe mask (image path or array) becomes one trimap; a per-frame
    mask stream becomes a lazy stream of trimaps, trimmed to [start,
    start + count) before the conversion and marked pre-trimmed."""
    from vidmat_torch.io.reader import FrameSource
    from vidmat_torch.pipeline.trimap import (PreTrimmedTrimaps,
                                              single_trimap,
                                              trimap_from_mask)

    single = single_trimap(mask_source)
    if single is not None:
        return trimap_from_mask(single, band=band)

    def gen():
        for m in FrameSource(mask_source, start=start, count=count):
            yield trimap_from_mask(m, band=band)

    return PreTrimmedTrimaps(gen())


def convert_video(input_source: Union[str, Iterable[np.ndarray]],
                  output_alpha: Optional[Target] = None,
                  output_foreground: Optional[Target] = None,
                  output_composition: Optional[Target] = None,
                  bg_color: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                  bg_image: Optional[Union[str, np.ndarray]] = None,
                  bg_video: Optional[Union[str, Iterable[np.ndarray]]] = None,
                  bg_blur: Optional[int] = None,
                  bg_plate: Optional[Union[str, np.ndarray]] = None,
                  downsample_ratio: Optional[float] = None,
                  variables=None,
                  model_cfg: Optional[ModelConfig] = None,
                  pipe_cfg: Optional[PipelineConfig] = None,
                  refiner_variables=None,
                  progress: bool = False,
                  start_frame: int = 0,
                  max_frames: Optional[int] = None,
                  trimap_source=None,
                  mask_source=None,
                  mask_band: float = 0.04,
                  output_segmentation: Optional[Target] = None,
                  device: Union[str, torch.device] = "cuda") -> dict:
    """Convert a video to alpha / composited streams.

    input_source: a video path (needs cv2) or an iterable of (H, W, 3)
        uint8 RGB frames.
    output_*: optional targets, each a video path (needs cv2) or a
        callable that receives every (H, W[, C]) uint8 frame. Without any,
        frames are processed and metrics returned (benchmark mode).
    bg_color: background of the composition output.
    bg_image: background-replacement image of the composition (path or
        (H, W, 3) array, uint8 or float in [0, 1]); takes precedence over
        bg_color.
    bg_video: per-frame background of the composition (video path or
        iterable of (H, W, 3) frames, consumed in lockstep with the input
        and looped if shorter); takes precedence over bg_image.
    bg_blur: portrait blur: composite over a blur of the source frame of
        this radius in full-resolution pixels (e.g. 16); takes precedence
        over bg_video. The background options apply only with
        output_composition.
    bg_plate: clean-plate conditioning: an image of the scene without the
        subject (path or (H, W, 3) array), an input of the
        plate-conditioned net. With model_cfg=None it selects that family
        (``ModelConfig(use_bg_plate=True, space_to_depth=2)``, shipped
        plate_demo weights).
    downsample_ratio: coarse-pass scale; None = pipe_cfg's, else auto
        from the resolution.
    variables: network weights (nested numpy dict in the JAX package's
        layout); None = the shipped weights of model_cfg (``synthetic_demo``
        for s2d=1, ``fast_demo`` for s2d=2).
    model_cfg / pipe_cfg: default to ``ModelConfig()`` and
        ``PipelineConfig()``, as in the JAX package.
    refiner_variables: the error-map refiner's weights (nested numpy
        dict in the JAX package's layout) for ``refine.mode="errormap"``
        (``preset_video_1080p_errormap``); None = the shipped
        errormap_demo. Ignored in the other modes, as in the JAX package.
    start_frame / max_frames: trim the input (temporal state starts cold
        at the trim point).
    trimap_source: trimaps for trimap-conditioned matting: a per-frame
        stream (video path, image directory or pattern, iterable),
        trimmed as the input is (with model_cfg=None: the per-frame
        family, ``trimap_demo``), or one keyframe trimap (image path or
        (H, W) array: the recurrent propagation family,
        ``trimap_prop_demo``, which carries it forward over all-unknown
        trimaps). uint8 {0, 128, 255} or float {0, 0.5, 1}.
    mask_source: rough binary masks in place of trimaps, in the same two
        shapes; each becomes a trimap with an unknown band of half-width
        ``mask_band`` across its boundary. Exclusive with trimap_source.
    output_segmentation: the co-trained segmentation head's mask stream
        (a video path or a callable receiving (H, W, 3) uint8 frames) in
        place of the matting outputs (shipped ``seg_demo`` with
        variables=None); exclusive with the matting outputs, the
        backgrounds and the conditioned families.
    device: "cuda" (default; raises without a CUDA device) or "cpu".
    Returns a metrics dict (fps, p50/p99 latency, frames, device).
    """
    from vidmat_torch.pipeline.video import VideoPipeline, single_trimap

    if output_segmentation is not None:
        if output_alpha or output_foreground or output_composition:
            raise ValueError(
                "output_segmentation runs the seg head in place of the "
                "matting heads (one pass, one head); request the matting "
                "outputs in a separate convert_video call")
        if (trimap_source is not None or mask_source is not None
                or bg_plate is not None):
            raise ValueError(
                "the shipped co-trained segmentation head covers the "
                "unconditioned base family; conditioned segmentation "
                "needs a custom co-trained model_cfg/variables and is "
                "not selected implicitly")
        return _segment_video(input_source, output_segmentation,
                              variables=variables, model_cfg=model_cfg,
                              downsample_ratio=downsample_ratio,
                              progress=progress, start_frame=start_frame,
                              max_frames=max_frames, device=device)
    if mask_source is not None:
        if trimap_source is not None:
            raise ValueError("pass either trimap_source or mask_source, "
                             "not both")
        trimap_source = _mask_to_trimap_source(
            mask_source, mask_band, start=start_frame, count=max_frames)
    if trimap_source is not None:
        keyframe = single_trimap(trimap_source)
        if keyframe is not None:
            trimap_source = keyframe  # read once here
        if model_cfg is None:
            if bg_plate is not None:
                raise ValueError(
                    "no shipped checkpoint combines trimap AND plate "
                    "conditioning: pass model_cfg/variables explicitly "
                    "for a custom-trained combined model")
            model_cfg = (ModelConfig(use_trimap=True, space_to_depth=2)
                         if keyframe is not None else
                         ModelConfig(use_trimap=True, recurrent=False))
    if bg_plate is not None and model_cfg is None:
        from vidmat_torch.models.weights import plate_default_config

        model_cfg = plate_default_config()
    comp = bool(output_composition)
    pipeline = VideoPipeline(
        model_cfg=model_cfg, pipe_cfg=pipe_cfg, variables=variables,
        downsample_ratio=downsample_ratio,
        bg_color=bg_color if comp else None,
        bg_image=bg_image if comp else None,
        bg_video=bg_video if comp else None,
        bg_blur=bg_blur if comp else None,
        bg_plate=bg_plate, refiner_variables=refiner_variables,
        device=device)
    return pipeline.run(input_source, output_alpha=output_alpha,
                        output_foreground=output_foreground,
                        output_composition=output_composition,
                        progress=progress, start_frame=start_frame,
                        max_frames=max_frames, trimap_source=trimap_source)


def _segment_video(input_source, target: Target, *, variables, model_cfg,
                   downsample_ratio, progress, start_frame, max_frames,
                   device) -> dict:
    """The segmentation stream of ``convert_video(output_segmentation=)``
    (vidmat/api.py:262-316): a segmentation ``VideoStepper`` per frame,
    bf16 on the card and float32 on the CPU (the JAX package picks by its
    backend), each mask written as an (H, W, 3) uint8 frame."""
    import time

    from vidmat_torch._device import resolve_device
    from vidmat_torch.io.reader import FrameSource
    from vidmat_torch.io.writer import open_sink
    from vidmat_torch.pipeline.stepper import VideoStepper, pad_to_multiple
    from vidmat_torch.pipeline.video import auto_downsample_ratio
    from vidmat_torch.utils.metrics import RunMetrics

    dev = resolve_device(device)
    cfg = model_cfg or ModelConfig()
    src = FrameSource(input_source, start=start_frame, count=max_frames)
    stepper = writer = None
    metrics = RunMetrics()
    n = 0
    try:
        for frame in src:
            padded, h, w = pad_to_multiple(np.asarray(frame),
                                           16 * cfg.space_to_depth)
            if stepper is None:
                ratio = (auto_downsample_ratio(*padded.shape[:2])
                         if downsample_ratio is None else downsample_ratio)
                stepper = VideoStepper(
                    cfg, padded.shape[0], padded.shape[1],
                    variables=variables, downsample_ratio=ratio,
                    dtype="bfloat16" if dev.type == "cuda" else "float32",
                    output="seg", device=dev)
                writer = open_sink(target, src.fps)
            t0 = time.perf_counter()
            mask, _ = stepper.step(padded)
            metrics.record_frame(time.perf_counter() - t0)
            m8 = np.round(mask[:h, :w, 0] * 255.0).astype(np.uint8)
            writer.write(np.repeat(m8[..., None], 3, axis=-1))
            n += 1
            if progress and n % 50 == 0:
                print(f"segmented {n} frames", flush=True)
    finally:
        if writer is not None:
            writer.close()
    summary = metrics.summary()
    summary["frames"] = n
    summary["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu")
    return summary


class MattingSession:
    """Streaming API: push frames, pull (alpha, fgr); the temporal state
    stays on the device between calls.

    >>> sess = MattingSession(1088, 1920, device="cuda")
    >>> for frame in frames:
    ...     alpha, fgr = sess.step(frame)

    The signature is the JAX package's, plus ``device`` ("cuda", the
    default, raises without a CUDA device; "cpu" runs the plain PyTorch
    versions of the kernels). dtype="float32" is the parity mode (no
    kernels); dtype="bfloat16" the serving mode (see
    ``pipeline.stepper.VideoStepper``). bg_plate: the clean plate of the
    plate-conditioned family, fixed for the session (with model_cfg=None
    it selects ``plate_default_config()``, shipped plate_demo).
    tile_size / tile_overlap: tiled refinement (e.g. 1024 / 128, the
    ``video_4k`` preset's). output="seg": the co-trained segmentation
    head (shipped seg_demo with variables=None); ``step`` then returns
    (mask (H, W, 1) float32, None)."""

    def __init__(self, height: int, width: int,
                 variables=None, model_cfg: Optional[ModelConfig] = None,
                 downsample_ratio: float = 1.0, dtype: str = "float32",
                 static_skip_eps: Optional[float] = None,
                 tile_size: Optional[int] = None,
                 tile_overlap: int = 128,
                 bg_plate: Optional[np.ndarray] = None,
                 output: str = "matte",
                 device: Union[str, torch.device] = "cuda"):
        from vidmat_torch.pipeline.stepper import VideoStepper

        if bg_plate is not None and model_cfg is None:
            from vidmat_torch.models.weights import plate_default_config

            model_cfg = plate_default_config()
        self._stepper = VideoStepper(
            model_cfg or ModelConfig(), height, width, variables=variables,
            downsample_ratio=downsample_ratio, dtype=dtype,
            static_skip_eps=static_skip_eps, tile_size=tile_size,
            tile_overlap=tile_overlap, bg_plate=bg_plate, output=output,
            device=device)

    def step(self, frame: np.ndarray, trimap: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """frame: (H, W, 3) uint8 or float RGB; trimap: (H, W) uint8 {0,
        128, 255} or float {0, 0.5, 1}, for trimap-conditioned models
        only: the per-frame family (trimap_demo) needs one every step, the
        recurrent propagation family (trimap_prop_demo) takes one on
        keyframes and an all-unknown one (filled in) in between. Returns
        (alpha (H, W, 1), fgr (H, W, 3)) float32 in [0, 1] on the host, or
        (mask, None) with output="seg"."""
        return self._stepper.step(frame, trimap)

    def reset(self) -> None:
        """Reset the temporal state (scene cut, new stream)."""
        self._stepper.reset()

    def save_state(self, path: str, frame_index: int = 0) -> None:
        """Write the temporal carry to the npz file ``path``."""
        self._stepper.save_state(path, frame_index)

    def load_state(self, path: str) -> int:
        """Restore a carry written by save_state; returns its frame
        index."""
        return self._stepper.load_state(path)
