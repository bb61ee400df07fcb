"""Public API of the port: video in -> per-frame alpha matte out
(counterpart of vidmat/api.py ``convert_video``).

The port serves the ``video_1080p`` configuration (``fast_demo`` weights,
pool-4 coarse pass, guided refinement, packed output). ``matte_image``,
the streaming API and the conditioned families are not ported yet
(ROADMAP queue A).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig

Target = Union[str, Callable[[np.ndarray], None]]


def convert_video(input_source: Union[str, Iterable[np.ndarray]],
                  output_alpha: Optional[Target] = None,
                  output_foreground: Optional[Target] = None,
                  output_composition: Optional[Target] = None,
                  bg_color: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                  downsample_ratio: Optional[float] = None,
                  variables=None,
                  model_cfg: Optional[ModelConfig] = None,
                  pipe_cfg: Optional[PipelineConfig] = None,
                  progress: bool = False,
                  start_frame: int = 0,
                  max_frames: Optional[int] = None,
                  device: Union[str, torch.device] = "cuda") -> dict:
    """Convert a video to alpha / composited streams.

    input_source: a video path (needs cv2) or an iterable of (H, W, 3)
        uint8 RGB frames.
    output_*: optional targets, each a video path (needs cv2) or a
        callable that receives every (H, W[, C]) uint8 frame. Without any,
        frames are processed and metrics returned (benchmark mode).
        output_foreground (raw foreground) is not ported yet (ROADMAP A.6).
    bg_color: background of the composition output.
    downsample_ratio: coarse-pass scale; None = the preset's 0.25.
    variables: network weights (nested numpy dict in the JAX package's
        layout); None = the shipped ``fast_demo`` weights.
    model_cfg / pipe_cfg: default to ``preset_video_1080p()``.
    start_frame / max_frames: trim the input (temporal state starts cold
        at the trim point).
    device: "cuda" (default; raises without a CUDA device) or "cpu".
    Returns a metrics dict (fps, p50/p99 latency, frames, device).
    """
    from vidmat_torch.pipeline.video import VideoPipeline

    pipeline = VideoPipeline(
        model_cfg=model_cfg, pipe_cfg=pipe_cfg, variables=variables,
        downsample_ratio=downsample_ratio,
        bg_color=bg_color if output_composition else None, device=device)
    return pipeline.run(input_source, output_alpha=output_alpha,
                        output_foreground=output_foreground,
                        output_composition=output_composition,
                        progress=progress, start_frame=start_frame,
                        max_frames=max_frames)
