"""Matting evaluation (MAD/MSE/SAD/Grad/Conn/dtSSD), the counterpart of
vidmat/eval: see ``eval.metrics``."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from vidmat_torch.eval.metrics import (ALL_METRICS, VideoEval,
                                       connectivity_error,
                                       evaluate_sequences, scale_metric,
                                       trimap_unknown_region)

__all__ = ["ALL_METRICS", "VideoEval", "connectivity_error",
           "evaluate_sequences", "scale_metric", "trimap_unknown_region",
           "alpha_frames", "rgb_frames"]


def rgb_frames(path: str) -> Iterator[np.ndarray]:
    """Iterate (H, W, 3) frames from a video file, image dir, printf
    pattern, or glob (used for the foreground-color metric)."""
    from vidmat_torch.io.reader import VideoReader, image_sequence

    seq = image_sequence(path)
    frames = seq if seq is not None else VideoReader(path)
    yield from frames


def alpha_frames(path: str) -> Iterator[np.ndarray]:
    """Iterate single-channel alpha frames from a video file, an image
    directory, a printf pattern, or a glob (the source forms
    convert_video takes). Multi-channel frames reduce to channel 0: alpha
    videos and PNGs are gray by contract, so any channel is the matte."""
    from vidmat_torch.io.reader import VideoReader, image_sequence

    seq = image_sequence(path)
    frames = seq if seq is not None else VideoReader(path)
    for f in frames:
        f = np.asarray(f)
        if f.ndim == 3:
            f = f[..., 0]
        yield f
