"""Typed configuration for the PyTorch port (counterpart of vidmat/config.py).

The dataclasses keep every field name and default of the JAX package so a
configuration reads the same in both. The port carries its own copy: it
imports nothing from ``vidmat``.

The defaults are the JAX package's: ``ModelConfig()`` (s2d=1, the net as
``F.conv2d``, shipped ``synthetic_demo`` weights) and ``PipelineConfig()``
(auto ratio, chunk 1, bfloat16, guided refinement) are what
``convert_video`` serves when given no configuration. The presets, as the
JAX package ships them: ``preset_video_1080p`` (``fast_demo``, s2d=2,
pool 4), ``preset_video_4k`` (the same model at pool 8, tiled
refinement), ``preset_clip_480p`` (``synthetic_demo`` at full resolution),
``preset_pr1_image`` (the single-image rung),
``preset_video_1080p_errormap`` (error-map refinement with the shipped
``errormap_demo`` refiner on ``synthetic_demo``) and
``preset_multistream`` (with a ``StreamConfig``: 8 streams served as one
batch by ``MultiStreamMatting``; a pipeline built from it raises
``TypeError`` naming that class). ``conv_impl="planar"`` runs the net
through the four planar conv kernels (``vidmat_torch/models/planar.py``);
``conv_impl="xla"`` runs the same variables as ``F.conv2d``
(``vidmat_torch/models/matting_net.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for the recurrent matting network."""

    # Encoder channels at strides 2/4/8/16.
    enc_channels: Tuple[int, int, int, int] = (16, 24, 40, 64)
    # Decoder channels at strides 8/4/2/1.
    dec_channels: Tuple[int, int, int, int] = (48, 32, 24, 16)
    # Trimap variant: extra input channel carrying {0, 0.5, 1}.
    use_trimap: bool = False
    # Clean-plate variant: three extra input channels (plate RGB).
    use_bg_plate: bool = False
    # Split-half ConvGRU recurrence in each decoder stage.
    recurrent: bool = True
    bn_eps: float = 1e-5
    # Space-to-depth input packing factor (1 = off, 2 = 2x2 pixels into
    # channels, channel order [dy, dx, c]).
    space_to_depth: int = 1
    # "xla": plain convolutions (F.conv2d in the port). "planar": the net
    # through the planar conv kernels (PlanarNetwork), BatchNorm folded.
    conv_impl: str = "xla"

    @property
    def in_channels(self) -> int:
        # RGB, then the trimap byte, then the plate RGB.
        return 3 + (1 if self.use_trimap else 0) + (
            3 if self.use_bg_plate else 0)


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Alpha refinement options."""

    mode: str = "guided"  # "none" | "guided" | "errormap"
    guided_radius: int = 4
    guided_eps: float = 1e-4
    # error-map path: number of worst patches refined at full resolution,
    # and their size
    errormap_patches: int = 256
    errormap_patch_size: int = 16


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Video pipeline configuration."""

    # Coarse-pass scale; None = auto from resolution.
    downsample_ratio: Optional[float] = None
    # Frames per dispatch group: one chunk-batched call on the planar net
    # (ServingPlan.chunk_body), else a loop over the per-frame body.
    chunk_size: int = 1
    # Compute dtype of the conv path.
    dtype: str = "bfloat16"
    refine: RefineConfig = dataclasses.field(default_factory=RefineConfig)
    # Tiled refinement (4K): tile size and overlap at full resolution.
    # The fused tails take per-coarse-tile guided-filter statistics with
    # the coefficient grids feather-blended (refine/tiling.py).
    tile_size: Optional[int] = None  # None = no tiling
    tile_overlap: int = 64
    # Background for compositing, declared as in the JAX package, which
    # reads it nowhere either (convert_video takes bg_color).
    composite_bg: Optional[Tuple[float, float, float]] = None
    # The serving kernels: None or True = on (the CUDA kernels on CUDA
    # tensors, their plain versions on CPU tensors); False = the branch
    # the JAX package takes without its kernels: no fused tail, the
    # uint8 tuple instead of packed words, every stage on its plain
    # version and the net as F.conv2d.
    use_pallas: Optional[bool] = None
    # Static-scene fast path: when the ingested coarse frame's mean abs
    # delta against the frame the cached coefficients came from is <= eps
    # (in [0, 1] units, e.g. 0.5/255), the net and the guided-filter
    # coefficients are skipped and the cache reused; the tail still runs
    # on the current frame. None = off. Batch-1 fused tails only.
    static_skip_eps: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Multi-stream serving configuration: S streams of one (height,
    width) bucket, served by ``MultiStreamMatting``."""

    num_streams: int = 8
    height: int = 1088  # padded 1080p (the /16 bucket)
    width: int = 1920
    downsample_ratio: float = 0.25


def preset_pr1_image() -> tuple[ModelConfig, PipelineConfig]:
    """512x512 single-image matting, optional trimap (the rung
    ``matte_image`` serves): float32, full resolution, no refinement
    (vidmat/config.py ``preset_pr1_image``)."""
    return ModelConfig(recurrent=False), PipelineConfig(
        downsample_ratio=1.0, dtype="float32",
        refine=RefineConfig(mode="none"))


def preset_video_1080p() -> tuple[ModelConfig, PipelineConfig]:
    """1080p recurrent serving with guided-filter refinement.

    The s2d=2 model (shipped ``fast_demo`` weights) at downsample ratio
    0.25 (pool 4 on a 1088x1920 bucket), guided refinement, chunk 4
    (chunk-batched: ingest, encoder, guided-filter coefficients and the
    fused tail once per chunk, the recurrent decoder per frame). The net
    runs through the planar conv kernels (``conv_impl="planar"``, as in
    vidmat/config.py); ingest, guided-filter and refine/composite run as
    hand-written CUDA kernels too."""
    return ModelConfig(space_to_depth=2, conv_impl="planar"), PipelineConfig(
        downsample_ratio=0.25, chunk_size=4,
        refine=RefineConfig(mode="guided"))


def preset_clip_480p() -> tuple[ModelConfig, PipelineConfig]:
    """A 480p clip with temporal propagation at full resolution.

    The s2d=1 model (shipped ``synthetic_demo`` weights) through the planar
    conv kernels, ratio 1.0 (the net runs on the frame itself), no
    refinement, chunk 10 (a loop of the per-frame body: the full-resolution
    tail has no chunk body); the float mattes are packed by the
    ``composite_rgba_packed`` kernel (vidmat/config.py
    ``preset_clip_480p``)."""
    return ModelConfig(conv_impl="planar"), PipelineConfig(
        downsample_ratio=1.0, chunk_size=10, refine=RefineConfig(mode="none"))


def preset_video_1080p_errormap() -> tuple[ModelConfig, PipelineConfig]:
    """1080p recurrent with error-map patch refinement on the s2d=1 model
    (vidmat/config.py ``preset_video_1080p_errormap``): the refiner
    (``refine/errormap.py``, shipped ``errormap_demo``) refines the 256
    worst 16x16 patches of the upsampled alpha; no chunk body, so each
    chunk is four calls of the per-frame body (one CUDA graph on the
    card)."""
    return ModelConfig(conv_impl="planar"), PipelineConfig(
        downsample_ratio=0.25, chunk_size=4,
        refine=RefineConfig(mode="errormap"))


def preset_video_4k() -> tuple[ModelConfig, PipelineConfig]:
    """4K tiled inference with overlap blending: the ``video_1080p`` model
    (s2d=2, planar) at ratio 0.125, tiles of 1024 with an overlap of 128,
    chunk 1 (vidmat/config.py ``preset_video_4k``). The coarse grid snaps
    to multiples of 16: a 3840x2176 frame gives 272x480, pool 8, and the
    tiled fused tail; a 3840x2160 one (its /16 bucket keeps 2160) also
    gives 272x480, which is no integer pool of it, so it takes the untiled
    guided tail, as in the JAX package."""
    return ModelConfig(space_to_depth=2, conv_impl="planar"), PipelineConfig(
        downsample_ratio=0.125, chunk_size=1,
        refine=RefineConfig(mode="guided"), tile_size=1024, tile_overlap=128)


def preset_multistream() -> tuple[ModelConfig, PipelineConfig, StreamConfig]:
    """8 concurrent 1080p streams on one card: the ``video_1080p`` pair at
    chunk 1 and a ``StreamConfig`` (vidmat/config.py
    ``preset_multistream``), served by ``MultiStreamMatting`` (each round
    the per-frame body on an (8, 1088, 1920, 3) batch)."""
    m, p = preset_video_1080p()
    return m, dataclasses.replace(p, chunk_size=1), StreamConfig()


#: the JAX package's presets, by its names
PRESETS = {
    "pr1_image": preset_pr1_image,
    "clip_480p": preset_clip_480p,
    "video_1080p": preset_video_1080p,
    "video_1080p_errormap": preset_video_1080p_errormap,
    "video_4k": preset_video_4k,
    "multistream": preset_multistream,
}
