"""vidmat_torch — the PyTorch / CUDA port of vidmat for NVIDIA Hopper.

A second package beside ``vidmat`` (the JAX reference, which it never
imports). ``matte_image`` mattes one image in float32 (the base, trimap
and clean-plate families); ``convert_video`` serves the JAX package's
defaults and the ``video_1080p``, ``video_4k`` (tiled) and ``clip_480p``
presets, with color, image, video and portrait-blur backgrounds, the
clean-plate family, trimap video (from trimaps or rough masks) and the
segmentation stream, the planar chunk body as one CUDA graph launch per
chunk; ``MattingSession`` streams float mattes (or segmentation masks).
The public surface is the JAX package's, name for name; what is not
ported yet (error-map refinement, multi-stream serving) raises
NotImplementedError naming its ROADMAP item. Every TPU kernel of those paths
(ingest, the planar convs, guided-filter coefficients, the refine tails,
composite) runs as a hand-written CUDA kernel (``vidmat_torch/csrc``).
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from vidmat_torch.api import (MattingSession, convert_video,  # noqa: F401
                              matte_image)
from vidmat_torch.config import (PRESETS, ModelConfig,  # noqa: F401
                                 PipelineConfig, RefineConfig, StreamConfig,
                                 preset_clip_480p, preset_multistream,
                                 preset_pr1_image, preset_video_1080p,
                                 preset_video_1080p_errormap,
                                 preset_video_4k)
