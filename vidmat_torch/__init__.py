"""vidmat_torch — the PyTorch / CUDA port of vidmat for NVIDIA Hopper.

A second package beside ``vidmat`` (the JAX reference, which it never
imports). ``convert_video`` serves the JAX package's defaults and the
``video_1080p`` and ``clip_480p`` presets, with color, image, video and
portrait-blur backgrounds and the clean-plate family; ``MattingSession``
streams float mattes. Every TPU kernel of those paths (ingest, the planar
convs, guided-filter coefficients, the refine tails, composite) runs as a
hand-written CUDA kernel (``vidmat_torch/csrc``). Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

from vidmat_torch.api import MattingSession, convert_video  # noqa: F401
from vidmat_torch.config import (ModelConfig, PipelineConfig,  # noqa: F401
                                 RefineConfig, preset_clip_480p,
                                 preset_video_1080p)
