"""vidmat_torch — the PyTorch / CUDA port of vidmat for NVIDIA Hopper.

A second package beside ``vidmat`` (the JAX reference, which it never
imports). It serves the ``video_1080p`` configuration: ingest,
guided-filter coefficients and the fused refine/composite tail run as
hand-written CUDA kernels (``vidmat_torch/csrc``), the matting net as
PyTorch convolutions. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""

from vidmat_torch.api import convert_video  # noqa: F401
from vidmat_torch.config import (ModelConfig, PipelineConfig,  # noqa: F401
                                 RefineConfig, preset_video_1080p)
