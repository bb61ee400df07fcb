"""vidmat_torch — the PyTorch / CUDA port of vidmat for NVIDIA Hopper.

A second package beside ``vidmat`` (the JAX reference, which it never
imports). ``matte_image`` mattes one image in float32 (the base, trimap
and clean-plate families); ``convert_video`` serves the JAX package's
defaults and the ``video_1080p``, ``video_1080p_errormap``, ``video_4k``
(tiled) and ``clip_480p`` presets, with color, image, video and
portrait-blur backgrounds, the clean-plate family, trimap video (from
trimaps or rough masks) and the segmentation stream, every full chunk as
one CUDA graph launch; ``MattingSession`` streams float mattes (or
segmentation masks); ``MultiStreamMatting`` serves S streams as one
batch (the ``multistream`` preset) and ``RealtimeMatting`` a live source
with latest-wins scheduling. ``vidmat_torch.deploy`` exports a serving
body as an AOT bundle (``export_bundle``, ``torch.export``) and serves it
without the model definition (``ServingBundle``); ``vidmat_torch.eval``
scores mattes (``VideoEval``, ``evaluate_sequences``);
``python -m vidmat_torch.cli`` is the command line (nine subcommands);
``vidmat_torch.train`` trains (the BPTT step, segmentation co-training,
the refiner's trainer). The public surface is the JAX package's, name
for name; what is not ported yet (the parts of multi-stream serving and
training that need more than one card) raises naming its ROADMAP item.
Every TPU kernel of those paths (ingest, the planar convs, guided-filter
coefficients, the refine tails, composite) runs as a hand-written CUDA
kernel (``vidmat_torch/csrc``), registered as a ``vidmat_torch::*``
custom op (``ops/library.py``). Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

from vidmat_torch._exports import lazy_exports
from vidmat_torch.api import (MattingSession, convert_video,  # noqa: F401
                              matte_image)
from vidmat_torch.config import (PRESETS, ModelConfig,  # noqa: F401
                                 PipelineConfig, RefineConfig, StreamConfig,
                                 preset_clip_480p, preset_multistream,
                                 preset_pr1_image, preset_video_1080p,
                                 preset_video_1080p_errormap,
                                 preset_video_4k)

# The JAX package's lazy exports (vidmat/__init__.py), imported on first
# use; what needs more than one card raises naming its ROADMAP item.
__getattr__ = lazy_exports(
    {"MultiStreamMatting": "vidmat_torch.parallel.multistream",
     "RealtimeMatting": "vidmat_torch.pipeline.realtime",
     "MattingNetwork": "vidmat_torch.models.matting_net",
     "trimap_from_mask": "vidmat_torch.pipeline.trimap"},
    multi_card=("make_mesh", "PipelinedMatting", "PipelinedStreams"))
