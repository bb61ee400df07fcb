"""Multi-stream serving (counterpart of vidmat/parallel/), exported
lazily: the one-card ``MultiStreamMatting``. The device mesh and the
2-stage pipeline split (``make_mesh``, ``PipelinedMatting``,
``PipelinedStreams``) need more than one card and raise naming ROADMAP
A.12."""

from vidmat_torch._exports import lazy_exports

__getattr__ = lazy_exports(
    {"MultiStreamMatting": "vidmat_torch.parallel.multistream"},
    multi_card=("make_mesh", "PipelinedMatting", "PipelinedStreams"))
