"""Multi-stream and multi-device serving (counterpart of
vidmat/parallel/), exported lazily: ``MultiStreamMatting`` (one card, or
its streams split over a mesh), ``make_mesh`` and the 2-stage pipeline
split (``PipelinedMatting``, ``PipelinedStreams``)."""

from vidmat_torch._exports import lazy_exports

__getattr__ = lazy_exports(
    {"make_mesh": "vidmat_torch.parallel.mesh",
     "MultiStreamMatting": "vidmat_torch.parallel.multistream",
     "PipelinedMatting": "vidmat_torch.parallel.pp",
     "PipelinedStreams": "vidmat_torch.parallel.pp"})
