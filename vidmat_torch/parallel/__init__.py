"""Multi-stream serving (counterpart of vidmat/parallel): the one-card
``MultiStreamMatting``. The device mesh and the 2-stage pipeline split
(``make_mesh``, ``PipelinedMatting``, ``PipelinedStreams``) need more
than one card and are not ported (ROADMAP A.12)."""

from vidmat_torch.parallel.multistream import MultiStreamMatting  # noqa: F401
