"""Host-side frame I/O of the port (numpy only; counterpart of
vidmat/io/), exported lazily."""

from vidmat_torch._exports import lazy_exports

__getattr__ = lazy_exports(
    {"FrameSource": "vidmat_torch.io.reader",
     "VideoReader": "vidmat_torch.io.reader",
     "read_image": "vidmat_torch.io.reader",
     "VideoWriter": "vidmat_torch.io.writer",
     "write_image": "vidmat_torch.io.writer",
     "synthetic_clip": "vidmat_torch.io.fixtures",
     "synthetic_frame": "vidmat_torch.io.fixtures"})
