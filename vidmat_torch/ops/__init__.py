"""Operators of the port (counterpart of vidmat/ops/), exported lazily.

``guided_filter`` is imported here: as in the JAX package the name is the
function, whichever module imported the ``ops.guided_filter`` submodule
first (a lazy export could not replace the submodule the import system
binds). Code that needs that module imports its names from it, or takes
it from ``importlib.import_module("vidmat_torch.ops.guided_filter")``."""

from vidmat_torch._exports import lazy_exports
from vidmat_torch.ops.guided_filter import guided_filter  # noqa: F401

__getattr__ = lazy_exports(
    {"resize_bilinear": "vidmat_torch.ops.resize",
     "upsample2x": "vidmat_torch.ops.resize",
     "downsample_ratio_shape": "vidmat_torch.ops.resize",
     "composite_rgba": "vidmat_torch.ops.composite"})
