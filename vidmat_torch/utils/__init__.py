"""Metrics and profiling helpers (counterpart of vidmat/utils/), exported
lazily."""

from vidmat_torch._exports import lazy_exports

__getattr__ = lazy_exports({"mad": "vidmat_torch.utils.metrics",
                            "sad": "vidmat_torch.utils.metrics"})
