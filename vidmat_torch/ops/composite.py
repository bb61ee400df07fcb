"""Host-side view of packed RGBA words (counterpart of
vidmat/ops/pallas/composite_kernel.py ``unpack_rgba_host``).

The full-resolution composite kernel (``composite_rgba_packed``) serves
the unfused tails only and is not ported yet (ROADMAP queue B).
"""

from __future__ import annotations

import numpy as np


def unpack_rgba_host(packed: np.ndarray) -> np.ndarray:
    """Zero-copy host view of packed words as (..., 4) uint8 RGBA."""
    arr = np.ascontiguousarray(packed)
    return arr.view(np.uint8).reshape(*arr.shape, 4)
