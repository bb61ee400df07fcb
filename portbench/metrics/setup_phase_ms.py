"""setup_phase_ms.<phase>.<tag>: the summed self time of the program's
spans of that name (``build``, ``eager``, ``kernel_load``, ``capture``)
that start before the window (``spans.py``), on every thread."""

import sys

from portbench import spans


def read(run):
    v = spans.view(run)
    if v is None:
        return None
    if v.setup_ns is None:
        print("spans: a span ring overwrote spans: set-up not read",
              file=sys.stderr)
        return None
    return v.setup_ns.get(run.metric["name"].split(".")[1], 0.0) * 1e-6
