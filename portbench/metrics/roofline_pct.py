"""roofline_pct.<layer>.<tag>: the least time of the layer's work over the
frames completed (``layers/<layer>.py``: its work a dispatch at the cell's
shapes, each unit's least time the larger of its bytes over the memory's
rate and its operations over its type's peak), over the device time of
the layer's kernels, matched by name in the trace."""

import importlib

from portbench.yardstick import geometry


def read(run):
    tr = run.obs.trace
    layer = run.metric["name"].split(".")[1]
    mod = importlib.import_module(f"portbench.layers.{layer}")
    if tr is None or run.frames == 0:
        return None
    measured = tr.device_s(mod.matches)
    work = mod.work(run.cell.config, run.cell.traffic)
    if measured <= 0 or not work:
        return None
    geo = geometry(run.cell.config, run.cell.traffic)
    least = sum(w.least_s for w in work) / geo.frames
    return 100.0 * least * run.frames / measured
