"""idle_ms_per_frame.<span>.<tag>: the device's idle time in the window
(outside the busy union) during which <span> was the innermost open span
of the dispatching thread (``spans.py``), over the frames completed;
<span> = none: idle time under no span."""

from portbench import spans


def read(run):
    v = spans.view(run)
    if v is None or run.frames == 0:
        return None
    name = run.metric["name"].split(".")[1]
    return v.idle_ns.get(name, 0.0) * 1e-6 / run.frames
