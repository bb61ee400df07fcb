"""host_ms_per_frame.<span>.<tag>: the summed self time, in the window, of
the program's spans of that name on the dispatching thread (``spans.py``),
over the frames completed."""

from portbench import spans


def read(run):
    v = spans.view(run)
    if v is None or run.frames == 0:
        return None
    name = run.metric["name"].split(".")[1]
    return v.host_ns.get(name, 0.0) * 1e-6 / run.frames
