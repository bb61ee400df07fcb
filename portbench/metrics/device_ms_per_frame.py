"""device_ms_per_frame: the card's busy time over the window (the union of
its kernels, copies and sets, overlaps once; device clock) over the frames
completed."""


def read(run):
    tr = run.obs.trace
    if tr is None or not tr.device or run.frames == 0:
        return None
    return 1e3 * tr.busy_s() / run.frames
