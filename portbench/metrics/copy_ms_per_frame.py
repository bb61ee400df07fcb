"""copy_ms_per_frame.<tag>: the device time of the copies (host to device
and back) over the frames completed."""


def read(run):
    tr = run.obs.trace
    if tr is None or run.frames == 0:
        return None
    s = tr.device_s(lambda n: n.startswith("Memcpy"))
    return 1e3 * s / run.frames if s > 0 else None
