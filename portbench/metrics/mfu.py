"""mfu.<tag>: the net's operations a frame (``yardstick.net_flops_per_frame``)
times the frames completed, over the card's busy time times the bfloat16
peak."""

from portbench.yardstick import (BF16_FLOPS_PER_S, net_flops_per_frame,
                                 net_shape)


def read(run):
    tr = run.obs.trace
    if tr is None or not tr.device:
        return None
    t = tr.busy_s()
    if t <= 0 or run.frames == 0:
        return None
    flops = net_flops_per_frame(net_shape(run.cell.config,
                                          run.cell.traffic))
    return 100.0 * flops * run.frames / (t * BF16_FLOPS_PER_S)
