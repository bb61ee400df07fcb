"""mfu.<tag>: the net's operations a frame (``flops_per_frame`` of
``layers/<name>.py``, the module the configuration names as its
``"net"``) times the frames completed, over the card's busy time times
the bfloat16 peak."""

import importlib

from portbench.yardstick import BF16_FLOPS_PER_S


def read(run):
    tr = run.obs.trace
    if tr is None or not tr.device:
        return None
    t = tr.busy_s()
    if t <= 0 or run.frames == 0:
        return None
    config = run.cell.config
    net = importlib.import_module(f"portbench.layers.{config['net']}")
    flops = net.flops_per_frame(config, run.cell.traffic)
    return 100.0 * flops * run.frames / (t * BF16_FLOPS_PER_S)
