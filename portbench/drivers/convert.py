"""``vidmat_torch.convert_video`` on host-fed uint8 frames, closed loop.

One conversion: a generator yields the warm-up frames (``warmup_dispatches``
chunks: the eager first chunk and its capture, then replays), waits until
the sink has the outputs of all but the last of them, then yields chunks of
frames from the seeded pool for the window, as fast as the pipeline takes
them, and stops after the chunk during which the window's seconds ran out.
The sink (``output_alpha`` or ``output_composition`` over ``bg_color``)
counts the window's outputs and keeps the sampled ones. The window runs
from the first timed frame to the last output, after a synchronize.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench.drivers.common import build_program, inputs, program_configs
from portbench.harness import CellError, Observation, Recorder, Sampler


def drive(ctx) -> Observation:
    import vidmat_torch

    cell = ctx.cell
    tr = cell.traffic
    mcfg, pcfg = program_configs(cell.config)
    ctx.note("imports")
    build_program(ctx.device)
    ctx.note("kernels built")
    pool, variables = inputs(cell, ctx.seed, ctx.device)
    ctx.note("frames and weights made")
    frames = pool[:, 0]
    k = int(pcfg.chunk_size)
    warm = int(tr["warmup_dispatches"]) * k
    if warm < 3 * k:
        raise CellError("warm-up needs three chunks: eager, capture, replay")
    sampler = Sampler(ctx.seed, int(tr["check_every"]))
    rec = Recorder() if ctx.record else None
    go = threading.Event()
    clock = {"t0": None, "stop": None}
    sent = [0]
    samples = {}
    last = [None]
    seen = [0]

    def source():
        for i in range(warm):
            yield frames[i % len(frames)]
        if not go.wait(timeout=900):
            return
        i = warm
        while True:
            for _ in range(k):
                sent[0] += 1
                yield frames[i % len(frames)]
                i += 1
            if time.perf_counter() >= clock["stop"]:
                return

    def sink(out: np.ndarray):
        i = seen[0]
        seen[0] += 1
        if i == 0:
            ctx.note("first warm-up output")
        if i >= warm:
            j = i - warm
            arr = out.reshape(1, *out.shape[:2], -1)
            if sampler.keep(j):
                samples[i] = arr
            last[0] = (i, arr)
        elif i == warm - k - 1:
            # The last warm-up chunk has been enqueued: the window opens.
            if rec is not None:
                rec.start()
            clock["t0"] = time.perf_counter()
            clock["stop"] = clock["t0"] + ctx.seconds
            ctx.note("window opens")
            go.set()

    target = "output_alpha" if tr["output"] == "alpha" else \
        "output_composition"
    kw = {target: sink}
    if tr["output"] != "alpha":
        kw["bg_color"] = tuple(tr["bg_color"])
    vidmat_torch.convert_video(source(), model_cfg=mcfg, pipe_cfg=pcfg,
                               variables=variables, device=ctx.device, **kw)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    trace = rec.stop() if rec is not None else None
    if clock["t0"] is None:
        raise CellError("the window never opened")
    if last[0] is not None:
        samples[last[0][0]] = last[0][1]
    return Observation(frames=max(0, seen[0] - warm), attempted=sent[0],
                       window_s=t_end - clock["t0"],
                       setup_s=clock["t0"] - ctx.t_start, samples=samples,
                       pool=pool, trace=trace, variables=variables)
