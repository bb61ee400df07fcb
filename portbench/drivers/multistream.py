"""``MultiStreamMatting.step``: S streams of one bucket as one batch, closed
loop, round after round.

Round r's frames are each stream's frame r of its seeded pool (cycled).
Three warm-up rounds (the eager first dispatch and its capture, then
replays) count as set-up; the window runs from the first timed round until
the round during which its seconds ran out has returned, then a
synchronize. ``step`` returns each round's outputs on the host.
"""

from __future__ import annotations

import time

import torch

from portbench.drivers.common import build_program, inputs, program_configs
from portbench.harness import CellError, Observation, Recorder, Sampler
from portbench.yardstick import frame_hw


def drive(ctx) -> Observation:
    from vidmat_torch.parallel.multistream import MultiStreamMatting

    cell = ctx.cell
    tr = cell.traffic
    mcfg, pcfg = program_configs(cell.config)
    if int(tr.get("chunk_size", 1)) != 1:
        raise CellError("the multistream driver steps one round a dispatch")
    streams = int(tr["streams"])
    fh, fw = frame_hw(cell.config, tr)
    ctx.note("imports")
    build_program(ctx.device)
    ctx.note("kernels built")
    pool, variables = inputs(cell, ctx.seed, ctx.device)
    ctx.note("frames and weights made")
    ms = MultiStreamMatting(
        streams, fh, fw, cfg=mcfg, variables=variables,
        downsample_ratio=pcfg.downsample_ratio, refine=pcfg.refine,
        dtype=pcfg.dtype, bg_color=tuple(tr["bg_color"]), chunk=1,
        device=ctx.device)
    ctx.note("program built")
    warm = int(tr["warmup_dispatches"])
    if warm < 3:
        raise CellError("warm-up needs three rounds: eager, capture, replay")
    for r in range(warm):
        ms.step(pool[r % len(pool)])
        if r == 0:
            ctx.note("first warm-up output")
    sampler = Sampler(ctx.seed, int(tr["check_every"]))
    rec = Recorder() if ctx.record else None
    if rec is not None:
        rec.start()
    t0 = time.perf_counter()
    ctx.note("window opens")
    stop = t0 + ctx.seconds
    samples = {}
    r = warm
    while True:
        _, rgba = ms.step(pool[r % len(pool)])
        if sampler.keep(r - warm):
            samples[r] = rgba
        r += 1
        if time.perf_counter() >= stop:
            break
    samples[r - 1] = rgba
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    trace = rec.stop() if rec is not None else None
    del ms
    n = (r - warm) * streams
    return Observation(frames=n, attempted=n, window_s=t_end - t0,
                       setup_s=t0 - ctx.t_start, samples=samples,
                       pool=pool, trace=trace, variables=variables)
