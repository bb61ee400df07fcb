"""A chunk's decoder as a wavefront (the planar chunk body's per-frame
decode, vidmat/pipeline/stepfactory.py:656-693, issued across streams).

The recurrence orders each stage-step of ``PlanarNetwork.decode`` only
against the same stage-step of the frame before and the stage-step before
it in the same frame: d3 of frame i+1 needs frame i's h3, d2 of frame i
needs frame i's d3. So d3 of frame i+1, d2 of frame i, d1 of frame i-1 and
the head of frame i-2 are independent. On a CUDA device with more than one
frame, stage-step k of every frame goes on side stream k (one a
stage-step, made once per device). Each side stream forks from the
current stream, waits for the stage-step before it in the same frame, and
carries its hidden map from frame to frame in its own order; all join the
current stream at the end. Under ``ChunkGraph``'s capture the forks,
waits and joins become the graph's edges, and its branches replay side by
side: the batch-1 launches, each of which fills a small part of the card,
share it. The kernels and their inputs are those of the serial order, so
the outputs are the same bytes. On the CPU, for one frame, and while
``torch.export`` traces a body, the same stage-steps run in order on the
current stream.

Every stage-step's outputs are held until the join: a block the caching
allocator took back while another stream still read it could be handed
to the next allocation on its own stream (in a capture too).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

#: the stage-steps' side streams of each device index, made at first use
_stage_streams = {}


def _streams(device: torch.device, n: int) -> List[torch.cuda.Stream]:
    got = _stage_streams.get(device.index)
    if got is None:
        got = _stage_streams[device.index] = [
            torch.cuda.Stream(device) for _ in range(n)]
    return got


def decode_frames(net, enc, state, plain: bool = False):
    """Decode the N frames of a batched ``PlanarEncoding`` in frame order,
    the state carried from each to the next (N calls of ``net.decode`` on
    ``enc.frame(i)``). Returns (alphas, fgrs, state, overlapped): the
    frames' (1, H, W, 1) alphas and (1, H, W, 3) foregrounds, the state
    after the last frame, and the stage-steps issued on a side stream
    (N times the stage-steps a frame on the wavefront, else 0)."""
    n = enc.b4.shape[0]
    depth = len(net.STAGES) + 1
    side: Optional[List[torch.cuda.Stream]] = None
    # A traced program (torch.export: a bundle's chunk program) records
    # no streams; it runs the stage-steps in order.
    if enc.b4.is_cuda and n > 1 and not torch.compiler.is_compiling():
        side = _streams(enc.b4.device, depth)
        cur = torch.cuda.current_stream(enc.b4.device)
        for s in side:
            s.wait_stream(cur)

    def on(k):
        """Stage-step k's stream, after stage-step k - 1 of this frame."""
        if side is None:
            return contextlib.nullcontext()
        if k:
            side[k].wait_stream(side[k - 1])
        return torch.cuda.stream(side[k])

    hs = [None] * len(net.STAGES) if state is None else list(state)
    live, alphas, fgrs = [], [], []
    for i in range(n):
        e = enc.frame(i)
        xs = [e.b4]
        for j in range(len(net.STAGES)):
            with on(j):
                xs, hs[j] = net.decode_stage(j, e, xs, hs[j], plain)
            live.append(xs)
        with on(depth - 1):
            alpha, fgr = net.decode_head(e, xs, plain)
        alphas.append(alpha)
        fgrs.append(fgr)
    if side is None:
        return alphas, fgrs, net.new_state(hs, state), 0
    for s in side:
        cur.wait_stream(s)
    return alphas, fgrs, net.new_state(hs, state), n * depth
