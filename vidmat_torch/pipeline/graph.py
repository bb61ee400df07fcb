"""One CUDA graph launch per chunk (counterpart of the JAX package's single
jitted ``chunk_step`` and ``step``, vidmat/pipeline/video.py:374-395 and
:536-582).

A chunk body makes tens of PyTorch calls per frame from Python: the
planar chunk body (``ServingPlan.chunk_body``) some sixty, K calls of a
per-frame body (``per_frame_chunk``) as many each, the 4K tiled body
about two hundred, a multi-stream chunk (``per_round_chunk``) as many as
its K rounds' bodies. Replaying them as one captured graph leaves the
host one ``cudaGraphLaunch`` per chunk. ``ChunkGraph`` captures the body
over static tensors: the device inputs (the frame chunk, the background
chunk of a background video, a multi-stream round's reset rows), the
recurrent state (updated in place by ``copy_`` at the end of the
captured region) and the outputs, which each replay rewrites.

The kernel wrappers count launches in Python, where they enqueue. A
capture only records the launches, so ``ChunkGraph`` takes the counts the
capture added off again and adds them back on every replay, which is
where those kernels run. A body's ``overlapped_steps`` (the planar chunk
body's stage-steps on side streams, ``pipeline/wavefront.py``) is
counted the same way; the side streams' forks and joins are the graph's
edges, and its branches replay concurrently.

A graph replays on the caller's current stream, and captures on the
current device: a mesh position (``parallel/mesh.py``) builds and replays
its graphs under its device and its own stream.

The capture runs on a side stream between ``capture_begin`` and
``capture_end``, as ``torch.cuda.graph`` does, without that context's
emptying of the device and pinned-host caching allocators on entry: a
pipeline captures one graph per bucket, and each emptying frees the
cached pinned chunks and device blocks of earlier runs, which the next
allocation then pays for again (``cudaHostAlloc``, ``cudaMalloc``).
"""

from __future__ import annotations

import gc
from typing import Callable, List

import torch


def kernel_wrappers() -> List[Callable]:
    """Every kernel wrapper of the port (each carries ``.launches``; the
    packed tail also ``.mode_launches``)."""
    from vidmat_torch.ops import composite, gf, ingest, int8_planar, planar
    from vidmat_torch.ops import refine

    return [ingest.ingest_pool_normalize, gf.guided_filter_coeffs,
            refine.fused_refine_composite, refine.fused_refine_float,
            composite.composite_rgba_packed, planar.planar_conv,
            planar.planar_conv2, planar.planar_conv_gru, planar.planar_gru,
            int8_planar.int8_conv]


#: the capture stream of each device index, made at its first capture
_capture_streams = {}


def _side_stream() -> torch.cuda.Stream:
    """The capture stream of the current device (a capture stream must be
    on the device whose work it captures: mesh positions on several cards
    capture each on its own)."""
    dev = torch.cuda.current_device()
    stream = _capture_streams.get(dev)
    if stream is None:
        stream = _capture_streams[dev] = torch.cuda.Stream(dev)
    return stream


def _counts(fns):
    return [(fn.launches, dict(getattr(fn, "mode_launches", {})))
            for fn in fns]


def _cat(outs):
    """Per-frame outputs (tensors, or tuples of tensors) joined along the
    frame axis."""
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(ts) for ts in zip(*outs))
    return torch.cat(outs)


def per_frame_chunk(body: Callable, bg_dynamic: bool = False) -> Callable:
    """K calls of a per-frame serving body as one chunk body, in frame
    order, the state carried from each to the next (the JAX package's
    ``lax.scan`` of its per-frame body). Returns fn(frames, state) ->
    (out, state), or with ``bg_dynamic`` fn(frames, bgs, state): frame j
    composites over bgs[j]. The outputs are joined along the frame
    axis."""
    def run(frames, *rest):
        *bgs, state = rest
        outs = []
        for j in range(frames.shape[0]):
            extra = (bgs[0][j:j + 1],) if bg_dynamic else ()
            out, state = body(frames[j:j + 1], state, *extra)
            outs.append(out)
        return _cat(outs), state

    return run


def _stack(outs):
    """Per-round outputs (tensors, or tuples of tensors) stacked on a new
    leading round axis."""
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(ts) for ts in zip(*outs))
    return torch.stack(outs)


def per_round_chunk(round_body: Callable) -> Callable:
    """K rounds of a multi-stream round body as one chunk body (the JAX
    package's ``lax.scan`` of its ``frame_step``,
    vidmat/parallel/multistream.py:157-170). round_body(frames (S, ...),
    reset (S,), state) -> (out, state) applies its reset row to the state
    before its frames. Returns fn(frames (K, S, ...), reset (K, S), state)
    -> (out, state): round j runs with reset row j, the state carried from
    each round to the next, the outputs stacked on a leading K axis. The
    reset rows are tensors, so a captured chunk reads each replay's rows
    from its static input."""
    def run(frames, reset, state):
        outs = []
        for j in range(frames.shape[0]):
            out, state = round_body(frames[j], reset[j], state)
            outs.append(out)
        return _stack(outs), state

    return run


class ChunkGraph:
    """A captured chunk body, replayed once per chunk.

    body(*static_in, state) -> (out, new_state): the chunk body. It must
    have run eagerly on this device first (the warm-up: it builds and
    loads every kernel, sets their shared-memory attributes and fills the
    caches a capture may not fill). static_in: the device input chunk the
    caller copies each chunk into, or a tuple of such inputs. state: the
    recurrent state to go on from (a tuple of tensors, or None); its
    tensors become the graph's static state. A failed capture raises.
    ``per_replay`` lists (wrapper, launches, mode launches) of one
    replay; ``steps_per_replay`` the body's ``overlapped_steps`` of one
    replay (0 for a body that has none)."""

    def __init__(self, body: Callable, static_in, state):
        self.static_in = static_in
        ins = static_in if isinstance(static_in, tuple) else (static_in,)
        self.state = state
        fns = kernel_wrappers()
        before = _counts(fns)
        self.body = body
        steps = getattr(body, "overlapped_steps", None)
        self.graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        # No garbage collection inside the capture: a graph freed there (one
        # held in a reference cycle) would invalidate it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.inference_mode(), torch.cuda.stream(_side_stream()):
                self.graph.capture_begin()
                try:
                    out, new_state = body(*ins, state)
                    if state is not None:
                        for s, t in zip(state, new_state):
                            s.copy_(t)
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.out = out
        self.steps_per_replay = 0
        if steps is not None:
            self.steps_per_replay = body.overlapped_steps - steps
            body.overlapped_steps = steps
        self.per_replay = []
        for fn, (n0, m0), (n1, m1) in zip(fns, before, _counts(fns)):
            fn.launches = n0
            if m0:
                fn.mode_launches.update(m0)
            modes = {k: m1[k] - m0[k] for k in m0 if m1[k] != m0[k]}
            if n1 != n0:
                self.per_replay.append((fn, n1 - n0, modes))

    def load_state(self, state) -> None:
        """Copy ``state`` into the static state (a reset or a restored
        carry); the next replay goes on from it."""
        if state is not self.state and state is not None:
            with torch.inference_mode():
                for s, t in zip(self.state, state):
                    s.copy_(t)

    def launches_per_replay(self) -> dict:
        """{wrapper name: launches} of one replay."""
        return {fn.__name__: n for fn, n, _ in self.per_replay}

    def __call__(self, state):
        """Replay on the inputs in ``static_in`` from ``state`` (copied into
        the static state unless it is that state). Returns (out, state):
        the static output and state, valid until the next replay."""
        self.load_state(state)
        self.graph.replay()
        if self.steps_per_replay:
            self.body.overlapped_steps += self.steps_per_replay
        for fn, n, modes in self.per_replay:
            fn.launches += n
            for k, v in modes.items():
                fn.mode_launches[k] += v
        return self.out, self.state
