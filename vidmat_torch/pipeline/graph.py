"""One CUDA graph launch per chunk (counterpart of the JAX package's single
jitted ``chunk_step``, vidmat/pipeline/video.py:374-395 and :540-548).

The planar chunk body makes some sixty PyTorch calls per frame from
Python (``ServingPlan.chunk_body``); replaying them as one captured graph
leaves the host one ``cudaGraphLaunch`` per chunk. ``ChunkGraph`` captures
the body over static tensors: the device input chunk, the recurrent
state (updated in place by ``copy_`` at the end of the captured region)
and the output, which each replay rewrites.

The kernel wrappers count launches in Python, where they enqueue. A
capture only records the launches, so ``ChunkGraph`` takes the counts the
capture added off again and adds them back on every replay, which is
where those kernels run.
"""

from __future__ import annotations

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


def _counts(fns):
    return [(fn.launches, dict(getattr(fn, "mode_launches", {})))
            for fn in fns]


class ChunkGraph:
    """A captured chunk body, replayed once per chunk.

    body(frames, state) -> (out, new_state): the chunk body. It must have
    run eagerly on this device first (the warm-up: it builds and loads
    every kernel, sets their shared-memory attributes and fills the
    caches a capture may not fill). static_in: the device input chunk the
    caller copies each chunk into. state: the recurrent state to go on
    from (a tuple of tensors, or None); its tensors become the graph's
    static state. A failed capture raises."""

    def __init__(self, body: Callable, static_in: torch.Tensor, state):
        self.static_in = static_in
        self.state = state
        fns = kernel_wrappers()
        before = _counts(fns)
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(self.graph):
            out, new_state = body(static_in, state)
            if state is not None:
                for s, t in zip(state, new_state):
                    s.copy_(t)
        self.out = out
        self.per_replay = []
        for fn, (n0, m0), (n1, m1) in zip(fns, before, _counts(fns)):
            fn.launches = n0
            if m0:
                fn.mode_launches.update(m0)
            modes = {k: m1[k] - m0[k] for k in m0 if m1[k] != m0[k]}
            if n1 != n0:
                self.per_replay.append((fn, n1 - n0, modes))

    def __call__(self, state):
        """Replay on the chunk in ``static_in`` from ``state`` (copied into
        the static state unless it is that state). Returns (out, state):
        the static output and state, valid until the next replay."""
        if state is not self.state and state is not None:
            with torch.inference_mode():
                for s, t in zip(self.state, state):
                    s.copy_(t)
        self.graph.replay()
        for fn, n, modes in self.per_replay:
            fn.launches += n
            for k, v in modes.items():
                fn.mode_launches[k] += v
        return self.out, self.state
