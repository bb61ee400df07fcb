"""Batched multi-stream serving on one card (counterpart of
vidmat/parallel/multistream.py).

S independent streams of one resolution run as one batch: the batch axis
is the stream axis. A round is the port's serving body
(``build_serving_body``, the one implementation with the pipeline and the
session) on an (S, H, W, C) frame batch with a batched recurrent state. A
stream's reset (a scene cut, a new stream in its slot) multiplies its
slot of every state tensor by zero inside the round, so it needs no host
round-trip and stalls no other stream (:138-155).

Dispatch, as ``VideoStepper`` does it: the frames and the reset flags go
through reused pinned host buffers (``Uploads``) into static device
inputs. On CUDA the first dispatch of each shape (one round, or K rounds)
runs eagerly (the warm-up) and is then captured as a CUDA graph
(``graph.ChunkGraph``): each later dispatch is two copies in, one graph
launch and one copy out, into reused pinned buffers (``Downloads``). A
packed word is unpacked once per batch on the host (``unpack_rgba``).

``serve`` drives S live sources, one producer thread each (:249-350); a
stream that ends keeps its slot with its last frame and a standing reset
flag, so the batch never stalls.

``mesh=`` splits the stream axis over the mesh's positions (the JAX
package's ``shard_map`` over 'stream', :191-228): S / P streams each.
Each position (``parallel/mesh.py``) has its own body built on its
device, its own state, staging and graphs, and on CUDA its own stream. A
dispatch stages every position's streams, sends and runs each (an H2D
and a replay on its stream), and only then fetches them all, so the
positions' work overlaps; the outputs join in stream order. A position
may repeat a device: two positions on one card serve their halves on two
streams of it. On a mesh that spans processes (``make_mesh`` after
``initialize_distributed``) each process serves the streams of its own
positions, as each JAX process feeds its addressable shards: serving
needs no communication.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vidmat_torch._device import resolve_device
from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.io.native import pad_into, unpack_rgba
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.parallel.mesh import Position
from vidmat_torch.pipeline.graph import ChunkGraph, per_round_chunk
from vidmat_torch.pipeline.stepfactory import build_serving_body
from vidmat_torch.pipeline.video import Downloads, Uploads
from vidmat_torch.utils.metrics import RunMetrics
from vidmat_torch.utils.profiling import annotate, spanned


def reset_streams(state, reset: torch.Tensor):
    """The batched carry with the streams flagged in ``reset`` (S,) zeroed:
    every state tensor times keep = 1 - reset, shaped (S, 1, 1, 1), in the
    tensor's dtype. A product, as in the JAX package, so the kept streams'
    values are their own (None, a non-recurrent model's carry, stays
    None)."""
    if state is None:
        return None
    return type(state)(*(
        h * (1 - reset.to(h.dtype)).view(-1, *(1,) * (h.dim() - 1))
        for h in state))


class MultiStreamMatting:
    """Batched matting over S independent streams of one resolution.

    step(frames_u8 (S, H, W, C), reset_mask (S,) bool) -> (alpha_u8,
    out_u8) on the host: with a background color the composited RGBA
    (``out``) and its alpha byte, (S, H, W, 4) and (S, H, W, 1); with
    ``bg_blur`` the same over a blur of each stream's own frames; with
    neither, alpha (S, H, W, 1) and the raw foreground (S, H, W, 3).

    C is 3 (RGB), or 4 for a trimap-conditioned ``cfg`` (RGB and the
    stream's uint8 {0, 128, 255} trimap). ``bg_plate``: the clean plate of
    a plate-conditioned ``cfg``, one (H, W, 3) plate shared by the streams
    or (S, H, W, 3), one per stream. ``chunk`` K > 1: each ``step`` takes
    K rounds, (K, S, H, W, C) frames and (K, S) reset rows, round j's row
    applied before its frames; the outputs carry the leading K axis.

    The signature is the JAX package's, plus ``device`` ("cuda", the
    default, raises without a CUDA device; "cpu" runs the plain PyTorch
    versions of the kernels). ``mesh`` (``make_mesh``): the streams split
    evenly over its positions, which then give the devices (``device`` is
    not used); a per-stream plate needs mesh=None, as in the JAX package.
    On a mesh of several processes ``num_streams`` counts every
    process's streams, and this process serves those of its positions:
    ``step`` takes its (S / P * local positions, ...) frames.
    ``use_pallas=False`` takes the branch without kernels (the uint8
    tuple, the net as F.conv2d), as in ``PipelineConfig``;
    ``pallas_interpret`` changes nothing here (the CUDA kernels run on the
    card, their plain versions on the CPU)."""

    #: capture each dispatch shape as a CUDA graph after its first dispatch
    #: (False: every dispatch through the eager bodies, the reference the
    #: graphs are held to)
    capture = True

    @spanned("build")
    def __init__(self, num_streams: int, height: int, width: int,
                 cfg: ModelConfig = ModelConfig(), variables=None,
                 mesh=None,
                 downsample_ratio: float = 1.0,
                 refine: RefineConfig = RefineConfig(),
                 dtype: str = "bfloat16",
                 bg_color: Optional[Tuple[float, float, float]] = None,
                 bg_blur: Optional[int] = None,
                 bg_plate: Optional[np.ndarray] = None,
                 chunk: int = 1,
                 use_pallas: Optional[bool] = None,
                 pallas_interpret: bool = False,
                 device="cuda"):
        if height % 16 or width % 16:
            raise ValueError("height/width must be multiples of 16")
        if bg_blur and bg_color is not None:
            raise ValueError("bg_blur composites over a blur of each "
                             "stream's own frames; it is mutually "
                             "exclusive with bg_color")
        if mesh is not None and num_streams % mesh.size:
            raise ValueError(
                f"num_streams={num_streams} must divide evenly over the "
                f"{mesh.size}-device mesh (per-device local batch)")
        if bg_plate is not None:
            bg_plate = np.asarray(bg_plate)
            if bg_plate.ndim == 4 and bg_plate.shape[0] != num_streams:
                raise ValueError(
                    f"per-stream bg_plate batch {bg_plate.shape[0]} != "
                    f"num_streams {num_streams}")
            if bg_plate.ndim == 4 and mesh is not None:
                raise ValueError(
                    "per-stream bg_plate is a single-chip feature; on a "
                    "mesh use one shared (H, W, 3) plate, or run one "
                    "MultiStreamMatting per device group")
        self.mesh = mesh
        positions = ([Position(d) for d in mesh.local_devices()]
                     if mesh is not None
                     else [Position(resolve_device(device),
                                    own_stream=False)])
        self.device = positions[0].device
        per = num_streams // (len(positions) if mesh is None else mesh.size)
        self.s = per * len(positions)
        self.h, self.w = height, width
        self.in_c = 4 if cfg.use_trimap else 3
        self.cfg = cfg
        self.variables = (variables if variables is not None
                          else default_variables(cfg))
        cdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        # Without kernels the JAX package runs the net as plain
        # convolutions (its planar forward needs its kernels).
        net_cfg = (cfg if use_pallas is not False
                   else dataclasses.replace(cfg, conv_impl="xla"))
        composited = bg_color is not None or bool(bg_blur)
        self.chunk = max(1, chunk)
        self._shards = []
        for p, pos in enumerate(positions):
            net = build_network(
                net_cfg, self.variables,
                dtype=cdtype if cdtype == torch.bfloat16 else None,
                device=pos.device)
            # No background keeps the raw-foreground output (the packed
            # word carries composited RGB), so it takes the uint8 tuple;
            # bg_blur composites each stream over a blur of its own
            # frames.
            body, plan = build_serving_body(
                net, net_cfg, refine, height, width, downsample_ratio,
                cdtype=cdtype, bg=bg_color, use_pallas=use_pallas,
                need_fgr=(bg_color is None and not bg_blur),
                bg_blur=bg_blur, bg_plate=bg_plate)
            self._shards.append(_Shard(self, pos, p * per, (p + 1) * per,
                                       _round_body(body, plan, composited),
                                       plan.make_state(per)))
        self.net_h, self.net_w = plan.net_h, plan.net_w
        self._packed = plan.packed
        self.capture_ms = None  # the last capture, once made

    @property
    def state(self):
        """The batched carry: on one position its state; on a mesh a list
        of each position's."""
        if len(self._shards) == 1:
            return self._shards[0].state
        return [sh.state for sh in self._shards]

    @state.setter
    def state(self, value):
        if len(self._shards) == 1:
            self._shards[0].state = value
        else:
            for sh, v in zip(self._shards, value):
                sh.state = v

    @property
    def positions(self) -> List[Position]:
        """The positions, in stream order (one without a mesh)."""
        return [sh.pos for sh in self._shards]

    # -- dispatch: stage, send, run (graph or eager), fetch --

    def _check_channels(self, c: int) -> None:
        if c != self.in_c:
            kind = ("trimap-conditioned (RGB + trimap channel)"
                    if self.in_c == 4 else "RGB")
            raise ValueError(f"frames have {c} channels; this {kind} model "
                             f"takes {self.in_c}")

    def _stage(self, k: int, rounds: Sequence[Sequence[np.ndarray]],
               resets) -> None:
        """Pad each frame of ``rounds`` (k rounds of S (H', W', C) uint8
        frames, H' <= H, W' <= W) straight into its slot of its
        position's pinned batch (``pad_into``, the JAX package's
        ``pad_stack``), and the reset rows (k, S) beside it."""
        resets = np.asarray(resets, bool).reshape(k, self.s)
        for sh in self._shards:
            sh.stage(k, [r[sh.lo:sh.hi] for r in rounds],
                     resets[:, sh.lo:sh.hi])

    def _join(self, k: int, parts):
        """The positions' outputs (each (n, ...) or, at k > 1, (k, n,
        ...)) joined along the stream axis."""
        if len(parts) == 1:
            return parts[0]
        axis = 0 if k == 1 else 1
        return tuple(np.concatenate(ps, axis=axis) for ps in zip(*parts))

    def _dispatch(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Send the staged k rounds and run them on every position, then
        fetch every position's outputs; each position's first dispatch
        of a shape is then captured."""
        with annotate("enqueue"):
            outs = []
            for sh in self._shards:
                sh.send(k)
                outs.append(sh.run(k))
            handles = [sh.download(k, out)
                       for sh, out in zip(self._shards, outs)]
        if len(self._shards) > 1 and self._packed:
            # Each position unpacks into its streams of one output.
            lead = (self.s,) if k == 1 else (k, self.s)
            rgba = np.empty(lead + (self.h, self.w, 4), np.uint8)
            for sh, h in zip(self._shards, handles):
                sh.read(k, h, rgba)
            res = rgba[..., 3:4], rgba
        else:
            res = self._join(k, [sh.read(k, h)
                                 for sh, h in zip(self._shards, handles)])
        captured = [sh.capture_after_warm_up(k) for sh in self._shards]
        if any(c is not None for c in captured):
            self.capture_ms = sum(c or 0.0 for c in captured)
        return res

    def step(self, frames_u8: np.ndarray,
             reset_mask: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """One dispatch. chunk=1: frames (S, H, W, C), reset (S,).
        chunk=K: frames (K, S, H, W, C), reset (K, S); outputs carry the
        matching leading K axis."""
        k = self.chunk
        lead = (self.s,) if k == 1 else (k, self.s)
        frames_u8 = np.asarray(frames_u8)
        self._check_channels(frames_u8.shape[-1])
        if reset_mask is None:
            reset_mask = np.zeros(lead, bool)
        if (frames_u8.shape != lead + (self.h, self.w, self.in_c)
                or np.shape(reset_mask) != lead):
            raise ValueError(
                f"frames {frames_u8.shape} and reset {np.shape(reset_mask)} "
                f"do not match this instance's "
                f"{lead + (self.h, self.w, self.in_c)} and {lead}")
        self._stage(k, frames_u8.reshape(k, self.s, self.h, self.w,
                                         self.in_c), reset_mask)
        return self._dispatch(k)

    def step_device(self, frames_u8: torch.Tensor, reset_mask: torch.Tensor):
        """Device-resident dispatch for benchmarking (no staging, no D2H):
        frames and reset flags are device tensors of ``step``'s shapes,
        copied into the static device inputs. Returns the device outputs
        (alpha, out), the packed words twice on the packed path, valid
        until the next dispatch. On a mesh each position copies its
        streams in and the outputs are joined on the first position's
        device, on the caller's current stream."""
        k = self.chunk
        if len(self._shards) == 1:
            out = self._shards[0].run_device(k, frames_u8, reset_mask)
            self._shards[0].capture_after_warm_up(k)
            return (out, out) if self._packed else out
        axis = 0 if k == 1 else 1
        outs = [sh.run_device(k, frames_u8.narrow(axis, sh.lo, sh.hi - sh.lo),
                              reset_mask.narrow(axis, sh.lo,
                                                sh.hi - sh.lo))
                for sh in self._shards]
        dev = self._shards[0].pos.device
        parts = []
        for sh, o in zip(self._shards, outs):
            sh.pos.join()
            parts.append(sh.pos.hand_over(o if isinstance(o, tuple)
                                          else (o,)))
        out = tuple(torch.cat([p[i].to(dev, non_blocking=True)
                               for p in parts], dim=axis)
                    for i in range(len(parts[0])))
        for sh in self._shards:
            sh.capture_after_warm_up(k)
        if self._packed:
            return out[0], out[0]
        return out

    def serve(self, stream_sources: Sequence[Iterable[np.ndarray]],
              on_output=None, max_frames: Optional[int] = None) -> dict:
        """Drive S live streams: one decode thread per stream into a queue
        of 4 -> the batched step -> on_output(stream_idx, frame_idx,
        alpha, out) for each live stream.

        A stream that ends keeps its slot with its last frame and a
        standing reset flag, so the batch never stalls. Full chunks go
        through the K-round dispatch; a partial tail (a stream ending or
        the max_frames boundary inside a chunk) drains round by round, with
        no filler frames. Each frame is padded straight into its slot of
        the pinned batch. Returns the RunMetrics summary with
        ``batch_steps``, ``stream_fps`` and, at chunk K > 1,
        ``latency_granularity``."""
        qs: List[queue.Queue] = [queue.Queue(maxsize=4)
                                 for _ in range(self.s)]
        end = object()
        stop = threading.Event()

        def produce(i, src):
            try:
                for frame in src:
                    if stop.is_set():
                        break
                    qs[i].put(frame)
            finally:
                qs[i].put(end)

        threads = [threading.Thread(target=produce, args=(i, s), daemon=True)
                   for i, s in enumerate(stream_sources)]
        for t in threads:
            t.start()

        metrics = RunMetrics()
        zero = np.zeros((self.h, self.w, self.in_c), np.uint8)
        last = [None] * self.s
        alive = [True] * self.s
        n = 0

        def gather_round():
            """One round: the frame of each stream (its last one once it
            ended), the reset flags and which streams are live; None when
            every stream is done and drained."""
            reset = np.zeros((self.s,), bool)
            for i in range(self.s):
                if not alive[i]:
                    continue
                item = qs[i].get()
                if item is end:
                    alive[i] = False
                    reset[i] = True  # the slot recycles; its state cleared
                else:
                    last[i] = item
            if all(f is None for f in last):
                return None
            return ([zero if f is None else f for f in last], reset,
                    list(alive))

        try:
            while any(alive) and (max_frames is None or n < max_frames):
                want = self.chunk if max_frames is None else min(
                    self.chunk, max_frames - n)
                rounds = []
                while len(rounds) < want and any(alive):
                    r = gather_round()
                    if r is None:
                        break
                    rounds.append(r)
                if not rounds:
                    break
                k = len(rounds)
                t0 = time.perf_counter()
                if self.chunk > 1 and k == self.chunk:
                    self._stage(k, [r[0] for r in rounds],
                                [r[1] for r in rounds])
                    alpha, out = self._dispatch(k)
                    per_round = [(alpha[j], out[j]) for j in range(k)]
                else:
                    per_round = []
                    for frames, reset, _ in rounds:
                        self._stage(1, [frames], reset)
                        per_round.append(self._dispatch(1))
                dt = time.perf_counter() - t0
                for _ in range(k):
                    metrics.record_frame(dt / k)
                if on_output is not None:
                    for j, (a_j, o_j) in enumerate(per_round):
                        for i in range(self.s):
                            if rounds[j][2][i]:
                                on_output(i, n + j, a_j[i], o_j[i])
                n += k
        finally:
            # Unblock producers waiting on a full queue, then let them end.
            stop.set()
            for q in qs:
                while not q.empty():
                    q.get_nowait()
            for t in threads:
                t.join(timeout=10.0)
        summary = metrics.summary()
        summary["batch_steps"] = n
        summary["stream_fps"] = summary.get("fps", 0.0) * self.s
        if self.chunk > 1:
            # dt / k is an amortized per-round cost, not an observed
            # per-frame latency.
            summary["latency_granularity"] = (
                f"per-{self.chunk}-round-dispatch")
        return summary


def _round_body(body: Callable, plan, composited: bool) -> Callable:
    """One round of a position's streams: the serving body on its frames
    after the reset flags zeroed their carry; the packed words, or the
    alpha byte and the composite (or the raw foreground)."""
    def round_body(frames, reset, state):
        out, new_state = body(frames, reset_streams(state, reset))
        if plan.packed:
            return out, new_state
        alpha_u8, fgr_u8, rgba = out
        return (alpha_u8, rgba if composited else fgr_u8), new_state

    return round_body


class _Shard:
    """The streams [lo, hi) of a MultiStreamMatting on one position: the
    dispatch bodies by rounds (a round, and K rounds at chunk K; a
    partial tail of serve drains round by round), the carry, the staging
    and the graphs by dispatch shape. Its device work runs under
    ``pos.active()``: its device and stream."""

    def __init__(self, owner: MultiStreamMatting, pos: Position, lo: int,
                 hi: int, round_body: Callable, state):
        # A weak reference: no cycle holds the graphs (see ChunkGraph).
        self.owner, self.pos, self.lo, self.hi = (weakref.proxy(owner), pos,
                                                  lo, hi)
        self.n = hi - lo
        self.bodies = {1: round_body}
        if owner.chunk > 1:
            self.bodies[owner.chunk] = per_round_chunk(round_body)
        self.state = state
        self.io = {}
        self.graphs = {}
        self.capture_ms = None

    def staging(self, k: int):
        """(frames, reset, outputs) buffers of a k-round dispatch, made at
        its first use and reused: pinned host slots (two, alternating)
        beside static device inputs of (n, H, W, C) frames and (n,)
        uint8 reset flags, each with a leading K axis when k > 1, and
        pinned output buffers."""
        io = self.io.get(k)
        if io is None:
            o = self.owner
            lead = (self.n,) if k == 1 else (k, self.n)
            with annotate("build"):
                io = self.io[k] = (
                    Uploads(lead + (o.h, o.w, o.in_c), torch.uint8,
                            self.pos.device),
                    Uploads(lead, torch.uint8, self.pos.device),
                    Downloads(lead[0], self.pos.device))
        return io

    def stage(self, k: int, rounds, resets) -> None:
        """Pad k rounds of this position's frames into the pinned slot,
        and its reset rows (k, n) beside them."""
        o = self.owner
        up_f, up_r, _ = self.staging(k)
        slot = up_f.slot().numpy().reshape(k, self.n, o.h, o.w, o.in_c)
        for j, frames in enumerate(rounds):
            for i, f in enumerate(frames):
                o._check_channels(f.shape[-1])
                pad_into(f, slot[j, i])
        up_r.slot().numpy().reshape(k, self.n)[:] = resets

    def send(self, k: int) -> None:
        up_f, up_r, _ = self.staging(k)
        with self.pos.active():
            up_f.send(up_f.dev.shape[0])
            up_r.send(up_r.dev.shape[0])

    def run(self, k: int):
        """The k-round body on the static device inputs: the graph's
        replay once captured, else eagerly. Returns its device output
        (valid until the next dispatch of this shape)."""
        up_f, up_r, _ = self.staging(k)
        g = self.graphs.get(k)
        with self.pos.active(), torch.inference_mode():
            if g is not None:
                out, self.state = g(self.state)
            else:
                with annotate("eager"):
                    out, self.state = self.bodies[k](up_f.dev, up_r.dev,
                                                     self.state)
        return out

    def run_device(self, k: int, frames: torch.Tensor, reset: torch.Tensor):
        """``run`` on device tensors copied into the static inputs (after
        the caller's current stream's work that made them)."""
        up_f, up_r, _ = self.staging(k)
        self.pos.follow_current(frames.device)
        with self.pos.active(), torch.inference_mode():
            up_f.dev.copy_(frames, non_blocking=True)
            up_r.dev.copy_(reset, non_blocking=True)
        return self.run(k)

    def capture_after_warm_up(self, k: int) -> Optional[float]:
        """Capture the k-round body after its first (eager) dispatch on a
        CUDA position; returns the capture's ms, or None."""
        if (k in self.graphs or not self.owner.capture
                or self.pos.device.type != "cuda"):
            return None
        up_f, up_r, _ = self.staging(k)
        with annotate("capture", timed=True) as span, self.pos.active():
            g = ChunkGraph(self.bodies[k], (up_f.dev, up_r.dev), self.state)
        self.graphs[k] = g
        self.state = g.state
        self.capture_ms = span.ms
        return self.capture_ms

    def download(self, k: int, out):
        """Enqueue the copy of a dispatch's output into pinned buffers on
        this position's stream; returns the handle ``read`` takes."""
        downs = self.staging(k)[2]
        with self.pos.active():
            i = downs.open(out)
            downs.put(i, 0, out)
            n = (out[0] if isinstance(out, tuple) else out).shape[0]
            return downs.close(i, n, isinstance(out, tuple))

    def read(self, k: int, handle, rgba: Optional[np.ndarray] = None):
        """Wait for the copy, then the packed words unpacked to owned
        (..., 4) RGBA (alpha its last channel), or owned copies of the
        uint8 tuple. With ``rgba`` (the whole dispatch's RGBA, streams on
        axis 0, or 1 at k > 1) the words are unpacked into this
        position's streams of it, and None is returned."""
        downs = self.staging(k)[2]
        try:
            arrs = downs.read(handle)
            if not self.owner._packed:
                return tuple(np.array(a) for a in arrs)
            if rgba is None:
                rgba = unpack_rgba(arrs)
                return rgba[..., 3:4], rgba
            if k == 1:
                unpack_rgba(arrs, out=rgba[self.lo:self.hi])
            else:
                for j in range(k):
                    unpack_rgba(arrs[j], out=rgba[j, self.lo:self.hi])
            return None
        finally:
            downs.release(handle)
