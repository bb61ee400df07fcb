"""Two-stage pipelined serving of recurrent streams (counterpart of
vidmat/parallel/pp.py).

A recurrent stream cannot be split over devices by frames: frame t's net
pass takes frame t-1's state. Its serving chain splits at the
coefficient boundary of the fused packed tail
(``ServingPlan.fused_stage0/1``):

  stage 0 (coarse, recurrent):  ingest -> net -> GF coefficient grids
  stage 1 (full-res, stateless): fused refine + composite -> packed RGBA

Stage 1 of frame t needs frame t and its grids, not the state, so the
position of stage 1 refines frame t-1 while the position of stage 0 runs
the net on frame t: a round costs max(t0, t1) and the handoff, not t0 +
t1, and the output comes one round late.

Each stream is a row of a ('stream', 'pp') mesh (``make_mesh``): stage 0
runs on position (s, 0) and owns the recurrent state; stage 1 runs on
position (s, 1) and holds the pending frame and its grids. Each position
runs under its device and, on CUDA, its own stream (``parallel/mesh.py``).
A round, per row:

  - the frame goes from one pinned host slot to both positions (the JAX
    package replicates it over 'pp', :245-248): it never moves between
    the devices;
  - position 0 runs stage 0 on the frame;
  - position 1 runs stage 1 on the pending frame and grids, at the same
    time;
  - the handoff: once stage 0 is done (a CUDA event), position 1 copies
    its grids (2 x (1, H/4, W/4, 4) float32, 4.18 MB at 1080p; with
    bg_blur the coarse background too, 1.57 MB) into the pending slots,
    the frame with them; the next round's stage 0 waits for the handoff
    (an event) before it writes its grids again: the JAX package's
    lockstep.

With ``chunk`` K a dispatch runs K rounds: stage 0 on f0 .. f_{K-1}, stage
1 on [pending, f0 .. f_{K-2}], and f_{K-1} becomes pending (:222-243).
Stage 1's rounds after the first refine this dispatch's frames, so at K >
1 it waits for stage 0 of its dispatch: the stages overlap at chunk 1.

Each stage is one body per dispatch shape: stage 0 is K calls of
``fused_stage0`` (the state carried from each to the next), stage 1 one
call of ``fused_stage1`` on the K frames. On CUDA both run eagerly on the
first dispatch (the warm-up) and as one ``ChunkGraph`` replay each after
it, each on its position's stream. The stages are the closures the
one-shot body is composed of, so the pipelined bytes are the bytes of
one-device serving.

Two positions on one card (``make_mesh(("pp",), devices=["cuda:0"] *
2)``) run the two stages on two streams of it; positions on two cards
copy the grids between them (PyTorch's peer copy).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.io.native import unpack_rgba
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.parallel.mesh import Mesh, Position
from vidmat_torch.pipeline.graph import ChunkGraph
from vidmat_torch.pipeline.stepfactory import build_serving_body
from vidmat_torch.utils.profiling import annotate


class PipelinedStreams:
    """S independent recurrent streams, each 2-stage pipelined, over a
    ('stream', 'pp') mesh of S x 2 positions.

    step(frames_u8 (S, H, W, C)) -> (alpha (S, H, W, 1), rgba (S, H, W,
    4)) for the PREVIOUS round (None on the first call, while the
    pipeline fills); flush() drains the last round in flight. convert()
    hides the skew and yields one aligned (alpha, rgba) round per input
    round. C is 3 (RGB) or 4 for a trimap-conditioned ``cfg`` (RGB and
    the uint8 {0, 128, 255} trimap).

    The signature is the JAX package's; the devices are the mesh's (a
    mesh of CPU positions runs the plain PyTorch versions of the
    kernels). ``use_pallas=False`` has no fused tail and raises, as
    there; ``pallas_interpret`` changes nothing (the CUDA kernels run on
    the card)."""

    def __init__(self, num_streams: int, height: int, width: int,
                 mesh: Mesh,
                 cfg: ModelConfig = ModelConfig(), variables=None,
                 downsample_ratio: float = 0.25,
                 refine: RefineConfig = RefineConfig(),
                 dtype: str = "bfloat16",
                 bg_color: Optional[Tuple[float, float, float]] = None,
                 bg_blur: Optional[int] = None,
                 bg_plate: Optional[np.ndarray] = None,
                 tile_size: Optional[int] = None,
                 tile_overlap: int = 64,
                 chunk: int = 1,
                 use_pallas: Optional[bool] = None,
                 pallas_interpret: bool = False):
        shape = dict(mesh.shape)
        if (len(mesh.axis_names) != 2
                or mesh.devices.shape[1] != 2
                or mesh.devices.shape[0] != num_streams):
            raise ValueError(
                f"PipelinedStreams needs a ('stream', 'pp')-shaped 2-axis "
                f"mesh of num_streams x 2 devices; got num_streams="
                f"{num_streams}, mesh {shape}")
        if not mesh.local.all():
            raise ValueError("PipelinedStreams takes a mesh of one "
                             "process's positions")
        if height % 16 or width % 16:
            raise ValueError("height/width must be multiples of 16")
        if bg_blur and bg_color is not None:
            raise ValueError("bg_blur composites over a blur of the "
                             "source frame; it is mutually exclusive "
                             "with bg_color")
        self.s = num_streams
        self.h, self.w = height, width
        self.in_c = 4 if cfg.use_trimap else 3
        self.cfg = cfg
        self.variables = (variables if variables is not None
                          else default_variables(cfg))
        self.chunk = max(1, chunk)
        self.mesh = mesh
        cdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self._use_blur = bool(bg_blur)
        self._bg = ([float(v) for v in bg_color] if bg_color is not None
                    else None)

        def plan_on(device):
            net = build_network(
                cfg, self.variables,
                dtype=cdtype if cdtype == torch.bfloat16 else None,
                device=device)
            # The clean plate is a constant of stage 0 (ingested at build
            # time): it never rides the handoff.
            _, plan = build_serving_body(
                net, cfg, refine, height, width, downsample_ratio,
                cdtype=cdtype, bg=bg_color, use_pallas=use_pallas,
                tile_size=tile_size, tile_overlap=tile_overlap,
                bg_blur=bg_blur, bg_plate=bg_plate)
            if plan.fused_stage0 is None:
                raise ValueError(
                    "pipeline-parallel serving needs the fully fused tail: "
                    "an integer downsample pool > 1, refine mode 'guided' "
                    "and the kernels' branch (got pool="
                    f"{plan.pool}, mode={refine.mode!r}, "
                    f"use_pallas={use_pallas})")
            return plan

        self._rows = []
        for s in range(num_streams):
            pos0, pos1 = (Position(d) for d in mesh.devices[s])
            self._rows.append(_Row(self, pos0, plan_on(pos0.device), pos1,
                                   plan_on(pos1.device)))
        self._slots = [None, None]   # pinned (S, K, H, W, C) host rounds
        self._slot_events = [[], []]
        self._slot_i = 0
        self._outs = None            # pinned (S, K, H, W) packed words
        self._fed = 0
        self._last = None
        self.reset()

    @property
    def positions(self):
        """The positions, row by row: (stage 0, stage 1) of each stream."""
        return [p for r in self._rows for p in (r.pos0, r.pos1)]

    def reset(self) -> None:
        """Empty the pipeline and zero the recurrent state."""
        for r in self._rows:
            r.reset()
        self._fed = 0
        self._last = None

    def _check_channels(self, frames_u8) -> None:
        if frames_u8.shape[-1] != self.in_c:
            kind = ("trimap-conditioned (RGB + trimap channel)"
                    if self.in_c == 4 else "RGB")
            raise ValueError(
                f"frames have {frames_u8.shape[-1]} channels; this "
                f"{kind} model takes {self.in_c}")

    def _slot(self) -> int:
        """The index of the next pinned host slot of a dispatch's rounds,
        (S, K, H, W, C), once the copies last made out of it are done."""
        i, self._slot_i = self._slot_i, self._slot_i ^ 1
        if self._slots[i] is None:
            cuda = self._rows[0].pos0.device.type == "cuda"
            self._slots[i] = torch.empty(
                (self.s, self.chunk, self.h, self.w, self.in_c),
                dtype=torch.uint8, pin_memory=cuda)
        for ev in self._slot_events[i]:
            ev.synchronize()
        self._slot_events[i] = []
        return i

    def _dispatch(self, rounds_u8: np.ndarray) -> np.ndarray:
        """Run one (possibly chunked) dispatch on (K, S, H, W, C) rounds;
        returns host RGBA (K, S, H, W, 4) in feed order: round k is the
        output for the round fed one round BEFORE rounds_u8[k]."""
        self._check_channels(rounds_u8)
        k = rounds_u8.shape[0]
        want = (self.chunk, self.s, self.h, self.w, self.in_c)
        if rounds_u8.shape != want:
            raise ValueError(f"a dispatch takes {want} uint8 rounds; got "
                             f"{rounds_u8.shape}")
        i = self._slot()
        slot = self._slots[i]
        slot.numpy()[:] = np.asarray(rounds_u8).swapaxes(0, 1)
        outs = [r.dispatch(slot[s], self._slot_events[i])
                for s, r in enumerate(self._rows)]
        if self._outs is None:
            self._outs = torch.empty(
                (self.s, k, self.h, self.w), dtype=outs[0].dtype,
                pin_memory=self._rows[0].pos0.device.type == "cuda")
        done = []
        for s, (r, out) in enumerate(zip(self._rows, outs)):
            with r.pos1.active():
                self._outs[s].copy_(out, non_blocking=True)
                done.append(r.pos1.event())
        for ev in done:
            if ev is not None:
                ev.synchronize()
        for r in self._rows:
            r.capture_after_warm_up()
        return unpack_rgba(self._outs.numpy().swapaxes(0, 1))

    def step_device(self, frames_u8: torch.Tensor):
        """Device-resident dispatch for benchmarking (no staging, no D2H):
        (K, S, H, W, C) uint8 frames on a device, copied to both positions
        of each row after the caller's current stream's work. Returns
        each row's (K, H, W) packed words on its stage-1 position, valid
        until the next dispatch."""
        outs = [r.dispatch(frames_u8[:, s], None)
                for s, r in enumerate(self._rows)]
        for r in self._rows:
            r.capture_after_warm_up()
        return outs

    def step(self, frames_u8: np.ndarray
             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Feed one (S, H, W, C) uint8 round; returns (alpha (S, H, W, 1),
        rgba (S, H, W, 4)) for the PREVIOUS round, or None on the first
        call while the pipeline fills. chunk must be 1 for the streaming
        step; use convert() for chunked throughput mode."""
        if self.chunk != 1:
            raise ValueError("step() is the chunk=1 streaming API; "
                             "use convert() with chunk>1")
        rgba = self._dispatch(np.asarray(frames_u8)[None])[0]
        self._fed += 1
        self._last = np.asarray(frames_u8)
        if self._fed == 1:
            return None
        return rgba[..., 3:4], rgba

    def flush(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Drain the round in flight (re-feeds the last round to advance
        the pipe; its stage-0 work is discarded, but the recurrent state
        advances over it, as in the JAX package). chunk must be 1: the
        streaming step/flush pair; convert() drains chunked dispatches
        itself."""
        if self.chunk != 1:
            raise ValueError("flush() is the chunk=1 streaming API; "
                             "convert() drains the pipeline itself "
                             "with chunk>1")
        if self._fed == 0 or self._last is None:
            return None
        rgba = self._dispatch(self._last[None])[0]
        return rgba[..., 3:4], rgba

    def convert(self, rounds: Iterable[np.ndarray]
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Pipeline a whole clip of (S, H, W, C) rounds: yields (alpha,
        rgba) aligned 1:1 with the input rounds (the 1-round skew and the
        tail drain are handled here). Resets the state first; the
        pipeline is drained when the iterator ends."""
        self.reset()
        # Output k refines input k-1 (inputs 0 .. n-1 real, n .. repeats
        # of the last round), so the aligned outputs are 1 <= k <= n.
        k = 0
        n_seen = 0
        buf: list = []
        last = None

        def run(chunk_rounds, n_total=None):
            nonlocal k
            out = self._dispatch(np.stack(chunk_rounds))
            self._fed += len(chunk_rounds)
            for rgba in out:
                if k >= 1 and (n_total is None or k <= n_total):
                    yield rgba[..., 3:4], rgba
                k += 1

        for f in rounds:
            buf.append(np.asarray(f))
            last = buf[-1]
            n_seen += 1
            if len(buf) == self.chunk:
                yield from run(buf)
                buf = []
        if last is None:
            return
        # Drain: at least one more round pushes the last output out; the
        # trailing chunk is padded with repeats of the last round, whose
        # outputs the k gate above drops.
        pad = (self.chunk - len(buf)) or self.chunk
        buf.extend([last] * pad)
        yield from run(buf, n_total=n_seen)


class PipelinedMatting(PipelinedStreams):
    """Two-position stage-pipelined serving of ONE recurrent stream: the
    S=1 adapter over PipelinedStreams on a 1-axis mesh of 2 positions,
    with the single-stream (H, W, C) frame API.

    step(frame_u8 (H, W, C)) -> (alpha (H, W, 1), rgba (H, W, 4)) for the
    PREVIOUS frame (None on the first call); flush() drains the last
    frame in flight; convert(frames) yields one aligned output per input
    frame."""

    def __init__(self, height: int, width: int, mesh: Mesh, **kwargs):
        if mesh.devices.size != 2 or len(mesh.axis_names) != 1:
            raise ValueError(
                "PipelinedMatting needs a 1-axis mesh of exactly 2 devices "
                f"(got shape {dict(mesh.shape)}); for N streams x 2 stages "
                "use PipelinedStreams on a ('stream', 'pp') mesh of Nx2 "
                "devices")
        m2 = Mesh(mesh.devices.reshape(1, 2), ("stream", mesh.axis_names[0]),
                  mesh.process_ids, mesh.process_index)
        super().__init__(1, height, width, m2, **kwargs)

    def step(self, frame_u8: np.ndarray
             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        r = super().step(np.asarray(frame_u8)[None])
        return None if r is None else (r[0][0], r[1][0])

    def flush(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        r = super().flush()
        return None if r is None else (r[0][0], r[1][0])

    def convert(self, frames: Iterable[np.ndarray]
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for alpha, rgba in super().convert(
                np.asarray(f)[None] for f in frames):
            yield alpha[0], rgba[0]


class _Row:
    """One stream's two positions: stage 0 and its recurrent state on
    pos0; stage 1, the pending frame and its grids on pos1. Static
    buffers of the owner's dispatch shape (K rounds): pos0's frames (K,
    1, H, W, C); pos1's frames and grids, K + 1 slots each (slot 0 the
    pending round, slots 1 .. K this dispatch's)."""

    def __init__(self, owner: PipelinedStreams, pos0: Position, plan0,
                 pos1: Position, plan1):
        # A weak reference: no cycle holds the graphs (see ChunkGraph).
        self.owner = weakref.proxy(owner)
        self.pos0, self.pos1 = pos0, pos1
        self.plan0 = plan0
        self.stage0, self.stage1 = plan0.fused_stage0, plan1.fused_stage1
        k, h, w, c = owner.chunk, owner.h, owner.w, owner.in_c
        hl, wl = plan0.net_h, plan0.net_w
        with pos0.active():
            self.f0 = torch.zeros((k, 1, h, w, c), dtype=torch.uint8,
                                  device=pos0.device)
        widths = (4, 4, 3) if owner._use_blur else (4, 4)
        with pos1.active():
            self.f1 = torch.zeros((k + 1, 1, h, w, c), dtype=torch.uint8,
                                  device=pos1.device)
            self.grids = tuple(torch.zeros((k + 1, 1, hl, wl, g),
                                           device=pos1.device)
                               for g in widths)
        self.state = None
        self.g0 = self.g1 = None
        self.capture_ms = None   # (stage 0, stage 1) once captured
        self.handed = None   # event: the last handoff done (pos1)

    def reset(self) -> None:
        with self.pos0.active():
            state = self.plan0.make_state(1)
        self.state = state
        with self.pos1.active():
            self.f1.zero_()
            for g in self.grids:
                g.zero_()

    def _body0(self, frames, state):
        """Stage 0 on K rounds: the grids of each, stacked (K, 1, ...),
        and the state after the last."""
        outs = []
        for j in range(frames.shape[0]):
            grids, state = self.stage0(frames[j], state)
            outs.append(grids)
        return tuple(torch.stack(g) for g in zip(*outs)), state

    def _body1(self, frames, *rest):
        """Stage 1 on the first K slots (the pending round, then this
        dispatch's first K - 1) as one batch of K frames."""
        *grids, _ = rest
        k = frames.shape[0] - 1
        ma, mb, *bg = (g[:k].flatten(0, 1) for g in grids)
        bgv = bg[0] if bg else self.owner._bg
        return self.stage1(frames[:k].flatten(0, 1), ma, mb, bgv), None

    def _handoff_scope(self):
        """pos1's scope for the handoff; a copy between two devices runs
        on the source's current stream, so pos0's stream is made current
        on its device first."""
        stack = contextlib.ExitStack()
        if (self.pos0.stream is not None
                and self.pos0.device != self.pos1.device):
            stack.enter_context(torch.cuda.stream(self.pos0.stream))
        stack.enter_context(self.pos1.active())
        return stack

    def _hand(self, grids, src: slice, dst: slice) -> None:
        for g, t in zip(self.grids, grids):
            g[dst].copy_(t[src], non_blocking=True)

    def dispatch(self, frames: torch.Tensor, slot_events):
        """One dispatch of this row: ``frames`` (K, H, W, C) uint8, on
        the host (pinned) or on a device, to both positions; stage 0 and
        stage 1 (see the module docstring); returns stage 1's (K, H, W)
        packed words on pos1. The events after which ``frames`` may be
        rewritten are appended to ``slot_events`` (a list, or None)."""
        k = self.owner.chunk
        src = frames.reshape(k, 1, *frames.shape[1:])
        if src.device.type == "cuda":
            self.pos0.follow_current(src.device)
            self.pos1.follow_current(src.device)
        with self.pos0.active(), torch.inference_mode():
            self.f0.copy_(src, non_blocking=True)
            self.pos0.wait(self.handed)
            if self.g0 is not None:
                grids, self.state = self.g0(self.state)
            else:
                grids, self.state = self._body0(self.f0, self.state)
            staged = self.pos0.event()
        with self._handoff_scope(), torch.inference_mode():
            self.f1[1:].copy_(src, non_blocking=True)
            if self.g0 is None:
                # Eager grids are read on pos1's stream: kept from reuse
                # until then.
                self.pos0.hand_over(grids)
            if k > 1:
                self.pos1.wait(staged)
                self._hand(grids, slice(0, k - 1), slice(1, k))
            if self.g1 is not None:
                out, _ = self.g1(None)
            else:
                out, _ = self._body1(self.f1, *self.grids, None)
            if k == 1:
                self.pos1.wait(staged)
            self._hand(grids, slice(k - 1, k), slice(0, 1))
            self.f1[0].copy_(self.f1[k])
            self.handed = self.pos1.event()
        if slot_events is not None and staged is not None:
            slot_events += [staged, self.handed]
        return out

    def capture_after_warm_up(self) -> None:
        """Capture both stages after the first (eager) dispatch on CUDA
        positions."""
        if self.g0 is not None or self.pos0.device.type != "cuda":
            return
        with annotate("capture", timed=True) as span0, self.pos0.active():
            self.g0 = ChunkGraph(self._body0, self.f0, self.state)
            self.state = self.g0.state
        with annotate("capture", timed=True) as span1, self.pos1.active():
            self.g1 = ChunkGraph(self._body1, (self.f1, *self.grids), None)
        self.capture_ms = (span0.ms, span1.ms)
