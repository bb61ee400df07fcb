"""AOT serving bundles: the serving step exported with ``torch.export``
(counterpart of vidmat/deploy.py).

A serving host should not need the model definition or a trace at start
up. ``export_bundle`` traces the serving body once with
``torch.export.export`` and saves the program with ``torch.export.save``;
the hand-written kernels are registered custom ops
(``vidmat_torch::*``, ``ops/library.py``), so each kernel launch is one
node of the program, as the JAX bundle embeds its Pallas calls in the
exported StableHLO. ``ServingBundle`` loads and drives it with nothing
but torch, numpy, the op library and the port's IO: it imports no module
of ``vidmat_torch.models`` and not the step factory.

A bundle is a directory:

    manifest.json   static facts: shapes, dtypes, output contract, platforms
    step.pt2        the per-frame serving step (torch.export)
    chunk.pt2       optional chunk step (pipe_cfg.chunk_size > 1)
    state0.npz      initial recurrent carry, flattened leaves

Design notes:
  - The exported step takes the (S, ph, pw, C) uint8 frame batch and the
    FLATTENED carry (a list of tensors; npz key order is the contract) and
    returns the outputs and the new flattened carry; the weights, the
    baked background and the baked clean plate are constants of the
    program (the JAX bundle passes its weights as a params.npz input).
    The carry's structure is checked against the initial state at export.
  - A program is pinned to the device it was exported on: its constants
    live there and its kernels are that device's. The manifest records
    ``platforms`` (``["cuda"]`` or ``["cpu"]``) and the loader refuses
    another device.
  - On the card ``ServingBundle`` runs each program eagerly once, then
    replays it as one CUDA graph per step or chunk over reused input,
    carry and outputs (``pipeline/graph.py`` ``ChunkGraph``), staged
    through reused pinned host buffers (one copy each way per call). A
    static-skip bundle's step holds a ``torch.cond`` (the host branch of
    the live body, taken on the device): it is not capturable and runs
    eagerly, as the live static-skip body does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from vidmat_torch._device import full_fp32, resolve_device
from vidmat_torch.config import ModelConfig, PipelineConfig
from vidmat_torch.io.native import pad_into, unpack_rgba
from vidmat_torch.pipeline.trimap import canon_trimap_u8

_FORMAT_VERSION = 1


# ---- leaf (de)serialization: npz with a dtype list in the manifest ----
# numpy has no bfloat16: such a leaf is stored as its uint16 bit pattern
# and its dtype recorded in the manifest.

def _save_leaves(path: str, leaves) -> list:
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        t = leaf.detach().cpu()
        dtypes.append(str(t.dtype).replace("torch.", ""))
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arrays[f"leaf_{i:04d}"] = t.numpy()
    np.savez(path, **arrays)
    return dtypes


def _load_leaves(path: str, dtypes: list, device: torch.device) -> list:
    with np.load(path) as z:
        leaves = []
        for i, dt in enumerate(dtypes):
            t = torch.from_numpy(z[f"leaf_{i:04d}"])
            if dt == "bfloat16":
                t = t.view(torch.bfloat16)
            leaves.append(t.to(device))
    return leaves


class _Program(torch.nn.Module):
    """The function ``torch.export`` traces: (frames, flat carry) ->
    (outputs, new flat carry). ``net`` is held so that its weights are
    buffers of the program."""

    def __init__(self, fn, spec, net: torch.nn.Module):
        super().__init__()
        self.fn, self.spec, self.net = fn, spec, net

    def forward(self, frames, state):
        out, new_state = self.fn(frames, tree_unflatten(list(state),
                                                        self.spec))
        leaves, spec = tree_flatten(new_state)
        if spec != self.spec:
            raise AssertionError(
                f"serving body changed the state tree structure: {spec} != "
                f"{self.spec}")
        return out, leaves


def chunk_step(body, plan, num_streams: int = 1):
    """The chunk step of a bundle: fn(frames (K, S, ph, pw, C), state) ->
    (outputs with a leading (K, S), state). The plan's chunk body where
    it has one (one stream), else K calls of the per-frame body, the
    state carried from each to the next (vidmat/deploy.py:236-259)."""
    if plan.chunk_body is not None and num_streams == 1:
        def run(frames, state):
            # (K, 1, ...) frames as the chunk body's K-frame batch
            out, state = plan.chunk_body(frames[:, 0], state)
            return out.unsqueeze(1), state
        return run

    def run(frames, state):
        outs = []
        for j in range(frames.shape[0]):
            out, state = body(frames[j], state)
            outs.append(out)
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(ts) for ts in zip(*outs)), state
        return torch.stack(outs), state
    return run


def serving_body(height: int, width: int, *,
                 model_cfg: Optional[ModelConfig] = None,
                 pipe_cfg: Optional[PipelineConfig] = None,
                 variables=None,
                 downsample_ratio: Optional[float] = None,
                 bg_color: Optional[Tuple[float, float, float]] = (0.0, 1.0,
                                                                   0.0),
                 bg_image: Optional[Union[str, np.ndarray]] = None,
                 bg_blur: Optional[int] = None,
                 bg_plate: Optional[Union[str, np.ndarray]] = None,
                 alpha_only: bool = False,
                 need_fgr: bool = False,
                 num_streams: int = 1,
                 output: str = "matte",
                 device: Union[str, torch.device] = "cuda",
                 export: bool = False):
    """The serving body a bundle of these arguments (``export_bundle``'s)
    holds: (body, plan, net, meta), meta holding the resolved
    configurations, ratio, padded size and background kind. With
    ``export=False`` it is the live body the bundle is held to."""
    from vidmat_torch.io.backgrounds import prepare_bg_image, prepare_plate_u8
    from vidmat_torch.models.weights import (build_network,
                                             default_variables,
                                             plate_default_config,
                                             seg_default_variables)
    from vidmat_torch.pipeline.stepfactory import build_serving_body
    from vidmat_torch.pipeline.video import auto_downsample_ratio

    dev = resolve_device(device)
    if bg_plate is not None and model_cfg is None:
        # A bare bg_plate selects the plate family, as every live entry
        # point does.
        model_cfg = plate_default_config()
    model_cfg = model_cfg or ModelConfig()
    pipe_cfg = pipe_cfg or PipelineConfig()
    if output not in ("matte", "seg"):
        raise ValueError(f"output must be 'matte' or 'seg', got {output!r}")
    if variables is None:
        variables = (seg_default_variables(model_cfg) if output == "seg"
                     else default_variables(model_cfg))
    if output == "seg" and "seg_head" not in variables["params"]:
        raise ValueError(
            "output='seg' needs a CO-TRAINED checkpoint (a seg_head "
            "subtree in the params): the shipped seg_demo")
    if num_streams < 1:
        raise ValueError(f"num_streams must be >= 1, got {num_streams}")

    ratio = downsample_ratio
    if ratio is None:
        ratio = pipe_cfg.downsample_ratio
    if ratio is None:
        ratio = auto_downsample_ratio(height, width)
    ph, pw = height + ((-height) % 16), width + ((-width) % 16)

    cdtype = torch.bfloat16 if pipe_cfg.dtype == "bfloat16" else torch.float32
    net_cfg = model_cfg
    if pipe_cfg.use_pallas is False:
        net_cfg = dataclasses.replace(net_cfg, conv_impl="xla")
    net = build_network(net_cfg, variables,
                        dtype=cdtype if cdtype == torch.bfloat16 else None,
                        device=dev)
    if bg_blur:
        bg, bg_kind = None, "blur"  # made from the frame inside the body
    elif bg_image is not None:
        bg, bg_kind = prepare_bg_image(bg_image, ph, pw), "image"
    elif bg_color is not None:
        bg, bg_kind = tuple(float(v) for v in bg_color), "color"
    else:
        bg, bg_kind = None, "none"
        need_fgr = True  # no background: packed words would premultiply
    plate = (prepare_plate_u8(bg_plate, ph, pw) if bg_plate is not None
             else None)
    body, plan = build_serving_body(
        net, model_cfg, pipe_cfg.refine, ph, pw, ratio, cdtype=cdtype,
        bg=bg, use_pallas=pipe_cfg.use_pallas, need_fgr=need_fgr,
        tile_size=pipe_cfg.tile_size, tile_overlap=pipe_cfg.tile_overlap,
        alpha_only=alpha_only, static_skip_eps=pipe_cfg.static_skip_eps,
        bg_blur=bg_blur if bg_kind == "blur" else None, bg_plate=plate,
        output_seg=(output == "seg"), export=export)
    meta = {"model_cfg": model_cfg, "pipe_cfg": pipe_cfg, "ratio": ratio,
            "padded_height": ph, "padded_width": pw, "bg_kind": bg_kind,
            "bg_blur": bg_blur if bg_kind == "blur" else None,
            "plate": plate is not None}
    return body, plan, net, meta


def export_bundle(out_dir: str, height: int, width: int, *,
                  model_cfg: Optional[ModelConfig] = None,
                  pipe_cfg: Optional[PipelineConfig] = None,
                  variables=None,
                  downsample_ratio: Optional[float] = None,
                  bg_color: Optional[Tuple[float, float, float]] = (0.0, 1.0,
                                                                    0.0),
                  bg_image: Optional[Union[str, np.ndarray]] = None,
                  bg_blur: Optional[int] = None,
                  bg_plate: Optional[Union[str, np.ndarray]] = None,
                  alpha_only: bool = False,
                  need_fgr: bool = False,
                  num_streams: int = 1,
                  output: str = "matte",
                  device: Union[str, torch.device] = "cuda") -> str:
    """Export an AOT serving bundle for a fixed (height, width) stream.

    height/width: the stream resolution (any size: padded to the /16
        bucket; the loader pads inputs and crops outputs).
    model_cfg/pipe_cfg: the axes of convert_video; the PRESETS for the
        ladder rungs. pipe_cfg.chunk_size > 1 also exports the chunk step
        (the plan's chunk body where it has one, else K per-frame bodies).
    variables: trained weights (nested numpy dict in the JAX package's
        layout); None loads the shipped checkpoint of model_cfg, or raises:
        a bundle of random weights is refused, as in the live API.
    bg_color/bg_image: the baked compositing background; bg_image takes
        precedence. Both None: the raw-foreground contract (the uint8
        tuple). Per-frame video backgrounds are not exportable.
    bg_blur: portrait blur (radius in full-resolution pixels): the bundle
        composites over a blur of its source frame, made on the device;
        takes precedence over bg_color/bg_image.
    bg_plate: the clean plate of the plate-conditioned family (path or
        array), ingested at export and baked into the program; the
        frame input stays RGB (plus the trimap byte).
    alpha_only: the bundle emits only the (H, W) uint8 alpha (packed
        path only).
    need_fgr: the bundle emits raw foreground (the uint8 tuple).
    num_streams: a batched multi-stream bundle: the step takes (S, H, W,
        C) frames with S independent carry slots; step() returns leading-S
        outputs; convert() stays single-stream.
    output="seg": the segmentation body (the co-trained seg head; the
        shipped seg_demo when variables=None): step returns the float32
        mask probability.
    device: "cuda" (default; raises without a CUDA device) or "cpu": the
        device the bundle is exported for and pinned to.

    Returns out_dir. The signature is the JAX package's, plus ``device``.
    """
    dev = resolve_device(device)
    body, plan, net, meta = serving_body(
        height, width, model_cfg=model_cfg, pipe_cfg=pipe_cfg,
        variables=variables, downsample_ratio=downsample_ratio,
        bg_color=bg_color, bg_image=bg_image, bg_blur=bg_blur,
        bg_plate=bg_plate, alpha_only=alpha_only, need_fgr=need_fgr,
        num_streams=num_streams, output=output, device=dev, export=True)
    model_cfg, pipe_cfg = meta["model_cfg"], meta["pipe_cfg"]
    ph, pw = meta["padded_height"], meta["padded_width"]
    state0 = plan.make_state(num_streams)
    s_leaves, s_spec = tree_flatten(state0)
    # Trimap-conditioned bundles take RGB and the trimap byte; a baked
    # plate is no frame channel.
    in_c = 4 if model_cfg.use_trimap else 3
    frames = torch.zeros((num_streams, ph, pw, in_c), dtype=torch.uint8,
                         device=dev)
    with full_fp32():
        # One eager call first: it builds the kernels and caches the
        # body's per-device constants (ops/guided_filter.py and others,
        # _device.device_constant), which the programs then hold.
        body(frames, plan.make_state(num_streams))
        step = torch.export.export(_Program(body, s_spec, net),
                                   (frames, list(s_leaves)))
        k = pipe_cfg.chunk_size
        chunk = None
        if k > 1:
            chunk = torch.export.export(
                _Program(chunk_step(body, plan, num_streams), s_spec, net),
                (frames[None].expand(k, -1, -1, -1, -1).contiguous(),
                 list(s_leaves)))

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(step, os.path.join(out_dir, "step.pt2"))
    if chunk is not None:
        torch.export.save(chunk, os.path.join(out_dir, "chunk.pt2"))
    s_dtypes = _save_leaves(os.path.join(out_dir, "state0.npz"), s_leaves)

    if output == "seg":
        pass  # manifest "output" stays "seg"
    elif plan.alpha_only:
        output = "alpha_only"
    elif plan.packed:
        output = "packed"
    else:
        output = "tuple"
    manifest = {
        "format_version": _FORMAT_VERSION,
        "height": height, "width": width,
        "padded_height": ph, "padded_width": pw,
        "downsample_ratio": meta["ratio"],
        "net_h": plan.net_h, "net_w": plan.net_w, "pool": plan.pool,
        "output": output,
        "bg": meta["bg_kind"],
        "bg_blur": meta["bg_blur"],
        "bg_plate": meta["plate"],
        "chunk": k if chunk is not None else 1,
        "num_streams": num_streams,
        "static_skip": plan.static_skip,
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "compute_capability": (
            "%d.%d" % torch.cuda.get_device_capability(dev)
            if dev.type == "cuda" else None),
        "model_cfg": dataclasses.asdict(model_cfg),
        "dtype": pipe_cfg.dtype,
        "params_dtypes": sorted({str(t.dtype).replace("torch.", "")
                                 for t in step.state_dict.values()}),
        "state_dtypes": s_dtypes,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class ServingBundle:
    """Load and drive an AOT serving bundle.

    >>> bundle = ServingBundle("bundle_1080p/")
    >>> out = bundle.step(frame)          # {"alpha": (H, W) u8, ...}
    >>> bundle.reset()                    # new stream / scene cut

    step() output keys by the bundle's contract (manifest "output"):
      alpha_only -> {"alpha"}; packed -> {"alpha", "comp"};
      tuple      -> {"alpha", "fgr", "comp"}; seg -> {"seg"} (float32).
    All other values are uint8, cropped to the exported (height, width).

    device: "cuda" (default; raises without a CUDA device) or "cpu"; a
    bundle exported for another device is refused. On the card each step
    or chunk after the first is one CUDA graph replay (a static-skip
    bundle runs eagerly). The signature is the JAX package's, plus
    ``device``.
    """

    def __init__(self, path: str,
                 device: Union[str, torch.device] = "cuda"):
        from vidmat_torch.ops import library  # noqa: F401 (the ops)

        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        m = self.manifest
        if m["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"bundle format {m['format_version']} is newer than this "
                f"loader ({_FORMAT_VERSION})")
        self.device = resolve_device(device)
        if self.device.type not in m["platforms"]:
            raise RuntimeError(
                f"bundle was exported for platforms {m['platforms']} but "
                f"the running device is '{self.device.type}': torch.export "
                "programs are platform-pinned; re-export on this platform")
        self._progs = {"step": torch.export.load(
            os.path.join(path, "step.pt2")).module()}
        chunk_path = os.path.join(path, "chunk.pt2")
        if os.path.exists(chunk_path):
            self._progs["chunk"] = torch.export.load(chunk_path).module()
        self._state0 = _load_leaves(os.path.join(path, "state0.npz"),
                                    m["state_dtypes"], self.device)
        self._state = [t.clone() for t in self._state0]
        self.h, self.w = m["height"], m["width"]
        self._ph, self._pw = m["padded_height"], m["padded_width"]
        self.chunk = m["chunk"]
        self.num_streams = m.get("num_streams", 1)
        self._in_c = (4 if m.get("model_cfg", {}).get("use_trimap")
                      else 3)
        self._graphs = {}
        self._inputs = {}
        self._outputs = {}

    def reset(self) -> None:
        """Reset the temporal carry (scene cut / new stream)."""
        self._state = [t.clone() for t in self._state0]

    def _pad_into(self, frame: np.ndarray, trimap: Optional[np.ndarray],
                  out: np.ndarray) -> None:
        """Check one (S, H, W, C) round (a single (H, W, C) frame for S=1
        bundles) against the exported shape and edge-pad it into ``out``,
        an (S, ph, pw, in_c) uint8 buffer."""
        frame = np.asarray(frame)
        if self.num_streams == 1 and frame.ndim == 3:
            frame = frame[None]
        if trimap is not None:
            if self._in_c != 4:
                raise ValueError("bundle is not trimap-conditioned")
            tri = np.asarray(trimap)
            if self.num_streams == 1 and tri.ndim in (2, 3):
                tri = tri[None]  # canon takes (H,W) / (H,W,1) / (H,W,3)
            tris = np.stack([canon_trimap_u8(tri[i], frame.shape[1:3])
                             for i in range(frame.shape[0])])
            frame = np.concatenate([frame, tris[..., None]], axis=-1)
        want = (self.num_streams, self.h, self.w, self._in_c)
        if frame.shape != want:
            raise ValueError(
                f"bundle serves (S, H, W, C) = {want} frames"
                + (" (trimap-conditioned: pass trimap= or 4-channel "
                   "frames)" if self._in_c == 4 else "")
                + f"; got {frame.shape}")
        for f, slot in zip(frame.astype(np.uint8, copy=False), out):
            pad_into(f, slot)

    def _pad(self, frame: np.ndarray,
             trimap: Optional[np.ndarray] = None) -> np.ndarray:
        """The exported (S, ph, pw, in_c) batch of a single (H, W, C) frame
        for S=1 bundles, or of an (S, H, W, C) round for batched ones."""
        out = np.empty((self.num_streams, self._ph, self._pw, self._in_c),
                       np.uint8)
        self._pad_into(frame, trimap, out)
        return out

    def _input(self, kind: str):
        """(host array, host tensor, device tensor): the reused input
        buffers of one program, the host one pinned on the card."""
        if kind not in self._inputs:
            lead = (self.chunk,) if kind == "chunk" else ()
            shape = (*lead, self.num_streams, self._ph, self._pw, self._in_c)
            cuda = self.device.type == "cuda"
            host = torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
            self._inputs[kind] = (host.numpy(), host, torch.empty(
                shape, dtype=torch.uint8, device=self.device))
        return self._inputs[kind]

    def _run(self, kind: str):
        """Run one program on its staged input from the current carry;
        returns its device outputs (valid until the next call)."""
        _, host, dev = self._input(kind)
        dev.copy_(host)
        prog = self._progs[kind]
        graph = self._graphs.get(kind)
        if graph is not None:
            out, self._state = graph(self._state)
            return out

        def call(frames, state):
            with full_fp32():
                return prog(frames, list(state))

        with torch.inference_mode():
            out, state = call(dev, self._state)
        self._state = list(state)
        if self.device.type == "cuda" and not self.manifest["static_skip"]:
            from vidmat_torch.pipeline.graph import ChunkGraph

            # Outputs of this eager call are read before the next call.
            graph = ChunkGraph(call, dev, self._state)
            self._graphs[kind] = graph
            self._state = graph.state
        return out

    def _to_host(self, kind: str, out):
        """One program's outputs copied into reused host buffers (pinned
        on the card), valid until the program's next call."""
        outs = out if isinstance(out, tuple) else (out,)
        bufs = self._outputs.get(kind)
        if bufs is None:
            pin = self.device.type == "cuda"
            bufs = self._outputs[kind] = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                for t in outs)
        for b, t in zip(bufs, outs):
            b.copy_(t)
        return bufs if isinstance(out, tuple) else bufs[0]

    def launches_per_replay(self, kind: str = "chunk") -> dict:
        """{wrapper name: launches} of one replay of a captured program
        (empty until it is captured)."""
        graph = self._graphs.get(kind)
        return graph.launches_per_replay() if graph is not None else {}

    def _unpack(self, outs) -> dict:
        """Host dict of outputs with the leading stream axis kept. uint8
        everywhere except the seg contract (the float32 mask
        probability)."""
        m = self.manifest
        h, w = self.h, self.w

        def owned(t):  # an array of the caller's own
            return np.array(t.cpu().numpy())

        if m["output"] == "seg":
            return {"seg": owned(outs[:, :h, :w, 0])}
        if m["output"] == "alpha_only":
            return {"alpha": owned(outs[:, :h, :w])}
        if m["output"] == "packed":
            # A program's words are int32 (ops/library.py ``words``).
            rgba = unpack_rgba(np.ascontiguousarray(
                outs[:, :h, :w].cpu().numpy()).view(np.uint32))
            return {"alpha": rgba[..., 3], "comp": rgba}
        alpha_u8, fgr_u8, rgba = outs
        return {"alpha": owned(alpha_u8[:, :h, :w, 0]),
                "fgr": owned(fgr_u8[:, :h, :w]),
                "comp": owned(rgba[:, :h, :w])}

    def step(self, frame: np.ndarray,
             trimap: Optional[np.ndarray] = None) -> dict:
        """Matte one (H, W, 3) uint8 RGB frame, or an (S, H, W, 3) round
        for a batched multi-stream bundle (outputs then keep the leading
        S axis; the per-stream carry slots are independent).
        Trimap-conditioned bundles also take a per-frame trimap ((H, W)
        uint8 {0, 128, 255} or float {0, 0.5, 1}; (S, H, W) when
        batched), or 4-channel frames."""
        self._pad_into(frame, trimap, self._input("step")[0])
        d = self._unpack(self._to_host("step", self._run("step")))
        return ({k: v[0] for k, v in d.items()}
                if self.num_streams == 1 else d)

    def convert(self, input_source, output_alpha=None,
                output_composition=None, output_foreground=None,
                progress: bool = False,
                trimap_source=None, mask_source=None,
                mask_band: float = 0.04) -> dict:
        """Offline conversion driven entirely from the bundle (the chunk
        program when the bundle ships one, a partial last chunk through
        the step program).

        output_*: a video path or a callable receiving each (H, W[, C])
        uint8 frame, as for convert_video.
        trimap_source / mask_source / mask_band: the convert_video
        contract: a per-frame trimap stream, or one keyframe trimap for
        the recurrent propagation family; mask_source takes rough binary
        masks."""
        from vidmat_torch.io.reader import FrameSource
        from vidmat_torch.io.writer import open_sink
        from vidmat_torch.pipeline.trimap import (PreTrimmedTrimaps,
                                                  single_trimap)
        from vidmat_torch.utils.metrics import RunMetrics

        m = self.manifest
        if m["output"] == "seg":
            raise ValueError(
                "seg bundles serve live masks via step(); offline mask "
                "conversion lives in convert_video("
                "output_segmentation=...)")
        if self.num_streams != 1:
            raise ValueError(
                "convert() is a single-stream surface; batched "
                f"(num_streams={self.num_streams}) bundles serve live "
                "rounds via step()")
        want = {"alpha": output_alpha, "comp": output_composition,
                "fgr": output_foreground}
        for key, p in want.items():
            if p and key != "alpha" and m["output"] == "alpha_only":
                raise ValueError("alpha-only bundle cannot write " + key)
            if p and key == "fgr" and m["output"] != "tuple":
                raise ValueError(
                    "this bundle composites on device (packed output); "
                    "export with need_fgr=True for raw foreground")
        if mask_source is not None:
            if trimap_source is not None:
                raise ValueError("pass either trimap_source or "
                                 "mask_source, not both")
            from vidmat_torch.api import _mask_to_trimap_source

            trimap_source = _mask_to_trimap_source(mask_source, mask_band)
        tri_iter = None
        recurrent = m.get("model_cfg", {}).get("recurrent", True)
        if trimap_source is not None:
            if self._in_c != 4:
                raise ValueError("bundle is not trimap-conditioned; "
                                 "export with a use_trimap model_cfg")
            keyframe = single_trimap(trimap_source)
            if keyframe is not None:
                if not recurrent:
                    raise ValueError(
                        "a single keyframe trimap needs the recurrent "
                        "propagation family: this bundle's model is "
                        "non-recurrent (per-frame trimaps)")
                tri_iter = iter([keyframe])
            elif isinstance(trimap_source, PreTrimmedTrimaps):
                tri_iter = iter(trimap_source)
            else:
                tri_iter = iter(FrameSource(trimap_source))
        elif self._in_c == 4:
            raise ValueError(
                "trimap-conditioned bundle needs trimap_source= (or "
                "mask_source=) for conversion")
        source = FrameSource(input_source)
        writers = None
        metrics = RunMetrics()
        n = 0
        staged = 0
        t_prev = time.perf_counter()

        def emit(d, i=0):
            for key, wtr in writers.items():
                wtr.write(d[key][i])

        def next_tri(frame):
            if tri_iter is None:
                return None
            tri = next(tri_iter, None)
            if tri is None:
                if not recurrent:
                    raise ValueError(
                        f"trimap stream ended at frame {n + staged} but the "
                        "input continues: the per-frame trimap family "
                        "needs a trimap for every converted frame")
                # Past the annotated prefix: all-unknown, the GRU carries
                # the constraint forward.
                tri = np.full(frame.shape[:2], 128, np.uint8)
            return tri

        chunked = "chunk" in self._progs
        buf = self._input("chunk")[0] if chunked else None
        for frame in source:
            if writers is None:
                writers = {key: open_sink(p, source.fps)
                           for key, p in want.items() if p}
            if chunked:
                self._pad_into(frame, next_tri(frame), buf[staged])
                staged += 1
                if staged < self.chunk:
                    continue
                staged = 0
                out = self._to_host("chunk", self._run("chunk"))
                for i in range(self.chunk):
                    emit(self._unpack(tuple(t[i] for t in out)
                                      if isinstance(out, tuple)
                                      else out[i]))
                n += self.chunk
                t_now = time.perf_counter()
                metrics.record_chunk(t_now - t_prev, self.chunk)
            else:
                self._pad_into(frame, next_tri(frame),
                               self._input("step")[0])
                emit(self._unpack(self._to_host("step", self._run("step"))))
                n += 1
                t_now = time.perf_counter()
                metrics.record_frame(t_now - t_prev)
            t_prev = t_now
            if progress and n % 50 == 0:
                print(f"frame {n}", flush=True)
        # A partial last chunk drains through the step program; each
        # drained frame records its time (the fps denominator includes
        # the tail).
        for j in range(staged):
            self._input("step")[0][...] = buf[j]
            emit(self._unpack(self._to_host("step", self._run("step"))))
            n += 1
            t_now = time.perf_counter()
            metrics.record_frame(t_now - t_prev)
            t_prev = t_now
        for wtr in (writers or {}).values():
            wtr.close()
        out = metrics.summary()
        out["frames"] = n
        return out
