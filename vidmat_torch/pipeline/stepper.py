"""Inference steppers (counterpart of vidmat/pipeline/stepper.py).

``ImageStepper``: one image per call, padded, one float32 forward from a
zero state, cropped (``matte_image``).

``VideoStepper``: one frame per ``step``; the recurrent state stays on
the device between calls. The body comes from ``build_serving_body`` in
float-output mode (or the segmentation body with ``output="seg"``). Each
frame (and its trimap channel) is written into one reused pinned host
slot (``io/native.py`` ``pad_into``) and sent to a static device input.
On CUDA the first step runs the body eagerly (the warm-up) and is then
captured as a CUDA graph (``graph.ChunkGraph`` with one frame): every
later step is one copy in, one graph launch and the copies out. The
static-skip body picks its branch on the host and stays eager. The
caller gets host arrays of its own (``.cpu()`` copies), which later
steps do not touch; ``step_device`` leaves the outputs on the device
(vidmat/pipeline/stepper.py:246-260), for a caller that finishes there.
Trimap-conditioned models take a trimap per step; the recurrent
propagation family takes one on keyframes and an all-unknown trimap in
between (vidmat/pipeline/stepper.py:212-232). ``tile_size`` gives the
tiled refinement: the bf16 session's tiled float tail, the parity
session's ``tiled_guided_upsample``.

dtype="float32" (the default) is the parity mode: float frames in,
float32 compute, the net as F.conv2d and every stage on its plain PyTorch
version, whatever ``conv_impl`` says (the JAX package's no-kernel path,
vidmat/pipeline/stepper.py:176-178). dtype="bfloat16" is the serving mode:
uint8 frames through the ingest kernel, the net through the planar
kernels on ``conv_impl="planar"``, and at an integer pool the GF
coefficient and ``fused_refine_float`` kernels (``kernels=False`` puts
every stage on its plain version, the reference the kernels are held
against on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vidmat_torch._device import full_fp32, resolve_device
from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.io.backgrounds import prepare_plate_u8
from vidmat_torch.io.native import pad_into
from vidmat_torch.io.reader import pad_frame
from vidmat_torch.models.weights import (build_network, default_variables,
                                         seg_default_variables)
from vidmat_torch.ops.resize import downsample_ratio_shape
from vidmat_torch.pipeline.graph import ChunkGraph
from vidmat_torch.pipeline.stepfactory import build_serving_body
from vidmat_torch.pipeline.trimap import canon_trimap_u8
from vidmat_torch.utils.profiling import annotate


def pad_to_multiple(x: np.ndarray, m: int = 16) -> Tuple[np.ndarray, int, int]:
    """Edge-pad an HWC image so H and W are multiples of m. Returns
    (padded, orig_h, orig_w)."""
    h, w = x.shape[:2]
    ph, pw = (-h) % m, (-w) % m
    if ph or pw:
        x = np.pad(x, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return x, h, w


def to_float_rgb(image: np.ndarray) -> np.ndarray:
    """uint8 or float HWC -> float32 [0, 1]."""
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


class ImageStepper:
    """Single-image matting: pad -> one float32 forward -> crop.

    The net runs as plain convolutions (``conv_impl="xla"``, as the JAX
    ``ImageStepper`` does) in full float32: TF32 is off for the forward
    (``_device.full_fp32``). A recurrent configuration runs one frame from
    a zero state."""

    def __init__(self, cfg: ModelConfig, variables=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        if variables is None:
            variables = default_variables(cfg)
        self.net = build_network(dataclasses.replace(cfg, conv_impl="xla"),
                                 variables, device=self.device)

    def __call__(self, image: np.ndarray,
                 trimap: Optional[np.ndarray] = None,
                 bg_plate: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """image: (H, W, 3) uint8 or float RGB; trimap: (H, W[, 1]) in
        [0, 1] (uint8 scaled by 1/255), for a trimap configuration;
        bg_plate: (H, W, 3), for a plate-conditioned one. Returns host
        alpha (H, W, 1) and fgr (H, W, 3), float32 in [0, 1]."""
        img = to_float_rgb(image)
        if self.cfg.use_trimap:
            if trimap is None:
                raise ValueError("model config requires a trimap input")
            tri = to_float_rgb(trimap)
            if tri.ndim == 2:
                tri = tri[..., None]
            img = np.concatenate([img, tri], axis=-1)
        if self.cfg.use_bg_plate:
            if bg_plate is None:
                raise ValueError(
                    "model config requires the clean background plate "
                    "(use_bg_plate=True): pass bg_plate=<(H, W, 3) image "
                    "of the scene without the subject>")
            plate = to_float_rgb(bg_plate)
            if plate.shape[:2] != img.shape[:2]:
                raise ValueError(
                    f"bg_plate {plate.shape[:2]} must match the image "
                    f"{img.shape[:2]}")
            img = np.concatenate([img, plate[..., :3]], axis=-1)
        elif bg_plate is not None:
            raise ValueError(
                "bg_plate given but the model is not plate-conditioned "
                "(use_bg_plate=False); build with "
                "ModelConfig(use_bg_plate=True, space_to_depth=2)")
        # space-to-depth models need the padded grid divisible by 16*s2d.
        padded, h, w = pad_to_multiple(img, 16 * self.cfg.space_to_depth)
        x = torch.from_numpy(np.ascontiguousarray(padded))[None].to(
            self.device)
        with torch.inference_mode(), full_fp32():
            alpha, fgr, _ = self.net(x, None)
        return (alpha[0, :h, :w].cpu().numpy(),
                fgr[0, :h, :w].cpu().numpy())


#: recurrent carry fields, as the JAX package names them
STATE_FIELDS = ("h3", "h2", "h1")


class VideoStepper:
    """Streaming recurrent stepper for a fixed (height, width) stream.

    downsample_ratio < 1 runs the net on a coarse grid and restores full
    resolution with the guided filter. bg_plate: the clean plate of a
    plate-conditioned ``cfg`` (path or (H, W, 3) array), prepared to the
    stream's size once and fixed for the session. output="seg": the
    co-trained segmentation head in place of the matting heads (the same
    trunk and state advance); ``step`` returns (mask probability (H, W, 1)
    float32, None)."""

    #: capture the step as a CUDA graph after the first (False: every step
    #: through the eager body, the reference the graph is held to)
    capture = True

    def __init__(self, cfg: ModelConfig, height: int, width: int,
                 variables=None, downsample_ratio: float = 1.0,
                 dtype: str = "float32", guided_radius: int = 4,
                 guided_eps: float = 1e-4,
                 static_skip_eps: Optional[float] = None,
                 tile_size: Optional[int] = None, tile_overlap: int = 128,
                 bg_plate=None, output: str = "matte", device="cuda",
                 kernels: bool = True):
        if height % 16 or width % 16:
            raise ValueError("height/width must be multiples of 16 "
                             "(pad with pipeline.stepper.pad_to_multiple)")
        if output not in ("matte", "seg"):
            raise ValueError(f"output must be 'matte' or 'seg', got "
                             f"{output!r}")
        self._seg = output == "seg"
        self.device = resolve_device(device)
        self.cfg = cfg
        self.h, self.w = height, width
        self.ratio = downsample_ratio
        self._parity = dtype != "bfloat16"
        self.dtype = torch.float32 if self._parity else torch.bfloat16
        if downsample_ratio < 1.0:
            self.net_h, self.net_w = downsample_ratio_shape(
                height, width, downsample_ratio)
        else:
            self.net_h, self.net_w = height, width
        if variables is None:
            variables = (seg_default_variables(cfg) if self._seg
                         else default_variables(cfg))
        if self._seg and "seg_head" not in variables["params"]:
            raise ValueError(
                "output='seg' needs a co-trained checkpoint (a seg_head "
                "subtree in the params), such as the shipped seg_demo")
        # Parity mode runs the net as plain convolutions (the JAX package
        # builds its planar forward only with its kernels on).
        net_cfg = (dataclasses.replace(cfg, conv_impl="xla") if self._parity
                   else cfg)
        self.net = build_network(
            net_cfg, variables, dtype=None if self._parity else self.dtype,
            device=self.device)
        self._step, self._plan = build_serving_body(
            self.net, net_cfg,
            RefineConfig(mode="guided", guided_radius=guided_radius,
                         guided_eps=guided_eps),
            height, width, downsample_ratio, cdtype=self.dtype,
            float_frames=self._parity, float_output=True,
            static_skip_eps=static_skip_eps, tile_size=tile_size,
            tile_overlap=tile_overlap, output_seg=self._seg,
            bg_plate=(None if bg_plate is None
                      else prepare_plate_u8(bg_plate, height, width)),
            kernels=kernels and not self._parity)
        # The reused input: a pinned host slot and its device copy.
        cuda = self.device.type == "cuda"
        c = 4 if cfg.use_trimap else 3
        self._host = torch.empty(
            (1, height, width, c),
            dtype=torch.float32 if self._parity else torch.uint8,
            pin_memory=cuda)
        self._dev = (torch.empty_like(self._host, device=self.device)
                     if cuda else self._host)
        self._sent = torch.cuda.Event() if cuda else None
        self._graph = None
        self.capture_ms = None  # the step's capture, once made
        self.reset()

    def reset(self) -> None:
        """Start from a zero carry (a scene cut, a new stream)."""
        self._set_state(self._plan.make_state(1))

    def _set_state(self, state) -> None:
        """Go on from ``state``; with a captured step it is copied into the
        graph's static state, which the step updates in place."""
        if self._graph is not None:
            self._graph.load_state(state)
            state = self._graph.state
        self.state = state

    def _host_frame(self, frame: np.ndarray,
                    trimap: Optional[np.ndarray] = None,
                    pad: bool = False) -> np.ndarray:
        """(H, W, C): float32 in [0, 1] in parity mode, uint8 in serving
        mode (float frames as round(clip(v) * 255)). A trimap-conditioned
        model gets the trimap as a fourth channel (an all-unknown one
        where the recurrent family is given none). ``pad``: the frame may
        be smaller than the session's (H, W); the staging edge-pads it."""
        if not self.cfg.use_trimap:
            if trimap is not None:
                raise ValueError(
                    "model is not trimap-conditioned (use_trimap=False); "
                    "the trimap would be silently ignored: build the "
                    "session with a trimap ModelConfig (or drop trimap=)")
        else:
            if trimap is None:
                if not self.cfg.recurrent:
                    raise ValueError(
                        "model config requires a per-frame trimap input "
                        "(step(frame, trimap=...))")
                # Propagation: a keyframe trimap, then all-unknown ones;
                # the GRU carries the constraint forward.
                trimap = np.full(frame.shape[:2], 128, np.uint8)
            tri = canon_trimap_u8(trimap, frame.shape[:2])
            if frame.dtype != np.uint8:
                tri = (tri.astype(np.float32) / 255.0).astype(frame.dtype)
            frame = np.concatenate([np.asarray(frame), tri[..., None]],
                                   axis=-1)
        if self._parity:
            arr = to_float_rgb(frame)
        elif frame.dtype != np.uint8:
            arr = np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)
        else:
            arr = frame
        want = tuple(self._host.shape[1:])
        fits = (arr.ndim == 3 and arr.shape[2] == want[2]
                and arr.shape[0] <= want[0] and arr.shape[1] <= want[1])
        if not (fits if pad else arr.shape == want):
            raise ValueError(f"frame {arr.shape} does not match the "
                             f"session's {want}")
        return arr

    def _device_frame(self, frame: np.ndarray,
                      trimap: Optional[np.ndarray] = None,
                      pad: bool = False) -> torch.Tensor:
        """Write the frame into the pinned slot (once the last copy out of
        it is done; edge-padded to the session's size with ``pad``) and
        send it to the static (1, H, W, C) device input, which is
        returned."""
        arr = self._host_frame(frame, trimap, pad)
        if self._sent is not None:
            self._sent.synchronize()
        slot = self._host[0].numpy()
        if self._parity:
            np.copyto(slot, pad_frame(arr, *slot.shape[:2])[0] if pad
                      else arr)
        else:
            pad_into(np.ascontiguousarray(arr), slot)
        if self._sent is not None:
            self._dev.copy_(self._host, non_blocking=True)
            self._sent.record()
        return self._dev

    def _run(self, x: torch.Tensor):
        """The body on the staged input: the graph's replay once
        captured, else eagerly. Returns its device output."""
        if self._graph is not None:
            out, self.state = self._graph(self.state)
        else:
            with annotate("eager"):
                out, self.state = self._step(x, self.state)
        return out

    def _capture_after_warm_up(self) -> None:
        if (self._graph is None and self.capture
                and self.device.type == "cuda" and not self._plan.static_skip):
            with annotate("capture", timed=True) as span:
                self._graph = ChunkGraph(self._step, self._dev, self.state)
            self.state = self._graph.state
            self.capture_ms = span.ms

    def _advance(self, x: torch.Tensor):
        """The step on the staged input ``x``, captured after its first
        (eager) run; returns the device output."""
        out = self._run(x)
        self._capture_after_warm_up()
        return out

    def step_device(self, frame: np.ndarray,
                    trimap: Optional[np.ndarray] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Like :meth:`step`, but returns the device tensors ((1, H, W, 1)
        alpha, (1, H, W, 3) fgr, float32; (mask, None) with output="seg")
        with no device-to-host copy, for callers that finish on the device
        (the realtime driver's composite). Once the step is captured they
        are the graph's static outputs: valid until the next step. A
        frame smaller than the session's (H, W) is edge-padded to it (the
        realtime driver's /16 bucket)."""
        out = self._advance(self._device_frame(frame, trimap, pad=True))
        return (out, None) if self._seg else out

    def step(self, frame: np.ndarray, trimap: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """frame: (H, W, 3) uint8 or float RGB; trimap (trimap-conditioned
        models): (H, W) uint8 {0, 128, 255} or float {0, 0.5, 1}. Returns
        host alpha (H, W, 1) and fgr (H, W, 3), float32 in [0, 1];
        output="seg" returns (mask (H, W, 1) float32, None)."""
        out = self._advance(self._device_frame(frame, trimap))
        if self._seg:
            return out[0].cpu().numpy(), None
        alpha, fgr = out
        return alpha[0].cpu().numpy(), fgr[0].cpu().numpy()

    # -- mid-video resume: the carry in the port's own npz format --

    def _net_state(self):
        return self.state[0] if self._plan.static_skip else self.state

    def save_state(self, path: str, frame_index: int = 0) -> None:
        """Write the recurrent carry (fields h3, h2, h1, as float32) and
        the frame index to the npz file ``path``."""
        ns = self._net_state()
        arrays = {"frame_index": np.asarray(frame_index, np.int64)}
        if ns is not None:
            for k, t in zip(STATE_FIELDS, ns):
                arrays[k] = t.float().cpu().numpy()
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def load_state(self, path: str) -> int:
        """Restore a carry written by :meth:`save_state`; returns the saved
        frame index. The static-skip coefficient cache is reset, so the
        next frame takes the compute branch."""
        ns = self._net_state()
        with np.load(path) as z:
            saved = {k: z[k] for k in z.files}
        if ns is not None and any(k in saved for k in STATE_FIELDS):
            for k, cur in zip(STATE_FIELDS, ns):
                if k not in saved or saved[k].shape != tuple(cur.shape):
                    raise ValueError(
                        f"saved carry field {k!r} has shape "
                        f"{None if k not in saved else saved[k].shape} but "
                        f"this session expects {tuple(cur.shape)}: the carry "
                        "was saved on another serving path or configuration")
            ns = type(ns)(*(torch.from_numpy(saved[k]).to(
                device=cur.device, dtype=cur.dtype)
                for k, cur in zip(STATE_FIELDS, ns)))
        if self._plan.static_skip:
            self.state = (ns, self._plan.make_state(1)[1])
        else:
            self._set_state(ns)
        return int(saved["frame_index"])
