"""The plain float32 reference of the serving chain, in PyTorch.

It imports nothing of the program and takes nothing the program made: it
works out again from the seeded variables (the JAX package's layout,
BatchNorm unfolded) and the uint8 frames what the port derives from them.
Every step is the published math, a frozen copy of the JAX package's
(vidmat/models/matting_net.py, layers.py, ops/resize.py,
ops/guided_filter.py, ops/composite.py and pipeline/stepfactory.py):

  pad     the frame edge-padded at the bottom and right to a multiple of
          16 (the pipeline's bucket)
  ingest  an area mean over pool x pool pixels, / 255 (ratio 1: the frame
          / 255)
  net     edge-padded to a multiple of 16 * s2d; space-to-depth (channel
          order [dy, dx, c]); encoder stem and three stride-2 pairs;
          bottleneck 1x1 times a sigmoid gate of the global mean; three
          stages of 2x bilinear upsample (half-pixel), skip concat, conv,
          split-half ConvGRU; d0 on the upsample and the packed input (the
          RGB at s2d 1); the head; depth-to-space; alpha clipped, the
          foreground a clipped residual on the input RGB
  tail    guided: the fast guided filter's coefficient grids (edge-
          truncated (2r+1)^2 box means, luma guide of the coarse frame),
          bilinearly upsampled to the frame, applied to the frame's luma
          and clipped; none: the net's output as it is
  output  round-half-even of clip(v) * 255: the alpha byte, or RGBA
          composited over a color

Convolutions run in float32 with TF32 off. ``quant`` (the control) rounds
every convolution's input and weights first, e.g. to float8 e4m3.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.yardstick import geometry


@contextlib.contextmanager
def full_float32():
    """TF32 off for the scope's convolutions and matmuls."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 (saturating at +-448) and back to float32."""
    return t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    n, c4, h, w = x.shape
    c = c4 // (r * r)
    x = x.reshape(n, r, r, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * r, w * r)


def up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=False)


def box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-truncated (2r+1)^2 window mean, NCHW: the window's sum over
    the pixels inside the frame, over their count."""
    return F.avg_pool2d(x, 2 * r + 1, stride=1, padding=r,
                        count_include_pad=False)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    return (0.299 * rgb[:, 0:1] + 0.587 * rgb[:, 1:2]
            + 0.114 * rgb[:, 2:3])


class Net:
    """The recurrent network in float32 NCHW from the nested variables."""

    def __init__(self, variables: dict, model: dict, device,
                 quant: Optional[Callable] = None):
        self.p = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                     device=device)
                  for k, v in _flat(variables)}
        # convolution weights (O, I, kh, kw) from the (kh, kw, I, O) kernels
        self.w = {k[len("params/"):-len("/kernel")]:
                  v.permute(3, 2, 0, 1).contiguous()
                  for k, v in self.p.items() if k.endswith("/kernel")}
        self.s = int(model["space_to_depth"])
        self.eps = float(model["bn_eps"])
        self.dec = list(model["dec_channels"])
        self.q = quant or (lambda t: t)

    def conv(self, x, name, stride=1, bias=True):
        w = self.w[name]
        b = self.p[f"params/{name}/bias"] if bias else None
        return F.conv2d(self.q(x), self.q(w), b, stride, w.shape[-1] // 2)

    def bn(self, x, name):
        mean = self.p[f"batch_stats/{name}/mean"].view(1, -1, 1, 1)
        var = self.p[f"batch_stats/{name}/var"].view(1, -1, 1, 1)
        scale = self.p[f"params/{name}/scale"].view(1, -1, 1, 1)
        bias = self.p[f"params/{name}/bias"].view(1, -1, 1, 1)
        return (x - mean) / torch.sqrt(var + self.eps) * scale + bias

    def cba(self, x, name, stride=1):
        return F.relu(self.bn(self.conv(x, f"{name}/conv", stride, False),
                              f"{name}/bn"))

    def encode(self, x: torch.Tensor):
        """x (N, C, H, W) in [0, 1], padded to 16 * s2d -> (x_in, rgb,
        f1, f2, f3, b4)."""
        s = self.s
        x_in = space_to_depth(x, s) if s > 1 else x
        f1 = self.cba(x_in, "encoder/stem", 2)
        f2 = self.cba(self.cba(f1, "encoder/s2a", 2), "encoder/s2b")
        f3 = self.cba(self.cba(f2, "encoder/s3a", 2), "encoder/s3b")
        f4 = self.cba(self.cba(f3, "encoder/s4a", 2), "encoder/s4b")
        a = self.cba(f4, "bottleneck/proj")
        g = self.conv(f4.mean(dim=(2, 3), keepdim=True), "bottleneck/gate")
        return x_in, x[:, :3], f1, f2, f3, a * torch.sigmoid(g)

    def gru(self, x, h, name):
        c = h.shape[1]
        rz = torch.sigmoid(self.conv(torch.cat([x, h], 1), f"{name}/gates"))
        r, z = rz[:, :c], rz[:, c:]
        cand = torch.tanh(self.conv(torch.cat([x, r * h], 1),
                                    f"{name}/cand"))
        return (1.0 - z) * h + z * cand

    def zero_state(self, n: int, h: int, w: int, device):
        """States at strides 8/4/2 of the packed grid (h, w: the padded
        input grid)."""
        s, d = self.s, self.dec
        return [torch.zeros((n, d[i] // 2, h // (s * k), w // (s * k)),
                            device=device)
                for i, k in enumerate((8, 4, 2))]

    def step(self, f1, f2, f3, b4, state):
        """The recurrent stages for one time step -> (y1, new state)."""
        y, new = b4, []
        for name, skip, h in zip(("d3", "d2", "d1"), (f3, f2, f1), state):
            y = self.cba(torch.cat([up2(y), skip], 1), f"{name}/conv")
            c = y.shape[1] // 2
            hn = self.gru(y[:, c:], h, f"{name}/gru")
            y = torch.cat([y[:, :c], hn], 1)
            new.append(hn)
        return y, new

    def head_raw(self, y1, x_in, rgb):
        """d0 and the head's convolution, before depth-to-space."""
        cond = x_in if self.s > 1 else rgb
        y = self.cba(torch.cat([up2(y1), cond], 1), "d0")
        return self.conv(y, "head")

    def head(self, y1, x_in, rgb):
        """d0 and the head -> alpha (N, 1, H, W), fgr (N, 3, H, W)."""
        out = self.head_raw(y1, x_in, rgb)
        if self.s > 1:
            out = depth_to_space(out, self.s)
        return (out[:, 0:1].clamp(0.0, 1.0),
                (out[:, 1:4] + rgb).clamp(0.0, 1.0))


# ---- what ``weights.py`` asks of the architecture to calibrate its head ----

#: the head's leaves (``kernel`` and ``bias`` under this path)
HEAD = "params/head"


def alpha_channels(n: int) -> np.ndarray:
    """Which of the head's n output channels are alpha: channel order
    [dy, dx, c] before depth-to-space, c = 0 the alpha."""
    return np.arange(n) % 4 == 0


def head_output(variables: dict, config: dict, traffic: dict,
                frames: np.ndarray, device) -> torch.Tensor:
    """The head's raw output (N, C, h, w), before depth-to-space and
    cropped to the net's grid, at the last of ``frames`` ((T, S, h, w, 3)
    uint8, run in order from a zero state)."""
    geo = geometry(config, traffic)
    net = Net(variables, config["model"], device)
    s = net.s
    state = None
    with torch.inference_mode(), full_float32():
        for t in range(frames.shape[0]):
            raw = torch.from_numpy(np.ascontiguousarray(frames[t]))
            _, _, xp = prepare(raw.to(device), geo)
            x_in, rgb, f1, f2, f3, b4 = net.encode(xp)
            if state is None:
                state = net.zero_state(raw.shape[0], geo.grid_h, geo.grid_w,
                                       device)
            y1, state = net.step(f1, f2, f3, b4, state)
        return net.head_raw(y1, x_in, rgb)[:, :, :geo.net_h // s,
                                           :geo.net_w // s]


def prepare(raw: torch.Tensor, geo):
    """(N, h, w, 3) uint8 frames on the device -> the frames padded to the
    bucket (N, 3, H, W) in [0, 1], the coarse frames and the net's padded
    input."""
    fh, fw = raw.shape[1:3]
    fr = raw.permute(0, 3, 1, 2).float()
    if (fh, fw) != (geo.height, geo.width):
        fr = F.pad(fr, (0, geo.width - fw, 0, geo.height - fh),
                   mode="replicate")
    full = fr / 255.0
    xc = F.avg_pool2d(fr, geo.pool) / 255.0 if geo.pool else full
    xp = xc
    if (geo.grid_h, geo.grid_w) != (geo.net_h, geo.net_w):
        xp = F.pad(xc, (0, geo.grid_w - geo.net_w, 0,
                        geo.grid_h - geo.net_h), mode="replicate")
    return full, xc, xp


def guided_tail(x_coarse, alpha, fgr, frame_full, radius, eps):
    """The fast guided filter: coefficient grids at the coarse grid,
    bilinearly upsampled, applied to the frame's luma, clipped."""
    guide = luma(x_coarse)
    p = torch.cat([alpha, fgr], 1)
    mean_i = box_mean(guide, radius)
    var_i = box_mean(guide * guide, radius) - mean_i * mean_i
    mean_p = box_mean(p, radius)
    cov = box_mean(guide * p, radius) - mean_i * mean_p
    a = cov / (var_i + eps)
    b = mean_p - a * mean_i
    h, w = frame_full.shape[2:]
    ma = F.interpolate(box_mean(a, radius), size=(h, w), mode="bilinear",
                       align_corners=False)
    mb = F.interpolate(box_mean(b, radius), size=(h, w), mode="bilinear",
                       align_corners=False)
    out = (ma * luma(frame_full) + mb).clamp(0.0, 1.0)
    return out[:, 0:1], out[:, 1:4]


def quantize(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def outputs(alpha, fgr, output: str, bg_color) -> torch.Tensor:
    """(N, h, w, C) uint8: C = 1, the alpha byte; C = 4, RGBA over a
    color."""
    if output == "alpha":
        return quantize(alpha).permute(0, 2, 3, 1)
    bg = torch.as_tensor(bg_color, dtype=torch.float32,
                         device=alpha.device).view(1, 3, 1, 1)
    rgb = fgr * alpha + bg * (1.0 - alpha)
    return quantize(torch.cat([rgb, alpha], 1)).permute(0, 2, 3, 1)


class Recurrence:
    """The recurrent stages stepped frame after frame over encodings made
    once per pool frame: on a CUDA device one captured graph a step (the
    same operations, launched at once), elsewhere eagerly."""

    def __init__(self, net: Net, enc, streams: int, state, device):
        self.net, self.enc, self.s = net, enc, streams
        self.state = state
        self.graph = None
        if torch.device(device).type != "cuda":
            return
        self.inputs = [t[:streams].clone() for t in enc]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                net.step(*self.inputs, self.state)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.y1, new = net.step(*self.inputs, self.state)
            for h, n in zip(self.state, new):
                h.copy_(n)

    def step(self, k: int) -> torch.Tensor:
        """Advance by pool frame k's encodings; returns y1."""
        sl = slice(k * self.s, (k + 1) * self.s)
        if self.graph is None:
            y1, self.state = self.net.step(*(t[sl] for t in self.enc),
                                           self.state)
            return y1
        for dst, src in zip(self.inputs, self.enc):
            dst.copy_(src[sl])
        self.graph.replay()
        return self.y1


def run(config: dict, traffic: dict, variables: dict, pool: np.ndarray,
        wanted: Iterable[int], device, quant: Optional[Callable] = None,
        block: int = 16) -> Dict[int, np.ndarray]:
    """The reference's outputs at the dispatch indices ``wanted``. Index i
    is the pool's frame i % P ((P, S, h, w, 3) uint8: S streams, one for a
    conversion); every index from 0 to the largest runs through the
    recurrence, in order. Returns {i: (S, h, w, C) uint8}."""
    geo = geometry(config, traffic)
    refine = config["pipeline"]["refine"]
    if not (geo.full and refine["mode"] == "none") and not (
            geo.pool and refine["mode"] == "guided"):
        raise ValueError("the reference serves a guided tail at an integer "
                         "pool, or the net at full resolution without "
                         "refinement")
    wanted = sorted(set(int(i) for i in wanted))
    out: Dict[int, np.ndarray] = {}
    if not wanted:
        return out
    net = Net(variables, config["model"], device, quant)
    p, s, fh, fw, _ = pool.shape

    def frames(lo, hi):
        raw = torch.from_numpy(np.ascontiguousarray(pool[lo:hi]))
        return prepare(raw.to(device).reshape(-1, fh, fw, 3), geo)

    with torch.inference_mode(), full_float32():
        # The encoder is stateless: once per pool frame.
        parts = []
        for lo in range(0, p, block):
            parts.append(net.encode(frames(lo, min(p, lo + block))[2])[2:])
        enc = [torch.cat(t) for t in zip(*parts)]
        state = net.zero_state(s, geo.grid_h, geo.grid_w, device)
        rec = Recurrence(net, enc, s, state, device)
        keep = set(wanted)
        for i in range(wanted[-1] + 1):
            y1 = rec.step(i % p)
            if i not in keep:
                continue
            full, xc, xp = frames(i % p, i % p + 1)
            x_in = space_to_depth(xp, net.s) if net.s > 1 else xp
            alpha, fgr = net.head(y1, x_in, xp[:, :3])
            alpha = alpha[:, :, :geo.net_h, :geo.net_w]
            fgr = fgr[:, :, :geo.net_h, :geo.net_w]
            if geo.pool:
                alpha, fgr = guided_tail(xc, alpha, fgr, full,
                                         int(refine["guided_radius"]),
                                         float(refine["guided_eps"]))
            o = outputs(alpha, fgr, traffic["output"],
                        traffic.get("bg_color"))
            out[i] = o[:, :fh, :fw].cpu().numpy()
    return out
