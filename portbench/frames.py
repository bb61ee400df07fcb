"""Seeded synthetic video: a soft-edged foreground moving over a textured,
slowly panning background, so every frame differs from the one before it
and the mattes have edges.

The frames are made on the device from the seed in a few large calls per
frame, then held in host memory as a user's decoded frames are. The scene's
parameters come from the traffic file (its ``scene`` object): the
foreground's half height as a share of the frame's (``fg_radius``), the
width of its soft edge in pixels (``edge_px``), how far its centre moves
as a share of the frame (``orbit``) and in how many turns over the pool
(``turns``), the background's pan a frame in pixels (``pan_px``) and the
fine noise's amplitude (``texture``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed (any seed up to
    2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) % 2**63)
    return g


def _smooth(g, c, h, w, cell, device):
    """Smooth noise in [0, 1]: a random grid of cells ``cell`` pixels wide,
    bilinearly upsampled to (c, h, w)."""
    gh, gw = max(2, h // cell + 2), max(2, w // cell + 2)
    grid = torch.rand((1, c, gh, gw), generator=g, device=device)
    return F.interpolate(grid, size=(h, w), mode="bilinear",
                         align_corners=False)[0]


def make_stream(seed: int, stream: int, count: int, h: int, w: int,
                scene: dict, device) -> np.ndarray:
    """``count`` frames (count, h, w, 3) uint8 of one stream."""
    g = generator(seed, stream, device)
    pan = int(math.ceil(scene["pan_px"] * count)) + 1
    bh, bw = h + pan, w + pan
    bg = (0.6 * _smooth(g, 3, bh, bw, 96, device)
          + 0.3 * _smooth(g, 3, bh, bw, 12, device)
          + scene["texture"] * torch.rand((3, bh, bw), generator=g,
                                          device=device))
    fg = (0.2 + 0.6 * _smooth(g, 3, h, w, 48, device)
          + scene["texture"] * torch.rand((3, h, w), generator=g,
                                          device=device))
    phase = float(torch.rand((1,), generator=g, device=device).item())
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    r = scene["fg_radius"] * h
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    for t in range(count):
        a = 2.0 * math.pi * (phase + scene["turns"] * t / count)
        cy = h * (0.5 + scene["orbit"] * math.sin(a))
        cx = w * (0.5 + scene["orbit"] * math.cos(2.0 * a))
        # an ellipse 0.7 as wide as high, its edge a logistic ramp
        d = torch.sqrt(((ys - cy) / r) ** 2 + ((xs - cx) / (0.7 * r)) ** 2)
        alpha = torch.sigmoid((1.0 - d) * r / scene["edge_px"])
        off = int(scene["pan_px"] * t)
        img = fg * alpha + bg[:, off:off + h, off:off + w] * (1.0 - alpha)
        out[t] = (img.clamp(0.0, 1.0) * 255.0).round().to(
            torch.uint8).permute(1, 2, 0)
    return out.cpu().numpy()


def make_streams(seed: int, streams: int, count: int, h: int, w: int,
                 scene: dict, device) -> np.ndarray:
    """(count, streams, h, w, 3) uint8: round r's frames are ``[r]``, a
    contiguous block."""
    out = np.empty((count, streams, h, w, 3), np.uint8)
    for s in range(streams):
        out[:, s] = make_stream(seed, s, count, h, w, scene, device)
    return out
