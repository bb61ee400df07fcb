"""Seeded weights in the JAX package's nested layout (``params`` and
``batch_stats``), at the shapes a configuration file lists.

One draw on the device from the seed, split into the leaves and scaled by
kind, so that activations stay of order one through the depth and the
alpha head lands inside (0, 1) on most pixels: convolutions He-normal
(the head's alpha channels biased to 0.5), BatchNorm scale near 1 and
bias, mean near 0, variance near 1.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.frames import generator

#: what ``calibrate`` sets the head's output to after CALIBRATION_FRAMES
#: frames: the alpha channels' mean and spread, the foreground residual's
#: spread
CALIBRATION_FRAMES = 8
ALPHA_MEAN, ALPHA_STD, FGR_STD = 0.5, 0.25, 0.1


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def make_variables(shapes: Dict[str, list], seed: int, device,
                   config: dict, traffic: dict, frames: np.ndarray) -> dict:
    """The nested variables for ``shapes`` ({"params/.../kernel": [kh, kw,
    cin, cout], ...}) from ``seed``, float32 numpy leaves, the head
    calibrated on ``frames`` (see ``calibrate``)."""
    g = generator(seed, 1 << 20, device)
    sizes = [math.prod(s) for s in shapes.values()]
    draw = torch.randn((sum(sizes),), generator=g, device=device,
                       dtype=torch.float32).cpu().numpy()
    flat, at = {}, 0
    for (path, shape), size in zip(shapes.items(), sizes):
        z = draw[at:at + size].reshape(shape)
        at += size
        leaf = path.rsplit("/", 1)[1]
        head = path.startswith("params/head/")
        if leaf == "kernel":
            fan_in = shape[0] * shape[1] * shape[2]
            v = z * math.sqrt(2.0 / fan_in)
        elif leaf == "bias" and head:
            # channel order [dy, dx, c]: c = 0 is the alpha
            v = 0.1 * z + np.where(np.arange(shape[0]) % 4 == 0, 0.5, 0.0)
        elif leaf == "bias":
            v = 0.1 * z
        elif leaf == "scale":
            v = 1.0 + 0.1 * z
        elif leaf == "mean":
            v = 0.1 * z
        elif leaf == "var":
            v = np.exp(0.2 * z)
        else:
            raise KeyError(f"unhandled leaf {path}")
        flat[path] = np.ascontiguousarray(v, dtype=np.float32)
    variables = _nest(flat)
    calibrate(variables, config, traffic, frames, device)
    return variables


def calibrate(variables: dict, config: dict, traffic: dict,
              frames: np.ndarray, device) -> None:
    """Rescale the head, in place, so that over the last of ``frames``
    ((T, S, h, w, 3) uint8, run in order from a zero state) each alpha
    channel's output before the clip has mean ALPHA_MEAN and spread
    ALPHA_STD, and each foreground channel's residual mean 0 and spread
    FGR_STD. Random BatchNorm statistics otherwise shift the head's output
    by seed, and on some seeds the alpha clips at 0 or 1 on most pixels,
    where no comparison can see the net."""
    from portbench.reference import Net, full_float32, prepare
    from portbench.yardstick import geometry

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
        out = net.head_raw(y1, x_in, rgb)[:, :, :geo.net_h // s,
                                          :geo.net_w // s]
        mean = out.mean(dim=(0, 2, 3)).double().cpu().numpy()
        std = out.std(dim=(0, 2, 3)).double().cpu().numpy()
    head = variables["params"]["head"]
    alpha = np.arange(mean.shape[0]) % 4 == 0
    gain = np.where(alpha, ALPHA_STD, FGR_STD) / np.maximum(std, 1e-6)
    target = np.where(alpha, ALPHA_MEAN, 0.0)
    head["bias"] = (target - gain * (mean - head["bias"])).astype(np.float32)
    head["kernel"] = (head["kernel"] * gain).astype(np.float32)
