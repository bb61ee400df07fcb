"""The net: the four planar kernels (csrc/planar_conv.cu, planar_conv2.cu,
planar_gru.cu). Per dispatch the stateless half runs once over its frames
and the recurrent half once a time step over its streams. The planar
net's whole count is here: its shape, the work of its launches and its
operations a frame, from the yardstick's site costs."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from portbench.yardstick import (Work, conv2_site, conv_gru_site, conv_site,
                                 geometry)


@dataclasses.dataclass(frozen=True)
class NetShape:
    """The network of a configuration at one input grid: channels, the
    space-to-depth factor and the (padded) grid it runs on."""

    enc: Sequence[int]
    dec: Sequence[int]
    s2d: int
    in_ch: int
    height: int     # the net's input grid, padded to 16 * s2d
    width: int


def encoder_work(net: NetShape, n: int) -> List[Work]:
    """The stateless half over n frames as the planar kernels take it: the
    stem, the three stride-2 pairs and the bottleneck's 1x1 projection."""
    c, s = net.enc, net.s2d
    h, w = net.height // s, net.width // s
    x_ch = net.in_ch * s * s
    out = [conv_site("stem", n, [x_ch], h, w, c[0], 3, 2)]
    h, w = h // 2, w // 2
    for i, name in enumerate(("s2", "s3", "s4")):
        out.append(conv2_site(name, n, [c[i]], h, w, c[i + 1], c[i + 1], 2))
        h, w = h // 2, w // 2
    out.append(conv_site("proj", n, [c[3]], h, w, c[3], 1, 1))
    return out


def decoder_work(net: NetShape, n: int) -> List[Work]:
    """The recurrent half for one time step of n streams: the three
    upsample-concat-conv-ConvGRU stages and the full-resolution d0 + head
    pair (the conditioning is the packed input, or the RGB at s2d 1)."""
    c, d, s = net.enc, net.dec, net.s2d
    h0, w0 = net.height // s, net.width // s
    grids = [(h0 >> k, w0 >> k) for k in range(5)]
    out = []
    prev = [c[3]]                      # b4
    for stage, (skip, dch, lvl) in zip(("d3", "d2", "d1"),
                                       zip(c[2::-1], d[:3], (3, 2, 1))):
        hh, ww = grids[lvl]
        out.append(conv_gru_site(stage, n, prev + [skip], hh, ww, dch))
        prev = [dch // 2, dch // 2]    # the kept half and the new state
    cond = net.in_ch * s * s if s > 1 else 3
    out.append(conv2_site("d0+head", n, prev + [cond], h0, w0, d[3],
                          4 * s * s, 1))
    return out


def net_flops_per_frame(net: NetShape) -> float:
    """The net's operations a frame: two per multiply-add of every
    convolution (the GRUs' gates and the bottleneck's gate, a 1x1 on the
    pooled vector, included; BatchNorm folded away)."""
    gate = 2.0 * net.enc[3] * net.enc[3]
    return gate + sum(wk.ops for wk in encoder_work(net, 1)
                      + decoder_work(net, 1))


def net_shape(config: dict, traffic: dict) -> NetShape:
    m, geo = config["model"], geometry(config, traffic)
    return NetShape(tuple(m["enc_channels"]), tuple(m["dec_channels"]),
                    int(m["space_to_depth"]), 3, geo.grid_h, geo.grid_w)


def matches(name: str) -> bool:
    return "planar_" in name


def work(config: dict, traffic: dict):
    geo = geometry(config, traffic)
    net = net_shape(config, traffic)
    return (encoder_work(net, geo.frames)
            + decoder_work(net, geo.streams) * geo.steps)


def flops_per_frame(config: dict, traffic: dict) -> float:
    """The net's operations a frame (``net_flops_per_frame``)."""
    return net_flops_per_frame(net_shape(config, traffic))
