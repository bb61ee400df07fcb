"""Peaks and the byte and operation counts of the port's launches.

Frozen copies: the counts of ``site_cost`` and ``tail_rows`` in
``chip_smoke.py`` (phase 6) and the published peaks of one NVIDIA H100 SXM
(dense, no sparsity). They take shapes, not tensors, so that they count
the work the configuration and the traffic ask for whatever the program
does: each input byte read once, each output byte written once, the
multiply-adds the convolutions need.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12

#: bytes of one element of the serving planes (bfloat16)
PLANE_BYTES = 2


@dataclasses.dataclass(frozen=True)
class Work:
    """One unit of a layer's work: a launch, or a fused pair of them."""

    name: str
    bytes: float
    ops: float      # operations (a multiply-add is two)
    peak: float     # operations per second of the type it runs in

    @property
    def least_s(self) -> float:
        """The least time the card could take: the larger of the bytes
        over the memory's rate and the operations over the peak."""
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / self.peak)


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


def conv_site(name: str, n: int, cins: Sequence[int], h: int, w: int,
              cout: int, k: int, stride: int) -> Work:
    """planar_conv (site_cost "conv"): inputs and weights read once, the
    folded BatchNorm's scale and bias (8 bytes a channel), the output
    written once."""
    b_in = n * sum(cins) * h * w * PLANE_BYTES
    cin = sum(cins)
    px = n * (h // stride) * (w // stride)
    wbytes = cout * cin * k * k * PLANE_BYTES
    macs = px * cout * cin * k * k
    return Work(name, b_in + wbytes + 8 * cout + px * cout * PLANE_BYTES,
                2.0 * macs, BF16_FLOPS_PER_S)


def conv2_site(name: str, n: int, cins: Sequence[int], h: int, w: int,
               cout: int, c2: int, stride: int) -> Work:
    """planar_conv2 (site_cost "conv2"): a 3x3 conv (stride 1 or 2) and a
    3x3 conv in one unit; the intermediate stays on chip."""
    b_in = n * sum(cins) * h * w * PLANE_BYTES
    cin = sum(cins)
    px = n * (h // stride) * (w // stride)
    wbytes = (cout * cin * 9 + c2 * cout * 9) * PLANE_BYTES
    macs = px * (cout * cin * 9 + c2 * cout * 9)
    return Work(name, b_in + wbytes + 8 * (cout + c2) + px * c2 * PLANE_BYTES,
                2.0 * macs, BF16_FLOPS_PER_S)


def conv_gru_site(name: str, n: int, cins: Sequence[int], h: int, w: int,
                  cout: int) -> Work:
    """planar_conv_gru (site_cost "conv_gru"): the stage's 3x3 conv, the
    split and the ConvGRU on its second half (c = cout / 2): the state read
    once, the kept half and the new state written once."""
    c = cout // 2
    cin = sum(cins)
    px = n * h * w
    b_in = px * cin * PLANE_BYTES
    hbytes = px * c * PLANE_BYTES
    wbytes = (cout * cin * 9 + 2 * c * 2 * c * 9 + c * 2 * c * 9) * PLANE_BYTES
    macs = px * 9 * (cout * cin + 2 * c * 2 * c + c * 2 * c)
    return Work(name, b_in + wbytes + 8 * cout + 3 * hbytes + 4 * 3 * c,
                2.0 * macs, BF16_FLOPS_PER_S)


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


def ingest_work(n: int, h: int, w: int, pool: int) -> Work:
    """ingest_pool_normalize: the uint8 frame read once, the pooled
    bfloat16 grid written once; an add per input byte, 3 multiplies and an
    add per output value."""
    inp = n * h * w * 3
    out = n * (h // pool) * (w // pool) * 3
    return Work("ingest", inp + out * PLANE_BYTES, inp + 4 * out,
                F32_FLOPS_PER_S)


def gf_work(n: int, hc: int, wc: int, radius: int) -> Work:
    """guided_filter_coeffs: the guide (1 float) and the 4 signals read,
    both coefficient grids (4 floats each) written; window sums of 10
    statistics and 8 coefficients, 5 products, 18 scalings, ~6 ops a
    channel for a and b."""
    coarse = n * hc * wc
    taps = 2 * (2 * radius + 1)
    return Work("gf", coarse * 4 * (1 + 4 + 4 + 4),
                coarse * (18 * taps + 5 + 18 + 24), F32_FLOPS_PER_S)


def refine_composite_work(n: int, h: int, w: int, pool: int) -> Work:
    """fused_refine_composite: the uint8 frame and both coefficient grids
    read, one packed word a pixel written; 8 channels x 3 lerps x 3 ops,
    the luma 6, 4 applies x 2 and clips, the composite 9, 4 quantizes x 3
    a pixel."""
    px = n * h * w
    coarse = n * (h // pool) * (w // pool)
    return Work("refine_composite", px * 3 + 2 * coarse * 16 + px * 4,
                px * (8 * 9 + 6 + 16 + 9 + 12), F32_FLOPS_PER_S)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The shapes a configuration and a traffic mix imply (a frozen copy
    of the pipeline's bucket and coarse-grid rules: vidmat/pipeline/
    video.py's /16 bucket, ops/resize.py ``downsample_ratio_shape``, the
    integer pool and stepfactory.py's s2d padding)."""

    height: int       # the frame's /16 bucket
    width: int
    net_h: int        # the coarse grid the net sees
    net_w: int
    grid_h: int       # the net's input grid, padded to 16 * s2d
    grid_w: int
    pool: int         # the integer area pool (0: none)
    full: bool        # the net runs at the frame's grid
    steps: int        # time steps a dispatch (the chunk)
    streams: int      # streams a step

    @property
    def frames(self) -> int:
        """Frames a dispatch."""
        return self.steps * self.streams


def frame_hw(config: dict, traffic: dict):
    """The frames' size: the traffic's, else the configuration's."""
    return tuple(traffic.get("frame_hw") or config["frame_hw"])


def geometry(config: dict, traffic: dict) -> Geometry:
    fh, fw = frame_hw(config, traffic)
    h, w = fh + (-fh % 16), fw + (-fw % 16)
    ratio = float(config["pipeline"]["downsample_ratio"])

    def snap(x: int) -> int:
        return max(16, int(round(x * ratio / 16.0)) * 16)

    net_h, net_w = (h, w) if ratio >= 1.0 else (snap(h), snap(w))
    full = (net_h, net_w) == (h, w)
    pool = (h // net_h if (not full and h % net_h == 0 and w % net_w == 0
                           and h // net_h == w // net_w) else 0)
    mult = 16 * int(config["model"]["space_to_depth"])
    steps = int(traffic.get("chunk_size",
                            config["pipeline"]["chunk_size"]))
    return Geometry(h, w, net_h, net_w, net_h + (-net_h % mult),
                    net_w + (-net_w % mult), pool, full, steps,
                    int(traffic.get("streams", 1)))


def net_shape(config: dict, traffic: dict) -> NetShape:
    m, geo = config["model"], geometry(config, traffic)
    return NetShape(tuple(m["enc_channels"]), tuple(m["dec_channels"]),
                    int(m["space_to_depth"]), 3, geo.grid_h, geo.grid_w)
