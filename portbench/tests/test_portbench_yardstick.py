"""The frozen byte, operation and FLOP counts against hand counts at small
shapes."""

import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, reference, weights, yardstick as y


def test_conv_site_by_hand():
    w = y.conv_site("c", 1, [3], 4, 4, 2, 3, 1)
    # in 3*16*2, weights 2*3*9*2, scale+bias 8*2, out 16*2*2
    assert w.bytes == 96 + 108 + 16 + 64
    assert w.ops == 2 * 16 * 2 * 3 * 9


def test_conv2_site_by_hand():
    w = y.conv2_site("p", 2, [2], 4, 4, 3, 5, 2)
    # in 2*2*16*2; weights (3*2*9 + 5*3*9)*2; 8*(3+5); out 8 px * 5 * 2
    assert w.bytes == 128 + 378 + 64 + 80
    assert w.ops == 2 * 8 * (54 + 135)


def test_conv_gru_site_by_hand():
    w = y.conv_gru_site("g", 1, [2, 2], 2, 2, 4)
    # c = 2: in 4 px * 4 ch * 2; weights (4*4 + 4*4 + 2*4)*9*2;
    # 8*4; the state, the kept half and the new state 3 * 4*2*2; 4*3*2
    assert w.bytes == 32 + 720 + 32 + 48 + 24
    assert w.ops == 2 * 4 * 9 * (16 + 16 + 8)


def test_tail_work_by_hand():
    assert y.ingest_work(1, 8, 8, 4).bytes == 192 + 12 * 2
    assert y.ingest_work(1, 8, 8, 4).ops == 192 + 4 * 12
    g = y.gf_work(1, 2, 2, 1)
    assert g.bytes == 4 * 4 * 13 and g.ops == 4 * (18 * 6 + 47)
    r = y.refine_composite_work(1, 8, 8, 4)
    assert r.bytes == 64 * 3 + 2 * 4 * 16 + 64 * 4
    assert r.ops == 64 * 115


def test_least_time_is_the_larger_bound():
    w = y.Work("x", 3.35e12, 1.0, y.F32_FLOPS_PER_S)
    assert w.least_s == pytest.approx(1.0)
    w = y.Work("x", 1.0, 2 * 67e12, y.F32_FLOPS_PER_S)
    assert w.least_s == pytest.approx(2.0)


@pytest.mark.parametrize("name,geo", [
    ("video_1080p.convert_alpha", (1088, 1920, 272, 480, 288, 480, 4, False,
                                   4, 1)),
    ("video_1080p.multistream_8", (1088, 1920, 272, 480, 288, 480, 4, False,
                                   1, 8)),
])
def test_geometry_of_the_cells(name, geo):
    cell = harness.find_cell(name)
    g = y.geometry(cell.config, cell.traffic)
    assert (g.height, g.width, g.net_h, g.net_w, g.grid_h, g.grid_w, g.pool,
            g.full, g.steps, g.streams) == geo


@pytest.mark.parametrize("s2d", [1, 2])
def test_net_flops_match_a_counter_on_the_reference(s2d):
    """The frozen count against torch's FLOP counter over the reference's
    convolutions at one frame of 64x64."""
    cell = harness.find_cell("video_1080p.convert_alpha")
    cfg = dict(cell.config, frame_hw=[64, 64])
    if s2d == 1:
        # the s2d=1 net at the shipped synthetic_demo checkpoint's shapes
        z = np.load(os.path.join(harness.ROOT, "vidmat_torch", "checkpoints",
                                 "synthetic_demo.npz"))
        cfg["variables"] = {k: list(z[k].shape) for k in z.files}
        cfg["model"] = dict(cfg["model"], space_to_depth=1)
    cfg["pipeline"] = dict(cfg["pipeline"], downsample_ratio=1.0)
    frames = np.random.default_rng(3).integers(0, 256, (2, 1, 64, 64, 3),
                                               dtype=np.uint8)
    var = weights.make_variables(cfg["variables"], 3, "cpu", cfg, {},
                                 frames)
    net = reference.Net(var, cfg["model"], "cpu")
    x = torch.rand(1, 3, 64, 64)
    with FlopCounterMode(display=False) as fc:
        x_in, rgb, f1, f2, f3, b4 = net.encode(x)
        st = net.zero_state(1, 64, 64, "cpu")
        y1, _ = net.step(f1, f2, f3, b4, st)
        net.head(y1, x_in, rgb)
    counted = fc.get_total_flops()
    shape = y.net_shape(cfg, {})
    assert y.net_flops_per_frame(shape) == counted
