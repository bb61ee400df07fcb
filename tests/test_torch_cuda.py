"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: they skip where no CUDA device is present (the
CPU tests hold the plain versions to the JAX package). Run them on the
card with ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # The plain versions' float32 convolutions run in full float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_ingest_kernel_bit_exact(dev):
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)

    g = torch.Generator().manual_seed(0)
    # The main path's 4-frame chunk (the vector path), then shapes the
    # general path takes: pools 2 and 8, 4 channels, a width that is not a
    # multiple of 16, and a frame that starts 1 byte off alignment.
    for shape, pool, offset in (((4, 1088, 1920, 3), 4, 0),
                                ((1, 64, 96, 3), 4, 0),
                                ((2, 30, 50, 4), 2, 0),
                                ((2, 64, 96, 3), 8, 0),
                                ((2, 64, 96, 4), 4, 0),
                                ((1, 64, 100, 3), 4, 0),
                                ((2, 64, 96, 3), 4, 1)):
        n = 1
        for d in shape:
            n *= d
        buf = torch.randint(0, 256, (n + offset,), generator=g,
                            dtype=torch.uint8).to(dev)
        img = buf[offset:].view(shape)
        for dt in (torch.bfloat16, torch.float32):
            before = ingest_pool_normalize.launches
            got = ingest_pool_normalize(img, pool, out_dtype=dt)
            assert ingest_pool_normalize.launches == before + 1
            assert torch.equal(got, ingest_pool_normalize_plain(
                img, pool, out_dtype=dt)), (shape, pool, offset, dt)


def test_gf_kernel_matches_plain(dev):
    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)

    g = torch.Generator().manual_seed(1)
    for (n, h, w), r in (((1, 68, 120), 4), ((2, 37, 53), 2),
                         ((1, 20, 31), 8)):
        gi = torch.rand((n, h, w, 1), generator=g).to(dev)
        pi = torch.rand((n, h, w, 4), generator=g).to(dev)
        ka, kb = guided_filter_coeffs(gi, pi, r, 1e-4)
        pa, pb = guided_filter_coeffs_plain(gi, pi, r, 1e-4)
        assert float((ka - pa).abs().max()) <= 1e-4
        assert float((kb - pb).abs().max()) <= 1e-4


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("n", [1, 4])
def test_gf_kernel_bit_exact_on_ragged_grids(dev, r, n):
    """One launch per call, equal to the plain version bit for bit on grids
    whose sides are not multiples of the kernel's 32x16 tile."""
    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)

    g = torch.Generator().manual_seed(20 + r + n)
    for h, w in ((37, 53), (71, 33), (5, 7), (17, 95)):
        gi = torch.rand((n, h, w, 1), generator=g).to(dev)
        pi = (torch.rand((n, h, w, 4), generator=g) * 1.2 - 0.1).to(dev)
        before = guided_filter_coeffs.launches
        ka, kb = guided_filter_coeffs(gi, pi, r, 1e-4)
        assert guided_filter_coeffs.launches == before + 1
        pa, pb = guided_filter_coeffs_plain(gi, pi, r, 1e-4)
        assert torch.equal(ka, pa) and torch.equal(kb, pb), (h, w)


def test_gf_kernel_refuses_a_radius_too_large(dev):
    from vidmat_torch.ops.gf import MAX_RADIUS, guided_filter_coeffs

    gi = torch.rand((1, 40, 60, 1), device=dev)
    pi = torch.rand((1, 40, 60, 4), device=dev)
    guided_filter_coeffs(gi, pi, MAX_RADIUS, 1e-4)
    with pytest.raises(ValueError):
        guided_filter_coeffs(gi, pi, MAX_RADIUS + 1, 1e-4)


# (n, h, w, pool) of the packed tail's card tests: the main path's 4-frame
# chunk, and shapes the tiled kernel must get right: the clamped edge
# columns at pool 4, pool 2 at a width that is not a multiple of 4 (pixel
# by pixel I/O), pool 8 with an odd coarse width that does not fill a
# tile, partial tiles in both directions.
REFINE_SHAPES = [(4, 1088, 1920, 4), (2, 64, 300, 4), (2, 36, 302, 2),
                 (2, 64, 296, 8), (2, 36, 300, 4)]


def _refine_case(n, h, w, pool, seed):
    g = torch.Generator().manual_seed(seed)
    fr = torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8)
    a = torch.rand((n, h // pool, w // pool, 4), generator=g) * 2 - 0.5
    b = torch.rand((n, h // pool, w // pool, 4), generator=g) - 0.5
    return fr, a, b, g


@pytest.mark.parametrize("shape", REFINE_SHAPES)
@pytest.mark.parametrize("bg", [None, (0.0, 1.0, 0.0)])
def test_refine_kernel_within_one_lsb(dev, bg, shape):
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    n, h, w, pool = shape
    fr, a, b, _ = _refine_case(n, h, w, pool, 2)
    fr, a, b = fr.to(dev), a.to(dev), b.to(dev)
    before = fused_refine_composite.launches
    k = fused_refine_composite(fr, a, b, bg, pool).view(torch.uint8).int()
    assert fused_refine_composite.launches == before + 1
    q = fused_refine_composite_plain(fr, a, b, bg, pool).view(
        torch.uint8).int()
    assert int((k - q).abs().max()) <= 1
    # A frame that starts 1 byte off alignment takes the pixel-by-pixel
    # I/O and gives the same bytes.
    buf = torch.empty(fr.numel() + 1, dtype=torch.uint8, device=dev)
    buf[1:].copy_(fr.reshape(-1))
    k1 = fused_refine_composite(buf[1:].view(fr.shape), a, b, bg, pool)
    assert torch.equal(k1.view(torch.uint8).int(), k)


# ---- refine image / coarse modes, int8 probe, plate session (slice 4) ----


@pytest.mark.parametrize("shape", REFINE_SHAPES)
@pytest.mark.parametrize("mode", ["image", "per_frame", "coarse"])
def test_refine_kernel_background_modes_within_one_lsb(dev, mode, shape):
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    n, h, w, pool = shape
    fr, a, b, g = _refine_case(n, h, w, pool, 10)
    # Images slightly outside [0, 1]: the image mode takes them unclipped,
    # the coarse mode clips after its upsample.
    bg_shape = {"image": (h, w, 3), "per_frame": (n, h, w, 3),
                "coarse": (n, h // pool, w // pool, 3)}[mode]
    bg = (torch.rand(bg_shape, generator=g) * 1.2 - 0.1).to(dev)
    fr, a, b = fr.to(dev), a.to(dev), b.to(dev)
    before = dict(fused_refine_composite.mode_launches)
    k = fused_refine_composite(fr, a, b, bg, pool).view(torch.uint8).int()
    assert fused_refine_composite.mode_launches[mode] == before[mode] + 1
    q = fused_refine_composite_plain(fr, a, b, bg, pool).view(
        torch.uint8).int()
    assert int((k - q).abs().max()) <= 1


def test_refine_kernel_refuses_backgrounds_it_cannot_take(dev):
    from vidmat_torch.ops.refine import fused_refine_composite

    fr = torch.zeros((1, 16, 32, 3), dtype=torch.uint8, device=dev)
    a = torch.zeros((1, 4, 8, 4), device=dev)
    for bg in (torch.zeros((16, 32, 3), dtype=torch.float64, device=dev),
               torch.zeros((16, 32, 3)),  # on the CPU
               torch.zeros((1, 5, 8, 3), device=dev)):
        with pytest.raises(ValueError):
            fused_refine_composite(fr, a, a, bg, 4)


def _offset_int8(x, offset):
    """x's values in a buffer ``offset`` bytes past an aligned start."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def test_int8_conv_kernel_matches_plain(dev):
    """The probe's layer-batch shape, a W that is not a multiple of 16 (the
    scalar staging path), one whose tiles are partial in both directions,
    and an input one byte off alignment (scalar staging at the probe's
    width)."""
    from vidmat_torch.ops.int8_planar import int8_conv, int8_conv_plain
    from vidmat_torch.ops.planar import pack_conv_weight

    g = torch.Generator().manual_seed(11)
    w = (torch.randn((16, 16, 3, 3), generator=g) * 0.2).to(dev,
                                                             torch.bfloat16)
    wp = pack_conv_weight(w)
    for shape, offset in (((2, 16, 144, 240), 0), ((1, 16, 13, 37), 0),
                          ((2, 16, 20, 72), 0), ((2, 16, 144, 240), 1)):
        x = _offset_int8(torch.randint(-127, 128, shape, generator=g,
                                       dtype=torch.int8).to(dev), offset)
        for packed in (None, wp):
            before = int8_conv.launches
            k = int8_conv(x, w, packed=packed)
            assert int8_conv.launches == before + 1
            d = (k.int() - int8_conv_plain(x, w).int()).abs()
            # The two sum the same exact products in another order: a tie
            # of the requantization may round the other way.
            assert int(d.max()) <= 1, (shape, offset)
            assert float((d > 0).float().mean()) < 1e-3, (shape, offset)


def _planted_int8_weights(dev):
    """Weights whose sums are exact in every order (powers of two times
    int8 / 64 span a few bits), so the kernel must equal the plain twin
    bit for bit: output channels 0-1 the half-to-even pattern of
    tests/test_torch_int8.py (1 and 0.5 at the centre of channel 0), 2
    doubles channel 0 (the clamp at 127), 3 negates it (ReLU's zero),
    4-12 one tap each of channel 1 (the zero padding on every border and
    corner), 13 a quarter of channel 2's 3x3 sum (ties on sums), 14-15
    random dyadic weights over every channel and tap."""
    g = torch.Generator().manual_seed(5)
    w = torch.zeros((16, 16, 3, 3))
    w[0, 0, 1, 1] = 1.0
    w[1, 0, 1, 1] = 0.5
    w[2, 0, 1, 1] = 2.0
    w[3, 0, 1, 1] = -1.0
    for t in range(9):
        w[4 + t, 1, t // 3, t % 3] = 1.0
    w[13, 2] = 0.25
    choice = torch.tensor([0.0, 1.0, -1.0, 0.5, -0.5, 0.25, -0.125])
    w[14:] = choice[torch.randint(0, len(choice), (2, 16, 3, 3),
                                  generator=g)]
    return w.to(dev, torch.bfloat16)


def test_int8_conv_kernel_bit_equal_on_planted_cases(dev):
    """Half-to-even ties at x.5, the clamp at 127, ReLU's zero and the zero
    padding on all four borders, where every sum is exact: equal to the
    plain twin on both staging paths."""
    from vidmat_torch.ops.int8_planar import int8_conv, int8_conv_plain

    w = _planted_int8_weights(dev)
    g = torch.Generator().manual_seed(6)
    for shape, offset in (((1, 16, 37, 53), 0), ((1, 16, 40, 128), 0),
                          ((1, 16, 40, 128), 1)):
        x = _offset_int8(torch.randint(-127, 128, shape, generator=g,
                                       dtype=torch.int8).to(dev), offset)
        k = int8_conv(x, w)
        p = int8_conv_plain(x, w)
        assert torch.equal(k, p), (shape, offset, int((k != p).sum()))
        # The planted cases occur: ties, clamped values, ReLU's zeros and
        # shifted copies whose border rows and columns are the padding.
        x0 = x[0, 0].int()
        assert int(((x0 % 2) != 0).sum()) > 100  # odd x: 0.5 x is a tie
        assert int((p[0, 2] == 127).sum()) > 100
        assert int((p[0, 3] == 0).sum()) > 100
        x1 = torch.relu(x[0, 1].int())
        assert torch.equal(p[0, 4, 1:, 1:].int(), x1[:-1, :-1])
        assert int(p[0, 4, 0].abs().sum() + p[0, 4, :, 0].abs().sum()) == 0
        assert int(p[0, 12, -1].abs().sum()
                   + p[0, 12, :, -1].abs().sum()) == 0


def test_plate_session_kernels_match_plain(dev):
    """A bf16 plate_demo session on the planar kernels (24 input
    channels at the stem and the d0 + head cond) against the same stepper
    on the plain versions."""
    import numpy as np

    from vidmat_torch import MattingSession
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.io.fixtures import synthetic_plate_clip
    from vidmat_torch.pipeline.stepper import VideoStepper

    cfg = ModelConfig(use_bg_plate=True, space_to_depth=2,
                      conv_impl="planar")
    h, w = 128, 192
    clip = list(synthetic_plate_clip(h, w, 3, seed=2))
    plate = clip[0][2]
    sess = MattingSession(h, w, model_cfg=cfg, downsample_ratio=0.25,
                          dtype="bfloat16", bg_plate=plate)
    plain = VideoStepper(cfg, h, w, downsample_ratio=0.25, dtype="bfloat16",
                         bg_plate=plate, device=dev, kernels=False)
    for f, _, _ in clip:
        (ka, kf), (pa, pf) = sess.step(f), plain.step(f)
        for k, p in ((ka, pa), (kf, pf)):
            assert float(np.abs(k - p).mean()) <= 2e-3


# ---- float tail, composite, unfused guided tail, session (slice 3) ----


def test_refine_float_kernel_matches_plain(dev):
    from vidmat_torch.ops.refine import (fused_refine_float,
                                         fused_refine_float_plain)

    g = torch.Generator().manual_seed(7)
    # The session's 1080p launch (pool 4, the strip body), a ragged last
    # strip, and pools 2 and 8 (the per-pixel body).
    for (n, h, w), pool in (((1, 1088, 1920), 4), ((2, 64, 300), 4),
                            ((1, 36, 300), 4), ((1, 36, 52), 2),
                            ((2, 64, 296), 8)):
        fr = torch.randint(0, 256, (n, h, w, 3), generator=g,
                           dtype=torch.uint8).to(dev)
        hl, wl = h // pool, w // pool
        a = (torch.rand((n, hl, wl, 4), generator=g) * 2 - 0.5).to(dev)
        b = (torch.rand((n, hl, wl, 4), generator=g) - 0.5).to(dev)
        before = fused_refine_float.launches
        ka, kf = fused_refine_float(fr, a, b, pool)
        assert fused_refine_float.launches == before + 1
        pa, pf = fused_refine_float_plain(fr, a, b, pool)
        assert ka.shape == (n, h, w, 1) and kf.shape == (n, h, w, 3)
        assert float((ka - pa).abs().max()) <= 1e-5
        assert float((kf - pf).abs().max()) <= 1e-5


@pytest.mark.parametrize("mode", ["color", "none", "image", "per_frame"])
def test_composite_kernel_bit_exact(dev, mode):
    from vidmat_torch.ops.composite import (composite_rgba_packed,
                                            composite_rgba_packed_plain)

    g = torch.Generator().manual_seed(8)
    # A ragged shape (h w mod 4 != 0: groups straddle frames, a scalar
    # tail) and the launch shapes of clip_480p and the defaults.
    for n, h, w in ((2, 37, 53), (1, 480, 864), (1, 1088, 1920)):
        fgr = torch.rand((n, h, w, 3), generator=g).to(dev)
        alpha = (torch.rand((n, h, w, 1), generator=g) * 1.2 - 0.1).to(dev)
        bg = {"color": (0.2, 0.9, 0.4), "none": None,
              "image": torch.rand((h, w, 3), generator=g).to(dev),
              "per_frame": torch.rand((n, h, w, 3), generator=g).to(dev)
              }[mode]
        before = composite_rgba_packed.launches
        k = composite_rgba_packed(fgr, alpha, bg)
        assert composite_rgba_packed.launches == before + 1
        assert torch.equal(k, composite_rgba_packed_plain(fgr, alpha, bg)), \
            (n, h, w)


def _offset(t):
    """t's values in a buffer one element past an aligned start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("kernel", ["fused_refine_float",
                                    "composite_rgba_packed"])
def test_tail_kernel_bodies_agree(dev, kernel):
    """The same inputs from a buffer offset by one element take the
    other body of the kernel: fused_refine_float's per-pixel body in
    place of its pool-4 warp strips, composite_rgba_packed's scalar path
    in place of its 16-byte groups. Both give the same values."""
    from vidmat_torch.ops.composite import composite_rgba_packed
    from vidmat_torch.ops.refine import fused_refine_float

    g = torch.Generator().manual_seed(10)
    n, h, w = 2, 68, 300
    if kernel == "fused_refine_float":
        fr = torch.randint(0, 256, (n, h, w, 3), generator=g,
                           dtype=torch.uint8).to(dev)
        a = (torch.rand((n, h // 4, w // 4, 4), generator=g) * 2
             - 0.5).to(dev)
        b = (torch.rand((n, h // 4, w // 4, 4), generator=g) - 0.5).to(dev)
        strip = fused_refine_float(fr, a, b, 4)
        pixel = fused_refine_float(_offset(fr), a, b, 4)
        for s, p in zip(strip, pixel):
            assert torch.equal(s, p)
        return
    fgr = torch.rand((n, h, w, 3), generator=g).to(dev)
    alpha = (torch.rand((n, h, w, 1), generator=g) * 1.2 - 0.1).to(dev)
    img = torch.rand((h, w, 3), generator=g).to(dev)
    for bg in (None, (0.2, 0.9, 0.4), img, img.expand(n, -1, -1, -1)):
        bg_o = bg if bg is None or isinstance(bg, tuple) else _offset(bg)
        assert torch.equal(composite_rgba_packed(fgr, alpha, bg),
                           composite_rgba_packed(_offset(fgr),
                                                 _offset(alpha), bg_o))


def test_guided_upsample_kernel_matches_plain(dev):
    from vidmat_torch.ops.gf import guided_filter_coeffs
    from vidmat_torch.ops.guided_filter import guided_upsample

    g = torch.Generator().manual_seed(9)
    rgb = torch.rand((1, 96, 128, 3), generator=g).to(dev)
    alpha = torch.rand((1, 32, 48, 1), generator=g).to(dev)
    fgr = torch.rand((1, 32, 48, 3), generator=g).to(dev)
    before = guided_filter_coeffs.launches
    ka, kf = guided_upsample(rgb, alpha, fgr)
    assert guided_filter_coeffs.launches == before + 1
    pa, pf = guided_upsample(rgb, alpha, fgr, kernels=False)
    assert float((ka - pa).abs().max()) <= 1e-4
    assert float((kf - pf).abs().max()) <= 1e-4


def test_session_kernels_match_plain(dev):
    """A bf16 serving session (s2d=2 planar, ratio 0.5: the float tail)
    on the kernels against the same stepper on the plain versions."""
    import numpy as np

    from vidmat_torch import MattingSession
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.io.fixtures import synthetic_frames_only
    from vidmat_torch.ops.refine import fused_refine_float
    from vidmat_torch.pipeline.stepper import VideoStepper

    cfg = ModelConfig(space_to_depth=2, conv_impl="planar")
    h, w = 128, 192
    sess = MattingSession(h, w, model_cfg=cfg, downsample_ratio=0.5,
                          dtype="bfloat16")
    plain = VideoStepper(cfg, h, w, downsample_ratio=0.5, dtype="bfloat16",
                         device=dev, kernels=False)
    before = fused_refine_float.launches
    for f in synthetic_frames_only(h, w, 3, seed=3):
        (ka, kf), (pa, pf) = sess.step(f), plain.step(f)
        for k, p in ((ka, pa), (kf, pf)):
            assert float(np.abs(k - p).mean()) <= 2e-3
    assert fused_refine_float.launches == before + 3


# ---- planar conv kernels (slice 2) ----


def _close(got, want, ulps):
    """Kernel vs plain on the card. Both sum the same float32 products in
    another order, so after the cast to the plane dtype they differ by at
    most ``ulps`` units in the last place of bfloat16 (2^-7 relative),
    plus, where an intermediate was rounded (the fused kernels' mid, the
    GRU's r * h) or a sum cancels to near zero, an absolute 2^-10 of the
    tensor's largest value (a quarter of a bfloat16 unit at that value).
    float32 planes: 1e-5 relative plus 1e-6 of the largest value."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if want.dtype == torch.bfloat16:
        tol = ulps * 2.0 ** -7 * w.abs() + 2.0 ** -10 * top
    else:
        tol = 1e-5 * w.abs() + 1e-6 * top
    d = (g - w).abs()
    worst = float((d / tol).max())
    assert torch.isfinite(g).all() and worst <= 1.0, (
        f"max |d| {float(d.max()):.3g}, max |want| {top:.3g}, "
        f"{int((d > tol).sum())} of {d.numel()} beyond, worst {worst:.3g}")


def _rand(g, shape, dev, dtype, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


def _conv_args(g, cins, cout, k, dev, dtype):
    fan = sum(cins) * k * k
    w = _rand(g, (cout, sum(cins), k, k), dev, dtype, fan ** -0.5)
    scale = (torch.rand(cout, generator=g) + 0.5).to(dev)
    bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
    return w, scale, bias


def _gru_args(g, c, dev, dtype):
    wg = _rand(g, (2 * c, 2 * c, 3, 3), dev, dtype, (18 * c) ** -0.5)
    wc = _rand(g, (c, 2 * c, 3, 3), dev, dtype, (18 * c) ** -0.5)
    bg = (torch.randn(2 * c, generator=g) * 0.1).to(dev)
    bc = (torch.randn(c, generator=g) * 0.1).to(dev)
    return wg, bg, wc, bc


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 4])
def test_planar_conv_matches_plain(dev, dtype, n):
    from vidmat_torch.ops.planar import planar_conv, planar_conv_plain

    g = torch.Generator().manual_seed(3)
    cases = [((5, 3, 4), 7, 3, 1, 20, 30), ((12,), 16, 3, 2, 36, 60),
             ((64,), 64, 1, 1, 9, 15), ((6,), 9, 3, 2, 13, 21)]
    for cins, cout, k, stride, h, w in cases:
        xs = [_rand(g, (n, c, h, w), dev, dtype) for c in cins]
        wt, sc, bi = _conv_args(g, cins, cout, k, dev, dtype)
        for act in ("relu", "none"):
            before = planar_conv.launches
            got = planar_conv(xs, wt, sc, bi, stride, act)
            assert planar_conv.launches == before + 1
            want = planar_conv_plain(xs, wt, sc, bi, stride, act)
            assert got.shape == want.shape and got.dtype == dtype
            _close(got, want, 1)


# Main-path sites (1080p, fast_demo, s2d 2): the encoder pairs s2, s3, s4
# (batch 4 on the path), d0 + head with 36 inputs and the plate net's 48,
# the decoder stages d3, d2, d1 (batch 1); and ragged shapes: output
# channels not a multiple of 8 (12, 20), input sums not a multiple of 16
# (36, 104, 5 + 3), widths not a multiple of 16, stride 2 on odd sizes.
CONV2_CASES = [((16,), 24, 24, 2, "relu", 72, 120),
               ((24,), 40, 40, 2, "relu", 36, 60),
               ((40,), 64, 64, 2, "relu", 18, 30),
               ((12, 12, 12), 16, 16, 1, "none", 144, 240),
               ((12, 12, 24), 16, 16, 1, "none", 144, 240),
               ((16,), 24, 24, 2, "relu", 36, 60),
               ((12, 12, 12), 16, 16, 1, "none", 20, 30),
               ((5, 3), 6, 4, 2, "relu", 13, 21),
               ((5,), 6, 4, 1, "none", 13, 21),
               ((5, 3), 20, 12, 2, "relu", 13, 21),
               ((64, 40), 12, 20, 1, "relu", 11, 19),
               ((12, 12, 3), 16, 4, 1, "none", 17, 35)]
CONV_GRU_CASES = [((64, 40), 24, 18, 30), ((24, 24, 24), 16, 36, 60),
                  ((16, 16, 16), 12, 72, 120), ((5, 7), 4, 13, 21),
                  ((5, 3), 6, 13, 21), ((12, 12, 12), 10, 11, 19),
                  ((64, 40), 10, 9, 15)]
GRU_CASES = [(12, 20, 30), (24, 18, 30), (5, 13, 21), (16, 36, 60),
             (12, 72, 120), (10, 13, 21), (6, 11, 19)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 4])
def test_planar_conv2_matches_plain(dev, dtype, n):
    from vidmat_torch.ops.planar import planar_conv2, planar_conv2_plain

    g = torch.Generator().manual_seed(4)
    for cins, cmid, cout, stride, act2, h, w in CONV2_CASES:
        xs = [_rand(g, (n, c, h, w), dev, dtype) for c in cins]
        w1, s1, b1 = _conv_args(g, cins, cmid, 3, dev, dtype)
        w2, s2, b2 = _conv_args(g, (cmid,), cout, 3, dev, dtype)
        before = planar_conv2.launches
        got = planar_conv2(xs, w1, s1, b1, w2, s2, b2, stride, "relu", act2)
        assert planar_conv2.launches == before + 1
        want = planar_conv2_plain(xs, w1, s1, b1, w2, s2, b2, stride,
                                  "relu", act2)
        assert got.shape == want.shape
        _close(got, want, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 4])
def test_planar_conv_gru_matches_plain(dev, dtype, n):
    from vidmat_torch.ops.planar import (planar_conv_gru,
                                         planar_conv_gru_plain)

    g = torch.Generator().manual_seed(5)
    for cins, c, h, w in CONV_GRU_CASES:
        xs = [_rand(g, (n, ci, h, w), dev, dtype) for ci in cins]
        wt, sc, bi = _conv_args(g, cins, 2 * c, 3, dev, dtype)
        hp = _rand(g, (n, c, h, w), dev, dtype, 0.5)
        gw = _gru_args(g, c, dev, dtype)
        before = planar_conv_gru.launches
        a, hn = planar_conv_gru(xs, wt, sc, bi, hp, *gw)
        assert planar_conv_gru.launches == before + 1
        wa, wh = planar_conv_gru_plain(xs, wt, sc, bi, hp, *gw)
        _close(a, wa, 1)
        _close(hn, wh, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 4])
def test_planar_gru_matches_plain(dev, dtype, n):
    from vidmat_torch.ops.planar import planar_gru, planar_gru_plain

    g = torch.Generator().manual_seed(6)
    for c, h, w in GRU_CASES:
        x = _rand(g, (n, c, h, w), dev, dtype)
        hp = _rand(g, (n, c, h, w), dev, dtype, 0.5)
        gw = _gru_args(g, c, dev, dtype)
        before = planar_gru.launches
        got = planar_gru(x, hp, *gw)
        assert planar_gru.launches == before + 1
        _close(got, planar_gru_plain(x, hp, *gw), 1)


# ---- planted bf16 rounding ties (slice 5) ----
#
# On bf16 planes the tensor-core kernels sum in k16 chunks, tap by tap, and
# recompute in the CUDA-core kernels' order (input channel, then ky, then
# kx) every value whose bf16 rounding the order could change. These inputs
# put values on bf16 rounding midpoints: b + 2^-8 with b = 1 + j 2^-7, in
# [1, 2), times a power of two. Where nothing else reaches the value the
# sum is exact in every order (an exact tie, rounded half to even). Where
# products of +-2^-26 reach it too, the sequential order drops each of
# them (each is under half a float32 unit of the running sum) and rounds
# the tie half to even, while the chunked order sums them first and rounds
# the value off the tie (a near tie). The kernels must give the sequential
# order's values exactly: the plain versions with ``sequential=True``
# (``planar.seq_conv_f32``). With cuDNN the plain versions choose their
# own order per shape, so on these inputs they are no reference: each case
# prints how far they land from the sequential order.

_TINY = 2.0 ** -13


def _planted_input(g, n, cins, h, w, dev):
    """bf16 inputs split into ``cins``: channel 0 is 1, channel 1 is 2^-8
    on three pixels in four (else 0), the rest +-2^-13 or 0."""
    c = sum(cins)
    x = torch.zeros((n, c, h, w))
    x[:, 0] = 1.0
    x[:, 1] = 2.0 ** -8 * (torch.rand((n, h, w), generator=g) < 0.75)
    x[:, 2:] = _TINY * torch.randint(-1, 2, (n, c - 2, h, w), generator=g)
    return [t.contiguous() for t in torch.split(x.to(dev, torch.bfloat16),
                                                list(cins), 1)]


def _planted_conv(g, cin, small, roles, dev, signed=False, k=3):
    """k x k weights (len(roles), cin, k, k; centre tap for the planted
    terms) in bf16 and float32 scale and
    bias, over inputs whose channel 0 is 1, channel 1 is 2^-8 (or 0) and
    channels ``small`` are +-2^-13 (or 0). roles[co]:
      "tie"       b * [0] + [1] + tiny terms on ``small``, scale a power
                  of two, bias 0: a bf16 midpoint where channel 1 is set;
                  one row in four has no tiny terms (exact ties); negative
                  at random if ``signed``;
      ("pass", k) a copy of channel k;
      "free"      random weights over every channel, scale and bias."""
    cout, c = len(roles), k // 2
    w = torch.zeros((cout, cin, k, k))
    scale, bias = torch.ones(cout), torch.zeros(cout)
    for co, role in enumerate(roles):
        if role == "tie":
            s = -1.0 if signed and torch.rand((), generator=g) < 0.5 else 1.0
            w[co, 0, c, c] = s * (1 + int(torch.randint(0, 128, (),
                                                        generator=g)) / 128)
            w[co, 1, c, c] = s
            if torch.rand((), generator=g) < 0.75:
                w[co, small] = _TINY * torch.randint(
                    -1, 2, (len(small), k, k), generator=g).float()
            scale[co] = 2.0 ** int(torch.randint(-1, 3, (), generator=g))
        elif role == "free":
            w[co] = torch.randn((cin, k, k), generator=g) * (
                k * k * cin) ** -0.5
            scale[co] = float(torch.rand((), generator=g)) + 0.5
            bias[co] = float(torch.randn((), generator=g)) * 0.1
        else:
            w[co, role[1], c, c] = 1.0
    return w.to(dev, torch.bfloat16), scale.to(dev), bias.to(dev)


def _midpoints(acc, scale, bias):
    """Values of acc * scale + bias (float32) that lie on a bf16 rounding
    midpoint."""
    from vidmat_torch.ops.planar import _affine_act

    v = _affine_act(acc, scale, bias, "none")
    return int(((v.view(torch.int32) & 0xFFFF) == 0x8000).sum())


# (input channels, out, k, stride, H, W, batch): the stem (12 inputs,
# stride 2), the bottleneck proj (64, 1x1), the unfused network's d3 conv
# (64 + 40 inputs), a ragged one.
PLANTED_CONV = [((12,), 16, 3, 2, 36, 60, 4), ((64,), 64, 1, 1, 9, 15, 4),
                ((64, 40), 48, 3, 1, 18, 30, 1), ((5, 3), 20, 3, 2, 13, 21, 2)]


@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("case", range(len(PLANTED_CONV)))
def test_planar_conv_rounds_planted_ties_as_sequential_order(dev, case,
                                                             batch):
    """The tensor-core planar_conv equals the sequential order exactly,
    with its weights packed beforehand or by the wrapper; at the case's
    batch and at 8 (the multistream preset's streams)."""
    from vidmat_torch.ops import planar as P

    cins, cout, k, stride, h, w, n = PLANTED_CONV[case]
    n = batch or n
    g = torch.Generator().manual_seed(27 + case)
    cin = sum(cins)
    xs = _planted_input(g, n, cins, h, w, dev)
    roles = ["tie"] * (cout // 2) + ["free"] * (cout - cout // 2)
    wt, sc, bi = _planted_conv(g, cin, list(range(2, cin)), roles, dev,
                               signed=True, k=k)
    wp = P.pack_conv_weight(wt)
    for act in ("relu", "none"):
        got = P.planar_conv(xs, wt, sc, bi, stride, act, wp)
        seq = P.planar_conv_plain(xs, wt, sc, bi, stride, act,
                                  sequential=True)
        plain = P.planar_conv_plain(xs, wt, sc, bi, stride, act)
        assert torch.equal(P.planar_conv(xs, wt, sc, bi, stride, act), got)
        assert torch.equal(got, seq)
    ties = _midpoints(P.seq_conv_f32(xs, wt, stride), sc, bi)
    print(f"planar_conv {PLANTED_CONV[case]}: {ties} midpoints; cuDNN plain "
          f"vs sequential max |d| {float((plain - seq).abs().max())}")
    assert ties > got.numel() // 20


# (input channels, mid, out, stride, H, W) and (input channels, C, H, W):
# the s2 and d0 + head sites' widths, d3's and d1's, ragged ones.
PLANTED_CONV2 = [((16,), 24, 24, 2, 36, 60), ((12, 12, 12), 16, 16, 1, 40, 64),
                 ((5, 3), 12, 20, 2, 13, 21)]
PLANTED_CONV_GRU = [((64, 40), 24, 18, 30), ((16, 16, 16), 12, 36, 60),
                    ((5, 7), 6, 13, 21)]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", range(len(PLANTED_CONV2)))
def test_planar_conv2_rounds_planted_ties_as_sequential_order(dev, case, n):
    from vidmat_torch.ops import planar as P

    cins, cmid, cout, stride, h, w = PLANTED_CONV2[case]
    g = torch.Generator().manual_seed(7 + case)
    cin = sum(cins)
    xs = _planted_input(g, n, cins, h, w, dev)
    # mid: 1, 2^-8 and a few tiny channels passed on, then ties and free
    # values; out: ties over those, free values over all of mid.
    npass = min(cin - 2, cmid // 4)
    ntie = (cmid - 2 - npass) // 2
    roles1 = ([("pass", 0), ("pass", 1)]
              + [("pass", 2 + k) for k in range(npass)]
              + ["tie"] * ntie + ["free"] * (cmid - 2 - npass - ntie))
    w1, s1, b1 = _planted_conv(g, cin, list(range(2, cin)), roles1, dev)
    roles2 = ["tie"] * (cout // 2) + ["free"] * (cout - cout // 2)
    w2, s2, b2 = _planted_conv(g, cmid, list(range(2, 2 + npass)), roles2,
                               dev, signed=True)
    args = (xs, w1, s1, b1, w2, s2, b2, stride, "relu", "none")

    got = P.planar_conv2(*args)
    plain = P.planar_conv2_plain(*args)
    seq = P.planar_conv2_plain(*args, sequential=True)
    mid = P.planar_conv_plain(xs, w1, s1, b1, stride, "relu",
                              sequential=True)
    ties = (_midpoints(P.seq_conv_f32(xs, w1, stride), s1, b1)
            + _midpoints(P.seq_conv_f32([mid], w2, 1), s2, b2))
    print(f"planar_conv2 {PLANTED_CONV2[case]}: {ties} midpoints; cuDNN "
          f"plain vs sequential max |d| {float((plain - seq).abs().max())}")
    assert ties > got.numel() // 20
    assert torch.equal(got, seq)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("case", range(len(PLANTED_CONV_GRU)))
def test_planar_conv_gru_rounds_planted_ties_as_sequential_order(dev, case,
                                                                 n):
    """Also fused = unfused: planar_conv then planar_gru give the fused
    stage's a and h'."""
    from vidmat_torch.ops import planar as P

    cins, c, h, w = PLANTED_CONV_GRU[case]
    g = torch.Generator().manual_seed(17 + case)
    cin = sum(cins)
    xs = _planted_input(g, n, cins, h, w, dev)
    half = ["tie"] * (c // 2) + ["free"] * (c - c // 2)
    wt, sc, bi = _planted_conv(g, cin, list(range(2, cin)), half + half, dev)
    hp = _rand(g, (n, c, h, w), dev, torch.bfloat16, 0.5)
    gw = _gru_args(g, c, dev, torch.bfloat16)

    a, hn = P.planar_conv_gru(xs, wt, sc, bi, hp, *gw)
    mid = P.planar_conv(xs, wt, sc, bi, 1, "relu")
    ua = mid[:, :c].contiguous()
    uh = P.planar_gru(mid[:, c:].contiguous(), hp, *gw)
    pa, ph = P.planar_conv_gru_plain(xs, wt, sc, bi, hp, *gw)
    sa, sh = P.planar_conv_gru_plain(xs, wt, sc, bi, hp, *gw,
                                     sequential=True)
    smid = P.planar_conv_plain(xs, wt, sc, bi, 1, "relu", sequential=True)
    ties = _midpoints(P.seq_conv_f32(xs, wt, 1), sc, bi)
    print(f"planar_conv_gru {PLANTED_CONV_GRU[case]}: {ties} midpoints; "
          f"cuDNN plain vs sequential max |d| a "
          f"{float((pa - sa).abs().max())}, h' "
          f"{float((ph - sh).abs().max())}")
    assert ties > mid.numel() // 20
    assert torch.equal(mid, smid)
    assert torch.equal(a, ua) and torch.equal(hn, uh)
    assert torch.equal(a, sa) and torch.equal(hn, sh)


# ---- same-sign tiny terms ----
#
# The planted ties above draw the tiny terms' signs at random, so their sum
# off the midpoint grows like a random walk. Here every tiny product is
# +2^-25 (inputs 2^-12, weights 2^-13): half of float32's half-unit on
# [1, 2), so the sequential order drops each one and rounds the tie half
# to even, while an order that sums them first lands up to (C - 2) * 9 *
# 2^-25 off the midpoint: linear in the number of terms K, not like sqrt(K).
# The error of a K-term float32 sum is bounded by about K u S (u = 2^-24,
# S = sum |x w|); each case prints that bound beside the sequential
# order's measured distance from the exact sum, in units of u S. Cases at
# 64 input channels and at d3's 104, for every bf16 tensor-core kernel.

_SS_X, _SS_W = 2.0 ** -12, 2.0 ** -13


def _same_sign_input(g, n, cins, h, w, dev):
    """bf16 inputs split into ``cins``: channel 0 is 1, channel 1 is 2^-8
    on three pixels in four, the rest 2^-12 on three pixels in four (else
    0)."""
    c = sum(cins)
    x = torch.zeros((n, c, h, w))
    x[:, 0] = 1.0
    x[:, 1] = 2.0 ** -8 * (torch.rand((n, h, w), generator=g) < 0.75)
    x[:, 2:] = _SS_X * (torch.rand((n, c - 2, h, w), generator=g) < 0.75)
    return [t.contiguous() for t in torch.split(x.to(dev, torch.bfloat16),
                                                list(cins), 1)]


def _same_sign_conv(g, cin, roles, k, dev):
    """(len(roles), cin, k, k) bf16 weights, float32 scale and bias.
    roles[co]: "tie" is b * [0] + [1] at the centre tap (b = 1 + j 2^-7,
    negative at random) plus 2^-13 on every tap of channels 2.., scale a
    power of two, bias 0; "free" is random weights, scale and bias."""
    cout, c = len(roles), k // 2
    w = torch.zeros((cout, cin, k, k))
    scale, bias = torch.ones(cout), torch.zeros(cout)
    for co, role in enumerate(roles):
        if role == "tie":
            s = -1.0 if torch.rand((), generator=g) < 0.5 else 1.0
            w[co, 0, c, c] = s * (1 + int(torch.randint(0, 128, (),
                                                        generator=g)) / 128)
            w[co, 1, c, c] = s
            w[co, 2:] = _SS_W
            scale[co] = 2.0 ** int(torch.randint(-1, 3, (), generator=g))
        else:
            w[co] = torch.randn((cin, k, k), generator=g) * (
                k * k * cin) ** -0.5
            scale[co] = float(torch.rand((), generator=g)) + 0.5
            bias[co] = float(torch.randn((), generator=g)) * 0.1
    return w.to(dev, torch.bfloat16), scale.to(dev), bias.to(dev)


def _sum_error(xs, w, stride):
    """(K, max |seq - exact| / (u S)) over the values of a conv: the
    bound's factor K (products per value) and the sequential order's
    distance from the exact sum (float64, exact here) in units of u S."""
    from vidmat_torch.ops.planar import seq_conv_f32

    x = torch.cat([t.double().cpu() for t in xs], 1)
    wd = w.double().cpu()
    pad = w.shape[-1] // 2
    exact = torch.nn.functional.conv2d(x, wd, None, stride, pad)
    s = torch.nn.functional.conv2d(x.abs(), wd.abs(), None, stride, pad)
    seq = seq_conv_f32(xs, w, stride).double().cpu()
    d = (seq - exact).abs() / (2.0 ** -24 * s).clamp_min(1e-300)
    return w[0].numel(), float(d.max())


# (kernel, input channels, k or C, stride, H, W)
SAME_SIGN = [("conv", (64,), 3, 1, 18, 30), ("conv", (64, 40), 3, 2, 18, 30),
             ("conv", (64, 40), 1, 1, 9, 15),
             ("conv2", (64,), 16, 2, 36, 60), ("conv2", (64, 40), 16, 1, 18, 30),
             ("conv_gru", (32, 32), 16, 1, 36, 60),
             ("conv_gru", (64, 40), 24, 1, 18, 30)]


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("case", range(len(SAME_SIGN)))
def test_planar_kernels_round_same_sign_tiny_terms_as_sequential_order(
        dev, case, n):
    from vidmat_torch.ops import planar as P

    key, cins, kc, stride, h, w = SAME_SIGN[case]
    g = torch.Generator().manual_seed(40 + case)
    cin = sum(cins)
    xs = _same_sign_input(g, n, cins, h, w, dev)
    if key == "conv":
        roles = ["tie"] * 12 + ["free"] * 4
        wt, sc, bi = _same_sign_conv(g, cin, roles, kc, dev)
        args = (xs, wt, sc, bi, stride, "none")
        got = (P.planar_conv(*args),)
        seq = (P.planar_conv_plain(*args, sequential=True),)
        plain = (P.planar_conv_plain(*args),)
    elif key == "conv2":
        w1, s1, b1 = _same_sign_conv(g, cin, ["tie"] * 12 + ["free"] * 12, 3,
                                     dev)
        w2, s2, b2 = _same_sign_conv(g, 24, ["free"] * kc, 3, dev)
        wt, sc = w1, s1
        args = (xs, w1, s1, b1, w2, s2, b2, stride, "relu", "none")
        got = (P.planar_conv2(*args),)
        seq = (P.planar_conv2_plain(*args, sequential=True),)
        plain = (P.planar_conv2_plain(*args),)
    else:
        half = ["tie"] * (kc // 2) + ["free"] * (kc - kc // 2)
        wt, sc, bi = _same_sign_conv(g, cin, half + half, 3, dev)
        hp = _rand(g, (n, kc, h, w), dev, torch.bfloat16, 0.5)
        args = (xs, wt, sc, bi, hp, *_gru_args(g, kc, dev, torch.bfloat16))
        got = P.planar_conv_gru(*args)
        seq = P.planar_conv_gru_plain(*args, sequential=True)
        plain = P.planar_conv_gru_plain(*args)
    acc = P.seq_conv_f32(xs, wt, stride)
    ties = _midpoints(acc, sc, torch.zeros_like(sc))
    k, dist = _sum_error(xs, wt, stride)
    unequal = sum(int((a != b).sum()) for a, b in zip(got, seq))
    print(f"same-sign {SAME_SIGN[case]}: {ties} midpoints; bound K u S with "
          f"K = {k}, sequential order measured {dist:.1f} u S from the exact "
          f"sum; kernel values unequal to the sequential order: {unequal}; "
          f"cuDNN plain vs sequential max |d| "
          f"{max(float((a - b).abs().max()) for a, b in zip(plain, seq))}")
    assert ties > acc.numel() // 20
    assert unequal == 0


# ---- sums that cancel ----
#
# The recompute's scale u (K |acc| + 4 S) covers partial sums larger than
# |acc| only as a spread (planar_mma.cuh, Numerics). Here every tie value
# is b * [0] + [1] + B [2] - B [last] + tiny terms: the big terms B = 2^10
# come early and late in the sequential order (input channel, then ky,
# then kx), so every tiny product (2^-8 * 2^-7 = 2^-15, under half a unit
# of B's running sum) on the channels between them is dropped by that
# order, while the tensor-core order (tap by tap, 16 channels a step)
# adds most of them while its running sum is small. The two orders then
# differ by up to ~9 (C - 4) 2^-15, far beyond the spread. The bound of a
# K-term sum, K u S, covers it. Each case prints S / |acc| at the ties and
# the sequential order's distance from the exact sum in units of u S.

_CANCEL_B, _CANCEL_X, _CANCEL_W = 2.0 ** 10, 2.0 ** -8, 2.0 ** -7


def _cancel_input(g, n, cins, h, w, dev):
    """bf16 inputs split into ``cins``: channel 0 is 1, channel 1 is 2^-8
    on three pixels in four, channel 2 and the last are B, the rest 2^-8
    on three pixels in four (else 0)."""
    c = sum(cins)
    x = torch.zeros((n, c, h, w))
    x[:, 0] = 1.0
    x[:, 1] = 2.0 ** -8 * (torch.rand((n, h, w), generator=g) < 0.75)
    x[:, 2] = _CANCEL_B
    x[:, c - 1] = _CANCEL_B
    x[:, 3:c - 1] = _CANCEL_X * (torch.rand((n, c - 4, h, w),
                                            generator=g) < 0.75)
    return [t.contiguous() for t in torch.split(x.to(dev, torch.bfloat16),
                                                list(cins), 1)]


def _cancel_conv(g, cin, roles, k, dev):
    """(len(roles), cin, k, k) bf16 weights, float32 scale and bias.
    roles[co]: "tie" is b * [0] + [1] + [2] - [last] at the centre tap
    (b = 1 + j 2^-7, negative at random) plus 2^-7 on every tap of
    channels 3 .. C - 2, scale a power of two, bias 0; "free" is random
    weights, scale and bias."""
    cout, c = len(roles), k // 2
    w = torch.zeros((cout, cin, k, k))
    scale, bias = torch.ones(cout), torch.zeros(cout)
    for co, role in enumerate(roles):
        if role == "tie":
            s = -1.0 if torch.rand((), generator=g) < 0.5 else 1.0
            w[co, 0, c, c] = s * (1 + int(torch.randint(0, 128, (),
                                                        generator=g)) / 128)
            w[co, 1, c, c] = s
            w[co, 2, c, c] = 1.0
            w[co, cin - 1, c, c] = -1.0
            w[co, 3:cin - 1] = _CANCEL_W
            scale[co] = 2.0 ** int(torch.randint(-1, 3, (), generator=g))
        else:
            w[co] = torch.randn((cin, k, k), generator=g) * (
                k * k * cin) ** -0.5
            scale[co] = float(torch.rand((), generator=g)) + 0.5
            bias[co] = float(torch.randn((), generator=g)) * 0.1
    return w.to(dev, torch.bfloat16), scale.to(dev), bias.to(dev)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("case", range(len(SAME_SIGN)))
def test_planar_kernels_round_cancelling_sums_as_sequential_order(dev, case,
                                                                  n):
    """The same kernels and widths as the same-sign cases, on sums whose
    big terms cancel after the sequential order dropped the tiny ones."""
    from vidmat_torch.ops import planar as P

    key, cins, kc, stride, h, w = SAME_SIGN[case]
    g = torch.Generator().manual_seed(60 + case)
    cin = sum(cins)
    xs = _cancel_input(g, n, cins, h, w, dev)
    if key == "conv":
        wt, sc, bi = _cancel_conv(g, cin, ["tie"] * 12 + ["free"] * 4, kc,
                                  dev)
        args = (xs, wt, sc, bi, stride, "none")
        got = (P.planar_conv(*args),)
        seq = (P.planar_conv_plain(*args, sequential=True),)
    elif key == "conv2":
        w1, s1, b1 = _cancel_conv(g, cin, ["tie"] * 12 + ["free"] * 12, 3,
                                  dev)
        w2, s2, b2 = _cancel_conv(g, 24, ["free"] * kc, 3, dev)
        wt, sc = w1, s1
        args = (xs, w1, s1, b1, w2, s2, b2, stride, "relu", "none")
        got = (P.planar_conv2(*args),)
        seq = (P.planar_conv2_plain(*args, sequential=True),)
    else:
        half = ["tie"] * (kc // 2) + ["free"] * (kc - kc // 2)
        wt, sc, bi = _cancel_conv(g, cin, half + half, 3, dev)
        hp = _rand(g, (n, kc, h, w), dev, torch.bfloat16, 0.5)
        args = (xs, wt, sc, bi, hp, *_gru_args(g, kc, dev, torch.bfloat16))
        got = P.planar_conv_gru(*args)
        seq = P.planar_conv_gru_plain(*args, sequential=True)
    acc = P.seq_conv_f32(xs, wt, stride)
    ties = _midpoints(acc, sc, torch.zeros_like(sc))
    k, dist = _sum_error(xs, wt, stride)
    x = torch.cat([t.double() for t in xs], 1)
    pad = wt.shape[-1] // 2
    s_abs = torch.nn.functional.conv2d(x.abs(), wt.double().abs(), None,
                                       stride, pad)
    ratio = float((s_abs / acc.double().abs().clamp_min(1e-30))[
        :, :12].median())
    unequal = sum(int((a != b).sum()) for a, b in zip(got, seq))
    print(f"cancelling {SAME_SIGN[case]}: {ties} midpoints; S / |acc| at "
          f"the ties (median) {ratio:.0f}; bound K u S with K = {k}, "
          f"sequential order measured {dist:.1f} u S from the exact sum; "
          f"kernel values unequal to the sequential order: {unequal} of "
          f"{sum(t.numel() for t in got)}")
    assert ties > acc.numel() // 20
    assert unequal == 0


def test_planar_tensor_core_plans_fit_every_shipped_site(dev):
    """Every bf16 planar_conv / planar_conv2 / planar_conv_gru / planar_gru
    site of the
    shipped configurations (fast_demo and synthetic_demo at s2d 2 and 1,
    the clean-plate family's extra input channels) gets a tile that fits
    in shared memory: the widths are the configurations' own, and shared
    memory depends on the widths only."""
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.ops.planar import (planar_conv2_plan, planar_conv_plan,
                                         planar_gru_plan)

    for plate in (False, True):
        for s2d in (1, 2):
            cfg = ModelConfig(space_to_depth=s2d, use_bg_plate=plate)
            e, d = cfg.enc_channels, cfg.dec_channels
            # d0 + head's conditioning: the packed input, or the RGB.
            cond = cfg.in_channels * s2d * s2d if s2d > 1 else 3
            pairs = [((e[0],), e[1], e[1], 2), ((e[1],), e[2], e[2], 2),
                     ((e[2],), e[3], e[3], 2),
                     ((d[2] // 2, d[2] // 2, cond), d[3], 4 * s2d * s2d, 1)]
            for cins, cmid, cout, stride in pairs:
                p = planar_conv2_plan(cins, 4, 72, 120, cmid, cout, stride)
                assert p["tile"] > 0 and p["smem"] <= 232448, (cins, p)
            grus = [(e[3] + e[2], d[0] // 2), (d[0] // 2 * 2 + e[1],
                                              d[1] // 2),
                    (d[1] // 2 * 2 + e[0], d[2] // 2)]
            for cin, c in grus:
                for fused in (True, False):
                    p = planar_gru_plan(fused, cin, 1, 36, 60, c)
                    assert p["tile"] > 0 and p["smem"] <= 232448, (cin, p)
            # planar_conv: the stem and proj, and every conv of the unfused
            # network (pairs, decoder convs, d0 and head).
            convs = [((cfg.in_channels * s2d * s2d,), e[0], 3, 2),
                     ((e[3],), e[3], 1, 1),
                     ((e[0],), e[1], 3, 2), ((e[1],), e[1], 3, 1),
                     ((e[1],), e[2], 3, 2), ((e[2],), e[2], 3, 1),
                     ((e[2],), e[3], 3, 2), ((e[3],), e[3], 3, 1),
                     ((e[3], e[2]), d[0], 3, 1),
                     ((d[0] // 2, d[0] // 2, e[1]), d[1], 3, 1),
                     ((d[1] // 2, d[1] // 2, e[0]), d[2], 3, 1),
                     ((d[2] // 2, d[2] // 2, cond), d[3], 3, 1),
                     ((d[3],), 4 * s2d * s2d, 3, 1)]
            for cins, cout, k, stride in convs:
                p = planar_conv_plan(cins, 4, 72, 120, cout, k, stride)
                assert p["tile"][0] > 0 and p["smem"] <= 232448, (cins, p)


def test_planar_wrappers_raise_on_bad_input(dev):
    from vidmat_torch.ops.planar import planar_conv

    x = torch.zeros((1, 4, 8, 8), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((4, 4, 3, 3), device=dev, dtype=torch.float32)
    s = torch.ones(4, device=dev)
    with pytest.raises(ValueError):
        planar_conv([x], w, s, s)  # weights not in the plane dtype
    with pytest.raises(ValueError):
        planar_conv([x.transpose(2, 3)], w.bfloat16(), s, s)


# ---- host side of the pipeline, the chunk graph and fp32 (slice 10) ----


def _launch_counts():
    from vidmat_torch.pipeline.graph import kernel_wrappers

    return {fn.__name__: (fn.launches, dict(getattr(fn, "mode_launches",
                                                    {})))
            for fn in kernel_wrappers()}


def _delta(after, before):
    return {k: (after[k][0] - before[k][0],
                {m: after[k][1][m] - before[k][1][m] for m in after[k][1]})
            for k in after}


def test_chunk_graph_replays_equal_eager_chunk_body(dev):
    """The video_1080p chunk body at 1088x1920 captured once and replayed
    over 8 chunks: every packed byte and the recurrent state equal to the
    eager body's on the same chunks, and each replay counts the launches an
    eager chunk counts (the capture itself counts none)."""
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.graph import ChunkGraph
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    mcfg, pcfg = preset_video_1080p()
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    _, plan = build_serving_body(net, mcfg, pcfg.refine, 1088, 1920, 0.25)
    g = torch.Generator().manual_seed(10)
    chunks = [torch.randint(0, 256, (4, 1088, 1920, 3), generator=g,
                            dtype=torch.uint8).to(dev) for _ in range(8)]
    st = plan.make_state(1)
    eager, eager_counts = [], []
    for c in chunks:
        before = _launch_counts()
        out, st = plan.chunk_body(c, st)
        eager_counts.append(_delta(_launch_counts(), before))
        eager.append(out.clone())
    eager_state = st

    static_in = torch.empty_like(chunks[0])
    before = _launch_counts()
    graph = ChunkGraph(plan.chunk_body, static_in, plan.make_state(1))
    assert _launch_counts() == before  # a capture launches nothing
    st = plan.make_state(1)
    for i, c in enumerate(chunks):
        static_in.copy_(c)
        before = _launch_counts()
        out, st = graph(st)
        assert _delta(_launch_counts(), before) == eager_counts[i]
        assert torch.equal(out, eager[i]), i
    assert st is graph.state
    for a, b in zip(st, eager_state):
        assert torch.equal(a, b)
    assert eager_counts[0]["planar_conv_gru"][0] == 12
    assert eager_counts[0]["fused_refine_composite"] == (1, {
        "color": 0, "none": 1, "image": 0, "per_frame": 0, "coarse": 0})


def test_wavefront_chunk_body_equals_per_frame_chain(dev, monkeypatch):
    """The video_1080p chunk body at 1088x1920, its decoder a wavefront of
    stage-steps on side streams, eager and replayed by ChunkGraph over 3
    chunks: alpha bytes and every state tensor equal to the per-frame
    body's chain over the same frames (``per_frame_chunk``) and to the same
    chunk body with the per-frame decode loop; ``overlapped_steps`` 4K a
    chunk eager and per replay; a replay's launch counts those of an eager
    chunk, with the loop or the wavefront."""
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline import stepfactory
    from vidmat_torch.pipeline.graph import ChunkGraph, per_frame_chunk

    mcfg, pcfg = preset_video_1080p()
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    body, plan = stepfactory.build_serving_body(
        net, mcfg, pcfg.refine, 1088, 1920, 0.25, alpha_only=True)
    g = torch.Generator().manual_seed(24)
    chunks = [torch.randint(0, 256, (4, 1088, 1920, 3), generator=g,
                            dtype=torch.uint8).to(dev) for _ in range(3)]

    def run(fn):
        st, outs, counts, steps = plan.make_state(1), [], [], []
        for c in chunks:
            before = _launch_counts()
            s0 = plan.chunk_body.overlapped_steps
            out, st = fn(c, st)
            counts.append(_delta(_launch_counts(), before))
            steps.append(plan.chunk_body.overlapped_steps - s0)
            outs.append(out.clone())
        torch.cuda.synchronize()
        return outs, [t.clone() for t in st], counts, steps

    chain = run(per_frame_chunk(body))
    wave = run(plan.chunk_body)
    static_in = torch.empty_like(chunks[0])
    graph = ChunkGraph(plan.chunk_body, static_in, plan.make_state(1))
    assert graph.steps_per_replay == 16

    def replay(c, st):
        static_in.copy_(c)
        return graph(st)

    replayed = run(replay)
    monkeypatch.setattr(stepfactory, "decode_frames", _per_frame_decode)
    loop = run(plan.chunk_body)

    assert wave[3] == replayed[3] == [16] * 3 and loop[3] == [0] * 3
    assert wave[2] == replayed[2] == loop[2]
    assert wave[2][0]["planar_conv_gru"][0] == 12
    for name, got in (("eager", wave), ("replayed", replayed),
                      ("per_frame_chunk", chain)):
        for i, (a, b) in enumerate(zip(got[0], loop[0])):
            assert torch.equal(a, b), (name, i)
        for i, (a, b) in enumerate(zip(got[1], loop[1])):
            assert torch.equal(a, b), (name, "state", i)


def _per_frame_decode(net, enc, state, plain=False):
    """A chunk body's decoder as the per-frame loop of net.decode."""
    alphas, fgrs = [], []
    for i in range(enc.b4.shape[0]):
        alpha, fgr, state = net.decode(enc.frame(i), state, plain=plain)
        alphas.append(alpha)
        fgrs.append(fgr)
    return alphas, fgrs, state, 0


def test_convert_video_graph_path_equals_eager_bodies(dev):
    """convert_video on the card with the chunk graph (5 chunks and a
    drained frame at 256x512, pool 4): alpha bytes and launch counts equal
    to the eager bodies' on the same padded frames."""
    import numpy as np

    from vidmat_torch import convert_video, preset_video_1080p
    from vidmat_torch.io.fixtures import synthetic_frames_only
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    mcfg, pcfg = preset_video_1080p()
    frames = list(synthetic_frames_only(250, 500, 21, seed=12))
    before = _launch_counts()
    alphas = []
    m = convert_video(frames, output_alpha=alphas.append, model_cfg=mcfg,
                      pipe_cfg=pcfg)
    graph_counts = _delta(_launch_counts(), before)
    assert m["frames"] == 21 and m["graph_capture_ms"] > 0, m

    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    body, plan = build_serving_body(net, mcfg, pcfg.refine, 256, 512, 0.25,
                                    alpha_only=True)
    padded = torch.from_numpy(np.stack([
        np.pad(f, ((0, 6), (0, 12), (0, 0)), mode="edge")
        for f in frames])).to(dev)
    st = plan.make_state(1)
    outs = []
    before = _launch_counts()
    for c in range(0, 20, 4):
        o, st = plan.chunk_body(padded[c:c + 4], st)
        outs.append(o)
    o, st = body(padded[20:21], st)
    outs.append(o)
    assert _delta(_launch_counts(), before) == graph_counts
    want = torch.cat(outs)[:, :250, :500].cpu().numpy()
    np.testing.assert_array_equal(np.stack(alphas), want)


def test_pad_into_pinned_then_h2d_equals_np_pad(dev):
    import numpy as np

    from vidmat_torch.io.native import pad_into

    rng = np.random.RandomState(13)
    frame = rng.randint(0, 256, (1080, 1920, 3), np.uint8)
    host = torch.empty((2, 1088, 1920, 3), dtype=torch.uint8,
                       pin_memory=True)
    pad_into(frame, host.numpy()[1])
    got = torch.empty((2, 1088, 1920, 3), dtype=torch.uint8, device=dev)
    got[1:].copy_(host[1:], non_blocking=True)
    torch.cuda.synchronize()
    want = np.pad(frame, ((0, 8), (0, 0), (0, 0)), mode="edge")
    assert np.array_equal(got[1].cpu().numpy(), want)


def test_fp32_paths_run_full_fp32_under_default_flags(monkeypatch):
    """Under PyTorch's default flags (cuDNN may take TF32 for float32
    convolutions), MattingSession(dtype="float32") on the card against the
    same session on the CPU over 4 frames: with the scope the port puts
    around its fp32 paths, alpha and fgr max |d| <= 1e-4 (float32 against
    float32 in another summation order). The same run with the scope
    removed (TF32 allowed) is logged beside it. matte_image is held the
    same way. The process-wide flags are left as they were."""
    import contextlib

    import numpy as np

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vidmat_torch import MattingSession, matte_image
    from vidmat_torch import _device
    from vidmat_torch.io.fixtures import synthetic_frames_only

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False  # PyTorch's defaults
    try:
        frames = list(synthetic_frames_only(128, 192, 4, seed=14))
        ref = MattingSession(128, 192, dtype="float32", device="cpu")
        want = [ref.step(f) for f in frames]

        def worst():
            sess = MattingSession(128, 192, dtype="float32", device="cuda")
            d = [0.0, 0.0]
            for f, w in zip(frames, want):
                for j, (a, b) in enumerate(zip(sess.step(f), w)):
                    d[j] = max(d[j], float(np.abs(a - b).max()))
            return d

        scoped = worst()
        assert cudnn.allow_tf32 and not matmul.allow_tf32
        with monkeypatch.context() as mp:
            mp.setattr(_device, "full_fp32", contextlib.nullcontext)
            tf32 = worst()
        img = frames[0][:100, :150]
        ia, if_ = matte_image(img)
        ca, cf = matte_image(img, device="cpu")
        image = [float(np.abs(ia - ca).max()), float(np.abs(if_ - cf).max())]
        print(f"fp32 session card vs CPU, max |d| alpha / fgr: full fp32 "
              f"{scoped[0]:.3g} / {scoped[1]:.3g}; TF32 allowed "
              f"{tf32[0]:.3g} / {tf32[1]:.3g}; matte_image full fp32 "
              f"{image[0]:.3g} / {image[1]:.3g}")
        assert max(scoped) <= 1e-4, scoped
        assert max(image) <= 1e-4, image
        assert cudnn.allow_tf32 and not matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


# ---- one graph per chunk on every path, the captured session step and
# ---- the error-map refiner (slice 12) ----


@pytest.mark.parametrize("case", ["bg_video", "defaults", "foreground"])
def test_per_frame_graph_equals_eager_bodies(dev, case):
    """convert_video over 3 full chunks on a path with no chunk body, with
    one graph per chunk (the first chunk eager, then the capture), against
    the same run through the eager bodies: every output byte equal, two
    replays, and the run's launches the graph's per replay once a chunk.
    bg_video: chunk 4, 3 backgrounds cycled, staged 4 deep; defaults:
    ModelConfig() / PipelineConfig() at ratio 0.3 (chunk 1, no integer
    pool: the GF kernel and the unfused tail); foreground: the
    video_1080p preset with output_foreground (the float tail)."""
    import numpy as np

    from vidmat_torch import convert_video, preset_video_1080p
    from vidmat_torch.io.fixtures import synthetic_frames_only
    from vidmat_torch.pipeline.video import VideoPipeline

    mcfg, pcfg = preset_video_1080p()
    kw, k, target = dict(model_cfg=mcfg, pipe_cfg=pcfg), 4, "output_alpha"
    if case == "bg_video":
        rng = np.random.RandomState(20)
        kw["bg_video"] = [(rng.rand(256, 512, 3) * 255).astype(np.uint8)
                          for _ in range(3)]
        target = "output_composition"
    elif case == "defaults":
        kw, k = dict(downsample_ratio=0.3), 1
    else:
        target = "output_foreground"
    frames = list(synthetic_frames_only(256, 512, 3 * k, seed=21))

    def run():
        outs = []
        before = _launch_counts()
        m = convert_video(frames, **{target: lambda a: outs.append(
            np.array(a))}, **kw)
        return m, outs, _delta(_launch_counts(), before)

    m, outs, launches = run()
    VideoPipeline.capture = False
    try:
        me, eager, _ = run()
    finally:
        VideoPipeline.capture = True
    assert m["graph_replays"] == 2 and "graph_replays" not in me, m
    per = m["graph_launches_per_replay"]
    assert per == {name: n // 3 for name, (n, _) in launches.items() if n}
    for a, b in zip(outs, eager):
        assert np.array_equal(a, b)


def test_session_captured_step_equals_eager_session(dev, tmp_path):
    """MattingSession(128, 192) bf16 on the video_1080p model: its steps
    after the first replay a captured step; every output equal to an
    eager session's (capture off) across a reset and a load_state, and
    the arrays a step returned are not overwritten by later steps."""
    import numpy as np

    from vidmat_torch import MattingSession, preset_video_1080p
    from vidmat_torch.io.fixtures import synthetic_frames_only

    kw = dict(model_cfg=preset_video_1080p()[0], downsample_ratio=0.25,
              dtype="bfloat16")
    sess, eager = MattingSession(128, 192, **kw), MattingSession(128, 192,
                                                                 **kw)
    eager._stepper.capture = False
    frames = list(synthetic_frames_only(128, 192, 12, seed=22))

    def both(fs):
        for f in fs:
            for a, b in zip(sess.step(f), eager.step(f)):
                assert np.array_equal(a, b)

    both(frames[:3])
    assert sess._stepper._graph is not None and eager._stepper._graph is None
    kept = sess.step(frames[3])
    eager.step(frames[3])
    snapshot = [np.array(a) for a in kept]
    sess.reset()
    eager.reset()
    both(frames[4:7])
    path = str(tmp_path / "carry.npz")
    sess.save_state(path, frame_index=7)
    both(frames[7:9])
    assert sess.load_state(path) == 7 and eager.load_state(path) == 7
    both(frames[9:])
    for a, b in zip(kept, snapshot):
        assert np.array_equal(a, b)


def _errormap_body(dev, cdtype, kernels=True, h=256, w=256):
    from vidmat_torch.config import ModelConfig, RefineConfig
    from vidmat_torch.models.weights import (build_network, build_refiner,
                                             default_refiner_variables,
                                             default_variables)
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    cfg = ModelConfig(conv_impl="planar" if kernels else "xla")
    net = build_network(cfg, default_variables(cfg),
                        dtype=None if cdtype == torch.float32 else cdtype,
                        device=dev)
    ref = build_refiner(default_refiner_variables(), 64, 16, device=dev)
    return build_serving_body(net, cfg, RefineConfig("errormap",
                                                     errormap_patches=64),
                              h, w, 0.25, cdtype=cdtype, refiner=ref,
                              use_pallas=kernels, float_output=True)


def test_errormap_body_card_equals_cpu(dev):
    """The fp32 errormap body (no kernels: F.conv2d net, the refiner) at
    256x256 over 3 recurrent frames of the hard clip, on the card against
    the CPU: alpha and fgr max |d| <= 1e-4."""
    from vidmat_torch.io.fixtures import synthetic_hard_clip

    bodies = {}
    for d in (dev, torch.device("cpu")):
        body, plan = _errormap_body(d, torch.float32, kernels=False)
        bodies[d.type] = [body, plan.make_state(1)]
    worst = 0.0
    for f, _ in synthetic_hard_clip(256, 256, 3, seed=23):
        outs = {}
        for name, bs in bodies.items():
            x = torch.from_numpy(f[None]).to(name)
            outs[name], bs[1] = bs[0](x, bs[1])
        for a, b in zip(outs["cuda"], outs["cpu"]):
            worst = max(worst, float((a.cpu() - b).abs().max()))
    print(f"errormap body card vs CPU, 3 frames: max |d| {worst:.3g}")
    assert worst <= 1e-4, worst


def test_errormap_refiner_full_fp32_under_default_tf32_flags(dev):
    """The bf16 errormap body on the card (the planar kernels, the refiner
    in float32) under PyTorch's default flags, where cuDNN may run float32
    convolutions as TF32, against the same body with TF32 off for the
    process: max |d| <= 1e-4 (the body runs its refiner in full
    float32)."""
    from vidmat_torch.io.fixtures import synthetic_hard_clip

    cudnn = torch.backends.cudnn
    frames = [f for f, _ in synthetic_hard_clip(256, 256, 2, seed=24)]
    outs = {}
    saved = cudnn.allow_tf32
    try:
        for allow in (True, False):
            cudnn.allow_tf32 = allow
            body, plan = _errormap_body(dev, torch.bfloat16)
            st = plan.make_state(1)
            outs[allow] = []
            for f in frames:
                o, st = body(torch.from_numpy(f[None]).to(dev), st)
                outs[allow].append([t.clone() for t in o])
    finally:
        cudnn.allow_tf32 = saved
    worst = max(float((a - b).abs().max())
                for fa, fb in zip(outs[True], outs[False])
                for a, b in zip(fa, fb))
    print(f"bf16 errormap body, TF32 allowed vs off: max |d| {worst:.3g}")
    assert worst <= 1e-4, worst


# ---- multi-stream and live serving (slice 13) ----


def _multistream(dev, s, **kw):
    from vidmat_torch import MultiStreamMatting, preset_multistream

    m, p, sc = preset_multistream()
    kw.setdefault("bg_color", (0.0, 1.0, 0.0))
    return MultiStreamMatting(s, sc.height, sc.width, cfg=m,
                              downsample_ratio=sc.downsample_ratio,
                              refine=p.refine, dtype=p.dtype, device=dev,
                              **kw)


def _stream_frames(rounds, s, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (s, 1088, 1920, 3), np.uint8)
            for _ in range(rounds)]


@pytest.mark.parametrize("bg", ["color", "none"])
def test_multistream_batch_of_8_equals_one_stream(dev, bg):
    """The multistream preset at 8 x 1088x1920 (the planar kernels, GF and
    the packed tail, or without a background the float tail, at N = 8):
    each stream's bytes within 1 of the same stream through a one-stream
    instance, over 3 rounds (a reset of stream 3 in the last)."""
    import numpy as np

    kw = {} if bg == "color" else {"bg_color": None}
    eight, one = _multistream(dev, 8, **kw), _multistream(dev, 1, **kw)
    reset = np.zeros(8, bool)
    worst = unequal = 0
    for t, f in enumerate(_stream_frames(3, 8, seed=30)):
        if t == 2:
            reset[3] = True
        got = eight.step(f, reset)
        want = one.step(f[3:4], reset[3:4])
        for g, w in zip(got, want):
            d = np.abs(g[3].astype(int) - w[0].astype(int))
            worst, unequal = max(worst, int(d.max())), unequal + int(
                (d > 0).sum())
    print(f"multistream ({bg}) stream 3 of 8 vs one stream: max |d| "
          f"{worst}, {unequal} bytes unequal")
    assert worst <= 1


def test_multistream_graphs_equal_eager_bodies(dev):
    """The per-round graph and the 2-round graph against the same dispatches
    through the eager bodies (capture off), resets planted mid-chunk: 0
    bytes unequal; a replay counts each kernel's launches once per
    round."""
    import numpy as np

    from vidmat_torch.parallel.multistream import MultiStreamMatting

    frames = np.stack(_stream_frames(6, 8, seed=31))
    reset = np.zeros((6, 8), bool)
    reset[1, 2] = reset[3, 5] = reset[4, 0] = True
    outs = {}
    for capture in (True, False):
        MultiStreamMatting.capture = capture
        try:
            one, two = _multistream(dev, 8), _multistream(dev, 8, chunk=2)
            outs[capture] = (
                [one.step(frames[t], reset[t]) for t in range(6)],
                [two.step(frames[t:t + 2], reset[t:t + 2])
                 for t in range(0, 6, 2)])
        finally:
            MultiStreamMatting.capture = True
        assert (1 in one._graphs) == capture
        assert (2 in two._graphs) == capture
    for (a, b) in zip(outs[True][0] + outs[True][1],
                      outs[False][0] + outs[False][1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for t in range(6):
        for x, y in zip(outs[True][0][t], outs[True][1][t // 2]):
            np.testing.assert_array_equal(x, y[t % 2])


def test_realtime_lockstep_equals_the_stepper(dev):
    """RealtimeMatting(1080, 1920) on the video_1080p model: frames sent one
    at a time (none dropped) give the alpha and composite bytes of a
    VideoStepper stepped frame by frame with the same finish (its captured
    step against the realtime driver's)."""
    import threading

    import numpy as np

    from vidmat_torch import RealtimeMatting, preset_video_1080p
    from vidmat_torch.io.fixtures import synthetic_frames_only
    from vidmat_torch.pipeline.stepper import VideoStepper

    mcfg = preset_video_1080p()[0]
    frames = list(synthetic_frames_only(1080, 1920, 6, seed=32))
    rt = RealtimeMatting(1080, 1920, model_cfg=mcfg, downsample_ratio=0.25,
                         device=dev)
    got, done = [], threading.Event()

    def src():
        for f in frames:
            yield f
            assert done.wait(60.0)
            done.clear()

    def on_frame(a, c):
        got.append((a, c))
        done.set()

    stats = rt.run(src(), on_frame=on_frame)
    assert stats["dropped"] == 0 and stats["processed"] == 6
    st = VideoStepper(mcfg, 1088, 1920, downsample_ratio=0.25,
                      dtype="bfloat16", device=dev)
    for f, (a, c) in zip(frames, got):
        padded = np.pad(f, ((0, 8), (0, 0), (0, 0)), "edge")
        a8, comp = rt._finish(*st.step_device(padded))
        np.testing.assert_array_equal(a, a8)
        np.testing.assert_array_equal(c, comp)
    assert st._graph is not None and rt._stepper._graph is not None


# ---- training (A.15): no hand-written kernel; the card against the CPU --

def _capture_optimizer():
    from vidmat_torch.train import optim

    return optim.GradientTransformation(
        lambda p: {"g": optim.tree_map(optim.zeros_like, p)},
        lambda g, s, p=None: (optim.tree_map(torch.zeros_like, g),
                              {"g": g}))


def _train_grads(kind, variables, batch, device, **kw):
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import (flatten_variables,
                                             numpy_variables)
    from vidmat_torch.train.loop import (TrainState, make_seg_train_step,
                                         make_train_step)

    make = make_train_step if kind == "mat" else make_seg_train_step
    opt = _capture_optimizer()
    st, m = make(ModelConfig(), optimizer=opt, device=device, **kw)(
        TrainState(variables=variables,
                   opt_state=opt.init(variables["params"])), *batch)
    return (flatten_variables(numpy_variables(st.opt_state["g"])),
            {k: float(v) for k, v in m.items()},
            flatten_variables(numpy_variables(
                st.variables["batch_stats"])))


def _rel(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kind", ["mat", "seg"])
def test_train_step_card_equals_cpu(dev, kind):
    """One float32 step (matting with the Laplacian and boundary terms, or
    segmentation) on the card against the CPU: per-leaf gradients within
    1e-4, losses 1e-5, running statistics 1e-5; no hand-written kernel
    launches (training runs F.conv2d through autograd)."""
    import numpy as np

    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import init_params
    from vidmat_torch.pipeline.graph import kernel_wrappers
    from vidmat_torch.train.data import (synthetic_clip_batches,
                                         synthetic_seg_batches)

    variables = init_params(ModelConfig(), seed=0, with_seg=kind == "seg")
    if kind == "mat":
        batch = next(synthetic_clip_batches(t=2, n=2, h=64, w=64, seed=3))
        kw = dict(laplacian_weight=0.5, boundary_weight=2.0)
    else:
        batch = next(synthetic_seg_batches(t=2, n=2, h=64, w=64, seed=3))
        kw = {}
    kernels = kernel_wrappers()
    before = [fn.launches for fn in kernels]
    g, m, s = _train_grads(kind, variables, batch, dev, **kw)
    assert [fn.launches for fn in kernels] == before
    gc, mc, sc = _train_grads(kind, variables, batch, "cpu", **kw)
    assert set(g) == set(gc) and set(m) == set(mc)
    worst = max(_rel(g[k], gc[k]) for k in gc if np.any(gc[k]))
    assert worst <= 1e-4, worst
    for k in mc:
        assert abs(m[k] - mc[k]) <= 1e-5 * max(abs(mc[k]), 1e-12), k
    for k in sc:
        np.testing.assert_allclose(s[k], sc[k], rtol=0, atol=1e-5)


def test_train_remat_on_and_off_equal_on_card(dev):
    import numpy as np

    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import init_params
    from vidmat_torch.train.data import synthetic_clip_batches

    variables = init_params(ModelConfig(), seed=1)
    batch = next(synthetic_clip_batches(t=3, n=2, h=64, w=64, seed=4))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        (g1, m1, s1), (g0, m0, s0) = (
            _train_grads("mat", variables, batch, dev, remat=r)
            for r in (True, False))
    # Each frame's statistics are folded in once: equal. The gradients
    # differ only by the order autograd sums the frames' contributions
    # (1.4e-6 measured on the H100; 0 on the CPU).
    for k in s0:
        np.testing.assert_array_equal(s1[k], s0[k])
    assert m1 == m0
    assert max(_rel(g1[k], g0[k]) for k in g0) <= 1e-5


def test_refiner_train_step_card_equals_cpu(dev):
    import numpy as np

    from vidmat_torch.models.weights import (flatten_variables,
                                             numpy_variables)
    from vidmat_torch.refine.errormap import ErrorMapRefiner
    from vidmat_torch.train.refine import (init_refiner_params,
                                           make_refiner_train_step)

    rng = np.random.RandomState(0)
    variables = init_refiner_params(seed=0, num_patches=4)
    inputs = [rng.rand(2, 64, 64, 3), rng.rand(2, 32, 32, 3),
              np.clip(rng.rand(2, 32, 32, 1) * 1.4 - 0.2, 0, 1),
              np.clip(rng.rand(2, 64, 64, 1) * 1.4 - 0.2, 0, 1)]
    out = {}
    for d in (dev, "cpu"):
        opt = _capture_optimizer()
        step = make_refiner_train_step(
            ErrorMapRefiner(num_patches=4, patch_size=16), opt, device=d)
        _, st, loss, _ = step(variables, opt.init(variables), *inputs)
        out[str(d)] = (flatten_variables(numpy_variables(st["g"])),
                       float(loss))
    g, loss = out[str(dev)]
    gc, lossc = out["cpu"]
    assert max(_rel(g[k], gc[k]) for k in gc if np.any(gc[k])) <= 1e-4
    assert abs(loss - lossc) <= 1e-5 * lossc
