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
    for shape, pool in (((1, 64, 96, 3), 4), ((2, 30, 50, 4), 2)):
        img = torch.randint(0, 256, shape, generator=g,
                            dtype=torch.uint8).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            before = ingest_pool_normalize.launches
            got = ingest_pool_normalize(img, pool, out_dtype=dt)
            assert ingest_pool_normalize.launches == before + 1
            assert torch.equal(got, ingest_pool_normalize_plain(
                img, pool, out_dtype=dt))


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


@pytest.mark.parametrize("bg", [None, (0.0, 1.0, 0.0)])
def test_refine_kernel_within_one_lsb(dev, bg):
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    g = torch.Generator().manual_seed(2)
    fr = torch.randint(0, 256, (2, 64, 300, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    a = (torch.rand((2, 16, 75, 4), generator=g) * 2 - 0.5).to(dev)
    b = (torch.rand((2, 16, 75, 4), generator=g) - 0.5).to(dev)
    k = fused_refine_composite(fr, a, b, bg, 4).view(torch.uint8).int()
    q = fused_refine_composite_plain(fr, a, b, bg, 4).view(torch.uint8).int()
    assert int((k - q).abs().max()) <= 1


# ---- refine image / coarse modes, int8 probe, plate session (slice 4) ----


@pytest.mark.parametrize("mode", ["image", "per_frame", "coarse"])
def test_refine_kernel_background_modes_within_one_lsb(dev, mode):
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    g = torch.Generator().manual_seed(10)
    n, h, w, pool = 2, 64, 300, 4
    fr = torch.randint(0, 256, (n, h, w, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    a = (torch.rand((n, h // pool, w // pool, 4), generator=g) * 2
         - 0.5).to(dev)
    b = (torch.rand((n, h // pool, w // pool, 4), generator=g) - 0.5).to(dev)
    # Images slightly outside [0, 1]: the image mode takes them unclipped,
    # the coarse mode clips after its upsample.
    shape = {"image": (h, w, 3), "per_frame": (n, h, w, 3),
             "coarse": (n, h // pool, w // pool, 3)}[mode]
    bg = (torch.rand(shape, generator=g) * 1.2 - 0.1).to(dev)
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


def test_int8_conv_kernel_matches_plain(dev):
    from vidmat_torch.ops.int8_planar import int8_conv, int8_conv_plain

    g = torch.Generator().manual_seed(11)
    w = (torch.randn((16, 16, 3, 3), generator=g) * 0.2).to(dev,
                                                             torch.bfloat16)
    for shape in ((2, 16, 144, 240), (1, 16, 13, 37)):
        x = torch.randint(-127, 128, shape, generator=g,
                          dtype=torch.int8).to(dev)
        before = int8_conv.launches
        k = int8_conv(x, w)
        assert int8_conv.launches == before + 1
        d = (k.int() - int8_conv_plain(x, w).int()).abs()
        # The two sum the same exact products in another order: a tie of
        # the requantization may round the other way.
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3


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
    for (n, h, w), pool in (((2, 64, 300), 4), ((1, 36, 52), 2)):
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
    n, h, w = 2, 37, 53
    fgr = torch.rand((n, h, w, 3), generator=g).to(dev)
    alpha = (torch.rand((n, h, w, 1), generator=g) * 1.2 - 0.1).to(dev)
    bg = {"color": (0.2, 0.9, 0.4), "none": None,
          "image": torch.rand((h, w, 3), generator=g).to(dev),
          "per_frame": torch.rand((n, h, w, 3), generator=g).to(dev)}[mode]
    before = composite_rgba_packed.launches
    k = composite_rgba_packed(fgr, alpha, bg)
    assert composite_rgba_packed.launches == before + 1
    assert torch.equal(k, composite_rgba_packed_plain(fgr, alpha, bg))


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 4])
def test_planar_conv2_matches_plain(dev, dtype, n):
    from vidmat_torch.ops.planar import planar_conv2, planar_conv2_plain

    g = torch.Generator().manual_seed(4)
    cases = [((16,), 24, 24, 2, "relu", 36, 60),
             ((12, 12, 12), 16, 16, 1, "none", 20, 30),
             ((5, 3), 6, 4, 2, "relu", 13, 21),
             ((5,), 6, 4, 1, "none", 13, 21)]
    for cins, cmid, cout, stride, act2, h, w in cases:
        xs = [_rand(g, (n, c, h, w), dev, dtype) for c in cins]
        w1, s1, b1 = _conv_args(g, cins, cmid, 3, dev, dtype)
        w2, s2, b2 = _conv_args(g, (cmid,), cout, 3, dev, dtype)
        got = planar_conv2(xs, w1, s1, b1, w2, s2, b2, stride, "relu", act2)
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
    for cins, c, h, w in (((64, 40), 24, 18, 30), ((16, 16, 16), 12, 72, 120),
                          ((5, 7), 4, 13, 21)):
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
    for c, h, w in ((12, 20, 30), (24, 18, 30), (5, 13, 21)):
        x = _rand(g, (n, c, h, w), dev, dtype)
        hp = _rand(g, (n, c, h, w), dev, dtype, 0.5)
        gw = _gru_args(g, c, dev, dtype)
        before = planar_gru.launches
        got = planar_gru(x, hp, *gw)
        assert planar_gru.launches == before + 1
        _close(got, planar_gru_plain(x, hp, *gw), 1)


def test_planar_wrappers_raise_on_bad_input(dev):
    from vidmat_torch.ops.planar import planar_conv

    x = torch.zeros((1, 4, 8, 8), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((4, 4, 3, 3), device=dev, dtype=torch.float32)
    s = torch.ones(4, device=dev)
    with pytest.raises(ValueError):
        planar_conv([x], w, s, s)  # weights not in the plane dtype
    with pytest.raises(ValueError):
        planar_conv([x.transpose(2, 3)], w.bfloat16(), s, s)
