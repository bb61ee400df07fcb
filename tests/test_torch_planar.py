"""The port's planar conv ops and planar network against the JAX package on
the CPU.

The JAX side runs its planar Pallas kernels in interpret mode on its
flattened planes (``to_planar`` / ``from_planar``, stride-2 convs as 4-tap
convs on space-to-depth-packed planes); the port runs the plain PyTorch
versions of its kernels on NCHW tensors. Inputs come from numpy seeds.
Bounds:
  - ops in float32: atol 1e-5 (tests/unit/test_planar_kernels.py);
  - ops in bfloat16: 1 bfloat16 unit in the last place for a conv and the
    GRU step, 2 for the fused pair and the fused stage, whose intermediate
    is rounded too (both sides sum the same exact products in float32 in
    another order, so a value may round the other way);
  - the network: per-frame alpha and fgr MAD <= 2e-4 in float32
    (tests/parity/test_planar_parity.py) and <= 2e-2 in bfloat16.
The plain versions are held to the JAX package both with ``F.conv2d``
(their CPU path) and with ``sequential=True`` (the fixed-order sum the
bf16 kernels reproduce on the card, ``planar.seq_conv_f32``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig
from vidmat_torch.io.fixtures import synthetic_clip
from vidmat_torch.models.planar import PlanarNetwork, planar_init_state
from vidmat_torch.models.weights import (build_network, default_variables,
                                         folded_planar_params)
from vidmat_torch.ops import planar as P
from vidmat_torch.utils.metrics import mad

CFG = ModelConfig(space_to_depth=2, conv_impl="planar")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _assert_close(got, want, dtype, ulps):
    """float32: atol 1e-5. bfloat16: |d| <= ulps units in the last place
    of bfloat16 at max(|want|, 2^-10 of the largest |want|) (the floor
    judges sums that cancel to near zero on their terms' scale)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    mag = np.maximum(np.abs(want), np.abs(want).max() * 2.0 ** -10)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    d = np.abs(got - want)
    assert (d <= ulps * ulp).all(), (d.max(), float((d / ulp).max()))


def _round(x, tdt):
    """Values representable in the plane dtype (both sides get the same)."""
    return torch.from_numpy(x).to(tdt).float().numpy()


def _nchw(x, tdt):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(x, (0, 3, 1, 2)))).to(tdt)


def _kernel(rng, cin, cout, k=3):
    return (rng.randn(k, k, cin, cout) / np.sqrt(cin * k * k)).astype(
        np.float32)


def _affine(rng, c):
    return ((rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


def _tw(kernel, tdt):
    """Flax (KH, KW, I, O) kernel -> the port's (O, I, KH, KW)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(kernel, (3, 2, 0, 1)))).to(tdt)


def _jplanes(xs, jdt):
    from vidmat.ops.pallas.planar import to_planar

    return [to_planar(jnp.asarray(x).astype(jdt)) for x in xs]


def _jsplit(kernel, cins, jdt):
    from vidmat.ops.pallas.planar import conv_tap_weights

    out, o = [], 0
    for c in cins:
        out.append(conv_tap_weights(jnp.asarray(kernel[:, :, o:o + c]), jdt))
        o += c
    return out


def _jcol(v):
    return jnp.asarray(v)[:, None]


def _jconv_inputs(xs, kernel, stride, jdt):
    """JAX planes, tap weights, tap structure, output grid for a conv."""
    from vidmat.models.matting_net import space_to_depth
    from vidmat.ops.pallas.planar import (conv1x1_taps, conv3x3_taps,
                                          stride2_tap_weights, stride2_taps)

    _, h, w, _ = xs[0].shape
    cins = [x.shape[-1] for x in xs]
    if stride == 2:
        packed = space_to_depth(jnp.asarray(xs[0]).astype(jdt), 2)
        return ([_jplanes([packed], jdt)[0]],
                [stride2_tap_weights(kernel, cins[0], jdt)],
                stride2_taps(w // 2), (h // 2, w // 2))
    taps = conv1x1_taps(w) if kernel.shape[0] == 1 else conv3x3_taps(w)
    return _jplanes(xs, jdt), _jsplit(kernel, cins, jdt), taps, (h, w)


CONV_CASES = {
    "3x3_multi": ([5, 3, 4], 7, 3, 1, 12, 20),
    "stride2": ([6], 8, 3, 2, 16, 30),
    "1x1": ([10], 9, 1, 1, 9, 15),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_planar_conv_plain_matches_jax(case, dt):
    from vidmat.ops.pallas.planar import from_planar, interior_mask
    from vidmat.ops.pallas.planar import planar_conv as j_conv

    jdt, tdt = DTYPES[dt]
    cins, cout, k, stride, h, w = CONV_CASES[case]
    rng = np.random.RandomState(len(case) + 10 * stride)
    xs = [_round(rng.randn(1, h, w, c).astype(np.float32), tdt) for c in cins]
    kern = _round(_kernel(rng, sum(cins), cout, k), tdt)
    sc, bi = _affine(rng, cout)
    planes, ws, taps, (ho, wo) = _jconv_inputs(xs, kern, stride, jdt)
    for act in ("relu", "none"):
        want = from_planar(j_conv(planes, ws, taps, _jcol(sc), _jcol(bi),
                                  interior_mask(ho, wo), act=act,
                                  interpret=True), ho, wo)
        args = ([_nchw(x, tdt) for x in xs], _tw(kern, tdt),
                torch.from_numpy(sc), torch.from_numpy(bi), stride, act)
        for got in (P.planar_conv(*args),
                    P.planar_conv_plain(*args, sequential=True)):
            assert got.dtype == tdt
            _assert_close(got.float().permute(0, 2, 3, 1).numpy(),
                          jnp.asarray(want, jnp.float32), tdt, 1)


CONV2_CASES = {
    "stride2_then_3x3": ([16], 12, 8, 2, "relu", 16, 20),
    "3x3_then_3x3_none": ([6, 4, 5], 8, 16, 1, "none", 12, 30),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV2_CASES))
def test_planar_conv2_plain_matches_jax(case, dt):
    from vidmat.ops.pallas.planar import (conv3x3_taps, conv_tap_weights,
                                          from_planar, interior_mask)
    from vidmat.ops.pallas.planar import planar_conv2 as j_conv2

    jdt, tdt = DTYPES[dt]
    cins, cmid, cout, stride, act2, h, w = CONV2_CASES[case]
    rng = np.random.RandomState(20 + stride)
    xs = [_round(rng.randn(1, h, w, c).astype(np.float32), tdt) for c in cins]
    k1 = _round(_kernel(rng, sum(cins), cmid), tdt)
    k2 = _round(_kernel(rng, cmid, cout), tdt)
    s1, b1 = _affine(rng, cmid)
    s2, b2 = _affine(rng, cout)
    planes, ws, taps, (ho, wo) = _jconv_inputs(xs, k1, stride, jdt)
    want = from_planar(j_conv2(
        planes, ws, taps, _jcol(s1), _jcol(b1),
        conv_tap_weights(jnp.asarray(k2), jdt), conv3x3_taps(wo), _jcol(s2),
        _jcol(b2), interior_mask(ho, wo), act="relu", act2=act2,
        interpret=True), ho, wo)
    args = ([_nchw(x, tdt) for x in xs], _tw(k1, tdt), torch.from_numpy(s1),
            torch.from_numpy(b1), _tw(k2, tdt), torch.from_numpy(s2),
            torch.from_numpy(b2), stride, "relu", act2)
    for got in (P.planar_conv2(*args),
                P.planar_conv2_plain(*args, sequential=True)):
        _assert_close(got.float().permute(0, 2, 3, 1).numpy(),
                      jnp.asarray(want, jnp.float32), tdt, 2)


def _gru_weights(rng, half, tdt, jdt):
    """Flax-layout GRU kernels, and both sides' forms of them."""
    from vidmat.ops.pallas.planar import conv_tap_weights

    kg = _round(_kernel(rng, 2 * half, 2 * half), tdt)
    kc = _round(_kernel(rng, 2 * half, half), tdt)
    bg = (rng.randn(2 * half) * 0.1).astype(np.float32)
    bc = (rng.randn(half) * 0.1).astype(np.float32)
    jw = (conv_tap_weights(jnp.asarray(kg[:, :, :half]), jdt),
          conv_tap_weights(jnp.asarray(kg[:, :, half:]), jdt), _jcol(bg),
          conv_tap_weights(jnp.asarray(kc[:, :, :half]), jdt),
          conv_tap_weights(jnp.asarray(kc[:, :, half:]), jdt), _jcol(bc))
    tw = (_tw(kg, tdt), torch.from_numpy(bg), _tw(kc, tdt),
          torch.from_numpy(bc))
    return jw, tw


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_planar_conv_gru_plain_matches_jax(dt):
    from vidmat.ops.pallas.planar import (conv3x3_taps, from_planar,
                                          interior_mask)
    from vidmat.ops.pallas.planar import planar_conv_gru as j_conv_gru

    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(30)
    h, w, cins, half = 12, 20, [7, 5, 4], 6
    xs = [_round(rng.randn(1, h, w, c).astype(np.float32), tdt) for c in cins]
    kern = _round(_kernel(rng, sum(cins), 2 * half), tdt)
    sc, bi = _affine(rng, 2 * half)
    hp = _round((rng.randn(1, h, w, half) * 0.5).astype(np.float32), tdt)
    jw, tw = _gru_weights(rng, half, tdt, jdt)
    ja, jh = j_conv_gru(_jplanes(xs, jdt), _jsplit(kern, cins, jdt),
                        conv3x3_taps(w), _jcol(sc), _jcol(bi),
                        _jplanes([hp], jdt)[0], *jw, interior_mask(h, w),
                        interpret=True)
    args = ([_nchw(x, tdt) for x in xs], _tw(kern, tdt), torch.from_numpy(sc),
            torch.from_numpy(bi), _nchw(hp, tdt), *tw)
    for ta, th in (P.planar_conv_gru(*args),
                   P.planar_conv_gru_plain(*args, sequential=True)):
        for got, want in ((ta, ja), (th, jh)):
            _assert_close(got.float().permute(0, 2, 3, 1).numpy(),
                          jnp.asarray(from_planar(want, h, w), jnp.float32),
                          tdt, 2)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_planar_gru_plain_matches_jax(dt):
    from vidmat.ops.pallas.planar import (conv3x3_taps, from_planar,
                                          interior_mask)
    from vidmat.ops.pallas.planar import planar_gru as j_gru

    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(40)
    h, w, c = 10, 30, 6
    x = _round(rng.randn(1, h, w, c).astype(np.float32), tdt)
    hp = _round((rng.randn(1, h, w, c) * 0.5).astype(np.float32), tdt)
    jw, tw = _gru_weights(rng, c, tdt, jdt)
    want = j_gru(_jplanes([x], jdt)[0], _jplanes([hp], jdt)[0], *jw,
                 interior_mask(h, w), conv3x3_taps(w), interpret=True)
    args = (_nchw(x, tdt), _nchw(hp, tdt), *tw)
    for got in (P.planar_gru(*args),
                P.planar_gru_plain(*args, sequential=True)):
        _assert_close(got.float().permute(0, 2, 3, 1).numpy(),
                      jnp.asarray(from_planar(want, h, w), jnp.float32),
                      tdt, 1)


@pytest.mark.parametrize("n_in", [1, 2, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_seq_conv_f32_matches_conv2d(k, stride, n_in):
    """The sequential-order conv equals F.conv2d exactly where every sum
    is exact (small integers in bfloat16), and within the float32 bound of
    a K-term sum (K u S, u = 2^-24, S = sum |x w|) on random bfloat16
    inputs, where the two orders may round apart."""
    rng = np.random.RandomState(50 + 10 * k + 3 * stride + n_in)
    cins = [3, 5, 4][:n_in]
    h, w, cout = 11, 14, 6
    cases = [(rng.randint(-4, 5, (2, c, h, w)) for c in cins),
             (rng.randn(2, c, h, w) for c in cins)]
    for exact, gen in zip((True, False), cases):
        xs = [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
              for x in gen]
        wt = (rng.randint(-4, 5, (cout, sum(cins), k, k)) if exact
              else rng.randn(cout, sum(cins), k, k) / np.sqrt(sum(cins)))
        wt = torch.from_numpy(wt.astype(np.float32)).to(torch.bfloat16)
        got = P.seq_conv_f32(xs, wt, stride)
        want = P._conv_f32(xs, wt, stride)
        assert got.shape == want.shape == (2, cout, (h - 1) // stride + 1,
                                           (w - 1) // stride + 1)
        if exact:
            assert torch.equal(got, want)
            continue
        x64 = torch.cat([t.double() for t in xs], 1)
        s = torch.nn.functional.conv2d(x64.abs(), wt.double().abs(), None,
                                       stride, k // 2)
        bound = wt[0].numel() * 2.0 ** -24 * s
        assert bool(((got - want).abs().double() <= bound).all())


@pytest.mark.parametrize("k", [1, 3])
def test_pack_conv_weight_round_trips(k):
    """pack_conv_weight's [n][tap][k] layout holds w[n, ci, ky, kx] at
    column (ky * k + kx) * kp + ci and zeros everywhere else (padding
    channels up to kp = up(C_in, 16), rows up to up(C_out, 8), the 8
    trailing columns)."""
    rng = np.random.RandomState(60 + k)
    cout, cin = 12, 20
    w = torch.from_numpy(rng.randn(cout, cin, k, k).astype(np.float32)
                         ).to(torch.bfloat16)
    wp = P.pack_conv_weight(w)
    kp = 32
    assert wp.shape == (16, k * k * kp + 8) and wp.dtype == torch.bfloat16
    body = wp[:cout, :k * k * kp].reshape(cout, k, k, kp)
    assert torch.equal(body[..., :cin].permute(0, 3, 1, 2), w)
    zeros = wp.clone()
    zeros[:cout, :k * k * kp].view(cout, k * k, kp)[:, :, :cin] = 0
    assert not zeros.any()


def test_folded_params_match_jax():
    """BatchNorm folding and weight layout against fold_bn and
    conv_tap_weights on fast_demo."""
    from vidmat.ops.pallas.planar import conv_tap_weights, fold_bn

    variables = default_variables(CFG)
    params = folded_planar_params(CFG, variables)
    prm, stt = variables["params"], variables["batch_stats"]
    sites = {n: (prm["encoder"][n], stt["encoder"][n])
             for n in ("stem", "s2a", "s2b", "s3a", "s3b", "s4a", "s4b")}
    sites["proj"] = (prm["bottleneck"]["proj"], stt["bottleneck"]["proj"])
    for n in ("d3", "d2", "d1"):
        sites[n] = (prm[n]["conv"], stt[n]["conv"])
    sites["d0"] = (prm["d0"], stt["d0"])
    for name, (p, st) in sites.items():
        sc, bi = fold_bn(jnp.asarray(p["bn"]["scale"]),
                         jnp.asarray(p["bn"]["bias"]),
                         jnp.asarray(st["bn"]["mean"]),
                         jnp.asarray(st["bn"]["var"]), CFG.bn_eps)
        np.testing.assert_allclose(params[name]["scale"].numpy(),
                                   np.asarray(sc)[:, 0], rtol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(params[name]["bias"].numpy(),
                                   np.asarray(bi)[:, 0], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        w = params[name]["w"]
        taps = w.permute(2, 3, 0, 1).reshape(-1, w.shape[0], w.shape[1])
        np.testing.assert_array_equal(taps.numpy(), np.asarray(
            conv_tap_weights(jnp.asarray(p["conv"]["kernel"]))), err_msg=name)
    assert torch.equal(params["head"]["bias"],
                       torch.from_numpy(np.asarray(prm["head"]["bias"])))
    assert torch.equal(params["head"]["scale"], torch.ones(16))
    g = prm["d1"]["gru"]
    np.testing.assert_array_equal(
        params["d1_gru"]["wg"].permute(2, 3, 0, 1).reshape(9, 24, 24).numpy(),
        np.asarray(conv_tap_weights(jnp.asarray(g["gates"]["kernel"]))))
    np.testing.assert_array_equal(
        params["gate"]["w"].numpy(),
        np.asarray(prm["bottleneck"]["gate"]["kernel"])[0, 0])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_planar_forward_matches_jax(dt):
    """fast_demo at 64x96 over 3 recurrent frames: the port's planar
    network (plain ops) against build_planar_forward (interpret mode)."""
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.planar import build_planar_forward, plane_to_grid
    from vidmat.models.planar import planar_init_state as j_init

    jdt, tdt = DTYPES[dt]
    h, w = 64, 96
    jcfg = JModelConfig(space_to_depth=2, conv_impl="planar")
    variables = default_variables(CFG)
    fwd = jax.jit(build_planar_forward(jcfg, h, w, dtype=jdt,
                                       interpret=True))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    net = build_network(CFG, variables, dtype=tdt)
    assert isinstance(net, PlanarNetwork) and net.fuse_pairs
    js, ts = j_init(jcfg, h, w, jdt), planar_init_state(CFG, 1, h, w, tdt)
    bound = 2e-4 if tdt == torch.float32 else 2e-2
    with jax.default_matmul_precision("float32"), torch.inference_mode():
        for f, _ in synthetic_clip(h, w, 3, seed=7):
            x = (f.astype(np.float32) / 255.0)[None]
            ja, jf, js = fwd(jvars, jnp.asarray(x), js)
            ta, tf, ts = net(torch.from_numpy(x), ts)
            assert ta.shape == (1, h, w, 1) and tf.shape == (1, h, w, 3)
            assert mad(ja, ta.numpy()) <= bound
            assert mad(jf, tf.numpy()) <= bound
            for jl, tl in zip(js, ts):
                grid = plane_to_grid(jl, *tl.shape[2:]).astype(jnp.float32)
                assert mad(grid, tl[0].float().numpy()) <= bound


def test_fuse_pairs_false_matches_fused():
    """The unfused chain (two planar_conv per pair, planar_conv + split +
    planar_gru per stage) against the fused network, float32, 3 frames."""
    variables = default_variables(CFG)
    fused = build_network(CFG, variables)
    chain = build_network(CFG, variables, fuse_pairs=False)
    assert not chain.fuse_pairs
    h, w = 64, 96
    sf = planar_init_state(CFG, 1, h, w, torch.float32)
    sc = planar_init_state(CFG, 1, h, w, torch.float32)
    with torch.inference_mode():
        for f, _ in synthetic_clip(h, w, 3, seed=8):
            x = torch.from_numpy((f.astype(np.float32) / 255.0)[None])
            af, ff, sf = fused(x, sf)
            ac, fc, sc = chain(x, sc)
            torch.testing.assert_close(af, ac, atol=1e-6, rtol=0)
            torch.testing.assert_close(ff, fc, atol=1e-6, rtol=0)
            for a, b in zip(sf, sc):
                torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_encode_batched_equals_per_frame():
    """encode over a batch equals encode frame by frame (the chunk body
    batches it), and PlanarEncoding.frame slices it back. float32; atol
    1e-5 as the CPU convolution may sum a batch in another order."""
    net = build_network(CFG, default_variables(CFG))
    frames = torch.from_numpy(np.stack(
        [f for f, _ in synthetic_clip(64, 96, 3, seed=9)]).astype(
            np.float32) / 255.0)
    with torch.inference_mode():
        enc = net.encode(frames)
        for i in range(3):
            one = net.encode(frames[i:i + 1])
            for a, b in zip(enc.frame(i), one):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
