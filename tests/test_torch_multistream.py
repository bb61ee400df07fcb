"""The port's ``MultiStreamMatting`` against the JAX package's
(``vidmat.parallel.multistream.MultiStreamMatting`` with ``mesh=None``) on
the CPU, on the same seeded numpy frames and the same variables.

float32 with the F.conv2d net (4 streams at 64x64, 3 rounds, a reset in
the last); the bf16 planar path of the ``multistream`` preset's model
(fast_demo), the JAX class with its Pallas kernels in interpret mode, 2
streams at 64x64, ratio 0.5 (pool 2), the packed fused tail over a
color, 2 rounds; portrait blur, the trimap-conditioned model and a
shared and a per-stream clean plate. Bars: output bytes mean |d| <= 0.26
LSB and max <= 2 against the JAX package (the bar of
tests/test_torch_planar_serving.py); stream i of S against a one-stream
port instance max <= 1. Then the port alone: chunk 2 against per-round
dispatch, reset isolation, ``serve`` with streams that end and a partial
tail chunk, and the preconditions, each raising as in the JAX class.
On a mesh (``mesh=``; JAX: 2 of the conftest's 8 virtual CPU devices,
the planar model's kernels in interpret mode; the port: ``["cpu"] * 2``
positions): 4 streams in float32 at ratio 0.5 against the JAX class
(the same bars) and within 1 of the port's unmeshed instance; chunk 2
against per-round dispatch, portrait blur, the trimap model, a shared
plate and ``serve`` on the mesh against the unmeshed instance.
"""

import functools

import jax
import numpy as np
import pytest

import vidmat.config as jconfig
from vidmat.parallel.mesh import make_mesh as jmake_mesh
from vidmat.parallel.multistream import MultiStreamMatting as JMulti

import vidmat_torch.config as tconfig
from vidmat_torch import MultiStreamMatting
from vidmat_torch.io.fixtures import synthetic_frames_only
from vidmat_torch.models.weights import default_variables
from vidmat_torch.parallel.mesh import make_mesh

H = W = 64


def _frames(rounds, s, seed, c=3, h=H, w=W):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (s, h, w, c), np.uint8)
            for _ in range(rounds)]


def _bytes_close(got, want):
    """mean |d| <= 0.26 LSB and max <= 2 over every output byte."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.uint8, (g.shape, w.shape)
        d = np.abs(g.astype(int) - w.astype(int))
        assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


@pytest.fixture(scope="module")
def base_vars():
    return default_variables(tconfig.ModelConfig())


@pytest.fixture(scope="module")
def preset_vars():
    return default_variables(tconfig.preset_multistream()[0])


@pytest.fixture(scope="module")
def fp32_pair(base_vars):
    """The float32 F.conv2d instances, 4 streams, built once."""
    j = JMulti(4, H, W, cfg=jconfig.ModelConfig(), variables=base_vars,
               dtype="float32")
    t = MultiStreamMatting(4, H, W, cfg=tconfig.ModelConfig(),
                           variables=base_vars, dtype="float32",
                           device="cpu")
    return j, t


def test_float32_matches_jax_and_one_stream(fp32_pair, base_vars):
    j, t = fp32_pair
    frames = _frames(3, 4, seed=0)
    resets = [None, None, np.array([False, True, False, False])]
    one = MultiStreamMatting(1, H, W, cfg=tconfig.ModelConfig(),
                             variables=base_vars, dtype="float32",
                             device="cpu")
    for f, r in zip(frames, resets):
        got, want = t.step(f, r), j.step(f, r)
        assert got[0].shape == (4, H, W, 1) and got[1].shape == (4, H, W, 3)
        _bytes_close(got, want)
        a1, o1 = one.step(f[2:3], None if r is None else r[2:3])
        assert np.abs(got[0][2].astype(int) - a1[0]).max() <= 1
        assert np.abs(got[1][2].astype(int) - o1[0]).max() <= 1


def test_bf16_planar_matches_jax_interpreted(preset_vars):
    """The preset's model and tail: pool 2, the packed fused tail over a
    green background (the JAX Pallas kernels in interpret mode)."""
    m, _, s = tconfig.preset_multistream()
    jm, _, _ = jconfig.preset_multistream()
    kw = dict(variables=preset_vars, dtype="bfloat16", downsample_ratio=0.5,
              bg_color=(0.0, 1.0, 0.0))
    j = JMulti(2, H, W, cfg=jm, use_pallas=True, pallas_interpret=True, **kw)
    t = MultiStreamMatting(2, H, W, cfg=m, device="cpu", **kw)
    assert t._packed and t.net_h == H // 2
    frames = _frames(2, 2, seed=1)
    for f in frames:
        alpha, rgba = t.step(f)
        assert alpha.shape == (2, H, W, 1) and rgba.shape == (2, H, W, 4)
        np.testing.assert_array_equal(alpha[..., 0], rgba[..., 3])
        _bytes_close((alpha, rgba), j.step(f))


@pytest.mark.parametrize("case", ["bg_blur", "trimap", "shared plate",
                                  "per-stream plate"])
def test_variants_match_jax(case):
    """float32 at full resolution: portrait blur over each stream's own
    frames, the trimap-conditioned model (trimap_demo) on 4-channel
    frames, and the plate family (plate_demo) with one plate shared by
    the streams and with a plate per stream."""
    from vidmat_torch.io.fixtures import synthetic_plate_frame

    kw, c = {}, 3
    if case == "bg_blur":
        cfg = dict()
        kw["bg_blur"] = 8
    elif case == "trimap":
        cfg = dict(use_trimap=True, recurrent=False)
        c = 4
    else:
        cfg = dict(use_bg_plate=True, space_to_depth=2)
        plate = synthetic_plate_frame(H, W, 0.0, seed=1)[2]
        kw["bg_plate"] = (plate if case == "shared plate" else
                          np.stack([plate, np.roll(plate, 9, axis=1)]))
    tcfg, jcfg = tconfig.ModelConfig(**cfg), jconfig.ModelConfig(**cfg)
    variables = default_variables(tcfg)
    j = JMulti(2, H, W, cfg=jcfg, variables=variables, dtype="float32", **kw)
    t = MultiStreamMatting(2, H, W, cfg=tcfg, variables=variables,
                           dtype="float32", device="cpu", **kw)
    frames = _frames(2, 2, seed=3, c=c)
    if c == 4:  # the trimap byte in {0, 128, 255}
        for f in frames:
            f[..., 3] = np.array([0, 128, 255], np.uint8)[
                np.digitize(f[..., 3], [85, 170])]
    outs = []
    for f in frames:
        got = t.step(f)
        _bytes_close(got, j.step(f))
        outs.append(got)
    if case == "bg_blur":
        assert outs[0][1].shape == (2, H, W, 4)  # the composite, not fgr
    if case == "per-stream plate":
        same = np.stack([frames[0][0]] * 2)
        a, _ = t.step(same)
        assert np.abs(a[0].astype(int) - a[1].astype(int)).max() > 0


def test_chunk_equals_per_round_dispatch(preset_vars):
    """chunk=2 (two rounds a dispatch, a reset planted in the second)
    against per-round dispatch: bytes and the carry equal."""
    m = tconfig.preset_multistream()[0]
    kw = dict(cfg=m, variables=preset_vars, downsample_ratio=0.5,
              bg_color=(0.0, 1.0, 0.0), device="cpu")
    one = MultiStreamMatting(2, H, W, **kw)
    two = MultiStreamMatting(2, H, W, chunk=2, **kw)
    frames = np.stack(_frames(4, 2, seed=4))
    reset = np.zeros((4, 2), bool)
    reset[1, 0] = reset[3, 1] = True
    for c in range(2):
        a2, o2 = two.step(frames[2 * c:2 * c + 2], reset[2 * c:2 * c + 2])
        assert a2.shape == (2, 2, H, W, 1) and o2.shape == (2, 2, H, W, 4)
        for r in range(2):
            a1, o1 = one.step(frames[2 * c + r], reset[2 * c + r])
            np.testing.assert_array_equal(a2[r], a1)
            np.testing.assert_array_equal(o2[r], o1)
    for x, y in zip(one.state, two.state):
        assert bool((x == y).all())


def test_reset_isolation(base_vars):
    """Resetting one stream leaves the others' bytes as they were; the
    reset stream equals a fresh one-stream instance on that frame."""
    kw = dict(cfg=tconfig.ModelConfig(), variables=base_vars,
              dtype="float32", device="cpu")
    a = MultiStreamMatting(4, H, W, **kw)
    b = MultiStreamMatting(4, H, W, **kw)
    f0, f1 = _frames(2, 4, seed=5)
    a.step(f0)
    b.step(f0)
    reset = np.array([False, True, False, False])
    ar, _ = a.step(f1, reset)
    ap, _ = b.step(f1)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(ar[i], ap[i])
    cold = MultiStreamMatting(1, H, W, **kw)
    a1, _ = cold.step(f1[1:2])
    np.testing.assert_array_equal(ar[1], a1[0])
    assert not np.array_equal(ap[1], a1[0])


def test_serve_streams_that_end_and_a_partial_tail(preset_vars):
    """chunk 4: two streams of 7 and 5 frames (the second ends inside a
    chunk) give every frame of each stream, byte-equal to the chunk-1
    serve; max_frames=3 stops inside the first chunk, drained round by
    round."""
    m = tconfig.preset_multistream()[0]
    kw = dict(cfg=m, variables=preset_vars, downsample_ratio=0.5,
              bg_color=(0.0, 1.0, 0.0), device="cpu")
    h, w = 48, 64

    def srcs(n0=7, n1=5):
        return [list(synthetic_frames_only(h, w, n0)),
                list(synthetic_frames_only(h, w, n1, seed=2))]

    got1, gotk = {}, {}
    s1 = MultiStreamMatting(2, h, w, **kw).serve(
        srcs(), on_output=lambda i, n, a, o: got1.__setitem__((i, n), o))
    sk = MultiStreamMatting(2, h, w, chunk=4, **kw).serve(
        srcs(), on_output=lambda i, n, a, o: gotk.__setitem__((i, n), o))
    assert set(got1) == set(gotk)
    assert sorted(n for i, n in gotk if i == 0) == list(range(7))
    assert sorted(n for i, n in gotk if i == 1) == list(range(5))
    for key in got1:
        np.testing.assert_array_equal(got1[key], gotk[key])
    assert s1["batch_steps"] == sk["batch_steps"] >= 7
    assert sk["latency_granularity"] == "per-4-round-dispatch"
    assert "latency_granularity" not in s1
    assert sk["stream_fps"] == pytest.approx(2 * sk["fps"])
    got = []
    s = MultiStreamMatting(2, h, w, chunk=4, **kw).serve(
        srcs(8, 8), on_output=lambda i, n, a, o: got.append((i, n)),
        max_frames=3)
    assert s["batch_steps"] == 3 and len(got) == 6


PRECONDITIONS = {
    "size": (dict(num_streams=2, height=60, width=64), ValueError,
             "multiples of 16"),
    "bg_blur and bg_color": (dict(num_streams=2, height=64, width=64,
                                  bg_blur=8, bg_color=(0.0, 1.0, 0.0)),
                             ValueError, "mutually exclusive"),
    "plate batch": (dict(num_streams=3, height=64, width=64,
                         bg_plate=np.zeros((2, 64, 64, 3), np.uint8)),
                    ValueError, "num_streams"),
}


@pytest.mark.parametrize("case", sorted(PRECONDITIONS) + ["channels",
                                                          "mesh"])
def test_preconditions_raise_as_in_jax(case, fp32_pair):
    if case == "channels":
        j, t = fp32_pair
        f = _frames(1, 4, seed=6, c=4)[0]
        for inst in (j, t):
            with pytest.raises(ValueError, match="frames have 4 channels"):
                inst.step(f)
        return
    if case == "mesh":
        # On a mesh of 2 positions: an uneven split of the streams, and a
        # plate per stream (a single-card feature).
        plates = np.zeros((4, 64, 64, 3), np.uint8)
        cfg = dict(use_bg_plate=True, space_to_depth=2)
        for cls, mesh, mcfg in ((JMulti, jmake_mesh(
                devices=jax.devices()[:2]), jconfig.ModelConfig(**cfg)),
                (functools.partial(MultiStreamMatting, device="cpu"),
                 make_mesh(devices=["cpu"] * 2), tconfig.ModelConfig(**cfg))):
            with pytest.raises(ValueError, match="divide evenly"):
                cls(3, 64, 64, mesh=mesh)
            with pytest.raises(ValueError, match="single-chip"):
                cls(4, 64, 64, cfg=mcfg, mesh=mesh, bg_plate=plates)
        return
    kw, exc, match = PRECONDITIONS[case]
    with pytest.raises(exc, match=match):
        JMulti(**kw)
    with pytest.raises(exc, match=match):
        MultiStreamMatting(**kw, device="cpu")


def test_mesh_matches_jax_and_one_position():
    """4 streams over 2 positions: the planar model in float32 at ratio
    0.5 over a color against the JAX class on 2 virtual devices (its
    kernels interpreted), and against the port's unmeshed instance
    (within 1), over 3 rounds with a reset in the last."""
    cfg = tconfig.ModelConfig(conv_impl="planar")
    v = default_variables(cfg)
    kw = dict(variables=v, dtype="float32", downsample_ratio=0.5,
              bg_color=(0.1, 0.7, 0.3))
    j = JMulti(4, H, W, cfg=jconfig.ModelConfig(conv_impl="planar"),
               mesh=jmake_mesh(devices=jax.devices()[:2]), use_pallas=True,
               pallas_interpret=True, **kw)
    t = MultiStreamMatting(4, H, W, cfg=cfg, mesh=make_mesh(
        devices=["cpu"] * 2), device="cpu", **kw)
    one = MultiStreamMatting(4, H, W, cfg=cfg, device="cpu", **kw)
    assert [p.device.type for p in t.positions] == ["cpu", "cpu"]
    resets = [None, None, np.array([False, False, True, False])]
    for f, r in zip(_frames(3, 4, seed=8), resets):
        got = t.step(f, r)
        assert got[1].shape == (4, H, W, 4)
        _bytes_close(got, j.step(f, r))
        for g, w in zip(got, one.step(f, r)):
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


@pytest.mark.parametrize("case", ["chunk 2", "bg_blur", "trimap",
                                  "shared plate", "serve"])
def test_mesh_variants_match_one_position(case, preset_vars):
    """On 2 positions, against the unmeshed instance with the same
    options (within 1): chunk 2 (two rounds a dispatch, resets planted)
    against per-round dispatch on the same mesh (equal), portrait blur,
    the trimap model on 4-channel frames, one plate shared by the
    streams, and serve over streams of unequal length."""
    from vidmat_torch.io.fixtures import synthetic_plate_frame

    m = tconfig.preset_multistream()[0]
    kw = dict(cfg=m, variables=preset_vars, downsample_ratio=0.5,
              bg_color=(0.0, 1.0, 0.0), device="cpu")
    c = 3
    if case == "bg_blur":
        kw.pop("bg_color")
        kw["bg_blur"] = 8
    elif case == "trimap":
        cfg = tconfig.ModelConfig(use_trimap=True, recurrent=False)
        kw.update(cfg=cfg, variables=default_variables(cfg),
                  downsample_ratio=1.0, dtype="float32")
        c = 4
    elif case == "shared plate":
        cfg = tconfig.ModelConfig(use_bg_plate=True, space_to_depth=2)
        kw.update(cfg=cfg, variables=default_variables(cfg),
                  bg_plate=synthetic_plate_frame(H, W, 0.0, seed=1)[2])
    mesh = make_mesh(devices=["cpu"] * 2)
    frames = np.stack(_frames(4, 4, seed=9, c=c))
    if c == 4:
        frames[..., 3] = np.array([0, 128, 255], np.uint8)[
            np.digitize(frames[..., 3], [85, 170])]
    if case == "serve":
        srcs = [list(synthetic_frames_only(48, 64, n, seed=i))
                for i, n in enumerate((4, 2, 4, 3))]
        got, want = {}, {}
        t = MultiStreamMatting(4, 48, 64, mesh=mesh, **kw)
        s = t.serve([list(x) for x in srcs],
                    on_output=lambda i, n, a, o: got.__setitem__((i, n), o))
        MultiStreamMatting(4, 48, 64, **kw).serve(
            srcs, on_output=lambda i, n, a, o: want.__setitem__((i, n), o))
        assert set(got) == set(want) and s["batch_steps"] == 5
        for key in got:
            assert np.abs(got[key].astype(int)
                          - want[key].astype(int)).max() <= 1
        return
    if case == "chunk 2":
        reset = np.zeros((4, 4), bool)
        reset[1, 3] = reset[2, 0] = True
        one = MultiStreamMatting(4, H, W, mesh=mesh, **kw)
        two = MultiStreamMatting(4, H, W, mesh=mesh, chunk=2, **kw)
        for r0 in (0, 2):
            a2, o2 = two.step(frames[r0:r0 + 2], reset[r0:r0 + 2])
            assert o2.shape == (2, 4, H, W, 4)
            for r in range(2):
                a1, o1 = one.step(frames[r0 + r], reset[r0 + r])
                np.testing.assert_array_equal(a2[r], a1)
                np.testing.assert_array_equal(o2[r], o1)
        for x, y in zip(one.state, two.state):
            for p, q in zip(x, y):
                assert bool((p == q).all())
        return
    t = MultiStreamMatting(4, H, W, mesh=mesh, **kw)
    u = MultiStreamMatting(4, H, W, **kw)
    for f in frames[:2]:
        for g, w in zip(t.step(f), u.step(f)):
            assert g.shape == w.shape
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
