"""The port's 2-stage pipelined serving (``vidmat_torch.parallel.pp``),
its meshes (``parallel/mesh.py``) and the stage split it is built on
(``ServingPlan.fused_stage0/1``) on the CPU.

Against the JAX package (``vidmat.parallel.pp`` on 2 and 4 of the
conftest's 8 virtual CPU devices, its Pallas kernels in interpret mode;
the port on ``["cpu"] * n`` positions): 64x64 frames, float32, ratio 0.5
(pool 2), the planar model, a color background, the same seeded frames
and variables. Bars: output bytes mean |d| <= 0.26 LSB and max <= 2 (the
bar of tests/test_torch_planar_serving.py); against the port's own
one-stream or unmeshed instance max <= 1 (the bar of
tests/unit/test_pp.py:60-63). The stage composition equals the one-shot
body: 0 bytes differ. Preconditions raise as in the JAX package.
"""

import json

import jax
import numpy as np
import pytest

import vidmat.config as jconfig
from vidmat.parallel.mesh import make_mesh as jmake_mesh
from vidmat.parallel.pp import PipelinedMatting as JPipelinedMatting
from vidmat.parallel.pp import PipelinedStreams as JPipelinedStreams

import vidmat_torch.config as tconfig
from vidmat_torch import MultiStreamMatting
from vidmat_torch.models.weights import default_variables
from vidmat_torch.parallel.mesh import (Mesh, initialize_distributed,
                                        make_mesh)
from vidmat_torch.parallel.pp import PipelinedMatting, PipelinedStreams

H = W = 64
BG = (0.1, 0.7, 0.3)
KW = dict(dtype="float32", downsample_ratio=0.5, bg_color=BG)


def _frames(n, seed=0, c=3, s=None):
    rng = np.random.RandomState(seed)
    shape = (H, W, c) if s is None else (s, H, W, c)
    return [rng.randint(0, 255, shape, np.uint8) for _ in range(n)]


def _bytes_close(got, want):
    """mean |d| <= 0.26 LSB and max <= 2 over every output byte."""
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def _max_d(got, want):
    return int(np.abs(got.astype(int) - want.astype(int)).max())


def _mesh(n, shape=None, axes=("pp",)):
    return make_mesh(axes, shape, devices=["cpu"] * n)


def _jmesh(n, shape=None, axes=("pp",)):
    return jmake_mesh(axes, shape, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def planar():
    """The planar model's configs and variables."""
    cfg = tconfig.ModelConfig(conv_impl="planar")
    return (cfg, jconfig.ModelConfig(conv_impl="planar"),
            default_variables(cfg))


@pytest.fixture(scope="module")
def pp_pair(planar):
    """The port's and the JAX package's PipelinedMatting, built once."""
    cfg, jcfg, v = planar
    return (PipelinedMatting(H, W, _mesh(2), cfg=cfg, variables=v, **KW),
            JPipelinedMatting(H, W, _jmesh(2), cfg=jcfg, variables=v,
                              pallas_interpret=True, **KW))


def test_pipelined_matting_matches_jax_and_one_stream(pp_pair, planar):
    """step / flush over 5 frames: the first step None, each later one
    the frame before, flush the last; a step after the flush returns at
    once (the flush advanced the state, as in the JAX package)."""
    cfg, _, v = planar
    t, j = pp_pair
    frames = _frames(5)
    one = MultiStreamMatting(1, H, W, cfg=cfg, variables=v, device="cpu",
                             **KW)
    ref = [one.step(f[None]) for f in frames]
    t.reset()
    j.reset()
    got, want = [], []
    for i, f in enumerate(frames):
        a, b = t.step(f), j.step(f)
        assert (a is None) == (b is None) == (i == 0)
        if a is not None:
            got.append(a)
            want.append(b)
    got.append(t.flush())
    want.append(j.flush())
    assert len(got) == len(frames)
    for (ga, gr), (wa, wr), (ra, rr) in zip(got, want, ref):
        assert ga.shape == (H, W, 1) and gr.shape == (H, W, 4)
        _bytes_close(ga, np.asarray(wa))
        _bytes_close(gr, np.asarray(wr))
        assert _max_d(gr, rr[0]) <= 1 and _max_d(ga, ra[0]) <= 1
    after = t.step(frames[0]), j.step(frames[0])
    assert after[0] is not None and after[1] is not None
    _bytes_close(after[0][1], np.asarray(after[1][1]))


def test_pipelined_streams_on_four_positions_match_jax(planar):
    """PipelinedStreams(2) on a (2, 2) mesh: convert over 3 rounds against
    the JAX package's on 4 virtual devices, and against the port's
    unmeshed 2-stream instance."""
    cfg, jcfg, v = planar
    rounds = _frames(3, seed=21, s=2)
    t = PipelinedStreams(2, H, W, _mesh(4, (2, 2), ("stream", "pp")),
                         cfg=cfg, variables=v, **KW)
    j = JPipelinedStreams(2, H, W, _jmesh(4, (2, 2), ("stream", "pp")),
                          cfg=jcfg, variables=v, pallas_interpret=True,
                          **KW)
    un = MultiStreamMatting(2, H, W, cfg=cfg, variables=v, device="cpu",
                            **KW)
    got, want = list(t.convert(rounds)), list(j.convert(rounds))
    assert len(got) == len(want) == len(rounds)
    for (ga, gr), (wa, wr), r in zip(got, want, rounds):
        assert gr.shape == (2, H, W, 4)
        _bytes_close(gr, np.asarray(wr))
        _bytes_close(ga, np.asarray(wa))
        assert _max_d(gr, un.step(r)[1]) <= 1


def test_convert_alignment_and_chunking(pp_pair, planar):
    """convert hides the skew: one aligned output per input for clip
    lengths that do and do not divide the chunk (3), chunked equal to
    per-frame dispatch and to a one-stream instance."""
    cfg, _, v = planar
    t, _ = pp_pair
    tk = PipelinedMatting(H, W, _mesh(2), cfg=cfg, variables=v, chunk=3,
                          **KW)
    for n in (5, 6, 2):
        frames = _frames(n, seed=n)
        o1, ok = list(t.convert(frames)), list(tk.convert(frames))
        one = MultiStreamMatting(1, H, W, cfg=cfg, variables=v,
                                 device="cpu", **KW)
        ref = [one.step(f[None]) for f in frames]
        assert len(o1) == len(ok) == n
        for (a1, r1), (ak, rk), (ra, rr) in zip(o1, ok, ref):
            assert _max_d(r1, rk) <= 1 and _max_d(a1, ak) <= 1
            assert _max_d(rk, rr[0]) <= 1


def test_reset_reproduces_outputs(pp_pair):
    t, _ = pp_pair
    frames = _frames(4, seed=7)
    a = list(t.convert(frames))
    b = list(t.convert(frames))
    for (aa, ar), (ba, br) in zip(a, b):
        np.testing.assert_array_equal(ar, br)
        np.testing.assert_array_equal(aa, ba)


@pytest.mark.parametrize("case", ["bg_blur", "trimap", "shared plate"])
def test_variants_match_one_stream(case):
    """Portrait blur (the coarse background rides the handoff), the
    trimap family (4-channel frames; stage 1 composites the RGB) and the
    plate family (a constant of stage 0) against a one-stream instance
    with the same options, float32 at ratio 0.25 on the s2d=2 models."""
    from vidmat_torch.io.fixtures import synthetic_plate_frame

    kw, c, cfg = dict(bg_color=BG), 3, dict(space_to_depth=2,
                                             conv_impl="planar")
    if case == "bg_blur":
        kw = dict(bg_blur=8)
    elif case == "trimap":
        cfg["use_trimap"] = True
        c = 4
    else:
        cfg["use_bg_plate"] = True
        kw["bg_plate"] = synthetic_plate_frame(H, W, 0.0, seed=1)[2]
    cfg = tconfig.ModelConfig(**cfg)
    v = default_variables(cfg)
    kw.update(cfg=cfg, variables=v, dtype="float32", downsample_ratio=0.25)
    frames = _frames(4, seed=5, c=c)
    if c == 4:  # the trimap byte in {0, 128, 255}
        for f in frames:
            f[..., 3] = np.array([0, 128, 255], np.uint8)[
                np.digitize(f[..., 3], [85, 170])]
    pp = PipelinedMatting(H, W, _mesh(2), **kw)
    assert pp.in_c == c
    one = MultiStreamMatting(1, H, W, device="cpu", **kw)
    outs = list(pp.convert(frames))
    assert len(outs) == len(frames)
    for (a, rgba), f in zip(outs, frames):
        ra, rr = one.step(f[None])
        assert _max_d(rgba, rr[0]) <= 1 and _max_d(a, ra[0]) <= 1


def _stage_case(case):
    """(kw of build_serving_body, frames) of a stage-split case."""
    import torch

    g = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (2, H, W, 3), generator=g,
                           dtype=torch.uint8)
    kw = {"color": dict(bg=BG), "bg_blur": dict(bg_blur=8),
          "alpha_only": dict(bg=BG, alpha_only=True),
          "premultiplied": dict()}[case]
    return kw, frames


@pytest.mark.parametrize("case", ["color", "bg_blur", "alpha_only",
                                  "premultiplied"])
def test_stage_composition_equals_the_body(case, planar):
    """fused_stage1(frame, *fused_stage0(frame, state)) is the one-shot
    body: 0 bytes and 0 state values differ, over two frames in bf16 on
    the planar net; the chunk body ends in the same stage 1."""
    import torch

    from vidmat_torch.models.weights import build_network
    from vidmat_torch.pipeline.stepfactory import alpha_byte, \
        build_serving_body

    cfg, _, v = planar
    kw, frames = _stage_case(case)
    net = build_network(cfg, v, dtype=torch.bfloat16, device="cpu")
    body, plan = build_serving_body(net, cfg, tconfig.RefineConfig(), H, W,
                                    0.5, cdtype=torch.bfloat16, **kw)
    assert plan.fused_stage0 is not None and plan.fused_stage1 is not None
    st_b = st_s = plan.make_state(1)
    for i in range(frames.shape[0]):
        f = frames[i:i + 1]
        want, st_b = body(f, st_b)
        grids, st_s = plan.fused_stage0(f, st_s)
        bgv = grids[2] if case == "bg_blur" else kw.get("bg")
        got = plan.fused_stage1(f, grids[0], grids[1], bgv)
        if case == "alpha_only":
            got = alpha_byte(got)
        assert got.dtype == want.dtype and torch.equal(got, want), case
        for x, y in zip(st_b, st_s):
            assert torch.equal(x, y)
    chunk_out, _ = plan.chunk_body(frames, plan.make_state(1))
    st = plan.make_state(1)
    for i in range(frames.shape[0]):
        want, st = body(frames[i:i + 1], st)
        assert torch.equal(chunk_out[i:i + 1], want)


def test_no_stages_off_the_fused_tail(planar):
    """The unfused tails (full resolution, float output) carry no stage
    split, as in the JAX package."""
    import torch

    from vidmat_torch.models.weights import build_network
    from vidmat_torch.pipeline.stepfactory import build_serving_body

    cfg, _, v = planar
    net = build_network(cfg, v, dtype=torch.bfloat16, device="cpu")
    for ratio, kw in ((1.0, dict(bg=BG)), (0.5, dict(float_output=True)),
                      (0.5, dict(need_fgr=True))):
        _, plan = build_serving_body(net, cfg, tconfig.RefineConfig(), H, W,
                                     ratio, **kw)
        assert plan.fused_stage0 is None and plan.fused_stage1 is None


PRECONDITIONS = {
    "4 devices": (lambda m, cls, cfg, extra: cls["PipelinedMatting"](
        64, 64, m(4), cfg=cfg, **extra), "2 devices"),
    "full resolution": (lambda m, cls, cfg, extra: cls["PipelinedMatting"](
        64, 64, m(2), cfg=cfg, downsample_ratio=1.0, **extra), "fused tail"),
    "blur and color": (lambda m, cls, cfg, extra: cls["PipelinedMatting"](
        64, 64, m(2), cfg=cfg, downsample_ratio=0.5, bg_blur=8,
        bg_color=BG, **extra), "mutually exclusive"),
    "num_streams": (lambda m, cls, cfg, extra: cls["PipelinedStreams"](
        3, 64, 64, m(8, (4, 2), ("stream", "pp")), cfg=cfg, **extra),
        "num_streams"),
    "size": (lambda m, cls, cfg, extra: cls["PipelinedMatting"](
        60, 64, m(2), cfg=cfg, **extra), "multiples of 16"),
}


@pytest.mark.parametrize("case", sorted(PRECONDITIONS) + ["chunked step",
                                                          "chunked flush"])
def test_preconditions_raise_as_in_jax(case, planar):
    cfg, jcfg, v = planar
    port = dict(cls={"PipelinedMatting": PipelinedMatting,
                     "PipelinedStreams": PipelinedStreams},
                m=lambda n, shape=None, axes=("pp",): _mesh(n, shape, axes),
                cfg=cfg, extra=dict(variables=v))
    jax_ = dict(cls={"PipelinedMatting": JPipelinedMatting,
                     "PipelinedStreams": JPipelinedStreams},
                m=lambda n, shape=None, axes=("pp",): _jmesh(n, shape, axes),
                cfg=jcfg, extra=dict(variables=v, pallas_interpret=True))
    for side in (port, jax_):
        if case.startswith("chunked"):
            pp = side["cls"]["PipelinedMatting"](
                64, 64, side["m"](2), cfg=side["cfg"], chunk=2,
                **dict(KW, **side["extra"]))
            with pytest.raises(ValueError, match="chunk=1 streaming"):
                if case == "chunked step":
                    pp.step(_frames(1)[0])
                else:
                    pp.flush()
            continue
        build, match = PRECONDITIONS[case]
        with pytest.raises(ValueError, match=match):
            build(side["m"], side["cls"], side["cfg"], side["extra"])


def test_make_mesh_rules_as_in_jax():
    """Shapes as the JAX package's make_mesh gives them, its ValueError on
    a shape that does not cover the devices; repeated devices; no mix of
    CPU and CUDA; no visible card raises; one process needs no job."""
    for axes, shape, n in ((("stream",), None, 4),
                           (("stream", "pp"), None, 4),
                           (("stream", "pp"), (2, 2), 4),
                           (("data", "spatial"), (4, 2), 8)):
        got, want = (make_mesh(axes, shape, devices=["cpu"] * n),
                     jmake_mesh(axes, shape, devices=jax.devices()[:n]))
        assert got.devices.shape == want.devices.shape
        assert tuple(got.shape.items()) == tuple(want.shape.items())
        assert got.axis_names == want.axis_names and got.size == n
    for m in (make_mesh, jmake_mesh):
        devs = ["cpu"] * 4 if m is make_mesh else jax.devices()[:4]
        with pytest.raises(ValueError, match=r"mesh shape \[3, 2\] != 4"):
            m(("stream", "pp"), [3, 2], devices=devs)
    mesh = make_mesh(("pp",), devices=["cpu", "cpu"])
    assert isinstance(mesh, Mesh) and all(
        str(d) == "cpu" for d in mesh.devices.flat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="not both"):
        make_mesh(devices=["cpu", "cuda:0"])
    assert initialize_distributed() is None
    assert initialize_distributed("localhost:1", 1, 0) is None


def test_bench_pp_stages_quick_on_the_cpu(capsys):
    from vidmat_torch.tools import bench_pp_stages

    assert bench_pp_stages.main(["--quick", "--device", "cpu",
                                 "--chunk", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["resolution"] == "256x128" and rec["chunk"] == 2
    assert [r["label"] for r in rec["stages"]] == [
        "composed body (t0+t1)", "stage0: ingest+net+coeffs",
        "stage1: fused refine+composite"]
    assert all(r["ms_per_frame"] > 0 for r in rec["stages"])
    assert "pipelined_fps" not in rec  # the card's measurement only
