"""The ``vidmat_torch::*`` custom ops (``ops/library.py``) on the card:
each op, called through ``torch.ops``, against its plain twin at the main
path's launch shapes (the video_1080p chunk: four 1088x1920 frames at
pool 4), one launch counted on its wrapper per call; and the video_1080p
bundle (``deploy.py``, chunk 4) against the live chunk body. Marked
``cuda``: they skip where no CUDA device is present (the CPU tests hold
the ops' CPU implementations and the bundles to the JAX package). On the
card: ``python -m pytest --noconftest tests/test_torch_cuda_library.py
-m cuda``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _frames(n, seed=0):
    from vidmat_torch.io.fixtures import synthetic_frames_only

    return [np.pad(f, ((0, 8), (0, 0), (0, 0)), mode="edge")
            for f in synthetic_frames_only(1080, 1920, n, seed=seed)]


def _main_path_calls(dev):
    """(net, [(op key, args)]): every planar call of the main path's
    chunk (the encoder on four frames, the decoder on one) through the
    plain twins, with their inputs."""
    import torch.nn.functional as F

    import vidmat_torch.models.planar as pm
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.ops.ingest import ingest_pool_normalize_plain

    mcfg, _ = preset_video_1080p()
    net = build_network(mcfg, default_variables(mcfg), dtype=torch.bfloat16,
                        device=dev)
    x = ingest_pool_normalize_plain(
        torch.from_numpy(np.stack(_frames(4))).to(dev), pool=4)
    xp = F.pad(x.permute(0, 3, 1, 2), (0, 0, 0, 288 - 272),
               mode="replicate").permute(0, 2, 3, 1)
    calls = []
    saved = dict(pm._PLAIN)
    for key, fn in saved.items():
        pm._PLAIN[key] = (lambda k, f: lambda *a: calls.append((k, a)) or
                          f(*a))(key, fn)
    try:
        with torch.inference_mode():
            enc = net.encode(xp, plain=True)
            net.decode(enc.frame(0), net.init_state(1, 288, 480),
                       plain=True)
    finally:
        pm._PLAIN.update(saved)
    return net, x, calls


def _ulps_close(got, want, ulps=1):
    g, w = got.float(), want.float()
    tol = ulps * 2.0 ** -7 * w.abs() + 2.0 ** -10 * float(w.abs().max())
    return int(((g - w).abs() > tol).sum())


def test_planar_ops_match_sequential_twins_at_main_path_sites(dev):
    from vidmat_torch.ops import planar

    _, _, calls = _main_path_calls(dev)
    names = {"conv": "planar_conv", "conv2": "planar_conv2",
             "conv_gru": "planar_conv_gru"}
    plain = {"conv": planar.planar_conv_plain,
             "conv2": planar.planar_conv2_plain,
             "conv_gru": planar.planar_conv_gru_plain}
    seen = set()
    for key, args in calls:
        wrapper = getattr(planar, names[key])
        before = wrapper.launches
        xs, rest = list(args[0]), list(args[1:])
        if key == "conv":
            w, scale, bias, stride, act = rest
            got = torch.ops.vidmat_torch.planar_conv.default(
                xs, w, scale, bias, stride, act,
                planar.pack_conv_weight(w))
        else:
            got = getattr(torch.ops.vidmat_torch, names[key]).default(
                xs, *rest)
        assert wrapper.launches == before + 1
        want = plain[key](xs, *rest, sequential=True)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and g.shape == w_.shape
            assert _ulps_close(g, w_) == 0, key
        seen.add(key)
    assert seen == set(names)


def test_tail_ops_match_plain_at_main_path_shapes(dev):
    from vidmat_torch.ops import gf, ingest, refine
    from vidmat_torch.ops.guided_filter import gray_guide

    ops = torch.ops.vidmat_torch
    frames = torch.from_numpy(np.stack(_frames(4, seed=1))).to(dev)
    before = ingest.ingest_pool_normalize.launches
    x = ops.ingest_pool_normalize.default(frames, 4, [1 / 255.0] * 3,
                                          [0.0] * 3, torch.bfloat16)
    assert ingest.ingest_pool_normalize.launches == before + 1
    assert torch.equal(x, ingest.ingest_pool_normalize_plain(frames, 4))
    g = torch.Generator().manual_seed(2)
    guide = gray_guide(x.float()).contiguous()
    p = torch.rand((4, 272, 480, 4), generator=g).to(dev)
    ma, mb = ops.guided_filter_coeffs.default(guide, p, 4, 1e-4)
    wa, wb = gf.guided_filter_coeffs_plain(guide, p, 4, 1e-4)
    assert torch.equal(ma, wa) and torch.equal(mb, wb)
    for bg, color in ((None, [0.0, 1.0, 0.0]), (None, None)):
        before = refine.fused_refine_composite.launches
        got = ops.fused_refine_composite.default(frames, ma, mb, bg, color,
                                                 4).view(torch.uint32)
        assert refine.fused_refine_composite.launches == before + 1
        want = refine.fused_refine_composite_plain(frames, ma, mb, color, 4)
        d = (got.view(torch.uint8).int() - want.view(torch.uint8).int())
        assert int(d.abs().max()) <= 1
    alpha, fgr = ops.fused_refine_float.default(frames[:1], ma[:1], mb[:1],
                                                4)
    pa, pf = refine.fused_refine_float_plain(frames[:1], ma[:1], mb[:1], 4)
    assert float((alpha - pa).abs().max()) <= 1e-5
    assert float((fgr - pf).abs().max()) <= 1e-5


def test_bundle_equals_live_chunk_body_on_the_card(dev, tmp_path):
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.deploy import (ServingBundle, chunk_step,
                                     export_bundle, serving_body)
    from vidmat_torch.ops import library

    mcfg, pcfg = preset_video_1080p()
    path = str(tmp_path / "b")
    export_bundle(path, 1088, 1920, model_cfg=mcfg, pipe_cfg=pcfg,
                  device=dev)
    ops = library.program_ops(torch.export.load(
        f"{path}/chunk.pt2").graph_module)
    assert set(library.MAIN_PATH) <= set(ops), ops
    assert "aten.convolution" not in ops
    frames = _frames(9, seed=3)
    got = []
    ServingBundle(path, device=dev).convert(frames, output_alpha=got.append)
    body, plan, _, _ = serving_body(1088, 1920, model_cfg=mcfg,
                                    pipe_cfg=pcfg, device=dev)
    chunk = chunk_step(body, plan)
    state = plan.make_state(1)
    want = []
    x = torch.from_numpy(np.stack(frames)).to(dev)
    for c in range(0, 8, 4):
        out, state = chunk(x[c:c + 4, None], state)
        want += [o[0].view(torch.uint8).reshape(1088, 1920, 4)[..., 3]
                 .cpu().numpy() for o in out]
    out, state = body(x[8:9], state)
    want.append(out[0].view(torch.uint8).reshape(1088, 1920, 4)[..., 3]
                .cpu().numpy())
    assert len(got) == len(want) == 9
    assert sum(int(np.sum(g != w)) for g, w in zip(got, want)) == 0
