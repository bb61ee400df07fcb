"""The planar decoder's stage-steps and the chunk body's wavefront on the
CPU (``PlanarNetwork.decode_stage`` / ``decode_head``,
``pipeline/wavefront.py``): the stage-steps composed are ``decode``, and
off the card the chunk body runs them in order on the current stream
(no side stream, ``overlapped_steps`` 0) with the per-frame loop's bytes.
The card's wavefront is held to the per-frame chain in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_clip
from vidmat_torch.models.planar import PlanarNetwork, PlanarState
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.pipeline.stepfactory import build_serving_body
from vidmat_torch.pipeline.wavefront import decode_frames

H, W = 64, 96
CFG = ModelConfig(space_to_depth=2, conv_impl="planar")


def _frames(n, seed):
    return np.stack([f for f, _ in synthetic_clip(H, W, n, seed=seed)])


def _net(dtype, fuse_pairs=True):
    net = build_network(CFG, default_variables(CFG), dtype=dtype)
    assert isinstance(net, PlanarNetwork)
    net.fuse_pairs = fuse_pairs
    return net


def _encode(net, frames):
    x = torch.from_numpy(frames).float() / 255.0
    return net.encode(x, plain=True)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,fuse_pairs", [
    (torch.bfloat16, True), (torch.float32, True), (torch.float32, False)])
def test_stage_steps_composed_equal_decode(dtype, fuse_pairs):
    """d3, d2, d1 and the head called one after another equal decode's
    alpha, fgr and each hidden map byte for byte, over 3 frames from a cold
    state."""
    net = _net(dtype, fuse_pairs)
    enc = _encode(net, _frames(3, seed=5))
    want_state = got_state = None
    for i in range(3):
        e = enc.frame(i)
        alpha, fgr, want_state = net.decode(e, want_state, plain=True)
        hs = [None] * 3 if got_state is None else list(got_state)
        xs = [e.b4]
        for j in range(3):
            xs, hs[j] = net.decode_stage(j, e, xs, hs[j], plain=True)
        a, f = net.decode_head(e, xs, plain=True)
        got_state = PlanarState(*hs)
        _equal(a, alpha)
        _equal(f, fgr)
        for g, w in zip(got_state, want_state):
            _equal(g, w)


def test_decode_frames_off_the_card_is_the_per_frame_loop():
    """decode_frames on the CPU issues nothing on a side stream and gives
    the per-frame decode loop's bytes and state."""
    net = _net(torch.bfloat16)
    enc = _encode(net, _frames(4, seed=6))
    st = net.init_state(1, H, W)
    alphas, fgrs, got, overlapped = decode_frames(net, enc, st, plain=True)
    assert overlapped == 0 and len(alphas) == len(fgrs) == 4
    want = st
    for i in range(4):
        alpha, fgr, want = net.decode(enc.frame(i), want, plain=True)
        _equal(alphas[i], alpha)
        _equal(fgrs[i], fgr)
    for g, w in zip(got, want):
        _equal(g, w)


def _per_frame_loop(net, enc, state, plain=False):
    """The chunk body's decoder before the wavefront: net.decode a frame."""
    alphas, fgrs = [], []
    for i in range(enc.b4.shape[0]):
        alpha, fgr, state = net.decode(enc.frame(i), state, plain=plain)
        alphas.append(alpha)
        fgrs.append(fgr)
    return alphas, fgrs, state, 0


@pytest.mark.parametrize("cdtype", [torch.bfloat16, torch.float32])
def test_chunk_body_on_cpu_counts_no_overlap(cdtype, monkeypatch):
    """The chunk body on the CPU leaves ``overlapped_steps`` at 0 (on the
    float32 wrapper too) and gives, over two chunks, the bytes and state of
    the same body with the per-frame decode loop."""
    from vidmat_torch.pipeline import stepfactory

    net = _net(cdtype)
    _, plan = build_serving_body(net, CFG, RefineConfig("guided"), H, W, 0.5,
                                 cdtype=cdtype)
    assert plan.chunk_body.overlapped_steps == 0
    frames = torch.from_numpy(_frames(8, seed=7))
    runs = []
    for decoder in (decode_frames, _per_frame_loop):
        monkeypatch.setattr(stepfactory, "decode_frames", decoder)
        st, outs = plan.make_state(1), []
        for c in range(2):
            out, st = plan.chunk_body(frames[c * 4:(c + 1) * 4], st)
            outs.append(out)
        runs.append((outs, st))
    assert plan.chunk_body.overlapped_steps == 0
    (got, got_st), (want, want_st) = runs
    for g, w in zip(got, want):
        _equal(g, w)
    for g, w in zip(got_st, want_st):
        _equal(g, w)
