"""The port's planar serving body and its chunk-batched dispatch against
the JAX package on the CPU.

The JAX body runs on ``conv_impl="planar"`` with its Pallas kernels in
interpret mode (``ServingPlan.chunk_body``: ingest and encoder batched
over the chunk, the decoder scanned); the port runs the plain PyTorch
versions of its kernels. fast_demo, fp32, 128x192 at ratio 0.25, two
4-frame chunks. Bound as tests/test_torch_serving.py: packed bytes mean
|d| <= 0.26 LSB and max <= 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_clip, synthetic_frames_only
from vidmat_torch.models.planar import PlanarState
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.pipeline.stepfactory import build_serving_body

H, W, K = 128, 192, 4
CFG = ModelConfig(space_to_depth=2, conv_impl="planar")


def _frames(n, seed):
    return np.stack([f for f, _ in synthetic_clip(H, W, n, seed=seed)])


def _port_body():
    net = build_network(CFG, default_variables(CFG))
    return build_serving_body(net, CFG, RefineConfig("guided"), H, W, 0.25,
                              cdtype=torch.float32)


def test_chunk_body_matches_jax():
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(space_to_depth=2, conv_impl="planar")
    _, jplan = j_build(JNet(jcfg), jcfg, JRefineConfig("guided"), H, W, 0.25,
                       cdtype=jnp.float32, use_pallas=True,
                       pallas_interpret=True)
    assert jplan.chunk_body is not None
    jchunk = jax.jit(jplan.chunk_body)
    jvars = jax.tree_util.tree_map(jnp.asarray, default_variables(CFG))
    _, plan = _port_body()
    assert plan.chunk_body is not None
    assert (plan.pool, plan.state_h, plan.state_w) == (
        jplan.pool, jplan.state_h, jplan.state_w)
    frames = _frames(2 * K, seed=3)
    js, ts = jplan.make_state(1), plan.make_state(1)
    assert isinstance(ts, PlanarState)
    diffs = []
    for c in range(2):
        chunk = frames[c * K:(c + 1) * K]
        jo, js = jchunk(jvars, jnp.asarray(chunk[:, None]), js)
        to, ts = plan.chunk_body(torch.from_numpy(chunk), ts)
        assert to.dtype == torch.uint32 and to.shape == (K, H, W)
        a = np.asarray(jo)[:, 0].view(np.uint8).astype(int)
        diffs.append(np.abs(a - to.numpy().view(np.uint8).astype(int)))
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_chunk_body_equals_per_frame_body():
    body, plan = _port_body()
    frames = _frames(K, seed=4)
    s1, s2 = plan.make_state(1), plan.make_state(1)
    chunk_out, s1 = plan.chunk_body(torch.from_numpy(frames), s1)
    outs = []
    for i in range(K):
        o, s2 = body(torch.from_numpy(frames[i:i + 1]), s2)
        outs.append(o)
    d = (chunk_out.view(torch.uint8).int()
         - torch.cat(outs).view(torch.uint8).int()).abs()
    # The batched encoder may sum in another order than batch 1 on the
    # CPU; bytes agree to one LSB.
    assert int(d.max()) <= 1, int(d.max())
    for a, b in zip(s1, s2):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_convert_video_planar_chunks_and_drain():
    """convert_video on the planar preset: 6 frames at chunk 4 are one
    chunk-batched call and two drained frames; the alpha stream equals the
    per-frame loop's (chunk 1)."""
    from vidmat_torch import convert_video

    frames = list(synthetic_frames_only(120, 180, 6, seed=1))
    got = {}
    for k in (1, 4):
        alphas = []
        pipe = PipelineConfig(downsample_ratio=0.25, chunk_size=k,
                              dtype="float32")
        m = convert_video(frames, output_alpha=alphas.append, model_cfg=CFG,
                          pipe_cfg=pipe, device="cpu")
        assert m["frames"] == 6 and len(alphas) == 6
        got[k] = np.stack(alphas)
    d = np.abs(got[1].astype(int) - got[4].astype(int))
    assert d.max() <= 1, d.max()
