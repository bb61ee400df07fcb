"""The port's serving body and convert_video against the JAX package on
the CPU.

The JAX body runs with its Pallas kernels in interpret mode on the
``conv_impl="xla"`` net; the port runs the plain PyTorch versions of its
kernels (CPU tensors). Bounds over an 8-frame fp32 rollout on fast_demo:
packed bytes mean |d| <= 0.26 LSB (1e-3 * 255) and max <= 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig, RefineConfig
from vidmat_torch.io.fixtures import synthetic_clip, synthetic_frames_only
from vidmat_torch.models.weights import build_network, default_variables
from vidmat_torch.pipeline.stepfactory import build_serving_body

H, W = 128, 192
CFG = ModelConfig(space_to_depth=2)


def _bodies(bg=None, alpha_only=False):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    jcfg = JModelConfig(space_to_depth=2)
    jbody, jplan = j_build(
        JNet(jcfg), jcfg, JRefineConfig("guided"), H, W, 0.25,
        cdtype=jnp.float32, use_pallas=True, pallas_interpret=True,
        bg=None if bg is None else jnp.asarray(bg, jnp.float32),
        alpha_only=alpha_only)
    variables = default_variables(CFG)
    net = build_network(CFG, variables)
    body, plan = build_serving_body(net, CFG, RefineConfig("guided"), H, W,
                                    0.25, cdtype=torch.float32, bg=bg,
                                    alpha_only=alpha_only)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return (jax.jit(jbody), jplan, jvars), (body, plan)


@pytest.mark.parametrize("bg", [None, (0.0, 1.0, 0.0)])
def test_serving_body_matches_jax(bg):
    (jstep, jplan, jvars), (body, plan) = _bodies(bg)
    assert (plan.pool, plan.net_h, plan.net_w, plan.state_h,
            plan.state_w) == (jplan.pool, jplan.net_h, jplan.net_w,
                              jplan.state_h, jplan.state_w)
    assert jplan.packed and jplan.chunk_body is None
    js, ts = jplan.make_state(1), plan.make_state(1)
    diffs = []
    for f, _ in synthetic_clip(H, W, 8, seed=3):
        jo, js = jstep(jvars, jnp.asarray(f[None]), js)
        to, ts = body(torch.from_numpy(f[None]), ts)
        assert to.dtype == torch.uint32 and to.shape == (1, H, W)
        a = np.asarray(jo).view(np.uint8).astype(int)
        b = to.numpy().view(np.uint8).astype(int)
        diffs.append(np.abs(a - b))
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_alpha_only_body_matches_jax():
    (jstep, jplan, jvars), (body, plan) = _bodies(alpha_only=True)
    assert plan.alpha_only and jplan.alpha_only
    js, ts = jplan.make_state(1), plan.make_state(1)
    diffs = []
    for f, _ in synthetic_clip(H, W, 4, seed=5):
        jo, js = jstep(jvars, jnp.asarray(f[None]), js)
        to, ts = body(torch.from_numpy(f[None]), ts)
        assert to.dtype == torch.uint8 and to.shape == (1, H, W)
        diffs.append(np.abs(np.asarray(jo).astype(int)
                            - to.numpy().astype(int)))
    d = np.stack(diffs)
    assert d.mean() <= 0.26 and d.max() <= 2, (d.mean(), d.max())


def test_unported_branches_raise():
    """Error-map refinement (A.11), which raised here, is ported: the body
    builds in errormap mode (with a refiner, and with none: the bilinear
    tail) and convert_video takes refiner_variables. Tiling (A.8), the
    earlier second case, is ported: tests/test_torch_tiling.py."""
    from vidmat_torch import convert_video
    from vidmat_torch.models.weights import (build_refiner,
                                             default_refiner_variables)

    net = build_network(CFG, default_variables(CFG))
    frames = list(synthetic_frames_only(64, 64, 1, seed=1))
    f = torch.from_numpy(frames[0][None])
    none_body, plan = build_serving_body(net, CFG, RefineConfig("errormap"),
                                         64, 64, 0.25)
    bilinear, _ = build_serving_body(net, CFG, RefineConfig("none"), 64, 64,
                                     0.25)
    assert plan.chunk_body is None and plan.packed
    assert torch.equal(none_body(f, plan.make_state(1))[0],
                       bilinear(f, plan.make_state(1))[0])
    refined, _ = build_serving_body(
        net, CFG, RefineConfig("errormap"), 64, 64, 0.25,
        refiner=build_refiner(default_refiner_variables(), 4, 16))
    out, _ = refined(f, plan.make_state(1))
    assert out.shape == (1, 64, 64) and out.dtype == torch.uint32
    m = convert_video(frames, refiner_variables=default_refiner_variables(),
                      pipe_cfg=PipelineConfig(
                          downsample_ratio=0.25,
                          refine=RefineConfig("errormap", errormap_patches=4)),
                      model_cfg=CFG, device="cpu")
    assert m["frames"] == 1


def test_convert_video_cpu_smoke():
    from vidmat_torch import convert_video, preset_video_1080p

    mcfg, pcfg = preset_video_1080p()
    frames = list(synthetic_frames_only(120, 180, 6, seed=1))
    alphas = []
    comps = []
    pipe = PipelineConfig(downsample_ratio=0.25, chunk_size=4,
                          dtype="float32")
    m = convert_video(frames, output_alpha=alphas.append, model_cfg=mcfg,
                      pipe_cfg=pipe, device="cpu")
    assert m["frames"] == 6 and len(alphas) == 6
    for k in ("fps", "p50_ms", "p99_ms", "wall_s", "latency_granularity",
              "device"):
        assert k in m, k
    assert alphas[0].shape == (120, 180) and alphas[0].dtype == np.uint8
    m = convert_video(frames, output_composition=comps.append,
                      model_cfg=mcfg, pipe_cfg=pipe, device="cpu",
                      max_frames=3)
    assert m["frames"] == 3 and comps[0].shape == (120, 180, 4)
    # The composite's alpha channel is the alpha-only output.
    np.testing.assert_array_equal(comps[0][..., 3], alphas[0])
    # benchmark mode, bf16 preset
    m = convert_video(frames, model_cfg=mcfg, pipe_cfg=pcfg, device="cpu")
    assert m["frames"] == 6 and m["fps"] > 0


def test_convert_video_file_round_trip(tmp_path):
    """Video-file input and output through cv2 (where installed)."""
    cv2 = pytest.importorskip("cv2")
    from vidmat_torch import convert_video, preset_video_1080p
    from vidmat_torch.io.writer import VideoWriter

    src = str(tmp_path / "in.mp4")
    w = VideoWriter(src)
    for f in synthetic_frames_only(64, 128, 5, seed=2):
        w.write(f)
    w.close()
    out = str(tmp_path / "alpha.mp4")
    pipe = PipelineConfig(downsample_ratio=0.25, dtype="float32")
    m = convert_video(src, output_alpha=out,
                      model_cfg=preset_video_1080p()[0], pipe_cfg=pipe,
                      device="cpu")
    assert m["frames"] == 5
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 5
