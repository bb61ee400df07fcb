"""AOT serving bundles of the port (``vidmat_torch.deploy``) on the CPU:
export -> load -> serve.

Each bundle variant is exported on the CPU (its kernels are the
``vidmat_torch::*`` ops, whose CPU implementations are the plain twins)
and held two ways over a 5-frame rollout:

- against the port's live serving body built from the same arguments
  (``deploy.serving_body``): 0 bytes unequal (the chunk variant through
  ``convert``, its last frame drained through the step program);
- against the JAX package's live body on the same weights (the shipped
  checkpoints, which ``tests/test_torch_weights.py`` holds equal to the
  JAX ones), its Pallas kernels in interpret mode on the ``xla`` net:
  within the JAX serving bar, worst-frame mean |d| <= 0.5 LSB and max
  |d| <= 2 (the segmentation probability compared as round(p * 255)).

The bundles run in float32 (the JAX comparison's dtype; the card's
bf16 bundles are held to their live bodies by ``chip_smoke.py`` phase
D). The JAX package's defaults and the contract cases run at 48x64 as in
tests/integration/test_deploy.py; the preset variants at 64x128, where
``video_1080p``'s ratio 0.25 gives an integer pool (at 48x64 it gives
none, and the fused tails, the chunk body and static skip would not be
exported).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig, PipelineConfig
from vidmat_torch.deploy import (ServingBundle, chunk_step, export_bundle,
                                 serving_body)
from vidmat_torch.io.fixtures import synthetic_clip, synthetic_plate_clip
from vidmat_torch.ops import library
from vidmat_torch.pipeline.trimap import alpha_to_trimap, canon_trimap_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64           # the JAX package's bundle tests
PH, PW = 64, 128        # the presets' integer pool
N = 5                   # frames; odd, so a chunk of 2 drains one frame
PLANAR = ModelConfig(space_to_depth=2, conv_impl="planar")
PIPE = PipelineConfig(downsample_ratio=0.25, dtype="float32")
SKIP_EPS = 0.5 / 255

#: variant -> (height, width, export_bundle keyword arguments)
VARIANTS = {
    "default": (H, W, dict(pipe_cfg=PipelineConfig(dtype="float32"))),
    "chunk2": (PH, PW, dict(model_cfg=PLANAR, pipe_cfg=dataclasses.replace(
        PIPE, chunk_size=2))),
    "bg_blur": (PH, PW, dict(model_cfg=PLANAR, pipe_cfg=PIPE, bg_blur=16)),
    "trimap": (PH, PW, dict(model_cfg=dataclasses.replace(
        PLANAR, use_trimap=True), pipe_cfg=PIPE)),
    "streams2": (PH, PW, dict(model_cfg=PLANAR, pipe_cfg=PIPE,
                              num_streams=2)),
    "seg": (PH, PW, dict(pipe_cfg=PIPE, output="seg")),
    "plate": (PH, PW, dict(model_cfg=dataclasses.replace(
        PLANAR, use_bg_plate=True), pipe_cfg=PIPE, bg_plate="plate")),
    "alpha_only": (PH, PW, dict(model_cfg=PLANAR, pipe_cfg=PIPE,
                                alpha_only=True)),
    "need_fgr": (PH, PW, dict(model_cfg=PLANAR, pipe_cfg=PIPE,
                              need_fgr=True)),
    "static_skip": (PH, PW, dict(model_cfg=PLANAR,
                                 pipe_cfg=dataclasses.replace(
                                     PIPE, static_skip_eps=SKIP_EPS))),
}


def _kwargs(name):
    h, w, kw = VARIANTS[name]
    kw = dict(kw)
    if kw.get("bg_plate") == "plate":
        kw["bg_plate"] = next(synthetic_plate_clip(h, w, 1, seed=4))[2]
    return h, w, kw


def _inputs(name):
    """N frames (rounds of 2 streams for streams2) and their trimaps (the
    trimap variant), made from seeds."""
    h, w, _ = VARIANTS[name]
    if name == "plate":
        clip = [(f, a) for f, a, _ in synthetic_plate_clip(h, w, N, seed=4)]
    else:
        clip = list(synthetic_clip(h, w, N, seed=3))
    frames = [f for f, _ in clip]
    if name == "static_skip":  # two static stretches
        frames = [frames[0], frames[0], frames[2], frames[2], frames[4]]
    if name == "streams2":
        other = [f for f, _ in synthetic_clip(h, w, N, seed=9)]
        frames = [np.stack([a, b]) for a, b in zip(frames, other)]
    tris = ([alpha_to_trimap(a[..., 0]) for _, a in clip]
            if name == "trimap" else [None] * N)
    return frames, tris


_BUNDLES = {}


def _bundle(name, tmp_path_factory):
    """The variant's bundle directory, exported once per session."""
    if name not in _BUNDLES:
        h, w, kw = _kwargs(name)
        path = str(tmp_path_factory.mktemp("bundles") / name)
        export_bundle(path, h, w, device="cpu", **kw)
        _BUNDLES[name] = path
    return _BUNDLES[name]


def _bundle_outputs(name, path):
    """Per-frame output dicts of the bundle: ``convert`` for the chunk
    variant, ``step`` otherwise."""
    bundle = ServingBundle(path, device="cpu")
    frames, tris = _inputs(name)
    if name == "chunk2":
        got = {"alpha": [], "comp": []}
        metrics = bundle.convert(frames, output_alpha=got["alpha"].append,
                                 output_composition=got["comp"].append)
        assert metrics["frames"] == N
        return [{k: v[i] for k, v in got.items()} for i in range(N)]
    return [bundle.step(f, t) for f, t in zip(frames, tris)]


def _live_outputs(name, path):
    """Per-frame output dicts of the port's live body built from the same
    arguments (unpacked by the bundle's own ``_unpack``)."""
    h, w, kw = _kwargs(name)
    body, plan, _, _ = serving_body(h, w, device="cpu", **kw)
    bundle = ServingBundle(path, device="cpu")
    s = kw.get("num_streams", 1)
    state = plan.make_state(s)
    frames, tris = _inputs(name)
    batch = []
    for f, t in zip(frames, tris):
        x = f if s > 1 else f[None]
        if t is not None:
            tri = canon_trimap_u8(t, (h, w))[None, ..., None]
            x = np.concatenate([x, tri], axis=-1)
        batch.append(x)
    outs = []
    if name == "chunk2":
        chunk = chunk_step(body, plan)
        for c in range(0, N - 1, 2):
            out, state = chunk(torch.from_numpy(np.stack(batch[c:c + 2])),
                               state)
            outs += [bundle._unpack(out[i]) for i in range(2)]
        batch = batch[N - 1:]
    for x in batch:
        out, state = body(torch.from_numpy(x), state)
        outs.append(bundle._unpack(out))
    if s == 1:
        outs = [{k: v[0] for k, v in d.items()} for d in outs]
    return outs


def _jax_outputs(name):
    """Per-frame output dicts of the JAX package's live body on the same
    weights: the xla net, the Pallas kernels in interpret mode, float32."""
    import jax
    import jax.numpy as jnp

    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.config import RefineConfig as JRefineConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.pipeline.stepfactory import build_serving_body as j_build

    from vidmat_torch.models.weights import (default_variables,
                                             seg_default_variables)

    h, w, kw = _kwargs(name)
    mcfg = kw.get("model_cfg") or ModelConfig()
    pcfg = kw["pipe_cfg"]
    fields = dataclasses.asdict(mcfg)
    fields.update(conv_impl="xla", enc_channels=tuple(fields["enc_channels"]),
                  dec_channels=tuple(fields["dec_channels"]))
    jcfg = JModelConfig(**fields)
    seg = kw.get("output") == "seg"
    variables = (seg_default_variables(mcfg) if seg
                 else default_variables(mcfg))
    ratio = pcfg.downsample_ratio or 1.0
    plate = kw.get("bg_plate")
    jbody, jplan = j_build(
        JNet(jcfg), jcfg, JRefineConfig("guided"), h, w, ratio,
        cdtype=jnp.float32, use_pallas=True, pallas_interpret=True,
        bg=None if kw.get("bg_blur") else jnp.asarray((0.0, 1.0, 0.0),
                                                      jnp.float32),
        need_fgr=kw.get("need_fgr", False),
        alpha_only=kw.get("alpha_only", False),
        static_skip_eps=pcfg.static_skip_eps, bg_blur=kw.get("bg_blur"),
        bg_plate=None if plate is None else jnp.asarray(plate[None]),
        output_seg=seg)
    jstep = jax.jit(jbody)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    s = kw.get("num_streams", 1)
    state = jplan.make_state(s)
    frames, tris = _inputs(name)
    outs = []
    for f, t in zip(frames, tris):
        x = f if s > 1 else f[None]
        if t is not None:
            tri = canon_trimap_u8(t, (h, w))[None, ..., None]
            x = np.concatenate([x, tri], axis=-1)
        out, state = jstep(jvars, jnp.asarray(x), state)
        if seg:
            d = {"seg": np.asarray(out)[:, :, :, 0]}
        elif jplan.alpha_only:
            d = {"alpha": np.asarray(out)}
        elif jplan.packed:
            rgba = np.asarray(out).view(np.uint8).reshape(*out.shape, 4)
            d = {"alpha": rgba[..., 3], "comp": rgba}
        else:
            a8, f8, rgba = (np.asarray(o) for o in out)
            d = {"alpha": a8[..., 0], "fgr": f8, "comp": rgba}
        outs.append({k: v[0] for k, v in d.items()} if s == 1 else d)
    return outs


def _bytes(d, key):
    v = d[key]
    return (np.round(v * 255.0) if key == "seg" else v).astype(int)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_bundle_equals_live_body(name, tmp_path_factory):
    path = _bundle(name, tmp_path_factory)
    got = _bundle_outputs(name, path)
    want = _live_outputs(name, path)
    assert len(got) == len(want) == N
    for i, (g, w_) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w_)
        for key in g:
            assert g[key].dtype == w_[key].dtype, key
            unequal = int(np.sum(g[key] != w_[key]))
            assert unequal == 0, (name, i, key, unequal)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_bundle_within_jax_serving_bar(name, tmp_path_factory):
    path = _bundle(name, tmp_path_factory)
    got = _bundle_outputs(name, path)
    want = _jax_outputs(name)
    worst_mean = worst_max = 0.0
    for g, w_ in zip(got, want):
        assert sorted(g) == sorted(w_)
        for key in g:
            d = np.abs(_bytes(g, key) - _bytes(w_, key))
            worst_mean = max(worst_mean, float(d.mean()))
            worst_max = max(worst_max, float(d.max()))
    assert worst_mean <= 0.5 and worst_max <= 2, (name, worst_mean,
                                                  worst_max)


def test_main_path_ops_are_nodes_of_the_programs(tmp_path_factory):
    """The chunk program of the planar preset holds the six main-path
    kernels as vidmat_torch:: nodes (the decoder stages once per frame)
    and no convolution; the static-skip step holds them inside its
    torch.cond."""
    path = _bundle("chunk2", tmp_path_factory)
    ops = library.program_ops(
        torch.export.load(os.path.join(path, "chunk.pt2")).graph_module)
    assert set(library.MAIN_PATH) <= set(ops), ops
    assert "aten.convolution" not in ops, ops
    assert ops["planar_conv_gru"] == 2 * 3 and ops["ingest_pool_normalize"] \
        == 1 and ops["fused_refine_composite"] == 1, ops
    path = _bundle("static_skip", tmp_path_factory)
    ops = library.program_ops(
        torch.export.load(os.path.join(path, "step.pt2")).graph_module)
    assert set(library.MAIN_PATH) <= set(ops), ops


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_programs_hold_no_uint32(name, tmp_path_factory):
    """No value of a program is uint32 (the packed words are int32 there):
    the program serializer of PyTorch 2.11, the card machine's, has no
    uint32."""
    path = _bundle(name, tmp_path_factory)
    for prog in ("step", "chunk"):
        f = os.path.join(path, f"{prog}.pt2")
        if not os.path.exists(f):
            continue
        gm = torch.export.load(f).graph_module
        for mod in gm.modules():
            if isinstance(mod, torch.fx.GraphModule):
                for node in mod.graph.nodes:
                    val = node.meta.get("val")
                    for v in (val if isinstance(val, (tuple, list))
                              else (val,)):
                        assert getattr(v, "dtype", None) != torch.uint32, (
                            name, prog, node.name)


def test_bundle_reset_restores_initial_state(tmp_path_factory):
    bundle = ServingBundle(_bundle("default", tmp_path_factory),
                           device="cpu")
    frames, _ = _inputs("default")
    first = bundle.step(frames[0])["comp"].copy()
    for f in frames[1:]:
        bundle.step(f)
    assert not np.array_equal(first, bundle.step(frames[0])["comp"])
    bundle.reset()
    np.testing.assert_array_equal(first, bundle.step(frames[0])["comp"])


def test_bundle_platform_pinning(tmp_path_factory, tmp_path):
    tampered = str(tmp_path / "tampered")
    shutil.copytree(_bundle("default", tmp_path_factory), tampered)
    mpath = os.path.join(tampered, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    assert manifest["platforms"] == ["cpu"]
    manifest["platforms"] = ["cuda"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RuntimeError, match="platform"):
        ServingBundle(tampered, device="cpu")


def test_bundle_rejects_wrong_shape(tmp_path_factory):
    bundle = ServingBundle(_bundle("default", tmp_path_factory),
                           device="cpu")
    with pytest.raises(ValueError, match="serves"):
        bundle.step(np.zeros((H + 16, W, 3), np.uint8))


def test_export_refuses_random_weights(tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        export_bundle(str(tmp_path / "b"), H, W,
                      model_cfg=ModelConfig(enc_channels=(8, 8, 8, 8),
                                            dec_channels=(8, 8, 8, 8)),
                      device="cpu")


def test_convert_refuses_what_the_bundle_cannot_write(tmp_path_factory):
    frames = _inputs("default")[0]
    seg = ServingBundle(_bundle("seg", tmp_path_factory), device="cpu")
    with pytest.raises(ValueError, match="seg bundles"):
        seg.convert(frames, output_alpha=lambda a: None)
    multi = ServingBundle(_bundle("streams2", tmp_path_factory),
                          device="cpu")
    with pytest.raises(ValueError, match="single-stream"):
        multi.convert(frames, output_alpha=lambda a: None)
    alpha = ServingBundle(_bundle("alpha_only", tmp_path_factory),
                          device="cpu")
    with pytest.raises(ValueError, match="alpha-only"):
        alpha.convert(frames, output_composition=lambda a: None)


LOADER_ONLY = """
import sys
import numpy as np
from vidmat_torch.deploy import ServingBundle
b = ServingBundle(sys.argv[1], device="cpu")
out = b.step(np.zeros((64, 128, 3), np.uint8))
assert out["alpha"].shape == (64, 128), out["alpha"].shape
bad = sorted(m for m in sys.modules
             if m.startswith(("vidmat_torch.models", "jax", "vidmat."))
             or m in ("vidmat", "vidmat_torch.pipeline.stepfactory"))
print("BAD", bad)
assert not bad, bad
"""


def test_loader_imports_no_model_definition(tmp_path_factory):
    path = _bundle("static_skip", tmp_path_factory)
    res = subprocess.run([sys.executable, "-c", LOADER_ONLY, path],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout
