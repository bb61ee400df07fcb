"""The port's public surface against the JAX package's, name for name
(ROADMAP C.4, C.6): every parameter of ``convert_video``,
``matte_image``, ``MattingSession.__init__`` and ``.step``,
``MultiStreamMatting.__init__``, ``.step`` and ``.serve``,
``RealtimeMatting.__init__`` and ``.run``, ``deploy.export_bundle``,
``deploy.ServingBundle.__init__``, ``.step``, ``.reset`` and
``.convert``, ``eval.VideoEval.__init__``, ``.update`` and ``.summary``
and ``eval.evaluate_sequences``, the training entry points and A.16's
functions (``make_chunk_step``'s ``cdtype`` compared by dtype name),
every field of the configuration dataclasses with its default, every
preset, each returning equal dataclasses, and the package's seven lazy
exports; error-map refinement
(A.11) runs as in the JAX package, and a ``StreamConfig`` is served by
``MultiStreamMatting``."""

import dataclasses
import inspect

import numpy as np
import pytest

import vidmat
import vidmat.config as jconfig
import vidmat_torch
import vidmat_torch.config as tconfig

ENTRY_POINTS = [("convert_video", None), ("matte_image", None),
                ("MattingSession", "__init__"), ("MattingSession", "step"),
                ("MultiStreamMatting", "__init__"),
                ("MultiStreamMatting", "step"),
                ("MultiStreamMatting", "serve"),
                ("RealtimeMatting", "__init__"), ("RealtimeMatting", "run"),
                ("deploy.export_bundle", None),
                ("deploy.ServingBundle", "__init__"),
                ("deploy.ServingBundle", "step"),
                ("deploy.ServingBundle", "reset"),
                ("deploy.ServingBundle", "convert"),
                ("eval.VideoEval", "__init__"), ("eval.VideoEval", "update"),
                ("eval.VideoEval", "summary"),
                ("eval.evaluate_sequences", None),
                # training (A.15; its mesh=, sharded training, A.12)
                ("train.loop.make_train_step", None),
                ("train.loop.make_seg_train_step", None),
                ("train.loop.train_on_clips", None),
                ("train.loop.make_optimizer", None),
                ("train.losses.matting_loss", None),
                ("train.losses.segmentation_loss", None),
                ("train.losses.laplacian_pyramid_loss", None),
                ("train.refine.make_refiner_train_step", None),
                ("train.refine.train_refiner", None),
                ("train.dataset.ClipDirDataset", "__init__"),
                ("train.dataset.with_trimaps", None),
                ("train.dataset.as_seg_batches", None),
                ("models.weights.init_params", None),
                ("models.weights.graft_seg_params", None),
                ("models.weights.graft_cond_params", None),
                ("models.weights.randomize_bn_stats", None),
                # A.16
                ("ops.guided_filter.guided_filter", None),
                ("utils.metrics.sad", None),
                ("models.weights.graft_trimap_params", None),
                ("models.weights.flax_to_torch_state", None),
                ("models.weights.torch_to_flax_variables", None),
                ("models.weights.load_into_torch", None),
                ("models.weights.load_checkpoint", None),
                ("pipeline.scan.make_chunk_step", None),
                # A.12 over several devices
                ("parallel.mesh.make_mesh", None),
                ("parallel.mesh.initialize_distributed", None)] + [
                (f"parallel.pp.{cls}", m)
                for cls in ("PipelinedStreams", "PipelinedMatting")
                for m in ("__init__", "step", "flush", "convert")] + [
                (f"train.data.{fn}", None) for fn in (
                    "synthetic_clip_batches", "synthetic_hard_clip_batches",
                    "synthetic_hard_plate_batches", "alpha_to_trimap",
                    "trimap_from_mask", "synthetic_ambiguous_clip_batches",
                    "synthetic_plate_batches", "synthetic_trimap_batches",
                    "synthetic_seg_batches")]
CONFIGS = ["ModelConfig", "RefineConfig", "PipelineConfig", "StreamConfig"]


def _params(mod, name, method):
    if "." in name:  # a submodule's name: deploy.export_bundle
        import importlib

        sub, name = name.rsplit(".", 1)
        mod = importlib.import_module(f"{mod.__name__}.{sub}")
    fn = getattr(mod, name)
    if method:
        fn = getattr(fn, method)
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()}


@pytest.mark.parametrize("name,method", ENTRY_POINTS,
                         ids=lambda v: v or "fn")
def test_entry_point_parameters_exist_with_equal_defaults(name, method):
    want = _params(vidmat, name, method)
    got = _params(vidmat_torch, name, method)
    missing = sorted(set(want) - set(got))
    assert not missing, missing
    # The port adds only the device to pick the card or the CPU.
    assert set(got) - set(want) <= {"device"}
    for k, v in want.items():
        if dataclasses.is_dataclass(v):  # a config default: equal fields
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(v), k
        elif k == "cdtype":  # jnp.float32 there, torch.float32 here
            assert str(got[k]).removeprefix("torch.") == np.dtype(v).name
        else:
            assert got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_exist_with_equal_defaults(name):
    want = getattr(jconfig, name)()
    got = getattr(tconfig, name)()
    wf = {f.name for f in dataclasses.fields(want)}
    gf = {f.name for f in dataclasses.fields(got)}
    assert wf == gf, (wf - gf, gf - wf)
    for f in wf:
        w, g = getattr(want, f), getattr(got, f)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(w) == dataclasses.asdict(g), f
        else:
            assert w == g, (f, g, w)
    assert getattr(vidmat_torch, name) is getattr(tconfig, name)


def _as_dicts(preset):
    return [dataclasses.asdict(c) for c in preset]


@pytest.mark.parametrize("key", sorted(jconfig.PRESETS))
def test_presets_equal_jax(key):
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
    want, got = jconfig.PRESETS[key](), tconfig.PRESETS[key]()
    assert len(got) == len(want)
    assert [type(c).__name__ for c in got] == [type(c).__name__
                                               for c in want]
    assert _as_dicts(got) == _as_dicts(want)
    assert getattr(vidmat_torch, f"preset_{key}") is tconfig.PRESETS[key]


# The JAX package's lazy exports (vidmat/__init__.py:27-57): the port's
# object of the same name.
LAZY = {"MattingNetwork": "vidmat_torch.models.matting_net",
        "trimap_from_mask": "vidmat_torch.pipeline.trimap",
        "MultiStreamMatting": "vidmat_torch.parallel.multistream",
        "RealtimeMatting": "vidmat_torch.pipeline.realtime",
        "make_mesh": "vidmat_torch.parallel.mesh",
        "PipelinedMatting": "vidmat_torch.parallel.pp",
        "PipelinedStreams": "vidmat_torch.parallel.pp"}


@pytest.mark.parametrize("name", list(LAZY) + ["no_such_name"])
def test_lazy_exports_resolve_or_name_their_item(name):
    """C.6: each of the seven resolves as in the JAX package (the three of
    A.12's mesh and pipeline split raised naming A.12 before they were
    ported); any other name raises AttributeError, as there. None of the
    six modules is imported by ``import vidmat_torch``."""
    import importlib
    import subprocess
    import sys

    if name == "no_such_name":
        with pytest.raises(AttributeError):
            getattr(vidmat, name)
        with pytest.raises(AttributeError):
            getattr(vidmat_torch, name)
        code = ("import sys, vidmat_torch; print(sorted(m for m in "
                f"{sorted(v for v in LAZY.values() if v)!r} "
                "if m in sys.modules))")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout
        assert out.strip() == "[]", out
        return
    assert name in vars(vidmat).get("__getattr__").__code__.co_consts
    got = getattr(vidmat_torch, name)
    assert got is getattr(importlib.import_module(LAZY[name]), name)
    assert hasattr(vidmat_torch, name)
    assert got.__name__ == getattr(vidmat, name).__name__


def test_import_loads_neither_deploy_eval_nor_cli():
    """``import vidmat_torch`` imports none of the modules of the bundles,
    the evaluation, the command line and training (nor torch.export's
    loader state): each is imported where it is used."""
    import subprocess
    import sys

    mods = ["vidmat_torch.deploy", "vidmat_torch.eval",
            "vidmat_torch.eval.metrics", "vidmat_torch.cli",
            "vidmat_torch.ops.library", "vidmat_torch.train",
            "vidmat_torch.train.loop"]
    code = ("import sys, vidmat_torch; print(sorted(m for m in "
            f"{mods!r} if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]", out


FRAMES = [np.zeros((32, 32, 3), np.uint8)]


@pytest.mark.parametrize("case", ["errormap preset", "refiner_variables",
                                  "session errormap", "multistream"])
def test_unported_options_raise_naming_their_item(case):
    """Error-map refinement (A.11) is ported: the preset runs, a
    ``refiner_variables`` outside errormap mode is ignored, and the body
    with no refiner is the JAX package's bilinear tail. Multi-stream
    serving's one-card part (A.12) is ported: the preset's
    ``MultiStreamMatting`` steps, and ``convert_video`` given its
    ``StreamConfig`` raises TypeError naming that class."""
    from vidmat_torch import convert_video

    if case == "errormap preset":
        m, p = tconfig.preset_video_1080p_errormap()
        frames = [np.full((64, 96, 3), 40 * i, np.uint8) for i in range(5)]
        alphas = []
        out = convert_video(frames, output_alpha=alphas.append, model_cfg=m,
                            pipe_cfg=p, device="cpu")
        assert out["frames"] == 5 and len(alphas) == 5
        assert alphas[0].shape == (64, 96) and alphas[0].dtype == np.uint8
    elif case == "refiner_variables":
        # Guided (the defaults): the refiner's weights are ignored, as in
        # vidmat/pipeline/video.py:284-291.
        frames = FRAMES * 2
        runs = []
        for rv in (None, {"params": {}}):
            comps = []
            convert_video(frames, output_composition=comps.append,
                          refiner_variables=rv, device="cpu")
            runs.append(np.stack(comps))
        np.testing.assert_array_equal(runs[0], runs[1])
    elif case == "session errormap":
        import jax
        import jax.numpy as jnp
        import torch
        from vidmat.models.matting_net import MattingNetwork
        from vidmat.pipeline.stepfactory import build_serving_body as jbuild

        from vidmat_torch.models.weights import build_network, \
            default_variables
        from vidmat_torch.pipeline.stepfactory import build_serving_body

        cfg = tconfig.ModelConfig()
        variables = default_variables(cfg)
        net = build_network(cfg, variables)
        body, plan = build_serving_body(
            net, cfg, tconfig.RefineConfig("errormap"), 32, 32, 0.5,
            cdtype=torch.float32, float_output=True)
        jcfg = jconfig.ModelConfig()
        jbody, jplan = jbuild(MattingNetwork(jcfg), jcfg,
                              jconfig.RefineConfig("errormap"), 32, 32, 0.5,
                              cdtype=jnp.float32, use_pallas=False,
                              float_output=True)
        f = (np.arange(32 * 32 * 3) % 251).astype(np.uint8).reshape(
            1, 32, 32, 3)
        (ta, tf), _ = body(torch.from_numpy(f), plan.make_state(1))
        (ja, jf), _ = jbody(jax.tree_util.tree_map(jnp.asarray, variables),
                            jnp.asarray(f), jplan.make_state(1))
        assert float(np.abs(ta.numpy() - np.asarray(ja)).max()) <= 1e-4
        assert float(np.abs(tf.numpy() - np.asarray(jf)).max()) <= 1e-4
    else:
        m, p, s = tconfig.preset_multistream()
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jconfig.StreamConfig())
        ms = vidmat_torch.MultiStreamMatting(
            s.num_streams, 64, 64, cfg=m, downsample_ratio=s.downsample_ratio,
            refine=p.refine, dtype=p.dtype, chunk=p.chunk_size,
            bg_color=(0.0, 1.0, 0.0), device="cpu")
        frames = np.stack([np.full((64, 64, 3), 30 * i, np.uint8)
                           for i in range(s.num_streams)])
        alpha, rgba = ms.step(frames)
        assert alpha.shape == (s.num_streams, 64, 64, 1)
        assert rgba.shape == (s.num_streams, 64, 64, 4)
        with pytest.raises(TypeError, match="MultiStreamMatting"):
            convert_video(FRAMES, model_cfg=m, pipe_cfg=tconfig.StreamConfig(),
                          device="cpu")
