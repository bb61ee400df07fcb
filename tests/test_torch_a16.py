"""A.16: the JAX package's remaining one-card surface in the port, each
held to the JAX function on the same seeded inputs (CPU, small shapes):

- ``ops.guided_filter.guided_filter``, the full-resolution filter (max
  |d| <= 1e-5);
- ``utils.metrics.sad`` (1e-12) and ``RunMetrics``'s ``extra`` and
  ``dump`` (the summary equal but for the wall clock);
- the weight bridge's names: ``flax_to_torch_state`` and
  ``torch_to_flax_variables`` equal (0) on fast_demo and seg_demo,
  ``graft_trimap_params`` as ``graft_cond_params``' test holds it,
  ``load_into_torch`` (a co-trained tree into a matting-only module) and
  ``load_checkpoint`` (the port's .npz, with and without a template);
- ``pipeline.scan.make_chunk_step`` against the JAX chunk step (max |d|
  <= 1e-4 per frame over two carried chunks);
- ``tools.import_torch_weights`` and the orbax converter at the repo
  root (their .npz equal to the source, 0);
- ``tools.eval_errormap``'s report against the JAX tool's at 64x64.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import runpy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.config import ModelConfig
from vidmat_torch.models import weights as tw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host(tree):
    return tw.flatten_variables(jax.tree_util.tree_map(np.asarray, tree))


def _assert_trees_equal(got, want):
    got, want = tw.flatten_variables(got), _host(want)
    assert set(got) == set(want), (set(got) ^ set(want))
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- guided_filter -------------------------------------------------------

def _gf_case(case):
    rng = np.random.RandomState(2)
    if case == "self-guided":  # tests/unit/test_ops.py:58
        src = rng.rand(1, 40, 40, 1).astype(np.float32)
        return src, src, 3, 1e-8
    if case == "edge":  # tests/unit/test_ops.py:79
        edge = np.zeros((1, 32, 32, 1), np.float32)
        edge[:, :, 16:] = 1.0
        blurred = np.stack([np.convolve(row, np.ones(5) / 5, mode="same")
                            for row in edge[0, :, :, 0]])[None, ..., None]
        return edge, blurred.astype(np.float32), 4, 1e-6
    # odd sizes, so the edge windows count; a 3-channel src
    return (rng.rand(2, 33, 47, 1).astype(np.float32),
            rng.rand(2, 33, 47, 3).astype(np.float32), 4, 1e-4)


@pytest.mark.parametrize("case", ["self-guided", "edge", "odd 3-channel"])
def test_guided_filter_matches_jax(case):
    from vidmat.ops.guided_filter import guided_filter as jgf

    from vidmat_torch.ops import guided_filter

    guide, src, r, eps = _gf_case(case)
    want = np.asarray(jgf(jnp.asarray(guide), jnp.asarray(src), r, eps))
    got = guided_filter(torch.from_numpy(guide), torch.from_numpy(src),
                        r, eps)
    assert got.dtype == torch.float32 and got.shape == src.shape
    d = float(np.abs(got.numpy() - want).max())
    assert d <= 1e-5, d


# ---- metrics -------------------------------------------------------------

def test_sad_matches_jax():
    from vidmat.utils import sad as jsad

    from vidmat_torch.utils import sad

    rng = np.random.RandomState(0)
    a, b = rng.rand(37, 53).astype(np.float32), rng.rand(37, 53)
    assert abs(sad(a, b) - jsad(a, b)) <= 1e-12


def test_run_metrics_summary_matches_jax():
    """The summary starts from ``extra`` and adds the observations'
    figures, as the JAX class; ``dump`` is its JSON."""
    from vidmat.utils.metrics import RunMetrics as JRunMetrics

    from vidmat_torch.utils.metrics import RunMetrics

    runs = []
    for cls in (JRunMetrics, RunMetrics):
        m = cls()
        m.extra.update(model="fast_demo", frames=-1, note=1.5)
        for s, k in ((0.01, 4), (0.02, 4), (0.005, 1)):
            if k == 1:
                m.record_frame(s)
            else:
                m.record_chunk(s, k)
        out = m.summary()
        assert json.loads(m.dump()).keys() == out.keys()
        out.pop("wall_s")
        runs.append(out)
    assert runs[1] == runs[0]
    assert runs[0]["frames"] == 9 and runs[0]["model"] == "fast_demo"


# ---- the weight bridge ---------------------------------------------------

def _shipped(name):
    from vidmat_torch.models.weights import (default_variables,
                                             seg_default_variables)

    if name == "seg_demo":
        return seg_default_variables(ModelConfig())
    return default_variables(ModelConfig(space_to_depth=2))


@pytest.mark.parametrize("name", ["fast_demo", "seg_demo"])
def test_flax_to_torch_state_matches_jax(name):
    """Key for key, value for value; seg_demo's top-level seg_head is
    dropped (``state_dict_from_jax`` keeps it)."""
    from vidmat.models.weights import flax_to_torch_state as jf2t

    v = _shipped(name)
    want, got = jf2t(v), tw.flax_to_torch_state(v)
    assert list(got) == list(want)
    assert not any(k.startswith("seg_head.") for k in got)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    kept = set(tw.state_dict_from_jax(v)) - set(got)
    assert kept == ({"seg_head.weight", "seg_head.bias"}
                    if name == "seg_demo" else set())


@pytest.mark.parametrize("name", ["fast_demo", "seg_demo"])
def test_torch_to_flax_variables_matches_jax(name):
    """The template's leaves filled from a state dict (tensors, with a
    ``num_batches_tracked`` the template lacks), equal to JAX's (0); a
    leaf the state dict lacks raises KeyError in both."""
    from vidmat.models.weights import torch_to_flax_variables as jt2f

    v = _shipped(name)
    sd = tw.state_dict_from_jax(v)
    sd["d0.bn.num_batches_tracked"] = torch.tensor(3)
    want = jt2f({k: x.numpy() for k, x in sd.items()}, v)
    got = tw.torch_to_flax_variables(sd, v)
    _assert_trees_equal(got, want)
    del sd["head.bias"]
    for fn in (tw.torch_to_flax_variables, jt2f):
        with pytest.raises(KeyError):
            fn({k: x.numpy() for k, x in sd.items()}, v)


def test_graft_trimap_params_matches_jax(monkeypatch):
    import vidmat.models.weights as jw
    from vidmat.config import ModelConfig as JModelConfig

    # The JAX graft reads only its target's tree and shapes (it inits the
    # target op by op, half a minute here): the port's init gives both.
    monkeypatch.setattr(jw, "init_params", lambda cfg, seed=0: tw.init_params(
        ModelConfig(**dataclasses.asdict(cfg)), seed))
    src = tw.default_variables(ModelConfig())
    want = _host(jw.graft_trimap_params(src, JModelConfig(use_trimap=True)))
    got = tw.flatten_variables(tw.graft_trimap_params(
        src, ModelConfig(use_trimap=True)))
    flat_src = tw.flatten_variables(src)
    assert set(got) == set(want) == set(flat_src)
    # the grafted kernel: source rows copied, the trimap rows zero; the
    # other leaves the source's
    k = "params/encoder/stem/conv/kernel"
    assert got[k].shape == (3, 3, 4, flat_src[k].shape[3])
    np.testing.assert_array_equal(got[k], want[k])
    assert not got[k][:, :, 3].any()
    for k in got:
        if got[k].shape == flat_src[k].shape:
            np.testing.assert_array_equal(got[k], flat_src[k])
    with pytest.raises(ValueError, match="use_trimap=True"):
        tw.graft_trimap_params(src, ModelConfig())


def test_load_into_torch_seg_tree_into_matting_module():
    """A co-trained tree loads into a matting-only ``MattingNetwork``
    (tests/parity/test_image_parity.py:167) in eval mode, and its forward
    equals ``build_network``'s on the same tree."""
    from vidmat_torch.models.matting_net import MattingNetwork

    cfg = ModelConfig()
    v = _shipped("seg_demo")
    net = MattingNetwork(cfg).train()
    tw.load_into_torch(net, v)
    assert not net.training and net.seg_head is None
    frame = torch.rand(1, 32, 32, 3,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a0, f0, s0 = net(frame, None)
    a1, f1, s1 = tw.build_network(cfg, v)(frame, None)
    assert torch.equal(a0, a1) and torch.equal(f0, f1)
    assert all(torch.equal(x, y) for x, y in zip(s0, s1))


def test_load_checkpoint_round_trip_and_refusals(tmp_path):
    from vidmat_torch.models import load_checkpoint, save_checkpoint

    cfg = ModelConfig(space_to_depth=2)
    v = _shipped("fast_demo")
    tensors = {c: jax.tree_util.tree_map(torch.from_numpy, v[c]) for c in v}
    path = save_checkpoint(str(tmp_path / "ck"), tensors)
    assert path == str(tmp_path / "ck.npz")
    for p in (path, str(tmp_path / "ck")):  # the path save_checkpoint took
        _assert_trees_equal(load_checkpoint(p), v)
    template = tw.init_params(cfg)
    got = load_checkpoint(path, template=template)
    _assert_trees_equal(got, v)
    assert list(tw.flatten_variables(got)) == list(
        tw.flatten_variables(template))
    bad = tw.init_params(ModelConfig())  # s2d=1: other shapes
    with pytest.raises(ValueError, match="shapes differ"):
        load_checkpoint(path, template=bad)
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(path, template=tw.init_params(cfg, with_seg=True))
    with pytest.raises(ValueError, match="jax_checkpoint_to_npz.py"):
        load_checkpoint(str(tmp_path))


# ---- make_chunk_step -----------------------------------------------------

def test_make_chunk_step_matches_jax():
    """synthetic_demo's weights, float32, 32x32, N=1: K=3 from init_state,
    then a chunk carried from the first, against ``jax.jit(
    make_chunk_step(net))``; the two chunks equal one chunk of 6 on both
    sides."""
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.matting_net import MattingNetwork as JNet
    from vidmat.models.matting_net import init_state as j_init_state
    from vidmat.pipeline.scan import make_chunk_step as j_make

    from vidmat_torch.models import MattingNetwork
    from vidmat_torch.models.matting_net import init_state
    from vidmat_torch.pipeline.scan import make_chunk_step

    cfg = ModelConfig()
    v = tw.default_variables(cfg)
    frames = np.random.RandomState(4).rand(6, 1, 32, 32, 3).astype(
        np.float32)
    jstep = jax.jit(j_make(JNet(JModelConfig())))
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    ja, jf, js = jstep(jv, jnp.asarray(frames[:3]),
                       j_init_state(JModelConfig(), 1, 32, 32))
    jb, jg, _ = jstep(jv, jnp.asarray(frames[3:]), js)
    j6a, j6f, _ = jstep(jv, jnp.asarray(frames),
                        j_init_state(JModelConfig(), 1, 32, 32))
    step = make_chunk_step(MattingNetwork(cfg), device="cpu")
    ta, tf, ts = step(v, torch.from_numpy(frames[:3]),
                      init_state(cfg, 1, 32, 32))
    tb, tg, _ = step(v, frames[3:], ts)
    t6a, t6f, _ = step(v, frames, init_state(cfg, 1, 32, 32))
    assert ta.shape == (3, 1, 32, 32, 1) and tf.shape == (3, 1, 32, 32, 3)
    alphas = torch.cat([ta, tb]).numpy()
    fgrs = torch.cat([tf, tg]).numpy()
    np.testing.assert_array_equal(alphas, t6a.numpy())
    np.testing.assert_array_equal(fgrs, t6f.numpy())
    np.testing.assert_allclose(np.concatenate([ja, jb]), j6a, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([jf, jg]), j6f, atol=1e-6)
    da = np.abs(alphas - np.concatenate([ja, jb])).max(axis=(1, 2, 3, 4))
    df = np.abs(fgrs - np.concatenate([jf, jg])).max(axis=(1, 2, 3, 4))
    assert da.max() <= 1e-4 and df.max() <= 1e-4, (da, df)


# ---- the .pth importer and the orbax converter ---------------------------

def test_import_torch_weights(tmp_path):
    """A .pth of the port's module state (after ``load_into_torch``)
    imports to the variables (0) and to JAX's ``torch_to_flax_variables``
    on the same state dict (0); a ``--map`` that renames a key back is
    honoured."""
    from vidmat.models.weights import torch_to_flax_variables as jt2f

    from vidmat_torch.models import MattingNetwork
    from vidmat_torch.tools import import_torch_weights as tool

    cfg = ModelConfig()
    v = tw.randomize_bn_stats(tw.default_variables(cfg), seed=3)
    net = MattingNetwork(cfg)
    tw.load_into_torch(net, v)
    sd = net.state_dict()
    torch.save({"state_dict": sd}, tmp_path / "a.pth")
    assert tool.main([str(tmp_path / "a.pth"), str(tmp_path / "a")]) == 0
    got = tw.load_checkpoint(str(tmp_path / "a.npz"))
    _assert_trees_equal(got, v)
    _assert_trees_equal(got, jt2f({k: x.numpy() for k, x in sd.items()},
                                  tw.init_params(cfg)))
    renamed = {("final.bias" if k == "head.bias" else k): x
               for k, x in sd.items()}
    torch.save(renamed, tmp_path / "b.pth")
    (tmp_path / "map.txt").write_text("final.bias -> head.bias\n")
    with pytest.raises(KeyError, match="head.bias"):
        tool.main([str(tmp_path / "b.pth"), str(tmp_path / "b")])
    assert tool.main([str(tmp_path / "b.pth"), str(tmp_path / "b.npz"),
                      "--map", str(tmp_path / "map.txt")]) == 0
    _assert_trees_equal(tw.load_checkpoint(str(tmp_path / "b.npz")), v)


def test_orbax_checkpoint_converts_to_npz(tmp_path):
    """An orbax checkpoint that the JAX package's ``save_checkpoint``
    writes converts leaf for leaf (0), and the port's ``load_checkpoint``
    reads the file with the network's template."""
    import jax_checkpoint_to_npz as conv
    from vidmat.models.weights import save_checkpoint as j_save

    from vidmat_torch.models import load_checkpoint

    cfg = ModelConfig()
    v = tw.randomize_bn_stats(tw.default_variables(cfg), seed=5)
    j_save(str(tmp_path / "orbax"), jax.tree_util.tree_map(jnp.asarray, v))
    with pytest.raises(ValueError, match="jax_checkpoint_to_npz"):
        load_checkpoint(str(tmp_path / "orbax"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert conv.main([str(tmp_path / "orbax"),
                          str(tmp_path / "conv")]) == 0
    assert out.getvalue().strip() == f"wrote {tmp_path / 'conv.npz'}"
    got = load_checkpoint(str(tmp_path / "conv.npz"),
                          template=tw.init_params(cfg))
    _assert_trees_equal(got, v)


# ---- eval_errormap -------------------------------------------------------

ERRORMAP_ARGS = ["--size", "64x64", "--frames", "2", "--seeds", "987654"]


def test_eval_errormap_report_matches_jax(monkeypatch):
    """The port's report at 64x64, 2 frames, one seed on the CPU has the
    JAX tool's keys and values: MADs within 1e-4, the Grad sums (about
    1e3, float32 sums in both) within 1e-4 relative. The JAX tool runs
    in-process with its argv set; its restore templates are initialised
    jitted (Flax's init takes about 40 s op by op here; only their
    structure is read)."""
    import vidmat.models.weights as jw
    import vidmat.pipeline.video as jvideo

    from vidmat_torch.tools import eval_errormap

    init, load_refiner = jw.init_params, jvideo._load_default_refiner
    monkeypatch.setattr(jw, "init_params", lambda cfg, **kw: jax.jit(
        functools.partial(init, cfg, **kw))())
    monkeypatch.setattr(jvideo, "_load_default_refiner",
                        lambda ref, *a: load_refiner(types.SimpleNamespace(
                            init=jax.jit(ref.init)), *a))
    monkeypatch.setattr(sys, "argv", ["eval_errormap.py", *ERRORMAP_ARGS,
                                      "--platform", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        runpy.run_path(os.path.join(ROOT, "tools", "eval_errormap.py"),
                       run_name="__main__")
    assert e.value.code == 0
    want = json.loads(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert eval_errormap.main([*ERRORMAP_ARGS, "--device", "cpu"]) == 0
    got = json.loads(out.getvalue())
    assert list(got) == list(want)
    for k in ("size", "ratio", "ckpt", "hard2", "frames"):
        assert got[k] == want[k], k
    for mode in ("guided", "errormap", "bilinear"):
        assert list(got[mode]) == list(want[mode])
        for k, w in want[mode].items():
            assert abs(got[mode][k] - w) <= 1e-4 * max(1.0, abs(w)), (
                mode, k, got[mode][k], w)
