"""The port's weight bridge and its shipped checkpoints.

``vidmat_torch/checkpoints/<name>.npz`` for fast_demo, synthetic_demo,
plate_demo, trimap_demo, trimap_prop_demo, seg_demo (co-trained, with
its seg_head) and errormap_demo (the error-map refiner) are the JAX
package's ``checkpoints/<name>`` flattened to one npz entry per leaf, so
the port loads them with numpy alone. Running this file as a script rewrites the
named ones (all by default):

    python tests/test_torch_weights.py [name ...]
"""

import ast
import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: shipped checkpoint -> the ModelConfig fields that select it
CHECKPOINTS = {"fast_demo": dict(space_to_depth=2),
               "synthetic_demo": dict(space_to_depth=1),
               "plate_demo": dict(use_bg_plate=True, space_to_depth=2),
               "trimap_demo": dict(use_trimap=True, recurrent=False),
               "trimap_prop_demo": dict(use_trimap=True, space_to_depth=2),
               "seg_demo": dict(space_to_depth=1),
               "errormap_demo": None}
#: the co-trained checkpoints (matting weights and seg_head)
SEG = {"seg_demo"}
#: the error-map refiner's checkpoint (no ModelConfig selects it)
REFINER = "errormap_demo"


def _npz(name):
    return os.path.join(ROOT, "vidmat_torch", "checkpoints", f"{name}.npz")


def _restore(name):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.weights import (default_variables,
                                       seg_default_variables)

    if name == REFINER:
        # The JAX package restores the refiner through a template from
        # ErrorMapRefiner.init (its convolutions' shapes do not depend on
        # the frame's).
        from vidmat.pipeline.video import _load_default_refiner
        from vidmat.refine.errormap import ErrorMapRefiner

        variables = _load_default_refiner(
            ErrorMapRefiner(num_patches=8, patch_size=16), 64, 64, 16, 16)
    else:
        load = seg_default_variables if name in SEG else default_variables
        variables = load(JModelConfig(**CHECKPOINTS[name]))
    return jax.tree_util.tree_map(np.asarray, variables)


def export(names=None) -> None:
    from vidmat_torch.models.weights import save_npz

    for name in names or CHECKPOINTS:
        save_npz(_npz(name), _restore(name))


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_committed_npz_equals_checkpoint(name):
    from vidmat_torch.models.weights import (default_checkpoint_path,
                                             default_refiner_path,
                                             flatten_variables, load_npz)
    from vidmat_torch.config import ModelConfig

    if name == REFINER:
        assert default_refiner_path() == _npz(name)
    else:
        assert default_checkpoint_path(ModelConfig(**CHECKPOINTS[name]),
                                       seg=name in SEG) == _npz(name)
    want = flatten_variables(_restore(name))
    got = flatten_variables(load_npz(_npz(name)))
    assert sorted(got) == sorted(want)
    # 76 leaves; the non-recurrent trimap_demo has no GRU (4 leaves per
    # decoder stage); seg_demo adds the seg_head's kernel and bias; the
    # refiner has 6 convolutions, 4 of them with BatchNorm.
    assert len(got) == {"trimap_demo": 64, "seg_demo": 78,
                        REFINER: 24}.get(name, 76)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_state_dict_mapping_layouts():
    """kernel (H, W, I, O) -> weight (O, I, H, W); BN scale/bias ->
    weight/bias; batch_stats mean/var -> running_mean/var; seg_head kept."""
    from vidmat_torch.models.weights import state_dict_from_jax

    rng = np.random.RandomState(0)
    k = rng.rand(3, 3, 5, 7).astype(np.float32)
    variables = {
        "params": {"d0": {"conv": {"kernel": k},
                          "bn": {"scale": np.ones(7, np.float32),
                                 "bias": np.full(7, 2.0, np.float32)}},
                   "seg_head": {"kernel": k, "bias": np.zeros(7, np.float32)}},
        "batch_stats": {"d0": {"bn": {"mean": np.full(7, 3.0, np.float32),
                                      "var": np.full(7, 4.0, np.float32)}}},
    }
    sd = state_dict_from_jax(variables)
    np.testing.assert_array_equal(sd["d0.conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    assert float(sd["d0.bn.bias"][0]) == 2.0
    assert float(sd["d0.bn.running_mean"][0]) == 3.0
    assert float(sd["d0.bn.running_var"][0]) == 4.0
    assert "seg_head.weight" in sd and "seg_head.bias" in sd


def test_fast_demo_loads_into_network():
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import build_network, default_variables

    net = build_network(ModelConfig(space_to_depth=2),
                        default_variables(ModelConfig(space_to_depth=2)))
    n_params = sum(p.numel() for p in net.parameters())
    n_stats = sum(b.numel() for b in net.buffers())
    assert n_params + n_stats == 239788
    assert all(not p.requires_grad for p in net.parameters())


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "vidmat_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "bench_torch.py")


def test_port_imports_neither_jax_nor_vidmat():
    bad = []
    for path in _port_files():
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "orbax", "vidmat"):
                bad.append(f"{os.path.relpath(path, ROOT)}: {mod}")
    assert not bad, bad


def test_training_imports_no_jax_module():
    """The training package and its tools, imported in a fresh process,
    load none of jax, flax, optax, orbax or the JAX package."""
    import subprocess

    mods = ["vidmat_torch.train", "vidmat_torch.train.loop",
            "vidmat_torch.train.data", "vidmat_torch.train.dataset",
            "vidmat_torch.train.refine", "vidmat_torch.tools.train_eval",
            "vidmat_torch.tools.train_seg"]
    assert any(p.endswith(os.path.join("train", "loop.py"))
               for p in _port_files())
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vidmat')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]", out


def test_entry_points_raise_without_cuda(monkeypatch):
    from vidmat_torch import MattingSession, convert_video, matte_image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_video([np.zeros((64, 64, 3), np.uint8)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MattingSession(64, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        matte_image(np.zeros((64, 64, 3), np.uint8))
    from vidmat_torch.config import ModelConfig
    from vidmat_torch.train import make_train_step, train_on_clips

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(ModelConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_on_clips(ModelConfig(), iter(()), num_steps=0)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    names = sys.argv[1:] or list(CHECKPOINTS)
    export(names)
    print("wrote", *(_npz(name) for name in names))
