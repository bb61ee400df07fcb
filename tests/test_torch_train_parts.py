"""The training parts of the port against the JAX package on the CPU:
BatchNorm in training mode against flax's, the losses and their
gradients against ``jax.grad``, the optimizer and schedule against optax,
the initialisation, the weight tools, the checkpoint round trip and the
refiner's train step."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vidmat.train import losses as jlosses
from vidmat_torch.config import ModelConfig
from vidmat_torch.models import weights as tw
from vidmat_torch.models.layers import BatchNorm, batch_statistics, ema_update
from vidmat_torch.train import losses as tlosses
from vidmat_torch.train import optim


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


# ---- BatchNorm in training mode ------------------------------------------

@pytest.mark.parametrize("center", [0.0, 3.0])
def test_batchnorm_train_matches_flax(center):
    """One layer, also on inputs whose mean is far from 0 (6 std, where
    E[x^2] - E[x]^2 cancels): output, gradients to the input, scale and
    bias, and the running update, against flax.linen.BatchNorm(momentum=
    0.99), within 1e-6 of the largest value of each. The reference is
    flax in float64: in float32 flax's own sums put its variance ~4e-5
    (relative) off at center 3, the port's float64 means ~1e-7."""
    rng = np.random.RandomState(0)
    c = 8
    x = (center + 0.5 * rng.randn(2, 6, 5, c)).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5)
    with jax.enable_x64(True):
        f64 = functools.partial(np.asarray, dtype=np.float64)
        stats = {"mean": f64(mean0), "var": f64(var0)}

        def f(x, params):
            y, mut = bn.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * f64(cot)), (y, mut["batch_stats"])

        (_, (jy, jstats)), (jgx, jgp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(
            f64(x), {"scale": f64(scale), "bias": f64(bias)})
        jy, jgx = np.asarray(jy), np.asarray(jgx)
        jgp = jax.tree_util.tree_map(np.asarray, jgp)
        jstats = jax.tree_util.tree_map(np.asarray, jstats)

    m = BatchNorm(c, 1e-5, bn_train=True)
    with torch.no_grad():
        m.weight.copy_(_t(scale))
        m.bias.copy_(_t(bias))
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    with batch_statistics() as sink:
        y = m(xt)
    (y * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    assert len(sink) == 1 and sink[0][0] is m
    _, bmean, bvar = sink[0]

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())

    close(y.detach().permute(0, 2, 3, 1).numpy(), jy)
    close(xt.grad.permute(0, 2, 3, 1).numpy(), jgx)
    close(m.weight.grad.numpy(), jgp["scale"])
    close(m.bias.grad.numpy(), jgp["bias"])
    close(ema_update(_t(mean0), bmean).numpy(), jstats["mean"])
    close(ema_update(_t(var0), bvar).numpy(), jstats["var"])
    # The module's own buffers are not written: the caller folds them.
    assert torch.equal(m.running_mean, torch.zeros(c))
    assert torch.equal(m.running_var, torch.ones(c))


def test_batchnorm_inference_path_unchanged():
    m = BatchNorm(4, 1e-5)
    with torch.no_grad():
        m.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        m.running_var.copy_(torch.tensor([0.5, 1.0, 1.5, 2.0]))
        m.weight.copy_(torch.tensor([1.0, 0.5, 2.0, 1.5]))
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    mul = torch.rsqrt(m.running_var + 1e-5) * m.weight
    want = (x - m.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
        + m.bias.view(1, -1, 1, 1)
    with batch_statistics() as sink:
        assert torch.equal(m(x), want)
    assert sink == []


# ---- losses -------------------------------------------------------------

def _loss_inputs(size, t, seed=0):
    """Predictions strictly inside (0, 1) against the fixture's exact
    alpha: no pred - gt difference is exactly 0, so no |x| tie decides a
    gradient (the ties' rule has its own test)."""
    from vidmat.io.fixtures import synthetic_frame

    rng = np.random.RandomState(seed)
    n = 2
    ga = np.zeros((t, n, size, size, 1), np.float32)
    fr = np.zeros((t, n, size, size, 3), np.float32)
    for i in range(t):
        for b in range(n):
            f, a = synthetic_frame(size, size, 0.1 * i + 0.37 * b, seed=b)
            fr[i, b], ga[i, b] = f / 255.0, a
    pa = np.clip(ga + rng.normal(0, 0.2, ga.shape), 0.01, 0.99).astype(
        np.float32)
    pf = rng.uniform(0.01, 0.99, fr.shape).astype(np.float32)
    gf = np.clip(fr + rng.normal(0, 0.05, fr.shape), 0, 1).astype(
        np.float32)
    return pa, pf, ga, gf, fr


def _jax64(fn, *args):
    """jax.jit(fn) on float64 copies of ``args`` (numpy leaves out).
    The losses are means over up to 10^5 values: the JAX package's
    float32 sums on the CPU are ~5e-6 (relative) off, the port's ~1e-7,
    so the port is held to the float64 values."""
    with jax.enable_x64(True):
        out = jax.jit(fn)(*(None if a is None else np.asarray(a, np.float64)
                            for a in args))
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("size", [64, 96, 100])
@pytest.mark.parametrize("with_gt_fgr", [True, False])
@pytest.mark.parametrize("t", [1, 2])
def test_matting_loss_and_grads_match_jax(size, with_gt_fgr, t):
    """Every term (temporal 0 at T=1), the Laplacian and boundary terms
    on, and d loss / d (pred_alpha, pred_fgr), within 1e-6 relative."""
    pa, pf, ga, gf, fr = _loss_inputs(size, t)
    kw = dict(laplacian_weight=0.7, boundary_weight=1.3)

    def jf(pa, pf, ga, gf, fr):
        return jax.value_and_grad(
            lambda a, f: jlosses.matting_loss(a, f, ga, gf, fr, **kw),
            argnums=(0, 1), has_aux=True)(pa, pf)

    (jl, jterms), (jga, jgf) = _jax64(jf, pa, pf, ga,
                                      gf if with_gt_fgr else None, fr)
    tpa, tpf = _t(pa).requires_grad_(True), _t(pf).requires_grad_(True)
    tl, tterms = tlosses.matting_loss(
        tpa, tpf, _t(ga), _t(gf) if with_gt_fgr else None, _t(fr), **kw)
    tl.backward()
    assert set(tterms) == set(jterms) == {"alpha", "grad", "fgr",
                                          "temporal", "laplacian",
                                          "boundary"}
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in jterms:
        assert abs(float(tterms[k]) - float(jterms[k])) <= 1e-6 * max(
            abs(float(jterms[k])), 1e-12), (k, float(tterms[k]),
                                            float(jterms[k]))
    if t == 1:
        assert float(tterms["temporal"]) == 0.0
    assert _rel(tpa.grad.numpy(), jga) <= 1e-6
    assert _rel(tpf.grad.numpy(), jgf) <= 1e-6


@pytest.mark.parametrize("size", [64, 96, 100])
def test_laplacian_pyramid_matches_jax(size):
    """The pyramid alone, at sizes whose halving rounds up (96 -> 48 ->
    24 -> 12 -> 6; 100 -> 50 -> 25 -> 13 -> 7, where the upsample is not
    exactly 2x)."""
    pa, _, ga, _, _ = _loss_inputs(size, 1, seed=4)
    jl, jg = _jax64(jax.value_and_grad(jlosses.laplacian_pyramid_loss),
                    pa[0], ga[0])
    tp = _t(pa[0]).requires_grad_(True)
    tl = tlosses.laplacian_pyramid_loss(tp, _t(ga[0]))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(tp.grad.numpy(), jg) <= 1e-6


def test_loss_ties_follow_jax():
    """At exact ties the port's gradients are JAX's: |0| passes +1 (torch's
    abs 0), a clip at its bound half (torch's clamp all)."""
    from vidmat_torch.models.layers import abs_ties_one, clip_ties_half

    x = np.array([0.0, -0.5, 0.5, 1.0, 0.0], np.float32)
    for jfn, tfn in ((jnp.abs, abs_ties_one),
                     (lambda v: jnp.clip(v, 0.0, 1.0),
                      lambda v: clip_ties_half(v, 0.0, 1.0))):
        jg = jax.grad(lambda v: jnp.sum(jfn(v) * jnp.arange(1.0, 6.0)))(x)
        tx = _t(x).requires_grad_(True)
        (tfn(tx) * torch.arange(1.0, 6.0)).sum().backward()
        np.testing.assert_array_equal(tx.grad.numpy(), jg)
        np.testing.assert_array_equal(tfn(_t(x)).numpy(), jfn(x))


@pytest.mark.parametrize("case", ["mixed", "empty_union"])
def test_segmentation_loss_matches_jax(case):
    rng = np.random.RandomState(1)
    logits = rng.normal(0, 2, (2, 2, 16, 16, 1)).astype(np.float32)
    mask = (rng.rand(2, 2, 16, 16, 1) > 0.6).astype(np.float32)
    if case == "empty_union":
        logits = -np.abs(logits) - 0.1
        mask = np.zeros_like(mask)
    (jl, jterms), jg = _jax64(jax.value_and_grad(
        jlosses.segmentation_loss, has_aux=True), logits, mask)
    tl_in = _t(logits).requires_grad_(True)
    tl, tterms = tlosses.segmentation_loss(tl_in, _t(mask))
    tl.backward()
    assert set(tterms) == set(jterms) == {"seg_bce", "seg_iou"}
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert abs(float(tterms["seg_iou"]) - float(jterms["seg_iou"])) <= 1e-6
    if case == "empty_union":
        assert float(tterms["seg_iou"]) == 1.0
    assert _rel(tl_in.grad.numpy(), jg) <= 1e-6


# ---- optimizer and schedule ---------------------------------------------

def _grad_sequence(norm_scale, seed=0):
    """Five steps of gradients over a small tree: one leaf always zero,
    another zero on alternate steps; the global norm ``norm_scale`` times
    a value near 1 (above and below the clip's limit)."""
    rng = np.random.RandomState(seed)
    shapes = {"a": {"kernel": (3, 3, 4, 5), "bias": (5,)},
              "b": {"scale": (7,)}, "c": {"bias": (2,)}}
    seq = []
    for s in range(5):
        g = jax.tree_util.tree_map(
            lambda shp: rng.randn(*shp).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
        g["c"]["bias"] = np.zeros(2, np.float32)
        if s % 2:
            g["b"]["scale"] = np.zeros(7, np.float32)
        norm = np.sqrt(sum(float(np.sum(x * x))
                           for x in jax.tree_util.tree_leaves(g)))
        g = jax.tree_util.tree_map(
            lambda x: (x / norm * norm_scale * (1 + 0.1 * s)).astype(
                np.float32), g)
        seq.append(g)
    params = jax.tree_util.tree_map(
        lambda shp: rng.randn(*shp).astype(np.float32) * 0.1, shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    return params, seq


def _run_optax(opt, params, seq):
    state = opt.init(params)
    for g in seq:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return jax.tree_util.tree_map(np.asarray, params)


def _run_port(opt, params, seq):
    params = optim.tree_map(_t, params)
    state = opt.init(params)
    for g in seq:
        upd, state = opt.update(optim.tree_map(_t, g), state, params)
        params = optim.apply_updates(params, upd)
    return optim.tree_map(lambda x: x.numpy(), params)


@pytest.mark.parametrize("norm_scale", [0.3, 4.0])
@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_optimizer_matches_optax(norm_scale, lr):
    params, seq = _grad_sequence(norm_scale)
    if lr == "constant":
        jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
        topt = optim.make_optimizer(1e-2)
    else:
        jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
            optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5,
                                               end_value=1e-4)))
        topt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(
            optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5,
                                               end_value=1e-4)))
    want = tw.flatten_variables(_run_optax(jopt, params, seq))
    got = tw.flatten_variables(_run_port(topt, params, seq))
    p0 = tw.flatten_variables(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    # the always-zero leaf still moved (its first moment is 0 here, so
    # only the alternating one shows Adam moving a zero-gradient leaf)
    assert np.array_equal(got["c/bias"], p0["c/bias"])
    assert not np.array_equal(got["b/scale"], p0["b/scale"])


def test_head_only_multi_transform_matches_optax():
    """train_seg's head-only optimizer: Adam (its clip over the head's
    leaves alone) on ``seg_head``, set_to_zero elsewhere."""
    params, seq = _grad_sequence(2.0, seed=3)
    params = {"seg_head": params["a"], "trunk": params["b"]}
    seq = [{"seg_head": g["a"], "trunk": g["b"]} for g in seq]
    jopt = optax.multi_transform(
        {"head": optax.chain(optax.clip_by_global_norm(1.0),
                             optax.adam(1e-2)),
         "freeze": optax.set_to_zero()},
        lambda p: jax.tree_util.tree_map_with_path(
            lambda path, _: ("head" if path[0].key == "seg_head"
                             else "freeze"), p))
    topt = optim.multi_transform(
        {"head": optim.make_optimizer(1e-2), "freeze": optim.set_to_zero()},
        lambda p: {k: optim.tree_map(
            lambda _, k=k: "head" if k == "seg_head" else "freeze", v)
            for k, v in p.items()})
    want = tw.flatten_variables(_run_optax(jopt, params, seq))
    got = tw.flatten_variables(_run_port(topt, params, seq))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(got["trunk/scale"],
                                  params["trunk"]["scale"])


@pytest.mark.parametrize("warmup,steps", [(100, 4000), (3, 50), (1, 2)])
def test_schedule_matches_optax_at_every_step(warmup, steps):
    lr = 2e-4
    js = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                            end_value=lr * 1e-2)
    ts = optim.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                            end_value=lr * 1e-2)
    counts = np.arange(steps + 5, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(js))(counts))
    got = np.array([ts(int(c)) for c in counts], np.float32)
    # float32 arithmetic on both sides (cos may differ by an ulp, which
    # the tail's small values magnify relatively)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * lr)


# ---- initialisation and weight tools ------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tree(s2d=1, with_seg=False):
    from vidmat.config import ModelConfig as JModelConfig
    from vidmat.models.weights import graft_seg_params, init_params

    cfg = JModelConfig(space_to_depth=s2d)

    def init():
        v = init_params(cfg, seed=0, height=32, width=32)
        return graft_seg_params(v, cfg) if with_seg else v
    return jax.tree_util.tree_map(np.asarray, jax.jit(init)())


@pytest.mark.parametrize("s2d", [1, 2])
def test_init_params_tree_and_distribution(s2d):
    """The JAX package's tree (names and shapes); conv kernels with the
    std of lecun_normal, sqrt(1 / fan_in), within 5% per leaf (leaves with
    fewer than 2048 values pooled over eight seeds), truncated at two of
    its stds; biases and BatchNorm at Flax's defaults; the trunk the same
    with and without the seg head."""
    cfg = ModelConfig(space_to_depth=s2d)
    want = tw.flatten_variables(_jax_tree(s2d))
    got = tw.flatten_variables(tw.init_params(cfg, seed=0))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    seg = tw.flatten_variables(tw.init_params(cfg, seed=0, with_seg=True))
    assert set(seg) - set(got) == {"params/seg_head/kernel",
                                   "params/seg_head/bias"}
    for k in got:
        np.testing.assert_array_equal(seg[k], got[k])
    for k, v in seg.items():
        if k.endswith("/kernel"):
            fan_in = int(np.prod(v.shape[:3]))
            vals = v.ravel()
            seeds = 1
            while vals.size < 2048:
                more = tw.flatten_variables(tw.init_params(
                    cfg, seed=seeds, with_seg=True))[k]
                vals = np.concatenate([vals, more.ravel()])
                seeds += 1
            std = np.sqrt(1.0 / fan_in)
            assert abs(vals.std() / std - 1) <= 0.05, (k, vals.std(), std)
            assert np.abs(vals).max() <= 2 * std / 0.87962566103423978
        elif k.endswith("/scale") or k.endswith("/var"):
            assert np.all(v == 1), k
        else:
            assert np.all(v == 0), k


def test_init_params_differs_by_seed_and_repeats():
    cfg = ModelConfig()
    a = tw.flatten_variables(tw.init_params(cfg, seed=0))
    b = tw.flatten_variables(tw.init_params(cfg, seed=0))
    c = tw.flatten_variables(tw.init_params(cfg, seed=1))
    k = "params/encoder/stem/conv/kernel"
    assert np.array_equal(a[k], b[k]) and not np.array_equal(a[k], c[k])


def test_randomize_bn_stats_equals_jax():
    from vidmat.models.weights import randomize_bn_stats

    tree = _jax_tree()
    want = tw.flatten_variables(jax.tree_util.tree_map(
        np.asarray, randomize_bn_stats(tree, seed=3)))
    got = tw.flatten_variables(tw.randomize_bn_stats(tree, seed=3))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_graft_seg_params_keeps_matting_bit_identical():
    from vidmat_torch.models.weights import build_network

    cfg = ModelConfig()
    v = tw.randomize_bn_stats(_jax_tree(), seed=2)
    g = tw.graft_seg_params(v, cfg, seed=0)
    assert "seg_head" in g["params"] and "seg_head" not in v["params"]
    with pytest.raises(ValueError, match="already has a seg_head"):
        tw.graft_seg_params(g, cfg)
    frame = torch.rand(1, 32, 32, 3,
                       generator=torch.Generator().manual_seed(0))
    a0, f0, _ = build_network(cfg, v)(frame, None)
    a1, f1, _ = build_network(cfg, g)(frame, None)
    assert torch.equal(a0, a1) and torch.equal(f0, f1)


def test_graft_cond_params_matches_jax(monkeypatch):
    import vidmat.models.weights as jw
    from vidmat.config import ModelConfig as JModelConfig

    init = jw.init_params
    # the JAX graft inits its target op by op (half a minute here): jit it
    monkeypatch.setattr(jw, "init_params", lambda cfg, seed=0: jax.jit(
        functools.partial(init, cfg, seed))())
    src = _jax_tree(2)
    jcfg = JModelConfig(space_to_depth=2, use_trimap=True)
    want = tw.flatten_variables(jax.tree_util.tree_map(
        np.asarray, jw.graft_cond_params(src, jcfg)))
    got = tw.flatten_variables(tw.graft_cond_params(
        src, ModelConfig(space_to_depth=2, use_trimap=True)))
    # the grafted kernels: source rows copied, new rows zero; the other
    # leaves the source's
    for k in ("params/encoder/stem/conv/kernel", "params/d0/conv/kernel"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in got:
        if got[k].shape == tw.flatten_variables(src)[k].shape:
            np.testing.assert_array_equal(got[k],
                                          tw.flatten_variables(src)[k])


def test_npz_round_trip_exact(tmp_path):
    """Tensors (a training state's leaves) -> save_checkpoint -> load_npz
    gives the same bytes; the module-state bridge inverts exactly."""
    cfg = ModelConfig()
    v = tw.randomize_bn_stats(tw.init_params(cfg, seed=4, with_seg=True))
    tensors = optim.tree_map(lambda x: torch.tensor(np.asarray(x)), v)
    path = tw.save_checkpoint(str(tmp_path / "ckpt"), tensors)
    assert path.endswith("ckpt.npz")
    back = tw.flatten_variables(tw.load_npz(path))
    want = tw.flatten_variables(v)
    assert set(back) == set(want)
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k])
    inv = tw.flatten_variables(tw.variables_from_state_dict(
        tw.state_dict_from_jax(v)))
    for k in want:
        np.testing.assert_array_equal(inv[k], want[k])


# ---- the refiner's trainer ----------------------------------------------

def test_refiner_train_step_grads_match_jax():
    """One step of the refiner's trainer (error head, patch gather and
    scatter, the L1 terms) from the same variables and inputs, gradients
    per leaf (BatchNorm's running statistics included: the JAX step
    differentiates the whole tree) against the JAX step (float32: its
    patch slicing does not trace under x64)."""
    from vidmat.refine.errormap import ErrorMapRefiner as JRefiner
    from vidmat.train.refine import make_refiner_train_step as jmake
    from vidmat_torch.refine.errormap import ErrorMapRefiner
    from vidmat_torch.train.refine import make_refiner_train_step

    k, p, hf, hl, n = 4, 16, 64, 32, 2
    rng = np.random.RandomState(0)
    jref = JRefiner(num_patches=k, patch_size=p)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jref.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, hf, hf, 3)), jnp.zeros((1, hl, hl, 3)),
                          jnp.zeros((1, hl, hl, 1))))())
    variables = tw.randomize_bn_stats(variables, seed=5)
    rgb = rng.rand(n, hf, hf, 3).astype(np.float32)
    rgb_lr = rng.rand(n, hl, hl, 3).astype(np.float32)
    alpha_lr = np.clip(rng.rand(n, hl, hl, 1) * 1.4 - 0.2, 0, 1).astype(
        np.float32)
    gt = np.clip(rng.rand(n, hf, hf, 1) * 1.4 - 0.2, 0, 1).astype(np.float32)

    def capture_jax():
        return optax.GradientTransformation(
            lambda q: {"g": jax.tree_util.tree_map(jnp.zeros_like, q)},
            lambda g, s, q=None: (jax.tree_util.tree_map(jnp.zeros_like, g),
                                  {"g": g}))

    opt = capture_jax()
    _, s32, jloss, jterms = jmake(jref, opt)(
        variables, opt.init(variables), rgb, rgb_lr, alpha_lr, gt)
    want = tw.flatten_variables(jax.tree_util.tree_map(np.asarray,
                                                       s32["g"]))
    jloss = float(jloss)
    topt = optim.GradientTransformation(
        lambda q: {"g": optim.tree_map(optim.zeros_like, q)},
        lambda g, s, q=None: (optim.tree_map(torch.zeros_like, g),
                              {"g": g}))
    step = make_refiner_train_step(ErrorMapRefiner(num_patches=k,
                                                   patch_size=p), topt,
                                   device="cpu")
    _, st, loss, terms = step(variables, topt.init(variables), rgb, rgb_lr,
                              alpha_lr, gt)
    got = tw.flatten_variables(tw.numpy_variables(st["g"]))
    assert set(got) == set(want)
    assert any(k.startswith("batch_stats/") and np.any(want[k])
               for k in want)
    worst = {key: _rel(got[key], want[key]) for key in want}
    assert max(worst.values()) <= 1e-4, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]
    assert abs(float(loss) - jloss) <= 1e-5 * jloss
    assert set(terms) == set(jterms) == {"alpha", "err"}


def test_refiner_init_is_flax_shaped():
    from vidmat.refine.errormap import ErrorMapRefiner as JRefiner
    from vidmat_torch.train.refine import init_refiner_params

    jv = jax.jit(lambda: JRefiner(num_patches=4, patch_size=16).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 1))))()
    want = tw.flatten_variables(jax.tree_util.tree_map(np.asarray, jv))
    got = tw.flatten_variables(init_refiner_params(seed=0, num_patches=4))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
