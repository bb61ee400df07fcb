"""The port's kernel modules against the JAX package, on the CPU.

Each wrapper runs its plain PyTorch version on CPU tensors; the JAX side
runs its Pallas kernel in interpret mode, as tests/unit/
test_pallas_kernels.py does. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.ops.gf import guided_filter_coeffs
from vidmat_torch.ops.guided_filter import box_mean, gray_guide
from vidmat_torch.ops.ingest import ingest_pool_normalize
from vidmat_torch.ops.refine import fused_refine_composite
from vidmat_torch.ops.resize import (downsample_ratio_shape,
                                     resize_bilinear, upsample2x)


# The shapes the CUDA kernel's paths take: pool 4 with 3 channels (the
# main path's vector path), the other pools and 4 channels (the general
# path; 4 channels: the plate and trimap ingest).
@pytest.mark.parametrize("pool, c", [
    pytest.param(1, 3, id="1"), pytest.param(2, 3, id="2"),
    pytest.param(4, 3, id="4"), pytest.param(8, 3, id="8"),
    pytest.param(4, 4, id="4-c4"), pytest.param(2, 4, id="2-c4")])
def test_ingest_matches_jax(pool, c):
    from vidmat.ops.pallas import ingest_pool_normalize as j_ingest

    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (2, 64, 96, c)).astype(np.uint8)
    want = np.asarray(j_ingest(jnp.asarray(img), pool=pool,
                               out_dtype=jnp.float32, interpret=True))
    got = ingest_pool_normalize(torch.from_numpy(img), pool=pool,
                                out_dtype=torch.float32)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert ingest_pool_normalize.launches == 0  # CPU: the plain version


def test_ingest_custom_normalization_and_bf16():
    from vidmat.ops.pallas import ingest_pool_normalize as j_ingest

    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (1, 32, 64, 3)).astype(np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    scale, offset = 1.0 / (255.0 * std), -mean / std
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(j_ingest(jnp.asarray(img), pool=2, scale=scale,
                                   offset=offset, out_dtype=jdt,
                                   interpret=True)).astype(np.float32)
        got = ingest_pool_normalize(torch.from_numpy(img), pool=2,
                                    scale=scale, offset=offset,
                                    out_dtype=dt).float().numpy()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        assert np.abs(got - want).max() <= tol, dt


def test_gf_coeffs_matches_jax():
    from vidmat.ops.pallas import guided_filter_coeffs as j_gf

    rng = np.random.RandomState(3)
    g = rng.rand(1, 48, 80, 1).astype(np.float32)
    p = rng.rand(1, 48, 80, 4).astype(np.float32)
    for r, eps in ((4, 1e-4), (3, 1e-2)):
        ja, jb = j_gf(jnp.asarray(g), jnp.asarray(p), radius=r, eps=eps,
                      interpret=True)
        ta, tb = guided_filter_coeffs(torch.from_numpy(g),
                                      torch.from_numpy(p), r, eps)
        assert np.abs(ta.numpy() - np.asarray(ja)).max() <= 1e-3, r
        assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1e-3, r
    assert guided_filter_coeffs.launches == 0


def test_box_mean_and_gray_guide_match_jax():
    from vidmat.ops.guided_filter import _box_filter
    from vidmat.ops.guided_filter import gray_guide as j_gray

    rng = np.random.RandomState(4)
    x = rng.rand(2, 20, 33, 3).astype(np.float32)
    for r in (1, 4):
        want = np.asarray(_box_filter(jnp.asarray(x), r))
        got = box_mean(torch.from_numpy(x), r).numpy()
        assert np.abs(got - want).max() <= 1e-6, r
    want = np.asarray(j_gray(jnp.asarray(x)))
    assert np.abs(gray_guide(torch.from_numpy(x)).numpy() - want).max() \
        <= 1e-6


# The shapes the tiled CUDA kernel must get right, each with n = 2: one
# full 128-column tile at pool 4, pool 2 and pool 8 with odd coarse widths
# (151, 37) whose tiles the width does not fill, and pool 4 with partial
# tiles in both directions (36 rows, 300 columns, 75 coarse columns).
@pytest.mark.parametrize("bg, shape", [
    pytest.param(None, (64, 128, 4), id="None"),
    pytest.param((0.0, 1.0, 0.0), (64, 128, 4), id="bg1"),
    pytest.param((0.2, 0.4, 0.9), (64, 128, 4), id="bg2"),
    pytest.param(None, (36, 302, 2), id="None-pool2-wl151"),
    pytest.param((0.2, 0.4, 0.9), (64, 296, 8), id="bg2-pool8-wl37"),
    pytest.param((0.0, 1.0, 0.0), (36, 300, 4), id="bg1-pool4-36x300")])
def test_refine_composite_matches_jax(bg, shape):
    from vidmat.ops.pallas.composite_kernel import unpack_rgba_host
    from vidmat.ops.pallas.refine_kernel import fused_refine_composite as j_rc

    rng = np.random.RandomState(7)
    n, (h, w, pool) = 2, shape
    frame = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    a_lr = rng.uniform(-0.5, 1.5, (n, h // pool, w // pool, 4)
                       ).astype(np.float32)
    b_lr = rng.uniform(-0.5, 1.0, (n, h // pool, w // pool, 4)
                       ).astype(np.float32)
    jbg = None if bg is None else jnp.asarray(bg, jnp.float32)
    want = unpack_rgba_host(np.asarray(j_rc(
        jnp.asarray(frame), jnp.asarray(a_lr), jnp.asarray(b_lr), jbg,
        pool=pool, interpret=True))).astype(int)
    out = fused_refine_composite(torch.from_numpy(frame),
                                 torch.from_numpy(a_lr),
                                 torch.from_numpy(b_lr), bg, pool)
    assert out.dtype == torch.uint32 and out.shape == (n, h, w)
    got = out.numpy().view(np.uint8).reshape(n, h, w, 4).astype(int)
    d = np.abs(got - want)
    assert d.max() <= 1, d.max()  # +-1 LSB: f32 rounding at the .5 edge
    assert fused_refine_composite.launches == 0


def test_resize_matches_jax():
    from vidmat.ops.resize import downsample_ratio_shape as j_shape
    from vidmat.ops.resize import resize_bilinear as j_resize
    from vidmat.ops.resize import upsample2x as j_up

    rng = np.random.RandomState(5)
    x = rng.rand(1, 12, 20, 4).astype(np.float32)
    want = np.asarray(j_up(jnp.asarray(x)))
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-6
    want = np.asarray(j_resize(jnp.asarray(x), 48, 80))
    got = resize_bilinear(torch.from_numpy(x), 48, 80).numpy()
    assert np.abs(got - want).max() <= 1e-5
    for hw in ((1088, 1920), (128, 192), (300, 412)):
        for ratio in (0.25, 0.5, 0.375):
            assert downsample_ratio_shape(*hw, ratio) == j_shape(*hw, ratio)


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        ingest_pool_normalize(x, pool=2)
