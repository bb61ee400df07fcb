"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: they skip where no CUDA device is present (the
CPU tests hold the plain versions to the JAX package). Run them on the
card with ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_ingest_kernel_bit_exact(dev):
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)

    g = torch.Generator().manual_seed(0)
    for shape, pool in (((1, 64, 96, 3), 4), ((2, 30, 50, 4), 2)):
        img = torch.randint(0, 256, shape, generator=g,
                            dtype=torch.uint8).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            before = ingest_pool_normalize.launches
            got = ingest_pool_normalize(img, pool, out_dtype=dt)
            assert ingest_pool_normalize.launches == before + 1
            assert torch.equal(got, ingest_pool_normalize_plain(
                img, pool, out_dtype=dt))


def test_gf_kernel_matches_plain(dev):
    from vidmat_torch.ops.gf import (guided_filter_coeffs,
                                     guided_filter_coeffs_plain)

    g = torch.Generator().manual_seed(1)
    for (n, h, w), r in (((1, 68, 120), 4), ((2, 37, 53), 2),
                         ((1, 20, 31), 8)):
        gi = torch.rand((n, h, w, 1), generator=g).to(dev)
        pi = torch.rand((n, h, w, 4), generator=g).to(dev)
        ka, kb = guided_filter_coeffs(gi, pi, r, 1e-4)
        pa, pb = guided_filter_coeffs_plain(gi, pi, r, 1e-4)
        assert float((ka - pa).abs().max()) <= 1e-4
        assert float((kb - pb).abs().max()) <= 1e-4


@pytest.mark.parametrize("bg", [None, (0.0, 1.0, 0.0)])
def test_refine_kernel_within_one_lsb(dev, bg):
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain)

    g = torch.Generator().manual_seed(2)
    fr = torch.randint(0, 256, (2, 64, 300, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    a = (torch.rand((2, 16, 75, 4), generator=g) * 2 - 0.5).to(dev)
    b = (torch.rand((2, 16, 75, 4), generator=g) - 0.5).to(dev)
    k = fused_refine_composite(fr, a, b, bg, 4).view(torch.uint8).int()
    q = fused_refine_composite_plain(fr, a, b, bg, 4).view(torch.uint8).int()
    assert int((k - q).abs().max()) <= 1
