"""The port's quality report (``vidmat_torch.tools.quality_report``)
against the JAX package's (tools/quality_report.py) on the CPU:
``eval_checkpoint`` on fast_demo at 32x48, 2 frames of each held-out
seed, every scaled metric within 1e-5 relative (the two float32 sessions
agree to about 3e-7 relative there); and the fixtures of its hard suite
(``HARD2``, ``HARD_PLATE`` and the hard clean-plate clip) equal to the
JAX package's."""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_eval_checkpoint_matches_jax_report():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import quality_report as jreport
    finally:
        sys.path.pop(0)
    from vidmat_torch.tools import quality_report

    got = quality_report.eval_checkpoint("fast_demo", frames=2, h=32, w=48,
                                         device="cpu")
    want = jreport.eval_checkpoint("fast_demo", frames=2, h=32, w=48)
    assert sorted(got) == sorted(want)
    assert got["frames"] == want["frames"] == 6
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)


def test_hard_suite_fixtures_equal_jax():
    from vidmat.io import fixtures as jfix

    from vidmat_torch.io import fixtures as tfix

    assert tfix.HARD2 == jfix.HARD2 and tfix.HARD_PLATE == jfix.HARD_PLATE
    for got, want in zip(
            tfix.synthetic_hard_plate_clip(40, 56, 3, seed=2,
                                           **tfix.HARD_PLATE),
            jfix.synthetic_hard_plate_clip(40, 56, 3, seed=2,
                                           **jfix.HARD_PLATE)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
