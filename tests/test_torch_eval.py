"""The port's evaluation metrics (``vidmat_torch.eval``) against the JAX
package's (``vidmat.eval``) on the CPU, on alpha frames made from a seed
with numpy: every per-frame row and the scaled summary. Bars: MAD, MSE,
SAD, dtSSD and fgr MSE within 1e-5 relative, Grad within 1e-4 relative
(two separable convolutions summed in another order), Conn equal (the
same numpy and scipy code on the same float32 frames)."""

import numpy as np
import pytest

from vidmat_torch.eval import (VideoEval, connectivity_error,
                               evaluate_sequences, scale_metric,
                               trimap_unknown_region)

H, W, T = 48, 64, 4
ALL = ("mad", "mse", "sad", "grad", "conn", "dtssd", "fgr_mse")
REL = {"grad": 1e-4}


def _alphas(seed, dtype="float", n=T):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for t in range(n):
        # A soft disk that moves, plus noise: partial alpha everywhere on
        # its edge, solid inside.
        r = np.hypot(yy - 20 - 3 * t, xx - 30 - 2 * t)
        a = np.clip((14.0 - r) / 4.0, 0.0, 1.0)
        a = np.clip(a + 0.05 * rng.randn(H, W), 0.0, 1.0).astype(np.float32)
        if dtype == "u8":
            a = np.round(a * 255).astype(np.uint8)
        elif dtype == "u16":
            a = np.round(a * 65535).astype(np.uint16)
        out.append(a)
    return out


def _close(name, got, want):
    rel = REL.get(name, 1e-5)
    assert abs(got - want) <= rel * max(abs(want), 1e-12), (name, got, want)


def _run(mod_eval, metrics, preds, trues, regions=None, fgrs=None,
         **kw):
    ev = mod_eval(metrics=metrics, **kw)
    for i, (p, t) in enumerate(zip(preds, trues)):
        extra = {}
        if regions is not None:
            extra["region"] = regions[i]
        if fgrs is not None:
            extra["pred_fgr"], extra["true_fgr"] = fgrs[0][i], fgrs[1][i]
        ev.update(p, t, **extra)
    return ev.frames, ev.summary()


def _check(rows, summary, jrows, jsummary):
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert sorted(r) == sorted(j)
        for k in r:
            if k == "conn":
                assert r[k] == j[k], (r[k], j[k])
            else:
                _close(k, r[k], j[k])
    assert sorted(summary) == sorted(jsummary)
    for k, v in summary.items():
        if k == "conn":
            assert v == jsummary[k]
        else:
            _close(k, v, jsummary[k])


@pytest.mark.parametrize("dtype", ["float", "u8", "u16"])
def test_video_eval_matches_jax(dtype):
    from vidmat.eval import VideoEval as JVideoEval

    preds, trues = _alphas(1, dtype), _alphas(2, dtype)
    metrics = ("mad", "mse", "sad", "grad", "conn", "dtssd")
    rows, summary = _run(VideoEval, metrics, preds, trues, device="cpu")
    jrows, jsummary = _run(JVideoEval, metrics, preds, trues)
    assert summary["frames"] == T and len([r for r in rows
                                           if "dtssd" in r]) == T - 1
    _check(rows, summary, jrows, jsummary)


def test_trimap_restricted_region_matches_jax():
    from vidmat.eval import VideoEval as JVideoEval
    from vidmat.eval import trimap_unknown_region as j_region

    preds, trues = _alphas(3), _alphas(4)
    tris = [np.where(t > 0.95, 255, np.where(t < 0.05, 0, 128)).astype(
        np.uint8) for t in trues]
    regions = [trimap_unknown_region(t) for t in tris]
    for r, t in zip(regions, tris):
        np.testing.assert_array_equal(r, j_region(t))
        assert 0 < r.sum() < r.size
    metrics = ("mad", "mse", "sad", "grad", "conn", "dtssd")
    rows, summary = _run(VideoEval, metrics, preds, trues, regions,
                         device="cpu")
    jrows, jsummary = _run(JVideoEval, metrics, preds, trues, regions)
    _check(rows, summary, jrows, jsummary)


def test_fgr_mse_matches_jax():
    from vidmat.eval import VideoEval as JVideoEval

    rng = np.random.RandomState(5)
    preds, trues = _alphas(5), _alphas(6)
    fgr_p = [rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
             for _ in range(T)]
    fgr_t = [rng.rand(H, W, 3).astype(np.float32) for _ in range(T)]
    rows, summary = _run(VideoEval, ("mad", "fgr_mse"), preds, trues,
                         fgrs=(fgr_p, fgr_t), device="cpu")
    jrows, jsummary = _run(JVideoEval, ("mad", "fgr_mse"), preds, trues,
                           fgrs=(fgr_p, fgr_t))
    assert "fgr_mse" in summary
    _check(rows, summary, jrows, jsummary)


def test_connectivity_error_equals_jax():
    from vidmat.eval import connectivity_error as j_conn

    p, t = _alphas(7, n=1)[0], _alphas(8, n=1)[0]
    region = trimap_unknown_region((t * 255).astype(np.uint8))
    assert connectivity_error(p, t) == j_conn(p, t)
    assert connectivity_error(p, t, region=region) == j_conn(p, t,
                                                             region=region)


def test_evaluate_sequences_matches_jax():
    from vidmat.eval import evaluate_sequences as j_eval

    preds, trues = _alphas(9, "u8"), _alphas(10, "u8")
    got = evaluate_sequences(preds, trues, device="cpu")
    want = j_eval(preds, trues)
    _check([], got, [], want)
    assert scale_metric("mad", 0.002) == pytest.approx(2.0)


def test_errors_match_jax():
    from vidmat.eval import VideoEval as JVideoEval
    from vidmat.eval import evaluate_sequences as j_eval

    a = _alphas(11, n=1)[0]
    cases = [
        (lambda E, **k: E(metrics=("mad", "psnr"), **k), "unknown metrics"),
        (lambda E, **k: E(**k).update(a, a[:-1]), "pred"),
        (lambda E, **k: E(**k).update(a, a, region=a[:-1] > 0.5), "region"),
        (lambda E, **k: E(**k).update(a[None], a), "alpha frame must be"),
    ]
    for make, match in cases:
        with pytest.raises(ValueError, match=match):
            make(VideoEval, device="cpu")
        with pytest.raises(ValueError, match=match):
            make(JVideoEval)
    with pytest.raises(ValueError, match="different lengths"):
        evaluate_sequences([a, a], [a], device="cpu")
    with pytest.raises(ValueError, match="different lengths"):
        j_eval([a, a], [a])
