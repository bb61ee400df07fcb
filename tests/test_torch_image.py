"""``vidmat_torch.matte_image`` against ``vidmat.matte_image`` on the CPU.

Both run the net in float32 from the shipped checkpoints at 100x148 (not a
multiple of 16: both pad and crop): synthetic_demo (no trimap),
trimap_demo given a trimap and given a rough mask, and plate_demo given a
plate. Bars: alpha and fgr MAD <= 1e-4, max |d| <= 1e-3 (float32 against
float32, the two frameworks' convolutions summing in their own orders).
The trimap's known regions come out exactly 0 and 1.
"""

import numpy as np
import pytest

from vidmat_torch.io.fixtures import synthetic_frame, synthetic_plate_frame

H, W = 100, 148


def _inputs():
    frame, gt = synthetic_frame(H, W, 0.3, seed=11)
    mask = np.where(gt[..., 0] > 0.5, 255, 0).astype(np.uint8)
    return frame, gt, mask


def _trimap(mask):
    from vidmat_torch.pipeline.trimap import trimap_from_mask

    return trimap_from_mask(mask)


CASES = ["synthetic_demo", "trimap_demo_trimap", "trimap_demo_mask",
         "plate_demo"]


@pytest.mark.parametrize("case", CASES)
def test_matte_image_matches_jax(case):
    import vidmat

    import vidmat_torch

    frame, _, mask = _inputs()
    if case == "synthetic_demo":
        kw = {}
    elif case == "trimap_demo_trimap":
        kw = dict(trimap=_trimap(mask)[..., 0])
    elif case == "trimap_demo_mask":
        kw = dict(mask=mask, mask_band=0.05)
    else:
        frame, _, plate = synthetic_plate_frame(H, W, 0.2, seed=3)
        kw = dict(bg_plate=plate)
    ja, jf = vidmat.matte_image(frame, **kw)
    ta, tf = vidmat_torch.matte_image(frame, device="cpu", **kw)
    assert ta.shape == (H, W, 1) and tf.shape == (H, W, 3)
    assert ta.dtype == np.float32 and tf.dtype == np.float32
    for got, want in ((ta, np.asarray(ja)), (tf, np.asarray(jf))):
        d = np.abs(got - want)
        assert d.mean() <= 1e-4 and d.max() <= 1e-3, (case, d.mean(),
                                                      d.max())
    if case.startswith("trimap"):
        from vidmat_torch.pipeline.trimap import trimap_from_mask

        tri = trimap_from_mask(mask, band=0.05 if "mask" in case else 0.04)
        assert (ta[tri >= 0.75] == 1.0).all()
        assert (ta[tri <= 0.25] == 0.0).all()
        unknown = (tri == 0.5)
        assert unknown.any() and ((ta[unknown] > 0) & (ta[unknown] < 1)).any()


@pytest.mark.parametrize("band", [0.04, 0.1, 3])
@pytest.mark.parametrize("form", ["u8", "float", "hw1", "hw3"])
def test_trimap_from_mask_equals_jax(band, form):
    from vidmat.train.data import trimap_from_mask as j_trimap

    from vidmat_torch.pipeline.trimap import trimap_from_mask

    rng = np.random.RandomState(band if isinstance(band, int) else 7)
    _, _, mask = _inputs()
    m = {"u8": mask,
         "float": mask.astype(np.float32) / 255.0
         + rng.rand(H, W).astype(np.float32) * 0.2,
         "hw1": mask[..., None],
         "hw3": np.repeat(mask[..., None], 3, axis=-1)}[form]
    got = trimap_from_mask(m, band=band)
    want = j_trimap(m, band=band)
    assert got.dtype == want.dtype and got.shape == (H, W, 1)
    np.testing.assert_array_equal(got, want)


def test_matte_image_errors():
    import vidmat_torch

    frame, _, mask = _inputs()
    tri = _trimap(mask)
    with pytest.raises(ValueError, match="not both"):
        vidmat_torch.matte_image(frame, trimap=tri, mask=mask, device="cpu")
    with pytest.raises(ValueError, match="no shipped checkpoint combines"):
        vidmat_torch.matte_image(frame, trimap=tri, bg_plate=frame,
                                 device="cpu")
    from vidmat_torch import ModelConfig

    with pytest.raises(ValueError, match="requires a trimap"):
        vidmat_torch.matte_image(
            frame, cfg=ModelConfig(recurrent=False, use_trimap=True),
            device="cpu")
    with pytest.raises(ValueError, match="not plate-conditioned"):
        vidmat_torch.matte_image(frame, cfg=ModelConfig(), bg_plate=frame,
                                 device="cpu")
    with pytest.raises(ValueError, match="must match the image"):
        vidmat_torch.matte_image(frame, bg_plate=frame[:50], device="cpu")
    with pytest.raises(ValueError, match="no shipped checkpoint"):
        vidmat_torch.matte_image(frame, cfg=ModelConfig(recurrent=False),
                                 device="cpu")
