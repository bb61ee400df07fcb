"""The port's training data (vidmat_torch/train/data.py and dataset.py,
and the fixtures they draw from) against the JAX package's: host numpy,
so equal seeds give equal bytes."""

import os

import numpy as np
import pytest

from vidmat.io import fixtures as jfix
from vidmat.train import data as jdata
from vidmat.train import dataset as jdataset
from vidmat_torch.io import fixtures as tfix
from vidmat_torch.train import data as tdata
from vidmat_torch.train import dataset as tdataset

S = dict(t=2, n=2, h=32, w=32)
BATCHERS = {
    "synthetic_clip_batches": dict(S, seed=1),
    "synthetic_hard_clip_batches": dict(S, seed=2, octave2=0.7),
    "synthetic_hard_plate_batches": dict(S, seed=3),
    "synthetic_ambiguous_clip_batches": dict(S, seed=4),
    "synthetic_plate_batches": dict(S, seed=5),
    "synthetic_trimap_batches": dict(S, seed=6, keyframe="mixed",
                                     ambiguous=0.3, hard=0.3, octave2=0.5),
    "synthetic_trimap_batches/only": dict(S, seed=7, keyframe="only"),
    "synthetic_seg_batches": dict(S, seed=8, hard=0.5, octave2=0.5),
}


def _equal_batches(a, b, count=3):
    for _ in range(count):
        x, y = next(a), next(b)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name", list(BATCHERS))
def test_batchers_equal_jax(name):
    fn = name.split("/")[0]
    kw = BATCHERS[name]
    _equal_batches(getattr(tdata, fn)(**kw), getattr(jdata, fn)(**kw))


@pytest.mark.parametrize("fn,args", [
    ("alpha_to_trimap", ()), ("trimap_from_mask", (0.1,)),
    ("trimap_from_mask", (3,)), ("_box_dilate", (2,))])
def test_trimap_helpers_equal_jax(fn, args):
    _, alpha = jfix.synthetic_frame(48, 64, 0.2, seed=3)
    x = (alpha[..., 0] > 0.5) if fn == "_box_dilate" else alpha
    np.testing.assert_array_equal(getattr(tdata, fn)(x, *args),
                                  getattr(jdata, fn)(x, *args))


def test_ambiguous_fixture_equals_jax():
    for target in (0, 1):
        got = list(tfix.synthetic_ambiguous_clip(40, 56, 3, seed=2,
                                                 target=target))
        want = list(jfix.synthetic_ambiguous_clip(40, 56, 3, seed=2,
                                                  target=target))
        for (f, a), (g, b) in zip(got, want):
            np.testing.assert_array_equal(f, g)
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dataset_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    got = tfix.write_synthetic_matting_dataset(str(root / "port"),
                                               num_clips=2, frames=5,
                                               h=48, w=64, seed=1)
    want = jfix.write_synthetic_matting_dataset(str(root / "jax"),
                                                num_clips=2, frames=5,
                                                h=48, w=64, seed=1)
    return got, want


def test_dataset_writer_equals_jax(dataset_dirs):
    """The same files with the same pixels (PNG is lossless)."""
    import cv2

    got, want = dataset_dirs
    for key in ("fgr", "pha", "bgr"):
        names = sorted(os.path.relpath(os.path.join(d, f), want[key])
                       for d, _, fs in os.walk(want[key]) for f in fs)
        assert names == sorted(
            os.path.relpath(os.path.join(d, f), got[key])
            for d, _, fs in os.walk(got[key]) for f in fs)
        for n in names:
            np.testing.assert_array_equal(
                cv2.imread(os.path.join(got[key], n), cv2.IMREAD_UNCHANGED),
                cv2.imread(os.path.join(want[key], n), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kw", [dict(bgr=True), dict(bgr=False, size=40),
                                dict(bgr=True, motion_aug=False,
                                     flip=False, size=(32, 48))])
def test_clip_dir_dataset_equals_jax(dataset_dirs, kw):
    _, want = dataset_dirs
    kw = dict(kw)
    bg = want["bgr"] if kw.pop("bgr") else None
    args = (want["fgr"], want["pha"])
    opts = dict(bgr_root=bg, clip_len=3, batch=2, seed=4, **kw)
    _equal_batches(tdataset.ClipDirDataset(*args, **opts).batches(),
                   jdataset.ClipDirDataset(*args, **opts).batches())


def test_dataset_adapters_equal_jax(dataset_dirs):
    _, want = dataset_dirs

    def make(mod):
        return mod.ClipDirDataset(want["fgr"], want["pha"], clip_len=2,
                                  batch=2, size=32, seed=9).batches()

    _equal_batches(tdataset.with_trimaps(make(tdataset)),
                   jdataset.with_trimaps(make(jdataset)), count=2)
    _equal_batches(tdataset.as_seg_batches(make(tdataset)),
                   jdataset.as_seg_batches(make(jdataset)), count=2)


def test_dataset_errors_as_jax(tmp_path, dataset_dirs):
    _, want = dataset_dirs
    with pytest.raises(FileNotFoundError):
        tdataset.ClipDirDataset(str(tmp_path / "missing"), want["pha"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no image frames"):
        tdataset.ClipDirDataset(str(tmp_path / "empty"), want["pha"])
