"""The port's native staging tier (``vidmat_torch/io/native.py``,
``vidmat_torch/csrc/framestage.cpp``) against numpy and the JAX package's
own tier (``vidmat/io/native.py``) on the CPU: edge padding bit-equal to
``np.pad(..., mode="edge")`` on strided, ragged and exact-size frames, of
3 channels and of 4 (a frame carrying its trimap), a padded batch equal
to the JAX ``pad_stack``'s, and packed RGBA unpacked to the same
bytes."""

import numpy as np
import pytest

from vidmat_torch.io.native import pad_into, unpack_rgba
from vidmat_torch.io.reader import pad_frame

# (frame h, w, bucket h, w, how the frame is laid out)
PAD_CASES = [
    (1080, 1920, 1088, 1920, "contiguous"),   # the 1080p bucket
    (90, 150, 96, 160, "contiguous"),         # ragged on both axes
    (64, 96, 64, 96, "contiguous"),           # exact size: a copy
    (37, 53, 48, 64, "strided rows"),         # a crop of a wider frame
    (37, 53, 48, 64, "strided pixels"),       # every other pixel
    (1, 1, 16, 16, "contiguous"),             # one pixel fills the bucket
    (300, 17, 304, 32, "channel-last view"),  # a transposed array
    (1080, 1920, 1088, 1920, "4 channels"),   # RGB + trimap, 1080p bucket
    (37, 53, 48, 64, "4 channels, strided"),  # RGB + trimap, a crop
]


def _frame(h, w, layout, rng):
    if layout == "4 channels":
        return rng.randint(0, 256, (h, w, 4), np.uint8)
    if layout == "4 channels, strided":
        return rng.randint(0, 256, (h + 3, w + 11, 4), np.uint8)[2:2 + h,
                                                                 5:5 + w]
    if layout == "contiguous":
        return rng.randint(0, 256, (h, w, 3), np.uint8)
    if layout == "strided rows":
        return rng.randint(0, 256, (h, w + 11, 3), np.uint8)[:, 5:5 + w]
    if layout == "strided pixels":
        return rng.randint(0, 256, (h, 2 * w, 3), np.uint8)[:, ::2]
    return rng.randint(0, 256, (w, h, 3), np.uint8).transpose(1, 0, 2)


@pytest.mark.parametrize("case", PAD_CASES, ids=lambda c: f"{c[0]}x{c[1]}"
                         f"-{c[4].replace(' ', '_')}")
@pytest.mark.parametrize("dest", ["array", "chunk slot", "torch buffer"])
def test_pad_into_equals_numpy_edge_pad(case, dest):
    """Into a numpy array, into the middle slot of a (3, oh, ow, 3) chunk
    (its neighbours stay untouched) and into a torch buffer's view."""
    h, w, oh, ow, layout = case
    rng = np.random.RandomState(h * 7 + w)
    frame = _frame(h, w, layout, rng)
    c = 4 if layout.startswith("4 channels") else 3
    assert frame.shape == (h, w, c)
    if dest == "array":
        out = np.full((oh, ow, c), 7, np.uint8)
    elif dest == "chunk slot":
        chunk = np.full((3, oh, ow, c), 7, np.uint8)
        out = chunk[1]
    else:
        import torch

        out = torch.full((oh, ow, c), 7, dtype=torch.uint8).numpy()
    pad_into(frame, out)
    if dest == "chunk slot":
        assert (chunk[0] == 7).all() and (chunk[2] == 7).all()
    np.testing.assert_array_equal(out, pad_frame(frame, oh, ow)[0])
    np.testing.assert_array_equal(
        out, np.pad(frame, ((0, oh - h), (0, ow - w), (0, 0)), mode="edge"))


def test_pad_into_a_slot_of_a_chunk_equals_jax_pad_stack():
    """The pipeline pads each frame into slot i of a (K, h, w, 3) chunk;
    the chunk equals the JAX package's pad_stack of the same frames."""
    from vidmat.io.native import pad_stack

    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (90, 150, 3), np.uint8) for _ in range(4)]
    chunk = np.zeros((4, 96, 160, 3), np.uint8)
    for i, f in enumerate(frames):
        pad_into(f, chunk[i])
    np.testing.assert_array_equal(chunk, pad_stack(frames, 96, 160))


@pytest.mark.parametrize("c", [3, 4])
def test_pad_stack_equals_jax_pad_stack(c):
    """``pad_stack`` (a new (S, out_h, out_w, C) array, the JAX signature)
    equals the JAX package's on frames of 3 channels and of 4 (RGB and a
    trimap byte), one of them strided."""
    from vidmat.io.native import pad_stack as j_pad_stack

    from vidmat_torch.io.native import pad_stack

    rng = np.random.RandomState(c)
    frames = [rng.randint(0, 256, (90, 150, c), np.uint8) for _ in range(3)]
    frames.append(rng.randint(0, 256, (90, 170, c), np.uint8)[:, 7:157])
    got = pad_stack(frames, 96, 160)
    assert got.shape == (4, 96, 160, c) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, j_pad_stack(frames, 96, 160))


def test_pad_into_refuses_what_it_cannot_take():
    f = np.zeros((20, 20, 3), np.uint8)
    with pytest.raises(ValueError, match="cannot pad"):
        pad_into(f, np.zeros((16, 32, 3), np.uint8))  # frame taller
    with pytest.raises(ValueError, match="uint8"):
        pad_into(f.astype(np.float32), np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        pad_into(f, np.zeros((32, 64, 3), np.uint8)[:, ::2])
    with pytest.raises(ValueError):
        pad_into(np.zeros((20, 20, 4), np.uint8),
                 np.zeros((32, 32, 3), np.uint8))


@pytest.mark.parametrize("shape", [(1088, 1920), (37, 53), (1,), (4, 8, 8)])
def test_unpack_rgba_owned_bytes(shape):
    from vidmat.io.native import unpack_rgba as j_unpack

    rng = np.random.RandomState(1)
    packed = rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(
        np.uint32)
    got = unpack_rgba(packed)
    assert got.shape == (*shape, 4) and got.dtype == np.uint8
    assert got.flags.owndata
    np.testing.assert_array_equal(got, packed.view(np.uint8).reshape(
        *shape, 4))
    # R | G<<8 | B<<16 | A<<24
    np.testing.assert_array_equal(got[..., 3], (packed >> 24).astype(
        np.uint8))
    if len(shape) == 2:
        np.testing.assert_array_equal(got, j_unpack(packed))
    # A strided (cropped) view is unpacked as its own values.
    if len(shape) == 2 and shape[1] > 8:
        np.testing.assert_array_equal(unpack_rgba(packed[:, 3:-2]),
                                      got[:, 3:-2])
