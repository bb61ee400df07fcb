"""The port's native host staging tier (counterpart of vidmat/io/native.py).

``csrc/framestage.cpp`` is host C++ with a plain C interface, compiled
with ``g++ -O3 -fopenmp`` at first use into ``vidmat_torch/build/`` and
loaded with ``ctypes`` (which releases the GIL for each call), as
``ops/_build.py`` loads the kernels. The library's name carries a hash of
the source and the flags. There is no numpy fallback: a failed build
raises (``have_native`` says whether it loads). ``pad_stack`` pads a
batch of frames into a new array.
``pad_frame`` (``io/reader.py``) is the numpy version the tests
hold ``pad_into`` to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Sequence

import numpy as np

from vidmat_torch.ops._build import BUILD_DIR, CSRC_DIR
from vidmat_torch.utils.profiling import spanned

SOURCE = os.path.join(CSRC_DIR, "framestage.cpp")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def library_path() -> str:
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"framestage-{h.hexdigest()[:12]}.so")


@functools.lru_cache(maxsize=None)
@spanned("kernel_load")
def _lib() -> ctypes.CDLL:
    """The bound library, built on first use; raises with the compiler's
    output when the build fails."""
    path = library_path()
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.vm_pad_into.restype = _I
    lib.vm_pad_into.argtypes = [_P, _I64, _I64, _I64, _I64, _I64, _P, _I64,
                                _I64, _I]
    lib.vm_unpack_rgba.restype = _I
    lib.vm_unpack_rgba.argtypes = [_P, _I64, _P]
    return lib


def have_native() -> bool:
    """True when the staging library builds and loads (the port has no
    numpy fallback: without it the staging calls raise)."""
    try:
        _lib()
    except (OSError, RuntimeError):
        return False
    return True


@spanned("pad")
def pad_into(frame: np.ndarray, out: np.ndarray, threads: int = 0) -> None:
    """Edge-pad an (H, W, C) uint8 frame, C = 3 or 4 (RGB and a trimap
    byte; any strides with a 1-byte channel step), at the bottom and right
    into ``out``, a C-contiguous (out_h, out_w, C) uint8 buffer with
    out_h >= H and out_w >= W, as ``np.pad(frame, ..., mode="edge")``
    does. Rows are split over up to ``threads`` OpenMP threads (0: up to
    4, fewer on a smaller host)."""
    if (frame.dtype != np.uint8 or frame.ndim != 3
            or frame.shape[2] not in (3, 4) or frame.strides[2] != 1):
        raise ValueError("frame must be (H, W, 3 or 4) uint8 with "
                         f"contiguous channels; got {frame.dtype} "
                         f"{frame.shape}")
    c = frame.shape[2]
    if (out.dtype != np.uint8 or out.ndim != 3 or out.shape[2] != c
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError("out must be a writable C-contiguous "
                         f"(out_h, out_w, {c}) uint8 array")
    h, w = frame.shape[:2]
    if threads < 0:
        raise ValueError(f"threads must be >= 0; got {threads}")
    err = _lib().vm_pad_into(frame.ctypes.data, h, w, c, frame.strides[0],
                             frame.strides[1], out.ctypes.data,
                             out.shape[0], out.shape[1], threads)
    if err:
        raise ValueError(f"cannot pad a {h}x{w} frame into "
                         f"{out.shape[0]}x{out.shape[1]}")


def pad_stack(frames: Sequence[np.ndarray], out_h: int, out_w: int,
              threads: int = 0) -> np.ndarray:
    """Edge-pad S (H, W, C) uint8 frames (C = 3 or 4) at the bottom and
    right and stack them: a new C-contiguous (S, out_h, out_w, C) array
    (vidmat/io/native.py ``pad_stack``), each slot filled by
    ``pad_into`` on up to ``threads`` threads (0: its default). A caller
    with a batch buffer of its own (a pinned slot) calls ``pad_into`` on
    its slots instead."""
    out = np.empty((len(frames), out_h, out_w, frames[0].shape[-1]),
                   np.uint8)
    for f, slot in zip(frames, out):
        pad_into(f, slot, threads)
    return out


@spanned("unpack")
def unpack_rgba(packed: np.ndarray, out: np.ndarray = None) -> np.ndarray:
    """(...) uint32 packed RGBA -> an owned (..., 4) uint8 copy, or into
    ``out`` (a C-contiguous (..., 4) uint8 array, returned)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    if out is None:
        out = np.empty((*packed.shape, 4), np.uint8)
    elif (out.shape != (*packed.shape, 4) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous {(*packed.shape, 4)} "
                         f"uint8 array; got {out.shape} {out.dtype}")
    _lib().vm_unpack_rgba(packed.ctypes.data, packed.size, out.ctypes.data)
    return out
