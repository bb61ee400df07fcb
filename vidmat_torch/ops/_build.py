"""Build and bind the port's CUDA kernels.

Each source in ``vidmat_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, at
first use, and loaded with ``ctypes``. The library's name carries a hash of
the source, the shared headers and the flags, so an edited source is
rebuilt and a stale library is never loaded. Outputs go to
``vidmat_torch/build/`` (ignored by git); the ``-Xptxas -v`` report of each build (registers, shared memory,
spills) is kept beside it as ``<name>.log``.

Only sources in this package are built. Nothing here runs at import time:
the CPU tests import every module of the port on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

from vidmat_torch.utils.profiling import annotate

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: kernel library name -> source file in csrc/
SOURCES = {
    "ingest": "ingest.cu",
    "gf_coeffs": "gf_coeffs.cu",
    "refine_composite": "refine_composite.cu",
    "refine_float": "refine_float.cu",
    "composite": "composite.cu",
    "planar_conv": "planar_conv.cu",
    "planar_conv2": "planar_conv2.cu",
    "planar_gru": "planar_gru.cu",
    "int8_conv": "int8_conv.cu",
}

#: headers in csrc/ the sources include; part of every library's hash
HEADERS = ("planar_common.cuh", "planar_mma.cuh", "refine_common.cuh")

# --fmad=false: every a*b+c is two IEEE-rounded operations, as in the plain
# PyTorch versions (separate kernels) and the JAX reference. Division and
# square root stay IEEE (no fast-math).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc (PyTorch's own lookup), else
    ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of vidmat_torch "
                           "need the CUDA toolkit")
    return found


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    h = hashlib.sha1()
    for path in (src, *(os.path.join(CSRC_DIR, x) for x in HEADERS)):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns
    {name: library path}; raises with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n in names:
        if os.path.isfile(paths[n]):
            continue
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{n}.log"), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{out}")
            continue
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The bound library of one kernel, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with annotate("kernel_load"):
            lib = ctypes.CDLL(build([name])[name])
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")
