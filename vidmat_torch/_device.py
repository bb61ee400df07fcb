"""Device resolution, the float32 scope shared by the port's public entry
points, and the per-device constants of its bodies."""

from __future__ import annotations

import contextlib
import functools
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to ``"cuda"`` and raise when no CUDA device is
    present: a run that silently fell back to the CPU would report CPU
    numbers as the port's. Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels on the CPU (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls in full float32 for the scope.

    PyTorch's default lets cuDNN run float32 convolutions in TF32
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; the JAX package pins float32
    (``jax.default_matmul_precision("float32")``). The port's fp32 paths
    (the session's parity mode, fp32 serving bodies, ``matte_image``) run
    inside this scope, which sets both switches off and restores them on
    exit: the process-wide flags are left as the caller set them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = prev


def in_full_fp32(fn):
    """``fn`` with every call inside ``full_fp32``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_fp32():
            return fn(*args, **kwargs)
    return wrapped


def device_constant(fn):
    """A cache for the tensors a module makes once per device (a
    host-to-device copy inside a captured CUDA graph is not allowed),
    keyed by the arguments. While ``torch.export`` traces a body a
    cached tensor is read (it becomes a constant of the program) but none
    is stored: a tensor made there is the trace's own. ``deploy.py`` runs
    a body once before it exports it, so that every constant is cached:
    a ``torch.cond`` branch cannot hold a tensor made in the trace."""
    cache = {}

    @functools.wraps(fn)
    def get(*args):
        if args in cache:
            return cache[args]
        t = fn(*args)
        if not torch.compiler.is_compiling():
            cache[args] = t
        return t
    return get
