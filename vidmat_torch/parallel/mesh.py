"""Device meshes and their positions (counterpart of
vidmat/parallel/mesh.py).

A ``Mesh`` is an array of devices with a name per axis, as a JAX mesh is:
'stream' for independent video streams (``MultiStreamMatting(mesh=)``),
'pp' for the two stages of a pipelined stream (``parallel/pp.py``).

A position of a mesh may repeat a device, as the JAX package's tests mesh
the virtual CPU devices of one host: ``make_mesh(("pp",),
devices=["cuda:0"] * 2)`` gives two positions on one card, and
``["cpu"] * 4`` four on the CPU. Each position of a serving class runs
its work under its own ``Position``: its device and, on CUDA, its own
stream, so the work of two positions on one card may overlap, and the
work of positions on several cards runs on each card. The kernel
wrappers launch on the current stream of the current device, which
``Position.active`` sets.

'data' and 'spatial' are the axes of sharded training
(``vidmat_torch/train/loop.py``, ``parallel/spatial.py``). A mesh may
span processes: after ``initialize_distributed``, ``make_mesh(...,
devices=<this process's devices>)`` builds the job's global mesh, its
positions ordered by process and then by local index (as
``jax.devices()`` orders them). Each process knows its own devices only:
the other processes' positions hold None in ``devices``, and
``process_ids`` / ``local`` say which positions are whose.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vidmat_torch._device import resolve_device


class Mesh:
    """Devices shaped like the mesh, one name per axis.

    ``devices``: a numpy object array of ``torch.device`` (None at a
    position of another process); ``shape``: {axis name: size}, in axis
    order; ``size``: the number of positions; ``process_ids``: the
    process of each position (all 0 in a job of one process);
    ``process_index``: this process's."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_ids=None, process_index: int = 0):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-axis device array needs "
                             f"{devices.ndim} axis names; got "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_ids = (np.zeros(devices.shape, int)
                            if process_ids is None
                            else np.asarray(process_ids, int).reshape(
                                devices.shape))
        self.process_index = process_index

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_count(self) -> int:
        return int(self.process_ids.max()) + 1

    @property
    def local(self) -> np.ndarray:
        """True at this process's positions (shaped like the mesh)."""
        return self.process_ids == self.process_index

    def local_devices(self) -> list:
        """This process's devices, in position order."""
        return list(self.devices[self.local])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def process_count_and_index() -> Tuple[int, int]:
    """(processes in the job, this one's index): (1, 0) unless
    ``initialize_distributed`` joined a job of several."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(axis_names: Sequence[str] = ("stream",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card): in a job of
    several processes, this process's devices, and the mesh is the job's.

    shape None puts every position on the first axis and 1 on the
    others; otherwise its product must be the number of positions, the
    processes times the devices each passes (ValueError, as in the JAX
    package). A device may repeat (several positions on one device); CPU
    and CUDA devices do not mix."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError(
                "no CUDA device is visible; pass devices=, e.g. "
                "['cpu'] * 2 to mesh positions on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    if len({torch.device(d).type for d in devices}) > 1:
        raise ValueError(f"a mesh takes CPU or CUDA devices, not both; got "
                         f"{[str(d) for d in devices]}")
    devices = [_device(d) for d in devices]
    nproc, rank = process_count_and_index()
    local = len(devices)
    n = nproc * local
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    if int(math.prod(shape)) != n:
        per = f" ({nproc} processes x {local})" if nproc > 1 else ""
        raise ValueError(f"mesh shape {list(shape)} != {n} devices{per}")
    dev_array = np.empty(n, dtype=object)
    dev_array[rank * local:(rank + 1) * local] = devices
    return Mesh(dev_array.reshape(tuple(shape)), axis_names,
                np.repeat(np.arange(nproc), local), rank)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join a job of several processes (``torch.distributed``): a no-op at
    one process or fewer; else ``init_process_group`` at ``coordinator``
    ("host:port" or a URL such as "tcp://localhost:port") as process
    ``process_id`` of ``num_processes``: gloo for CPU tensors and, where a
    card is visible, NCCL for CUDA tensors (so a mesh of CPU positions
    works on a machine with a card too)."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if coordinator is None:
        raise ValueError("several processes need the coordinator's "
                         "address, e.g. 'localhost:29500'")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if torch.cuda.is_available()
        else "gloo",
        init_method=url, world_size=num_processes, rank=process_id)


def kernel_launches() -> dict:
    """{wrapper name: launches so far} of every kernel wrapper."""
    from vidmat_torch.pipeline.graph import kernel_wrappers

    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


class Position:
    """One position of a mesh: its device, its own stream on CUDA (None
    on the CPU, or with ``own_stream=False``: the caller's current
    stream), and ``launches``, {wrapper name: launches} made under
    ``active`` (the wrappers count for the whole process, so a position
    counts by difference)."""

    def __init__(self, device, own_stream: bool = True):
        self.device = _device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if own_stream and self.device.type == "cuda"
                       else None)
        self.launches = collections.Counter()

    @contextlib.contextmanager
    def active(self):
        """The scope of this position's work: its device and stream
        current, its launches counted."""
        before = kernel_launches()
        try:
            if self.stream is None:
                yield
            else:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self.stream):
                    yield
        finally:
            for name, n in kernel_launches().items():
                if n != before[name]:
                    self.launches[name] += n - before[name]

    def event(self) -> Optional[torch.cuda.Event]:
        """An event recorded on this position's stream now (None on the
        CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream if self.stream is not None
                  else torch.cuda.current_stream(self.device))
        return ev

    def wait(self, event: Optional[torch.cuda.Event]) -> None:
        """Make this position's later work wait for ``event``."""
        if event is not None:
            (self.stream if self.stream is not None
             else torch.cuda.current_stream(self.device)).wait_event(event)

    def follow_current(self, device) -> None:
        """Make this position's later work wait for the work enqueued so
        far on the current stream of ``device`` (the caller's)."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def join(self) -> None:
        """Make the current stream of this position's device wait for the
        work enqueued so far on this position's stream."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def hand_over(self, tensors):
        """Tensors this position made, read next on the current streams
        of their devices: recorded there, so that the caching allocator
        reuses none of them before that work is done."""
        if self.stream is not None:
            for t in tensors:
                t.record_stream(torch.cuda.current_stream(t.device))
        return tensors
