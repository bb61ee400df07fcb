"""Collectives over the positions of a mesh that autograd follows (what
XLA inserts into the JAX package's sharded programs: the psum of the
gradients and of BatchNorm's batch statistics, the gather of the
outputs, the halo exchanges of a width split across hosts).

A process holds its positions' parts as a list of tensors, one a
position. In the process, a collective is device copies (``.to``) and a
sum or a concatenation, which autograd follows as it follows any op. In
a job of several processes (``mesh.initialize_distributed``) the
process's result then goes through ``torch.distributed``, with a
collective in the forward and, where the gradient needs one, in the
backward, as SyncBatchNorm does. ``initialize_distributed`` carries CPU
tensors over gloo and CUDA tensors over NCCL; in a job whose group has
no NCCL backend (gloo alone, e.g. two processes on one card, which NCCL
refuses) CUDA tensors go through the host (``_wire``).

Both collectives assume what a sharded step is: each process runs the
same program on its own rows, and the loss is computed alike on every
process from the gathered outputs (it is replicated).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from vidmat_torch.parallel.mesh import process_count_and_index


@functools.lru_cache(maxsize=None)
def _nccl() -> bool:
    """Whether the job's group carries CUDA tensors over NCCL."""
    import torch.distributed as dist

    return "nccl" in str(dist.get_backend_config()).lower()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as the job's group carries it: a contiguous copy, on the host
    where x is a CUDA tensor and the group has no NCCL backend."""
    if x.device.type == "cuda" and not _nccl():
        return x.detach().to("cpu", copy=True)
    return x.detach().contiguous().clone()


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    y = _wire(x)
    dist.all_reduce(y)
    return y.to(x.device)


class _AllReduce(torch.autograd.Function):
    """The sum over processes. Each process uses the sum for its own
    positions' work only, so the gradient that reaches it is that
    process's part: the backward sums the parts."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``parts`` (this process's positions' tensors) over every
    position of the job, on ``device``: the parts summed in list order,
    then over the processes. The result's uses on each process must be
    that process's own work (the backward sums the processes'
    gradients)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    if process_count_and_index()[0] > 1:
        total = _AllReduce.apply(total)
    return total


def all_gather_flat(x: torch.Tensor, sizes: Sequence[int]
                    ) -> List[torch.Tensor]:
    """Every process's 1-d buffer, on x's device (no gradient): this
    process passes x, of ``sizes[rank]`` elements, and ``sizes`` gives
    every process's (the same list on every process). The buffers are
    padded to the largest for one ``all_gather`` and trimmed after; where
    every size is 0, or in a job of one process, nothing is sent."""
    import torch.distributed as dist

    n = max(sizes)
    if n == 0:
        return [x.new_zeros(0) for _ in sizes]
    if len(sizes) == 1:
        return [x.reshape(-1)]
    wire = _wire(x.reshape(-1))
    padded = wire.new_zeros(n)
    padded[:wire.numel()] = wire
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded)
    return [p[:s].to(x.device) for p, s in zip(parts, sizes)]


def sum_over_processes(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the processes of the job (one all-reduce
    of their concatenation; no gradient): the step's parameter
    gradients. The tensors themselves at one process."""
    if process_count_and_index()[0] == 1:
        return tensors
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out
