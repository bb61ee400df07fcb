"""Collectives over the positions of a mesh that autograd follows (what
XLA inserts into the JAX package's sharded programs: the psum of the
gradients and of BatchNorm's batch statistics, the gather of the
outputs).

A process holds its positions' parts as a list of tensors, one a
position. In the process, a collective is device copies (``.to``) and a
sum or a concatenation, which autograd follows as it follows any op. In
a job of several processes (``mesh.initialize_distributed``) the
process's result then goes through ``torch.distributed`` (gloo for CPU
tensors, NCCL for CUDA ones), with a collective in the forward and, where
the gradient needs one, in the backward, as SyncBatchNorm does.

Both collectives assume what a sharded step is: each process runs the
same program on its own rows, and the loss is computed alike on every
process from the gathered outputs (it is replicated).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from vidmat_torch.parallel.mesh import process_count_and_index


class _AllReduce(torch.autograd.Function):
    """The sum over processes. Each process uses the sum for its own
    positions' work only, so the gradient that reaches it is that
    process's part: the backward sums the parts."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


class _AllGather(torch.autograd.Function):
    """The processes' equal-sized parts concatenated along ``dim`` in
    process order. The loss is replicated, so every process holds the
    whole gradient of the result: the backward returns this process's
    slice of it. (A backward that reduce-scatters, as
    ``torch.distributed.nn.functional.all_gather`` does, would multiply
    the gradient by the number of processes.)"""

    @staticmethod
    def forward(ctx, x, dim):
        import torch.distributed as dist

        nproc, rank = process_count_and_index()
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(nproc)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None


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


def gather(parts: Sequence[torch.Tensor], dim: int,
           device) -> torch.Tensor:
    """``parts`` (this process's positions' tensors, in position order)
    concatenated along ``dim`` on ``device``, then the processes' results
    along ``dim`` in process order (each process must give the same
    shape). Every process gets the whole tensor."""
    out = (parts[0].to(device) if len(parts) == 1
           else torch.cat([p.to(device) for p in parts], dim))
    if process_count_and_index()[0] > 1:
        out = _AllGather.apply(out, dim)
    return out


def sum_over_processes(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the processes of the job (one all-reduce
    of their concatenation; no gradient): the step's parameter
    gradients. The tensors themselves at one process."""
    if process_count_and_index()[0] == 1:
        return tensors
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out
