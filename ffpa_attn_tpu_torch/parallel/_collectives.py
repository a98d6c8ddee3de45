"""Collectives under autograd, and the one transport rule.

Every sharded function here runs the same program on each rank of a
process group (SPMD), as the JAX package's ``shard_map`` bodies do; the
collectives that ``shard_map`` and ``jax.grad`` place there are explicit:

* ``shard`` / ``gather``: the boundary of a whole-tensor entry. Every rank
  holds the global tensor; ``shard`` keeps the rank's slice (its backward
  all-gathers the slices' gradients, so each rank ends with the whole
  gradient) and ``gather`` all-gathers the ranks' outputs (its backward
  keeps the rank's slice: every rank computes the same loss from the
  gathered output).
* ``copy_to`` (identity, all-reduce of the gradient) and ``reduce_from``
  (all-reduce, identity gradient): Megatron's pair around a tensor-parallel
  region, and the replicated operands of a sharded region (sinks), whose
  gradient is the sum of the ranks' parts.
* ``all_to_all``: the Ulysses re-shard, whose backward is the inverse
  re-shard.

``point_to_point_staged`` is the transport rule: gloo fails a
point-to-point send of a CUDA tensor (``writev ... Bad address``, raised or
aborting the process: two ranks on one H100, torch 2.11), so sends and
receives over a gloo group go through pinned host memory; every other
collective here takes the CUDA tensor itself (``chip_smoke.py``'s
``_par_probe`` holds each on the card), and NCCL takes everything on the
device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def point_to_point_staged(group, x: torch.Tensor) -> bool:
    """Whether a send / receive of ``x`` over ``group`` goes through
    pinned host memory (a CUDA tensor over gloo)."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def transport(group) -> str:
    """The backend and how a rotation's bytes move, for logs."""
    backend = dist.get_backend(group)
    return f"{backend}, " + ("CUDA tensors staged through pinned host memory for "
                             "send / recv" if backend == "gloo" else "device tensors")


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _local_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(g, ctx.dim, ctx.group), None, None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def shard(x, dim: int, group):
    """The rank's slice of ``x`` along ``dim`` (equal slices, rank order)."""
    return x if group is None else _Shard.apply(x, dim, group)


def gather(x, dim: int, group):
    """The ranks' slices of ``dim`` concatenated in rank order."""
    return x if group is None else _Gather.apply(x, dim, group)


def copy_to(x, group):
    """``x`` unchanged; its gradient summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """``x`` summed over ``group``; its gradient passed through."""
    return x if group is None else _ReduceFrom.apply(x, group)


def _a2a(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)``: ``x`` cut along ``split`` into n blocks, block j sent to
    rank j, the n blocks received concatenated along ``concat`` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} of size {x.shape[split]} over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.split, ctx.concat, ctx.group = split, concat, group
        return _a2a(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.concat, ctx.split, ctx.group), None, None, None


def all_to_all(x, split: int, concat: int, group):
    return _AllToAll.apply(x, split, concat, group)
