"""Collectives with derivatives, for the modules' distributed forms.

Each rank's loss enters the gradient with its share of the global loss
(``parallel/mesh.py``), so the adjoint of a collective whose output every
rank of a group holds is a **sum** over the group: an all-reduce's adjoint
is an all-reduce, an all-gather's a reduce-scatter, a ring shift's the
shift the other way.  The parameters' gradients are then summed over the
world as they are.

The tensor axis's four operators (Megatron's regions) follow Megatron's
convention instead: every rank of a tensor group holds the same loss, the
gradient of an activation that the group holds whole is the same on each
rank, and a split activation's gradient is its share of it.  Copy into the
region: identity forward, all-reduce backward; reduce out of it:
all-reduce forward, identity backward; gather along the last dim: its
adjoint takes the rank's slice; scatter (the slice): its adjoint is the
all-gather.  Each rank's loss still enters with 1 / ``replicas()``, which
counts the tensor ranks, so the gradient of a split leaf, summed over the
ranks that hold the same slice, comes out ``tensor`` times too small: the
trainers scale it back (``runtime/trainer.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient is summed back over it."""
    return _AllReduceSum.apply(x, group)


def _sizes(n: int, group, device) -> list:
    world = dist.get_world_size(group)
    mine = torch.tensor([n], dtype=torch.int64, device=device)
    out = torch.empty(world, dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(out, mine, group=group)
    return out.tolist()


class _AllGather(torch.autograd.Function):
    """Rank order along dim 0; the ranks' lengths may differ."""

    @staticmethod
    def forward(ctx, x, group):
        sizes = _sizes(x.shape[0], group, x.device)
        top = max(sizes)
        pad = x.new_zeros((top - x.shape[0],) + x.shape[1:])
        buf = torch.cat([x, pad]).contiguous() if top > x.shape[0] else x.contiguous()
        out = x.new_empty((len(sizes) * top,) + x.shape[1:])
        dist.all_gather_into_tensor(out, buf, group=group)
        ctx.group, ctx.sizes, ctx.rank = group, sizes, dist.get_rank(group)
        parts = out.split(top)
        return torch.cat([p[:n] for p, n in zip(parts, sizes)])

    @staticmethod
    def backward(ctx, g):
        sizes, top = ctx.sizes, max(ctx.sizes)
        parts = g.split(sizes)
        buf = torch.cat([torch.cat([p, p.new_zeros((top - n,) + p.shape[1:])]) if n < top else p
                         for p, n in zip(parts, sizes)]).contiguous()
        out = g.new_empty((top,) + g.shape[1:])
        dist.reduce_scatter_tensor(out, buf, group=ctx.group)
        return out[: sizes[ctx.rank]], None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (their
    lengths along ``dim`` may differ); the gradient of each rank's part is
    summed over the group and returned to it."""
    if dim == 0:
        return _AllGather.apply(x, group)
    return _AllGather.apply(x.movedim(dim, 0), group).movedim(0, dim)


def shard_of(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's equal share of ``x`` along ``dim`` (a view)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, to_rank, from_rank):
        ctx.group, ctx.to_rank, ctx.from_rank = group, to_rank, from_rank
        return _exchange(x.contiguous(), group, to_rank, from_rank)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group, ctx.from_rank, ctx.to_rank), None, None, None


def _exchange(x: torch.Tensor, group, to_rank: int, from_rank: int) -> torch.Tensor:
    y = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to_rank, group),
                                   dist.P2POp(dist.irecv, y, from_rank, group)])
    for r in reqs:
        r.wait()
    return y


def ring_shift(x: torch.Tensor, group, to_rank: int, from_rank: int) -> torch.Tensor:
    """Send ``x`` to global rank ``to_rank`` and return what ``from_rank``
    sent; the gradient travels back the other way."""
    return _RingShift.apply(x, group, to_rank, from_rank)


def flat_all_reduce_(tensors, group: Optional[object] = None) -> None:
    """Sum each tensor of ``tensors`` (same dtype and device) over ``group``
    in place, through one flat buffer."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


# ---- the tensor axis: Megatron's region operators --------------------------------


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    # a list all-gather: gloo takes it for CUDA tensors too (ranks sharing a card)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


def _slice_last(x: torch.Tensor, group) -> torch.Tensor:
    return shard_of(x, group, x.ndim - 1).contiguous()


def _all_reduced(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, taken in f32 for a narrower float type."""
    wide = x.dtype in (torch.bfloat16, torch.float16)
    y = x.float() if wide else x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype) if wide else y


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduced(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.group), None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def copy_to_tensor_region(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (whole on every rank of the tensor ``group``) entering a
    region of split activations: the identity; the gradient all-reduced."""
    return _CopyToRegion.apply(x, group)


def reduce_from_tensor_region(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial ``x`` summed over the tensor ``group``; the
    gradient passes as it is."""
    return _ReduceFromRegion.apply(x, group)


def gather_from_tensor_region(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' slices of the last dim concatenated in rank order; the
    gradient's slice returns to each rank."""
    return _GatherFromRegion.apply(x, group)


def scatter_to_tensor_region(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's equal slice of ``x``'s last dim; the gradients of the
    ranks' slices are gathered into the whole one on every rank."""
    return _ScatterToRegion.apply(x, group)
