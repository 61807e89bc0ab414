"""Collectives with derivatives, for the modules' distributed forms.

Each rank's loss enters the gradient with its share of the global loss
(``parallel/mesh.py``), so the adjoint of a collective whose output every
rank of a group holds is a **sum** over the group: an all-reduce's adjoint
is an all-reduce, an all-gather's a reduce-scatter, a ring shift's the
shift the other way.  The parameters' gradients are then summed over the
world as they are.
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
