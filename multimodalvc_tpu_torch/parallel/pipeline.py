"""GPipe pipeline parallelism over the mesh "pipeline" axis.

Port of ``multimodalvc_tpu/parallel/pipeline.py``.  The JAX version stacks
the stages' parameters on a leading axis and runs the (M + P - 1)-step
schedule in one ``shard_map`` program, rotating activations with
``ppermute``.  Here each rank is one stage, and the schedule is written out:
at step k stage s runs microbatch k - s, receiving it from stage s - 1 and
sending its output to stage s + 1; the last stage's outputs are then
broadcast to every stage (the JAX ``psum``).  The backward runs the schedule
in reverse inside the same ``autograd.Function``: each stage takes its
output's gradient from the next stage (the last stage: the broadcast's
adjoint, the stages' cotangents summed), back-propagates through its
microbatch and sends its input's gradient to the previous stage.  The
gradients of the stage's parameters are returned as the Function's, so
they reach the trainer as any other.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, mesh: Mesh, axis: str, x, *params):
        n_stages, stage = mesh.size(axis), mesh.coords[axis]
        m = x.shape[0]
        group = mesh.group(axis)
        prev = mesh.rank_of(**{axis: stage - 1}) if stage > 0 else None
        nxt = mesh.rank_of(**{axis: stage + 1}) if stage < n_stages - 1 else None
        last = mesh.rank_of(**{axis: n_stages - 1})
        grad = any(ctx.needs_input_grad[3:])
        ins: List[Optional[torch.Tensor]] = [None] * m
        outs: List[Optional[torch.Tensor]] = [None] * m
        result = torch.empty_like(x)
        with torch.enable_grad():
            for step in range(m + n_stages - 1):
                mb = step - stage
                if not 0 <= mb < m:
                    continue  # the bubble
                if prev is None:
                    h = x[mb].detach()
                else:
                    h = torch.empty_like(x[mb])
                    dist.recv(h, src=prev, group=group)
                h.requires_grad_(grad)
                y = stage_fn(h, mb)
                if nxt is not None:
                    dist.send(y.detach().contiguous(), dst=nxt, group=group)
                else:
                    result[mb] = y.detach()
                ins[mb], outs[mb] = h, y
        dist.broadcast(result, src=last, group=group)
        ctx.stage_fn, ctx.group, ctx.prev, ctx.nxt, ctx.last = stage_fn, group, prev, nxt, last
        ctx.n_stages, ctx.stage, ctx.ins, ctx.outs, ctx.params = n_stages, stage, ins, outs, params
        return result

    @staticmethod
    def backward(ctx, g):
        m = len(ctx.ins)
        g = g.contiguous().clone()
        # the broadcast's adjoint: every stage's cotangent, summed at the last
        dist.reduce(g, dst=ctx.last, group=ctx.group)
        params = ctx.params
        d_params = [torch.zeros_like(p) for p in params]
        d_x = torch.zeros_like(g)
        for step in range(m + ctx.n_stages - 1):
            mb = m - 1 - (step - (ctx.n_stages - 1 - ctx.stage))
            if not 0 <= mb < m:
                continue
            if ctx.nxt is None:
                gy = g[mb]
            else:
                gy = torch.empty_like(g[mb])
                dist.recv(gy, src=ctx.nxt, group=ctx.group)
            got = torch.autograd.grad(ctx.outs[mb], [ctx.ins[mb], *params], gy,
                                      allow_unused=True)
            for acc, dp in zip(d_params, got[1:]):
                if dp is not None:
                    acc.add_(dp)
            gx = got[0] if got[0] is not None else torch.zeros_like(gy)
            if ctx.prev is not None:
                dist.send(gx.contiguous(), dst=ctx.prev, group=ctx.group)
            else:
                d_x[mb] = gx
            ctx.ins[mb] = ctx.outs[mb] = None
        return (None, None, None, d_x, *d_params)


def pipeline_apply(stage_fn: Callable, params, x: torch.Tensor, mesh: Optional[Mesh],
                   axis: str = "pipeline") -> torch.Tensor:
    """Run ``x`` [M, mb, ...] through the P chained stages; returns the last
    stage's [M, mb, ...] outputs on every stage.

    ``stage_fn(h, mb) -> h`` runs this rank's stage on microbatch ``mb``
    (shape-preserving; per-microbatch side inputs ride in its closure);
    ``params`` are the stage's trainable tensors, whose gradients the
    backward returns.  M >= P keeps the bubble at (P - 1) / (M + P - 1).
    Without a mesh, or with one stage, the stage runs the microbatches in
    turn."""
    if mesh is None or not mesh.distributed or mesh.size(axis) == 1:
        return torch.stack([stage_fn(x[mb], mb) for mb in range(x.shape[0])])
    return _Pipeline.apply(stage_fn, mesh, axis, x, *params)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    assert b % n_microbatches == 0, (b, n_microbatches)
    return x.reshape((n_microbatches, b // n_microbatches) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))
