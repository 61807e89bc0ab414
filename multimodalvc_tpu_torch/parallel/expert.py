"""Expert-parallel BASE-style layer: balanced token -> expert routing.

Port of ``multimodalvc_tpu/parallel/expert.py`` (the reference's
``fairseq/modules/base_layer.py`` with Sinkhorn in place of the host
auction): scores = tokens @ expert_centroids, Sinkhorn-balanced, each token
to its argmax expert under the plan with a per-expert capacity
ceil(N / E) * capacity_factor; overflow tokens pass through; the softmax
gate of the chosen expert mixes the expert's output with the token.

The JAX layer routes over the **global** token set (GSPMD computes it over
the whole batch).  On a mesh the batch group's tokens are all-gathered in
rank order, so the Sinkhorn sums, the capacity and its positions run over
every token of the global batch, rank 0's first; each rank keeps its own
rows of the result.  On the expert axis each rank runs its E / expert
experts over the dispatched buffer and the experts' outputs are gathered.
The weights keep the flax names and layouts (``expert_centroids`` [D, E],
``experts_w1`` [E, D, F], ``experts_w2`` [E, F, D]), so the weight bridge
moves them as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import all_gather
from .mesh import BATCH_AXES, active_mesh


def sinkhorn_route(scores: torch.Tensor, n_iters: int = 8) -> torch.Tensor:
    """Balanced soft assignment: [T, E] affinities -> [T, E] transport plan
    (rows sum to 1, columns to T / E), in the log domain."""
    t, e = scores.shape
    log_p = scores - torch.logsumexp(scores, dim=1, keepdim=True)
    log_te = torch.log(torch.tensor(t / e, dtype=scores.dtype, device=scores.device))
    for _ in range(n_iters):
        log_p = log_p - torch.logsumexp(log_p, dim=0, keepdim=True) + log_te
        log_p = log_p - torch.logsumexp(log_p, dim=1, keepdim=True)
    return torch.exp(log_p)


class BaseMoELayer(nn.Module):
    """Token-routed expert FFN bank (exact GELU) with capacity-balanced
    dispatch.  ``load`` holds the last forward's tokens taken by each expert
    and its overflowed tokens (over the global token set)."""

    def __init__(self, d: int, num_experts: int, ffn_dim: int, capacity_factor: float = 1.25,
                 sinkhorn_iters: int = 8, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.sinkhorn_iters = sinkhorn_iters
        self.expert_centroids = nn.Parameter(torch.empty(d, num_experts, **kw))
        self.experts_w1 = nn.Parameter(torch.empty(num_experts, d, ffn_dim, **kw))
        self.experts_w2 = nn.Parameter(torch.empty(num_experts, ffn_dim, d, **kw))
        self.load: Optional[dict] = None

    def _experts(self, buf: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        w1 = self.experts_w1[lo:hi].to(buf.dtype)
        w2 = self.experts_w2[lo:hi].to(buf.dtype)
        h = F.gelu(torch.einsum("ecd,edf->ecf", buf, w1))
        return torch.einsum("ecf,efd->ecd", h, w2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        e = self.num_experts
        tokens = mine = x.reshape(b * t, d)
        mesh = active_mesh()
        spread = mesh is not None and mesh.size(*BATCH_AXES) > 1
        if spread:
            group = mesh.group(*BATCH_AXES)
            tokens = all_gather(mine, group)
            sizes = torch.tensor([mine.shape[0]], device=x.device)
            before = all_gather(sizes, group)[: mesh.index(*BATCH_AXES)].sum()
        n = tokens.shape[0]
        cap = max(int(-(-n // e) * self.capacity_factor), 1)

        scores = (tokens @ self.expert_centroids.to(tokens.dtype)).float()
        plan = sinkhorn_route(scores, self.sinkhorn_iters)
        idx = plan.argmax(dim=1)
        gate = torch.softmax(scores, dim=1).gather(1, idx[:, None])[:, 0]
        onehot = F.one_hot(idx, e).to(torch.int32)
        pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=1) - 1
        keep = pos < cap
        flat_slot = torch.where(keep, idx * cap + pos, torch.full_like(pos, e * cap))
        buf = tokens.new_zeros((e * cap + 1, d)).index_put((flat_slot,), tokens)
        buf = buf[:-1].reshape(e, cap, d)

        n_expert = mesh.size("expert") if mesh is not None else 1
        if n_expert > 1 and e % n_expert == 0:
            per = e // n_expert
            lo = mesh.coords["expert"] * per
            h = all_gather(self._experts(buf[lo:lo + per], lo, lo + per), mesh.group("expert"))
        else:
            h = self._experts(buf, 0, e)
        out = h.reshape(e * cap, d)
        picked = torch.where(keep[:, None], out[flat_slot.clamp(max=e * cap - 1)], tokens)
        g = gate[:, None].to(picked.dtype)
        mixed = picked * g + tokens * (1.0 - g)
        with torch.no_grad():
            self.load = {"tokens": torch.bincount(torch.where(keep, idx, e),
                                                  minlength=e + 1)[:e],
                         "overflow": (~keep).sum()}
        if spread:
            mixed = mixed.narrow(0, int(before), mine.shape[0])
        return mixed.reshape(b, t, d)
