"""BMUF: block-wise model-update filtering (Chen & Huo, ICASSP'16).

Port of ``multimodalvc_tpu/parallel/bmuf.py`` (the reference's
``fairseq/optim/bmuf.py``): data-parallel workers run ``sync_every`` local
optimizer steps, then reconcile through a block-momentum update of a global
model.  At a sync point, with the workers' parameters x_i, the global model
g and the momentum buffer d:

    G  = mean_i(x_i) - g                      (block gradient)
    d' = bm * d + (1 - bm) * lr_b * G
    g' = g + d'                               (+ bm * d' under Nesterov)

and every worker restarts from the broadcast model.  Here it wraps any
optimizer of the port with ``update(grads, params)`` over f32 tensors
updated in place; the mean over the workers is an all-reduce over
``group`` (None: a single worker, the maths alone).  Nothing in the JAX
package calls it either.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


class BMUF:
    def __init__(self, inner, params: Dict[str, torch.Tensor], sync_every: int = 50,
                 block_momentum: float = 0.875, block_lr: float = 1.0,
                 use_nesterov: bool = True, group=None):
        self.inner = inner
        self.sync_every, self.block_momentum, self.block_lr = sync_every, block_momentum, block_lr
        self.use_nesterov, self.group = use_nesterov, group
        self.step = 0
        self.global_params = {n: p.detach().clone() for n, p in params.items()}
        self.delta = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> bool:
        """One local step of the inner optimizer; every ``sync_every``-th
        step the block-momentum sync.  Returns True (the parameters moved)."""
        self.inner.update(grads, params)
        self.step += 1
        if self.step % self.sync_every == 0:
            self._sync(params)
        return True

    def _sync(self, params: Dict[str, torch.Tensor]) -> None:
        bm, blr = self.block_momentum, self.block_lr
        world = dist.get_world_size(self.group) if self.group is not None else 1
        for n, p in params.items():
            avg = p.clone()
            if self.group is not None:
                dist.all_reduce(avg, group=self.group)
                avg /= world
            g, d = self.global_params[n], self.delta[n]
            d.copy_(bm * d + (1.0 - bm) * blr * (avg - g))
            g.add_(d)
            p.copy_(g + bm * d if self.use_nesterov else g)
