"""Trainer: the JAX trainer's masked optax chain over an ``nn.Module``.

Port of ``multimodalvc_tpu/runtime/trainer.py``, on one device or on a mesh
(below).  One ``train_step(batch)`` is the JAX trainer's compiled step,
eagerly:

- the loss and its gradient with respect to the trainable leaves only.  A
  leaf is frozen when one of the task's regexes matches its ``state_dict``
  name joined by "/" (the JAX tree path, so the JAX patterns apply
  unchanged), unless an always-train regex matches (``lora_``); frozen
  leaves get ``requires_grad=False``, the JAX ``stop_gradient``, so the
  backward computes no weight gradient for them;
- the optimizer as the JAX ``build_optimizer`` chains optax's transforms,
  over the trainable leaves: ``MultiSteps`` accumulation (the running mean of
  ``update_freq`` micro-steps; the inner optimizer runs once per update; the
  accumulator restarts from zero after every update, also a skipped one,
  where optax's keeps a NaN, 0 * NaN) of
  ``apply_if_finite`` (a step with a non-finite gradient is skipped: no
  update, the optimizer's count does not advance; more than 25 in a row
  raise, where optax would apply the non-finite update) of
  ``clip_by_global_norm`` -> the base optimizer -> the reduce-on-plateau
  scale.  The base optimizers are the eight of ``OptimizationConfig.optimizer``
  with the JAX trainer's arguments: ``adamw`` / ``adam`` (decoupled weight
  decay, scaled by the learning rate), ``adafactor`` (optax's defaults:
  factored second moments), ``lamb``, ``adagrad``, ``adamax``, ``nag``
  (Nesterov momentum 0.99) and ``sgd``;
- the eight learning-rate schedules as plain functions of the update count
  (``make_schedule``).

Dtypes: each trainable leaf keeps an f32 master copy in the trainer, as the
JAX trainer keeps f32 params; the optimizer updates the master and copies it,
cast, into the module's parameter, with which the module computes in its
own dtype (bf16 on the card, f32 in the CPU tests).  Frozen leaves stay in
the module's dtype.  Gradients are taken in the module's dtype and widened
to f32, except where the update is one multi-tensor pass (``adam`` /
``adamw`` over leaves on the card, ``ops/adamw.py``) and no mesh sums them:
that pass reads them in their dtype, the norm and the finite check come
from one pass of square sums, and the update writes the module's cast copy
itself where no leaf is fsdp-split.

``Optimizer`` is a plain optax alias (every leaf, a schedule of its own
update count, no clipping); ``AdamW`` (``optax.adamw``) is the optimizer of
the two GAN steps (``models/vocoder.py``, ``criterions/gan.py``);
``trainable_leaves`` gives them the same f32 masters of a module's trainable
leaves as ``Trainer``.  ``build_composite_optimizer`` routes leaves to such
optimizers by path regex.

On a mesh (``parallel/mesh.py``; one process a device) the step is the
JAX step on the concatenation of the batch group's batches: the loss
function divides by its global count (``batch_total``), each rank's loss
enters with the weight 1 / ``replicas()``, and the gradients are summed over
the world.  Every rank then makes the same decisions: the global grad norm
and its clip, the non-finite skip, the plateau metric (rank 0's).  Under
fsdp each rank keeps its share of the f32 masters and the optimizer state
of the leaves that ``parallel/sharding.py: param_specs`` splits (ZeRO-3
for the optimizer state): their gradients are reduce-scattered over fsdp,
the updated shares all-gathered into the module's whole weights; the
reductions over a whole leaf (adafactor's means and RMSs, lamb's norms) sum
the shares over the group (``Leaves``).  This changes memory, never the
numbers.  Which leaves fsdp splits, and along which dim, the JAX sharding
rules say (``parallel/sharding.py: param_specs``: the rule's dim where one
matches and fits, else the largest-dim fallback).

On a tensor axis the module holds only its slice of each leaf the rules
split (``parallel/tensor.py: split_tensor_parallel_``), and the trainer
keeps the master and the optimizer state of that slice (under fsdp too,
its fsdp share cut from the slice).  A split leaf's gradient is the
tensor group's share (Megatron's region operators): it is scaled by the
tensor size, which ``replicas()`` counts in the loss weight, and summed
over the ranks that hold the same slice only; the global grad norm, its
clip and the non-finite skip count each slice once, and adafactor's and
lamb's whole-leaf reductions sum over the tensor group too.  The trainable
leaves and the buffers start from rank 0's (after ``init_from_pt``, and in
``load_state_dict`` after a restore; a split leaf from the ranks of rank
0's tensor group, which took rank 0's whole leaf before the split);
``state_dict`` gathers the shares and slices, so a checkpoint written on
any mesh resumes on any other.  The GAN steps (``apply_gradients_`` with
``rows``) weight their row means and sum their gradients the same way.

Not ported: ``CompileGuard`` and buffer donation (XLA scaffolding).
"""
from __future__ import annotations

import contextlib
import logging
import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config.configs import OptimizationConfig
from ..ops.adamw import adamw_many_, f32 as _f32, square_sums_many
from ..parallel.collectives import flat_all_reduce_
from ..parallel.mesh import (
    AXIS_ORDER,
    Mesh,
    active_mesh,
    batch_total,
    dropout_seed,
    replicas,
    restore_generator_,
)
from ..parallel.sharding import param_specs
from ..parallel.tensor import (
    gather_dim,
    gather_whole,
    slice_dim,
    slice_of,
    tensor_dim,
    tensor_groups,
)
from .tracing import span

logger = logging.getLogger(__name__)

# apply_if_finite's limit: more consecutive non-finite steps than this raise
MAX_CONSECUTIVE_NONFINITE = 25


def path_str(name: str) -> str:
    """A ``state_dict`` name as the JAX tree path ("a.b.c" -> "a/b/c")."""
    return name.replace(".", "/")


def trainable_mask(names: Iterable[str], frozen_patterns: List[str],
                   always_train_patterns: Optional[List[str]] = None) -> Dict[str, bool]:
    """True = trainable, for each ``state_dict`` name.  A leaf is frozen if a
    frozen regex matches its path, unless an always-train regex does (the
    LoRA adapters inside the frozen LLaMA)."""
    regexes = [re.compile(p) for p in frozen_patterns]
    always = [re.compile(p) for p in (always_train_patterns or ["lora_"])]

    def decide(name: str) -> bool:
        p = path_str(name)
        if any(rx.search(p) for rx in always):
            return True
        return not any(rx.search(p) for rx in regexes)

    return {name: decide(name) for name in names}


def trainable_leaves(module: torch.nn.Module, frozen_patterns: List[str]):
    """(mask, params, masters) of ``module``: the ``trainable_mask`` of its
    parameters, each frozen one set to ``requires_grad=False`` (the JAX
    ``stop_gradient``: the backward computes no weight gradient for it), the
    trainable parameters by name, and an f32 master copy of each."""
    named = dict(module.named_parameters())
    mask = trainable_mask(named, frozen_patterns)
    for name, p in named.items():
        p.requires_grad_(mask[name])
    params = {n: p for n, p in named.items() if mask[n]}
    masters = {n: p.detach().float().clone() for n, p in params.items()}
    return mask, params, masters


def copy_masters_(params: Dict[str, torch.Tensor], masters: Dict[str, torch.Tensor]) -> None:
    """Each parameter takes its f32 master's value, cast to its dtype."""
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(masters[n])


# ---- the learning-rate schedules -----------------------------------------------


def _linear(init: float, end: float, steps: int, begin: int = 0) -> Callable[[int], float]:
    """optax ``polynomial_schedule`` with power 1 (``linear_schedule``)."""
    if steps <= 0:
        return lambda step: init

    def schedule(step):
        count = min(max(step - begin, 0), steps)
        return (init - end) * (1.0 - count / steps) + end

    return schedule


def make_schedule(cfg: OptimizationConfig) -> Callable[[int], float]:
    """The learning rate at update count ``step`` for ``cfg.lr_scheduler``:
    cosine, inverse_sqrt, tri_stage, polynomial, triangular, manual, fixed
    or reduce_lr_on_plateau (before the plateau scale), as the JAX trainer
    builds them."""
    lr, name = float(cfg.lr), cfg.lr_scheduler
    if name == "cosine":
        warm = max(cfg.warmup_updates, 1)
        decay = max(cfg.max_update, cfg.warmup_updates + 1) - warm
        alpha = 0.0 if lr == 0.0 else cfg.min_lr / lr
        warmup = _linear(0.0, lr, warm)

        def cosine(step):
            if step < warm:
                return warmup(step)
            count = min(step - warm, decay)
            return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay)) + alpha)

        return cosine
    if name == "inverse_sqrt":
        warm = max(cfg.warmup_updates, 1)

        def inverse_sqrt(step):
            step = max(step, 1)
            return lr * step / warm if step < warm else lr * math.sqrt(warm / step)

        return inverse_sqrt
    if name == "tri_stage":
        total = max(cfg.max_update, 1)
        if cfg.phase_ratio is not None:
            r = cfg.phase_ratio
            warm, hold, decay = max(int(r[0] * total), 1), max(int(r[1] * total), 0), \
                max(int(r[2] * total), 1)
        else:
            warm = max(cfg.warmup_updates, 1)
            hold = max(int(0.4 * total) - warm, 0)
            decay = max(total - warm - hold, 1)
        final_scale = max(cfg.min_lr / max(lr, 1e-12), 1e-8)

        def tri_stage(step):
            if step < warm:
                return lr * step / warm
            if step < warm + hold:
                return lr
            frac = min(max((step - warm - hold) / decay, 0.0), 1.0)
            return lr * math.exp(math.log(final_scale) * frac)

        return tri_stage
    if name == "polynomial":
        warm = cfg.warmup_updates
        if not warm:
            return _linear(lr, cfg.min_lr, max(cfg.max_update, 1))
        up, down = _linear(0.0, lr, warm), _linear(lr, cfg.min_lr, max(cfg.max_update - warm, 1))
        return lambda step: up(step) if step < warm else down(step - warm)
    if name == "triangular":
        period = max(cfg.lr_period_updates, 0) or 2 * max(cfg.warmup_updates, 1)
        half, shrink = period / 2.0, float(cfg.lr_shrink)

        def triangular(step):
            cycle = math.floor(step / period)
            peak = lr * shrink ** cycle
            tri = max(0.0, 1.0 - abs(step / half - 2.0 * (cycle + 1.0) + 1.0))
            return cfg.min_lr + max(peak - cfg.min_lr, 0.0) * tri

        return triangular
    if name == "manual":
        points = sorted((int(k), float(v)) for k, v in (cfg.lr_milestones or {}).items())
        values = [lr] + [v for _, v in points]
        return lambda step: values[sum(step >= b for b, _ in points)]
    if name == "fixed":
        return lambda step: lr
    if name == "reduce_lr_on_plateau":
        warm = max(cfg.warmup_updates, 0)
        return lambda step: lr if warm == 0 else lr * min(step / warm, 1.0)
    raise ValueError(f"unknown lr_scheduler {name}")


# ---- the optimizers ----------------------------------------------------------------


def host_numbers(values: Dict[str, Any]) -> Dict[str, Any]:
    """``values`` with each one-element tensor as a Python number (an int for
    an integer tensor, as ``.item()`` gives it), the tensors read from the
    device together: one synchronisation, not one a tensor."""
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    out = dict(values)
    if keys:
        read = torch.stack([values[k].detach().reshape(()).double() for k in keys]).tolist()
        for k, x in zip(keys, read):
            out[k] = x if values[k].is_floating_point() else int(x)
    return out


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum of every element's square."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def _moments(g, m, v, b1: float, b2: float) -> None:
    """Adam's moments in place: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v."""
    m.copy_((1.0 - b1) * g + b1 * m)
    v.copy_((1.0 - b2) * (g * g) + b2 * v)


def _finish_(p, u, step_size: float, scale: float) -> None:
    """p += u * step_size (* the plateau scale)."""
    u = u * step_size
    if scale != 1.0:
        u = u * scale
    p.add_(u)


class Leaves:
    """The layout of the leaves an optimizer updates: each leaf's whole
    shape, the dim along which fsdp splits it (absent: whole on this rank)
    and the group that splits it, the same for the tensor axis (``tdims``,
    ``tgroup``), and the names whose JAX layout is the reverse of the
    port's (``nn.Linear`` weights: torch [out, in], flax [in, out]).  The
    reductions over a whole leaf (adafactor's means and RMSs, lamb's norms)
    sum a split leaf's shares over the groups, so fsdp and tensor change
    memory, never the numbers."""

    def __init__(self, params: Dict[str, torch.Tensor], shapes=None, dims=None, group=None,
                 reversed_layout: Iterable[str] = (), tdims=None, tgroup=None):
        self.shapes = {n: tuple(p.shape) for n, p in params.items()} if shapes is None \
            else {n: tuple(s) for n, s in shapes.items()}
        self.dims = {n: d for n, d in (dims or {}).items() if d is not None}
        self.group = group
        self.tdims = {n: d for n, d in (tdims or {}).items() if d is not None}
        self.tgroup = tgroup
        self.reversed_layout = frozenset(reversed_layout)

    def dim(self, name: str) -> Optional[int]:
        return self.dims.get(name)

    def tdim(self, name: str) -> Optional[int]:
        return self.tdims.get(name)

    @property
    def split(self) -> bool:
        """Whether any leaf is split over a group."""
        return bool(self.dims or self.tdims)

    def total_(self, x: torch.Tensor, split: bool, tsplit: bool = False) -> torch.Tensor:
        """``x`` (a sum over a share) summed over the fsdp group where
        ``split`` and over the tensor group where ``tsplit``."""
        if split:
            dist.all_reduce(x, group=self.group)
        if tsplit:
            dist.all_reduce(x, group=self.tgroup)
        return x

    def square_sum(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The sum of the squares of the whole leaf ``name`` (``x`` its share)."""
        return self.total_((x * x).sum(), self.dim(name) is not None,
                           self.tdim(name) is not None)

    def mean(self, x: torch.Tensor, axis: int, split: Optional[int], size: int,
             keepdim: bool = False, tsplit: Optional[int] = None) -> torch.Tensor:
        """The mean over ``axis`` (of length ``size`` whole) of a tensor whose
        share ``x`` is split along ``split`` (fsdp) and ``tsplit`` (tensor):
        the sum over the share, summed over the group whose split dim is
        ``axis``, over ``size``."""
        return self.total_(x.sum(axis, keepdim=keepdim), split == axis, tsplit == axis) / size


class BaseOptimizer:
    """One of the optax aliases of the JAX ``build_optimizer`` over a dict of
    f32 leaves.  ``state`` holds its tensors by kind ({kind: {leaf: tensor}},
    the names optax gives them); ``apply_`` makes update number ``count``
    (from 1) at learning rate ``lr`` (the schedule's value for count - 1),
    times the plateau ``scale``, in place.  ``fused``: the update is one
    multi-tensor pass, which takes the gradients in any float dtype."""

    KINDS: tuple = ()
    fused = False

    def __init__(self, params: Dict[str, torch.Tensor], leaves: Leaves):
        self.leaves = leaves
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            kind: {n: torch.zeros_like(p) for n, p in params.items()} for kind in self.KINDS}

    def split_dim(self, kind: str, name: str) -> Optional[int]:
        """The dim along which fsdp splits ``state[kind][name]``."""
        return self.leaves.dim(name)

    def tensor_split_dim(self, kind: str, name: str) -> Optional[int]:
        """The dim along which the tensor axis splits ``state[kind][name]``."""
        return self.leaves.tdim(name)

    def apply_(self, params, grads, count: int, lr: float, scale: float = 1.0,
               norm: Optional[torch.Tensor] = None, clip: Optional[float] = None,
               copies: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """With ``norm`` (the gradients' global norm, a tensor) the gradients
        are first clipped to global norm ``clip``; with ``copies`` (the
        module's parameters) each then takes its leaf's value, cast."""
        if norm is not None:
            grads = {n: torch.where(norm < clip, g, (g / norm) * clip) for n, g in grads.items()}
        self._update_leaves(params, grads, count, lr, scale)
        if copies is not None:
            copy_masters_(copies, params)

    def _update_leaves(self, params, grads, count: int, lr: float, scale: float) -> None:
        raise NotImplementedError


class Adam(BaseOptimizer):
    """``optax.adamw`` (``weight_decay`` > 0) / ``optax.adam``: "mu", "nu".
    The clip, the update and the copies are one ``adamw_many_`` pass: a
    kernel launch for leaves on the card (``fused``), the per-leaf chain on
    the CPU."""

    KINDS = ("mu", "nu")

    def __init__(self, params, leaves, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        super().__init__(params, leaves)
        self.betas, self.eps, self.weight_decay = (b1, b2), eps, weight_decay
        self.fused = all(p.is_cuda for p in params.values())

    def apply_(self, params, grads, count, lr, scale=1.0, norm=None, clip=None, copies=None):
        names = list(params)
        mu, nu = self.state["mu"], self.state["nu"]
        adamw_many_([params[n] for n in names], [grads[n] for n in names],
                    [mu[n] for n in names], [nu[n] for n in names], count=count, lr=lr,
                    betas=self.betas, eps=self.eps, weight_decay=self.weight_decay, scale=scale,
                    norm=norm, clip=clip,
                    copies=None if copies is None else [copies[n] for n in names])


class Lamb(BaseOptimizer):
    """``optax.lamb``: Adam's direction ("mu", "nu"), plus the decayed
    weights, times the trust ratio ||p|| / ||u|| (1 where either is 0), times
    -lr."""

    KINDS = ("mu", "nu")

    def __init__(self, params, leaves, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0):
        super().__init__(params, leaves)
        self.b1, self.b2, self.eps, self.weight_decay = float(b1), float(b2), eps, weight_decay

    def _update_leaves(self, params, grads, count, lr, scale):
        bc1, bc2 = _f32(1.0 - self.b1 ** count), _f32(1.0 - self.b2 ** count)
        for name, p in params.items():
            m, v = self.state["mu"][name], self.state["nu"][name]
            _moments(grads[name], m, v, self.b1, self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p_norm = torch.sqrt(self.leaves.square_sum(p, name))
            u_norm = torch.sqrt(self.leaves.square_sum(u, name))
            ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            _finish_(p, u * ratio, -_f32(lr), scale)


class Adagrad(BaseOptimizer):
    """``optax.adagrad``: "sum_of_squares" from ``initial_accumulator_value``;
    the update g / sqrt(sum + eps) (0 where the sum is 0), times -lr."""

    KINDS = ("sum_of_squares",)

    def __init__(self, params, leaves, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, leaves)
        for t in self.state["sum_of_squares"].values():
            t.fill_(initial_accumulator_value)
        self.eps = eps

    def _update_leaves(self, params, grads, count, lr, scale):
        for name, p in params.items():
            g, s = grads[name], self.state["sum_of_squares"][name]
            s.copy_(g * g + s)
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s))
            _finish_(p, inv * g, -_f32(lr), scale)


class Adamax(BaseOptimizer):
    """``optax.adamax``: "mu" (bias-corrected) over "nu", the decayed
    maximum of |g| + eps, times -lr."""

    KINDS = ("mu", "nu")

    def __init__(self, params, leaves, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, leaves)
        self.b1, self.b2, self.eps = float(b1), float(b2), eps

    def _update_leaves(self, params, grads, count, lr, scale):
        bc1 = _f32(1.0 - self.b1 ** count)
        for name, p in params.items():
            g, m, v = grads[name], self.state["mu"][name], self.state["nu"][name]
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_(torch.maximum(g.abs() + self.eps, self.b2 * v))
            _finish_(p, (m / bc1) / v, -_f32(lr), scale)


class Sgd(BaseOptimizer):
    """``optax.sgd``: -lr g; with ``momentum`` a "trace" t = g + momentum t
    and the update t, or with ``nesterov`` g + momentum t (``nag``)."""

    def __init__(self, params, leaves, momentum: Optional[float] = None, nesterov=False):
        super().__init__(params, leaves)
        if momentum is not None:
            self.state["trace"] = {n: torch.zeros_like(p) for n, p in params.items()}
        self.momentum, self.nesterov = momentum, nesterov

    def _update_leaves(self, params, grads, count, lr, scale):
        for name, p in params.items():
            u = grads[name]
            if self.momentum is not None:
                t = self.state["trace"][name]
                t.copy_(u + self.momentum * t)
                u = u + self.momentum * t if self.nesterov else t
            _finish_(p, u, -_f32(lr), scale)


def factored_dims(shape, reverse: bool = False,
                  min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax ``_factored_dims``: (d1, d0), the second largest dim and the
    largest of ``shape`` (numpy's argsort), or None where the second largest
    is under ``min_dim_size_to_factor``.  ``reverse``: the shape is the
    reverse of the JAX leaf's, whose choice (on equal sizes) is taken."""
    if len(shape) < 2:
        return None
    jax_shape = tuple(shape)[::-1] if reverse else tuple(shape)
    order = np.argsort(jax_shape)
    if jax_shape[order[-2]] < min_dim_size_to_factor:
        return None
    d1, d0 = int(order[-2]), int(order[-1])
    if reverse:
        d1, d0 = len(shape) - 1 - d1, len(shape) - 1 - d0
    return d1, d0


def _decay_rate(count: int, decay_rate: float) -> float:
    """optax ``_decay_rate_pow`` at step count - 1: 1 - count^-decay_rate in
    f32."""
    return float(1.0 - torch.tensor(float(count), dtype=torch.float32) ** -decay_rate)


class Adafactor(BaseOptimizer):
    """``optax.adafactor(lr)`` at optax's defaults: a leaf whose two largest
    dims are both >= 128 keeps the factored second moments "v_row" (its mean
    over the largest dim d0) and "v_col" (over d1), any other leaf "v"; the
    decay 1 - count^-0.8, eps 1e-30, then the update clipped to an RMS of
    1.0, times lr, times the parameter's RMS (at least 1e-3), negated; no
    momentum.

    Under fsdp a split leaf keeps the share of each statistic that its share
    produces: a mean over the split dim is summed over the group (that
    statistic then whole on every rank), so are the RMSs."""

    MIN_DIM, DECAY, EPS, CLIP, MIN_SCALE = 128, 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, params, leaves):
        super().__init__(params, leaves)
        self.factored = {n: factored_dims(leaves.shapes[n], n in leaves.reversed_layout,
                                          self.MIN_DIM) for n in params}
        self.state = {"v_row": {}, "v_col": {}, "v": {}}
        for n, p in params.items():
            dims = self.factored[n]
            if dims is None:
                self.state["v"][n] = torch.zeros_like(p)
                continue
            # a share's statistics: along the split dim a mean is whole
            d1, d0 = dims
            self.state["v_row"][n] = p.new_zeros(_without(p.shape, d0))
            self.state["v_col"][n] = p.new_zeros(_without(p.shape, d1))

    def _state_dim(self, kind, name, s):
        """The dim of ``state[kind][name]`` that the leaf's split dim ``s``
        becomes (None where the statistic reduced it away)."""
        if kind == "v" or s is None:
            return s
        d1, d0 = self.factored[name]
        gone = d0 if kind == "v_row" else d1
        return None if s == gone else (s - 1 if s > gone else s)

    def split_dim(self, kind, name):
        return self._state_dim(kind, name, self.leaves.dim(name))

    def tensor_split_dim(self, kind, name):
        return self._state_dim(kind, name, self.leaves.tdim(name))

    def _update_leaves(self, params, grads, count, lr, scale):
        decay = _decay_rate(count, self.DECAY)
        lr32 = _f32(lr)
        for name, p in params.items():
            g, shape, s = grads[name], self.leaves.shapes[name], self.leaves.dim(name)
            ts = self.leaves.tdim(name)
            grad_sqr = g * g + self.EPS
            if self.factored[name] is None:
                v = self.state["v"][name]
                v.copy_(decay * v + (1.0 - decay) * grad_sqr)
                u = g * v ** -0.5
            else:
                d1, d0 = self.factored[name]
                v_row, v_col = self.state["v_row"][name], self.state["v_col"][name]
                v_row.copy_(decay * v_row + (1.0 - decay)
                            * self.leaves.mean(grad_sqr, d0, s, shape[d0], tsplit=ts))
                v_col.copy_(decay * v_col + (1.0 - decay)
                            * self.leaves.mean(grad_sqr, d1, s, shape[d1], tsplit=ts))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = self.leaves.mean(v_row, reduced_d1, self.split_dim("v_row", name),
                                                shape[d1], keepdim=True,
                                                tsplit=self.tensor_split_dim("v_row", name))
                row_factor = (v_row / row_col_mean) ** -0.5
                col_factor = v_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            numel = math.prod(shape)
            rms = torch.sqrt(self.leaves.square_sum(u, name) / numel)
            u = u / torch.clamp(rms / self.CLIP, min=1.0)
            u = u * lr32
            p_rms = torch.sqrt(self.leaves.square_sum(p, name) / numel)
            u = u * torch.where(p_rms <= self.MIN_SCALE, torch.full_like(p_rms, self.MIN_SCALE),
                                p_rms)
            _finish_(p, u, -1.0, scale)


def _without(shape, dim: int) -> tuple:
    return tuple(n for i, n in enumerate(shape) if i != dim)


OPTIMIZERS = ("adamw", "adam", "adafactor", "lamb", "adagrad", "adamax", "nag", "sgd")


def make_base(name: str, params: Dict[str, torch.Tensor], leaves: Leaves,
              betas=(0.9, 0.999), eps: Optional[float] = None,
              weight_decay: float = 0.0) -> BaseOptimizer:
    """The base optimizer ``name`` as the JAX ``build_optimizer`` builds it
    (``betas``, ``eps`` and ``weight_decay`` where it passes them; ``eps``
    None: optax's default)."""
    b1, b2 = (float(b) for b in betas)
    if name in ("adamw", "adam"):
        return Adam(params, leaves, b1, b2, 1e-8 if eps is None else eps,
                    weight_decay if name == "adamw" else 0.0)
    if name == "lamb":
        return Lamb(params, leaves, b1, b2, 1e-6 if eps is None else eps, weight_decay)
    if name == "adamax":
        return Adamax(params, leaves, b1, b2, 1e-8 if eps is None else eps)
    if name == "adafactor":
        return Adafactor(params, leaves)
    if name == "adagrad":
        return Adagrad(params, leaves)
    if name == "nag":
        return Sgd(params, leaves, momentum=0.99, nesterov=True)
    if name == "sgd":
        return Sgd(params, leaves)
    raise ValueError(f"unknown optimizer {name}")


class Optimizer:
    """An optax alias over every leaf of ``params`` (f32 tensors, updated in
    place): no clipping, no mask, no skip; the learning rate of update n is
    ``schedule(n - 1)``, the count this optimizer's own.  ``name`` and the
    keywords as ``make_base`` takes them."""

    def __init__(self, name: str, params: Dict[str, torch.Tensor],
                 schedule: Callable[[int], float], **hyper):
        self.schedule, self.count = schedule, 0
        self.base = make_base(name, params, Leaves(params), **hyper)

    def update(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> bool:
        self.base.apply_(params, grads, self.count + 1, self.schedule(self.count))
        self.count += 1
        return True

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, **self.base.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for kind, mine in self.base.state.items():
            for name, t in mine.items():
                t.copy_(state[kind][name])


class AdamW(Optimizer):
    """``optax.adamw(schedule, b1, b2, eps, weight_decay)``, the optimizer of
    the two GAN steps."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable[[int], float],
                 betas=(0.9, 0.999), weight_decay: float = 1e-4, eps: float = 1e-8):
        super().__init__("adamw", params, schedule, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self.betas, self.weight_decay, self.eps = betas, weight_decay, eps

    @property
    def mu(self):
        return self.base.state["mu"]

    @property
    def nu(self):
        return self.base.state["nu"]


def alias(name: str, learning_rate, **hyper) -> Callable[[Dict[str, torch.Tensor]], Optimizer]:
    """The port of ``optax.<name>(learning_rate, ...)`` for
    ``build_composite_optimizer``: a function of a group's leaves that
    builds its ``Optimizer`` (``learning_rate`` a number or a schedule)."""
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    return lambda params: Optimizer(name, params, schedule, **hyper)


class CompositeOptimizer:
    """``build_composite_optimizer``: each leaf's group is the first regex
    that matches its path; each group's optimizer updates its leaves alone."""

    def __init__(self, groups, params: Dict[str, torch.Tensor], default=None):
        regexes = [re.compile(rx) for rx, _ in groups]
        factories = {f"g{i}": make for i, (_, make) in enumerate(groups)}
        factories["default"] = default

        def label(name: str) -> str:
            p = path_str(name)
            return next((f"g{i}" for i, rx in enumerate(regexes) if rx.search(p)), "default")

        self.labels = {n: label(n) for n in params}
        self.members = {}
        for key, make in factories.items():
            mine = {n: p for n, p in params.items() if self.labels[n] == key}
            if make is not None and mine:
                self.members[key] = make(mine)

    def update(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> bool:
        """Leaves of no group and no default stay as they are (frozen)."""
        for key, opt in self.members.items():
            names = [n for n in params if self.labels[n] == key]
            opt.update({n: grads[n] for n in names}, {n: params[n] for n in names})
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {key: opt.state_dict() for key, opt in self.members.items()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for key, opt in self.members.items():
            opt.load_state_dict(state[key])


def build_composite_optimizer(groups: List[Tuple[str, Callable]], params: Dict[str, torch.Tensor],
                              default: Optional[Callable] = None) -> CompositeOptimizer:
    """Route leaves to different optimizers by the regex of their path
    ("a/b/c" for ``state_dict`` name "a.b.c"): ``groups`` is [(regex,
    factory)], a factory a function of the group's leaves such as
    ``alias("sgd", 0.1)``; first match wins; unmatched leaves use
    ``default`` or are frozen."""
    return CompositeOptimizer(groups, params, default)


def row_share(rows: int, mesh: Mesh) -> float:
    """The weight of a rank's mean over its ``rows`` batch rows in the global
    batch's mean: rows / the batch group's rows / the ranks holding the same
    batch."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    total = batch_total(torch.tensor(rows, dtype=torch.float64, device=device))
    return rows / float(total) / replicas(mesh)


def sum_gradients_(grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
                   mesh: Mesh) -> None:
    """Sum each rank's gradients of whole leaves over the world; a
    tensor-split leaf's (the tensor group's share: times the tensor size)
    over the ranks that hold the same slice."""
    split = {n for n in grads if tensor_dim(params[n]) is not None}
    for n in split:
        grads[n].mul_(mesh.size("tensor"))
    flat_all_reduce_(g for n, g in grads.items() if n not in split)
    flat_all_reduce_((grads[n] for n in split), tensor_groups(mesh)[1])


def apply_gradients_(loss: torch.Tensor, params: Dict[str, torch.Tensor],
                     masters: Dict[str, torch.Tensor], opt: Optimizer,
                     rows: Optional[int] = None) -> None:
    """One ``opt`` update of ``masters`` from the gradient of ``loss`` with
    respect to ``params`` (zero where the loss does not reach a leaf); then
    each parameter takes its master's value.  On a mesh ``loss`` is a mean
    over the rank's ``rows`` batch rows: it enters with its ``row_share`` and
    the gradients are summed over the world (``sum_gradients_``)."""
    names = list(params)
    mesh = active_mesh()
    if mesh is not None:
        loss = loss * row_share(rows, mesh)
    got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(masters[n]) if g is None else g.float()
             for n, g in zip(names, got)}
    if mesh is not None:
        sum_gradients_(grads, params, mesh)
    with torch.no_grad():
        opt.update(grads, masters)
    copy_masters_(params, masters)


@contextlib.contextmanager
def no_weight_grad(module: torch.nn.Module):
    """Within the block ``module``'s parameters take no gradient: a loss
    through it reaches its input only (the JAX GAN steps differentiate the
    generator's loss with respect to the generator alone)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def exponential_decay(lr: float, transition_steps: int, decay_rate: float) -> Callable[[int], float]:
    """optax ``exponential_decay(..., staircase=True)``: lr * decay_rate **
    floor(count / transition_steps)."""
    return lambda count: lr * decay_rate ** (count // transition_steps)


class MaskedOptimizer:
    """The JAX trainer's optax chain over the trainable leaves (f32 masters):
    [MultiSteps] of apply_if_finite of clip_by_global_norm -> the base
    optimizer of ``cfg.optimizer`` (``make_base``) -> the plateau scale.
    ``update`` applies one micro-step's gradients in place and says whether
    the parameters moved.  ``leaves`` is the masters' layout (fsdp shares).
    ``copies`` (the module's parameters, or None): each takes its master's
    value, cast, in every update that moves them.

    The global norm and the finite check come from one ``square_sums_many``
    pass over the gradients: ``grad_norm`` keeps it for the same gradients'
    ``update``, which takes its finite flag and clips by its norm."""

    def __init__(self, cfg: OptimizationConfig, params: Dict[str, torch.Tensor],
                 leaves: Optional[Leaves] = None,
                 copies: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.leaves = leaves or Leaves(params)
        self.copies = copies
        self._pass = None  # (gradients, norm, finite) of the last square sums
        self.schedule = make_schedule(cfg)
        self.base = make_base(cfg.optimizer, params, self.leaves, cfg.adam_betas, cfg.adam_eps,
                              cfg.weight_decay)
        self.count = 0  # updates the base optimizer applied (its count and the schedule's)
        self.notfinite_count = self.total_notfinite = 0
        self.last_finite = True
        self.mini_step = self.gradient_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()} \
            if cfg.update_freq > 1 else None
        self.plateau = None
        if cfg.lr_scheduler == "reduce_lr_on_plateau":
            if cfg.lr_shrink >= 1.0:
                logger.warning("reduce_lr_on_plateau with lr_shrink=%.3g never reduces",
                               cfg.lr_shrink)
            best = -math.inf if cfg.plateau_maximize else math.inf
            self.plateau = {"scale": 1.0, "best": best, "bad": 0}

    @property
    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The base optimizer's tensors by kind."""
        return self.base.state

    @property
    def fused(self) -> bool:
        """The update is one multi-tensor pass, which takes the gradients in
        any float dtype."""
        return self.base.fused

    def tensor_kinds(self) -> List[str]:
        """The kinds of per-leaf tensors ``state_dict`` holds."""
        return list(self.base.state) + ([] if self.acc is None else ["acc"])

    def split_dim(self, kind: str, name: str) -> Optional[int]:
        return self.leaves.dim(name) if kind == "acc" else self.base.split_dim(kind, name)

    def tensor_split_dim(self, kind: str, name: str) -> Optional[int]:
        return self.leaves.tdim(name) if kind == "acc" else \
            self.base.tensor_split_dim(kind, name)

    def update(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> bool:
        with span("train.optimizer.update"):
            try:
                return self._update(grads, params)
            finally:
                self._pass = None

    def _update(self, grads, params) -> bool:
        k = self.cfg.update_freq
        if self.acc is None:
            return self._if_finite(grads, params)
        n_acc = self.mini_step
        for name, g in grads.items():
            acc = self.acc[name]
            acc.add_((g - acc) / (n_acc + 1))
        self.mini_step = (n_acc + 1) % k
        if n_acc != k - 1:
            return False
        self.gradient_step += 1
        applied = self._if_finite(self.acc, params)
        for acc in self.acc.values():
            acc.zero_()
        return applied

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads``; the squares of the split leaves'
        shares are summed over their groups (fsdp, tensor), each slice
        counted once."""
        return self._square_pass(grads)[0]

    def _square_pass(self, grads) -> Tuple[torch.Tensor, torch.Tensor]:
        """(global norm, all finite) of ``grads`` from one ``square_sums_many``
        pass, kept for the same ``grads`` until the end of ``update``.  The
        split leaves' sums are totalled by split group (fsdp bit, tensor bit)
        on the device, then summed over their groups."""
        if self._pass is not None and self._pass[0] is grads:
            return self._pass[1:]
        leaves = self.leaves
        groups = [(leaves.dim(n) is not None) + 2 * (leaves.tdim(n) is not None)
                  for n in grads] if leaves.split else None
        _, totals, finite = square_sums_many(list(grads.values()), groups)
        out, both = totals[0], None
        if leaves.dims:
            fsdp = leaves.total_(totals[1::2].clone(), True)  # groups 1 and 3
            out, both = out + fsdp[0], fsdp[1]
        if leaves.tdims:
            tensor = totals[2].clone() if both is None else totals[2] + both
            out = out + leaves.total_(tensor, False, True)
        self._pass = (grads, torch.sqrt(out), finite)
        return self._pass[1:]

    def _all_finite(self, grads) -> bool:
        finite = self._square_pass(grads)[1]
        if self.leaves.split:  # every rank makes the same decision
            flag = finite.to(torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            finite = flag > 0
        with span("train.finite.wait"):
            return bool(finite)

    def _if_finite(self, grads, params) -> bool:
        if not self.cfg.skip_nonfinite_grads:
            self._apply(grads, params)
            return True
        finite = self._all_finite(grads)
        self.last_finite = finite
        if finite:
            self.notfinite_count = 0
            self._apply(grads, params)
            return True
        self.notfinite_count += 1
        self.total_notfinite += 1
        if self.notfinite_count > MAX_CONSECUTIVE_NONFINITE:
            raise FloatingPointError(
                f"{self.notfinite_count} consecutive steps with non-finite gradients")
        return False

    def _apply(self, grads, params) -> None:
        cfg = self.cfg
        clip = float(cfg.clip_norm) if cfg.clip_norm and cfg.clip_norm > 0 else None
        self.count += 1
        self.base.apply_(params, grads, self.count, self.schedule(self.count - 1),
                         1.0 if self.plateau is None else self.plateau["scale"],
                         norm=None if clip is None else self._square_pass(grads)[0], clip=clip,
                         copies=self.copies)

    def plateau_update(self, value: float) -> Optional[float]:
        """Host-side reduce-on-plateau step (torch ``ReduceLROnPlateau``,
        threshold_mode "rel"): after more than ``lr_patience`` validations
        without an improvement the scale shrinks by ``lr_shrink``.  Returns
        the scale, or None without the plateau scheduler."""
        if self.plateau is None:
            return None
        cfg, st = self.cfg, self.plateau
        thr, best = float(cfg.lr_threshold), st["best"]
        fbest = math.isfinite(best)
        if cfg.plateau_maximize:
            improved = value > best * (1.0 + thr) if fbest else True
            new_best = max(best, value) if fbest else value
        else:
            improved = value < best * (1.0 - thr) if fbest else True
            new_best = min(best, value) if fbest else value
        bad = 0 if improved else st["bad"] + 1
        scale = st["scale"]
        if bad > int(cfg.lr_patience):
            scale *= float(cfg.lr_shrink)
            bad = 0
            logger.info("plateau: shrinking lr scale to %.3g", scale)
        # the JAX state keeps scale and best in f32
        self.plateau = {"scale": _f32(scale), "best": _f32(new_best), "bad": bad}
        return self.plateau["scale"]

    _SCALARS = ("count", "notfinite_count", "total_notfinite", "last_finite", "mini_step",
                "gradient_step", "plateau")

    def state_dict(self) -> Dict[str, Any]:
        """The counters, each of the base optimizer's kinds ({leaf: tensor})
        and "acc" (None without accumulation)."""
        out = {k: getattr(self, k) for k in self._SCALARS}
        out.update(self.base.state, acc=self.acc)
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k in self._SCALARS:
            setattr(self, k, state[k])
        for kind in self.tensor_kinds():
            mine = self.acc if kind == "acc" else self.base.state[kind]
            for name, t in mine.items():
                t.copy_(state[kind][name])


def build_optimizer(opt_cfg: OptimizationConfig, params: Dict[str, torch.Tensor],
                    leaves: Optional[Leaves] = None,
                    copies: Optional[Dict[str, torch.Tensor]] = None) -> MaskedOptimizer:
    """The optimizer over ``params`` (the trainable leaves' f32 masters):
    the JAX ``build_optimizer``, kept under its name for callers ported from
    the JAX package."""
    return MaskedOptimizer(opt_cfg, params, leaves, copies)


def broadcast_(tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor takes global rank 0's value, in place."""
    for t in tensors:
        dist.broadcast(t.data, src=0)


class Trainer:
    """Generic loss-driven trainer over a module.

    ``loss_fn(batch, generator) -> (loss, metrics)`` runs the module's
    training forward with its dropout drawn from ``generator`` (the
    trainer's, seeded by ``seed`` (``dropout_seed`` on a mesh); its state
    checkpoints with the rest).  On the active mesh the loss divides by
    global counts and the step is the step of the batch group's
    concatenated batch (module docstring)."""

    def __init__(self, loss_fn: Callable, module: torch.nn.Module, opt_cfg: OptimizationConfig,
                 frozen_patterns: Optional[List[str]] = None, seed: int = 0):
        self.loss_fn = loss_fn
        self.module = module
        self.opt_cfg = opt_cfg
        self.mesh = active_mesh()
        self.mask, self.params, full = trainable_leaves(module, frozen_patterns or [])
        # the tensor-split leaves (the module holds their slices) and their dims
        self.tensor_dim = {n: d for n, p in self.params.items()
                           if (d := tensor_dim(p)) is not None}
        if self.mesh is not None:
            # rank 0's trainable leaves and buffers (after its init_from_pt)
            broadcast_([*(p for n, p in self.params.items() if n not in self.tensor_dim),
                        *module.buffers()])
            # a split leaf's slice from the rank of rank 0's tensor group
            # that holds it
            _, holders = tensor_groups(self.mesh)
            for n in self.tensor_dim:
                dist.broadcast(self.params[n].data, src=self._first_holder(), group=holders)
            full = {n: p.detach().float().clone() for n, p in self.params.items()}
        fsdp = self.mesh.size("fsdp") if self.mesh is not None else 1
        specs = param_specs(module, self.mesh.sizes) if self.mesh is not None else {}
        self.shard_dim = {n: specs[n].fsdp if fsdp > 1 else None for n in self.params}
        self.master = {n: self._share(n, m) for n, m in full.items()}
        named = dict(module.named_parameters())
        n_train = sum(p.numel() for p in self.params.values())
        n_total = sum(p.numel() for p in named.values())
        logger.info("trainable params: %.2fM / %.2fM (%.2f%%)", n_train / 1e6, n_total / 1e6,
                    100.0 * n_train / max(n_total, 1))
        linear = {f"{m}.weight" for m, mod in module.named_modules()
                  if isinstance(mod, torch.nn.Linear) or getattr(mod, "flax_leaf", "") == "kernel"}
        # the masters' layout, for the optimizer (and one built later for them)
        self.leaves = Leaves(self.master, {n: getattr(p, "whole_shape", p.shape)
                                           for n, p in self.params.items()},
                             self.shard_dim if fsdp > 1 else None,
                             self.mesh.group("fsdp") if fsdp > 1 else None,
                             reversed_layout=linear & set(self.params),
                             tdims=self.tensor_dim,
                             tgroup=self.mesh.group("tensor") if self.tensor_dim else None)
        # the update writes the module's copies where they are whole masters
        split = any(d is not None for d in self.shard_dim.values())
        self.optimizer = build_optimizer(opt_cfg, self.master, self.leaves,
                                         None if split else self.params)
        device = next(iter(named.values())).device
        self.generator = torch.Generator(device=device).manual_seed(dropout_seed(seed, self.mesh))
        self._step = 0

    # -- the fsdp shares and the tensor slices -----------------------------------------

    def _first_holder(self) -> int:
        """The rank of rank 0's tensor group that holds this rank's slices."""
        return self.mesh.rank_of(**{a: 0 for a in AXIS_ORDER if a != "tensor"})

    def _tensor_whole(self, name: str, t: torch.Tensor, d: Optional[int] = -1) -> torch.Tensor:
        """The whole tensor from the tensor group's slices along ``d`` (by
        default the leaf's tensor dim)."""
        d = self.tensor_dim.get(name) if d == -1 else d
        return t if d is None else gather_dim(t, d, self.mesh.group("tensor"))

    def _tensor_slice(self, name: str, whole: torch.Tensor, d: Optional[int] = -1):
        """This rank's slice of a whole tensor along ``d`` (by default the
        leaf's tensor dim)."""
        d = self.tensor_dim.get(name) if d == -1 else d
        return whole if d is None else slice_dim(whole, d, self.mesh.group("tensor"))

    def _share(self, name: str, full: torch.Tensor, d: Optional[int] = -1) -> torch.Tensor:
        """This rank's share of a whole tensor split along ``d`` (by default
        the leaf's split dim)."""
        d = self.shard_dim[name] if d == -1 else d
        if d is None:
            return full
        fsdp = self.mesh.size("fsdp")
        return full.chunk(fsdp, d)[self.mesh.coords["fsdp"]].clone().contiguous()

    def _whole(self, name: str, share: torch.Tensor, d: Optional[int] = -1) -> torch.Tensor:
        """The whole tensor from the fsdp group's shares along ``d`` (by
        default the leaf's split dim)."""
        d = self.shard_dim[name] if d == -1 else d
        if d is None:
            return share
        fsdp = self.mesh.size("fsdp")
        part = share.movedim(d, 0).contiguous()
        out = part.new_empty((fsdp * part.shape[0],) + part.shape[1:])
        dist.all_gather_into_tensor(out, part, group=self.mesh.group("fsdp"))
        return out.movedim(0, d).contiguous()

    def _reduce_(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the gradients over the world: the whole leaves through one
        flat all-reduce; a tensor-split leaf's (its share of the tensor
        group's loss: times the tensor size) over the ranks that hold the
        same slice; an fsdp-split leaf reduce-scattered over fsdp, then
        summed over the other axes (but tensor, for a tensor-split one)."""
        mesh, tensor = self.mesh, self.mesh.size("tensor")
        for n in self.tensor_dim:
            grads[n].mul_(tensor)
        flat_all_reduce_(g for n, g in grads.items()
                         if self.shard_dim[n] is None and n not in self.tensor_dim)
        _, holders = tensor_groups(mesh)
        flat_all_reduce_((g for n, g in grads.items()
                          if self.shard_dim[n] is None and n in self.tensor_dim), holders)
        fsdp = mesh.size("fsdp")
        for n, d in self.shard_dim.items():
            if d is None:
                continue
            g = grads[n].movedim(d, 0).contiguous()
            out = g.new_empty((g.shape[0] // fsdp,) + g.shape[1:])
            dist.reduce_scatter_tensor(out, g, group=mesh.group("fsdp"))
            rest = [a for a in mesh.sizes if a != "fsdp" and not (a == "tensor"
                                                                 and n in self.tensor_dim)]
            if mesh.size(*rest) > 1:
                dist.all_reduce(out, group=mesh.group(*rest))
            grads[n] = out.movedim(0, d).contiguous()

    def _copy_to_module(self) -> None:
        with span("train.optimizer.copy"), torch.no_grad():
            for n, p in self.params.items():
                p.copy_(self._whole(n, self.master[n]))

    # -- the step --------------------------------------------------------------------

    def train_step(self, batch) -> Dict[str, float]:
        """One step: the loss function's metrics as Python numbers, with loss
        (the batch group's) and gnorm (the global norm of this micro-step's
        gradients)."""
        with span("train.step"):
            return self._train_step(batch)

    def _train_step(self, batch) -> Dict[str, float]:
        with span("train.forward"):
            loss, metrics = self.loss_fn(batch, self.generator)
        names = list(self.params)
        weighted = loss if self.mesh is None else loss / replicas(self.mesh)
        # a one-pass update reads the gradients in the module's dtype; a mesh
        # sums them in f32
        dtype = None if self.mesh is None and self.optimizer.fused else torch.float32
        with span("train.backward"):
            got = torch.autograd.grad(weighted, [self.params[n] for n in names],
                                      allow_unused=True)
            # a trainable leaf the loss does not reach has a zero gradient
            grads = {n: torch.zeros_like(self.params[n], dtype=dtype) if g is None
                     else g.to(dtype or g.dtype) for n, g in zip(names, got)}
        if self.mesh is not None:
            self._reduce_(grads)
        with span("train.optimizer"):
            gnorm = self.optimizer.grad_norm(grads)
            if self.optimizer.update(grads, self.master) and self.optimizer.copies is None:
                self._copy_to_module()
        self._step += 1
        if "loss" not in metrics:  # the criterions report the batch group's loss themselves
            metrics = dict(metrics, loss=batch_total(loss.detach()))
        with span("train.metrics.wait"):
            return host_numbers(dict(metrics, gnorm=gnorm))

    def plateau_step(self, value: float) -> Optional[float]:
        """Feed a validation metric to the reduce-on-plateau scheduler (a
        no-op unless lr_scheduler is reduce_lr_on_plateau); returns the LR
        scale.  On a mesh every rank must pass the same value (``cli.train``
        passes rank 0's, ``parallel.mesh.from_rank0``)."""
        return self.optimizer.plateau_update(float(value))

    @property
    def step(self) -> int:
        return self._step

    def state_dict(self, include_frozen: bool = True) -> Dict[str, Any]:
        """model (the trainable leaves' f32 masters, the module's buffers,
        such as the BatchNorm statistics that a training forward moves, and
        with ``include_frozen`` the frozen leaves too), optimizer, step and
        generator state (rank 0's on a mesh).  Under fsdp the shares are
        gathered: every rank must call it, and the result is the one-rank
        state."""
        named = dict(self.module.named_parameters())
        model = {n: gather_whole(named[n], t) if n in named else t
                 for n, t in self.module.state_dict().items()
                 if n not in self.master and (include_frozen or n not in named)}
        model.update({n: self._tensor_whole(n, self._whole(n, m))
                      for n, m in self.master.items()})
        opt = self.optimizer.state_dict()
        for kind in self.optimizer.tensor_kinds():
            opt[kind] = {n: self._tensor_whole(n, self._whole(n, t, self.optimizer.split_dim(kind, n)),
                                               self.optimizer.tensor_split_dim(kind, n))
                         for n, t in opt[kind].items()}
        return {"model": model, "optimizer": opt, "step": self._step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any], reset_optimizer: bool = False) -> None:
        """Load a (one-rank layout) state.  On a mesh the trainable leaves,
        the buffers and the optimizer moments are rank 0's; the frozen leaves
        come from the same file on every rank; a tensor-split leaf and its
        state take this rank's slice."""
        own = self.module.state_dict()
        named = dict(self.module.named_parameters())
        buffers = {n for n, _ in self.module.named_buffers()}
        device = next(iter(own.values())).device

        def rank0(t):
            if self.mesh is None:
                return t
            t = t.to(device).clone()
            dist.broadcast(t, src=0)
            return t

        with torch.no_grad():
            for name, t in state["model"].items():
                if name in self.master:
                    mine = self._tensor_slice(name, rank0(t))
                    self.master[name].copy_(self._share(name, mine.float()))
                    self.params[name].copy_(mine)
                elif name in buffers:
                    own[name].copy_(rank0(t))
                else:
                    own[name].copy_(slice_of(named[name], t.to(own[name].device))
                                    if name in named else t)
        if not reset_optimizer:
            opt = dict(state["optimizer"])
            opt_ = self.optimizer
            for kind in opt_.tensor_kinds():
                opt[kind] = {n: self._share(n, self._tensor_slice(n, rank0(t),
                                                                  opt_.tensor_split_dim(kind, n)),
                                            opt_.split_dim(kind, n))
                             for n, t in opt[kind].items()}
            self.optimizer.load_state_dict(opt)
        self._step = int(state["step"])
        restore_generator_(self.generator, state["generator"].cpu(), self.mesh)
