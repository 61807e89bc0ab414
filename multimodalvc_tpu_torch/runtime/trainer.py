"""Trainer: masked AdamW with optax's semantics over an ``nn.Module``.

Port of ``multimodalvc_tpu/runtime/trainer.py`` for one device.  One
``train_step(batch)`` is the JAX trainer's compiled step, eagerly:

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
  ``clip_by_global_norm`` -> ``adamw`` / ``adam`` (decoupled weight decay,
  scaled by the learning rate) -> the reduce-on-plateau scale;
- the eight learning-rate schedules as plain functions of the update count
  (``make_schedule``).

Dtypes: each trainable leaf keeps an f32 master copy in the trainer, as the
JAX trainer keeps f32 params; the optimizer updates the master and copies it,
cast, into the module's parameter, with which the module computes in its
own dtype (bf16 on the card, f32 in the CPU tests).  Frozen leaves stay in
the module's dtype.  Gradients are taken in the module's dtype and then
widened to f32.

``AdamW`` is the plain ``optax.adamw`` (every leaf, a schedule of its own
update count, no clipping), the optimizer of the two GAN steps
(``models/vocoder.py``, ``criterions/gan.py``); ``trainable_leaves`` gives
them the same f32 masters of a module's trainable leaves as ``Trainer``.

On a mesh (``parallel/mesh.py``; one process a device) the step is the
JAX step on the concatenation of the batch group's batches: the loss
function divides by its global count (``batch_total``), each rank's loss
enters with the weight 1 / ``replicas()``, and the gradients are summed over
the world.  Every rank then makes the same decisions: the global grad norm
and its clip, the non-finite skip, the plateau metric (rank 0's).  Under
fsdp each rank keeps its share of the f32 masters and the optimizer moments
of the leaves that ``parallel/sharding.py: fsdp_shard_dim`` splits (ZeRO-3
for the optimizer state): their gradients are reduce-scattered over fsdp,
the updated shares all-gathered into the module's whole weights.  This
changes memory, never the numbers.  The trainable leaves and the buffers
start from rank 0's (after ``init_from_pt``, and in ``load_state_dict``
after a restore); ``state_dict`` gathers the shares, so a checkpoint written
on any mesh resumes on any other.  The GAN steps (``apply_gradients_`` with
``rows``) weight their row means and sum their gradients the same way.

Not ported: ``CompileGuard`` and buffer donation (XLA scaffolding),
``build_composite_optimizer`` and the optimizers other than adamw and adam.
"""
from __future__ import annotations

import contextlib
import logging
import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from ..config.configs import OptimizationConfig
from ..parallel.collectives import flat_all_reduce_
from ..parallel.mesh import (
    Mesh,
    active_mesh,
    batch_total,
    dropout_seed,
    replicas,
    restore_generator_,
)
from ..parallel.sharding import fsdp_shard_dim

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


# ---- the optimizer ----------------------------------------------------------------


def _f32(x: float) -> float:
    """x rounded to the nearest f32."""
    return float(torch.tensor(x, dtype=torch.float32))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum of every element's square."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def adamw_update_(params, grads, mu, nu, count: int, lr: float, betas, eps: float,
                  weight_decay: float, scale: float = 1.0) -> None:
    """One optax ``adam`` (+ ``add_decayed_weights``) update in place:
    moments, bias corrections 1 - b^count as f32 scalars, eps outside the
    square root, the decay added to the direction, times -lr (and the
    plateau ``scale``).  ``count`` is the update's number, from 1."""
    b1, b2 = (float(b) for b in betas)
    bc1, bc2 = _f32(1.0 - b1 ** count), _f32(1.0 - b2 ** count)
    step_size = -_f32(lr)
    for name, p in params.items():
        g, m, v = grads[name], mu[name], nu[name]
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        u = u * step_size
        if scale != 1.0:
            u = u * scale
        p.add_(u)


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay)`` over every leaf of
    ``params`` (f32 tensors, updated in place): no clipping, no mask, no
    skip; the learning rate of update n is ``schedule(n - 1)``, the count
    this optimizer's own."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable[[int], float],
                 betas=(0.9, 0.999), weight_decay: float = 1e-4, eps: float = 1e-8):
        self.schedule, self.betas, self.weight_decay, self.eps = (
            schedule, betas, weight_decay, eps)
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    def update(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> None:
        adamw_update_(params, grads, self.mu, self.nu, self.count + 1,
                      self.schedule(self.count), self.betas, self.eps, self.weight_decay)
        self.count += 1

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            for name, t in getattr(self, key).items():
                t.copy_(state[key][name])


def row_share(rows: int, mesh: Mesh) -> float:
    """The weight of a rank's mean over its ``rows`` batch rows in the global
    batch's mean: rows / the batch group's rows / the ranks holding the same
    batch."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    total = batch_total(torch.tensor(rows, dtype=torch.float64, device=device))
    return rows / float(total) / replicas(mesh)


def apply_gradients_(loss: torch.Tensor, params: Dict[str, torch.Tensor],
                     masters: Dict[str, torch.Tensor], opt: AdamW,
                     rows: Optional[int] = None) -> None:
    """One ``opt`` update of ``masters`` from the gradient of ``loss`` with
    respect to ``params`` (zero where the loss does not reach a leaf); then
    each parameter takes its master's value.  On a mesh ``loss`` is a mean
    over the rank's ``rows`` batch rows: it enters with its ``row_share`` and
    the gradients are summed over the world."""
    names = list(params)
    mesh = active_mesh()
    if mesh is not None:
        loss = loss * row_share(rows, mesh)
    got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(masters[n]) if g is None else g.float()
             for n, g in zip(names, got)}
    if mesh is not None:
        flat_all_reduce_(grads.values())
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


class MaskedAdamW:
    """The JAX trainer's optax chain over the trainable leaves (f32 masters):
    [MultiSteps] of apply_if_finite of clip_by_global_norm -> adamw / adam
    -> the plateau scale.  ``update`` applies one micro-step's gradients in
    place and says whether the parameters moved."""

    def __init__(self, cfg: OptimizationConfig, params: Dict[str, torch.Tensor]):
        if cfg.optimizer not in ("adamw", "adam"):
            raise ValueError(f"optimizer {cfg.optimizer!r} is not ported (adamw and adam are)")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        self.count = 0  # updates the inner optimizer applied (adam's and the schedule's)
        self.mu, self.nu = zeros(), zeros()
        self.notfinite_count = self.total_notfinite = 0
        self.last_finite = True
        self.mini_step = self.gradient_step = 0
        self.acc = zeros() if cfg.update_freq > 1 else None
        self.plateau = None
        if cfg.lr_scheduler == "reduce_lr_on_plateau":
            if cfg.lr_shrink >= 1.0:
                logger.warning("reduce_lr_on_plateau with lr_shrink=%.3g never reduces",
                               cfg.lr_shrink)
            best = -math.inf if cfg.plateau_maximize else math.inf
            self.plateau = {"scale": 1.0, "best": best, "bad": 0}
        # under fsdp: the group that splits the leaves named in ``sharded``
        self.shard_group, self.sharded = None, frozenset()

    def update(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> bool:
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
        """The global norm of ``grads``; under fsdp (``shard_group``) the
        squares of the split leaves' shares are summed over the group."""
        if self.shard_group is None:
            return global_norm(grads.values())
        zero = torch.zeros((), device=next(iter(grads.values())).device)

        def squares(split: bool) -> torch.Tensor:
            return sum(((g.float() * g.float()).sum() for n, g in grads.items()
                        if (n in self.sharded) == split), zero)

        shares = squares(True)
        dist.all_reduce(shares, group=self.shard_group)
        return torch.sqrt(squares(False) + shares)

    def _all_finite(self, grads) -> bool:
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        if self.shard_group is not None:
            flag = finite.to(torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.shard_group)
            finite = flag > 0
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
        if cfg.clip_norm and cfg.clip_norm > 0:
            norm = self.grad_norm(grads)
            clip = float(cfg.clip_norm)
            grads = {n: torch.where(norm < clip, g, (g / norm) * clip) for n, g in grads.items()}
        self.count += 1
        adamw_update_(params, grads, self.mu, self.nu, self.count,
                      self.schedule(self.count - 1), cfg.adam_betas, cfg.adam_eps,
                      cfg.weight_decay if cfg.optimizer == "adamw" else 0.0,
                      1.0 if self.plateau is None else self.plateau["scale"])

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
        out = {k: getattr(self, k) for k in self._SCALARS}
        out.update(mu=self.mu, nu=self.nu, acc=self.acc)
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k in self._SCALARS:
            setattr(self, k, state[k])
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if mine is None:
                continue
            for name, t in mine.items():
                t.copy_(state[key][name])


def build_optimizer(opt_cfg: OptimizationConfig,
                    params: Dict[str, torch.Tensor]) -> MaskedAdamW:
    """The optimizer over ``params`` (the trainable leaves' f32 masters):
    the JAX ``build_optimizer``, kept under its name for callers ported from
    the JAX package."""
    return MaskedAdamW(opt_cfg, params)


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
        if self.mesh is not None:
            # rank 0's trainable leaves and buffers (after its init_from_pt)
            broadcast_([*self.params.values(), *module.buffers()])
            full = {n: p.detach().float().clone() for n, p in self.params.items()}
        fsdp = self.mesh.size("fsdp") if self.mesh is not None else 1
        self.shard_dim = {n: fsdp_shard_dim(tuple(p.shape), fsdp) for n, p in self.params.items()}
        self.master = {n: self._share(n, m) for n, m in full.items()}
        named = dict(module.named_parameters())
        n_train = sum(p.numel() for p in self.params.values())
        n_total = sum(p.numel() for p in named.values())
        logger.info("trainable params: %.2fM / %.2fM (%.2f%%)", n_train / 1e6, n_total / 1e6,
                    100.0 * n_train / max(n_total, 1))
        self.optimizer = build_optimizer(opt_cfg, self.master)
        if fsdp > 1:
            self.optimizer.shard_group = self.mesh.group("fsdp")
            self.optimizer.sharded = frozenset(n for n, d in self.shard_dim.items()
                                               if d is not None)
        device = next(iter(named.values())).device
        self.generator = torch.Generator(device=device).manual_seed(dropout_seed(seed, self.mesh))
        self._step = 0

    # -- the fsdp shares ---------------------------------------------------------------

    def _share(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's share of a whole leaf-shaped tensor."""
        d = self.shard_dim[name]
        if d is None:
            return full
        fsdp = self.mesh.size("fsdp")
        return full.chunk(fsdp, d)[self.mesh.coords["fsdp"]].clone().contiguous()

    def _whole(self, name: str, share: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the fsdp group's shares."""
        d = self.shard_dim[name]
        if d is None:
            return share
        fsdp = self.mesh.size("fsdp")
        part = share.movedim(d, 0).contiguous()
        out = part.new_empty((fsdp * part.shape[0],) + part.shape[1:])
        dist.all_gather_into_tensor(out, part, group=self.mesh.group("fsdp"))
        return out.movedim(0, d).contiguous()

    def _reduce_(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the gradients over the world: the whole leaves through one
        flat all-reduce; a split leaf reduce-scattered over fsdp, then summed
        over the other axes."""
        flat_all_reduce_(g for n, g in grads.items() if self.shard_dim[n] is None)
        fsdp = self.mesh.size("fsdp")
        for n, d in self.shard_dim.items():
            if d is None:
                continue
            g = grads[n].movedim(d, 0).contiguous()
            out = g.new_empty((g.shape[0] // fsdp,) + g.shape[1:])
            dist.reduce_scatter_tensor(out, g, group=self.mesh.group("fsdp"))
            if self.mesh.world > fsdp:
                dist.all_reduce(out, group=self.mesh.group(*(a for a in self.mesh.sizes
                                                             if a != "fsdp")))
            grads[n] = out.movedim(0, d).contiguous()

    def _copy_to_module(self) -> None:
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(self._whole(n, self.master[n]))

    # -- the step --------------------------------------------------------------------

    def train_step(self, batch) -> Dict[str, float]:
        """One step: the loss function's metrics as Python numbers, with loss
        (the batch group's) and gnorm (the global norm of this micro-step's
        gradients)."""
        loss, metrics = self.loss_fn(batch, self.generator)
        names = list(self.params)
        weighted = loss if self.mesh is None else loss / replicas(self.mesh)
        got = torch.autograd.grad(weighted, [self.params[n] for n in names], allow_unused=True)
        # a trainable leaf the loss does not reach has a zero gradient
        grads = {n: torch.zeros_like(self.params[n], dtype=torch.float32) if g is None
                 else g.float() for n, g in zip(names, got)}
        if self.mesh is not None:
            self._reduce_(grads)
        gnorm = self.optimizer.grad_norm(grads)
        if self.optimizer.update(grads, self.master):
            self._copy_to_module()
        self._step += 1
        out = {k: v.detach().item() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
        if "loss" not in out:  # the criterions report the batch group's loss themselves
            out["loss"] = float(batch_total(loss.detach()))
        out["gnorm"] = float(gnorm)
        return out

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
        frozen = {n for n, _ in self.module.named_parameters() if n not in self.master}
        model = {n: t for n, t in self.module.state_dict().items()
                 if n not in self.master and (include_frozen or n not in frozen)}
        model.update({n: self._whole(n, m) for n, m in self.master.items()})
        opt = self.optimizer.state_dict()
        for key in ("mu", "nu", "acc"):
            if opt[key] is not None:
                opt[key] = {n: self._whole(n, t) for n, t in opt[key].items()}
        return {"model": model, "optimizer": opt, "step": self._step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any], reset_optimizer: bool = False) -> None:
        """Load a (one-rank layout) state.  On a mesh the trainable leaves,
        the buffers and the optimizer moments are rank 0's; the frozen leaves
        come from the same file on every rank."""
        own = self.module.state_dict()
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
                    whole = rank0(t)
                    self.master[name].copy_(self._share(name, whole.float()))
                    self.params[name].copy_(whole)
                else:
                    own[name].copy_(rank0(t) if name in buffers else t)
        if not reset_optimizer:
            opt = dict(state["optimizer"])
            for key in ("mu", "nu", "acc"):
                if opt.get(key) is not None:
                    opt[key] = {n: self._share(n, rank0(t)) for n, t in opt[key].items()}
            self.optimizer.load_state_dict(opt)
        self._step = int(state["step"])
        restore_generator_(self.generator, state["generator"].cpu(), self.mesh)
