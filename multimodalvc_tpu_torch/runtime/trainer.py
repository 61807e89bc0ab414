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

Not ported: the mesh shardings (``infer_param_specs``, the state and batch
shardings, the GAN helpers), ``CompileGuard`` and buffer donation, which are
XLA and mesh scaffolding with no counterpart in an eager step on one card;
``build_composite_optimizer`` and the optimizers other than adamw and adam.
"""
from __future__ import annotations

import logging
import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ..config.configs import OptimizationConfig

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

    def _if_finite(self, grads, params) -> bool:
        if not self.cfg.skip_nonfinite_grads:
            self._apply(grads, params)
            return True
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
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
            norm = global_norm(grads.values())
            clip = float(cfg.clip_norm)
            grads = {n: torch.where(norm < clip, g, (g / norm) * clip) for n, g in grads.items()}
        b1, b2 = (float(b) for b in cfg.adam_betas)
        count = self.count + 1
        # optax's scalars are f32: bias corrections 1 - b^count, the step -lr(count)
        bc1, bc2 = _f32(1.0 - b1 ** count), _f32(1.0 - b2 ** count)
        step_size = -_f32(self.schedule(self.count))
        for name, p in params.items():
            g, mu, nu = grads[name], self.mu[name], self.nu[name]
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
            if cfg.optimizer == "adamw":
                u = u + cfg.weight_decay * p
            u = u * step_size
            if self.plateau is not None:
                u = u * self.plateau["scale"]
            p.add_(u)
        self.count = count

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


class Trainer:
    """Generic loss-driven trainer over a module.

    ``loss_fn(batch, generator) -> (loss, metrics)`` runs the module's
    training forward with its dropout drawn from ``generator`` (the
    trainer's, seeded by ``seed``; its state checkpoints with the rest)."""

    def __init__(self, loss_fn: Callable, module: torch.nn.Module, opt_cfg: OptimizationConfig,
                 frozen_patterns: Optional[List[str]] = None, seed: int = 0):
        self.loss_fn = loss_fn
        self.module = module
        self.opt_cfg = opt_cfg
        named = dict(module.named_parameters())
        self.mask = trainable_mask(named, frozen_patterns or [])
        for name, p in named.items():
            p.requires_grad_(self.mask[name])
        self.params = {n: p for n, p in named.items() if self.mask[n]}
        self.master = {n: p.detach().float().clone() for n, p in self.params.items()}
        n_train = sum(p.numel() for p in self.params.values())
        n_total = sum(p.numel() for p in named.values())
        logger.info("trainable params: %.2fM / %.2fM (%.2f%%)", n_train / 1e6, n_total / 1e6,
                    100.0 * n_train / max(n_total, 1))
        self.optimizer = build_optimizer(opt_cfg, self.master)
        device = next(iter(named.values())).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._step = 0

    def train_step(self, batch) -> Dict[str, float]:
        """One step: loss, gnorm (the global norm of this micro-step's
        gradients), accuracy and n_tokens."""
        loss, metrics = self.loss_fn(batch, self.generator)
        names = list(self.params)
        got = torch.autograd.grad(loss, [self.params[n] for n in names], allow_unused=True)
        # a trainable leaf the loss does not reach has a zero gradient
        grads = {n: torch.zeros_like(self.master[n]) if g is None else g.float()
                 for n, g in zip(names, got)}
        gnorm = global_norm(grads.values())
        if self.optimizer.update(grads, self.master):
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(self.master[n])
        self._step += 1
        return {"loss": float(loss.detach()), "gnorm": float(gnorm),
                "accuracy": float(metrics["accuracy"]), "n_tokens": int(metrics["n_tokens"])}

    def plateau_step(self, value: float) -> Optional[float]:
        """Feed a validation metric to the reduce-on-plateau scheduler (a
        no-op unless lr_scheduler is reduce_lr_on_plateau); returns the LR
        scale."""
        return self.optimizer.plateau_update(float(value))

    @property
    def step(self) -> int:
        return self._step

    def state_dict(self, include_frozen: bool = True) -> Dict[str, Any]:
        """model (the trainable leaves' f32 masters, and with
        ``include_frozen`` every other entry of the module's state_dict),
        optimizer, step and generator state."""
        model = {n: t for n, t in self.module.state_dict().items()
                 if include_frozen and n not in self.master}
        model.update(self.master)
        return {"model": model, "optimizer": self.optimizer.state_dict(), "step": self._step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any], reset_optimizer: bool = False) -> None:
        own = self.module.state_dict()
        with torch.no_grad():
            for name, t in state["model"].items():
                if name in self.master:
                    self.master[name].copy_(t)
                    self.params[name].copy_(self.master[name])
                else:
                    own[name].copy_(t)
        if not reset_optimizer:
            self.optimizer.load_state_dict(state["optimizer"])
        self._step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())
