"""The training runner: NoLLM fine-tuning through the port's own step.

Set-up builds one ``SpeechTask`` ("nollm") and one ``Trainer`` around its
module, loads the seeded weights, makes the pool's batches on the device and
drives the trainer through one pass over the pool (every batch shape once):
those are the run's first steps, and the first ``compare_steps`` of them are
read for the check.  The window then takes further passes, each in the
seed's new order, through ``SpeechTask.prepare_batch`` -> ``Trainer.train_step``.

The check (after the window, the program freed): the plain reference
(``reference/model.py`` in f32, TF32 off) follows the same first steps from
the same weights, batches, modality modes (drawn again by the task's rule)
and dropout masks (drawn again from the trainer's seed), with the recipe's
clipped AdamW.  Compared, each by its worst case: the step's mel L1; each
leaf's norm of the first gradient as the optimizer got it (its first moment
after step 1 over 1 - beta1); each leaf's norm of the parameters' change
after the compared steps.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of both leaf-wise numbers.
"""
from __future__ import annotations

import gc
import math
import re
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench import workload as wl
from perfbench.harness import Outcome, traced, window
from perfbench.reference import model as ref
from perfbench.runners.common import (
    DTYPES,
    card,
    exact_f32,
    norm_gap,
    port_speech_config,
    reference_module,
    seeded_state,
    sync,
)
from perfbench import weights

EXCLUDE = 1e-3  # a leaf whose reference gradient norm is under this share of the median's


def trainer_seed(seed: int) -> int:
    return wl.sub_seed(seed, "dropout")


def schedule(opt: Dict) -> Callable[[int], float]:
    """The recipe's learning rate at update count ``step`` (from 0): optax's
    warm-up from 0 then cosine decay to ``min_lr``."""
    lr, warm = float(opt["lr"]), max(int(opt["warmup_updates"]), 1)
    decay = max(int(opt["max_update"]), int(opt["warmup_updates"]) + 1) - warm
    alpha = float(opt["min_lr"]) / lr

    def at(step: int) -> float:
        if step < warm:
            return lr * step / warm
        count = min(step - warm, decay)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay)) + alpha)

    if opt["lr_scheduler"] != "cosine" or opt["optimizer"] != "adamw":
        raise ValueError("the reference follows the cosine-scheduled AdamW recipe only")
    return at


def trainable(name: str, frozen: List[str]) -> bool:
    path = name.replace(".", "/")
    return not any(re.search(p, path) for p in frozen)


class Program:
    """The port's task and trainer with the run's weights and the pool."""

    def __init__(self, ctx, seed: int, fault: Optional[str] = None):
        from multimodalvc_tpu_torch.config.configs import OptimizationConfig
        from multimodalvc_tpu_torch.runtime.trainer import Trainer
        from multimodalvc_tpu_torch.tasks import SpeechTask, SpeechTaskConfig

        c, dev = ctx.config, ctx.device
        self.ctx, self.seed, self.model = ctx, seed, c["model"]
        t = c["task"]
        task_cfg = SpeechTaskConfig(variant=t["variant"],
                                    max_mel_frames=self.model["max_mel_frames"],
                                    p_modality_av=t["p_modality_av"],
                                    p_modality_video_only=t["p_modality_video_only"],
                                    p_modality_audio_only=t["p_modality_audio_only"])
        self.task = SpeechTask(task_cfg, port_speech_config(self.model), dtype=DTYPES[c["dtype"]],
                               device=dev)
        weights.load_into(self.task.module,
                          seeded_state(self.model, "nollm", seed, dev, DTYPES[c["dtype"]]))
        opt = dict(c["optimization"])
        opt["adam_betas"] = tuple(opt["adam_betas"])
        loss_fn = self.task.make_loss_fn()
        if fault == "half_batch":
            loss_fn = _half_batch(loss_fn)
        self.trainer = Trainer(loss_fn, self.task.module, OptimizationConfig(**opt),
                               self.task.frozen_patterns(), seed=trainer_seed(seed))
        if fault == "no_update":
            self.trainer.optimizer.update = lambda grads, params: False
        self.batches_ids = wl.pool_batches(ctx.mix, seed)
        self.batches = [wl.make_batch(ids, ctx.mix, self.model, seed, dev, targets=True)
                        for ids in self.batches_ids]

    def step(self, b: int) -> Dict[str, float]:
        return self.trainer.train_step(self.task.prepare_batch(self.batches[b]))

    def first_steps(self, n: int, rest: bool = True) -> Dict:
        """The first pass over the pool (or its first ``n`` steps without
        ``rest``), reading the first ``n``: losses, each leaf's first
        gradient norm, each leaf's change after step n."""
        tr = self.trainer
        names = list(tr.master)
        init = [tr.master[k].clone() for k in names]
        b1 = float(self.ctx.config["optimization"]["adam_betas"][0])
        out = {"loss": [], "names": names}
        steps = len(self.batches) if rest else n
        for k in range(steps):
            m = self.step(k)
            if k < n:
                out["loss"].append(float(m["loss"]))
            if k == 0:
                mu = tr.optimizer.state["mu"]
                out["grad"] = [float(x) / (1.0 - b1) for x in
                               torch.stack(torch._foreach_norm([mu[k_] for k_ in names])).tolist()]
            if k == n - 1:
                diff = torch._foreach_sub([tr.master[k_] for k_ in names], init)
                out["change"] = torch.stack(torch._foreach_norm(diff)).tolist()
                del diff, init
        return out


def _half_batch(loss_fn):
    """A fault: the loss over the first half of the batch's rows only."""
    def half(batch, generator):
        b = batch["video"].shape[0]
        keep = max(b // 2, 1)
        cut = {k: (v[:keep] if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == b else v)
               for k, v in batch.items()}
        return loss_fn(cut, generator)
    return half


def reference_steps(ctx, seed: int, batches: List[Dict], n: int,
                    precision: Optional[str] = None) -> Dict:
    """The reference's first ``n`` steps on ``batches`` (in order), read as
    ``Program.first_steps`` reads the program's."""
    c, dev = ctx.config, ctx.device
    model, opt, task = c["model"], c["optimization"], c["task"]
    module = reference_module(model, "nollm", seed, dev, DTYPES[c["dtype"]])
    ref.set_precision(module, precision)
    params = {k: p for k, p in module.named_parameters() if trainable(k, task["frozen"])}
    for k, p in module.named_parameters():
        p.requires_grad_(k in params)
    names = list(params)
    init = {k: p.detach().clone() for k, p in params.items()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2 = (float(x) for x in opt["adam_betas"])
    eps, wd, clip = float(opt["adam_eps"]), float(opt["weight_decay"]), float(opt["clip_norm"])
    lr_at = schedule(opt)
    p_modes = (task["p_modality_av"], task["p_modality_video_only"], task["p_modality_audio_only"])
    modes = wl.mode_draws(p_modes, task["mode_seed"], n)
    rng = torch.Generator(device=dev).manual_seed(trainer_seed(seed))
    out = {"loss": [], "names": names}
    for k in range(n):
        batch = batches[k]
        with exact_f32():
            pred, mel_lens = module(batch, mode=modes[k], train=True, rng=rng)
            t = min(pred.shape[1], batch["target_mel"].shape[1])
            lengths = torch.clamp(torch.minimum(mel_lens, batch["target_mel_lengths"].to(mel_lens)),
                                  max=t)
            loss = ref.masked_l1(pred.float(), batch["target_mel"].float(), lengths)
            got = torch.autograd.grad(loss, [params[k_] for k_ in names], allow_unused=True)
        grads = [torch.zeros_like(params[k_]) if g is None else g for k_, g in zip(names, got)]
        del pred, got
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            if gnorm >= clip:
                grads = [g / gnorm * clip for g in grads]
            if k == 0:
                out["grad"] = [float(g.norm()) for g in grads]
            count, lr = k + 1, lr_at(k)
            bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            for k_, g in zip(names, grads):
                p = params[k_]
                mu[k_].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[k_].mul_(b2).add_(g * g, alpha=1.0 - b2)
                u = (mu[k_] / bc1) / (torch.sqrt(nu[k_] / bc2) + eps) + wd * p
                p.add_(u, alpha=-lr)
        del grads
    with torch.no_grad():
        out["change"] = [float((params[k_] - init[k_]).norm()) for k_ in names]
    del module, params, init, mu, nu
    return out


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The three numbers: the worst step's relative loss gap, the worst
    leaf's first-gradient norm gap, the worst moved leaf's change gap."""
    if got["names"] != want["names"]:
        raise ValueError("the program's and the reference's trainable leaves differ")
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"]))
    moved = _moved(want)
    return {"loss_gap": loss, "grad_gap": norm_gap(got["grad"], want["grad"], moved),
            "change_gap": norm_gap(got["change"], want["change"], moved)}


def _moved(want: Dict) -> List[bool]:
    """The leaves the reference's gradient moves: at least ``EXCLUDE`` of the
    median leaf's norm.  The others (a bias under a BatchNorm, whose gradient
    is nought in exact arithmetic) move by round-off alone."""
    med = sorted(want["grad"])[len(want["grad"]) // 2]
    return [w >= EXCLUDE * med for w in want["grad"]]


def worst_leaves(got: Dict, want: Dict) -> Dict[str, List]:
    """For the log: each leaf-wise number's worst leaf, its program and
    reference norms."""
    out, moved = {}, _moved(want)
    for key in ("grad", "change"):
        w = want[key]
        med = sorted(x for x, m in zip(w, moved) if m)[sum(moved) // 2]
        gaps = [abs(g - x) / max(x, med, 1e-30) if m else 0.0
                for g, x, m in zip(got[key], w, moved)]
        i = max(range(len(gaps)), key=gaps.__getitem__)
        out[key] = [want["names"][i], got[key][i], w[i], med]
    return out


def flops(model: Dict, mix: Dict, ids: List[int]) -> float:
    from perfbench.yardstick import step_flops

    frames = wl.clip_frames(mix)
    return step_flops(model, [frames[i] for i in ids], "nollm", train=True)


def run(ctx) -> Outcome:
    dev, mix = ctx.device, ctx.mix
    n = mix["compare_steps"]
    prog = Program(ctx, ctx.seed, ctx.fault)
    readings = prog.first_steps(n)
    nb = len(prog.batches)
    done: List[int] = []

    def step(i: int) -> None:
        k = len(done)
        p, at = 1 + k // nb, k % nb
        b = wl.pass_order(mix, ctx.seed, nb, p)[at]
        prog.step(b)
        done.append(b)

    layer, values, device = None, {}, card(dev)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t0
    if ctx.trace:
        from perfbench.trace import Ranges

        ranges = Ranges()
        ranges.attention()
        ranges.method(prog.trainer.optimizer, "update", "optimizer")
        ranges.method(prog.trainer, "_copy_to_module", "optimizer")
        ranges.method(prog.task.module.encoder, "forward", "encoder")
        steps = mix["trace_steps"]
        tr, wall = traced(step, steps, sync(dev), ctx.root / "build" / "perfbench" /
                          f"trace_{ctx.cell['name']}.json", ranges)
        ctx.log(f"perfbench: trace {tr.summary()}")
        active = done[-steps:]
        layer = {"trace": tr, "window_s": wall, "kind": "train", "steps": steps,
                 "attention": ranges.attention_calls(), "model": prog.model,
                 "flops": sum(flops(prog.model, mix, prog.batches_ids[b]) for b in active)}
        ranges.close()
        layer["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        device.update(busy_s=tr.busy_s(), window_s=wall)
        attempted = steps
    else:
        count, wall = window(step, ctx.seconds, sync(dev), whole=nb)
        audio = sum(wl.audio_seconds(prog.batches_ids[b], mix) for b in done)
        values = {"setup_s": setup_s, "train_audio_s_per_s": audio / wall}
        attempted = count
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    values["peak_gib"] = peak / 2 ** 30
    ctx.log(f"perfbench: setup_s {setup_s!r}, window {wall!r} s, {attempted} steps, values "
            f"{values}, device {device}")
    first = [prog.batches[b] for b in range(n)]
    del prog
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    want = reference_steps(ctx, ctx.seed, first, n)
    compared = compare(readings, want)
    ctx.log(f"perfbench: worst leaves {worst_leaves(readings, want)}")
    failed = sum(1 for k, v in compared.items() if not v <= ctx.limits.get(k, math.inf))
    return Outcome(values=values, layer=layer, compared=compared, attempted=attempted,
                   failed=failed, peak_bytes=peak, device=device)
