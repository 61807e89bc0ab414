"""The rank processes of the port's multi-rank tests (tests/test_torch_dist_*.py).

``spawn`` starts ``world`` processes with ``torch.multiprocessing`` (the
spawn start method), joined by gloo through a ``file://`` rendezvous under
the test's tmp_path, one torch thread each; every rank runs the named jobs
in order and saves what they return, which the test reads back and holds
against the JAX package in its own process.  This module imports the port
only (no JAX), so the ranks never start a JAX runtime.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from datetime import timedelta
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 240  # a collective that waits longer fails the rank


def spawn(tmp_path, world: int, jobs):
    """Run ``jobs`` ([(name, kwargs)]) on ``world`` gloo ranks; returns each
    rank's {name: result}."""
    tmp_path = str(tmp_path)
    init = os.path.join(tmp_path, "rendezvous")
    out = os.path.join(tmp_path, "ranks")
    os.makedirs(out, exist_ok=True)
    mp.spawn(_entry, args=(world, init, jobs, out), nprocs=world, join=True)
    return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False) for r in range(world)]


def _entry(rank, world, init, jobs, out):
    torch.set_num_threads(1)
    from multimodalvc_tpu_torch.parallel import distributed

    distributed.distributed_init(backend="gloo", init_method="file://" + init, world_size=world,
                                 rank=rank, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        results = {name: JOBS[name.split(":")[0]](rank, **kw) for name, kw in jobs}
        torch.save(results, os.path.join(out, f"{rank}.pt"))
    finally:
        distributed.destroy()


# ---- helpers ------------------------------------------------------------------------


def _mesh(sizes):
    from multimodalvc_tpu_torch.parallel import mesh as M

    return M.make_mesh(sizes)


def _rows(batch, mesh):
    """This rank's rows of a global batch: its batch-group share, in order."""
    from multimodalvc_tpu_torch.parallel.mesh import BATCH_AXES

    n = mesh.size(*BATCH_AXES)
    i = mesh.index(*BATCH_AXES)
    per = len(next(iter(batch.values()))) // n
    return {k: torch.from_numpy(np.array(v[i * per:(i + 1) * per])) for k, v in batch.items()}


def _sum_over(tensors, group=None):
    out = [t.clone() for t in tensors]
    for t in out:
        dist.all_reduce(t, group=group)
    return out


def _no_dropout():
    """Within the block, the port's training forwards without a generator (no
    dropout draws), as tests/test_torch_cli.py runs them; a later job of the
    same rank draws its dropout again."""
    from multimodalvc_tpu_torch.models import avsr as tavsr

    return mock.patch.object(tavsr, "train_rng", lambda train, generator: None)


def _tiny_avsr(state_path, lora_dropout=None):
    from multimodalvc_tpu_torch.models import avsr as tavsr

    cfg = tavsr.AVSRConfig.tiny()
    if lora_dropout is not None:
        cfg.llama.lora = dataclasses.replace(cfg.llama.lora, dropout=lora_dropout)
    system = tavsr.AVSRSystem(cfg, device="cpu")
    system.module.load_state_dict(torch.load(state_path), strict=True)
    return system


# ---- jobs ---------------------------------------------------------------------------


def avsr_trainer(rank, mesh, state, batch, opt, steps, fsdp_min=None, ckpt=None):
    """The AVSR Trainer on ``mesh`` over this rank's rows of ``batch`` (the
    evaluation loss: no dropout draw enters), the module split on a tensor
    axis: its metrics, its masters, the bytes of master and moments it
    holds of the fsdp-split leaves, and of the tensor-split leaves those and
    the module's weights (frozen ones too) against the whole leaves'."""
    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.criterions.lm import lm_metrics
    from multimodalvc_tpu_torch.parallel import sharding
    from multimodalvc_tpu_torch.parallel.tensor import split_tensor_parallel_
    from multimodalvc_tpu_torch.runtime.trainer import Trainer

    if fsdp_min is not None:
        sharding.FSDP_MIN_SIZE = fsdp_min
    m = _mesh(mesh)
    system = _tiny_avsr(state)
    tensor_split = split_tensor_parallel_(system.module, m)
    mine = _rows(dict(np.load(batch)), m)

    def loss_fn(b, generator):
        loss, aux = system.module(b, train=False)
        return loss, lm_metrics(loss, aux)

    trainer = Trainer(loss_fn, system.module, OptimizationConfig(**opt),
                      system.frozen_patterns())
    metrics = [trainer.train_step(mine) for _ in range(steps)]
    split = [n for n, d in trainer.shard_dim.items() if d is not None]
    held = sum(4 * (trainer.master[n].numel() + trainer.optimizer.state["mu"][n].numel()
                    + trainer.optimizer.state["nu"][n].numel()) for n in split)
    whole = sum(12 * trainer.params[n].numel() for n in split)
    named = dict(system.module.named_parameters())
    t_bytes = {}  # leaf: (held, whole)
    for n in tensor_split:
        p, n_whole = named[n], math.prod(named[n].whole_shape)
        t_held, t_whole = p.numel() * p.element_size(), n_whole * p.element_size()
        if n in trainer.master:
            t_held += 4 * sum(x.numel() for x in (trainer.master[n],
                                                  trainer.optimizer.state["mu"][n],
                                                  trainer.optimizer.state["nu"][n]))
            t_whole += 12 * n_whole
        t_bytes[n] = (t_held, t_whole)
    state_dict = trainer.state_dict(include_frozen=False)
    if ckpt is not None and rank == 0:
        torch.save(trainer.state_dict(), ckpt)
    elif ckpt is not None:
        trainer.state_dict()  # the gather is collective
    return {"metrics": metrics, "masters": {n: state_dict["model"][n] for n in trainer.master},
            "mu": state_dict["optimizer"]["mu"], "split": split, "held_bytes": held,
            "whole_bytes": whole, "rows": int(mine["labels"].shape[0]),
            "tensor_split": tensor_split, "tensor_bytes": t_bytes}


def avsr_tensor_ckpt(rank, mesh, state, batch, opt, steps, save=None, load=None):
    """The AVSR Trainer on ``mesh`` (split on its tensor axis) over this
    rank's rows: with ``load`` it resumes from that (whole, one-rank)
    checkpoint first; ``steps`` steps, then with ``save`` the state written
    by rank 0, then one more step: that step's metrics."""
    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.criterions.lm import lm_metrics
    from multimodalvc_tpu_torch.parallel.tensor import split_tensor_parallel_
    from multimodalvc_tpu_torch.runtime.trainer import Trainer

    m = _mesh(mesh)
    system = _tiny_avsr(state)
    split_tensor_parallel_(system.module, m)
    mine = _rows(dict(np.load(batch)), m)

    def loss_fn(b, generator):
        loss, aux = system.module(b, train=False)
        return loss, lm_metrics(loss, aux)

    trainer = Trainer(loss_fn, system.module, OptimizationConfig(**opt), system.frozen_patterns())
    if load is not None:
        trainer.load_state_dict(torch.load(load, weights_only=False))
    for _ in range(steps):
        trainer.train_step(mine)
    if save is not None:
        saved = trainer.state_dict()
        if rank == 0:
            torch.save(saved, save)
    return {"next": trainer.train_step(mine)}


def nollm_task(moe_experts: int = 0):
    """The tiny NoLLM speech task (dropout on; with ``moe_experts`` an expert
    bank in each Conformer block), random from seed 0."""
    from multimodalvc_tpu_torch.models.speech import SpeechConfig
    from multimodalvc_tpu_torch.tasks import SpeechTask, SpeechTaskConfig

    cfg = dataclasses.replace(SpeechConfig.tiny(), conformer_moe_experts=moe_experts)
    task = SpeechTask(SpeechTaskConfig(variant="nollm", max_mel_frames=80), cfg, device="cpu")
    task.init_random(0)
    return task


def nollm_steps(batch, opt, steps, mesh=None, moe_experts: int = 0):
    """``steps`` Trainer steps of the NoLLM task's training loss (dropout
    drawn, BatchNorm on batch statistics) on ``batch`` (every rank the
    whole batch), split on ``mesh``'s tensor axis: metrics, masters and the
    split leaves."""
    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.parallel.tensor import split_tensor_parallel_
    from multimodalvc_tpu_torch.runtime.trainer import Trainer

    task = nollm_task(moe_experts)
    split = split_tensor_parallel_(task.module, mesh)
    trainer = Trainer(task.make_loss_fn(), task.module, OptimizationConfig(**opt),
                      task.frozen_patterns(), seed=0)
    b = {k: torch.from_numpy(np.array(v)) for k, v in np.load(batch).items()}
    metrics = [trainer.train_step(b) for _ in range(steps)]
    state = trainer.state_dict()
    return {"metrics": metrics, "masters": {n: state["model"][n] for n in trainer.master},
            "split": split}


def nollm_tensor(rank, mesh, batch, opt, steps, moe_experts=0):
    return nollm_steps(batch, opt, steps, _mesh(mesh), moe_experts)


def nollm_one(rank, batch, opt, steps):
    """The NoLLM steps with no mesh of their own, as a one-process training
    in a process that holds a group runs them: their metrics."""
    return nollm_steps(batch, opt, steps)["metrics"]


def nollm_batch(seed=5):
    """Two rows for the tiny NoLLM speech head (its 80 mel frames), both
    streams."""
    from multimodalvc_tpu_torch.models.speech import SpeechConfig

    cfg = SpeechConfig.tiny()
    rng = np.random.default_rng(seed)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((2, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((2, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([t_v, t_v // 2], np.int32),
        "audio_lengths": np.asarray([80 * 160, 50 * 160], np.int32),
        "target_mel": rng.standard_normal((2, cfg.max_mel_frames, 128)).astype(np.float32),
        "target_mel_lengths": np.asarray([80, 50], np.int32),
        "modality_mode": np.asarray(0, np.int32),
    }


def _sum_grads(names, grads, named, mesh):
    """Each gradient summed over the world; a tensor-split leaf's (the tensor
    group's share) times the tensor size over the ranks that hold its slice,
    then gathered whole."""
    from multimodalvc_tpu_torch.parallel.tensor import gather_whole, tensor_dim, tensor_groups

    _, holders = tensor_groups(mesh)
    out = {}
    for n, g in zip(names, grads):
        if tensor_dim(named[n]) is None:
            (out[n],) = _sum_over([g])
        else:
            (out[n],) = _sum_over([g * mesh.size("tensor")], holders)
            out[n] = gather_whole(named[n], out[n])
    return out


def toy_model(seed: int = 0):
    """Two Linear layers whose weights fsdp splits along their largest dim
    ([128, 256]) and along their smaller one ([255, 128]: 255 is odd); their
    biases stay whole (the JAX rule for names ending in ``bias``)."""
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(256, 128), torch.nn.Tanh(),
                               torch.nn.Linear(128, 255))


def toy_batch(seed: int = 1, rows: int = 4):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(rows, 256, generator=g), "y": torch.randn(rows, 255, generator=g)}


def toy_loss(module):
    """The mean square error over the batch group's rows."""
    from multimodalvc_tpu_torch.parallel.mesh import batch_total

    def loss_fn(b, generator):
        err = ((module(b["x"]) - b["y"]) ** 2).sum(-1)
        n = batch_total(torch.tensor(float(err.shape[0])))
        return err.sum() / n, {}

    return loss_fn


def toy_trainer(opt, steps, mesh=None, fsdp_min=None):
    """``steps`` Trainer steps of the toy model on the toy batch (this
    rank's rows on a mesh): the metrics and the gathered state dict."""
    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.parallel import sharding
    from multimodalvc_tpu_torch.runtime.trainer import Trainer

    if fsdp_min is not None:
        sharding.FSDP_MIN_SIZE = fsdp_min
    batch = toy_batch()
    if mesh is not None:
        batch = _rows(batch, _mesh(mesh))
    module = toy_model()
    trainer = Trainer(toy_loss(module), module, OptimizationConfig(**opt))
    metrics = [trainer.train_step(batch) for _ in range(steps)]
    split = {n: d for n, d in trainer.shard_dim.items() if d is not None}
    return {"metrics": metrics, "state": trainer.state_dict(), "split": split}


def optim_fsdp(rank, mesh, opt, steps):
    return toy_trainer(opt, steps, mesh, fsdp_min=64)


def avsr_resume(rank, state, batch, opt, steps, ckpt):
    """A two-rank resume of the AVSR Trainer on {data: 2}, whose loss draws
    one number from the dropout generator a step: ``steps`` steps, rank 0's
    state written to ``ckpt`` and loaded into a new Trainer on every rank,
    then one more step on the new Trainer and on the old: the restored
    generator state, the draws and metrics of both last steps, and the
    masters after them."""
    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.criterions.lm import lm_metrics
    from multimodalvc_tpu_torch.runtime.trainer import Trainer

    m = _mesh({"data": 2})
    mine = _rows(dict(np.load(batch)), m)

    def trainer_of(draws):
        system = _tiny_avsr(state)

        def loss_fn(b, generator):
            draws.append(float(torch.rand((), generator=generator)))
            loss, aux = system.module(b, train=False)
            return loss, lm_metrics(loss, aux)

        return Trainer(loss_fn, system.module, OptimizationConfig(**opt),
                       system.frozen_patterns())

    old_draws, new_draws = [], []
    old = trainer_of(old_draws)
    for _ in range(steps):
        old.train_step(mine)
    saved = old.state_dict()
    if rank == 0:
        torch.save(saved, ckpt)
    dist.barrier()
    new = trainer_of(new_draws)
    new.load_state_dict(torch.load(ckpt, weights_only=False))
    restored = new.generator.get_state()
    out = {"saved_generator": torch.load(ckpt, weights_only=False)["generator"],
           "restored_generator": restored}
    for name, trainer, draws in (("old", old, old_draws), ("new", new, new_draws)):
        metrics = trainer.train_step(mine)
        out[name] = {"metrics": metrics, "draw": draws[-1],
                     "masters": {n: t.clone() for n, t in trainer.master.items()}}
    return out


def agree(rank):
    """``from_rank0`` of metrics that differ by rank, on {data: 2} and within
    ``local()``."""
    from multimodalvc_tpu_torch.parallel.mesh import from_rank0, local

    _mesh({"data": 2})
    mine = {"loss": float(rank), "accuracy": 0.5 + rank}
    with local():
        alone = from_rank0(dict(mine))
    return {"mesh": from_rank0(dict(mine)), "local": alone}


def batch_norm(rank, x, w):
    """``batch_norm_train_`` on this rank's rows of x [B, T, C] on {data: 2}:
    the output, the input's gradient of sum(out * w) and the running
    statistics."""
    from multimodalvc_tpu_torch.nn.layers import batch_norm_train_

    m = _mesh({"data": dist.get_world_size()})
    mine = _rows({"x": np.load(x), "w": np.load(w)}, m)
    h = mine["x"].clone().requires_grad_(True)
    norm = torch.nn.BatchNorm1d(h.shape[-1])
    out = batch_norm_train_(h, norm)
    (out * mine["w"]).sum().backward()
    return {"out": out.detach(), "grad": h.grad, "mean": norm.running_mean.clone(),
            "var": norm.running_var.clone()}


def ring(rank, mesh, cases):
    """Ring attention of each case {shape, causal, kv_len, seed} on ``mesh``:
    the all-gathered output and the gradients of sum(out * w) with respect
    to the whole q, k and v (summed over the world)."""
    from multimodalvc_tpu_torch.ops.ring_attention import ring_attention
    from multimodalvc_tpu_torch.parallel.collectives import all_gather, shard_of
    from multimodalvc_tpu_torch.parallel.mesh import replicas

    m = _mesh(mesh)
    group = m.group("sequence")
    out = {}
    for name, c in cases.items():
        rng = np.random.default_rng(c["seed"])
        q, k, v, w = (torch.from_numpy(rng.standard_normal(c["shape"]).astype(np.float32))
                      for _ in range(4))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        kv_len = None if c["kv_len"] is None else torch.tensor(c["kv_len"])
        o = ring_attention(shard_of(q, group, 2), shard_of(k, group, 2), shard_of(v, group, 2),
                           m, kv_len=kv_len, causal=c["causal"])
        o = all_gather(o, group, dim=2)
        ((o * w).sum() / replicas(m)).backward()
        out[name] = {"out": o.detach(), "grads": _sum_over([q.grad, k.grad, v.grad])}
    return out


class _SGD:
    def __init__(self, lr):
        self.lr = lr

    def update(self, grads, params):
        for n, p in params.items():
            p.sub_(self.lr * grads[n])


def bmuf(rank, sync_every, steps, lr, block_momentum):
    """BMUF over an SGD on {data: world}: worker i's gradient is i / 8 +
    0.5 (tests/test_bmuf.py's); the parameters after each step."""
    from multimodalvc_tpu_torch.parallel.bmuf import BMUF

    m = _mesh({"data": dist.get_world_size()})
    params = {"w": torch.ones(1)}
    opt = BMUF(_SGD(lr), params, sync_every=sync_every, block_momentum=block_momentum,
               group=m.group("data"))
    grads = {"w": torch.full((1,), rank / 8.0 + 0.5)}
    seen = []
    for _ in range(steps):
        opt.update(grads, params)
        seen.append(float(params["w"]))
    return seen


def llama_pipeline(rank, mesh, state, emb, mask, microbatches):
    """``pipeline_lm_forward`` of the tiny LLaMA (no LoRA) on this rank's
    rows: its logits, and the gradients of every leaf of the loss
    sum(logits^2 over the valid positions) / the global count of logit
    entries there, summed over the world."""
    from multimodalvc_tpu_torch.nn.llama import LlamaConfig, LlamaModel, pipeline_lm_forward
    from multimodalvc_tpu_torch.parallel.mesh import batch_total, replicas

    m = _mesh(mesh)
    cfg = LlamaConfig.tiny()
    cfg.lora = None
    model = LlamaModel(cfg)
    model.load_state_dict(torch.load(state), strict=True)
    mine = _rows({"emb": np.load(emb), "mask": np.load(mask)}, m)
    logits = pipeline_lm_forward(model, mine["emb"], mine["mask"], m, microbatches)
    keep = mine["mask"].bool()[..., None]
    count = batch_total(keep.sum() * logits.shape[-1])
    loss = torch.where(keep, logits ** 2, 0.0).sum() / count / replicas(m)
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(model.parameters(), got)]
    return {"logits": logits.detach(), "grads": dict(zip(names, _sum_over(grads)))}


def avsr_pipeline(rank, mesh, state, batch, microbatches):
    with _no_dropout():
        return _avsr_pipeline(mesh, state, batch, microbatches)


def _avsr_pipeline(mesh, state, batch, microbatches):
    """The AVSR pipelined loss (``AVSRTask.make_loss_fn`` on a pipeline
    axis) on this rank's rows, its trainable gradients summed over the world,
    and the same of the plain loss on the whole batch computed alone
    (``parallel.mesh.local``); no dropout."""
    from multimodalvc_tpu_torch.parallel.mesh import local, replicas
    from multimodalvc_tpu_torch.runtime.trainer import trainable_mask
    from multimodalvc_tpu_torch.tasks import AVSRTask, AVSRTaskConfig

    from multimodalvc_tpu_torch.parallel.tensor import gather_whole, split_tensor_parallel_

    m = _mesh(mesh)
    system = _tiny_avsr(state, lora_dropout=0.0)
    split_tensor_parallel_(system.module, m)
    task = AVSRTask(AVSRTaskConfig(pipeline_microbatches=microbatches), system.cfg, device="cpu")
    task.system = system
    whole = dict(np.load(batch))
    named = dict(system.module.named_parameters())
    mask = trainable_mask(named, system.frozen_patterns())
    for n, p in named.items():
        p.requires_grad_(mask[n])
    params = [p for n, p in named.items() if mask[n]]
    names = [n for n in named if mask[n]]

    def grads_of(loss):
        got = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]

    loss_fn = task.make_loss_fn()
    loss, metrics = loss_fn(_rows(whole, m), torch.Generator())
    pipe = _sum_grads(names, grads_of(loss / replicas(m)), named, m)
    with local():
        ref_loss, _ = system.make_trainer_loss_fn()(
            {k: torch.from_numpy(v) for k, v in whole.items()}, torch.Generator())
        ref = {n: gather_whole(named[n], g) for n, g in zip(names, grads_of(ref_loss))}
    return {"loss": float(metrics["loss"]), "n_tokens": int(metrics["n_tokens"]),
            "fn": loss_fn.__qualname__, "grads": pipe, "ref_loss": float(ref_loss),
            "ref_grads": ref}


def moe(rank, mesh, state, x, w, experts, ffn):
    """``BaseMoELayer`` on this rank's rows of x [B, T, D]: the output, the
    gradients of sum(out * w) for the input rows (summed over the expert
    group) and the weights (summed over the world), and the load."""
    from multimodalvc_tpu_torch.parallel.expert import BaseMoELayer
    from multimodalvc_tpu_torch.parallel.mesh import replicas

    m = _mesh(mesh)
    mine = _rows({"x": np.load(x), "w": np.load(w)}, m)
    layer = BaseMoELayer(mine["x"].shape[-1], experts, ffn)
    layer.load_state_dict(torch.load(state), strict=True)
    h = mine["x"].clone().requires_grad_(True)
    out = layer(h)
    ((out * mine["w"]).sum() / replicas(m)).backward()
    (dx,) = _sum_over([h.grad], m.group("expert"))
    names = [n for n, _ in layer.named_parameters()]
    return {"out": out.detach(), "dx": dx,
            "grads": dict(zip(names, _sum_over([p.grad for p in layer.parameters()]))),
            "load": {k: v.clone() for k, v in layer.load.items()}}


def encoder_sp(rank, mesh, state, x, lengths, w=None):
    """The port's TransformerEncoder with ``sequence_parallel`` on this
    rank's rows (d 32, 2 layers, 4 heads, FFN 64), split on a tensor axis:
    its output; with ``w`` the gradients of sum(out * w) (``_sum_grads``)."""
    from multimodalvc_tpu_torch.nn.layers import TransformerEncoder
    from multimodalvc_tpu_torch.parallel.tensor import split_tensor_parallel_

    m = _mesh(mesh)
    enc = TransformerEncoder(32, 2, 4, 64, sequence_parallel=True)
    enc.load_state_dict(torch.load(state), strict=True)
    split_tensor_parallel_(enc, m)
    mine = _rows({"x": np.load(x), "lengths": np.load(lengths)}, m)
    if w is None:
        with torch.no_grad():
            return {"out": enc(mine["x"], lengths=mine["lengths"])}
    from multimodalvc_tpu_torch.parallel.mesh import replicas

    out = enc(mine["x"], lengths=mine["lengths"])
    weights = _rows({"w": np.load(w)}, m)["w"]
    named = dict(enc.named_parameters())
    grads = torch.autograd.grad((out * weights).sum() / replicas(m), list(named.values()))
    return {"out": out.detach(), "grads": _sum_grads(list(named), grads, named, m)}


def cli_train(rank, argv=None, tree=None, dropout=False):
    """``cli.train.main`` of the port in a launch of several processes (the
    group started here, which the CLI takes as a launcher's) on the command
    line ``argv`` or the config ``tree``, without dropout unless
    ``dropout``: the stats it logged and the checkpoints it wrote."""
    from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
    from multimodalvc_tpu_torch.cli import train as ttrain
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    lines, writes = [], []
    real, real_write = ttrain.log_stats, CheckpointManager._write

    def write(mgr, state, name):
        if mgr.writer:
            writes.append(name)
        real_write(mgr, state, name)

    cfg = ttrain.parse_args(argv)[0] if tree is None else from_dict(TrainRootConfig, tree)
    with contextlib.ExitStack() as patches:
        if not dropout:
            patches.enter_context(_no_dropout())
        patches.enter_context(mock.patch.object(
            ttrain, "log_stats", lambda stats, step, prefix="train", fmt="simple": (
                lines.append((prefix, step, dict(stats))), real(stats, step, prefix, fmt))))
        patches.enter_context(mock.patch.object(CheckpointManager, "_write", write))
        ttrain.main(cfg, device="cpu")
    return {"train": [(step, s) for p, step, s in lines if p == "train"],
            "valid": [s for p, _, s in lines if p == "valid"], "writes": writes}


# a small HiFi-GAN and discriminator stack (tests/test_torch_vocoder_train.py's)
VOCODER_GEN = dict(in_channels=128, upsample_initial_channel=32, upsample_factors=(10, 4, 2, 2),
                   upsample_kernel_sizes=(20, 8, 4, 4), resblock_kernel_sizes=(3,),
                   resblock_dilations=((1, 3, 5),))
VOCODER_EPS = 1e-3  # AdamW's eps: no sign-like first update of rounding-sized gradients


def tiny_vocoder():
    """The small vocoder, random from seed 0, its AdamW eps at VOCODER_EPS."""
    import functools

    from multimodalvc_tpu_torch.models import vocoder as tvoc
    from multimodalvc_tpu_torch.nn.hifigan import HifiGanConfig

    cfg = tvoc.VocoderConfig(generator=HifiGanConfig(**VOCODER_GEN), segment_length=1600,
                             steps_per_epoch=2, lr=1e-3, disc_periods=(2, 3), disc_scales=3,
                             disc_channels_cap=16)
    voc = tvoc.VocoderModel(cfg, device="cpu")
    voc.init_random(0)
    adamw = tvoc.AdamW
    tvoc.AdamW = functools.partial(adamw, eps=VOCODER_EPS)
    try:
        voc.init_state(0)
    finally:
        tvoc.AdamW = adamw
    return voc


def vocoder(rank, batch, steps):
    """The vocoder's GAN steps on {data: world} over this rank's rows: both
    sides' masters after them."""
    m = _mesh({"data": dist.get_world_size()})
    voc = tiny_vocoder()
    mine = _rows(dict(np.load(batch)), m)
    for _ in range(steps):
        voc.train_step(mine)
    return {"gen": dict(voc.gen_master), "disc": dict(voc.disc_master)}


JOBS = {"avsr_trainer": avsr_trainer, "optim_fsdp": optim_fsdp, "avsr_resume": avsr_resume,
        "avsr_tensor_ckpt": avsr_tensor_ckpt, "nollm_tensor": nollm_tensor,
        "nollm_one": nollm_one,
        "agree": agree, "vocoder": vocoder, "batch_norm": batch_norm, "ring": ring, "bmuf": bmuf,
        "llama_pipeline": llama_pipeline, "avsr_pipeline": avsr_pipeline, "moe": moe,
        "encoder_sp": encoder_sp, "cli_train": cli_train}
