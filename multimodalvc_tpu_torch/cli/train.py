"""Training CLI: a YAML preset and dotted overrides -> the epoch loop on one card.

Port of ``multimodalvc_tpu/cli/train.py``::

  python -m multimodalvc_tpu_torch.cli.train --config conf/mms-llama.yaml \\
      dataset.data=/path/manifest task.noise_wav=/path/babble.wav

Epochs of bucketed batches from the manifest (``data/dataset.py:
BatchLoader``, ``dataset.num_workers`` worker processes) -> ``Trainer``
steps, validation (loss, and the beam-decoded WER of
``dataset.valid_wer_batches`` batches) at each epoch end and every
``checkpoint.save_interval_updates`` updates, checkpoints with the loader's
position (a restart resumes mid-epoch), patience, the plateau scheduler,
``max_update`` / ``max_epoch``.  ``checkpoint.init_from_pt`` warm starts
from a reference product ``.pt`` (``import_init_from_pt``; the vocoder
from a reference generator).  The vocoder and the E2E GAN have their own
dual-optimizer loops; the E2E loop refuses ``init_from_pt``, which the JAX
E2E loop never reads.  ``--device cpu`` runs on the CPU.

Several devices: one process a device, launched by ``torch.distributed.run``
(torchrun) or SLURM (``parallel/distributed.py``).  ``mesh`` lays the world
out over the (pipeline, data, fsdp, sequence, expert, tensor) axes
(``parallel/mesh.py``; -1 fills).  On a tensor axis each loop swaps the
leaves that the JAX sharding rules split for their tensor-parallel forms
(``parallel/tensor.py: split_tensor_parallel_``) once the weights are final
(init, ``init_from_pt``) and before its trainer is built; a resume loads
the whole leaves of the checkpoint into the split modules.  Each loop
takes its batch-group rank's share of the batches (``shard_batches``); a
step is the step on the batch group's concatenated batch.  Every rank
validates the whole set on its own (``parallel.mesh.local``); the beam WER
runs only in a launch of one process; rank 0 alone writes checkpoints and
metric sinks, and every rank takes rank 0's validation metrics
(``parallel.mesh.from_rank0``), so that all make the same checkpoint,
patience and plateau decisions.

A checkpoint holds the whole state, as the JAX package's does: the
module (its trainable leaves as their f32 masters), the optimizer, the step
and the dropout generator, or the GAN loops' two models and optimizers.
Each training step logs ``data_ms`` (the wait for the batch and its copy to the card) and
``step_ms`` beside the trainer's metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import benchmark as _benchmark  # noqa: F401 (registers the dummy task)
from .. import tasks as _tasks  # noqa: F401 (registers the tasks)
from ..config import TrainRootConfig, apply_overrides, from_dict, load_yaml, merge
from ..config.configs import MeshConfig
from ..config.registry import lookup
from ..data.batching import shard_batches
from ..data.dataset import BatchLoader, to_device, to_tensors
from ..interop.avsr_import import import_reference_avsr, merge_state
from ..models import avhubert_pretrain as _avh, avsr as _avsr, speech as _speech  # noqa: F401
from ..models import vocoder as _vocoder  # noqa: F401
from ..parallel.distributed import distributed_init, is_master, world_size
from ..parallel.mesh import (
    active_mesh,
    batch_group_rank,
    batch_group_size,
    from_rank0,
    local,
    mesh_scope,
    resolve_axis_sizes,
    restore_generator_,
)
from ..parallel.tensor import split_tensor_parallel_
from ..runtime import tracing
from ..runtime.checkpoint import CheckpointManager
from ..runtime.debug import (
    NanDetector,
    Watchdog,
    check_cross_process_scalar,
    with_oom_batch_split,
)
from ..runtime.metrics import MetricsAggregator, MetricSinks, log_stats
from ..runtime.pt_loader import flatten_state_dict, load_pt
from ..runtime.trainer import Trainer

logger = logging.getLogger(__name__)

E2E_NO_PT = ("checkpoint.init_from_pt: the E2E GAN loop takes no reference .pt, as the JAX "
             "E2E loop never reads the field")


def parse_args(argv=None, results: bool = False):
    """(TrainRootConfig, the parsed arguments) of a command line: ``--config``
    (a YAML preset), ``--device`` and the dotted ``key=value`` overrides."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="YAML preset")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if results:
        parser.add_argument("--results", default="results")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    tree: Dict[str, Any] = {}
    if args.config:
        merge(tree, load_yaml(args.config))
    apply_overrides(tree, args.overrides)
    return from_dict(TrainRootConfig, tree), args


def mesh_sizes(cfg: TrainRootConfig, n_devices: Optional[int] = None) -> Dict[str, int]:
    """The mesh axes of ``cfg`` resolved over ``n_devices`` (default the
    world: one device a process)."""
    return resolve_axis_sizes({f.name: getattr(cfg.mesh, f.name)
                               for f in dataclasses.fields(MeshConfig)
                               if f.name != "microbatches"}, n_devices)


def compute_dtype(cfg: TrainRootConfig) -> torch.dtype:
    return getattr(torch, cfg.common.compute_dtype)


def build_task(cfg: TrainRootConfig, device="cuda", dtype: Optional[torch.dtype] = None):
    """The registered task of ``cfg.task["name"]`` with the model of
    ``cfg.model`` (``preset``: a config classmethod such as ``tiny``, the
    other keys set on it; else the keys build the model's config), its
    modules on ``device`` in ``dtype`` (default ``common.compute_dtype``)."""
    task_dict = dict(cfg.task)
    task_cls, task_cfg_cls = lookup("task", task_dict.pop("name", "avsr_training"))
    task_cfg = from_dict(task_cfg_cls, task_dict) if task_cfg_cls else None
    if task_cfg is not None and getattr(task_cfg, "data", "") in ("", None):
        task_cfg.data = cfg.dataset.data
    model_dict = dict(cfg.model)
    model_name = model_dict.pop("name", None)
    preset = model_dict.pop("preset", None)
    model_cfg = None
    if model_name:
        _, model_cfg_cls = lookup("model", model_name)
        if model_cfg_cls is not None:
            if preset:
                model_cfg = getattr(model_cfg_cls, preset)()
                for k, v in model_dict.items():
                    setattr(model_cfg, k, v)
            else:
                model_cfg = from_dict(model_cfg_cls, model_dict)
    return task_cls.from_config(task_cfg, model_cfg, dtype=dtype or compute_dtype(cfg),
                                device=device)


def loader(cfg: TrainRootConfig, dataset, batches, device, epoch: int = 0,
           first: int = 0) -> BatchLoader:
    return BatchLoader(dataset, batches, num_workers=cfg.dataset.num_workers, epoch=epoch,
                       first=first, pin_memory=torch.device(device).type == "cuda")


def timed_batches(batches, task, device, train: bool = True):
    """(prepared batch on ``device``, the raw host batch, ms waited for it)
    for each batch of the loader ``batches``."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        raw = next(it, None)
        if raw is None:
            return
        batch = task.prepare_batch(to_device(raw, device), train=train)
        yield batch, raw, 1e3 * (time.perf_counter() - t0)


class Profiler:
    """``common.profile``: a ``torch.profiler`` trace of the run, written as
    a Chrome trace under ``common.profile_dir``, with the port's spans
    (``runtime/tracing.py``) as ``record_function`` ranges in it."""

    def __init__(self, cfg: TrainRootConfig):
        self.cfg, self.prof, self.spans = cfg, None, None

    def __enter__(self):
        if self.cfg.common.profile:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.spans = tracing.install(tracing.ProfilerSpans())
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            tracing.install(self.spans)
            self.prof.__exit__(*exc)
            os.makedirs(self.cfg.common.profile_dir, exist_ok=True)
            path = os.path.join(self.cfg.common.profile_dir, f"trace_{os.getpid()}.json")
            self.prof.export_chrome_trace(path)
            logger.info("profiler trace written to %s", path)
        return False


def main(cfg: TrainRootConfig, device="cuda") -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    np.random.seed(cfg.common.seed)
    # a multi-process launch rendezvous before the first device access
    distributed_init()
    # the run's mesh is current until it returns, then the caller's again
    with mesh_scope(mesh_sizes(cfg)):
        task = build_task(cfg, device)
        with Profiler(cfg):
            if type(task).__name__ == "VocoderTask":
                return _vocoder_loop(cfg, task, device)
            if type(task).__name__ == "E2EGanTask":
                if cfg.checkpoint.init_from_pt:
                    raise NotImplementedError(E2E_NO_PT)
                return _e2e_gan_loop(cfg, task, device)
            return _train_loop(cfg, task, device)


def import_init_from_pt(module: torch.nn.Module, path: str) -> int:
    """Warm start ``module`` from a reference product ``.pt``, as the JAX
    training loop does: ``load_pt``, its ``model`` entry (or the whole
    file), ``import_reference_avsr`` (the Q-Former, projector and LoRA
    trainables; the frozen encoders keep their own weights) and
    ``merge_state``.  Returns the number of entries written."""
    raw = load_pt(path)
    state = raw.get("model", raw) if isinstance(raw, dict) else raw
    n = merge_state(module, import_reference_avsr(flatten_state_dict(state)))
    logger.info("imported %d leaves from %s", n, path)
    return n


def _train_loop(cfg: TrainRootConfig, task, device) -> Dict[str, float]:
    train_ds = task.load_dataset(cfg.dataset.train_subset)
    valid_ds = task.load_dataset(cfg.dataset.valid_subset)
    seed = cfg.common.seed
    task.init_random(seed)
    if cfg.checkpoint.init_from_pt:
        import_init_from_pt(task.module, cfg.checkpoint.init_from_pt)
    split_tensor_parallel_(task.module)
    if cfg.optimization.lr_scheduler == "reduce_lr_on_plateau":
        # the plateau direction follows the tracked checkpoint metric
        cfg.optimization.plateau_maximize = bool(cfg.checkpoint.maximize_best_checkpoint_metric)
    trainer = Trainer(task.make_loss_fn(), task.module, cfg.optimization, task.frozen_patterns(),
                      seed=seed)
    valid_step = task.valid_step_fn()
    ckpt = CheckpointManager(
        cfg.checkpoint.save_dir,
        best_metric=cfg.checkpoint.best_checkpoint_metric,
        maximize=cfg.checkpoint.maximize_best_checkpoint_metric,
        save_interval_updates=cfg.checkpoint.save_interval_updates,
        keep_interval_updates=cfg.checkpoint.keep_interval_updates,
        writer=is_master(),
    )
    agg = MetricsAggregator()
    tb = MetricSinks(cfg.common, enabled=is_master())
    patience_left = cfg.checkpoint.patience
    epoch = 0
    stop = False

    # on the host first: the card holds the live model beside it only leaf by leaf
    restored = ckpt.restore(name=cfg.checkpoint.restore_file, map_location="cpu")
    if restored is not None:
        trainer.load_state_dict(restored, reset_optimizer=cfg.checkpoint.reset_optimizer)
        epoch = int(ckpt.meta.get("epoch", 0))
        logger.info("resumed from %s at step %d (epoch %d)", cfg.checkpoint.restore_file,
                    trainer.step, epoch)
    last_val: Dict[str, float] = {}
    last_train_stats: Dict[str, float] = {}

    def run_validation() -> Dict[str, float]:
        if cfg.dataset.disable_validation:
            stats = agg.snapshot()
            if "loss" not in stats:  # the aggregator was just reset at a log tick
                stats = dict(last_train_stats) or stats
            stats = from_rank0(stats)
            log_stats(stats, trainer.step, "train(valid-off)", cfg.common.log_format)
            return stats
        val_agg = MetricsAggregator()
        v_batches = valid_ds.batches(max_tokens=cfg.dataset.max_tokens,
                                     batch_size=cfg.dataset.batch_size)
        hyps: list = []
        refs: list = []
        budget = cfg.dataset.valid_wer_batches
        # as the JAX CLI: the beam WER only in a launch of one process
        can_wer = (budget != 0 and hasattr(task, "decode_to_text") and valid_ds.manifest.labels
                   and world_size() == 1)
        for bi, (vb, raw, _) in enumerate(timed_batches(
                loader(cfg, valid_ds, v_batches, device), task, device, train=False)):
            with local():  # every rank validates the whole set on its own
                for vm in with_oom_batch_split(valid_step, vb):
                    val_agg.update({k: float(v) for k, v in vm.items()})
                if can_wer and (budget < 0 or bi < budget):
                    # the live training module, under inference mode
                    h, r = task.decode_to_text(vb, raw["ids"].tolist(), valid_ds,
                                               cfg.generation)
                    hyps += h
                    refs += r
        metrics = val_agg.snapshot()
        if hyps:
            from ..utils.wer import wer as corpus_wer

            metrics["wer"] = corpus_wer(hyps, refs)[0]
        metrics = from_rank0(metrics)  # one checkpoint, patience and plateau decision
        log_stats(metrics, trainer.step, "valid", cfg.common.log_format)
        tb.scalars(metrics, trainer.step, "valid")
        if cfg.optimization.lr_scheduler == "reduce_lr_on_plateau":
            value = metrics.get(cfg.checkpoint.best_checkpoint_metric, metrics.get("loss"))
            if value is not None and np.isfinite(value):
                trainer.plateau_step(value)
        return metrics

    def save_state(val_metrics, epoch_now, batch_offset) -> bool:
        """Checkpoint with the loader's position: ``batch_offset`` batches of
        epoch ``epoch_now`` consumed (0: the epoch is complete)."""
        prev_best = ckpt.best_value
        ckpt.save(trainer.state_dict(), trainer.step, val_metrics=val_metrics,
                  extra={"epoch": epoch_now, "batch_offset": int(batch_offset)})
        return ckpt.best_value != prev_best

    resume_offset = int(ckpt.meta.get("batch_offset", 0)) if restored is not None else 0
    while not stop:
        if resume_offset == 0:
            epoch += 1
        batches = train_ds.batches(
            max_tokens=cfg.dataset.max_tokens, batch_size=cfg.dataset.batch_size,
            required_multiple=cfg.dataset.required_batch_size_multiple, epoch=epoch)
        # this rank's share (batch_offset counts this rank's batches)
        batches = shard_batches(batches, batch_group_size(), batch_group_rank())
        n_epoch_batches = len(batches)
        skipped = min(resume_offset, n_epoch_batches)
        if skipped:
            logger.info("mid-epoch resume: skipping %d consumed batches of epoch %d", skipped,
                        epoch)
        resume_offset = 0
        consumed = skipped
        for batch, _, data_ms in timed_batches(
                loader(cfg, train_ds, batches[skipped:], device, epoch, skipped), task, device):
            t0 = time.perf_counter()
            if cfg.common.step_timeout_s > 0:
                with Watchdog(cfg.common.step_timeout_s):
                    metrics = trainer.train_step(batch)
            else:
                metrics = trainer.train_step(batch)
            metrics.update(data_ms=data_ms, step_ms=1e3 * (time.perf_counter() - t0))
            consumed += 1
            agg.update(metrics)
            step = trainer.step
            if step % cfg.common.log_interval == 0:
                stats = agg.snapshot()
                last_train_stats.update(stats)
                log_stats(stats, step, "train", cfg.common.log_format)
                tb.scalars(stats, step, "train")
                agg.reset()
                # the NanDetector flow (reference trainer.py:835-850): localise
                # the non-finite tensor on the batch that produced it
                if not np.isfinite(stats.get("loss", 0.0)):
                    NanDetector(trainer.loss_fn, trainer.params).run(
                        batch, torch.Generator(device=device).manual_seed(0))
                check_cross_process_scalar("gnorm", stats.get("gnorm", 0.0))
            if (cfg.checkpoint.save_interval_updates
                    and step % cfg.checkpoint.save_interval_updates == 0
                    and consumed < n_epoch_batches):
                last_val = run_validation()
                improved = save_state(last_val, epoch, consumed)
                if cfg.checkpoint.patience > 0:
                    patience_left = cfg.checkpoint.patience if improved else patience_left - 1
                    if patience_left <= 0:
                        logger.info("early stopping (patience exhausted)")
                        stop = True
                        break
            if cfg.optimization.max_update and step >= cfg.optimization.max_update:
                stop = True
                break
        last_val = run_validation()
        end_offset = consumed if (stop and consumed < n_epoch_batches) else 0
        improved = save_state(last_val, epoch, end_offset)
        if cfg.checkpoint.patience > 0 and not stop:
            patience_left = cfg.checkpoint.patience if improved else patience_left - 1
            if patience_left <= 0:
                logger.info("early stopping (patience exhausted)")
                stop = True
        if cfg.optimization.max_epoch and epoch >= cfg.optimization.max_epoch:
            stop = True
    tb.close()
    return last_val


def _gan_loop(cfg: TrainRootConfig, task, device, trainer, bsz: int, max_tokens,
              sample_audio) -> Dict[str, float]:
    """The epoch loop of a dual-optimizer GAN ``trainer`` (``train_step``,
    ``valid_step``, ``step``, ``state_dict``): validation (mel L1) and a
    full-state checkpoint at each epoch end, patience on mel L1, and with a
    TensorBoard log dir the waveform ``sample_audio(batch)`` of the first
    validation sample."""
    train_ds = task.load_dataset(cfg.dataset.train_subset)
    valid_ds = task.load_dataset(cfg.dataset.valid_subset)
    ckpt = CheckpointManager(
        cfg.checkpoint.save_dir, best_metric="mel_l1",
        save_interval_updates=cfg.checkpoint.save_interval_updates,
        keep_interval_updates=cfg.checkpoint.keep_interval_updates, writer=is_master())
    epoch = 0
    restored = ckpt.restore(name=cfg.checkpoint.restore_file, map_location=device)
    if restored is not None:
        trainer.load_state_dict(restored)
        epoch = int(ckpt.meta.get("epoch", 0))
        logger.info("resumed GAN training state at step %d (epoch %d)", trainer.step, epoch)
    sync_gan_state_(trainer, restored is not None)
    agg = MetricsAggregator()
    tb = MetricSinks(cfg.common, enabled=is_master())
    stop = False
    patience_left = cfg.checkpoint.patience
    last_val: Dict[str, float] = {}
    while not stop:
        epoch += 1
        batches = train_ds.batches(batch_size=bsz, max_tokens=max_tokens)
        batches = shard_batches(batches, batch_group_size(), batch_group_rank())
        for batch, _, data_ms in timed_batches(
                loader(cfg, train_ds, batches, device, epoch), task, device):
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            metrics.update(data_ms=data_ms, step_ms=1e3 * (time.perf_counter() - t0))
            agg.update(metrics)
            if trainer.step % cfg.common.log_interval == 0:
                stats = agg.snapshot()
                log_stats(stats, trainer.step, "train", cfg.common.log_format)
                tb.scalars(stats, trainer.step, "train")
                agg.reset()
            if cfg.optimization.max_update and trainer.step >= cfg.optimization.max_update:
                stop = True
                break
        val_agg = MetricsAggregator()
        v_batches = valid_ds.batches(batch_size=bsz, max_tokens=max_tokens)
        for batch, _, _ in timed_batches(loader(cfg, valid_ds, v_batches, device), task, device,
                                         train=False):
            with local():
                val_agg.update(trainer.valid_step(batch))
        last_val = from_rank0(val_agg.snapshot())
        log_stats(last_val, trainer.step, "valid", cfg.common.log_format)
        tb.scalars(last_val, trainer.step, "valid")
        if cfg.common.tensorboard_logdir:
            raw = to_tensors(valid_ds.load_batch([0]))
            wav = sample_audio(task.prepare_batch(to_device(raw, device), train=False))
            tb.audio("valid/generated", wav.float().cpu().numpy().reshape(-1), trainer.step)
        prev_best = ckpt.best_value
        ckpt.save(trainer.state_dict(), trainer.step, val_metrics=last_val,
                  extra={"epoch": epoch})
        if cfg.checkpoint.patience > 0:
            improved = ckpt.best_value != prev_best
            patience_left = cfg.checkpoint.patience if improved else patience_left - 1
            if patience_left <= 0:
                logger.info("early stopping (patience exhausted)")
                stop = True
        if cfg.optimization.max_epoch and epoch >= cfg.optimization.max_epoch:
            stop = True
    tb.close()
    return last_val


def sync_gan_state_(trainer, restored: bool) -> None:
    """On a mesh every rank takes rank 0's GAN state (its floating tensors:
    weights, masters, optimizer moments, EMA); after a restore the dropout
    generator (rank 0's in the file) is re-derived for the rank."""
    if active_mesh() is None:
        return
    device = next(trainer.gen_master[n] for n in trainer.gen_master).device

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            y = x.to(device).clone()
            torch.distributed.broadcast(y, src=0)
            return y
        return x

    trainer.load_state_dict(walk(trainer.state_dict()))
    gen = getattr(trainer, "generator", None)
    if restored and isinstance(gen, torch.Generator):
        restore_generator_(gen, gen.get_state())


def _e2e_gan_loop(cfg: TrainRootConfig, task, device) -> Dict[str, float]:
    """The E2E waveform model's GAN loop (``E2EGanTask.make_trainer``: the
    stage's frozen leaves, the discriminators random from the seed)."""
    task.init_random(cfg.common.seed)
    split_tensor_parallel_(task.model)
    trainer = task.make_trainer(cfg.common.seed)
    return _gan_loop(cfg, task, device, trainer, cfg.dataset.batch_size or 4,
                     cfg.dataset.max_tokens, lambda b: trainer.synthesize(b)[0])


def _vocoder_loop(cfg: TrainRootConfig, task, device) -> Dict[str, float]:
    """The standalone vocoder's GAN loop; ``checkpoint.init_from_pt`` warm
    starts the generator (and its EMA) from a reference checkpoint."""
    model = task.model
    model.init_random(cfg.common.seed)
    model.init_state(cfg.common.seed)
    if cfg.checkpoint.init_from_pt:
        model.import_torch_checkpoint(cfg.checkpoint.init_from_pt)
        model.reset_optimizers()
        logger.info("warm-started the generator from %s", cfg.checkpoint.init_from_pt)
    # no JAX rule splits a HiFi-GAN or discriminator leaf (nothing to swap)
    for module in (model.generator, model.discriminator):
        split_tensor_parallel_(module)
    return _gan_loop(cfg, task, device, model, cfg.dataset.batch_size or 8, None,
                     lambda b: model.generate(b["mel"][:1])[0])


def cli_main(argv=None):
    cfg, args = parse_args(argv)
    main(cfg, device=args.device)


if __name__ == "__main__":
    cli_main()
