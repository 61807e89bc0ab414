"""Checkpoints: the last, the best and every N updates, each written safely.

Port of ``multimodalvc_tpu/runtime/checkpoint.py`` in torch's own format: a
checkpoint is a directory holding ``state.pt`` (``torch.save`` of a nested
dict, such as ``Trainer.state_dict()``: model, optimizer, step and generator
state) beside a ``meta.json`` of the save directory.  A write goes to a
``.tmp`` sibling and is swapped in whole, so every instant has a complete
checkpoint under its name or under ``name.old``; strays of a crashed run are
removed when the manager starts.  Writes are synchronous (the JAX package's
orbax writes in a background thread).
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from .trainer import path_str

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _swap_dirs(tmp: str, path: str) -> None:
    """Replace ``path`` with ``tmp``: the old copy is moved aside before the
    rename and deleted only after it."""
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _select_like(template: Any, raw: Any) -> Any:
    """The entries of ``raw`` that ``template`` names (a restore may ask for
    a part of what was saved, e.g. the model alone); leaves come from
    ``raw``."""
    if isinstance(template, dict):
        if not isinstance(raw, dict):
            raise KeyError(f"expected a mapping, got {type(raw)}")
        return {k: _select_like(v, raw[k]) for k, v in template.items()}
    return raw


class CheckpointManager:
    """best / last / interval checkpoints, their metadata, and resume."""

    def __init__(
        self,
        save_dir: str,
        best_metric: str = "loss",
        maximize: bool = False,
        keep_best: int = 1,
        save_interval_updates: int = 0,
        keep_interval_updates: int = -1,
        writer: bool = True,
    ):
        """``writer``: whether this process writes (rank 0 of a multi-process
        run); the others keep the best-value bookkeeping only."""
        self.save_dir = os.path.abspath(save_dir)
        self.writer = writer
        if writer:
            os.makedirs(self.save_dir, exist_ok=True)
        self.best_metric = best_metric
        self.maximize = maximize
        self.keep_best = keep_best
        self.save_interval_updates = save_interval_updates
        self.keep_interval_updates = keep_interval_updates
        self.best_value: Optional[float] = None
        for n in os.listdir(self.save_dir) if writer else ():
            if n.endswith(".tmp") or n.endswith(".old"):
                shutil.rmtree(os.path.join(self.save_dir, n), ignore_errors=True)
        self._meta_path = os.path.join(self.save_dir, "meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.best_value = json.load(f).get("best_value")

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    def save(self, state: Dict[str, Any], step: int,
             val_metrics: Optional[Dict[str, float]] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Write ``checkpoint_last``; ``checkpoint_best`` when
        ``val_metrics[best_metric]`` improves on the best so far;
        ``checkpoint_<step>`` every ``save_interval_updates`` updates, keeping
        the newest ``keep_interval_updates`` of them; then the metadata."""
        self._write(state, "checkpoint_last")
        improved = False
        if val_metrics and self.best_metric in val_metrics:
            v = float(val_metrics[self.best_metric])
            if self.best_value is None or (v > self.best_value if self.maximize
                                           else v < self.best_value):
                self.best_value = v
                self._write(state, "checkpoint_best")
                improved = True
        if self.save_interval_updates and step % self.save_interval_updates == 0:
            self._write(state, f"checkpoint_{step}")
            self._prune_interval()
        meta = {"step": step, "best_value": self.best_value, "best_metric": self.best_metric,
                **(extra or {})}
        if not self.writer:
            return
        with open(self._meta_path, "w") as f:
            json.dump(meta, f)
        logger.info("saved checkpoint step=%d%s", step, " (new best)" if improved else "")

    def _prune_interval(self) -> None:
        """Delete all but the newest ``keep_interval_updates`` step checkpoints."""
        if self.keep_interval_updates < 0 or not self.writer:
            return
        rx = re.compile(r"^checkpoint_(\d+)$")
        steps = sorted(int(m.group(1)) for m in map(rx.match, os.listdir(self.save_dir)) if m)
        for s in steps[: max(0, len(steps) - self.keep_interval_updates)]:
            shutil.rmtree(self._path(f"checkpoint_{s}"), ignore_errors=True)

    def _write(self, state: Dict[str, Any], name: str) -> None:
        if not self.writer:
            return
        path = self._path(name)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        _swap_dirs(tmp, path)

    def restore(self, template: Optional[Any] = None, name: str = "checkpoint_last",
                map_location=None) -> Optional[Any]:
        """The saved state, or the part of it that ``template`` names; None
        when there is no such checkpoint."""
        path = os.path.join(self._path(name), STATE_FILE)
        if not os.path.exists(path):
            return None
        raw = torch.load(path, map_location=map_location, weights_only=False)
        return raw if template is None else _select_like(template, raw)

    @property
    def meta(self) -> Dict[str, Any]:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {}


def average_checkpoints(trees: List[Any]) -> Any:
    """Uniform averaging of same-structure states: float tensors averaged in
    float64 and cast back; every other leaf (integer tensors, step counters)
    keeps the last tree's value."""
    if len(trees) == 1:
        return trees[0]
    first = trees[0]
    if isinstance(first, dict):
        return {k: average_checkpoints([t[k] for t in trees]) for k in first}
    if isinstance(first, torch.Tensor) and first.is_floating_point():
        return torch.stack([t.double() for t in trees]).mean(dim=0).to(first.dtype)
    return trees[-1]


def load_ensemble(manager: CheckpointManager, restore_file: str, mode: str = "logprob",
                  strict: bool = True, map_location=None) -> Optional[List[Any]]:
    """The checkpoints named in a comma-separated ``restore_file``: the list
    of states for a log-prob ensemble (``mode`` "logprob"), or one
    parameter-averaged state (``mode`` "average", ``average_checkpoints``).
    With ``strict``, a missing member of a multi-member list raises; a single
    missing name returns None, so that the caller keeps its fallback."""
    names = [n.strip() for n in restore_file.split(",") if n.strip()]
    states, missing = [], []
    for name in names:
        state = manager.restore(name=name, map_location=map_location)
        if state is None:
            missing.append(name)
            logger.warning("ensemble member %s not found%s", name, "" if strict else ": skipped")
            continue
        states.append(state)
    if missing and strict and len(names) > 1:
        raise FileNotFoundError(
            f"ensemble member(s) not found: {', '.join(missing)} (requested: {restore_file}; "
            "checkpoint.strict_ensemble=false decodes with the remaining members)")
    if not states:
        return None
    if mode == "average" and len(states) > 1:
        return [average_checkpoints(states)]
    return states


def load_model(module: torch.nn.Module, state: Dict[str, Any]) -> None:
    """Copy a checkpoint's ``state["model"]`` (``Trainer.state_dict``: the
    whole module, its trainable leaves as their f32 masters) into
    ``module``, each entry cast to the module's dtype.  Entries the module
    does not name are skipped, as the JAX restore takes the part of a
    checkpoint that its template names; an entry the checkpoint lacks
    raises."""
    missing, _ = module.load_state_dict(state["model"], strict=False)
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} of the module's entries, "
                       f"such as {missing[:3]}")


def filter_frozen(state_dict: Dict[str, Any], frozen_patterns: List[str]) -> Dict[str, Any]:
    """Drop the frozen entries of a flat ``state_dict`` from an export: those
    whose name joined by "/" a frozen regex matches."""
    regexes = [re.compile(p) for p in frozen_patterns]
    return {n: t for n, t in state_dict.items()
            if not any(rx.search(path_str(n)) for rx in regexes)}
