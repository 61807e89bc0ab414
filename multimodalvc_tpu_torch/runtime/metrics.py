"""Metric aggregation: averaged meters with log-interval snapshots, and the
metric sinks.

Port of ``multimodalvc_tpu/runtime/metrics.py``: a flat set of named meters
(the perplexity and the WER are computed where they are logged), the
simple / JSON log line, and the TensorBoard, JSONL, W&B and AzureML sinks,
each of which does nothing when it is not configured or its package is
absent.
"""
from __future__ import annotations

import json
import logging
import math
import time
from collections import OrderedDict
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class AverageMeter:
    __slots__ = ("sum", "count")

    def __init__(self):
        self.sum = 0.0
        self.count = 0.0

    def update(self, value: float, weight: float = 1.0):
        self.sum += float(value) * weight
        self.count += weight

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class SpeedMeter:
    def __init__(self):
        self.start = time.perf_counter()
        self.n = 0

    def update(self, n: int = 1):
        self.n += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self.start
        return self.n / dt if dt > 0 else 0.0


class MetricsAggregator:
    def __init__(self):
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()
        self.speed = SpeedMeter()

    def update(self, values: Dict[str, float], weight: float = 1.0):
        for k, v in values.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            if math.isnan(fv):
                continue
            self.meters.setdefault(k, AverageMeter()).update(fv, weight)
        self.speed.update()

    def snapshot(self) -> Dict[str, float]:
        out = {k: m.avg for k, m in self.meters.items()}
        out["ups"] = self.speed.rate
        return out

    def reset(self):
        self.meters.clear()
        self.speed = SpeedMeter()


def format_stats(stats: Dict[str, float], step: int, prefix: str = "train") -> str:
    parts = [f"{prefix} step {step}"]
    for k, v in stats.items():
        parts.append(f"{k}={v:.4g}")
    return " | ".join(parts)


def log_stats(stats: Dict[str, float], step: int, prefix: str = "train", fmt: str = "simple"):
    if fmt == "json":
        logger.info(json.dumps({"step": step, "prefix": prefix, **{k: round(float(v), 6) for k, v in stats.items()}}))
    else:
        logger.info(format_stats(stats, step, prefix))


class TensorBoardSink:
    """TensorBoard scalar and audio sink (reference analog:
    fairseq/fairseq/logging/progress_bar.py TensorboardProgressBarWrapper and
    the vocoder trainer's audio/spectrogram logging,
    scripts/trainGermanVocoder.py:541-575).  No-op if tensorboardX is
    unavailable."""

    def __init__(self, logdir: Optional[str]):
        self._writer = None
        if not logdir:
            return
        try:
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except Exception as e:  # pragma: no cover
            logger.info("tensorboard sink unavailable (%s)", e)

    def scalars(self, stats: Dict[str, float], step: int, prefix: str = "train") -> None:
        if self._writer is None:
            return
        for k, v in stats.items():
            try:
                self._writer.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                continue

    def audio(self, tag: str, wav, step: int, sample_rate: int = 16000) -> None:
        if self._writer is not None:
            self._writer.add_audio(tag, wav.reshape(-1, 1), step, sample_rate=sample_rate)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class JsonlSink:
    """Append-only JSONL metrics stream (machine-readable training log;
    reference analog: logging/progress_bar.py JsonProgressBar writing to
    stdout — here to a file so it composes with the simple formatter)."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def scalars(self, stats: Dict[str, float], step: int, prefix: str = "train") -> None:
        if self._f is None:
            return
        rec = {"step": step, "split": prefix}
        rec.update({k: float(v) for k, v in stats.items() if _is_num(v)})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def audio(self, *a, **k) -> None:
        pass

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class WandbSink:
    """Weights & Biases sink (reference: logging/progress_bar.py
    WandBProgressBarWrapper).  No-op when wandb is not importable."""

    def __init__(self, project: Optional[str], run_name: Optional[str] = None,
                 config: Optional[dict] = None):
        self._run = None
        if not project:
            return
        try:
            import wandb

            self._run = wandb.init(
                project=project, name=run_name, config=config, reinit=True
            )
        except Exception as e:  # pragma: no cover — wandb not baked in
            logger.info("wandb sink unavailable (%s)", e)

    def scalars(self, stats: Dict[str, float], step: int, prefix: str = "train") -> None:
        if self._run is None:
            return
        self._run.log(
            {f"{prefix}/{k}": float(v) for k, v in stats.items() if _is_num(v)},
            step=step,
        )

    def audio(self, *a, **k) -> None:
        pass

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class AzureMLSink:
    """AzureML run-context sink (reference: logging/progress_bar.py
    AzureMLProgressBarWrapper).  No-op outside an AzureML run."""

    def __init__(self, enabled: bool = False):
        self._run = None
        if not enabled:
            return
        try:  # pragma: no cover — azureml not baked in
            from azureml.core import Run

            self._run = Run.get_context()
        except Exception as e:
            logger.info("azureml sink unavailable (%s)", e)

    def scalars(self, stats: Dict[str, float], step: int, prefix: str = "train") -> None:
        if self._run is None:
            return
        for k, v in stats.items():  # pragma: no cover
            if _is_num(v):
                self._run.log(f"{prefix}/{k}", float(v))

    def audio(self, *a, **k) -> None:
        pass

    def close(self) -> None:
        pass


def _is_num(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


class MetricSinks:
    """Fan-out over every configured sink (TensorBoard / W&B / AzureML /
    JSONL), same surface as TensorBoardSink so call sites don't care."""

    def __init__(self, common_cfg, enabled: bool = True) -> None:
        """``enabled``: False on the ranks past 0 of a multi-process run (no sink)."""
        self.sinks = [] if not enabled else [
            TensorBoardSink(getattr(common_cfg, "tensorboard_logdir", None)),
            JsonlSink(getattr(common_cfg, "metrics_jsonl", None)),
            WandbSink(getattr(common_cfg, "wandb_project", None)),
            AzureMLSink(getattr(common_cfg, "azureml_logging", False)),
        ]

    def scalars(self, stats, step, prefix="train"):
        for s in self.sinks:
            s.scalars(stats, step, prefix)

    def audio(self, tag, wav, step, sample_rate=16000):
        for s in self.sinks:
            s.audio(tag, wav, step, sample_rate=sample_rate)

    def close(self):
        for s in self.sinks:
            s.close()
