"""The runtime helpers the port's command line calls, on the CPU: the metric
aggregation and log line against the JAX package's, the JSONL sink, the
failure tools (non-finite tensors, the step watchdog, the OOM batch split),
``load_ensemble`` and ``common.profile``'s trace."""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch_parity import t  # noqa: F401 (sets one torch thread)

from multimodalvc_tpu.runtime import metrics as jmetrics
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
from multimodalvc_tpu_torch.runtime import debug, metrics
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager, load_ensemble

from tests.fixtures import make_corpus

UPDATES = [{"loss": 2.5, "accuracy": 0.25, "n_tokens": 12, "skip": "text"},
           {"loss": 1.5, "accuracy": float("nan"), "n_tokens": 10},
           {"loss": 0.5, "gnorm": 3.0}]


def test_metrics_match_jax(tmp_path):
    want, got = jmetrics.MetricsAggregator(), metrics.MetricsAggregator()
    for u in UPDATES:
        want.update(u)
        got.update(u)
    w, g = want.snapshot(), got.snapshot()
    assert w.keys() == g.keys() and {k: w[k] for k in w if k != "ups"} == \
        {k: g[k] for k in g if k != "ups"}
    assert g["accuracy"] == 0.25 and g["loss"] == 1.5  # NaN updates are left out
    stats = {k: v for k, v in g.items() if k != "ups"}
    assert metrics.format_stats(stats, 7, "valid") == jmetrics.format_stats(stats, 7, "valid")
    got.reset()
    assert got.snapshot().keys() == {"ups"}
    path = str(tmp_path / "m.jsonl")
    sinks = metrics.MetricSinks(from_dict(TrainRootConfig,
                                          {"common": {"metrics_jsonl": path}}).common)
    sinks.scalars(stats, 3, "train")
    sinks.audio("x", np.zeros(4), 3)  # no sink takes audio here
    sinks.close()
    with open(path) as f:
        assert json.loads(f.read()) == {"step": 3, "split": "train", **stats}
    assert all(s._run is None for s in sinks.sinks[2:])  # W&B and AzureML off


def test_find_nonfinite():
    module = torch.nn.Linear(3, 2)
    assert debug.find_nonfinite(module) == []
    with torch.no_grad():
        module.weight[0, 1] = float("nan")
        module.bias[1] = float("inf")
    assert debug.find_nonfinite(module, "p/") == ["p/weight (1/6 non-finite)",
                                                  "p/bias (1/2 non-finite)"]
    assert debug.find_nonfinite({"i": torch.arange(3), "f": torch.ones(2)}) == []


def test_watchdog_fires_only_past_its_timeout():
    with debug.Watchdog(0.05) as fast:
        pass
    time.sleep(0.1)
    assert not fast.fired
    with debug.Watchdog(0.05) as slow:
        time.sleep(0.3)
    assert slow.fired


def test_oom_batch_split():
    calls = []

    def step(batch):
        rows = batch["x"].shape[0]
        calls.append(rows)
        if rows > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return float(batch["x"].sum())

    batch = {"x": torch.arange(7.0), "scalar": torch.tensor(1.0)}
    out = debug.with_oom_batch_split(step, batch)
    assert calls == [7, 3, 1, 2, 4, 2, 2] and out == [0.0, 3.0, 7.0, 11.0]
    assert sum(out) == float(batch["x"].sum())
    with pytest.raises(ValueError):
        debug.with_oom_batch_split(lambda b: (_ for _ in ()).throw(ValueError("no")), batch)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        debug.with_oom_batch_split(step, batch, max_splits=0)


def test_load_ensemble(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for name, v in (("a", 1.0), ("b", 3.0)):
        mgr._write({"model": {"w": torch.full((2,), v), "n": torch.tensor(int(v))}}, name)
    both = load_ensemble(mgr, "a, b")
    assert [float(s["model"]["w"][0]) for s in both] == [1.0, 3.0]
    (avg,) = load_ensemble(mgr, "a,b", mode="average")
    assert torch.equal(avg["model"]["w"], torch.full((2,), 2.0))
    assert int(avg["model"]["n"]) == 3  # integer leaves keep the last member's
    assert load_ensemble(mgr, "missing") is None
    with pytest.raises(FileNotFoundError, match="missing"):
        load_ensemble(mgr, "a,missing")
    assert len(load_ensemble(mgr, "a,missing", strict=False)) == 1


def test_profile_writes_a_trace(tmp_path):
    root, _ = make_corpus(str(tmp_path / "corpus"), n=3, frame_sizes=(10,))
    cfg = from_dict(TrainRootConfig, {
        "common": {"compute_dtype": "float32", "profile": True,
                   "profile_dir": str(tmp_path / "prof")},
        "dataset": {"data": root, "max_tokens": 32, "num_workers": 0,
                    "required_batch_size_multiple": 1, "disable_validation": True},
        "optimization": {"max_update": 1},
        "checkpoint": {"save_dir": str(tmp_path / "ckpt")},
        "task": {"name": "avsr_training", "max_video_frames": 16, "max_label_tokens": 16,
                 "length_buckets": [16]},
        "model": {"name": "mms_llama_avsr", "preset": "tiny"}})
    val = ttrain.main(cfg, device="cpu")
    assert np.isfinite(val["loss"])
    (trace,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        assert json.load(f)["traceEvents"]
