"""The port's ``dummy_avsr`` task (``multimodalvc_tpu_torch/benchmark``)
against the JAX package's, on the CPU.

The fabricated batch is the JAX one bit for bit, at the default (full
width) and the tiny configurations.  Then ``cli.train`` on the tiny tree of
tests/test_cli_integration.py::test_cli_dummy_benchmark_task, 2 updates,
on both sides: from the JAX run's initial parameters (carried into the
port through ``interop/from_flax.py``), without dropout, AdamW's eps at
1e-5 and f32, as tests/test_torch_cli.py's ``runs``; the per-update losses
agree to rel 1e-5.  The JAX run has validation off: the JAX task's
``prepare_batch`` takes no ``train`` flag, so the JAX loop's validation of
it raises.  The port's run validates after its updates (the port's task
takes the flag), which leaves the losses of the updates as they were."""
import dataclasses

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch_parity import loaded, to_numpy_tree

from multimodalvc_tpu import benchmark as jbench
from multimodalvc_tpu.cli import train as jtrain
from multimodalvc_tpu.config import TrainRootConfig as JaxRoot
from multimodalvc_tpu.config import from_dict as jax_from_dict
from multimodalvc_tpu.models.avsr import AVSRConfig as JaxAVSRConfig
from multimodalvc_tpu.parallel import mesh as jmesh
from multimodalvc_tpu_torch import benchmark as tbench
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
from multimodalvc_tpu_torch.config.registry import lookup
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.models.avsr import AVSRConfig

from tests.test_torch_cli import LogTap

LOSS_RTOL = 1e-5
TINY_TASK = {"batch_size": 2, "video_frames": 16, "crop": 24, "label_tokens": 6, "n_batches": 3}


def dummy_tree(save_dir, validation=False):
    return {
        "common": {"log_interval": 1, "compute_dtype": "float32"},
        "mesh": {"data": -1},
        "dataset": {"data": "/unused", "num_workers": 0, "disable_validation": not validation},
        "optimization": {"max_update": 2, "max_epoch": 1, "warmup_updates": 1, "adam_eps": 1e-5},
        "checkpoint": {"save_dir": save_dir},
        "task": {"name": "dummy_avsr", **TINY_TASK},
        "model": {"name": "mms_llama_avsr", "preset": "tiny"},
    }


@pytest.mark.parametrize("preset", ["default", "tiny"])
def test_fabricated_batch_is_the_jax_one(preset):
    task = {} if preset == "default" else TINY_TASK
    jcfg, tcfg = jbench.DummyAVSRTaskConfig(**task), tbench.DummyAVSRTaskConfig(**task)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = JaxAVSRConfig() if preset == "default" else JaxAVSRConfig.tiny()
    tmodel = AVSRConfig() if preset == "default" else AVSRConfig.tiny()
    want_ds, got_ds = jbench._DummyDataset(jcfg, jmodel), tbench._DummyDataset(tcfg, tmodel)
    assert len(got_ds) == len(want_ds)
    want_idx, got_idx = want_ds.batches(), got_ds.batches(max_tokens=1000, epoch=2)
    assert [i.tolist() for i in got_idx] == [i.tolist() for i in want_idx]
    want = want_ds.collate([want_ds[int(i)] for i in want_idx[1]])
    got = got_ds.load_batch(got_idx[1])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if preset == "default":  # a full 30 s Whisper window, t_v x 640 audio samples
        assert got["audio_feats"].shape == (4, 80, 3000)
        assert got["video"].shape == (4, 100, 88, 88, 1)
        assert (got["audio_lengths"] == 64000).all()


def test_the_task_is_registered():
    cls, cfg_cls = lookup("task", "dummy_avsr")
    assert cls is tbench.DummyAVSRTask and cfg_cls is tbench.DummyAVSRTaskConfig
    assert issubclass(cls, ttasks.AVSRTask)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port's cli.train runs of the dummy task (2 updates)."""
    out = tmp_path_factory.mktemp("dummy")
    start = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jtrain, "make_mesh",
                   lambda sizes: jmesh.make_mesh(sizes, devices=jax.devices()[:1]))
        real_trainer = jtrain.Trainer

        def trainer(loss_fn, params, collections, *a, **k):
            start.update(params=to_numpy_tree(params), **to_numpy_tree(collections))
            return real_trainer(loss_fn, params, collections, *a, **k)

        mp.setattr(jtrain, "Trainer", trainer)
        jtap = LogTap(mp, jtrain)
        jtrain.main(jax_from_dict(JaxRoot, dummy_tree(str(out / "jax"))))

        mp.setattr(ttasks.AVSRTask, "init_random",
                   lambda self, seed=0: loaded(self.system.module, start))
        mp.setattr(tavsr, "train_rng", lambda train, generator: None)
        ttap = LogTap(mp, ttrain)
        tasks = []
        real_build = ttrain.build_task
        mp.setattr(ttrain, "build_task", lambda *a, **k: tasks.append(real_build(*a, **k))
                   or tasks[-1])
        tval = ttrain.main(from_dict(TrainRootConfig, dummy_tree(str(out / "port"), True)),
                           device="cpu")
    return dict(jtap=jtap, ttap=ttap, tval=tval, tasks=tasks, out=out)


def test_train_losses_match_jax(runs):
    want = runs["jtap"].of("train")
    got = runs["ttap"].of("train")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    for (_, w), (step, g) in zip(want, got):
        for k in ("loss", "accuracy", "n_tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
        assert np.isfinite(g["loss"]) and g["data_ms"] >= 0 and g["step_ms"] > 0
    assert (runs["out"] / "port" / "checkpoint_last").is_dir()


def test_the_task_builds_as_avsr_task(runs):
    task = runs["tasks"][0]
    assert type(task) is tbench.DummyAVSRTask
    assert task.cfg.batch_size == 2 and task.model_cfg.whisper.max_frames == AVSRConfig.tiny(
        ).whisper.max_frames
    leaf = next(task.module.parameters())
    assert leaf.device.type == "cpu" and leaf.dtype == torch.float32


def test_validated_run_finishes(runs):
    valid = runs["ttap"].of("valid")
    assert [s for s, _ in valid] == [2]
    assert np.isfinite(valid[0][1]["loss"]) and np.isfinite(runs["tval"]["loss"])
