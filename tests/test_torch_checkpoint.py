"""The port's checkpoints (runtime/checkpoint.py, torch's own format): a
trainer's model, Adam moments, step and generator state round trip bit for
bit, and a resumed run's next step equals the uninterrupted one; keep-N,
best-by-metric, the crash-safe swap; and ``filter_frozen`` and
``average_checkpoints`` against the JAX package's."""
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_train import avsr_batch
from torch_parity import loaded, randomize, t, to_numpy_tree

from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.runtime import checkpoint as jckpt
from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.runtime import checkpoint as tckpt
from multimodalvc_tpu_torch.runtime.trainer import Trainer


@pytest.fixture(scope="module")
def tiny():
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = avsr_batch(cfg)
    variables = randomize(jsys.init(jax.random.PRNGKey(0), batch))
    return jsys, variables, {k: t(v) for k, v in batch.items()}


def _trainer(variables):
    """A trainer of the tiny model with its training loss (dropout on, from
    the trainer's generator), the mms-llama optimizer."""
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    loaded(tsys.module, variables)
    cfg = OptimizationConfig(lr=1e-3, warmup_updates=1, max_update=20)
    return Trainer(tsys.make_trainer_loss_fn(), tsys.module, cfg, tsys.frozen_patterns(), seed=3)


def _assert_same_state(a, b):
    """Nested states equal: tensors bit for bit, everything else by ==."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_state(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_round_trip_and_resume(tiny, tmp_path):
    """Save after step 3, restore into a fresh trainer: every leaf, Adam
    moment, counter, the step and the generator come back bit for bit, and
    the restored trainer's step 4 equals the uninterrupted run's."""
    _, variables, batch = tiny
    a = _trainer(variables)
    for _ in range(3):
        a.train_step(batch)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(a.state_dict(), a.step)
    b = _trainer(variables)
    b.load_state_dict(mgr.restore())
    _assert_same_state(a.state_dict(), b.state_dict())
    assert b.step == 3 and mgr.meta["step"] == 3
    ma, mb = a.train_step(batch), b.train_step(batch)
    assert ma == mb
    for n in a.master:
        assert torch.equal(a.master[n], b.master[n])
        assert torch.equal(a.params[n], b.params[n])
    # a restore may name a part of what was saved
    part = mgr.restore({"step": None, "optimizer": {"count": None}})
    assert part == {"step": 3, "optimizer": {"count": 3}}
    # without the frozen leaves the checkpoint still resumes the trainable state
    small = a.state_dict(include_frozen=False)
    assert set(small["model"]) == set(a.master)


def test_keep_n_and_best(tiny, tmp_path):
    _, variables, _ = tiny
    a = _trainer(variables)
    mgr = tckpt.CheckpointManager(str(tmp_path), best_metric="loss", save_interval_updates=2,
                                  keep_interval_updates=2)
    for step, loss in zip(range(1, 9), [5.0, 4.0, 4.5, 3.0, 3.5, 3.2, 2.9, 3.1]):
        a._step = step
        mgr.save(a.state_dict(include_frozen=False), step, val_metrics={"loss": loss})
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("checkpoint_"))
    assert names == ["checkpoint_6", "checkpoint_8", "checkpoint_best", "checkpoint_last"]
    assert mgr.best_value == 2.9 and mgr.restore(name="checkpoint_best")["step"] == 7
    assert mgr.restore()["step"] == 8
    # the best value survives a new manager; maximizing keeps the largest
    assert tckpt.CheckpointManager(str(tmp_path)).best_value == 2.9
    up = tckpt.CheckpointManager(str(tmp_path / "acc"), best_metric="accuracy", maximize=True)
    for step, acc in [(1, 0.2), (2, 0.5), (3, 0.4)]:
        a._step = step
        up.save({"step": step}, step, val_metrics={"accuracy": acc})
    assert up.restore(name="checkpoint_best")["step"] == 2
    assert up.restore(name="checkpoint_9") is None


def test_crash_safe_swap(tmp_path):
    """A stray .tmp (a crash mid-save) and .old are removed when a manager
    starts; the complete checkpoint under the name is kept."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save({"step": 1, "w": torch.arange(4)}, 1)
    os.makedirs(tmp_path / "checkpoint_last.tmp")
    os.makedirs(tmp_path / "checkpoint_last.old")
    again = tckpt.CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_last", "meta.json"]
    assert torch.equal(again.restore()["w"], torch.arange(4))
    mgr.save({"step": 2, "w": torch.arange(5)}, 2)
    assert torch.equal(again.restore()["w"], torch.arange(5))


def test_filter_frozen_matches_jax(tiny):
    """The export without the frozen leaves names what the JAX
    filter_frozen keeps, leaf for leaf (and the kept leaves cross the
    reverse bridge back into the JAX tree unchanged)."""
    jsys, variables, _ = tiny
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    loaded(tsys.module, variables)
    want = jckpt.filter_frozen(to_numpy_tree(variables["params"]), jsys.frozen_patterns())
    got = tckpt.filter_frozen(dict(tsys.module.named_parameters()), tsys.frozen_patterns())
    assert set(got) == set(flax_to_state_dict({"params": want}))
    back = state_dict_to_flax(got, want)
    jax.tree.map(np.testing.assert_array_equal, back, want)


def test_average_checkpoints_matches_jax():
    rng = np.random.default_rng(2)
    trees = [{"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32),
              "step": np.asarray(i + 10, np.int32)} for i in range(3)]
    want = jckpt.average_checkpoints(trees)
    got = tckpt.average_checkpoints([jax.tree.map(t, tr) for tr in trees])
    np.testing.assert_array_equal(want["a"]["w"], got["a"]["w"].numpy())
    np.testing.assert_array_equal(want["b"], got["b"].numpy())
    assert int(got["step"]) == int(want["step"]) == 12
