"""The port's ``cli.train`` and ``cli.eval`` against the JAX package's on the
tiny AVSR preset and the synthetic corpus of tests/fixtures.py, on the CPU.

Both CLIs start from the same weights (the JAX run's initial parameters,
carried into the port through ``interop/from_flax.py``), draw the same
noise and crops (the port's loader in this process; the JAX dataset's
generators are reset after its init draws a sample batch), and run without
dropout (flax ``Dropout`` as the identity; the port's training forward
without a generator), with AdamW's eps at 1e-5 on both sides, so that
Adam's first, sign-like update does not make rounding-sized gradient
elements into lr-sized differences.  f32 on both sides: the per-update
losses and the validation loss agree to rel 1e-5 (the two trainers part by
~1e-7 a step, tests/test_torch_trainer.py), the validation WER, the eval
hypotheses and the eval WER exactly.  Then the port alone: a mid-epoch
resume with noise, crops and two loader workers lands on the straight
run's state bit for bit, and what the port cannot run raises."""
import json
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch_parity import loaded, to_numpy_tree

from multimodalvc_tpu.cli import eval as jeval
from multimodalvc_tpu.cli import train as jtrain
from multimodalvc_tpu.config import TrainRootConfig as JaxRoot
from multimodalvc_tpu.config import from_dict as jax_from_dict
from multimodalvc_tpu.parallel import mesh as jmesh
from multimodalvc_tpu import tasks as jtasks
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.cli import eval as teval
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

from tests.fixtures import make_corpus

LOSS_RTOL = 1e-5
ADAM_EPS = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("torchcli")), frame_sizes=(10, 14, 16))


def avsr_tree(root, noise, save_dir, **task):
    return {
        "common": {"log_interval": 1, "compute_dtype": "float32"},
        "mesh": {"data": 1},
        "dataset": {"data": root, "max_tokens": 64, "num_workers": 0,
                    "required_batch_size_multiple": 1, "valid_wer_batches": 1},
        "optimization": {"max_update": 3, "lr": 1e-3, "warmup_updates": 2,
                         "adam_eps": ADAM_EPS},
        "checkpoint": {"save_dir": save_dir, "best_checkpoint_metric": "wer"},
        "generation": {"beam": 2, "max_len": 6},
        "task": {"name": "avsr_training", "noise_wav": noise, "noise_prob": 0.5,
                 "max_video_frames": 16, "max_label_tokens": 16, "length_buckets": [16],
                 "image_aug": True, **task},
        "model": {"name": "mms_llama_avsr", "preset": "tiny"},
    }


class LogTap:
    """The (prefix, step, stats) of every log_stats call of a CLI module."""

    def __init__(self, mp, module):
        self.lines = []
        real = module.log_stats
        mp.setattr(module, "log_stats", lambda stats, step, prefix="train", fmt="simple": (
            self.lines.append((prefix, step, dict(stats))), real(stats, step, prefix, fmt)))

    def of(self, prefix):
        return [(step, stats) for p, step, stats in self.lines if p == prefix]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX and the port's train + eval runs (3 updates, validation WER)."""
    root, noise = corpus
    out = tmp_path_factory.mktemp("runs")
    start, datasets = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jtrain, "make_mesh",
                   lambda sizes: jmesh.make_mesh(sizes, devices=jax.devices()[:1]))
        real_load = jtasks.AVSRTask.load_dataset
        mp.setattr(jtasks.AVSRTask, "load_dataset",
                   lambda self, subset: datasets.append(real_load(self, subset)) or datasets[-1])
        real_trainer = jtrain.Trainer

        def trainer(loss_fn, params, collections, *a, **k):
            # after the init's sample batch: the train dataset's generators
            # start over, as the port's do at its first batch
            start.update(params=to_numpy_tree(params), **to_numpy_tree(collections))
            ds = datasets[0]
            ds.rng = np.random.default_rng(ds.cfg.seed)
            ds.noise.rng = np.random.default_rng(ds.cfg.seed)
            return real_trainer(loss_fn, params, collections, *a, **k)

        mp.setattr(jtrain, "Trainer", trainer)
        jtap = LogTap(mp, jtrain)
        jcfg = jax_from_dict(JaxRoot, avsr_tree(root, noise, str(out / "jax")))
        jval = jtrain.main(jcfg)
        jres = jeval.main(jcfg, results_path=str(out / "jax_results"))

        mp.setattr(ttasks.AVSRTask, "init_random",
                   lambda self, seed=0: loaded(self.system.module, start))
        mp.setattr(tavsr, "train_rng", lambda train, generator: None)
        ttap = LogTap(mp, ttrain)
        tcfg = from_dict(TrainRootConfig, avsr_tree(root, noise, str(out / "port")))
        tval = ttrain.main(tcfg, device="cpu")
        tres = teval.main(tcfg, results_path=str(out / "port_results"), device="cpu")
    return dict(jtap=jtap, jval=jval, jres=jres, ttap=ttap, tval=tval, tres=tres, out=out)


def test_train_losses_match_jax(runs):
    want, got = runs["jtap"].of("train"), runs["ttap"].of("train")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    for (_, w), (step, g) in zip(want, got):
        for k in ("loss", "accuracy", "n_tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
        assert g["data_ms"] >= 0 and g["step_ms"] > 0
    # validation after each epoch (2 batches an epoch) and at the stop
    wv, gv = runs["jtap"].of("valid"), runs["ttap"].of("valid")
    assert [s for s, _ in gv] == [s for s, _ in wv] == [2, 3]
    for (_, w), (_, g) in zip(wv, gv):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["accuracy"], w["accuracy"], rtol=LOSS_RTOL)
        assert g["wer"] == w["wer"]
    assert set(runs["tval"]) == set(runs["jval"]) | {"ppl"}


def test_checkpoints_match_jax_layout(runs, corpus):
    for side in ("jax", "port"):
        names = set(os.listdir(runs["out"] / side))
        assert {"checkpoint_last", "checkpoint_best", "meta.json"} <= names, side
    meta = CheckpointManager(str(runs["out"] / "port")).meta
    assert meta["step"] == 3 and meta["epoch"] == 2 and meta["batch_offset"] == 1
    # the whole module, as the JAX checkpoint holds the whole params tree:
    # the frozen Whisper leaves too
    state = CheckpointManager(str(runs["out"] / "port")).restore()
    task = ttrain.build_task(from_dict(TrainRootConfig, avsr_tree(*corpus, "unused")), "cpu")
    assert set(state["model"]) == set(task.module.state_dict())
    assert any(k.startswith("encoder.whisper.") for k in state["model"])


def test_eval_matches_jax(runs):
    assert runs["tres"] == runs["jres"]
    out = runs["out"]
    (jhyp,) = [f for f in os.listdir(out / "jax_results") if f.startswith("hypo-")]
    (thyp,) = [f for f in os.listdir(out / "port_results") if f.startswith("hypo-")]
    assert thyp == jhyp  # the tag hashes the same generation options
    with open(out / "jax_results" / jhyp) as f, open(out / "port_results" / thyp) as g:
        assert json.load(g) == json.load(f)
    with open(out / "jax_results" / jhyp.replace("hypo-", "wer.").replace(".json", "")) as f, \
            open(out / "port_results" / thyp.replace("hypo-", "wer.").replace(".json", "")) as g:
        assert g.read() == f.read()


def test_midepoch_resume_matches_straight_run(corpus, tmp_path):
    """Stopped at update 2 (mid-epoch) and resumed to 5: the same validation
    metrics and the same checkpoint as the straight run, with noise, crops
    and two loader workers (each batch drawn from its own seed)."""
    root, noise = corpus

    def run(save_dir, max_update):
        tree = avsr_tree(root, noise, save_dir)
        tree["dataset"].update(max_tokens=30, num_workers=2, valid_wer_batches=0)
        tree["optimization"]["max_update"] = max_update
        tree["checkpoint"]["best_checkpoint_metric"] = "loss"
        return ttrain.main(from_dict(TrainRootConfig, tree), device="cpu")

    straight = run(str(tmp_path / "straight"), 5)
    run(str(tmp_path / "mid"), 2)
    meta = CheckpointManager(str(tmp_path / "mid")).meta
    assert meta["step"] == 2 and meta["batch_offset"] == 2
    resumed = run(str(tmp_path / "mid"), 5)
    assert CheckpointManager(str(tmp_path / "mid")).meta["step"] == 5
    for k in ("loss", "accuracy", "n_tokens"):
        assert resumed[k] == straight[k], k
    a = CheckpointManager(str(tmp_path / "straight")).restore()
    b = CheckpointManager(str(tmp_path / "mid")).restore()
    assert a["model"].keys() == b["model"].keys()
    for n in a["model"]:
        assert torch.equal(a["model"][n], b["model"][n]), n
    assert torch.equal(a["generator"], b["generator"])


def test_decode_leaves_the_live_module_unchanged(corpus):
    """Validation-time WER decodes with the training module itself (LoRA on):
    under inference mode, its weights stay bit for bit."""
    root, noise = corpus
    cfg = from_dict(TrainRootConfig, avsr_tree(root, noise, "unused"))
    task = ttrain.build_task(cfg, device="cpu")
    ds = task.load_dataset("valid")
    task.init_random(3)
    before = {n: x.clone() for n, x in task.module.state_dict().items()}
    raw = {k: torch.from_numpy(v) for k, v in ds.load_batch([0, 1, 2]).items()}
    hyps, refs = task.decode_to_text(task.prepare_batch(raw, train=False), [0, 1, 2], ds,
                                     cfg.generation)
    assert len(hyps) == 3 and refs == [ds.manifest.labels[i] for i in range(3)]
    for n, x in task.module.state_dict().items():
        assert torch.equal(x, before[n]), n
