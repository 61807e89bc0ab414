"""The port's weight-import command line against the JAX package's, on the CPU:
``checkpoint.init_from_pt`` writes the leaves that the JAX training loop's
path writes (``load_pt`` -> ``import_reference_avsr`` -> ``merge_subtree``
over the same init weights, through ``flax_to_state_dict``); ``inspect_checkpoint``
prints the JAX tool's lines for the same ``.pt`` and numpy checkpoint; and
``demo --device cpu`` prints the JAX demo's transcript for the same clip,
the port restoring a checkpoint of the weights that the JAX demo's init
gives and the JAX demo restoring none."""
import argparse
import contextlib
import io
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from torch_parity import jax_variables

import chip_smoke
from multimodalvc_tpu.cli import demo as jdemo
from multimodalvc_tpu.cli import inspect_checkpoint as jinspect
from multimodalvc_tpu.interop import avsr_import as jai
from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.runtime.pt_loader import flatten_state_dict as jflatten
from multimodalvc_tpu.runtime.pt_loader import load_pt as jload
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.cli import demo as tdemo
from multimodalvc_tpu_torch.cli import inspect_checkpoint as tinspect
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn.init import init_random_
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager


@pytest.fixture(scope="module")
def product(tmp_path_factory):
    """A reference product .pt of the tiny AVSR's trainables (random, seed 5),
    with an ``args`` Namespace and an int64 step beside the model."""
    module = tavsr.AVSRModel(tavsr.AVSRConfig.tiny())
    init_random_(module, 5)
    sd = module.state_dict()
    state = chip_smoke.product_state({k: v for k, v in sd.items()
                                      if re.search(chip_smoke.PRODUCT_KEY, k)})
    path = tmp_path_factory.mktemp("product") / "product.pt"
    torch.save({"model": state, "args": argparse.Namespace(lr=1e-4),
                "num_updates": torch.tensor(1200)}, path)
    return path


def _init_batch(cfg):
    rng = np.random.default_rng(0)
    t_v = cfg.max_video_frames
    return {"audio_feats": rng.standard_normal((2, 80, 2 * cfg.whisper.max_frames)).astype(np.float32),
            "video": rng.standard_normal((2, t_v, 24, 24, 1)).astype(np.float32),
            "video_lengths": np.asarray([t_v, t_v // 2], np.int32),
            "instruction": np.ones((2, 5), np.int32), "labels": np.ones((2, 4), np.int32),
            "label_lengths": np.asarray([4, 2], np.int32)}


class _Built(Exception):
    """Raised by a stand-in Trainer: the loop got as far as building it."""


def test_init_from_pt_writes_the_jax_leaves(product, monkeypatch):
    cfg = javsr.AVSRConfig.tiny()
    base = tavsr.AVSRModel(tavsr.AVSRConfig.tiny())
    init_random_(base, 7)
    variables = jax_variables(javsr.AVSRSystem(cfg).module.init, _init_batch(cfg), base)
    raw = jload(str(product))
    n = jai.merge_subtree(variables["params"],
                          jai.import_reference_avsr(jflatten(raw.get("model", raw))))
    want = flax_to_state_dict(variables)

    seen = {}

    def trainer(loss_fn, module, *a, **k):
        seen.update({k: v.clone() for k, v in module.state_dict().items()})
        raise _Built

    monkeypatch.setattr(ttasks.AVSRTask, "init_random",
                        lambda self, seed=0: self.system.module.load_state_dict(base.state_dict()))
    monkeypatch.setattr(ttasks.AVSRTask, "load_dataset", lambda self, subset: None)
    monkeypatch.setattr(ttrain, "Trainer", trainer)
    tcfg = from_dict(TrainRootConfig, {
        "common": {"compute_dtype": "float32"},
        "checkpoint": {"init_from_pt": str(product)},
        "task": {"name": "avsr_training"},
        "model": {"name": "mms_llama_avsr", "preset": "tiny"}})
    with pytest.raises(_Built):
        ttrain.main(tcfg, device="cpu")
    assert n == len(torch.load(product, weights_only=False)["model"])
    assert sorted(seen) == sorted(want)
    for key, x in seen.items():
        assert torch.equal(x, want[key]), key


def _printed(main, argv, monkeypatch=None) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["prog", *argv])
            main()
    return out.getvalue()


@pytest.mark.parametrize("what", ["pt_depth1", "pt_keys_depth2", "numpy_dir"])
def test_inspect_checkpoint_prints_the_jax_lines(what, product, tmp_path, monkeypatch):
    path = str(product)
    argv = {"pt_depth1": ["--depth", "1"], "pt_keys_depth2": ["--keys"],
            "numpy_dir": ["--keys", "--depth", "3"]}[what]
    if what == "numpy_dir":
        flat = jflatten(jload(path))
        np.savez(tmp_path / "arrays.npz", **{k.replace(".", "/"): v for k, v in flat.items()})
        path = str(tmp_path)
    want = _printed(jinspect.main, [path, *argv], monkeypatch)
    got = _printed(tinspect.main, [path, *argv])
    assert got == want and "keys," in got


def test_inspect_checkpoint_reads_the_port_checkpoint(product, tmp_path):
    """A checkpoint directory of the port (``state.pt``) lists what the same
    state lists as a ``.pt``; a directory with neither file is refused."""
    state = torch.load(product, weights_only=False)
    CheckpointManager(str(tmp_path / "ckpt")).save(state, step=1)
    got = _printed(tinspect.main, [str(tmp_path / "ckpt" / "checkpoint_last"), "--keys"])
    assert got == _printed(tinspect.main, [str(product), "--keys"])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="cannot read"):
        tinspect.main([str(tmp_path / "orbax")])


def test_demo_prints_the_jax_transcript(tmp_path, monkeypatch):
    """Both demos on one clip of 16 frames (96 x 96 uint8 .npy, its 0.64 s
    16 kHz wav) with the tiny AVSR in f32, beam 3, 12 tokens; an f32 decode
    cache on both sides (ROADMAP's near-tie note).  The JAX demo's init
    gives a seeded port model's weights, so the JAX init is not compiled;
    the port demo restores a checkpoint of the same weights."""
    rng = np.random.default_rng(3)
    np.save(tmp_path / "clip.npy", rng.integers(0, 256, (16, 96, 96), dtype=np.uint8))
    n = 16 * 640
    wav = 0.1 * np.sin(2 * np.pi * 180 * np.arange(n) / 16000) + 0.02 * rng.standard_normal(n)
    wavfile.write(tmp_path / "clip.wav", 16000, (wav * 32767).astype(np.int16))
    overrides = ["task.name=avsr_training", "task.llm_path=null", "model.name=mms_llama_avsr",
                 "model.preset=tiny", "common.compute_dtype=float32",
                 "checkpoint.restore_file=checkpoint_last"]
    args = ["--config", "", "--video", str(tmp_path / "clip.npy"), "--audio",
            str(tmp_path / "clip.wav"), "--beams", "3", "--max-len", "12"]
    weights = tavsr.AVSRModel(tavsr.AVSRConfig.tiny())
    init_random_(weights, 3)
    beams = []
    real_jgen, real_tgen = javsr.AVSRSystem.generate, tavsr.AVSRSystem.generate

    def jgen(self, *a, **k):
        beams.append(np.asarray(real_jgen(self, *a, cache_dtype=jnp.float32, **k)[0]))
        return beams[-1], None

    def tgen(self, *a, **k):
        beams.append(real_tgen(self, *a, cache_dtype=torch.float32, **k)[0].numpy())
        return torch.from_numpy(beams[-1]), None

    monkeypatch.setattr(javsr.AVSRSystem, "init",
                        lambda self, rng, batch: jax_variables(self.module.init, batch, weights))
    monkeypatch.setattr(javsr.AVSRSystem, "generate", jgen)
    monkeypatch.setattr(tavsr.AVSRSystem, "generate", tgen)

    want = _printed(jdemo.main, args + overrides + [f"checkpoint.save_dir={tmp_path}/none"],
                    monkeypatch)
    CheckpointManager(str(tmp_path / "port")).save({"model": weights.state_dict()}, step=0)
    got = _printed(tdemo.main, args + ["--device", "cpu"] + overrides
                   + [f"checkpoint.save_dir={tmp_path}/port"])
    np.testing.assert_array_equal(beams[1], beams[0])
    assert want.startswith("TRANSCRIPT:") and got == want
