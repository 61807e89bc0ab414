"""The port's ``cli.generate`` on the CPU: ``synthesize`` against the JAX
command (the same clip at the tiny preset gives a wav of the same length;
the weights are random on both sides, from different generators), from a
speech training run's checkpoint, bit for bit its speech head's mel through
``vocode``;
``vocode`` from a vocoder training checkpoint (its EMA or its trained
generator, bit for bit the model's own ``generate``) and from a reference
``.pt`` (against the JAX command on the same file: the waveforms to 1e-5 of
their peak, f32 convolutions summed in other orders)."""
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from test_torch_vocoder_train import _reference_generator_state
from torch_parity import t  # noqa: F401 (sets one torch thread)

from multimodalvc_tpu.cli import generate as jgen
from multimodalvc_tpu.models import vocoder as jvoc
from multimodalvc_tpu_torch.cli import generate as tgen
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
from multimodalvc_tpu_torch.data.audio import hifigan_mel_np, read_wav
from multimodalvc_tpu_torch.models import vocoder as tvoc
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

from tests.fixtures import make_corpus

PT_TOL = 1e-5


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root, _ = make_corpus(str(tmp_path_factory.mktemp("gencorpus")), frame_sizes=(10, 14, 16))
    return root, f"{root}/data/clip2.npy", f"{root}/data/clip2.wav"


def run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["generate", *argv])
    jgen.main()


def read(path):
    sr, wav = wavfile.read(path)
    assert sr == 16000 and wav.dtype == np.float32 and np.isfinite(wav).all()
    return wav


def test_synthesize_matches_jax_length(clip, tmp_path, monkeypatch):
    _, video, audio = clip
    # the JAX command's random vocoder comes from init_state, which builds the
    # whole GAN state (~50 s on the CPU): its generator's init alone here
    monkeypatch.setattr(jvoc.VocoderModel, "init_state", lambda self, rng, mel_frames=52: (
        types.SimpleNamespace(gen_params=self.generator.init(
            rng, jnp.zeros((1, mel_frames, self.cfg.generator.in_channels)))["params"])))
    args = ["synthesize", "--video", video, "--audio", audio, "--preset", "tiny"]
    run_jax(monkeypatch, [*args, "--out", str(tmp_path / "jax.wav")])
    tgen.main([*args, "--out", str(tmp_path / "port.wav"), "--device", "cpu"])
    want, got = read(tmp_path / "jax.wav"), read(tmp_path / "port.wav")
    assert got.shape == want.shape and got.shape[0] == 16 * 640  # 16 frames, 4 mel each
    assert np.abs(got).max() > 0


def test_synthesize_from_training_checkpoint_then_vocode(clip, tmp_path):
    """A NoLLM speech head trained 2 updates through ``cli.train`` (its
    checkpoint holds the whole module) synthesizes from it; its mel vocodes
    from a vocoder checkpoint to the model's own ``generate``, EMA or not,
    and with the EMA to exactly the synthesized wav."""
    root, video, audio = clip
    save_dir = str(tmp_path / "speech")
    ttrain.main(from_dict(TrainRootConfig, {
        "common": {"log_interval": 1, "compute_dtype": "float32"},
        "dataset": {"data": root, "max_tokens": 64, "num_workers": 0,
                    "required_batch_size_multiple": 1},
        "optimization": {"max_update": 2, "lr": 1e-3, "warmup_updates": 1},
        "checkpoint": {"save_dir": save_dir, "best_checkpoint_metric": "mel_l1"},
        "task": {"name": "speech_training", "variant": "nollm", "max_video_frames": 16,
                 "length_buckets": [16], "max_mel_frames": 80},
        "model": {"name": "mms_speech_nollm", "preset": "tiny"},
    }), device="cpu")
    state = CheckpointManager(save_dir).restore()
    system = tgen.load_speech(save_dir, "tiny", "cpu")
    assert set(state["model"]) >= set(system.module.state_dict())

    voc = tvoc.VocoderModel(device="cpu")
    voc.init_random(5)
    voc.init_state(5)
    with torch.no_grad():  # the EMA and the trained generator differ
        for e in voc.ema.values():
            e.mul_(0.9)
    CheckpointManager(str(tmp_path / "voc")).save(voc.state_dict(), 0)

    mel = str(tmp_path / "mel.npy")
    tgen.main(["synthesize", "--video", video, "--audio", audio, "--preset", "tiny",
               "--checkpoint", save_dir, "--vocoder-checkpoint", str(tmp_path / "voc/checkpoint_last"),
               "--out", str(tmp_path / "synth.wav"), "--device", "cpu"])
    with torch.no_grad():
        out = system(tgen.clip_batch(video, audio, system.cfg, "tiny", "cpu"))
    m = out["melspec"][0, : int(out["mel_lengths"][0])].numpy()
    np.save(mel, m)
    assert m.shape == (64, 128) and np.isfinite(m).all()
    assert read(tmp_path / "synth.wav").shape == (64 * 160,)
    for ema in (True, False):
        out = str(tmp_path / f"voc_{ema}.wav")
        tgen.main(["vocode", "--mel", mel, "--checkpoint", str(tmp_path / "voc/checkpoint_last"),
                   "--out", out, "--device", "cpu", "--ema" if ema else "--no-ema"])
        weights = voc.ema if ema else voc.gen_master
        check = tvoc.VocoderModel(device="cpu")
        check.generator.load_state_dict(weights, strict=False)
        want = np.clip(check.generate(torch.from_numpy(m)[None])[0].numpy(), -1, 1)
        np.testing.assert_array_equal(read(out), want)
    np.testing.assert_array_equal(read(tmp_path / "synth.wav"), read(tmp_path / "voc_True.wav"))


def test_vocode_reference_pt_matches_jax(clip, tmp_path, monkeypatch):
    voc = tvoc.VocoderModel(device="cpu")
    torch.save({"generator": _reference_generator_state(voc)}, tmp_path / "ref.pt")
    _, _, audio = clip
    np.save(tmp_path / "mel.npy", hifigan_mel_np(read_wav(audio))[:20])
    args = ["vocode", "--mel", str(tmp_path / "mel.npy"), "--checkpoint", str(tmp_path / "ref.pt")]
    run_jax(monkeypatch, [*args, "--out", str(tmp_path / "jax.wav")])
    tgen.main([*args, "--out", str(tmp_path / "port.wav"), "--device", "cpu"])
    want, got = read(tmp_path / "jax.wav"), read(tmp_path / "port.wav")
    assert got.shape == want.shape == (20 * 160,)
    assert np.abs(got - want).max() <= PT_TOL * max(1.0, np.abs(want).max())
