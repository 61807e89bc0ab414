"""The speech heads through the weight bridge: the port's SpeechLLMModel,
SpeechNoLLMModel (modality modes 0 and 1) and SpeechE2EModel (the tiny
32-channel vocoder) whole at SpeechConfig.tiny() against the flax models on
the same weights (BatchNorm statistics and mask embeddings randomized) and
numpy inputs; ``synthesize``; the query-slot gather and the mel lengths;
each tree's strict load and bit-for-bit round trip."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t, to_numpy_tree

from multimodalvc_tpu.models import speech as jsp
from multimodalvc_tpu.nn import hifigan as jhg
from multimodalvc_tpu_torch.interop.from_flax import state_dict_to_flax_variables
from multimodalvc_tpu_torch.models import speech as tsp
from multimodalvc_tpu_torch.models import vocoder as tvoc
from multimodalvc_tpu_torch.nn import hifigan as thg

TOL = 1e-4  # f32 through the encoders, the trunk and the Conformer
KEY = jax.random.PRNGKey(0)
# tests/test_speech_models.py's E2E vocoder: 32 channels, one MRF kernel
TINY_VOCODER = dict(upsample_initial_channel=32, upsample_factors=(10, 4, 2, 2),
                    upsample_kernel_sizes=(20, 8, 4, 4), resblock_kernel_sizes=(3,),
                    resblock_dilations=((1, 3, 5),))


def _batch(cfg, b=2):
    rng = np.random.default_rng(0)
    t_v = cfg.max_video_frames
    audio_lengths = np.resize([cfg.max_mel_frames * 160, cfg.max_mel_frames * 80 + 37], b)
    return {
        "audio_feats": rng.standard_normal((b, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((b, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.resize([t_v, t_v // 2], b).astype(np.int32),
        "instruction": rng.integers(1, 200, (b, 4)).astype(np.int32),
        "audio_lengths": audio_lengths.astype(np.int32),
    }


def _torch_batch(batch, **extra):
    return {**{k: t(x) for k, x in batch.items()}, **extra}


def _check_tree(tm, variables):
    """Strict load (``loaded``) is done; the port's state_dict goes back to
    the flax tree bit for bit, batch_stats included."""
    back = state_dict_to_flax_variables(tm.state_dict(), variables)
    assert set(back) == set(variables)
    jax.tree.map(np.testing.assert_array_equal, back, to_numpy_tree(variables))


def test_extract_query_hiddens():
    hidden = np.random.default_rng(1).standard_normal((3, 10, 4)).astype(np.float32)
    q_lens = np.asarray([3, 5, 0], np.int32)
    want = jsp.extract_query_hiddens(jnp.asarray(hidden), jnp.asarray(q_lens), 6)
    got = tsp.extract_query_hiddens(t(hidden), t(q_lens), 6)
    assert max_err(want, got) == 0.0


def test_mel_lengths_from_samples():
    samples = np.asarray([16000, 8320, 100, 0, 256000], np.int32)
    want = jsp.mel_lengths_from_samples(jnp.asarray(samples))
    got = tsp.mel_lengths_from_samples(t(samples))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.dtype == torch.int32 and got.tolist() == [100, 52, 1, 1, 1600]


def test_speech_config_matches_jax():
    for make in ("tiny", None):
        j = getattr(jsp.SpeechConfig, make)() if make else jsp.SpeechConfig()
        p = getattr(tsp.SpeechConfig, make)() if make else tsp.SpeechConfig()
        for f in dataclasses.fields(p):
            if f.name not in ("whisper", "avhubert", "llama"):
                assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert p.max_queries == j.max_queries


def test_speech_nollm_matches_jax():
    cfg = dataclasses.replace(jsp.SpeechConfig.tiny(), modality_dropout=True)
    batch = _batch(cfg)
    jm = jsp.SpeechNoLLMModel(cfg)
    variables = randomize(jax.jit(jm.init)(KEY, {**batch, "modality_mode": np.int32(0)}))
    apply = jax.jit(jm.apply)
    system = tsp.SpeechNoLLMSystem(dataclasses.replace(tsp.SpeechConfig.tiny(),
                                                       modality_dropout=True), device="cpu")
    loaded(system.module, variables)
    _check_tree(system.module, variables)
    mels = {}
    for mode in (0, 1):
        want = apply(variables, {**batch, "modality_mode": np.int32(mode)})
        got = system(_torch_batch(batch, modality_mode=torch.tensor(mode)))
        assert got["melspec"].shape == (2, cfg.max_mel_frames, 128)
        np.testing.assert_array_equal(np.asarray(want["mel_lengths"]), got["mel_lengths"].numpy())
        assert max_err(want["melspec"], got["melspec"]) < TOL, mode
        mels[mode] = got["melspec"]
    assert (mels[1] - mels[0]).abs().max() > 1e-3

    # synthesize: each row's mel cut to its frames, then the vocoder (held
    # against JAX in tests/test_torch_hifigan.py)
    voc = tvoc.VocoderModel(tvoc.VocoderConfig(generator=thg.HifiGanConfig(**TINY_VOCODER)),
                            device="cpu")
    voc.init_random(0)
    wavs = tsp.synthesize(system, voc, _torch_batch(batch))
    for i, n in enumerate((80, 40)):
        assert torch.equal(wavs[i], voc.generate(mels[0][i:i + 1, :n])[0])


def test_speech_llm_matches_jax():
    cfg = jsp.SpeechConfig.tiny()
    batch = _batch(cfg)
    jm = jsp.SpeechLLMModel(cfg)
    variables = randomize(jax.jit(jm.init)(KEY, batch))
    want = jax.jit(jm.apply)(variables, batch)
    system = tsp.SpeechLLMSystem(tsp.SpeechConfig.tiny(), device="cpu")
    loaded(system.module, variables)
    _check_tree(system.module, variables)
    got = system(_torch_batch(batch))
    np.testing.assert_array_equal(np.asarray(want["mel_lengths"]), got["mel_lengths"].numpy())
    assert max_err(want["melspec"], got["melspec"]) < TOL


def test_speech_e2e_matches_jax():
    cfg = jsp.SpeechConfig.tiny()
    batch = _batch(cfg)
    jm = jsp.SpeechE2EModel(cfg, jhg.HifiGanConfig(**TINY_VOCODER))
    variables = randomize(jax.jit(jm.init)(KEY, batch))
    want = jax.jit(jm.apply)(variables, batch)
    system = tsp.SpeechE2ESystem(tsp.SpeechConfig.tiny(), thg.HifiGanConfig(**TINY_VOCODER),
                                 device="cpu")
    loaded(system.module, variables)
    _check_tree(system.module, variables)
    got = system(_torch_batch(batch))
    assert got["waveform"].shape == (2, cfg.max_mel_frames * 160, 1)
    assert max_err(want["waveform"], got["waveform"]) < TOL
    # row 1 (40 frames): past 40 * 160 + 3 samples only conv_post's bias reaches the output
    tail = got["waveform"][1, 40 * 160 + 3:, 0]
    assert torch.equal(tail, torch.tanh(system.module.generator.conv_post.bias).expand_as(tail))


def test_systems_default_to_the_card():
    import inspect

    for cls in (tsp.SpeechLLMSystem, tsp.SpeechNoLLMSystem, tsp.SpeechE2ESystem,
                tvoc.VocoderModel):
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"


@pytest.mark.parametrize("variant", ["nollm", "e2e"])
def test_init_random_is_deterministic(variant):
    cfg = tsp.SpeechConfig.tiny()
    make = (lambda: tsp.SpeechNoLLMSystem(cfg, device="cpu")) if variant == "nollm" else \
        (lambda: tsp.SpeechE2ESystem(cfg, thg.HifiGanConfig(**TINY_VOCODER), device="cpu"))
    a, b = make(), make()
    a.init_random(3)
    b.init_random(3)
    for (name, x), y in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(x, y), name
