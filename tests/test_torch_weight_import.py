"""The port's weight importers against the JAX package's, on the CPU.

The sources are a tiny port model with random weights (BatchNorm
statistics and LoRA ``lora_b`` drawn too) written out in the reference
layouts by chip_smoke.py's inverse maps (HF LLaMA and Whisper, the fairseq
AV-HuBERT with its weight-normed positional conv, the speech-rate
predictor, a product checkpoint's trainables) and, for the speech heads, by
this file's (the vendored Conformer, the heads, the ``vocoder_*``
generator).  Each importer's output equals the JAX importer's, through
``flax_to_state_dict``, key for key and bit for bit (the LoRA draws from
``default_rng(0)``, the tap-stacked ResNet stem and the folded positional
conv included).  Then whole models assembled from the sources in both
packages: the tiny AVSR gives the JAX beam tokens (an f32 cache, ROADMAP's
near-tie note), and ``import_reference_speech`` loads a NoLLM and an E2E
model whose mel and waveform equal the JAX models' within the speech
tolerance."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables, max_err, t, to_numpy_tree

import chip_smoke
from multimodalvc_tpu.interop import avsr_import as jai
from multimodalvc_tpu.interop import speech_import as jsi
from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.models import speech as jsp
from multimodalvc_tpu.nn import avhubert as jav
from multimodalvc_tpu.nn import hifigan as jhg
from multimodalvc_tpu.nn import llama as jl
from multimodalvc_tpu.nn import whisper as jw
from multimodalvc_tpu_torch.interop import avsr_import as tai
from multimodalvc_tpu_torch.interop import speech_import as tsi
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.models import speech as tsp
from multimodalvc_tpu_torch.nn import avhubert as tav
from multimodalvc_tpu_torch.nn import hifigan as thg
from multimodalvc_tpu_torch.nn import llama as tl
from multimodalvc_tpu_torch.nn import whisper as tw
from multimodalvc_tpu_torch.nn.init import init_random_

TOL = 1e-4  # tests/test_torch_speech.py's: f32 through the encoders, the head and the vocoder
TINY_VOCODER = dict(upsample_initial_channel=32, upsample_factors=(10, 4, 2, 2),
                    upsample_kernel_sizes=(20, 8, 4, 4), resblock_kernel_sizes=(3,),
                    resblock_dilations=((1, 3, 5),))
GEN = dict(num_beams=3, max_new_tokens=6, kv_quant="int8", ancestry_reorder=True)
KEY = jax.random.PRNGKey(0)


def randomized(module, seed):
    """``module``'s state dict after ``init_random_(seed)``, with its LoRA
    ``lora_b`` and BatchNorm statistics drawn too, so the imports carry
    them."""
    init_random_(module, seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, x in module.state_dict().items():
            if name.endswith("lora_b"):
                x.normal_(0.0, 0.05, generator=g)
            elif name.endswith("running_mean"):
                x.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                x.uniform_(0.5, 1.5, generator=g)
    return {k: v.clone() for k, v in module.state_dict().items()}


def as_numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def assert_same(got, want):
    """Two state dicts with the same keys and the same bits."""
    assert sorted(got) == sorted(want)
    for key, x in got.items():
        assert x.dtype == want[key].dtype and torch.equal(x, want[key]), key


def trainables(sd):
    return {k: v for k, v in sd.items() if re.search(chip_smoke.PRODUCT_KEY, k)}


@pytest.fixture(scope="module")
def avsr_sources():
    sd = randomized(tavsr.AVSRModel(tavsr.AVSRConfig.tiny()), 5)
    return {"sd": sd,
            "whisper": chip_smoke.hf_whisper_state(sd),
            "avhubert": chip_smoke.fairseq_avhubert_state(sd),
            "sr_predictor": chip_smoke.sr_predictor_state(sd),
            "llama": chip_smoke.hf_llama_state(sd),
            "product": chip_smoke.product_state(trainables(sd))}


AVSR_IMPORTERS = {  # source -> (the port's importer, the JAX importer's variables)
    "whisper": (lambda s, c: tw.import_hf_whisper_encoder(s, c.whisper),
                lambda s, c: jw.import_hf_whisper_encoder(s, c.whisper)),
    "avhubert": (lambda s, c: tav.import_torch_avhubert(s, c.avhubert),
                 lambda s, c: jav.import_torch_avhubert(s, c.avhubert)),
    "sr_predictor": (lambda s, c: tai.import_sr_predictor(s, c.sr_predictor_layers),
                     lambda s, c: {"params": jai.import_sr_predictor(s, c.sr_predictor_layers)}),
    "llama": (lambda s, c: tl.import_hf_llama(s, c.llama),
              lambda s, c: jl.import_hf_llama(s, c.llama)),
    "product": (lambda s, c: tai.import_reference_avsr(s, c.qformer_layers),
                lambda s, c: {"params": jai.import_reference_avsr(s, c.qformer_layers)}),
}


@pytest.mark.parametrize("source", sorted(AVSR_IMPORTERS))
def test_avsr_importer_matches_jax(source, avsr_sources):
    port, jax_import = AVSR_IMPORTERS[source]
    got = port(avsr_sources[source], tavsr.AVSRConfig.tiny())
    want = flax_to_state_dict(to_numpy_tree(jax_import(as_numpy(avsr_sources[source]),
                                                       javsr.AVSRConfig.tiny())))
    assert_same(got, want)


def import_avsr(module, sources) -> list:
    """The four sources merged into an AVSRModel as
    tests/test_system_parity.py composes them in JAX (the product last);
    returns the entries logged absent."""
    cfg, enc, absent = module.cfg, module.encoder, []
    tai.merge_state(enc.whisper, tw.import_hf_whisper_encoder(sources["whisper"], cfg.whisper),
                    absent)
    tai.merge_state(enc.avhubert, tav.import_torch_avhubert(sources["avhubert"], cfg.avhubert),
                    absent)
    tai.merge_state(enc.sr_predictor, tai.import_sr_predictor(sources["sr_predictor"]), absent)
    tai.merge_state(module.llama, tl.import_hf_llama(sources["llama"], cfg.llama), absent)
    tai.merge_state(module, tai.import_reference_avsr(sources["product"], cfg.qformer_layers),
                    absent)
    return absent


def test_imports_give_back_the_source(avsr_sources):
    """Through the inverse maps and the importers a fresh model becomes the
    source: every entry bit for bit (the folded positional convs to one f32
    rounding), but the tiny config's Whisper-to-predictor bridge, which no
    reference file holds; the audio stream's projection is logged absent."""
    module = tavsr.AVSRModel(tavsr.AVSRConfig.tiny())
    init_random_(module, 9)
    assert import_avsr(module, avsr_sources) == ["audio_proj.weight", "audio_proj.bias"]
    for key, x in module.state_dict().items():
        want = avsr_sources["sd"][key]
        if key in chip_smoke.FOLDED:
            assert max_err(want.numpy(), x) < 1e-6, key
        elif not key.startswith("encoder.sr_bridge."):
            assert torch.equal(x, want), key
    with pytest.raises(ValueError, match="shape"):
        tai.merge_state(module, {"llama.norm.weight": torch.zeros(3)})


def _avsr_batch(cfg, b=2):
    rng = np.random.default_rng(0)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((b, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((b, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([t_v, t_v // 2], np.int32),
        "instruction": rng.integers(1, 200, (b, 5)).astype(np.int32),
    }


def test_imported_avsr_generates_as_jax(avsr_sources):
    """The tiny AVSR assembled from the four sources in both packages (JAX:
    the port's init weights in the JAX tree, its encoders replaced by the
    imports, the product merged by ``merge_subtree``) gives the same beam
    tokens."""
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = _avsr_batch(cfg)
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    init_random_(tsys.module.eval(), 9)
    variables = jax_variables(jsys.module.init, {**batch, "labels": np.ones((2, 4), np.int32),
                                                 "label_lengths": np.asarray([4, 2], np.int32)},
                              tsys.module)
    src = {k: as_numpy(v) for k, v in avsr_sources.items() if k != "sd"}
    params = variables["params"]
    enc = params["encoder"]
    enc["whisper"] = jw.import_hf_whisper_encoder(src["whisper"], cfg.whisper)["params"]
    av = jav.import_torch_avhubert(src["avhubert"], cfg.avhubert)
    enc["avhubert"] = av["params"]
    variables["batch_stats"]["encoder"]["avhubert"] = av["batch_stats"]
    enc["sr_predictor"] = jai.import_sr_predictor(src["sr_predictor"])
    params["llama"] = jl.import_hf_llama(src["llama"], cfg.llama)["params"]
    jai.merge_subtree(params, jai.import_reference_avsr(src["product"], cfg.qformer_layers))

    import_avsr(tsys.module, avsr_sources)  # the same imports over the same weights
    want_seqs, want_scores = jsys.generate(variables, batch, cache_dtype=jnp.float32, **GEN)
    got_seqs, got_scores = tsys.generate({k: t(x) for k, x in batch.items()},
                                         cache_dtype=torch.float32, **GEN)
    np.testing.assert_array_equal(np.asarray(want_seqs), got_seqs.numpy())
    np.testing.assert_allclose(np.asarray(want_scores), got_scores.numpy(), atol=1e-4)


# ---- the speech heads ------------------------------------------------------------

CONFORMER_NAMES = {"self_attn.q_proj": "self_attn.linear_q", "self_attn.k_proj": "self_attn.linear_k",
                   "self_attn.v_proj": "self_attn.linear_v",
                   "self_attn.out_proj": "self_attn.linear_out",
                   "ff_macaron": "feed_forward_macaron", "ff": "feed_forward"}


def reference_speech_state(head_sd, generator_sd, lora) -> dict:
    """A speech model's state dict (``encoder.*``, ``head.*``) and a
    generator's in the reference speech checkpoint's names: the product
    trainables (with ``lora``, peft LoRA keys the NoLLM model lacks), the
    mask embeddings, proj1 / proj2 / ln1-3 / the mel head, the vendored
    Conformer (``conformer.encoder.encoders.{i}``, the pointwise convs [O, I,
    1] as ``pointwise_cov{1,2}``) and the ``vocoder_*`` generator
    (``weight_v`` / ``weight_g``)."""
    out = chip_smoke.product_state({**trainables(head_sd), **lora})
    for rest, x in chip_smoke.entries_under(head_sd, "encoder.").items():
        if rest.endswith("_mask_emb"):
            out[rest] = x
    for rest, x in chip_smoke.entries_under(head_sd, "head.").items():
        if not rest.startswith("conformer."):
            out[rest] = x
            continue
        rest = rest.removeprefix("conformer.")
        m = re.fullmatch(r"blocks_(\d+)\.(.*)\.(\w+)", rest)
        if m is None:  # after_norm
            out[f"conformer.encoder.{rest}"] = x
            continue
        i, mod, leaf = m.groups()
        mod = CONFORMER_NAMES.get(mod, re.sub(r"^ff", "feed_forward", mod))
        mod = re.sub(r"pointwise_conv(\d)", r"pointwise_cov\1", mod)
        if "pointwise_cov" in mod and leaf == "weight":
            x = x[:, :, None]
        out[f"conformer.encoder.encoders.{i}.{mod}.{leaf}"] = x
    for key, x in generator_sd.items():
        base, leaf = key.rsplit(".", 1)
        for part in ("ups", "resblocks", "convs1", "convs2"):
            base = base.replace(f"{part}_", f"{part}.")
        out[f"vocoder_{base}.{dict(v='weight_v', g='weight_g').get(leaf, leaf)}"] = \
            x.reshape(-1, 1, 1) if leaf == "g" else x
    return out


CONFORMER_BLOCKS = 3  # SpeechConfig.tiny()'s Conformer S


def _speech_cfg(pkg):
    return dataclasses.replace(pkg.SpeechConfig.tiny(), modality_dropout=True)


def _speech_batch(cfg, b=2):
    rng = np.random.default_rng(0)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((b, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((b, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([t_v, t_v // 2], np.int32),
        "instruction": rng.integers(1, 200, (b, 4)).astype(np.int32),
        "audio_lengths": np.asarray([cfg.max_mel_frames * 160, cfg.max_mel_frames * 80 + 37],
                                    np.int32),
        "modality_mode": np.int32(0),
    }


@pytest.fixture(scope="module")
def speech_sources(avsr_sources):
    cfg = _speech_cfg(tsp)
    head_sd = randomized(tsp.SpeechNoLLMModel(cfg), 6)
    gen_sd = randomized(tsp.SpeechE2EModel(cfg, thg.HifiGanConfig(**TINY_VOCODER)).generator, 7)
    lora = {k: v for k, v in trainables(avsr_sources["sd"]).items() if k.startswith("llama.")}
    return {"state": reference_speech_state(head_sd, gen_sd, lora), "lora": sorted(lora)}


def _generator_cfgs():
    cfg = _speech_cfg(tsp)
    return (thg.HifiGanConfig(in_channels=cfg.head_dim, **TINY_VOCODER),
            jhg.HifiGanConfig(in_channels=cfg.head_dim, **TINY_VOCODER))


def _jax_speech_variables(mapped):
    """The JAX ``import_reference_speech`` subtrees as one variables tree in
    the port's key layout (``head_stats`` under ``head``)."""
    return {"params": {k: v for k, v in mapped.items() if k != "head_stats"},
            "batch_stats": {"head": mapped.get("head_stats", {})}}


@pytest.mark.parametrize("importer", ["conformer", "reference_speech"])
def test_speech_importer_matches_jax(importer, speech_sources):
    state, blocks = speech_sources["state"], CONFORMER_BLOCKS
    if importer == "conformer":
        got = tsi.import_torch_conformer(state, blocks, prefix="conformer.encoder.")
        want = jsi.import_torch_conformer(as_numpy(state), blocks, prefix="conformer.encoder.")
    else:
        t_gen, j_gen = _generator_cfgs()
        got = tsi.import_reference_speech(state, 2, blocks, generator_cfg=t_gen)
        want = _jax_speech_variables(jsi.import_reference_speech(
            as_numpy(state), 2, blocks, generator_cfg=j_gen))
    assert_same(got, flax_to_state_dict(to_numpy_tree(want)))


@pytest.mark.parametrize("variant", ["nollm", "e2e"])
def test_imported_speech_model_matches_jax(variant, avsr_sources, speech_sources):
    """A NoLLM and an E2E model with the Whisper and AV-HuBERT imports and
    ``import_reference_speech`` merged, in both packages over the same init
    weights: the mel / the waveform within the speech tolerance.  The port logs
    as absent what the model lacks, which the JAX merge adds unused: the LoRA
    keys, and the generator (NoLLM) or the mel head (E2E)."""
    cfg = _speech_cfg(jsp)
    batch = _speech_batch(cfg)
    t_gen, j_gen = _generator_cfgs()
    src = {k: as_numpy(avsr_sources[k]) for k in ("whisper", "avhubert")}
    state = speech_sources["state"]
    if variant == "nollm":
        jm, trunk = jsp.SpeechNoLLMModel(cfg), ()
        system = tsp.SpeechNoLLMSystem(_speech_cfg(tsp), device="cpu")
        out, prefix = "melspec", ""
    else:
        jm, trunk = jsp.SpeechE2EModel(cfg, jhg.HifiGanConfig(**TINY_VOCODER)), ("trunk",)
        system = tsp.SpeechE2ESystem(_speech_cfg(tsp), thg.HifiGanConfig(**TINY_VOCODER),
                                     device="cpu")
        out, prefix = "waveform", "trunk."
    init_random_(system.module.eval(), 9)
    variables = jax_variables(jm.init, batch, system.module)
    params, stats = variables["params"], variables["batch_stats"]
    for key in trunk:
        params, stats = params[key], stats[key]
    enc = params["encoder"]
    enc["whisper"] = jw.import_hf_whisper_encoder(src["whisper"], cfg.whisper)["params"]
    av = jav.import_torch_avhubert(src["avhubert"], cfg.avhubert)
    enc["avhubert"], stats["encoder"]["avhubert"] = av["params"], av["batch_stats"]
    mapped = jsi.import_reference_speech(as_numpy(state), 2, CONFORMER_BLOCKS,
                                         generator_cfg=j_gen)
    jai.merge_subtree(enc, mapped["encoder"])
    jai.merge_subtree(params["head"], mapped["head"])
    jai.merge_subtree(stats.setdefault("head", {}), mapped["head_stats"])
    if trunk:
        jai.merge_subtree(variables["params"]["generator"], mapped["generator"])
    want = jax.jit(jm.apply)(variables, batch)[out]

    m = system.module.trunk if trunk else system.module
    cfg_t = system.cfg
    tai.merge_state(m.encoder.whisper, tw.import_hf_whisper_encoder(avsr_sources["whisper"],
                                                                    cfg_t.whisper))
    tai.merge_state(m.encoder.avhubert, tav.import_torch_avhubert(avsr_sources["avhubert"],
                                                                  cfg_t.avhubert))
    imported = tsi.import_reference_speech(state, 2, CONFORMER_BLOCKS, generator_cfg=t_gen)
    # the E2E model nests the encoder and head under its trunk, as the JAX merge does
    imported = {(k if k.startswith(("generator.", "llama.")) else prefix + k): v
                for k, v in imported.items()}
    absent = []
    tai.merge_state(system.module, imported, absent)
    unused = [k for k in imported if k.startswith("generator.")] if not trunk else \
        [f"trunk.head.mel_head.{leaf}" for leaf in ("weight", "bias")]
    assert sorted(absent) == sorted(speech_sources["lora"] + unused)
    got = system({**{k: t(x) for k, x in batch.items()}, "modality_mode": torch.tensor(0)})[out]
    assert max_err(want, got) < TOL
