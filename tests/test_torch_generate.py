"""End-to-end parity of the served slice: the port's tiny AVSRSystem.generate
against the JAX AVSRSystem.generate on the same weights and inputs, in each
ported mode: the int8 KV cache with the ancestry decode, the float KV cache
with the ancestry decode or the gather reorder, and int8 / int4 weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t

from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn import llama as tl

GEN = dict(num_beams=3, max_new_tokens=6, kv_quant="int8")
# f32 prefill cache on both sides (compare in f32): with the serving bf16
# cache, an f32 last-bit difference upstream can flip a bf16 rounding of a
# cached key, and a near-tie between two beams then resolves differently


def _batch(cfg, b=2):
    rng = np.random.default_rng(0)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((b, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((b, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([t_v, t_v // 2], np.int32),
        "instruction": rng.integers(1, 200, (b, 5)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def systems():
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = _batch(cfg)
    init_batch = {**batch, "labels": np.ones((2, 4), np.int32),
                  "label_lengths": np.asarray([4, 2], np.int32)}
    variables = randomize(jsys.init(jax.random.PRNGKey(0), init_batch))
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny())
    loaded(tsys.module, variables)
    return jsys, variables, tsys, batch


def test_prompt_matches_jax(systems):
    jsys, variables, tsys, batch = systems
    want_e, want_m = jax.jit(
        lambda v, b: jsys.module.apply(v, b, method=javsr.AVSRModel.prompt_for_generation)
    )(variables, batch)
    with torch.no_grad():
        got_e, got_m = tsys.module.prompt_for_generation({k: t(x) for k, x in batch.items()})
    np.testing.assert_array_equal(np.asarray(want_m), got_m.numpy())
    # f32 through both encoders, the Q-Former and the projector
    assert max_err(want_e, got_e) < 1e-4


def test_generate_matches_jax(systems):
    jsys, variables, tsys, batch = systems
    want_seqs, want_scores = jsys.generate(variables, batch, ancestry_reorder=True,
                                           cache_dtype=jnp.float32, **GEN)
    got_seqs, got_scores = tsys.generate({k: t(x) for k, x in batch.items()},
                                         cache_dtype=torch.float32, **GEN)
    np.testing.assert_array_equal(np.asarray(want_seqs), got_seqs.numpy())
    # scores are sums of 6 f32 log-probs (~1e-6 relative each); 1e-4 also
    # leaves room for one int8 KV value on a rounding boundary
    np.testing.assert_allclose(np.asarray(want_scores), got_scores.numpy(), atol=1e-4)


@pytest.mark.parametrize("reorder", ["ancestry", "gather"])
def test_generate_float_kv_matches_jax(systems, reorder):
    """The bf16-KV decode modes (here with an f32 cache): the ancestry decode
    with the prompt segment as einsums, and the gather reorder."""
    jsys, variables, tsys, batch = systems
    kw = dict(num_beams=3, max_new_tokens=6, ancestry_reorder=reorder == "ancestry")
    want_seqs, want_scores = jsys.generate(variables, batch, cache_dtype=jnp.float32, **kw)
    got_seqs, got_scores = tsys.generate({k: t(x) for k, x in batch.items()},
                                         cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(np.asarray(want_seqs), got_seqs.numpy())
    # sums of 6 f32 log-probs; no quantized value on the path
    np.testing.assert_allclose(np.asarray(want_scores), got_scores.numpy(), atol=1e-5)


def test_default_reorder_resolves_as_the_jax_package(systems, monkeypatch):
    """``ancestry_reorder=None`` gives the ancestry decode on the accelerator,
    as in the JAX package (models/avsr.py:516-517), and the gather reorder on
    the CPU; an int8 KV cache always takes the ancestry decode."""
    assert tavsr.resolve_ancestry_reorder(None, torch.device("cuda")) is True
    assert tavsr.resolve_ancestry_reorder(None, "cuda:0") is True
    assert tavsr.resolve_ancestry_reorder(None, "cpu") is False
    assert tavsr.resolve_ancestry_reorder("int8", "cpu") is True
    _, _, tsys, batch = systems
    seen = []
    monkeypatch.setattr(tavsr, "generate_beam",
                        lambda *a, **kw: seen.append(kw["ancestry_reorder"]))
    tb = {k: t(x) for k, x in batch.items()}
    tsys.generate(tb, num_beams=2, max_new_tokens=2)
    tsys.generate(tb, num_beams=2, max_new_tokens=2, kv_quant="int8")
    assert seen == [False, True]


def test_generate_rejects_unported_modes(systems):
    """n-gram blocking, constraints, share_prompt_kv=False and ensembles are
    the next slice; kv_quant without the ancestry split cache is refused as
    in the JAX package."""
    _, _, tsys, batch = systems
    tb = {k: t(x) for k, x in batch.items()}
    with pytest.raises(NotImplementedError):
        tsys.generate(tb, num_beams=2, max_new_tokens=2, kv_quant="int8",
                      no_repeat_ngram_size=3)
    with pytest.raises(NotImplementedError):
        tsys.generate(tb, num_beams=2, max_new_tokens=2, constraints=[[5, 6], []])
    with torch.no_grad():
        emb, mask = tsys.module.prompt_for_generation(tb)
    llama = tsys.llama_module
    kw = dict(eos_token_id=2, pad_token_id=0, num_beams=2, max_new_tokens=2)
    with pytest.raises(NotImplementedError):
        tl.generate_beam(llama, emb, mask, share_prompt_kv=False, **kw)
    with pytest.raises(NotImplementedError):
        tl.generate_beam(llama, [emb, emb], [mask, mask], ancestry_reorder=True, **kw)
    with pytest.raises(ValueError):
        tl.generate_beam(llama, emb, mask, kv_quant="int8", ancestry_reorder=False, **kw)


def _wide_llama(cfg):
    """The tiny config with a 256-wide LLaMA, so that every projection lies
    inside the quantized kernels' shape rule (JAX runs them in interpret
    mode) and int4's group-128 halves fit."""
    llama = dataclasses.replace(cfg.llama, hidden_size=256, intermediate_size=512, head_dim=64)
    return dataclasses.replace(cfg, llama=llama)


# weights, then the decode mode each quantized test serves
QUANT_GEN = {
    "int8": dict(kv_quant="int8"),  # the serving configuration: int8 KV, ancestry
    "int4": dict(ancestry_reorder=None),  # the CPU default: gather reorder, float KV
}


@pytest.fixture(scope="module")
def wide_systems():
    cfg = _wide_llama(javsr.AVSRConfig.tiny())
    batch = _batch(cfg)
    init_batch = {**batch, "labels": np.ones((2, 4), np.int32),
                  "label_lengths": np.asarray([4, 2], np.int32)}
    variables = randomize(javsr.AVSRSystem(cfg).init(jax.random.PRNGKey(0), init_batch))
    return cfg, variables, batch


@pytest.mark.parametrize("mode", list(QUANT_GEN))
def test_generate_quantized_weights_matches_jax(wide_systems, mode):
    cfg, variables, batch = wide_systems
    jsys = javsr.AVSRSystem(cfg)
    qvars = jsys.enable_quantized_decode(variables, mode)
    tsys = tavsr.AVSRSystem(_wide_llama(tavsr.AVSRConfig.tiny()))
    loaded(tsys.module, variables)
    tsys.enable_quantized_decode(mode)
    assert tsys.llama_module.cfg.weight_quant == mode
    assert not hasattr(tsys.llama_module.layers[0].self_attn.q_proj, "base")  # float freed
    kw = dict(num_beams=3, max_new_tokens=6, **QUANT_GEN[mode])
    want_seqs, want_scores = jsys.generate(qvars, batch, cache_dtype=jnp.float32, **kw)
    got_seqs, got_scores = tsys.generate({k: t(x) for k, x in batch.items()},
                                         cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(np.asarray(want_seqs), got_seqs.numpy())
    # each quantized matmul rounds its input to bf16, and an f32 last-bit
    # difference upstream can flip one of those roundings (2^-9 relative);
    # summed over 6 log-probs that stays well inside 1e-3
    np.testing.assert_allclose(np.asarray(want_scores), got_scores.numpy(), atol=1e-3)
