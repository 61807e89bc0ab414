"""End-to-end parity of the served slice: the port's tiny AVSRSystem.generate
against the JAX AVSRSystem.generate on the same weights and inputs, in each
ported mode: the int8 KV cache with the ancestry decode, the float KV cache
with the ancestry decode or the gather reorder, int8 / int4 weights, n-gram
blocking, constraints, ensembles, the full per-beam cache, encoder
microbatches and long-form decoding."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t

from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.nn import llama as jl
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn import llama as tl
from multimodalvc_tpu_torch.ops import decode_attention as tdecode

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
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
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


def test_generate_int8_kv_goes_through_the_merged_entry(systems, monkeypatch):
    """The int8-KV ancestry decode calls ``ancestry_attention`` once a layer
    and step, never the PyTorch merge, and still gives the JAX beam tokens."""
    jsys, variables, tsys, batch = systems
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return tdecode.ancestry_attention(*args, **kw)

    def no_merge(*args, **kw):
        raise AssertionError("the PyTorch merge ran on the int8 path")

    monkeypatch.setattr(tl, "ancestry_attention", counted)
    monkeypatch.setattr(tl, "merge_softmax_segments", no_merge)
    want_seqs, _ = jsys.generate(variables, batch, ancestry_reorder=True,
                                 cache_dtype=jnp.float32, **GEN)
    got_seqs, _ = tsys.generate({k: t(x) for k, x in batch.items()},
                                cache_dtype=torch.float32, **GEN)
    np.testing.assert_array_equal(np.asarray(want_seqs), got_seqs.numpy())
    layers = tsys.cfg.llama.num_layers
    assert calls and len(calls) % layers == 0 and len(calls) <= layers * GEN["max_new_tokens"]


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


# wide beams: 9 beams make 18 query rows a kv head at the tiny LLaMA's rep 2
# (two 16-row tiles of the decode attention on the card), 17 pass the old
# 16-beam limit of the top-k kernel; the int8 KV cache with the ancestry
# decode, and the float KV cache with the gather reorder (f32 here, as the
# other float-KV tests: a bf16 cache rounds at other points in the two
# frameworks and moves the scores by ~4e-4 with the same tokens)
WIDE_GEN = {
    "ancestry_int8": (dict(kv_quant="int8"), 1e-4),
    "gather_float": (dict(ancestry_reorder=False), 1e-5),
}


@pytest.mark.parametrize("beams", [9, 17])
@pytest.mark.parametrize("mode", list(WIDE_GEN))
def test_generate_wide_beams_matches_jax(systems, mode, beams):
    jsys, variables, tsys, batch = systems
    extra, atol = WIDE_GEN[mode]
    kw = dict(num_beams=beams, max_new_tokens=6, **extra)
    want = jsys.generate(variables, batch, cache_dtype=jnp.float32, **kw)
    got = tsys.generate(_tb(batch), cache_dtype=torch.float32, **kw)
    assert tuple(got[0].shape) == (2, beams, 6)
    _assert_same(want, got, atol)


def test_generate_beam_105_matches_jax(systems):
    """Past the top-k kernel's old ceiling of 104 beams (on the card: the
    select form): the int8-KV ancestry decode at beam 105 returns the JAX
    generate's tokens and scores."""
    jsys, variables, tsys, batch = systems
    extra, atol = WIDE_GEN["ancestry_int8"]
    kw = dict(num_beams=105, max_new_tokens=4, **extra)
    want = jsys.generate(variables, batch, cache_dtype=jnp.float32, **kw)
    got = tsys.generate(_tb(batch), cache_dtype=torch.float32, **kw)
    assert tuple(got[0].shape) == (2, 105, 4)
    _assert_same(want, got, atol)


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


def _tb(batch):
    return {k: t(x) for k, x in batch.items()}


def _assert_same(want, got, atol):
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_allclose(np.asarray(want[1]), got[1].numpy(), atol=atol)


def test_device_defaults_to_the_card():
    """The port's entry point runs on the card unless the caller asks for the
    CPU (every CPU test passes device="cpu")."""
    sig = inspect.signature(tavsr.AVSRSystem.__init__)
    assert sig.parameters["device"].default == "cuda"


# n-gram blocking on both decode caches: the int8 KV ancestry decode (scores:
# 1e-4 leaves room for one int8 KV value on a rounding boundary) and the f32
# gather reorder (sums of f32 log-probs)
NGRAM = {
    "ancestry_int8": (dict(kv_quant="int8"), 1e-4),
    "gather_f32": (dict(ancestry_reorder=False), 1e-5),
}


@pytest.mark.parametrize("mode", list(NGRAM))
def test_generate_ngram_blocking_matches_jax(systems, mode):
    jsys, variables, tsys, batch = systems
    extra, atol = NGRAM[mode]
    kw = dict(num_beams=3, max_new_tokens=10, no_repeat_ngram_size=2, **extra)
    want = jsys.generate(variables, batch, cache_dtype=jnp.float32, **kw)
    got = tsys.generate(_tb(batch), cache_dtype=torch.float32, **kw)
    _assert_same(want, got, atol)
    seqs = got[0].numpy()
    for row in seqs.reshape(-1, seqs.shape[-1]):  # no 2-gram twice in any beam
        pairs = list(zip(row[:-1], row[1:]))
        assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("constraints_mode", ["unordered", "ordered"])
def test_generate_constraints_match_jax(systems, constraints_mode):
    """Row 0 one phrase, row 1 two (their order matters in "ordered")."""
    jsys, variables, tsys, batch = systems
    cons = [[[17, 33]], [[41], [90, 91]]]
    kw = dict(num_beams=3, max_new_tokens=8, constraints=cons, constraints_mode=constraints_mode)
    want = jsys.generate(variables, batch, cache_dtype=jnp.float32, **kw)
    got = tsys.generate(_tb(batch), cache_dtype=torch.float32, **kw)
    _assert_same(want, got, 1e-5)
    best = got[0][:, 0].tolist()
    assert [17, 33] in [best[0][i : i + 2] for i in range(7)]
    assert 41 in best[1] and [90, 91] in [best[1][i : i + 2] for i in range(7)]


@pytest.fixture(scope="module")
def second_member(systems):
    """A second set of weights for a two-member ensemble."""
    jsys, _, _, batch = systems
    init_batch = {**batch, "labels": np.ones((2, 4), np.int32),
                  "label_lengths": np.asarray([4, 2], np.int32)}
    variables = randomize(jsys.init(jax.random.PRNGKey(1), init_batch), seed=2)
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    loaded(tsys.module, variables)
    return variables, tsys


def test_generate_ensemble_matches_jax(systems, second_member):
    jsys, variables, tsys, batch = systems
    variables2, tsys2 = second_member
    kw = dict(num_beams=3, max_new_tokens=6, kv_quant="int8")
    want = jsys.generate([variables, variables2], batch, cache_dtype=jnp.float32, **kw)
    got = tsys.generate(_tb(batch), cache_dtype=torch.float32, ensemble=[tsys2], **kw)
    # log-prob averages through logsumexp, then as test_generate_matches_jax
    _assert_same(want, got, 1e-4)


def test_generate_beam_full_cache_matches_jax(systems):
    """share_prompt_kv=False: the prompt prefilled into T + L slots, tiled to
    the beams; the same prompt embeddings on both sides."""
    jsys, variables, tsys, batch = systems
    emb, mask = jax.jit(
        lambda v, b: jsys.module.apply(v, b, method=javsr.AVSRModel.prompt_for_generation)
    )(variables, batch)
    kw = dict(eos_token_id=2, pad_token_id=0, num_beams=3, max_new_tokens=6,
              share_prompt_kv=False)
    want = jax.jit(lambda v, e, m: jl.generate_beam(
        jsys.llama_module, v, e, m, cache_dtype=jnp.float32, **kw))(
        {"params": variables["params"]["llama"]}, emb, mask)
    with torch.no_grad():
        got = tl.generate_beam(tsys.llama_module, t(emb), t(mask), cache_dtype=torch.float32,
                               **kw)
    _assert_same(want, got, 1e-5)


def test_generate_encoder_microbatch_matches_jax(systems):
    jsys, variables, tsys, batch = systems
    kw = dict(num_beams=3, max_new_tokens=6, kv_quant="int8", encoder_microbatch=2)
    want = jsys.generate(variables, batch, cache_dtype=jnp.float32, **kw)
    got = tsys.generate(_tb(batch), cache_dtype=torch.float32, **kw)
    _assert_same(want, got, 1e-4)


def _long_batch(cfg, b=2, frames=32):
    """A clip of two encoder windows, with full-clip mel features."""
    rng = np.random.default_rng(3)
    return {
        "audio_feats": rng.standard_normal((b, cfg.whisper.n_mels, 4 * frames)).astype(np.float32),
        "video": rng.standard_normal((b, frames, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([frames, frames - 12], np.int32),
        "instruction": rng.integers(1, 200, (b, 5)).astype(np.int32),
    }


@pytest.mark.parametrize("merge", [True, False])
def test_generate_long_form_matches_jax(systems, merge):
    jsys, variables, tsys, _ = systems
    cfg = javsr.AVSRConfig.tiny()
    batch = _long_batch(cfg)
    kw = dict(chunk_frames=cfg.max_video_frames, merge=merge, num_beams=3, max_new_tokens=6,
              ancestry_reorder=False)
    want = jsys.generate_long_form(variables, batch, cache_dtype=jnp.float32, **kw)
    got = tsys.generate_long_form(_tb(batch), cache_dtype=torch.float32, **kw)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        if merge:
            np.testing.assert_array_equal(w, g)
        else:
            assert len(w) == len(g) == 2  # both rows reach into the second window
            for wr, gr in zip(w, g):
                np.testing.assert_array_equal(wr, gr)


def test_merge_token_rows_matches_jax():
    rows = [np.asarray([5, 6, 7, 2, 0]), np.asarray([6, 7, 9, 0, 0]), np.asarray([0, 9, 4, 2])]
    for dedup in (True, False):
        np.testing.assert_array_equal(javsr.merge_token_rows(rows, 2, 0, dedup=dedup),
                                      tavsr.merge_token_rows(rows, 2, 0, dedup=dedup))
    assert tavsr.merge_token_rows(rows, 2, 0).tolist() == [5, 6, 7, 9, 4]


def test_generate_rejects_what_jax_rejects(systems, second_member):
    """kv_quant without the ancestry split cache, constraints with an
    ensemble, an encoder microbatch that does not divide the batch and a
    long-form overlap as long as the chunk are refused, as in the JAX
    package."""
    _, _, tsys, batch = systems
    _, tsys2 = second_member
    tb = _tb(batch)
    with torch.no_grad():
        emb, mask = tsys.module.prompt_for_generation(tb)
    llama = tsys.llama_module
    kw = dict(eos_token_id=2, pad_token_id=0, num_beams=2, max_new_tokens=2)
    with pytest.raises(ValueError):
        tl.generate_beam(llama, emb, mask, kv_quant="int8", ancestry_reorder=False, **kw)
    with pytest.raises(ValueError):
        tl.generate_beam(llama, emb, mask, kv_quant="int8", ancestry_reorder=True,
                         share_prompt_kv=False, **kw)
    with pytest.raises(NotImplementedError):
        tsys.generate(tb, num_beams=2, max_new_tokens=2, constraints=[[[5, 6]], []],
                      ensemble=[tsys2])
    with pytest.raises(ValueError):
        tsys.generate(tb, num_beams=2, max_new_tokens=2, encoder_microbatch=3)
    with pytest.raises(ValueError):
        tsys.generate_long_form(tb, chunk_frames=8, overlap_frames=8)


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
    tsys = tavsr.AVSRSystem(_wide_llama(tavsr.AVSRConfig.tiny()), device="cpu")
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
