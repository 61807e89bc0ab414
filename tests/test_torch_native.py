"""The port's host C++ routines (``multimodalvc_tpu_torch/native``) against
the JAX package's ``native`` module, on seeded inputs, exactly.

Each port C++ function is held against the JAX C++ (``native._load()``
builds the JAX library, as tests/test_native.py does), and each port
``*_plain`` twin against the JAX Python fallback (the JAX library hidden,
as tests/test_native.py hides it).  ``balanced_assignment``'s two versions
differ on purpose (an auction against a greedy fill), so each is held
against its own twin.  A compiler that fails makes the call raise."""
import numpy as np
import pytest

from multimodalvc_tpu import native as jnative
from multimodalvc_tpu.data import batching as jbatching
from multimodalvc_tpu.utils.wer import _edit_distance_dp
from multimodalvc_tpu_torch import native as tnative

BUCKETS = [100, 200, 300, 400, 500]
WORDS = ("a", "b", "c", "d", "e")


@pytest.fixture(scope="module")
def jlib():
    lib = jnative._load()
    assert lib is not None, "the JAX native library did not build"
    return lib


def jax_fallback(monkeypatch):
    """Hide the JAX module's library: its Python fallbacks run."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_build_failed", True)


def word_pairs(seed, n=40):
    rng = np.random.default_rng(seed)
    return [tuple(list(rng.choice(WORDS, rng.integers(0, 25))) for _ in "ab") for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_distance(jlib, seed):
    for a, b in word_pairs(seed):
        want = jnative.edit_distance_native(a, b)
        assert tnative.edit_distance_native(a, b) == want
        assert tnative.edit_distance_native_plain(a, b) == _edit_distance_dp(a, b) == want


@pytest.mark.parametrize("max_tokens, batch_size, multiple", [
    (3200, 0, 8), (1000, 0, 1), (0, 6, 1), (2000, 5, 4)])
def test_batch_by_size(jlib, max_tokens, batch_size, multiple):
    rng = np.random.default_rng(max_tokens + batch_size)
    sizes = rng.integers(1, 520, 3000)
    order = np.argsort(sizes, kind="stable")
    args = (sizes, order, BUCKETS, max_tokens, batch_size, multiple)
    want = jnative.batch_by_size_native(*args)
    got = tnative.batch_by_size_native(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fallback = jbatching.batch_by_size(sizes, max_tokens=max_tokens or None,
                                       batch_size=batch_size or None, buckets=BUCKETS,
                                       required_multiple=multiple)
    plain = tnative.batch_by_size_native_plain(*args)
    assert len(plain) == len(fallback)
    for g, w in zip(plain, fallback):
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(len(sizes)))


@pytest.mark.parametrize("complete_doc", [False, True])
def test_token_blocks_complete(jlib, monkeypatch, complete_doc):
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 40, 500)
    sizes[rng.integers(0, 500, 30)] = 1  # document separators / single tokens
    want = jnative.token_blocks_complete(sizes, 64, complete_doc)
    np.testing.assert_array_equal(tnative.token_blocks_complete(sizes, 64, complete_doc), want)
    jax_fallback(monkeypatch)
    fallback = jnative.token_blocks_complete(sizes, 64, complete_doc)
    np.testing.assert_array_equal(tnative.token_blocks_complete_plain(sizes, 64, complete_doc),
                                  fallback)


@pytest.mark.parametrize("shape", [(4, 32), (4, 1024), (8, 64)])  # 4: the MoE preset's experts
def test_balanced_assignment(jlib, shape):
    scores = np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)
    got = tnative.balanced_assignment(scores)
    np.testing.assert_array_equal(got, jnative.balanced_assignment(scores))
    assert (np.bincount(got, minlength=shape[0]) == shape[1] // shape[0]).all()
    np.testing.assert_array_equal(tnative.balanced_assignment_plain(scores),
                                  jnative._balanced_assignment_py(scores))
    with pytest.raises(ValueError, match="evenly"):
        tnative.balanced_assignment(scores[:, :-1])


def sentence_pairs(seed, n=60):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 6, rng.integers(0, 25)).tolist(),
             rng.integers(0, 6, rng.integers(1, 25)).tolist()) for _ in range(n)]


def test_bleu_counts(jlib, monkeypatch):
    pairs = sentence_pairs(4)
    for s, r in pairs:
        for got, want in zip(tnative.bleu_counts(s, r), jnative.bleu_counts(s, r)):
            np.testing.assert_array_equal(got, want)
    jax_fallback(monkeypatch)
    for s, r in pairs:
        for got, want in zip(tnative.bleu_counts_plain(s, r), jnative.bleu_counts(s, r)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plain", [False, True])
def test_bleu_scorer(jlib, monkeypatch, plain):
    pairs = sentence_pairs(5) + [(list(range(8)), list(range(8)))]
    if plain:
        jax_fallback(monkeypatch)
    want = jnative.BleuScorer()
    got = tnative.BleuScorer(counts=tnative.bleu_counts_plain if plain else tnative.bleu_counts)
    for s, r in pairs:
        want.add(s, r)
        got.add(s, r)
    assert 0.0 < got.score() < 100.0
    assert got.score() == want.score()
    np.testing.assert_array_equal(got.matches, want.matches)
    assert tnative.BleuScorer().score() == 0.0


@pytest.mark.parametrize("ngram", [2, 3])
def test_ngram_banned_tokens(jlib, monkeypatch, ngram):
    tokens = np.random.default_rng(6).integers(0, 5, (40, 64)).astype(np.int32)
    want = jnative.ngram_banned_tokens(tokens, ngram)
    assert tnative.ngram_banned_tokens(tokens, ngram) == want
    assert sum(map(len, want)) > 40  # the small vocabulary repeats n-grams
    jax_fallback(monkeypatch)
    assert tnative.ngram_banned_tokens_plain(tokens, ngram) == jnative.ngram_banned_tokens(
        tokens, ngram)


@pytest.mark.parametrize("cxx", ["false", "no-such-compiler-mmvc"])
def test_a_failed_build_raises(monkeypatch, tmp_path, cxx):
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_LOADED", None)
    with pytest.raises(tnative.NativeBuildError):
        tnative.balanced_assignment(np.zeros((2, 4), np.float32))
    assert list(tmp_path.iterdir()) == []  # nothing half-built left behind
