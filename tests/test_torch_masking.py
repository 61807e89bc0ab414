"""The port's span masks (``ops/masking.py``) against the JAX package's.
The JAX draws cannot be replayed in torch, so the pure part is held bit for
bit on JAX's own uniforms (the JAX function's split and draw repeated here),
and the port's draws by their statistics: the span count, the share of
valid frames masked against its expectation, uniform starts, nothing past a
row's length."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from multimodalvc_tpu.ops import masking as jmask
from multimodalvc_tpu_torch.ops import masking as tmask

# (seq_len, lengths, mask_prob, mask_length, min_masks): full rows, short
# rows (max(len - L, 1) = 1), an empty row, rows shorter than a span
CASES = [
    (50, [50, 37, 12, 0], 0.8, 10, 2),
    (400, [400, 257, 11, 3], 0.8, 10, 2),
    (24, [24, 9, 2, 1], 0.5, 3, 2),
    (7, [7, 7, 5, 4], 0.65, 3, 1),
]


@pytest.mark.parametrize("seq_len,lengths,prob,span,min_masks", CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_mask_on_jax_uniforms_is_exact(seq_len, lengths, prob, span, min_masks, seed):
    rng = jax.random.PRNGKey(seed)
    lens = np.asarray(lengths, np.int32)
    b = len(lengths)
    want = jmask.compute_span_mask(rng, b, seq_len, jnp.asarray(lens), prob, span, min_masks)
    n = tmask.num_spans(seq_len, prob, span, min_masks)
    u = jax.random.uniform(jax.random.split(rng)[0], (b, n))  # the JAX function's draw
    got = tmask.span_mask_from_uniforms(t(u), seq_len, t(lens), span)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_span_mask_statistics():
    """Over many draws at AV-HuBERT-Large's setting (p 0.8, L 10, T 400):
    each row's starts are uniform over [0, len - L), nothing masks past the
    length, and the masked share of valid frames matches 1 - P(no span
    covers a frame), the expectation of the static-budget scheme."""
    g = torch.Generator().manual_seed(0)
    seq_len, span, prob = 400, 10, 0.8
    lens = torch.tensor([400, 300, 57, 5] * 64, dtype=torch.int32)
    n = tmask.num_spans(seq_len, prob, span)
    assert n == 32
    u = tmask.span_uniforms(g, len(lens), seq_len, prob, span)
    assert u.shape == (len(lens), n) and u.dtype == torch.float32
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    mask = tmask.span_mask_from_uniforms(u, seq_len, lens, span)
    pos = torch.arange(seq_len)[None]
    assert not (mask & (pos >= lens[:, None])).any()
    for length in (400, 300, 57):
        rows = mask[lens == length][:, :length].double()
        m = max(length - span, 1)
        # frame f is covered by a start in [f - L + 1, f], each start
        # uniform over m integers; n independent starts
        f = torch.arange(length)
        covered = (torch.minimum(f, torch.tensor(m - 1)) - torch.clamp(f - span + 1, min=0) + 1)
        expect = 1.0 - (1.0 - torch.clamp(covered, min=0).double() / m) ** n
        share = rows.mean()
        sigma = float((expect.mean() * (1 - expect.mean()) / rows.numel()) ** 0.5)
        assert abs(float(share - expect.mean())) < 8 * sigma + 1e-3, length
    # the same generator state gives the same draws, so the same mask
    a, b = (tmask.span_mask_from_uniforms(
        tmask.span_uniforms(torch.Generator().manual_seed(5), 4, seq_len, prob, span), seq_len,
        lens[:4], span) for _ in range(2))
    assert torch.equal(a, b)


def test_apply_feature_mask_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4)).astype(np.float32)
    mask = rng.random((2, 6)) < 0.5
    emb = rng.standard_normal(4).astype(np.float32)
    want = jmask.apply_feature_mask(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(emb))
    got = tmask.apply_feature_mask(t(x), t(mask), t(emb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
