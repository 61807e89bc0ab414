"""K1 parity: the port's flash_attention (plain version on the CPU) against the
JAX flash_attention kernel in interpret mode, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import max_err, t

from multimodalvc_tpu.ops import attention as jattn
from multimodalvc_tpu_torch.ops import attention as tattn

# f32 on both sides; the kernel's online softmax and the one-shot softmax
# differ only in summation order (~1e-6 relative)
TOL = 2e-5

CASES = {
    "kv_lens": dict(shape=(2, 2, 96, 32), kv_lens=[96, 40], kv_starts=None, causal=False),
    "causal": dict(shape=(2, 3, 64, 16), kv_lens=None, kv_starts=None, causal=True),
    "causal_kv_starts": dict(shape=(2, 2, 80, 32), kv_lens=[80, 60], kv_starts=[0, 17],
                             causal=True),
    "fully_masked_row": dict(shape=(2, 2, 48, 16), kv_lens=[0, 30], kv_starts=None,
                             causal=False),
    # the kernel's tile edges: D=128 with kv_start inside the first key tile
    # (causal: whole leading rows dead), kv_len 1, ragged T with kv_len
    # inside a tile
    "d128_causal_kv_starts_mid_tile": dict(shape=(2, 2, 72, 128), kv_lens=None,
                                           kv_starts=[0, 29], causal=True),
    "kv_len_one": dict(shape=(2, 2, 40, 64), kv_lens=[1, 33], kv_starts=None, causal=False),
    "ragged_72_kv_len_65": dict(shape=(2, 2, 72, 64), kv_lens=[65, 72], kv_starts=None,
                                causal=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax_kernel(case):
    c = CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(c["shape"]).astype(np.float32) for _ in range(3))
    lens = None if c["kv_lens"] is None else np.asarray(c["kv_lens"], np.int32)
    starts = None if c["kv_starts"] is None else np.asarray(c["kv_starts"], np.int32)
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_lens=None if lens is None else jnp.asarray(lens), causal=c["causal"],
        kv_starts=None if starts is None else jnp.asarray(starts), interpret=True,
    )
    got = tattn.flash_attention(
        t(q), t(k), t(v), kv_lens=None if lens is None else t(lens), causal=c["causal"],
        kv_starts=None if starts is None else t(starts),
    )
    assert max_err(want, got) < TOL
    # the contract: a row with no valid key is exact zeros, not mean(V)
    b, _, tq, _ = c["shape"]
    col = np.arange(tq)
    lo = np.zeros(b, np.int32) if starts is None else starts
    hi = np.full(b, tq, np.int32) if lens is None else lens
    allowed = (col[None, None, :] >= lo[:, None, None]) & (col[None, None, :] < hi[:, None, None])
    allowed = np.broadcast_to(allowed, (b, tq, tq))  # [B, row, col]; Tq == Tk here
    if c["causal"]:
        allowed = allowed & (col[None, None, :] <= col[None, :, None])
    dead = ~allowed.any(axis=-1)  # [B, T]
    assert torch.all(got.permute(0, 2, 1, 3)[torch.from_numpy(dead)] == 0)
    if case == "fully_masked_row":
        assert dead[0].all()


def test_flash_attention_cpu_launches_no_kernel():
    before = tattn.flash_attention.launches
    x = torch.zeros(1, 1, 8, 16)
    tattn.flash_attention(x, x, x)
    assert tattn.flash_attention.launches == before


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_flash_attention_rejects_non_positive_scale(scale):
    """The contract on every device: the kernel's running max is taken on the
    unscaled scores, so a scale <= 0 is refused on the CPU as on the card."""
    x = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="scale must be positive"):
        tattn.flash_attention(x, x, x, scale=scale)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_jax(causal):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 2, 5, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 7, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 7, 8)).astype(np.float32)
    mask = np.arange(7)[None, None, None, :] < np.asarray([7, 3])[:, None, None, None]
    bias = rng.standard_normal((1, 2, 5, 7)).astype(np.float32)
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias),
        mask=jnp.asarray(mask), causal=causal,
    )
    got = tattn.dot_product_attention(t(q), t(k), t(v), bias=t(bias), mask=t(mask), causal=causal)
    assert max_err(want, got) < TOL
