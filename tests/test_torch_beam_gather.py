"""K6 parity: the port's gather_rows / gather_beams_rows (plain versions on
the CPU) against the JAX Pallas kernel in interpret mode, exactly, and the
beam reorder of a decode cache against the JAX _gather_beams."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from multimodalvc_tpu.ops import beam_gather as jbg
from multimodalvc_tpu.ops.beam_search import _gather_beams as jax_gather_beams
from multimodalvc_tpu_torch.ops import beam_gather as tbg
from multimodalvc_tpu_torch.ops.beam_search import _gather_beams as torch_gather_beams

B, K = 3, 4


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8])
def test_gather_rows_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B * K, 6, 2, 128)) * 50).astype(dtype)
    src = np.asarray([3, 3, 0, 11, 5, 5, 5, 1, 2, 10, 0, 7, 4], np.int32)  # repeats, M != N
    want = jbg.gather_rows(jnp.asarray(x), jnp.asarray(src), interpret=True)
    got = tbg.gather_rows(t(x), t(src))
    assert got.dtype == t(x).dtype
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_gather_beams_rows_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B * K, 5, 2, 128)).astype(np.float32)
    parents = rng.integers(0, K, (B, K)).astype(np.int32)
    want = jbg.gather_beams_rows(jnp.asarray(x), jnp.asarray(parents), B, K)
    got = tbg.gather_beams_rows(t(x), t(parents), B, K)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(got.numpy(), x.reshape(B, K, -1)[
        np.arange(B)[:, None], parents].reshape(x.shape))


def test_gather_beams_matches_jax_and_skips_fixed_leaves():
    rng = np.random.default_rng(2)
    leaves = {
        "k": rng.standard_normal((B * K, 6, 2, 128)).astype(np.float32),
        "fixed_k": rng.standard_normal((B * K, 6, 2, 128)).astype(np.float32),
        "anc": rng.integers(0, K, (B * K, 6)).astype(np.int32),
        "prompt_k": rng.standard_normal((B, 2, 5, 128)).astype(np.float32),
    }
    parents = np.asarray([[1, 1, 0, 3], [2, 0, 0, 0], [3, 2, 1, 0]], np.int32)
    want = jax_gather_beams(({**{n: jnp.asarray(v) for n, v in leaves.items()},
                              "index": jnp.int32(2)},), jnp.asarray(parents), B, K)
    got = torch_gather_beams(({**{n: t(v) for n, v in leaves.items()}, "index": 2},),
                             t(parents).long(), B, K)
    for name, x in leaves.items():
        np.testing.assert_array_equal(np.asarray(want[0][name]), got[0][name].numpy())
    assert torch.equal(got[0]["fixed_k"], t(leaves["fixed_k"]))  # never reordered
    assert not torch.equal(got[0]["k"], t(leaves["k"]))
    assert got[0]["index"] == 2
