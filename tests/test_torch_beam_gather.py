"""K6 parity: the port's gather_rows / gather_rows_many / gather_beams_rows
(plain versions on the CPU) against the JAX Pallas kernel in interpret mode,
exactly, the beam reorder of a decode cache against the JAX _gather_beams,
and its one launch for every eligible leaf (meta tensors, a recording
stand-in for the kernel library)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from multimodalvc_tpu.ops import beam_gather as jbg
from multimodalvc_tpu.ops.beam_search import _gather_beams as jax_gather_beams
from multimodalvc_tpu_torch.ops import beam_gather as tbg
from multimodalvc_tpu_torch.ops import kernel_lib
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


# leaves of mixed types and row sizes, one src for all: the generated KV of a
# gather cache (bf16 stands in as f32 here), an int8 leaf, a long row
MANY = [((B * K, 6, 2, 128), np.float32), ((B * K, 3, 128), np.int8),
        ((B * K, 2, 4, 256), np.int32), ((B * K + 3, 5, 128), np.float32)]


def test_gather_rows_many_matches_jax_kernel_per_leaf():
    """gather_rows_many: every leaf exactly the JAX Pallas kernel's rows
    (interpret mode) for the one shared src, with repeats and M != N."""
    rng = np.random.default_rng(3)
    xs = [(rng.standard_normal(shape) * 50).astype(dtype) for shape, dtype in MANY]
    src = np.asarray([3, 3, 0, 11, 5, 5, 5, 1, 2, 10, 0, 7, 4], np.int32)
    got = tbg.gather_rows_many([t(x) for x in xs], t(src))
    assert len(got) == len(xs)
    for x, g in zip(xs, got):
        want = jbg.gather_rows(jnp.asarray(x), jnp.asarray(src), interpret=True)
        assert g.dtype == t(x).dtype
        np.testing.assert_array_equal(np.asarray(want), g.numpy())
    assert [g.numpy().tolist() for g in tbg.gather_rows_many_plain([t(x) for x in xs], t(src))] \
        == [g.numpy().tolist() for g in got]


class _Recorder:
    """A stand-in for the kernel library: records each C call."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


def _meta_cache(layers=3):
    """A gather cache of ``layers`` layers on meta tensors: K6-eligible
    generated KV leaves (bf16 [B*K, 64, 8, 128], 2**18 elements each), a
    fixed_ leaf of the same shape, small leaves and the shared prompt."""
    meta = dict(device="meta")
    big = (B * K, 64, 8, 128)
    return {
        "layers": [{"k": torch.empty(big, dtype=torch.bfloat16, **meta),
                    "v": torch.empty(big, dtype=torch.bfloat16, **meta),
                    "prompt_k": torch.empty(B, 8, 5, 128, dtype=torch.bfloat16, **meta)}
                   for _ in range(layers)],
        "fixed_k": torch.empty(big, dtype=torch.bfloat16, **meta),
        "small": torch.empty(B * K, 6, 128, **meta),
        "index": 2,
    }


def test_gather_beams_reorders_every_leaf_in_one_launch(monkeypatch):
    """On the accelerator, _gather_beams sends every K6-eligible leaf of the
    tree to one gather_rows_many launch with one src built once from the
    indices; fixed_ leaves, small leaves and the shared prompt never reach
    the kernel; each output goes back to its leaf's place."""
    from multimodalvc_tpu_torch.ops import beam_search

    lib = _Recorder()
    monkeypatch.setattr(kernel_lib, "load", lambda: lib)
    monkeypatch.setattr(kernel_lib, "check", lambda *a, **kw: None)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(beam_search, "_on_accelerator", lambda x: True)
    srcs = []
    beam_src = tbg.beam_src
    monkeypatch.setattr(tbg, "beam_src", lambda *a: srcs.append(a) or beam_src(*a))
    small_gathers = []
    gather = torch.gather
    monkeypatch.setattr(torch, "gather", lambda *a, **kw: small_gathers.append(a[0].shape)
                        or gather(*a, **kw))
    cache = _meta_cache()
    indices = torch.zeros(B, K, dtype=torch.long, device="meta")
    before = tbg.gather_rows.launches
    out = torch_gather_beams(cache, indices, B, K)
    assert tbg.gather_rows.launches - before == 1 and len(srcs) == 1
    (name, args), = lib.calls
    assert name == "mmvc_gather_rows_many" and args[0] == 6  # k and v of 3 layers
    assert list(args[3]) == [64 * 8 * 128 * 2] * 6 and list(args[4]) == [B * K] * 6
    assert args[6] == B * K  # m: one source row an output row
    assert out["fixed_k"] is cache["fixed_k"] and out["index"] == 2
    for new, old in zip(out["layers"], cache["layers"]):
        assert new["prompt_k"] is old["prompt_k"]  # [B, ...]: not a beam leaf
        for key in ("k", "v"):
            assert new[key] is not old[key] and new[key].shape == old[key].shape
    assert len({id(layer[key]) for layer in out["layers"] for key in ("k", "v")}) == 6
    assert small_gathers == [(B, K, 6, 128)]  # only the small leaf takes torch.gather


def test_gather_beams_on_the_cpu_launches_nothing(monkeypatch):
    """CPU leaves never reach the kernel library."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(kernel_lib, "load", refuse)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B * K, 64, 8, 128)).astype(np.float32)
    parents = rng.integers(0, K, (B, K)).astype(np.int64)
    got = torch_gather_beams({"k": t(x)}, t(parents), B, K)
    np.testing.assert_array_equal(
        got["k"].numpy(), x.reshape(B, K, -1)[np.arange(B)[:, None], parents].reshape(x.shape))
