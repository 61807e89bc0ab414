"""K7/K8 parity: the port's weight quantization, int8_matmul and int4_matmul
(plain versions on the CPU) against the JAX package (Pallas kernels in
interpret mode with small blocks, and its dense path), then QuantDense,
LoraDense and LlamaMLP through the weight bridge, and quantize_llama_params
/ the in-place quantize_llama_ against the JAX quantize_llama_params."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t, to_numpy_tree

from multimodalvc_tpu.nn import llama as jl
from multimodalvc_tpu.ops import int8_matmul as jq
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_variables
from multimodalvc_tpu_torch.nn import llama as tl
from multimodalvc_tpu_torch.ops import int8_matmul as tq

# f32 outputs of exact bf16 x bf16 products summed in f32: the kernel, XLA and
# the port differ only in summation order (~1e-7 relative at these widths)
TOL = 1e-5


def _kernel(rng, d_in, d_out):
    w = (rng.standard_normal((d_in, d_out)) * 0.05).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero column: amax floored at 1e-12
    return w


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_kernel_bytes_match_jax(mode):
    rng = np.random.default_rng(0)
    w = _kernel(rng, 256, 4096 + 384)  # two column chunks
    w[3, 5], w[7, 5] = 0.5, -0.5  # ties at amax: +-127 (+-7)
    jfn, tfn = ((jq.quantize_kernel_int4, tq.quantize_kernel_int4) if mode == "int4"
                else (jq.quantize_kernel, tq.quantize_kernel))
    (wq, ws), (gq, gs) = jfn(jnp.asarray(w)), tfn(t(w))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(wq), gq.numpy())
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())


# (lead dims, d_in, d_out, JAX kernel blocks): inside the shape rule with
# small blocks, then through its dense path (odd dims, rows > 512)
INT8_CASES = {
    "kernel": ((40,), 512, 768, dict(block_in=256, block_out=256)),
    "lead_dims": ((2, 3), 256, 128, {}),
    "dense_odd": ((4,), 100, 64, {}),
    "dense_rows": ((600,), 256, 128, {}),
}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_matmul_matches_jax(case):
    lead, d_in, d_out, blocks = INT8_CASES[case]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(lead + (d_in,)) * 0.3).astype(np.float32)
    w_q, w_s = jq.quantize_kernel(jnp.asarray(_kernel(rng, d_in, d_out)))
    want = jq.int8_matmul(jnp.asarray(x), w_q, w_s, interpret=True, **blocks)
    got = tq.int8_matmul(t(x), t(w_q), t(w_s))
    assert got.shape == lead + (d_out,) and got.dtype == torch.float32
    assert max_err(want, got) < TOL


# (d_in, d_out) of the LLaMA-3.2-3B trunk (q/o, k/v, gate/up, down) and the
# tied unembed, at the decode's 40 rows (batch 8 x beam 5) and 240 (48 x 5)
K7_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256)]


@pytest.mark.parametrize("rows", [40, 240])
@pytest.mark.parametrize("d_in,d_out", K7_SHAPES)
def test_k7_plan(rows, d_in, d_out):
    """K7's split-K schedule: K chunks that divide d_in in whole 32-row
    stages, a grid of K7_MIN_BLOCKS blocks unless the minimum chunk stops it
    or the tiles alone reach it, row tiles that cover the rows, the
    workspace of the split partials and the groups of the split sum."""
    p = tq.k7_plan(rows, d_in, d_out)
    assert p.kc * p.splits == d_in and p.kc % tq.K7_KSTEP == 0 and p.kc >= tq.K7_MIN_KC
    row_tiles = -(-rows // p.row_tile)
    tiles = d_out // tq.K7_BN * row_tiles
    if tiles >= tq.K7_MIN_BLOCKS:
        assert p.splits == 1
    else:
        assert tiles * p.splits >= tq.K7_MIN_BLOCKS or p.kc == tq.K7_MIN_KC
    assert p.row_tile % 8 == 0 and p.row_tile <= tq.K7_MAX_ROW_TILE
    assert row_tiles <= -(-rows // tq.K7_MAX_ROW_TILE)  # no more row tiles than 64-row ones
    assert p.workspace == (p.splits * rows * d_out if p.splits > 1 else 0)
    groups = -(-p.splits // p.group)
    assert (groups - 1) * p.group < p.splits <= groups * p.group
    assert p.counters <= tq.K7_COUNTERS and (p.splits == 1) == (p.counters == 0)
    if rows == 40:  # five n8 tiles, no dead rows
        assert p.row_tile == 40


@pytest.mark.parametrize("rows", [40, 240])
@pytest.mark.parametrize("d_in,d_out", K7_SHAPES)
def test_k8_plan(rows, d_in, d_out):
    """K8 on K7's schedule over the d_in / 2 packed rows: K chunks of whole
    32-row stages and whole scale groups, so that every stage lies in one
    scale group of each half; a grid of K7_MIN_BLOCKS blocks unless the
    minimum chunk stops it or the tiles alone reach it; row tiles, workspace
    and counters as K7's."""
    half, group = d_in // 2, tq.INT4_GROUP
    p = tq.k8_plan(rows, d_in, d_out)
    assert p.kc * p.splits == half and p.kc % tq.K7_KSTEP == 0 and p.kc % group == 0
    assert p.kc >= tq.K7_MIN_KC
    for kb in range(0, half, tq.K7_KSTEP):  # every stage of every chunk
        for first in (kb, half + kb):  # its low- and high-nibble rows
            assert first // group == (first + tq.K7_KSTEP - 1) // group
    row_tiles = -(-rows // p.row_tile)
    tiles = d_out // tq.K7_BN * row_tiles
    if tiles >= tq.K7_MIN_BLOCKS:
        assert p.splits == 1
    else:
        assert tiles * p.splits >= tq.K7_MIN_BLOCKS or p.kc == tq.K7_MIN_KC
    assert p.row_tile % 8 == 0 and p.row_tile <= tq.K7_MAX_ROW_TILE
    assert row_tiles <= -(-rows // tq.K7_MAX_ROW_TILE)
    assert p.workspace == (p.splits * rows * d_out if p.splits > 1 else 0)
    groups = -(-p.splits // p.group)
    assert (groups - 1) * p.group < p.splits <= groups * p.group
    assert p.counters <= tq.K7_COUNTERS and (p.splits == 1) == (p.counters == 0)
    if rows == 40:
        assert p.row_tile == 40


@pytest.mark.parametrize("group", [32, 64, 48, 100])
def test_k8_plan_takes_only_groups_of_whole_stages(group):
    """A scale group that is not a multiple of the 32-row stage would put
    two groups in one stage: k8_plan, and so the CUDA wrapper, raises."""
    if group % tq.K7_KSTEP:
        with pytest.raises(ValueError, match="scale group"):
            tq.k8_plan(40, 3072, 3072, group)
    else:
        assert tq.k8_plan(40, 3072, 3072, group).kc % group == 0


INT4_CASES = {
    "kernel": ((24,), 512, 384, dict(block_in=128, block_out=128)),
    "dense_odd": ((8,), 256, 192, {}),
    "dense_rows": ((600,), 512, 384, {}),
}


@pytest.mark.parametrize("case", list(INT4_CASES))
def test_int4_matmul_matches_jax(case):
    """Held against the JAX kernel itself, which rounds each dequantized
    weight to bf16 before the product (not the f32 oracle of its selftest)."""
    lead, d_in, d_out, blocks = INT4_CASES[case]
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(lead + (d_in,)) * 0.3).astype(np.float32)
    packed, scale = jq.quantize_kernel_int4(jnp.asarray(_kernel(rng, d_in, d_out)))
    want = jq.int4_matmul(jnp.asarray(x), packed, scale, interpret=True, **blocks)
    got = tq.int4_matmul(t(x), t(packed), t(scale))
    assert got.shape == lead + (d_out,)
    assert max_err(want, got) < TOL


def test_bridge_keeps_quantized_leaves_untransposed():
    """The quantized leaves cross the bridge in the flax [d_in, d_out] layout
    and their packed formats: one checkpoint serves both packages."""
    rng = np.random.default_rng(5)
    w_q, w_s = jq.quantize_kernel(jnp.asarray(_kernel(rng, 256, 128)))
    packed, g_s = jq.quantize_kernel_int4(jnp.asarray(_kernel(rng, 256, 128)))
    tree = {"params": {"a": {"w_q": w_q, "w_scale": w_s}, "b": {"w_packed": packed, "w_scale": g_s}}}
    sd = flax_to_state_dict(to_numpy_tree(tree))
    for key, want in [("a.w_q", w_q), ("a.w_scale", w_s), ("b.w_packed", packed), ("b.w_scale", g_s)]:
        assert sd[key].dtype == t(np.asarray(want)).dtype
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(want))


def _quant_tree(kernel: np.ndarray, mode: str) -> dict:
    if mode == "int4":
        p, s = jq.quantize_kernel_int4(jnp.asarray(kernel))
        return {"w_packed": p, "w_scale": s}
    q, s = jq.quantize_kernel(jnp.asarray(kernel))
    return {"w_q": q, "w_scale": s}


def _modules(kind, mode, rng, d_in=256, d_out=384):
    if kind == "quant_dense":
        params = _quant_tree(_kernel(rng, d_in, d_out), mode)
        return jl.QuantDense(d_out, mode=mode), tl.QuantDense(d_in, d_out, mode), params
    if kind == "lora_dense":
        params = {
            "base_q": _quant_tree(_kernel(rng, d_in, d_out), mode),
            "lora_a": (rng.standard_normal((d_in, 4)) * 0.05).astype(np.float32),
            "lora_b": (rng.standard_normal((4, d_out)) * 0.05).astype(np.float32),
        }
        return (jl.LoraDense(d_out, lora=jl.LoraConfig(rank=4, alpha=8), quant=mode),
                tl.LoraDense(d_in, d_out, tl.LoraConfig(rank=4, alpha=8), quant=mode), params)
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), hidden_size=d_in, intermediate_size=512,
                               weight_quant=mode)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), hidden_size=d_in, intermediate_size=512,
                               weight_quant=mode)
    params = {name: _quant_tree(_kernel(rng, *shape), mode) for name, shape in [
        ("gate_proj", (d_in, 512)), ("up_proj", (d_in, 512)), ("down_proj", (512, d_in))]}
    return jl.LlamaMLP(jcfg), tl.LlamaMLP(tcfg), params


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("kind", ["quant_dense", "lora_dense", "mlp"])
def test_quantized_modules_match_jax_through_the_bridge(kind, mode):
    rng = np.random.default_rng(3)
    jmod, tmod, params = _modules(kind, mode, rng)
    x = (rng.standard_normal((2, 3, 256)) * 0.5).astype(np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    load_flax_variables(tmod, to_numpy_tree({"params": params}))
    assert not list(tmod.parameters()) or kind == "lora_dense"  # quantized leaves are buffers
    with torch.no_grad():
        got = tmod(t(x))
    # the MLP feeds silu(gate) * up, cast to bf16, into down_proj: an f32
    # last-bit difference there can flip one bf16 rounding (2^-9 relative)
    assert max_err(want, got) < (1e-4 if kind == "mlp" else TOL)


def _tiny_llama_cfgs(mode=None):
    kw = dict(hidden_size=256, intermediate_size=512, head_dim=64, weight_quant=mode)
    return (dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=384), **kw),
            dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=384), **kw))


@pytest.fixture(scope="module")
def float_llama():
    jcfg, _ = _tiny_llama_cfgs()
    rng = np.random.default_rng(4)
    emb = (rng.standard_normal((2, 7, 256)) * 0.5).astype(np.float32)
    v = randomize(jax.jit(jl.LlamaModel(jcfg).init)(jax.random.PRNGKey(0),
                                                    inputs_embeds=jnp.asarray(emb)))
    return v, emb


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_llama_params_matches_jax(float_llama, mode):
    """The port's quantize_llama_params and its in-place quantize_llama_ give
    the JAX package's leaves byte for byte, and the quantized models agree."""
    v, emb = float_llama
    jcfg, tcfg = _tiny_llama_cfgs(mode)
    q_params = jl.quantize_llama_params(v["params"], mode=mode)
    want_sd = flax_to_state_dict(to_numpy_tree({"params": q_params}))
    got_sd = tl.quantize_llama_params(flax_to_state_dict(to_numpy_tree(v)), mode)
    assert sorted(got_sd) == sorted(want_sd)
    for key, want in want_sd.items():
        assert got_sd[key].dtype == want.dtype and torch.equal(got_sd[key], want), key

    float_cfg = dataclasses.replace(tcfg, weight_quant=None)
    model = tl.quantize_llama_(loaded(tl.LlamaModel(float_cfg), v), mode)
    inplace = model.state_dict()
    assert model.cfg.weight_quant == mode and sorted(inplace) == sorted(want_sd)
    for key, want in want_sd.items():
        assert inplace[key].dtype == want.dtype and torch.equal(inplace[key], want), key

    want = jax.jit(lambda e: jl.LlamaModel(jcfg).apply({"params": q_params},
                                                       inputs_embeds=e)["logits"])(jnp.asarray(emb))
    with torch.no_grad():
        got = model(inputs_embeds=t(emb))["logits"]
    # every quantized matmul rounds its input to bf16: an f32 last-bit
    # difference upstream (the attention's summation order) flips some of
    # those roundings (2^-9 relative each), and two layers carry the flips on
    # (measured: relative L2 1.8e-3 for int8, 1.7e-5 for int4)
    want = np.asarray(want)
    assert np.linalg.norm(want - got.numpy()) / np.linalg.norm(want) < 1e-2
