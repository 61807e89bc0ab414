"""On-device kernel verification: every hand-written kernel against its oracle.

Port of ``multimodalvc_tpu/ops/selftest.py``.  The CPU tests hold each
kernel wrapper's plain PyTorch version to the JAX package; they cannot show
that a CUDA kernel builds, launches or computes the right numbers on the
card.  This module runs each kernel through the port's public entry at the
JAX selftest's production shapes, seeds and tolerances, and checks it
against the same oracle math the JAX check uses (f32 where the JAX oracle is
f32, never the kernel's own bf16 plain version).

Consumers of the one registry:
  * ``pytest -m cuda`` (``tests/test_torch_selftest_cuda.py``, one test a
    check, skipped without a card);
  * ``chip_smoke.py``'s ``selftest`` phase, which fails the smoke run on a
    red record;
  * ``run_all(device="cpu")`` runs the same checks through the plain
    versions, which is what the CPU tests do.

``run_all`` turns any exception into a failed record, so a kernel that
fails to build or to launch is a red check, not a crash of the caller.  A
check runs on the ``device`` it is given: nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

CHECKS: Dict[str, Callable[[str], dict]] = {}


def _check(name: str):
    def reg(fn):
        CHECKS[name] = fn
        return fn

    return reg


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _result(name: str, got, want, tol: float, exact: bool = False) -> dict:
    got, want = _host(got), _host(want)
    if exact:
        err = float(np.max(got != want)) if got.size else 0.0
    else:
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
    return {"name": name, "max_err": err, "tol": tol, "ok": bool(err <= tol)}


def _worst(name: str, results: List[dict]) -> dict:
    """Collapse sub-results into one record keyed by the worst margin."""
    bad = [r for r in results if not r["ok"]]
    pick = bad[0] if bad else max(results, key=lambda r: r["max_err"] / max(r["tol"], 1e-30))
    return {"name": name, "max_err": pick["max_err"], "tol": pick["tol"],
            "ok": all(r["ok"] for r in results)}


def _normal(rng: np.random.Generator, shape, dtype: torch.dtype, device: str,
            scale: float = 1.0) -> torch.Tensor:
    """``rng.standard_normal(shape)`` (times ``scale``) as f32, then ``dtype``
    on ``device``: the JAX check's ``jnp.asarray(..., dtype)``."""
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _ints(values, device: str) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int32), device=device)


# ---- flash attention, K1 (ops/attention.py) ------------------------------------


def _flash_fwd(name: str, seed: int, shape, kv_lens, kv_starts, causal: bool,
               device: str) -> dict:
    from .attention import _windowed_reference_attention, flash_attention

    rng = np.random.default_rng(seed)
    b, h, t, d = shape
    q, k, v = (_normal(rng, shape, torch.bfloat16, device) for _ in range(3))
    lens = _ints(kv_lens, device)
    starts = _ints(kv_starts if kv_starts is not None else [0] * b, device)
    got = flash_attention(q, k, v, kv_lens=lens, causal=causal,
                          kv_starts=None if kv_starts is None else starts)
    want = _windowed_reference_attention(q.float(), k.float(), v.float(), lens, starts, causal,
                                         1.0 / math.sqrt(d))
    return _result(name, got.float(), want, tol=3e-2)


@_check("flash_fwd_encoder")
def _flash_fwd_encoder(device: str) -> dict:
    """The Whisper / AV-HuBERT encoder shape: a long sequence, d=64, a
    kv_lens mask."""
    return _flash_fwd("flash_fwd_encoder", 0, (2, 16, 768, 64), [700, 512], None, False, device)


@_check("flash_fwd_llama_prefill")
def _flash_fwd_llama_prefill(device: str) -> dict:
    """The LLaMA prefill shape: causal, d=128, a left-padded window through
    kv_starts."""
    return _flash_fwd("flash_fwd_llama_prefill", 1, (2, 24, 256, 128), [256, 200], [0, 37],
                      True, device)


@_check("flash_fwd_llama_prefill_1kb")
def _flash_fwd_llama_prefill_1kb(device: str) -> dict:
    """A long-prompt prefill (t=512, d=128), eight left pads."""
    return _flash_fwd("flash_fwd_llama_prefill_1kb", 14, (8, 24, 512, 128), [512] * 8,
                      [0, 63, 0, 0, 17, 0, 0, 128], True, device)


@_check("flash_vjp")
def _flash_vjp(device: str) -> dict:
    """The backward: the JAX custom VJP's semantics, built here on f32 q, k,
    v (``FlashAttentionGrad`` takes bf16 only): the value is K1's, launched
    on the inputs' bf16 rounding, and the gradient is the VJP of the plain
    windowed attention recomputed in f32, so the grads must track autograd
    of the f32 reference closely.  The CPU runs ``flash_attention``'s plain
    version for the value."""
    from .attention import _windowed_reference_attention, flash_attention

    rng = np.random.default_rng(2)
    b, h, t, d = 1, 4, 256, 64
    q, k, v = (_normal(rng, (b, h, t, d), torch.float32, device, 0.3) for _ in range(3))
    lens, starts = _ints([220], device), _ints([0], device)
    cot = _normal(rng, (b, h, t, d), torch.float32, device)
    scale = 1.0 / math.sqrt(d)

    def reference(q, k, v):
        return _windowed_reference_attention(q, k, v, lens, starts, True, scale)

    def kernel(q, k, v):
        half = [x.detach().to(torch.bfloat16) for x in (q, k, v)]
        value = flash_attention(*half, kv_lens=lens, causal=True).float()
        recompute = reference(q, k, v)
        return value + (recompute - recompute.detach())

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad((fn(*leaves) * cot).sum(), leaves)

    subs = [_result(f"flash_vjp/{n}", a, b_, tol=2e-3)
            for n, a, b_ in zip("qkv", grads(kernel), grads(reference))]
    return _worst("flash_vjp", subs)


# ---- decode attention, K2 and K3 (ops/decode_attention.py) -----------------------


def _partials(name: str, got, want) -> dict:
    subs = [_result(f"{name}/{part}", a, b_, tol=5e-2)
            for part, a, b_ in zip(("out", "m", "l"), got, want)]
    return _worst(name, subs)


def _decode_gen_case(quant: bool, seed: int, device: str) -> dict:
    """K3 on a [B*K, slots, g, d] generated segment selected through anc.
    The JAX kernel takes f32 queries, K3 bf16 ones: the kernel and the f32
    oracle both get the bf16 rounding of the JAX check's f32 queries."""
    from .decode_attention import gen_attention_ancestor, gen_attention_ancestor_plain, quantize_kv

    rng = np.random.default_rng(seed)
    b, beams, slots, g, h, d = 2, 5, 64, 8, 24, 128
    rows = b * beams
    q = _normal(rng, (rows, h, d), torch.bfloat16, device)
    gk = _normal(rng, (rows, slots, g, d), torch.bfloat16, device)
    gv = _normal(rng, (rows, slots, g, d), torch.bfloat16, device)
    anc = _ints(rng.integers(0, beams, (rows, slots)), device)
    valid, scale = 41, 1.0 / math.sqrt(d)
    kw = {}
    if quant:
        gk, ks = quantize_kv(gk)
        gv, vs = quantize_kv(gv)
        kw = dict(k_scale=ks, v_scale=vs)
    name = "decode_gen_ancestor_" + ("int8" if quant else "bf16")
    got = gen_attention_ancestor(q, gk, gv, anc, valid, beams=beams,
                                 scale=scale, **kw)
    want = gen_attention_ancestor_plain(q, gk, gv, anc, valid, beams=beams, scale=scale, **kw)
    return _partials(name, got, want)


@_check("decode_gen_ancestor_bf16")
def _decode_gen_bf16(device: str) -> dict:
    return _decode_gen_case(False, 3, device)


@_check("decode_gen_ancestor_int8")
def _decode_gen_int8(device: str) -> dict:
    return _decode_gen_case(True, 4, device)


def _decode_prompt_case(quant: bool, seed: int, device: str) -> dict:
    """K2 on the shared [B, g, Tp, d] prompt with a 60-slot left pad, the
    queries as in ``_decode_gen_case``."""
    from .decode_attention import prompt_attention, prompt_attention_plain, quantize_kv

    rng = np.random.default_rng(seed)
    b, beams, tp, g, h, d = 2, 5, 256, 8, 24, 128
    rows = b * beams
    q = _normal(rng, (rows, h, d), torch.bfloat16, device)
    pk = _normal(rng, (b, g, tp, d), torch.bfloat16, device)
    pv = _normal(rng, (b, g, tp, d), torch.bfloat16, device)
    mask = np.ones((b, tp), np.int32)
    mask[1, :60] = 0  # left pad
    mask = _ints(mask, device)
    scale = 1.0 / math.sqrt(d)
    kw = {}
    if quant:
        pk, ks = quantize_kv(pk)
        pv, vs = quantize_kv(pv)
        kw = dict(k_scale=ks, v_scale=vs)
    name = "decode_prompt_" + ("int8" if quant else "bf16")
    got = prompt_attention(q, pk, pv, mask, beams=beams, scale=scale, **kw)
    want = prompt_attention_plain(q, pk, pv, mask, beams=beams, scale=scale, **kw)
    return _partials(name, got, want)


@_check("decode_prompt_bf16")
def _decode_prompt_bf16(device: str) -> dict:
    return _decode_prompt_case(False, 5, device)


@_check("decode_prompt_int8")
def _decode_prompt_int8(device: str) -> dict:
    return _decode_prompt_case(True, 6, device)


# ---- beam-search kernels, K4, K5 and K6 (ops/topk.py, ops/beam_gather.py) --------


def _topk_record(name: str, got, logp: torch.Tensor, scores: torch.Tensor, n: int) -> dict:
    """``got`` (values, flat indices) against ``lax.top_k`` of
    scores[:, :, None] + logp over the flattened [B, K*V] row: values within
    1e-6, indices exact (they drive the beam selection)."""
    from .topk import top_k

    b = scores.shape[0]
    want_v, want_i = top_k((scores[:, :, None] + logp).reshape(b, -1), n)
    return _worst(name, [_result(f"{name}/values", got[0], want_v, tol=1e-6),
                         _result(f"{name}/indices", got[1], want_i, tol=0.0, exact=True)])


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``'s op order: (x - max) - log(sum(exp(x - max)))."""
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


@_check("beam_topk")
def _beam_topk(device: str) -> dict:
    """K5 on the production candidate row: [B, K, V] = [4, 5, 128256]."""
    from .topk import beam_topk

    rng = np.random.default_rng(7)
    b, k, v, n = 4, 5, 128256, 10
    logp = _normal(rng, (b, k, v), torch.float32, device)
    scores = _normal(rng, (b, k), torch.float32, device)
    return _topk_record("beam_topk", beam_topk(logp, scores, n), logp, scores, n)


def _from_logits_case(name: str, entry, seed: int, planted: bool, device: str) -> dict:
    """K4 / K5 from raw [B*K, V] unembed logits and their row max and
    logsumexp, at the serving shape of batch 48, beam 5."""
    from .topk import row_stats

    rng = np.random.default_rng(seed)
    b, k, v, n = 48, 5, 128256, 10
    logits = rng.standard_normal((b * k, v)).astype(np.float32) * np.float32(3.0)
    if planted:  # one column winning for three beam rows
        logits[0 * k + 0, 999] = 40.0
        logits[0 * k + 1, 999] = 39.5
        logits[0 * k + 3, 999] = 39.0
    logits = torch.from_numpy(logits).to(device)
    scores = _normal(rng, (b, k), torch.float32, device)
    row_max, row_ls = row_stats(logits)
    got = entry(logits, row_max, row_ls, scores, n)
    return _topk_record(name, got, _log_softmax(logits).reshape(b, k, v), scores, n)


@_check("beam_topk_from_logits")
def _beam_topk_from_logits(device: str) -> dict:
    from .topk import beam_topk_from_logits

    return _from_logits_case("beam_topk_from_logits", beam_topk_from_logits, 11, False, device)


@_check("beam_topk_columns")
def _beam_topk_columns(device: str) -> dict:
    """With several winners in one column, which the merge must keep."""
    from .topk import beam_topk_columns

    return _from_logits_case("beam_topk_columns", beam_topk_columns, 13, True, device)


@_check("beam_gather_rows")
def _beam_gather_rows(device: str) -> dict:
    """K6: a row gather over a KV-cache-shaped leaf against indexing."""
    from .beam_gather import gather_rows

    rng = np.random.default_rng(8)
    x = _normal(rng, (40, 64, 8, 128), torch.bfloat16, device)
    src = _ints(rng.integers(0, 40, (40,)), device)
    got = gather_rows(x, src)
    return _result("beam_gather_rows", got.float(), x[src.long()].float(), tol=0.0, exact=True)


# ---- quantized matmuls, K7 and K8 (ops/int8_matmul.py) ----------------------------


def _int8_case(name: str, seed: int, rows: int, d_in: int, d_out: int, device: str) -> dict:
    """K7 against the bf16 operands' products summed in f32 (numpy on the
    host), times the column scales."""
    from .int8_matmul import int8_matmul, quantize_kernel

    rng = np.random.default_rng(seed)
    w = _normal(rng, (d_in, d_out), torch.float32, device, 0.02)
    w_q, w_s = quantize_kernel(w)
    x = _normal(rng, (rows, d_in), torch.bfloat16, device)
    got = int8_matmul(x, w_q, w_s, out_dtype=torch.float32)
    want = (x.float().cpu().numpy() @ w_q.float().cpu().numpy()) * w_s.cpu().numpy()[None, :]
    return _result(name, got, want, tol=1e-2)


@_check("int8_matmul_trunk")
def _int8_matmul_trunk(device: str) -> dict:
    """The decode-shape trunk matmul (the kernel's row rule), 3072x3072."""
    return _int8_case("int8_matmul_trunk", 9, 240, 3072, 3072, device)


@_check("int8_matmul_unembed")
def _int8_matmul_unembed(device: str) -> dict:
    """A wide output (d_out 16384, the tied lm-head's kind)."""
    return _int8_case("int8_matmul_unembed", 10, 240, 1024, 16384, device)


@_check("int4_matmul")
def _int4_matmul(device: str) -> dict:
    """K8 against the f32 dequantization (numpy on the host): the nibbles
    half-split over the input axis, the scales per (group, output column)."""
    from .int8_matmul import INT4_GROUP, int4_matmul, quantize_kernel_int4

    rng = np.random.default_rng(11)
    rows, d_in, d_out = 240, 1024, 2048
    w = _normal(rng, (d_in, d_out), torch.float32, device, 0.02)
    w_q, w_s = quantize_kernel_int4(w)
    x = _normal(rng, (rows, d_in), torch.bfloat16, device)
    got = int4_matmul(x, w_q, w_s, out_dtype=torch.float32)
    p = w_q.cpu().numpy().astype(np.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    q = np.concatenate([lo, hi], axis=0).astype(np.float32)
    w_deq = (q.reshape(d_in // INT4_GROUP, INT4_GROUP, d_out)
             * w_s.cpu().numpy()[:, None, :]).reshape(d_in, d_out)
    want = x.float().cpu().numpy() @ w_deq
    return _result("int4_matmul", got, want, tol=5e-2)


# ---- the end-to-end decode ---------------------------------------------------------


@_check("generate_smoke")
def _generate_smoke(device: str) -> dict:
    """A tiny ``generate_beam``: the ancestry decode against the physical
    gather (the default), each a completed run with valid ids, the ancestry
    decode also with an int8 KV cache.

    The two paths compute attention with different (algebraically equal)
    algorithms, so bf16 rounding can flip near-tied beam picks on a random
    tiny model, and token equality is too strict.  A broken kernel gives
    beam scores far outside rounding, so the check compares the final beam
    scores within a tolerance and asks each path to repeat itself exactly.
    ``LlamaConfig.tiny()`` with 128-wide heads, the only head width of the
    decode kernels (csrc/decode_attention.cu), and the module in bf16, the
    kernels' type: on the card the decode runs K3 (bf16 KV), the merged
    K2 + K3 entry (int8 KV) and K4."""
    from ..nn.init import init_random_
    from ..nn.llama import LlamaConfig, LlamaModel, generate_beam

    cfg = dataclasses.replace(LlamaConfig.tiny(), head_dim=128, lora=None)
    model = LlamaModel(cfg, device=device, dtype=torch.bfloat16)
    init_random_(model, 0)
    rng = np.random.default_rng(12)
    emb = _normal(rng, (2, 7, cfg.hidden_size), torch.bfloat16, device, 0.05)
    mask = np.ones((2, 7), np.int32)
    mask[1, :3] = 0
    mask = _ints(mask, device)
    kw = dict(eos_token_id=2, pad_token_id=0, num_beams=5, max_new_tokens=8)
    with torch.no_grad():
        seq_default, sc_default = generate_beam(model, emb, mask, **kw)
        seq_anc, sc_anc = generate_beam(model, emb, mask, ancestry_reorder=True, **kw)
        seq_anc2, _ = generate_beam(model, emb, mask, ancestry_reorder=True, **kw)
        seq_int8, _ = generate_beam(model, emb, mask, ancestry_reorder=True, kv_quant="int8",
                                    **kw)
    subs = [
        _result("generate_smoke/scores", sc_anc, sc_default, tol=0.1),
        _result("generate_smoke/deterministic", seq_anc2, seq_anc, tol=0.0, exact=True),
    ]
    # int8 KV is lossy by design: a completed run with valid ids
    for tag, seq in (("int8", seq_int8), ("default", seq_default)):
        valid = bool(((seq >= 0) & (seq < cfg.vocab_size)).all())
        subs.append({"name": f"generate_smoke/{tag}_valid", "max_err": 0.0 if valid else 1.0,
                     "tol": 0.0, "ok": valid})
    return _worst("generate_smoke", subs)


def run_all(names: Optional[Sequence[str]] = None, device: str = "cuda") -> List[dict]:
    """Run the registered checks (all by default) on ``device``.  An
    exception becomes a failed record with its ``error``: a kernel that does
    not build or launch fails its check, not the caller."""
    out = []
    for name, fn in CHECKS.items():
        if names and name not in names:
            continue
        try:
            out.append(fn(device))
        except Exception as e:  # noqa: BLE001 - any crash is a red check
            out.append({"name": name, "max_err": float("inf"), "tol": 0.0, "ok": False,
                        "error": f"{type(e).__name__}: {e}"})
    return out
