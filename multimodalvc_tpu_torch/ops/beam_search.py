"""Batched beam search with HF-exact finalisation.

Port of ``multimodalvc_tpu/ops/beam_search.py:beam_search``.  The JAX
``lax.while_loop`` becomes a Python loop whose early-exit test reads one
boolean from the device per step.  On CUDA the candidate top-2K is the
fused K4 kernel (row max and logsumexp in plain PyTorch, in the JAX op
order); on CPU it is ``log_softmax`` + a flat top-k.  Every top-k keeps
``lax.top_k``'s tie order (lowest index first).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from .beam_gather import gather_beams_rows
from .topk import beam_topk_columns, top_k

NEG_INF = -1.0e7
_K6_MIN_SIZE = 1 << 18  # elements: the JAX gate for the row-gather kernel


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` op order: (x - max) - log(sum(exp(x - max)))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _gather_beams(tree: Any, indices: torch.Tensor, b: int, k: int) -> Any:
    """Select beams: indices [B, K] into the K axis of every [B*K, ...] leaf.

    Leaves whose key starts with ``fixed_`` stay put (the ancestry cache's
    generated KV; only its small ``anc`` map moves), as do scalars and
    leaves of another leading size.  Large leaves on CUDA (the gather
    cache's generated KV) take K6 under the JAX gate: ndim >= 3, at least
    2**18 elements, a last dim that is a multiple of 128.  The rest take
    ``take_along_axis`` semantics.  The JAX package's one-hot einsum branch
    for k >= 8 is an XLA lowering workaround that selects exactly the same
    rows; it has no counterpart here."""

    def gather(x):
        if not torch.is_tensor(x) or x.ndim == 0 or x.shape[0] != b * k:
            return x
        if x.is_cuda and x.ndim >= 3 and x.numel() >= _K6_MIN_SIZE and x.shape[-1] % 128 == 0:
            return gather_beams_rows(x, indices, b, k)
        xb = x.reshape((b, k) + x.shape[1:])
        idx = indices.reshape((b, k) + (1,) * (xb.ndim - 2)).expand_as(xb)
        return torch.gather(xb, 1, idx).reshape(x.shape)

    def walk(node):
        if isinstance(node, dict):
            return {
                key: val if str(key).startswith("fixed_") else walk(val)
                for key, val in node.items()
            }
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return gather(node)

    return walk(tree)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1 with idx [B, n] over [B, K, ...] leaves."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand((-1, -1) + x.shape[2:])
    return torch.gather(x, 1, idx)


def beam_search(
    decode_fn: Callable[[torch.Tensor, torch.Tensor, Any], Tuple[torch.Tensor, Any]],
    init_cache: Any,  # leaves [B*K, ...] pre-filled with the prompt
    prompt_lengths: torch.Tensor,  # [B] valid prompt length per row
    first_logits: torch.Tensor,  # [B, V] logits at the last prompt position
    eos_token_id: int,
    pad_token_id: int,
    max_new_tokens: int,
    num_beams: int = 5,
    length_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run beam search; returns (sequences [B, K, max_new_tokens], scores [B, K]).

    ``decode_fn(tokens [B*K, 1], positions [B*K, 1], cache) -> (logits
    [B*K, V], cache)`` runs one decoder step."""
    if no_repeat_ngram_size:
        raise NotImplementedError("n-gram blocking is not ported yet")
    b, vocab = first_logits.shape
    k, l = num_beams, max_new_tokens
    dev = first_logits.device
    lp = length_penalty

    # --- first expansion: top-K tokens from the prompt's last logits -------
    top_scores, top_tokens = top_k(log_softmax(first_logits.float()), k)
    live_seqs = torch.full((b, k, l), pad_token_id, dtype=torch.long, device=dev)
    live_seqs[:, :, 0] = top_tokens
    eos0 = top_tokens == eos_token_id
    finished_seqs = live_seqs.clone()
    finished_scores = torch.where(eos0, top_scores / (1.0**lp), NEG_INF)
    finished_flags = eos0
    live_scores = torch.where(eos0, NEG_INF, top_scores)
    cache = init_cache
    step = 1

    def keep_going() -> bool:
        if step >= l:
            return False
        # early exit: the best possible live score can't beat the worst finished
        best_live = live_scores.amax(dim=1) / (float(l) ** lp if lp > 0 else 1.0)
        worst_finished = torch.where(finished_flags, finished_scores, NEG_INF).amin(dim=1)
        all_done = finished_flags.all(dim=1)
        return bool(((~all_done) | (best_live > worst_finished)).any())

    while keep_going():
        flat_tokens = live_seqs[:, :, step - 1].reshape(b * k, 1)
        # HF generate positions: prompt_len + step - 1
        positions = (prompt_lengths[:, None] + step - 1).repeat_interleave(k, dim=0)
        logits, cache = decode_fn(flat_tokens, positions.reshape(-1, 1), cache)

        # 2K candidates so EOS picks never starve the live set (HF-style)
        lf = logits.float()
        if lf.is_cuda:
            row_max = lf.amax(dim=-1, keepdim=True)
            row_ls = torch.log(torch.exp(lf - row_max).sum(dim=-1, keepdim=True))
            top2k_scores, top2k_idx = beam_topk_columns(lf, row_max, row_ls, live_scores, 2 * k)
            top2k_idx = top2k_idx.long()
        else:
            cand = live_scores[:, :, None] + log_softmax(lf).reshape(b, k, vocab)
            top2k_scores, top2k_idx = top_k(cand.reshape(b, k * vocab), 2 * k)
        cand_beam = top2k_idx // vocab  # [B, 2K]
        cand_token = top2k_idx % vocab

        seqs2k = _take(live_seqs, cand_beam)
        seqs2k[:, :, step] = cand_token
        is_eos = cand_token == eos_token_id

        # ---- update the finished set -------------------------------------
        gen_len = float(step + 1)
        fin_cand_scores = torch.where(is_eos, top2k_scores / (gen_len**lp), NEG_INF)
        all_fin_seqs = torch.cat([finished_seqs, seqs2k], dim=1)
        all_fin_scores = torch.cat([finished_scores, fin_cand_scores], dim=1)
        all_fin_flags = torch.cat([finished_flags, is_eos], dim=1)
        finished_scores, top_fin_idx = top_k(all_fin_scores, k)
        finished_seqs = _take(all_fin_seqs, top_fin_idx)
        finished_flags = torch.gather(all_fin_flags, 1, top_fin_idx)

        # ---- update the live set (top K non-EOS) -------------------------
        live_cand_scores = torch.where(is_eos, NEG_INF, top2k_scores)
        live_scores, live_idx = top_k(live_cand_scores, k)
        live_seqs = _take(seqs2k, live_idx)
        live_beam = torch.gather(cand_beam, 1, live_idx)  # [B, K]

        cache = _gather_beams(cache, live_beam, b, k)
        step += 1

    # HF finalize (BeamSearchScorer.finalize): live beams compete with the
    # finished pool, normalised at their generated length
    final_live_scores = live_scores / (max(float(step), 1.0) ** lp)
    all_seqs = torch.cat([finished_seqs, live_seqs], dim=1)
    all_scores = torch.cat([finished_scores, final_live_scores], dim=1)
    scores, order = top_k(all_scores, k)
    return _take(all_seqs, order), scores
