"""Batched beam search with HF-exact finalisation, and the other decode modes.

Port of ``multimodalvc_tpu/ops/beam_search.py``: ``beam_search`` (with
n-gram blocking), ``greedy_search``, ``sample_search``,
``diverse_beam_search`` and ``constrained_beam_search``.  Each JAX
``lax.while_loop`` becomes a Python loop whose exit test reads one boolean
from the device per step.  The dispatch of the candidate top-2K follows the
JAX package, with a CUDA tensor as "on the accelerator": without n-gram
blocking the fused kernel on the raw logits (K4 ``beam_topk_columns`` when
V % 8 == 0, else K5 ``beam_topk_from_logits``), which also takes each row's
max and logsumexp (the JAX step computes them outside its kernel, where XLA
fuses them; eager PyTorch would not); with it ``log_softmax``, the
n-gram mask and K5 ``beam_topk``; on the CPU ``log_softmax`` and a flat
top-k.  Every top-k keeps ``lax.top_k``'s tie order (lowest index first),
every argsort is stable as ``jnp.argsort``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch

from . import constraints as C
from . import beam_gather
from .topk import beam_topk, beam_topk_columns, beam_topk_from_logits, top_k

NEG_INF = -1.0e7
_top_k = top_k  # for _filter_logits, whose top_k argument (the JAX name) shadows it
_K6_MIN_SIZE = 1 << 18  # elements: the JAX gate for the row-gather kernel


def _on_accelerator(x: torch.Tensor) -> bool:
    """The JAX package's "on the accelerator" (a TPU backend): a CUDA tensor."""
    return x.is_cuda


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
    2**18 elements, a last dim that is a multiple of 128; all of them in one
    launch (``gather_rows_many``), from one flat source index.  The rest
    take ``take_along_axis`` semantics.  The JAX package's one-hot einsum
    branch for k >= 8 is an XLA lowering workaround that selects exactly the
    same rows; it has no counterpart here."""

    def moves(x) -> bool:
        return torch.is_tensor(x) and x.ndim > 0 and x.shape[0] == b * k

    def k6(x) -> bool:
        return (_on_accelerator(x) and x.ndim >= 3 and x.numel() >= _K6_MIN_SIZE
                and x.shape[-1] % 128 == 0)

    def walk(node, leaf):
        if isinstance(node, dict):
            return {key: val if str(key).startswith("fixed_") else walk(val, leaf)
                    for key, val in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, leaf) for v in node)
        return leaf(node) if moves(node) else node

    eligible = []
    walk(tree, lambda x: eligible.append(x) if k6(x) else None)
    reordered = iter(beam_gather.gather_rows_many(eligible, beam_gather.beam_src(indices, b, k))
                     if eligible else ())

    def gather(x):
        if k6(x):
            return next(reordered)
        xb = x.reshape((b, k) + x.shape[1:])
        idx = indices.reshape((b, k) + (1,) * (xb.ndim - 2)).expand_as(xb)
        return torch.gather(xb, 1, idx).reshape(x.shape)

    return walk(tree, gather)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1 with idx [B, n] over [B, K, ...] leaves."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand((-1, -1) + x.shape[2:])
    return torch.gather(x, 1, idx)


def apply_ngram_block(
    logp: torch.Tensor,  # [B, K, V]
    seqs: torch.Tensor,  # [B, K, L] generated tokens so far
    step: int,  # tokens generated
    ngram: int,
) -> torch.Tensor:
    """Mask (to NEG_INF) every token that would complete an n-gram already
    generated by its beam.  The JAX package drops the "no ban" entries with
    an out-of-range index (``mode="drop"``); here they become a column V of
    a [B*K, V+1] ban mask that is cut off."""
    b, k, vocab = logp.shape
    l = seqs.shape[2]
    n1 = ngram - 1
    if l < ngram:
        return logp
    dev = seqs.device
    suf_idx = (step - n1 + torch.arange(n1, device=dev)).clamp(0, l - 1)
    suffix = seqs[:, :, suf_idx]  # [B, K, n-1]
    windows = seqs.unfold(2, n1, 1)[:, :, : l - n1] if n1 else seqs.new_zeros(b, k, l, 0)
    follows = seqs[:, :, n1:]  # [B, K, S]
    match = (windows == suffix[:, :, None, :]).all(dim=-1)
    # only windows wholly inside the generated region (window end < step)
    s_pos = torch.arange(l - n1, device=dev)
    match = match & (s_pos + n1 <= step - 1) & (step >= n1)
    banned = torch.where(match, follows, vocab).reshape(b * k, -1)
    ban = torch.zeros(b * k, vocab + 1, dtype=torch.bool, device=dev)
    ban.scatter_(1, banned.long(), True)
    return logp.reshape(b * k, vocab).masked_fill(ban[:, :vocab], NEG_INF).reshape(b, k, vocab)


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
        if _on_accelerator(lf) and not no_repeat_ngram_size:
            # the kernel takes each row's max and logsumexp itself
            fused = beam_topk_columns if vocab % 8 == 0 else beam_topk_from_logits
            top2k_scores, top2k_idx = fused(lf, None, None, live_scores, 2 * k)
        else:
            logp = log_softmax(lf).reshape(b, k, vocab)
            if no_repeat_ngram_size > 0:
                logp = apply_ngram_block(logp, live_seqs, step, no_repeat_ngram_size)
            if _on_accelerator(lf):
                top2k_scores, top2k_idx = beam_topk(logp, live_scores, 2 * k)
            else:
                cand = live_scores[:, :, None] + logp
                top2k_scores, top2k_idx = top_k(cand.reshape(b, k * vocab), 2 * k)
        top2k_idx = top2k_idx.long()
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


def greedy_search(
    decode_fn,
    init_cache,
    prompt_lengths: torch.Tensor,
    first_logits: torch.Tensor,
    eos_token_id: int,
    pad_token_id: int,
    max_new_tokens: int,
) -> torch.Tensor:
    """Greedy decode (the beam-1 fast path): sequences [B, max_new_tokens]."""
    return _sample_loop(decode_fn, init_cache, prompt_lengths, first_logits, eos_token_id,
                        pad_token_id, max_new_tokens, lambda logits: logits.argmax(dim=-1))


def _filter_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Temperature, top-k and nucleus filtering, the filtered entries at
    NEG_INF (fairseq's Sampling with sampling_topk / sampling_topp)."""
    if temperature != 1.0:
        # a tensor divisor: a scalar one may become a product with its reciprocal
        logits = logits / torch.tensor(max(temperature, 1e-6), dtype=torch.float32,
                                       device=logits.device)
    if top_k and top_k > 0:
        kth = _top_k(logits, top_k)[0][..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, dims=(-1,))
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (at least one)
        cutoff_mask = cum - probs < top_p
        threshold = torch.where(cutoff_mask, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, NEG_INF, logits)
    return logits



def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row, by the Gumbel-max trick as ``jax.random.categorical``
    (the random bits differ from JAX's)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def sample_search(
    decode_fn,
    init_cache,
    prompt_lengths: torch.Tensor,
    first_logits: torch.Tensor,
    eos_token_id: int,
    pad_token_id: int,
    max_new_tokens: int,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Ancestral sampling decode: sequences [B, max_new_tokens].  The random
    draws come from ``generator`` (on the logits' device)."""

    def pick(logits):
        return _categorical(_filter_logits(logits.float(), temperature, top_k, top_p), generator)

    return _sample_loop(decode_fn, init_cache, prompt_lengths, first_logits, eos_token_id,
                        pad_token_id, max_new_tokens, pick)


def _sample_loop(decode_fn, cache, prompt_lengths, first_logits, eos_token_id, pad_token_id,
                 max_new_tokens, pick) -> torch.Tensor:
    """The one-sequence-per-row loop of greedy and sampled decoding; ``pick``
    maps logits [B, V] to tokens [B]."""
    b = first_logits.shape[0]
    seqs = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long,
                      device=first_logits.device)
    seqs[:, 0] = pick(first_logits)
    done = seqs[:, 0] == eos_token_id
    step = 1
    while step < max_new_tokens and not bool(done.all()):
        positions = (prompt_lengths + step - 1)[:, None]
        logits, cache = decode_fn(seqs[:, step - 1 : step], positions, cache)
        nxt = torch.where(done, pad_token_id, pick(logits))
        seqs[:, step] = nxt
        done = done | (nxt == eos_token_id)
        step += 1
    return seqs


def _constrained_step(
    logp: torch.Tensor,  # [B, K, V] this step's log-probs (EOS banned where unfinished)
    scores: torch.Tensor,  # [B, K] cumulative scores
    cons,  # TrieArrays | SequenceArrays, leaves [B, ...]
    state,  # UnorderedState (leaves [B, K, ...]) | ordered state [B, K]
    *,
    k: int,
    is_step0: bool,
    mode: str,
):
    """One step of fairseq's LexicallyConstrainedBeamSearch for every batch
    row at once (the JAX package's ``_constrained_step_row`` under ``vmap``).

    Candidates = top-2K over the flat cumulative scores, plus (after step 0)
    the top-1 of every beam, plus every beam's constraint next-tokens; each
    is advanced through the constraint automaton, sorted by fairseq's
    (bank, score) key, deduped on (beam, token), striped round-robin across
    banks and cut to 2K.  Returns (scores, tokens, beams, state), each [B, 2K, ...]."""
    b, _, kv = logp.shape
    dev = logp.device
    beam_ids = torch.arange(k, device=dev)
    if is_step0:
        # fairseq uses only the first beam at step 0
        cum = torch.where(beam_ids[None, :, None] == 0, logp, NEG_INF)
    else:
        cum = scores[:, :, None] + logp

    s_top, i_top = top_k(cum.reshape(b, -1), 2 * k)
    cand_s, cand_t, cand_b = [s_top], [i_top % kv], [i_top // kv]
    cand_ok = [torch.ones(b, 2 * k, dtype=torch.bool, device=dev)]
    if not is_step0:  # the top-1 of each hypothesis
        cand_s.append(cum.amax(dim=-1))
        cand_t.append(cum.argmax(dim=-1))
        cand_b.append(beam_ids.expand(b, k))
        cand_ok.append(torch.ones(b, k, dtype=torch.bool, device=dev))

    # every beam's constraint next-tokens; at step 0 only beam 0's
    if mode == "unordered":
        ctoks, cok = C.unordered_next_tokens(cons, state.node)
    else:
        ctoks, cok = C.ordered_next_tokens(cons, state)  # [B, K, Cn]
    cn = ctoks.shape[-1]
    if is_step0:
        cok = cok & (beam_ids[None, :, None] == 0)
    safe_t = ctoks.long().clamp(0, kv - 1)
    cand_s.append(cum.gather(-1, safe_t).reshape(b, -1))
    cand_t.append(safe_t.reshape(b, -1))
    cand_b.append(beam_ids.repeat_interleave(cn).expand(b, k * cn))
    cand_ok.append(cok.reshape(b, -1))

    s_all, t_all, b_all = torch.cat(cand_s, 1), torch.cat(cand_t, 1), torch.cat(cand_b, 1)
    ok_all = torch.cat(cand_ok, 1)
    c = s_all.shape[1]
    pos = torch.arange(c, device=dev).expand(b, c)

    # advance every candidate through the automaton -> banks
    if mode == "unordered":
        new_state = C.UnorderedState(*C.unordered_advance(
            cons, *_take_state(state, b_all, mode), t_all))
        banks = C.unordered_bank(new_state.generated).long()
    else:
        new_state = C.ordered_advance(cons, _take_state(state, b_all, mode), t_all)
        banks = C.ordered_bank(new_state)

    # sort by fairseq's key: (num_constraint_tokens - bank) * MAX_SCORE + score
    t_total = cons.num_constraint_tokens[:, None]
    key = (t_total.float() - banks.float()) * (-100.0) + s_all
    key = torch.where(ok_all, key, -3.0e38)
    order = torch.argsort(-key, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, pos)

    # dedup (beam, token), keeping the first in sort order
    ids = b_all * (kv + 1) + t_all
    same = (ids[:, None, :] == ids[:, :, None]) & ok_all[:, None, :]
    earlier = rank[:, None, :] < rank[:, :, None]
    ok_all = ok_all & ~(same & earlier).any(dim=-1)

    # stripe round-robin across banks: the count restarts at every
    # contiguous run of one bank in the (deduped, key-sorted) list
    compact = torch.argsort(torch.where(ok_all, rank, 1 << 30), dim=1, stable=True)
    bank_seq = banks.gather(1, compact)
    run_start = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=dev),
                           bank_seq[:, 1:] != bank_seq[:, :-1]], dim=1)
    start_idx = torch.cummax(torch.where(run_start, pos, 0), dim=1).values
    cnt = torch.empty_like(compact).scatter_(1, compact, pos - start_idx)
    l_valid = ok_all.sum(dim=1, keepdim=True)
    stripes = t_total.long() - banks + cnt * (l_valid + 1)
    stripes = torch.where(ok_all, stripes, 1 << 30)
    # lexicographic (stripes, rank): rank order first, then a stable sort on stripes
    by_stripe = torch.argsort(stripes.gather(1, order), dim=1, stable=True)
    sel = order.gather(1, by_stripe)[:, : 2 * k]

    return (s_all.gather(1, sel), t_all.gather(1, sel), b_all.gather(1, sel),
            _take_state(new_state, sel, mode))


def _take_state(state, idx: torch.Tensor, mode: str):
    """The constraint state's rows at idx [B, n] along dim 1."""
    if mode == "unordered":
        per_node = idx[..., None].expand(-1, -1, state.generated.shape[-1])
        return C.UnorderedState(state.node.gather(1, idx), state.generated.gather(1, per_node),
                                state.completed.gather(1, per_node))
    return state.gather(1, idx)


def constrained_beam_search(
    decode_fn,
    init_cache,
    prompt_lengths: torch.Tensor,
    first_logits: torch.Tensor,
    eos_token_id: int,
    pad_token_id: int,
    max_new_tokens: int,
    constraint_set,  # TrieArrays | SequenceArrays, leaves [B, ...]
    num_beams: int = 5,
    length_penalty: float = 1.0,
    mode: str = "unordered",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexically constrained beam search (fairseq's
    LexicallyConstrainedBeamSearch): hypotheses are striped across constraint
    banks every step, and EOS is banned until a hypothesis has met all its
    constraints.  Finalisation is the HF-style merge of ``beam_search``, with
    only satisfied live hypotheses competing; a row where nothing satisfied
    its constraints falls back to its live beams.  Rows with no constraint
    are plain beam search.  Returns (sequences [B, K, L], scores [B, K])."""
    b, vocab = first_logits.shape
    k, l = num_beams, max_new_tokens
    dev = first_logits.device
    lp = length_penalty
    if 2 * k > vocab:
        raise ValueError("constrained search needs 2*beam <= vocab")
    cons = constraint_set.to(dev)
    if mode == "unordered":
        state0 = C.unordered_init(cons, k)

        def is_finished(state):  # [B, K] bool
            return C.unordered_finished(cons, state.node, state.completed)
    else:
        state0 = C.ordered_init(cons, k)

        def is_finished(state):
            return C.ordered_finished(cons, state)

    def select_live(is_eos):
        """The first K non-EOS candidates in stripe order (the generator picks
        actives by candidate order, not by score)."""
        return torch.argsort(is_eos.to(torch.int32), dim=1, stable=True)[:, :k]

    # step 0: expand from the prompt logits (beam 0 only); EOS is banned
    # there as fairseq's min_len >= 1 does
    logp0 = log_softmax(first_logits.float())
    logp0[:, eos_token_id] = NEG_INF
    s2k, t2k, b2k, st2k = _constrained_step(
        logp0[:, None].expand(b, k, vocab), torch.zeros(b, k, device=dev), cons, state0,
        k=k, is_step0=True, mode=mode)
    is_eos0 = t2k == eos_token_id
    live_idx = select_live(is_eos0)
    live_scores = s2k.gather(1, live_idx)
    live_state = _take_state(st2k, live_idx, mode)
    live_seqs = torch.full((b, k, l), pad_token_id, dtype=torch.long, device=dev)
    live_seqs[:, :, 0] = t2k.gather(1, live_idx)

    # EOS candidates inside the first-K window finalise
    win = torch.arange(2 * k, device=dev)[None, :] < k
    fin_seqs0 = torch.full((b, 2 * k, l), pad_token_id, dtype=torch.long, device=dev)
    fin_seqs0[:, :, 0] = t2k
    fin_scores0 = torch.where(is_eos0 & win, s2k / (1.0**lp), NEG_INF)
    _, fin_idx = top_k(fin_scores0, k)
    fin_seqs = _take(fin_seqs0, fin_idx)
    fin_scores = fin_scores0.gather(1, fin_idx)
    fin_flags = fin_scores > NEG_INF / 2
    cache = init_cache
    step = 1

    while step < l and not bool(fin_flags.all()):
        flat_tokens = live_seqs[:, :, step - 1].reshape(b * k, 1)
        positions = (prompt_lengths[:, None] + step - 1).repeat_interleave(k, dim=0)
        logits, cache = decode_fn(flat_tokens, positions.reshape(-1, 1), cache)
        logp = log_softmax(logits.float()).reshape(b, k, vocab)
        # ban EOS while the constraints are unmet
        unfin = ~is_finished(live_state)
        logp[:, :, eos_token_id] = torch.where(unfin, NEG_INF, logp[:, :, eos_token_id])

        s2k, t2k, b2k, st2k = _constrained_step(logp, live_scores, cons, live_state,
                                                k=k, is_step0=False, mode=mode)
        seqs2k = _take(live_seqs, b2k)
        seqs2k[:, :, step] = t2k
        is_eos = t2k == eos_token_id

        gen_len = float(step + 1)
        f_cand = torch.where(is_eos & win, s2k / (gen_len**lp), NEG_INF)
        all_f_seqs = torch.cat([fin_seqs, seqs2k], dim=1)
        all_f_scores = torch.cat([fin_scores, f_cand], dim=1)
        all_f_flags = torch.cat([fin_flags, f_cand > NEG_INF / 2], dim=1)
        fin_scores, f_idx = top_k(all_f_scores, k)
        fin_seqs = _take(all_f_seqs, f_idx)
        fin_flags = all_f_flags.gather(1, f_idx)

        live_idx = select_live(is_eos)
        live_scores = s2k.gather(1, live_idx)
        live_seqs = _take(seqs2k, live_idx)
        live_state = _take_state(st2k, live_idx, mode)
        cache = _gather_beams(cache, b2k.gather(1, live_idx), b, k)
        step += 1

    # finalise: live hypotheses compete with the finished pool only where
    # their constraints are met (fairseq's max-len endgame)
    norm_live = live_scores / (max(float(step), 1.0) ** lp)
    final_live = torch.where(is_finished(live_state), norm_live, NEG_INF)
    all_seqs = torch.cat([fin_seqs, live_seqs], dim=1)
    all_scores = torch.cat([fin_scores, final_live], dim=1)
    scores, order = top_k(all_scores, k)
    best = _take(all_seqs, order)
    # rows where nothing met its constraints emit the best live beams
    nothing = ~(all_scores > NEG_INF / 2).any(dim=1)
    live_rank_scores, live_order = top_k(norm_live, k)
    best = torch.where(nothing[:, None, None], _take(live_seqs, live_order), best)
    scores = torch.where(nothing[:, None], live_rank_scores, scores)
    return best, scores


def diverse_beam_search(
    decode_fn,
    init_cache,
    prompt_lengths: torch.Tensor,
    first_logits: torch.Tensor,
    eos_token_id: int,
    pad_token_id: int,
    max_new_tokens: int,
    num_beams: int = 6,
    num_groups: int = 2,
    diversity_strength: float = 0.5,
    length_penalty: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diverse beam search (Vijayakumar et al. 2016; fairseq's
    DiverseBeamSearch).  The beams split into ``num_groups`` groups; group
    g's candidates are penalised by ``diversity_strength`` times the number
    of times each token was picked by groups < g at this step.  Returns
    (sequences [B, K, L], scores [B, K])."""
    if num_beams % num_groups:
        raise ValueError("num_beams must be divisible by num_groups")
    kg = num_beams // num_groups
    b, vocab = first_logits.shape
    l, lp = max_new_tokens, length_penalty
    dev = first_logits.device

    def counts(tokens):  # [B, n] -> per-token pick counts [B, V]
        return torch.zeros(b, vocab, device=dev).scatter_add_(
            1, tokens, torch.ones(tokens.shape, device=dev))

    logp0 = log_softmax(first_logits.float())
    toks, scs, div = [], [], torch.zeros(b, vocab, device=dev)
    for _ in range(num_groups):
        _, t = top_k(logp0 - diversity_strength * div, kg)
        toks.append(t)
        scs.append(logp0.gather(1, t))  # the true log-prob, not the penalised one
        div = div + counts(t)
    top_tokens = torch.cat(toks, dim=1)
    live_scores = torch.cat(scs, dim=1)
    live_seqs = torch.full((b, num_beams, l), pad_token_id, dtype=torch.long, device=dev)
    live_seqs[:, :, 0] = top_tokens
    eos0 = top_tokens == eos_token_id
    fin_seqs, fin_flags = live_seqs.clone(), eos0
    fin_scores = torch.where(eos0, live_scores, NEG_INF)
    live_scores = torch.where(eos0, NEG_INF, live_scores)
    cache = init_cache
    step = 1

    while step < l and not bool(fin_flags.all()):
        flat_tokens = live_seqs[:, :, step - 1].reshape(b * num_beams, 1)
        positions = (prompt_lengths[:, None] + step - 1).repeat_interleave(num_beams, dim=0)
        logits, cache = decode_fn(flat_tokens, positions.reshape(-1, 1), cache)
        logp = log_softmax(logits.float()).reshape(b, num_beams, vocab)

        div = torch.zeros(b, vocab, device=dev)
        # every group reads the live set as it stood before this step
        new_seqs, new_scores = live_seqs.clone(), live_scores.clone()
        beam_sel = torch.zeros(b, num_beams, dtype=torch.long, device=dev)
        for g in range(num_groups):
            sl = slice(g * kg, (g + 1) * kg)
            true_cand = live_scores[:, sl, None] + logp[:, sl]
            cand = true_cand - diversity_strength * div[:, None, :]
            _, idx = top_k(cand.reshape(b, kg * vocab), 2 * kg)
            cand_beam, cand_token = idx // vocab, idx % vocab
            cand_scores = true_cand.reshape(b, kg * vocab).gather(1, idx)
            g_seqs = _take(live_seqs[:, sl], cand_beam)
            g_seqs[:, :, step] = cand_token
            is_eos = cand_token == eos_token_id

            f_cand = torch.where(is_eos, cand_scores / (float(step + 1) ** lp), NEG_INF)
            all_f_seqs = torch.cat([fin_seqs[:, sl], g_seqs], dim=1)
            all_f_scores = torch.cat([fin_scores[:, sl], f_cand], dim=1)
            all_f_flags = torch.cat([fin_flags[:, sl], is_eos], dim=1)
            tf_scores, tf_idx = top_k(all_f_scores, kg)
            fin_seqs[:, sl] = _take(all_f_seqs, tf_idx)
            fin_scores[:, sl] = tf_scores
            fin_flags[:, sl] = all_f_flags.gather(1, tf_idx)

            nl_scores, live_idx = top_k(torch.where(is_eos, NEG_INF, cand_scores), kg)
            new_seqs[:, sl] = _take(g_seqs, live_idx)
            new_scores[:, sl] = nl_scores
            beam_sel[:, sl] = cand_beam.gather(1, live_idx) + g * kg
            # count every token this group just committed to its live set
            div = div + counts(cand_token.gather(1, live_idx))
        live_seqs, live_scores = new_seqs, new_scores
        cache = _gather_beams(cache, beam_sel, b, num_beams)
        step += 1

    final_live = live_scores / (max(float(step), 1.0) ** lp)
    all_seqs = torch.cat([fin_seqs, live_seqs], dim=1)
    all_scores = torch.cat([fin_scores, final_live], dim=1)
    scores, order = top_k(all_scores, num_beams)
    return _take(all_seqs, order), scores
