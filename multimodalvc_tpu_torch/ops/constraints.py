"""Lexically-constrained decoding state machines as batched tensors.

Port of ``multimodalvc_tpu/ops/constraints.py`` (fairseq's
token_generation_constraints.py semantics).  The packing and the trie /
sequence flattening run on the host in numpy, as in the JAX package, and are
kept here as their own copy; the per-beam state and its ``advance``,
``bank``, ``finished`` and ``next_tokens`` are tensor functions.  Where the
JAX package ``vmap``s a one-row function, these take the batch dimensions
explicitly: the constraint arrays have a leading [B] and the states a
leading [B, C] (C beams or candidates of that batch row).

 * ``pack_constraints``: fairseq's packed [B, maxlen] format.
 * unordered: a flattened trie (``TrieArrays``) with per-beam generated /
   completed counters (``UnorderedState``), including edge saturation.
 * ordered: the flattened constraint sequence (``SequenceArrays``) with the
   index of the last fulfilled token as the state.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Packing (host-side, numpy): fairseq's exact tensor format
# ---------------------------------------------------------------------------


def pack_constraints(batch_constraints: Sequence[Sequence[Sequence[int]]]) -> np.ndarray:
    """Pack per-sentence constraint lists into fairseq's [B, maxlen] layout:
    row = [num_constraints, c0..., 0, c1..., 0, ...] zero-padded."""
    max_len = 1
    for sent in batch_constraints:
        if len(sent):
            max_len = max(max_len, 1 + sum(len(c) for c in sent) + len(sent))
    out = np.zeros((len(batch_constraints), max_len), np.int64)
    for i, sent in enumerate(batch_constraints):
        out[i, 0] = len(sent)
        off = 1
        for c in sent:
            out[i, off : off + len(c)] = np.asarray(c, np.int64)
            off += len(c) + 1
    return out


def unpack_constraints(row: np.ndarray) -> List[List[int]]:
    """Inverse of ``pack_constraints`` for one row."""
    row = [int(x) for x in row]
    n, off, out = row[0], 1, []
    for _ in range(n):
        end = row.index(0, off)
        out.append(row[off:end])
        off = end + 1
    return out


# ---------------------------------------------------------------------------
# Unordered constraints: flattened trie + counter state
# ---------------------------------------------------------------------------


class TrieArrays(NamedTuple):
    """One flattened constraint trie per batch row, padded to a common node
    count.  Node 0 is the root (token -1).  Each non-root node has exactly
    one parent edge, so the (parent, token) pairs are the edge table."""

    token: torch.Tensor  # [B, N] int32, the node's incoming-edge token (-1 at root/pad)
    parent: torch.Tensor  # [B, N] int32 (0 at root/pad)
    terminal: torch.Tensor  # [B, N] int32, constraints ending exactly here
    num_constraints: torch.Tensor  # [B, N] int32, constraints through this node
    node_valid: torch.Tensor  # [B, N] bool (False for padding and root)
    num_constraint_tokens: torch.Tensor  # [B] int32
    max_depth: int  # bound for the rewind walk

    def to(self, device) -> "TrieArrays":
        return TrieArrays(*(x.to(device) for x in self[:-1]), max_depth=self.max_depth)


class UnorderedState(NamedTuple):
    """Per-beam trie progress: node [B, C], generated / completed [B, C, N]."""

    node: torch.Tensor
    generated: torch.Tensor
    completed: torch.Tensor


def build_unordered(packed: np.ndarray) -> TrieArrays:
    """Flatten each row's constraint trie (host-side)."""
    b = packed.shape[0]
    rows = [unpack_constraints(packed[i]) for i in range(b)]
    tries = []
    max_nodes, max_depth = 1, 1
    for sent in rows:
        nodes = [dict(token=-1, parent=0, terminal=0, num=0, children={})]  # node 0 = root
        for seq in sent:
            cur = 0
            for tok in seq:
                kids = nodes[cur]["children"]
                if tok not in kids:
                    nodes.append(dict(token=tok, parent=cur, terminal=0, num=0, children={}))
                    kids[tok] = len(nodes) - 1
                cur = kids[tok]
            nodes[cur]["terminal"] += 1
            while True:  # bump num_constraints up the path, root included
                nodes[cur]["num"] += 1
                if cur == 0:
                    break
                cur = nodes[cur]["parent"]
            max_depth = max(max_depth, len(seq))
        tries.append(nodes)
        max_nodes = max(max_nodes, len(nodes))

    def arr(key, fill):
        out = np.full((b, max_nodes), fill, np.int32)
        for i, nodes in enumerate(tries):
            out[i, : len(nodes)] = [n[key] for n in nodes]
        return torch.from_numpy(out)

    valid = np.zeros((b, max_nodes), bool)
    for i, nodes in enumerate(tries):
        valid[i, 1 : len(nodes)] = True
    n_tokens = np.asarray([sum(n["num"] for n in nodes[1:]) for nodes in tries], np.int32)
    return TrieArrays(
        token=arr("token", -1),
        parent=arr("parent", 0),
        terminal=arr("terminal", 0),
        num_constraints=arr("num", 0),
        node_valid=torch.from_numpy(valid),
        num_constraint_tokens=torch.from_numpy(n_tokens),
        max_depth=max_depth,
    )


def unordered_init(trie: TrieArrays, beams: int) -> UnorderedState:
    b, n = trie.token.shape
    dev = trie.token.device
    return UnorderedState(
        node=torch.zeros(b, beams, dtype=torch.long, device=dev),
        generated=torch.zeros(b, beams, n, dtype=torch.int32, device=dev),
        completed=torch.zeros(b, beams, n, dtype=torch.int32, device=dev),
    )


def _per_node(leaf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A trie leaf [B, N] broadcast to the states' [B, C, N]."""
    return leaf[:, None, :].expand(like.shape[0], like.shape[1], leaf.shape[1])


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, C, N] at node idx [B, C] -> [B, C]."""
    return x.gather(-1, idx[..., None].long())[..., 0]


def _child(trie: TrieArrays, node, tok) -> Tuple[torch.Tensor, torch.Tensor]:
    """(child index, found) of the edge node --tok-->; node, tok [B, C]."""
    parent = trie.parent[:, None, :]
    match = (trie.node_valid[:, None, :] & (parent == node[..., None])
             & (trie.token[:, None, :] == tok[..., None]))
    return match.to(torch.int32).argmax(dim=-1), match.any(dim=-1)


def _rewind(trie: TrieArrays, node, generated, completed):
    """Walk old-state node -> root: the first unsaturated terminal ancestor
    gets completed += 1 (and the walk stops); every node passed before that
    gets generated -= 1.  The JAX fori_loop of max_depth + 1 steps."""
    terminal = _per_node(trie.terminal, generated)
    parent = _per_node(trie.parent, generated)
    cur, gen, comp = node.long(), generated, completed
    done = torch.zeros_like(cur, dtype=torch.bool)
    for _ in range(trie.max_depth + 1):
        active = ~(done | (cur == 0))
        term = _at(terminal, cur)
        is_term = (term > 0) & (_at(comp, cur) < term)
        comp = comp.scatter_add(-1, cur[..., None], (active & is_term).to(comp.dtype)[..., None])
        gen = gen.scatter_add(-1, cur[..., None], -(active & ~is_term).to(gen.dtype)[..., None])
        done = done | (active & is_term)
        cur = torch.where(active & ~is_term, _at(parent, cur).long(), cur)
    return gen, comp


def unordered_advance(trie: TrieArrays, node, generated, completed, tok):
    """Advance every (batch, candidate) state by its token: node, tok [B, C];
    generated, completed [B, C, N] (UnorderedConstraintState.advance)."""
    num = _per_node(trie.num_constraints, generated)
    child, c_found = _child(trie, node, tok)
    can_child = c_found & (_at(generated, child) < _at(num, child))
    rchild, r_found = _child(trie, torch.zeros_like(node), tok)
    root_unsat = _at(generated, rchild) < _at(num, rchild)

    # 1: a matching unsaturated child, no rewind; 2: the token restarts from
    # the root; 3: fall off entirely, back to the root
    take_child = can_child
    take_rchild = ~can_child & r_found & root_unsat
    new_node = torch.where(take_child, child, torch.where(take_rchild, rchild, 0)).long()
    gen = generated.scatter_add(
        -1, new_node[..., None], (take_child | take_rchild).to(generated.dtype)[..., None])
    r_gen, r_comp = _rewind(trie, node, gen, completed)
    gen = torch.where(take_child[..., None], gen, r_gen)
    comp = torch.where(take_child[..., None], completed, r_comp)
    return new_node, gen, comp


def unordered_bank(generated) -> torch.Tensor:
    return generated.sum(dim=-1)


def unordered_num_completed(trie: TrieArrays, node, completed) -> torch.Tensor:
    term = _at(_per_node(trie.terminal, completed), node)
    in_final = (term > 0) & (_at(completed, node) < term)
    return completed.sum(dim=-1) + in_final.to(completed.dtype)


def unordered_finished(trie: TrieArrays, node, completed) -> torch.Tensor:
    total = trie.num_constraints[:, :1]  # [B, 1]: the root's count
    return total - unordered_num_completed(trie, node, completed) == 0


def unordered_next_tokens(trie: TrieArrays, node):
    """Candidate tokens = children of the root plus (off-root) children of
    the current node: ([B, C, N] tokens, [B, C, N] valid), aligned with the
    node table."""
    parent = trie.parent[:, None, :]
    is_cand = trie.node_valid[:, None, :] & ((parent == 0) | (parent == node[..., None]))
    return _per_node(trie.token, is_cand), is_cand


# ---------------------------------------------------------------------------
# Ordered constraints: flattened sequence + index state
# ---------------------------------------------------------------------------


class SequenceArrays(NamedTuple):
    """The constraints of each batch row concatenated, with endpoint flags at
    each constraint's last token."""

    seq: torch.Tensor  # [B, M] int32 (-1 padding)
    endpoints: torch.Tensor  # [B, M] bool
    length: torch.Tensor  # [B] int32
    num_constraint_tokens: torch.Tensor  # [B] int32 (== length)
    max_depth: int  # unused; symmetry with TrieArrays

    def to(self, device) -> "SequenceArrays":
        return SequenceArrays(*(x.to(device) for x in self[:-1]), max_depth=self.max_depth)


def build_ordered(packed: np.ndarray) -> SequenceArrays:
    b = packed.shape[0]
    rows = [unpack_constraints(packed[i]) for i in range(b)]
    m = max(1, max((sum(len(c) for c in sent) for sent in rows), default=1))
    seq = np.full((b, m), -1, np.int32)
    ends = np.zeros((b, m), bool)
    lens = np.zeros((b,), np.int32)
    for i, sent in enumerate(rows):
        off = 0
        for c in sent:
            seq[i, off : off + len(c)] = c
            ends[i, off + len(c) - 1] = True
            off += len(c)
        lens[i] = off
    return SequenceArrays(
        seq=torch.from_numpy(seq),
        endpoints=torch.from_numpy(ends),
        length=torch.from_numpy(lens),
        num_constraint_tokens=torch.from_numpy(lens.copy()),
        max_depth=1,
    )


def ordered_init(seqs: SequenceArrays, beams: int) -> torch.Tensor:
    """The state is the index of the last fulfilled token (-1 = root)."""
    return torch.full((seqs.seq.shape[0], beams), -1, dtype=torch.long, device=seqs.seq.device)


def _seq_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M] at idx [B, C], clipped into range."""
    return x.gather(1, idx.clamp(0, x.shape[1] - 1).long())


def ordered_advance(seqs: SequenceArrays, state, tok):
    """OrderedConstraintState.advance's 5-way branch; state, tok [B, C]."""
    finished = state + 1 >= seqs.length[:, None]
    nxt = _seq_at(seqs.seq, state + 1)
    at_end = _seq_at(seqs.endpoints, state) & (state >= 0)
    first = seqs.seq[:, :1]
    restart = torch.where(tok == first, 0, -1)
    out = torch.where(nxt == tok, state + 1, torch.where(at_end, state, restart))
    return torch.where(finished, state, out).long()


def ordered_bank(state) -> torch.Tensor:
    return state + 1


def ordered_num_completed(seqs: SequenceArrays, state) -> torch.Tensor:
    idx = torch.arange(seqs.endpoints.shape[1], device=state.device)
    return (seqs.endpoints[:, None, :] & (idx <= state[..., None])).sum(dim=-1)


def ordered_finished(seqs: SequenceArrays, state) -> torch.Tensor:
    return state + 1 >= seqs.length[:, None]


def ordered_next_tokens(seqs: SequenceArrays, state):
    """{seq[0] if state > 0} plus {seq[state + 1] if unfinished}:
    ([B, C, 2] tokens, [B, C, 2] valid)."""
    first = seqs.seq[:, :1].expand_as(state)
    toks = torch.stack([first, _seq_at(seqs.seq, state + 1)], dim=-1)
    valid = torch.stack([state > 0, ~ordered_finished(seqs, state)], dim=-1)
    return toks, valid
