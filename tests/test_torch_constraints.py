"""Constraint state machines: the port's ops/constraints.py against the JAX
package's, on the same packed constraints and the same random token streams.
The built arrays must be identical; advance, bank, num_completed, finished
and next_tokens must agree at every step, for every batch row and beam at
once (the JAX functions take one row, under vmap)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from multimodalvc_tpu.ops import constraints as JC
from multimodalvc_tpu_torch.ops import constraints as TC

CONSTRAINTS = [
    [[5, 6, 7], [5], [9, 10]],
    [],
    [[4, 5], [5, 6]],  # a shared token 5: trie sharing and edge saturation
    [[7, 7, 7], [8]],  # a repeated token: the rewind walks several levels
]
BEAMS = 3


def _streams(rng, steps=60):
    """Token streams [B, K, steps] over a small alphabet that hits the
    constraint tokens often, plus the constraint phrases themselves."""
    toks = rng.integers(3, 12, (len(CONSTRAINTS), BEAMS, steps))
    toks[:, 0, :16] = [5, 6, 7, 5, 9, 10, 5, 4, 5, 5, 6, 7, 7, 7, 8, 4]
    return toks


def test_pack_and_unpack_match_jax():
    packed = TC.pack_constraints(CONSTRAINTS)
    np.testing.assert_array_equal(packed, JC.pack_constraints(CONSTRAINTS))
    for i, sent in enumerate(CONSTRAINTS):
        assert TC.unpack_constraints(packed[i]) == JC.unpack_constraints(packed[i])


@pytest.mark.parametrize("mode", ["unordered", "ordered"])
def test_built_arrays_match_jax(mode):
    packed = JC.pack_constraints(CONSTRAINTS)
    build = {"unordered": (JC.build_unordered, TC.build_unordered),
             "ordered": (JC.build_ordered, TC.build_ordered)}[mode]
    want, got = build[0](packed), build[1](packed)
    assert type(got)._fields == type(want)._fields
    for name, w, g in zip(want._fields, want, got):
        if name == "max_depth":
            assert g == w
        else:
            np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
            assert g.dtype == torch.from_numpy(np.array(w)).dtype, name


def _row(tree, i):
    return jax.tree.map(lambda x: x[i] if hasattr(x, "ndim") and x.ndim else x, tree)


def test_unordered_machine_matches_jax():
    rng = np.random.default_rng(0)
    packed = JC.pack_constraints(CONSTRAINTS)
    jtrie, ttrie = JC.build_unordered(packed), TC.build_unordered(packed)
    b, n = jtrie.token.shape
    rows = [_row(jtrie, i) for i in range(b)]

    def per_row(fn):  # a one-row JAX function over [B, K] states
        return jax.jit(lambda *xs: jnp.stack([
            jax.vmap(lambda *a, r=r: fn(r, *a))(*(x[i] for x in xs))
            for i, r in enumerate(rows)]))

    adv = jax.jit(lambda *xs: [jnp.stack(z) for z in zip(*[
        jax.vmap(lambda *a, r=r: JC.unordered_advance(r, *a))(*(x[i] for x in xs))
        for i, r in enumerate(rows)])])
    num_completed = per_row(JC.unordered_num_completed)
    finished = per_row(JC.unordered_finished)
    next_tokens = jax.jit(lambda nd: [jnp.stack(z) for z in zip(*[
        jax.vmap(lambda a, r=r: JC.unordered_next_tokens(r, a))(nd[i])
        for i, r in enumerate(rows)])])

    jnode = jnp.zeros((b, BEAMS), jnp.int32)
    jgen = jnp.zeros((b, BEAMS, n), jnp.int32)
    jcomp = jnp.zeros((b, BEAMS, n), jnp.int32)
    st = TC.unordered_init(ttrie, BEAMS)
    tnode, tgen, tcomp = st
    for step, tok in enumerate(np.moveaxis(_streams(rng), -1, 0)):
        jnode, jgen, jcomp = adv(jnode, jgen, jcomp, jnp.asarray(tok, jnp.int32))
        tnode, tgen, tcomp = TC.unordered_advance(ttrie, tnode, tgen, tcomp, t(tok))
        for name, w, g in [("node", jnode, tnode), ("generated", jgen, tgen),
                           ("completed", jcomp, tcomp),
                           ("bank", JC.unordered_bank(jgen), TC.unordered_bank(tgen)),
                           ("num_completed", num_completed(jnode, jcomp),
                            TC.unordered_num_completed(ttrie, tnode, tcomp)),
                           ("finished", finished(jnode, jcomp),
                            TC.unordered_finished(ttrie, tnode, tcomp))]:
            np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=f"{name}@{step}")
        (jt, jok), (tt, tok_ok) = next_tokens(jnode), TC.unordered_next_tokens(ttrie, tnode)
        np.testing.assert_array_equal(np.asarray(jok), tok_ok.numpy())
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    assert bool(tcomp.any())  # the streams complete constraints


def test_ordered_machine_matches_jax():
    rng = np.random.default_rng(1)
    packed = JC.pack_constraints(CONSTRAINTS)
    jseq, tseq = JC.build_ordered(packed), TC.build_ordered(packed)
    b = jseq.seq.shape[0]
    rows = [_row(jseq, i) for i in range(b)]

    def per_row(fn):
        return jax.jit(lambda *xs: jnp.stack([
            jax.vmap(lambda *a, r=r: fn(r, *a))(*(x[i] for x in xs))
            for i, r in enumerate(rows)]))

    adv = per_row(JC.ordered_advance)
    num_completed = per_row(JC.ordered_num_completed)
    finished = per_row(JC.ordered_finished)
    next_tokens = jax.jit(lambda s: [jnp.stack(z) for z in zip(*[
        jax.vmap(lambda a, r=r: JC.ordered_next_tokens(r, a))(s[i])
        for i, r in enumerate(rows)])])

    jst = jnp.full((b, BEAMS), -1, jnp.int32)
    tst = TC.ordered_init(tseq, BEAMS)
    for step, tok in enumerate(np.moveaxis(_streams(rng), -1, 0)):
        jst = adv(jst, jnp.asarray(tok, jnp.int32))
        tst = TC.ordered_advance(tseq, tst, t(tok))
        for name, w, g in [("state", jst, tst),
                           ("bank", JC.ordered_bank(jst), TC.ordered_bank(tst)),
                           ("num_completed", num_completed(jst),
                            TC.ordered_num_completed(tseq, tst)),
                           ("finished", finished(jst), TC.ordered_finished(tseq, tst))]:
            np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=f"{name}@{step}")
        (jt, jok), (tt, tok_ok) = next_tokens(jst), TC.ordered_next_tokens(tseq, tst)
        np.testing.assert_array_equal(np.asarray(jok), tok_ok.numpy())
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    assert bool(TC.ordered_finished(tseq, tst).any())
