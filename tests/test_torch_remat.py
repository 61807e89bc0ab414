"""remat (LlamaConfig.remat, TransformerEncoder(remat=), AVHubertConfig.remat):
each layer rematerialised in the backward through ``torch.utils.checkpoint``
with the dropout generator's state replayed.  With dropout on, the gradients
equal those without remat bit for bit in f32, and the generator ends in the
same state; with dropout off, the LLaMA's equal the JAX remat gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, randomize, t

from multimodalvc_tpu.nn import llama as jl
from multimodalvc_tpu_torch.interop.from_flax import state_dict_to_flax
from multimodalvc_tpu_torch.nn import avhubert as tavh
from multimodalvc_tpu_torch.nn import llama as tl
from multimodalvc_tpu_torch.nn.init import init_random_

B, T = 2, 9
# the JAX remat gradients against the port's, f32, each leaf within 1e-5 of
# its largest element (two decoder layers and the tied unembed)
JAX_RTOL = 1e-5


def _lora_llama(remat: bool, dropout: float):
    cfg = tl.LlamaConfig.tiny()
    cfg.remat = remat
    cfg.lora = dataclasses.replace(cfg.lora, dropout=dropout)
    model = tl.LlamaModel(cfg, dtype=torch.float32)
    init_random_(model, 0)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "lora_b" in n:  # zero at init: give the adapters a gradient path
                p.normal_(0.0, 0.1, generator=g)
    return model


def _ids(seed=1):
    return torch.randint(1, 256, (B, T), generator=torch.Generator().manual_seed(seed))


def _grads(model, loss):
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    got = torch.autograd.grad(loss, [dict(model.named_parameters())[n] for n in names])
    return dict(zip(names, got))


def _llama_step(remat: bool):
    model = _lora_llama(remat, dropout=0.3)
    gen = torch.Generator().manual_seed(3)
    logits = model(_ids(), dropout_rng=gen)["logits"]
    grads = _grads(model, logits.square().mean())
    return grads, gen.get_state()


def _avhubert_step(remat: bool):
    cfg = dataclasses.replace(tavh.AVHubertConfig.tiny(), remat=remat, dropout=0.2)
    model = tavh.AVHubertModel(cfg, audio=True)
    init_random_(model, 0)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, 12, 64, generator=torch.Generator().manual_seed(1))
    out = model.encoder(x, lengths=torch.tensor([12, 9]), dropout_rng=gen)
    return _grads(model.encoder, out.square().mean()), gen.get_state()


@pytest.mark.parametrize("step", [_llama_step, _avhubert_step], ids=["llama", "avhubert"])
def test_remat_gradients_equal_without_bit_for_bit(step):
    plain, plain_state = step(False)
    checked, checked_state = step(True)
    assert plain.keys() == checked.keys()
    for n, g in plain.items():
        assert torch.equal(g, checked[n]), n
    # the recompute replayed the forward's draws: the generator moved as far
    # as without remat, and the dropout did draw
    assert torch.equal(plain_state, checked_state)
    assert not torch.equal(plain_state, torch.Generator().manual_seed(3).get_state())


def test_remat_checkpoints_each_layer():
    """The remat model saves no layer's activations: its forward keeps fewer
    tensors for the backward than the plain one."""
    counts = []
    for remat in (False, True):
        model = _lora_llama(remat, dropout=0.0)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(1) or x,
                                                      lambda x: x):
            model(_ids())["logits"].sum()
        counts.append(len(saved))
    assert counts[1] < counts[0] / 2, counts


def test_llama_remat_gradients_match_jax():
    """Dropout off: the port's remat gradients against ``jax.grad`` of the
    JAX remat model on the same weights (tests/test_llama.py's loss)."""
    ids = np.random.default_rng(0).integers(1, 200, (B, T))
    jcfg = jl.LlamaConfig.tiny()
    jcfg.remat = True
    jm = jl.LlamaModel(jcfg)
    variables = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids)))

    def loss(p):
        out = jm.apply({"params": p}, input_ids=jnp.asarray(ids))
        return jnp.sum(out["logits"].astype(jnp.float32) ** 2) * 1e-6

    want = jax.jit(jax.grad(loss))(variables["params"])
    cfg = tl.LlamaConfig.tiny()
    cfg.remat = True
    tm = loaded(tl.LlamaModel(cfg), variables)
    out = tm(t(ids))["logits"]
    grads = _grads(tm, (out.float() ** 2).sum() * 1e-6)
    got = state_dict_to_flax(grads, jax.tree.map(np.asarray, want))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got),
                            strict=True):
        w = np.asarray(w)
        assert np.abs(np.asarray(g) - w).max() <= JAX_RTOL * np.abs(w).max(), \
            jax.tree_util.keystr(path)
