"""The training forward of the port against the JAX package (tiny config, f32,
dropout off where values are compared): the label half of the prompt
assembly, the LM loss and its counts, the gradients of the trainable leaves
under the frozen stop-gradient, K1's gradient, the tied unembed's gradient,
and the LoRA dropout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t, to_numpy_tree

from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.ops import attention as jattn
from multimodalvc_tpu.runtime.trainer import trainable_mask as jax_mask
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn import llama as tl
from multimodalvc_tpu_torch.ops import attention as tattn
from multimodalvc_tpu_torch.ops import kernel_lib
from multimodalvc_tpu_torch.runtime.trainer import trainable_mask

# f32 through the encoders, the Q-Former and two LLaMA layers: the loss agrees
# to a few ulps (rel 1e-5); the gradients, summed in other orders through the
# same graph, to rel L2 1e-4 over all trainable leaves, and per leaf within
# 1e-4 of the leaf's norm or 1e-6 of the whole gradient's (a few leaves, the
# attention key biases, have no gradient in exact arithmetic: both sides hold
# rounding noise there)
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-6


def avsr_batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((b, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((b, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([t_v, t_v // 2], np.int32),
        "instruction": rng.integers(1, 200, (b, 5)).astype(np.int32),
        "labels": rng.integers(1, 200, (b, 8)).astype(np.int32),
        "label_lengths": np.asarray([8, 4], np.int32),
    }


@pytest.fixture(scope="module")
def systems():
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = avsr_batch(cfg)
    variables = randomize(jsys.init(jax.random.PRNGKey(0), batch))
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    loaded(tsys.module, variables)
    return jsys, variables, tsys, batch


@pytest.fixture(scope="module")
def jax_grads(systems):
    jsys, variables, _, batch = systems
    return _jax_grads(jsys, variables, batch)


def _tb(batch):
    return {k: t(x) for k, x in batch.items()}


def test_assemble_left_padded_with_labels_matches_jax():
    rng = np.random.default_rng(3)
    d = 6
    pad = rng.standard_normal(d).astype(np.float32)
    inst = rng.standard_normal((3, 4, d)).astype(np.float32)
    queries = rng.standard_normal((3, 7, d)).astype(np.float32)
    q_lens = np.asarray([7, 2, 4], np.int32)
    lab_emb = rng.standard_normal((3, 5, d)).astype(np.float32)
    lab_tok = rng.integers(1, 100, (3, 5)).astype(np.int32)
    lab_lens = np.asarray([5, 1, 3], np.int32)
    want = javsr.assemble_left_padded(*(jnp.asarray(x) for x in (
        pad, inst, queries, q_lens, lab_emb, lab_tok, lab_lens)))
    got = tavsr.assemble_left_padded(*(t(x) for x in (
        pad, inst, queries, q_lens, lab_emb, lab_tok, lab_lens)))
    assert len(got) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_loss_matches_jax(systems):
    jsys, variables, tsys, batch = systems
    loss, aux = jax.jit(lambda v, b: jsys.module.apply(v, b, train=False))(variables, batch)
    with torch.no_grad():
        got, gaux = tsys.module(_tb(batch), train=False)
    np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
    assert int(gaux["n_valid"]) == int(aux["n_valid"]) == 12
    assert int(gaux["n_correct"]) == int(aux["n_correct"])
    np.testing.assert_array_equal(np.asarray(aux["labels"]), gaux["labels"].numpy())
    np.testing.assert_array_equal(np.asarray(aux["attn_mask"]), gaux["attn_mask"].numpy())
    assert max_err(aux["hidden"], gaux["hidden"]) < 1e-4
    # the validation step of the task computes the same
    from multimodalvc_tpu_torch.tasks import AVSRTask, AVSRTaskConfig

    task = AVSRTask(AVSRTaskConfig(), tavsr.AVSRConfig.tiny(), device="cpu")
    task.system = tsys
    step = task.valid_step_fn()(task.prepare_batch(_tb(batch)))
    assert float(step["loss"]) == float(got) and int(step["n_tokens"]) == 12
    assert torch.equal(step["ppl"], torch.exp(got))


def test_prompt_for_training_matches_jax(systems):
    """The front half of the training forward: the embeddings, the mask and
    the slot labels of the prompt with its labels."""
    jsys, variables, tsys, batch = systems
    want = jax.jit(lambda v, b: jsys.module.apply(
        v, b, False, method=javsr.AVSRModel.prompt_for_training))(variables, batch)
    with torch.no_grad():
        got = tsys.module.prompt_for_training(_tb(batch), train=False)
    assert max_err(want[0], got[0]) < 1e-5
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _jax_grads(jsys, variables, batch):
    params = variables["params"]
    colls = {k: v for k, v in variables.items() if k != "params"}
    mask = jax_mask(params, jsys.frozen_patterns())

    def lf(p):
        p = jax.tree.map(lambda x, m: x if m else jax.lax.stop_gradient(x), p, mask)
        return jsys.module.apply({"params": p, **colls}, batch, train=False)[0]

    grads = jax.jit(jax.grad(lf))(params)
    return flax_to_state_dict({"params": to_numpy_tree(grads)}), mask


def _port_grads(tsys, batch):
    named = dict(tsys.module.named_parameters())
    mask = trainable_mask(named, tsys.frozen_patterns())
    for n, p in named.items():
        p.requires_grad_(mask[n])
        p.grad = None
    loss, _ = tsys.module(_tb(batch), train=False)
    loss.backward()
    grads = {n: p.grad for n, p in named.items()}
    for p in named.values():
        p.requires_grad_(False)
        p.grad = None
    return grads, mask


def test_trainable_gradients_match_jax(systems, jax_grads):
    _, _, tsys, batch = systems
    want, _ = jax_grads
    got, mask = _port_grads(tsys, batch)
    names = [n for n in got if mask[n]]
    # a trainable leaf the loss does not reach (the tiny config's bridge
    # before the speech-rate predictor, whose output the JAX model stops)
    # has no gradient here and a zero one there
    flat_w = torch.cat([want[n].double().reshape(-1) for n in names])
    flat_g = torch.cat([(got[n] if got[n] is not None else torch.zeros_like(want[n]))
                        .double().reshape(-1) for n in names])
    assert float((flat_g - flat_w).norm() / flat_w.norm()) < GRAD_RTOL
    total = float(flat_w.norm())
    for n in names:
        w = want[n].double()
        g = got[n].double() if got[n] is not None else torch.zeros_like(w)
        assert float((g - w).norm()) <= GRAD_RTOL * float(w.norm()) + GRAD_FLOOR * total, n


def test_frozen_leaves_get_no_gradient(systems, jax_grads):
    """The analog of test_avsr_grads_flow_only_to_trainable: every frozen
    leaf (the encoders, the speech-rate predictor, the LLaMA but its LoRA
    adapters) gets no gradient; the trainable ones are the JAX mask's."""
    _, variables, tsys, batch = systems
    got, mask = _port_grads(tsys, batch)
    _, jmask = jax_grads
    shaped = jax.tree.map(lambda p, m: np.full(np.shape(p), m), variables["params"], jmask)
    jflat = flax_to_state_dict({"params": shaped})
    assert {n for n, m in mask.items() if m} == {n for n, m in jflat.items() if bool(m.all())}
    frozen = [n for n, m in mask.items() if not m]
    assert frozen and all(got[n] is None for n in frozen)
    assert any(n.startswith("llama.") and "lora_" in n for n, m in mask.items() if m)
    reached = [n for n, m in mask.items() if m and got[n] is not None]
    assert all(n.startswith("encoder.sr_bridge.") for n, m in mask.items()
               if m and got[n] is None)
    assert any(float(got[n].abs().max()) > 0 for n in reached)


# K1's gradient: the JAX kernel in interpret mode under jax.grad (its custom
# VJP) against the port's autograd Function with the plain forward in place of
# the launch; f32 (the same recompute on both sides: ~1e-6)
FLASH_GRAD_CASES = {
    "causal_kv_starts": dict(shape=(2, 2, 80, 32), kv_lens=[80, 60], kv_starts=[0, 17]),
    "causal_d128_starts_lens": dict(shape=(2, 3, 72, 128), kv_lens=[72, 50], kv_starts=[5, 29]),
}


@pytest.mark.parametrize("case", sorted(FLASH_GRAD_CASES))
def test_flash_attention_gradient_matches_jax(monkeypatch, case):
    c = FLASH_GRAD_CASES[case]
    rng = np.random.default_rng(4)
    q, k, v, cot = (rng.standard_normal(c["shape"]).astype(np.float32) for _ in range(4))
    lens, starts = np.asarray(c["kv_lens"], np.int32), np.asarray(c["kv_starts"], np.int32)
    scale = 0.3

    def jloss(q_, k_, v_):
        out = jattn.flash_attention(q_, k_, v_, kv_lens=jnp.asarray(lens), causal=True,
                                    scale=scale, interpret=True, kv_starts=jnp.asarray(starts))
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))

    def plain_launch(q_, k_, v_, kv_lens, kv_starts, causal, scale_):
        with torch.no_grad():  # a launch records nothing
            return tattn._windowed_reference_attention(q_, k_, v_, kv_lens, kv_starts, causal,
                                                       scale_)

    monkeypatch.setattr(tattn, "_launch", plain_launch)
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = tattn.FlashAttentionGrad.apply(*leaves, t(lens), t(starts), True, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, t(cot))
    for w, g in zip(want, got):
        assert max_err(w, g) < 1e-4


def test_flash_attention_takes_the_gradient_only_under_grad(monkeypatch):
    """On the card (meta tensors stand in, the library recorded): q, k or v
    requiring a gradient under grad mode launch K1 inside the autograd
    Function; no_grad and inference_mode launch it bare, saving nothing."""
    calls = []

    class Lib:
        def call(self, name, *args):
            calls.append(name)

    monkeypatch.setattr(kernel_lib, "load", lambda: Lib())
    monkeypatch.setattr(kernel_lib, "check", lambda *a, **kw: None)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda x: 0)
    shape = (2, 4, 64, 128)
    q, k, v = (torch.empty(shape, dtype=torch.bfloat16, device="meta") for _ in range(3))
    before = tattn.flash_attention.launches
    assert tattn.flash_attention(q, k, v, causal=True).grad_fn is None
    q.requires_grad_()
    out = tattn.flash_attention(q, k, v, causal=True)
    assert isinstance(out.grad_fn, tattn.FlashAttentionGrad._backward_cls)
    with torch.no_grad():
        assert tattn.flash_attention(q, k, v, causal=True).grad_fn is None
    with torch.inference_mode():
        assert tattn.flash_attention(q, k, v, causal=True).grad_fn is None
    assert calls == ["mmvc_flash_attention"] * 4
    assert tattn.flash_attention.launches == before + 4


def test_tied_unembed_has_a_gradient(monkeypatch):
    """The card's bf16 unembed (torch.mm with f32 out, which has no
    derivative of its own) through ``TiedUnembed``: the f32 logits of the
    bf16 product, and d hidden = g @ emb, the product's gradient rounded to
    bf16.  On the CPU a stand-in for torch.mm with out_dtype runs it."""
    real_mm = torch.mm

    def mm(a, b, out_dtype=None):
        return real_mm(a.double(), b.double()).to(out_dtype) if out_dtype else real_mm(a, b)

    monkeypatch.setattr(torch, "mm", mm)
    rng = np.random.default_rng(5)
    flat = t(rng.standard_normal((6, 16)).astype(np.float32)).bfloat16().requires_grad_()
    emb = t(rng.standard_normal((40, 16)).astype(np.float32)).bfloat16()
    g = t(rng.standard_normal((6, 40)).astype(np.float32))
    logits = tl.TiedUnembed.apply(flat, emb)
    assert logits.dtype == torch.float32
    ref = flat.detach().double() @ emb.double().T
    assert max_err(ref, logits) < 1e-5
    (d_flat,) = torch.autograd.grad(logits, [flat], g)
    want = (g.bfloat16().double() @ emb.double()).bfloat16()
    assert d_flat.dtype == torch.bfloat16 and torch.equal(d_flat, want)


def test_lora_dropout_follows_the_generator():
    """With LoRA dropout on, the masks come from the generator alone: one
    seed gives the same loss and adapter gradients bit for bit, another seed
    other ones; without a generator (evaluation) the adapters take no
    dropout, and neither do they at rate 0."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=64),
                              lora=tl.LoraConfig(rank=4, dropout=0.3))
    torch.manual_seed(0)
    model = tl.LlamaModel(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.normal_(0, 0.2 if "lora" in name else 0.05)
    emb = torch.randn(2, 9, 64)
    mask = torch.ones(2, 9, dtype=torch.int32)
    mask[1, :3] = 0
    lora = [p for n, p in model.named_parameters() if "lora" in n]

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        loss = (model(inputs_embeds=emb, attn_mask=mask, dropout_rng=gen)["logits"] ** 2).mean()
        return loss.detach(), torch.autograd.grad(loss, lora)

    (a, ga), (b, gb), (c, _) = run(7), run(7), run(8)
    assert torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert not torch.equal(a, c)
    evaluation = run(None)[0]
    assert not torch.equal(a, evaluation)
    for layer in model.modules():
        if isinstance(layer, tl.LoraDense):
            layer.dropout = 0.0
    assert torch.equal(run(7)[0], evaluation)


def test_training_loss_draws_dropout_from_the_generator(systems):
    """make_trainer_loss_fn: the Q-Former's and LoRA's dropout from the
    generator (one seed, one loss); with every rate at 0 it is the
    evaluation loss."""
    _, _, tsys, batch = systems
    fn = tsys.make_trainer_loss_fn()
    tb = _tb(batch)
    with torch.no_grad():
        eval_loss, _ = tsys.module(tb, train=False)
        a, ma = fn(tb, torch.Generator().manual_seed(1))
        b, _ = fn(tb, torch.Generator().manual_seed(1))
        c, _ = fn(tb, torch.Generator().manual_seed(2))
    assert float(a) == float(b) and float(a) != float(c) and float(a) != float(eval_loss)
    assert int(ma["n_tokens"]) == 12
    with pytest.raises(ValueError, match="torch.Generator"):
        tsys.module(tb, train=True)
    rates = {}
    for m in tsys.module.modules():
        if isinstance(getattr(m, "dropout", None), float):
            rates[m] = m.dropout
            m.dropout = 0.0
    try:
        with torch.no_grad():
            z, _ = fn(tb, torch.Generator().manual_seed(1))
    finally:
        for m, r in rates.items():
            m.dropout = r
    assert float(z) == float(eval_loss)
