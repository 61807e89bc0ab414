"""Four gloo ranks of the port (tests/torch_dist_worker.py) against the JAX
package in this process: data 2 x fsdp 2 gives the data-2 step of the JAX
Trainer; ``pipeline_lm_forward`` at {pipeline 2, data 2} gives JAX's
pipelined and sequential logits and gradients; the AVSR pipelined loss gives
the plain loss and its gradients; the MoE layer at {expert 2, data 2}
routes over the global token set as the JAX layer on the global batch,
forward and gradients; ring attention at sequence 4 is exact attention; the
``sequence_parallel`` encoder at {sequence 2, data 2} gives the JAX serial
encoder's output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_train import (
    ATTN_TOL,
    LOSS_RTOL,
    MASTER_RTOL,
    OPT,
    RING_CASES,
    STEPS,
    _jax_run,
    batch4,
    exact_attention,
    tiny_variables,
)
from torch_dist_worker import spawn
from torch_parity import to_numpy_tree

from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.nn.layers import TransformerEncoder
from multimodalvc_tpu.nn.llama import LlamaConfig, LlamaModel, pipeline_lm_forward
from multimodalvc_tpu.parallel import make_mesh
from multimodalvc_tpu.parallel.expert import BaseMoELayer
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict

# the pipelined logits on the valid rows as tests/test_parallel_extras.py
# holds JAX's own (2e-4); gradients to rel 1e-4 of each leaf's norm; f32 MoE
# and encoder through the same ops
LOGIT_TOL, GRAD_RTOL, MOE_TOL, ENC_TOL = 2e-4, 1e-4, 2e-5, 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist4")
    rng = np.random.default_rng(5)
    # the AVSR trainer and the pipelined loss
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = batch4(cfg)
    variables = tiny_variables(jsys, batch)
    torch.save(flax_to_state_dict(to_numpy_tree(variables)), tmp / "avsr.pt")
    np.savez(tmp / "batch.npz", **batch)
    # the LLaMA pipeline: left padding on row 1
    lcfg = LlamaConfig.tiny()
    lcfg.lora = None
    emb = (rng.standard_normal((4, 10, lcfg.hidden_size)) * 0.05).astype(np.float32)
    mask = np.ones((4, 10), np.int32)
    mask[1, :4] = 0
    lvars = LlamaModel(lcfg).init(jax.random.PRNGKey(0), inputs_embeds=jnp.asarray(emb),
                                  attn_mask=jnp.asarray(mask))
    torch.save(flax_to_state_dict(to_numpy_tree(lvars)), tmp / "llama.pt")
    np.save(tmp / "emb.npy", emb)
    np.save(tmp / "mask.npy", mask)
    # the MoE layer
    x = rng.standard_normal((4, 12, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    mvars = BaseMoELayer(num_experts=4, ffn_dim=32).init(jax.random.PRNGKey(1), jnp.asarray(x))
    torch.save(flax_to_state_dict(to_numpy_tree(mvars)), tmp / "moe.pt")
    np.save(tmp / "moe_x.npy", x)
    np.save(tmp / "moe_w.npy", w)
    # the sequence-parallel encoder
    ex = rng.standard_normal((2, 64, 32)).astype(np.float32)
    lens = np.asarray([64, 40], np.int32)
    enc = TransformerEncoder(num_layers=2, num_heads=4, ffn_dim=64)
    evars = enc.init(jax.random.PRNGKey(2), jnp.asarray(ex), lengths=jnp.asarray(lens))
    torch.save(flax_to_state_dict(to_numpy_tree(evars)), tmp / "enc.pt")
    np.save(tmp / "enc_x.npy", ex)
    np.save(tmp / "enc_len.npy", lens)
    ring_cases = {n: dict(c, shape=(2, 2, 16, 8), seed=10 + i)
                  for i, (n, c) in enumerate(RING_CASES.items())}
    jobs = [("avsr_trainer", dict(mesh={"data": 2, "fsdp": 2}, state=str(tmp / "avsr.pt"),
                                  batch=str(tmp / "batch.npz"), opt=OPT, steps=STEPS,
                                  fsdp_min=64)),
            ("llama_pipeline", dict(mesh={"pipeline": 2, "data": 2}, state=str(tmp / "llama.pt"),
                                    emb=str(tmp / "emb.npy"), mask=str(tmp / "mask.npy"),
                                    microbatches=2)),
            ("avsr_pipeline", dict(mesh={"pipeline": 2, "data": 2}, state=str(tmp / "avsr.pt"),
                                   batch=str(tmp / "batch.npz"), microbatches=2)),
            ("moe", dict(mesh={"expert": 2, "data": 2}, state=str(tmp / "moe.pt"),
                         x=str(tmp / "moe_x.npy"), w=str(tmp / "moe_w.npy"), experts=4, ffn=32)),
            ("ring", dict(mesh={"sequence": 4}, cases=ring_cases)),
            ("encoder_sp", dict(mesh={"sequence": 2, "data": 2}, state=str(tmp / "enc.pt"),
                                x=str(tmp / "enc_x.npy"), lengths=str(tmp / "enc_len.npy")))]
    ranks = spawn(tmp, 4, jobs)
    return dict(ranks=ranks, jsys=jsys, variables=variables, batch=batch, lcfg=lcfg,
                lvars=lvars, emb=emb, mask=mask, moe=(mvars, x, w), enc=(enc, evars, ex, lens),
                ring_cases=ring_cases)


def test_data2_fsdp2_gives_the_data2_step(world):
    jm, jparams = _jax_run(world, {"data": 2})
    runs = [r["avsr_trainer"] for r in world["ranks"]]
    assert all(r["rows"] == 1 for r in runs) and runs[0]["split"]
    assert all(2 * r["held_bytes"] == r["whole_bytes"] for r in runs)
    for r in runs[1:]:
        assert r["metrics"] == runs[0]["metrics"]
        assert all(torch.equal(m, runs[0]["masters"][n]) for n, m in r["masters"].items())
    for a, j in zip(runs[0]["metrics"], jm):
        np.testing.assert_allclose(a["loss"], float(j["loss"]), rtol=LOSS_RTOL)
        assert a["n_tokens"] == int(j["n_tokens"])
    for n, m in runs[0]["masters"].items():
        np.testing.assert_allclose(m.numpy(), jparams[n].numpy(), rtol=MASTER_RTOL, atol=1e-7,
                                   err_msg=n)


def test_llama_pipeline_matches_jax_and_the_sequential_model(world):
    cfg, lvars, emb, mask = world["lcfg"], world["lvars"], world["emb"], world["mask"]
    model = LlamaModel(cfg)
    keep = mask[..., None].astype(bool)
    count = keep.sum() * cfg.vocab_size
    mesh = make_mesh({"pipeline": 2, "data": 2}, devices=jax.devices()[:4])

    def seq_loss(v):
        lg = model.apply(v, inputs_embeds=jnp.asarray(emb), attn_mask=jnp.asarray(mask))["logits"]
        return jnp.sum(jnp.where(keep, lg ** 2, 0.0)) / count

    def pipe_loss(v):
        lg = pipeline_lm_forward(cfg, v, jnp.asarray(emb), jnp.asarray(mask), mesh, 2)
        return jnp.sum(jnp.where(keep, lg ** 2, 0.0)) / count

    ref = model.apply(lvars, inputs_embeds=jnp.asarray(emb), attn_mask=jnp.asarray(mask))["logits"]
    jpipe = jax.jit(lambda v: pipeline_lm_forward(cfg, v, jnp.asarray(emb), jnp.asarray(mask),
                                                  mesh, 2))(lvars)
    g_seq = flax_to_state_dict(to_numpy_tree(jax.grad(seq_loss)(lvars)))
    g_pipe = flax_to_state_dict(to_numpy_tree(jax.jit(jax.grad(pipe_loss))(lvars)))
    make_mesh({"data": -1})
    for rank in world["ranks"]:
        got = rank["llama_pipeline"]
        d = (rank is world["ranks"][1] or rank is world["ranks"][3])
        rows = slice(2, 4) if d else slice(0, 2)
        vr = keep[rows]
        for want in (np.asarray(ref)[rows], np.asarray(jpipe)[rows]):
            np.testing.assert_allclose(got["logits"].numpy() * vr, want * vr, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
        for n, g in got["grads"].items():
            for want in (g_seq, g_pipe):
                assert _rel(g.numpy(), want[n].numpy()) < GRAD_RTOL, n
    # every stage's layers got their gradient
    grads = world["ranks"][0]["llama_pipeline"]["grads"]
    for i in range(cfg.num_layers):
        assert sum(float(g.abs().sum()) for n, g in grads.items()
                   if n.startswith(f"layers_{i}.")) > 0


def test_avsr_pipelined_loss_gives_the_plain_loss(world):
    """The task's pipelined loss (the loss of the global batch on every rank)
    and its trainable gradients against the plain loss of the whole batch
    computed alone; the encoders and every layer's LoRA get a gradient."""
    for rank in world["ranks"]:
        got = rank["avsr_pipeline"]
        assert got["fn"].startswith("AVSRSystem.make_pipeline_loss_fn")
        np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=2e-4)
        for n, g in got["grads"].items():
            ref = got["ref_grads"][n]
            assert float(torch.linalg.norm(g - ref)) <= GRAD_RTOL * float(
                torch.linalg.norm(ref)) + 1e-7, n
    grads = world["ranks"][0]["avsr_pipeline"]["grads"]
    assert any(float(g.abs().sum()) > 0 for n, g in grads.items() if n.startswith("encoder."))
    for i in range(world["jsys"].cfg.llama.num_layers):
        assert any(float(g.abs().sum()) > 0 for n, g in grads.items()
                   if n.startswith(f"llama.layers_{i}.")), i


def test_moe_routes_over_the_global_token_set(world):
    mvars, x, w = world["moe"]
    layer = BaseMoELayer(num_experts=4, ffn_dim=32)

    def loss(p, xx):
        return jnp.sum(layer.apply({"params": p}, xx) * w)

    out = layer.apply(mvars, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(mvars["params"], jnp.asarray(x))
    gp = flax_to_state_dict({"params": to_numpy_tree(gp)})
    for r, rank in enumerate(world["ranks"]):
        got = rank["moe"]
        rows = slice(2, 4) if r // 2 else slice(0, 2)  # data is the outer axis
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(out)[rows], atol=MOE_TOL)
        np.testing.assert_allclose(got["dx"].numpy(), np.asarray(gx)[rows], atol=MOE_TOL)
        for n, g in got["grads"].items():
            assert _rel(g.numpy(), gp[n].numpy()) < MOE_TOL, n
        assert int(got["load"]["tokens"].sum() + got["load"]["overflow"]) == x.shape[0] * x.shape[1]


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_at_sequence_4_is_exact_attention(world, case):
    c = world["ring_cases"][case]
    rng = np.random.default_rng(c["seed"])
    q, k, v, w = (jnp.asarray(rng.standard_normal(c["shape"]).astype(np.float32))
                  for _ in range(4))
    want = exact_attention(q, k, v, c["causal"], c["kv_len"])
    grads = jax.grad(lambda *a: jnp.sum(exact_attention(*a, c["causal"], c["kv_len"]) * w),
                     argnums=(0, 1, 2))(q, k, v)
    for rank in world["ranks"]:
        got = rank["ring"][case]
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), atol=ATTN_TOL)
        for g, jg in zip(got["grads"], grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATTN_TOL)


def test_sequence_parallel_encoder_matches_jax_serial(world):
    enc, evars, ex, lens = world["enc"]
    want = np.asarray(enc.apply(evars, jnp.asarray(ex), lengths=jnp.asarray(lens)))
    for r, rank in enumerate(world["ranks"]):
        row = r // 2  # data is outside sequence
        np.testing.assert_allclose(rank["encoder_sp"]["out"].numpy(), want[row:row + 1],
                                   atol=ENC_TOL)
