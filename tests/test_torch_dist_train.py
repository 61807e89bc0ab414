"""Two gloo ranks of the port (tests/torch_dist_worker.py) against the JAX
package in this process: a data-parallel AVSR step on {data: 2} equals the
JAX Trainer's on the concatenated batch, and the ranks are bitwise equal;
fsdp 2 gives the data-2 numbers with half the split leaves' optimizer bytes
on each rank, and its checkpoint resumes on one rank; tensor 2 gives the
JAX Trainer's steps on the same mesh with half of each split leaf on each
rank, its checkpoints resume at tensor 1 and the other way round, and the
NoLLM head's training steps with dropout are the one-process steps; a
checkpoint resumes on two ranks, rank 1 drawing apart from rank 0; every rank takes rank 0's
validation metrics; BatchNorm's training
statistics are the global batch's; ring attention at sequence 2 is exact
attention, forward and gradient; BMUF syncs the workers; the vocoder's
GAN steps on two ranks give the one-process steps.  One spawn of two ranks
runs every job (~110 s for the whole file with the tensor-2 jobs)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_dist_worker import avsr_tensor_ckpt, nollm_steps, spawn, tiny_vocoder, toy_trainer
from torch_parity import jax_variables, randomize, to_numpy_tree

from multimodalvc_tpu.config.configs import OptimizationConfig as JaxOptimizationConfig
from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.parallel import make_mesh
from multimodalvc_tpu.parallel.bmuf import bmuf
from multimodalvc_tpu.runtime import trainer as jtrainer
from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn.init import init_random_
from multimodalvc_tpu_torch.ops.stft import hifigan_log_mel
from multimodalvc_tpu_torch.runtime.trainer import Trainer

# f32 on both sides: the losses of a step to rel 1e-5 (the two trainers part
# by ~1e-7 a step, tests/test_torch_trainer.py); the masters to rel 1e-5 of
# their values with AdamW's eps at 1e-3, so that Adam's first, sign-like
# update does not turn rounding-sized gradient elements into lr-sized moves
LOSS_RTOL, MASTER_RTOL = 1e-5, 1e-5
OPT = dict(lr=1e-3, warmup_updates=2, max_update=10, adam_eps=1e-3)
STEPS = 3
# adafactor and lamb reduce over whole leaves: the toy model's split weights
FSDP_OPTIMIZERS, TOY_STEPS = ("adafactor", "lamb"), 4
TOY_OPT = dict(lr=1e-2, weight_decay=0.01, clip_norm=1.0, lr_scheduler="fixed")
ATTN_TOL = 1e-5  # ring against exact attention, f32
NOLLM_STEPS = 2


def batch4(cfg, seed=0):
    """Four rows whose label counts differ between the halves (label lengths
    8 + 3 on rank 0, 6 + 2 on rank 1)."""
    rng = np.random.default_rng(seed)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((4, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((4, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([t_v, t_v // 2, t_v - 3, t_v], np.int32),
        "instruction": rng.integers(1, 200, (4, 5)).astype(np.int32),
        "labels": rng.integers(1, 200, (4, 8)).astype(np.int32),
        "label_lengths": np.asarray([8, 3, 6, 2], np.int32),
    }


def nollm_batch(seed=5):
    """Two rows for the tiny NoLLM speech head (its 80 mel frames), both
    streams."""
    from multimodalvc_tpu_torch.models.speech import SpeechConfig

    cfg = SpeechConfig.tiny()
    rng = np.random.default_rng(seed)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((2, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((2, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.asarray([t_v, t_v // 2], np.int32),
        "audio_lengths": np.asarray([80 * 160, 50 * 160], np.int32),
        "target_mel": rng.standard_normal((2, cfg.max_mel_frames, 128)).astype(np.float32),
        "target_mel_lengths": np.asarray([80, 50], np.int32),
        "modality_mode": np.asarray(0, np.int32),
    }


def tiny_variables(jsys, batch):
    """The tiny AVSR system's weights for both packages: the port's from
    seed 0 laid out as the JAX init's tree (no JAX init compiled), with
    ``randomize``'s LoRA ``lora_b`` and BatchNorm statistics."""
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    init_random_(tsys.module, 0)
    return randomize(jax_variables(jsys.init, batch, tsys.module))


RING_CASES = {"plain": dict(causal=False, kv_len=None), "causal": dict(causal=True, kv_len=None),
              "kv_len": dict(causal=False, kv_len=[16, 9]),
              "causal_kv_len": dict(causal=True, kv_len=[11, 16])}
RING_SHAPE = (2, 2, 16, 8)


def exact_attention(q, k, v, causal, kv_len):
    t = q.shape[2]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    ids = jnp.arange(t)
    valid = jnp.ones((q.shape[0], 1, t, t), bool)
    if kv_len is not None:
        valid = valid & (ids[None, None, None, :] < jnp.asarray(kv_len)[:, None, None, None])
    if causal:
        valid = valid & (ids[None, None, None, :] <= ids[None, None, :, None])
    s = jnp.where(valid, s, -1e30)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist2")
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = batch4(cfg)
    variables = tiny_variables(jsys, batch)
    state = str(tmp / "avsr.pt")
    torch.save(flax_to_state_dict(to_numpy_tree(variables)), state)
    np.savez(tmp / "batch.npz", **batch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    np.save(tmp / "bn_x.npy", x)
    np.save(tmp / "bn_w.npy", w)
    wav = (rng.standard_normal((4, 1600)) * 0.1).astype(np.float32)
    mel = hifigan_log_mel(torch.from_numpy(wav)).numpy()
    np.savez(tmp / "vocoder.npz", mel=mel, wav=wav[..., None])
    ring_cases = {n: dict(c, shape=RING_SHAPE, seed=i) for i, (n, c) in enumerate(
        RING_CASES.items())}
    trainer_kw = dict(state=state, batch=str(tmp / "batch.npz"), opt=OPT, steps=STEPS)
    np.savez(tmp / "nollm.npz", **nollm_batch())
    # a one-process checkpoint for the tensor-2 resume, and its next step
    one_ckpt = str(tmp / "one_ckpt.pt")
    one_next = avsr_tensor_ckpt(0, {}, **trainer_kw, save=one_ckpt)["next"]
    jobs = [("avsr_trainer:data", dict(trainer_kw, mesh={"data": 2})),
            ("avsr_trainer:fsdp", dict(trainer_kw, mesh={"fsdp": 2}, fsdp_min=64,
                                       ckpt=str(tmp / "fsdp_ckpt.pt"))),
            ("avsr_resume", dict(trainer_kw, ckpt=str(tmp / "resume_ckpt.pt"))),
            ("agree", {}),
            ("batch_norm", dict(x=str(tmp / "bn_x.npy"), w=str(tmp / "bn_w.npy"))),
            ("ring", dict(mesh={"sequence": 2}, cases=ring_cases)),
            ("bmuf", dict(sync_every=3, steps=5, lr=0.05, block_momentum=0.875)),
            *((f"optim_fsdp:{name}", dict(mesh={"fsdp": 2}, opt=dict(TOY_OPT, optimizer=name),
                                          steps=TOY_STEPS)) for name in FSDP_OPTIMIZERS),
            ("vocoder", dict(batch=str(tmp / "vocoder.npz"), steps=2)),
            ("avsr_trainer:tensor", dict(trainer_kw, mesh={"tensor": 2})),
            ("avsr_tensor_ckpt:save", dict(trainer_kw, mesh={"tensor": 2},
                                           save=str(tmp / "tensor2_ckpt.pt"))),
            ("avsr_tensor_ckpt:load", dict(trainer_kw, mesh={"tensor": 2}, steps=0,
                                           load=one_ckpt)),
            ("nollm_tensor", dict(mesh={"tensor": 2}, batch=str(tmp / "nollm.npz"), opt=OPT,
                                  steps=NOLLM_STEPS))]
    ranks = spawn(tmp, 2, jobs)
    return dict(ranks=ranks, jsys=jsys, variables=variables, batch=batch, tmp=tmp, state=state,
                bn=(x, w), ring_cases=ring_cases, one_next=one_next, trainer_kw=trainer_kw)


def _jax_run(world, mesh_sizes):
    jsys, variables = world["jsys"], world["variables"]
    params = variables["params"]
    colls = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p, c, b, rng):
        loss, aux = jsys.module.apply({"params": p, **c}, b, train=False)
        acc = aux["n_correct"] / jnp.maximum(aux["n_valid"], 1)
        return loss, ({"accuracy": acc, "n_tokens": aux["n_valid"]}, c)

    mesh = make_mesh(mesh_sizes, devices=jax.devices()[:2])
    jt = jtrainer.Trainer(loss_fn, params, colls, JaxOptimizationConfig(**OPT), mesh=mesh,
                          frozen_patterns=jsys.frozen_patterns(), donate=False)
    metrics = [jt.train_step({k: jnp.asarray(v) for k, v in world["batch"].items()})
               for _ in range(STEPS)]
    make_mesh({"data": -1})
    return metrics, flax_to_state_dict({"params": to_numpy_tree(jt.state.params)})


def test_data_parallel_step_matches_jax_on_the_concatenated_batch(world):
    ranks = world["ranks"]
    jm, jparams = _jax_run(world, {"data": 2})
    r0, r1 = (r["avsr_trainer:data"] for r in ranks)
    assert r0["rows"] == r1["rows"] == 2
    for step, (a, b, j) in enumerate(zip(r0["metrics"], r1["metrics"], jm)):
        # every rank reports the global batch's numbers
        assert a == b, step
        np.testing.assert_allclose(a["loss"], float(j["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["gnorm"], float(j["gnorm"]), rtol=1e-4)
        assert a["n_tokens"] == int(j["n_tokens"])
    for n, m in r0["masters"].items():
        assert torch.equal(m, r1["masters"][n]), n  # the ranks bitwise equal
        np.testing.assert_allclose(m.numpy(), jparams[n].numpy(), rtol=MASTER_RTOL, atol=1e-7,
                                   err_msg=n)


def test_tensor2_steps_match_jax_on_the_same_mesh(world):
    """{tensor 2}: both ranks hold the whole batch and report the JAX
    Trainer's loss, grad norm and masters on a 2-device {tensor: 2} mesh;
    each rank holds half the bytes of each split leaf (the module's weight,
    frozen ones too, and a trainable one's master and moments)."""
    jm, jparams = _jax_run(world, {"tensor": 2})
    r0, r1 = (r["avsr_trainer:tensor"] for r in world["ranks"])
    assert r0["tensor_split"] and r0["tensor_split"] == r1["tensor_split"]
    for r in (r0, r1):
        assert r["tensor_bytes"].keys() == r0["tensor_split"].keys()
        assert all(2 * held == whole for held, whole in r["tensor_bytes"].values())
    # a trainable split leaf: its master and moments are halved too
    assert any(n.startswith("encoder.qformer") for n in r0["tensor_split"])
    for step, (a, b, j) in enumerate(zip(r0["metrics"], r1["metrics"], jm)):
        assert a == b, step
        np.testing.assert_allclose(a["loss"], float(j["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["gnorm"], float(j["gnorm"]), rtol=1e-4)
        assert a["n_tokens"] == int(j["n_tokens"])
    for n, m in r0["masters"].items():
        assert torch.equal(m, r1["masters"][n]), n
        np.testing.assert_allclose(m.numpy(), jparams[n].numpy(), rtol=MASTER_RTOL, atol=1e-7,
                                   err_msg=n)


@pytest.mark.parametrize("direction", ["tensor2_to_1", "tensor1_to_2"])
def test_tensor_checkpoints_resume_at_the_other_size(world, direction):
    """A checkpoint written at tensor 2 (the whole leaves, gathered) resumes
    in one process with the next step the tensor-2 run took, and one written
    in one process resumes at tensor 2 likewise."""
    ranks = world["ranks"]
    if direction == "tensor2_to_1":
        want = ranks[0]["avsr_tensor_ckpt:save"]["next"]
        got = avsr_tensor_ckpt(0, {}, **dict(world["trainer_kw"], steps=0),
                               load=str(world["tmp"] / "tensor2_ckpt.pt"))["next"]
        results = [got]
    else:
        want = world["one_next"]
        results = [r["avsr_tensor_ckpt:load"]["next"] for r in ranks]
    for got in results:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-4)
        assert got["n_tokens"] == want["n_tokens"]


def test_nollm_dropout_steps_at_tensor_2_equal_one_process(world):
    """The NoLLM head's training steps (dropout on: the Q-Former's and the
    Conformer's, whose split attention outputs draw the whole masks; the
    BatchNorm on batch statistics) at tensor 2 equal the one-process steps."""
    one = nollm_steps(str(world["tmp"] / "nollm.npz"), OPT, NOLLM_STEPS)
    for r in world["ranks"]:
        got = r["nollm_tensor"]
        assert any(".conformer." in n for n in got["split"])
        for a, w in zip(got["metrics"], one["metrics"]):
            np.testing.assert_allclose(a["loss"], w["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(a["gnorm"], w["gnorm"], rtol=1e-4)
        for n, m in got["masters"].items():
            np.testing.assert_allclose(m.numpy(), one["masters"][n].numpy(), rtol=MASTER_RTOL,
                                       atol=1e-7, err_msg=n)


def test_fsdp_gives_the_data_parallel_numbers_with_half_the_bytes(world):
    ranks = world["ranks"]
    data = ranks[0]["avsr_trainer:data"]
    f0, f1 = (r["avsr_trainer:fsdp"] for r in ranks)
    assert f0["split"] and f0["split"] == f1["split"]
    assert 2 * f0["held_bytes"] == f0["whole_bytes"] == 2 * f1["held_bytes"]
    for a, b, d in zip(f0["metrics"], f1["metrics"], data["metrics"]):
        assert a == b
        np.testing.assert_allclose(a["loss"], d["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["gnorm"], d["gnorm"], rtol=1e-6)
    for n, m in f0["masters"].items():
        assert torch.equal(m, f1["masters"][n]), n
        # the clip's norm sums the split leaves' shares in another order
        np.testing.assert_allclose(m.numpy(), data["masters"][n].numpy(), rtol=MASTER_RTOL,
                                   atol=1e-7, err_msg=n)


@pytest.mark.parametrize("name", FSDP_OPTIMIZERS)
def test_fsdp_optimizer_takes_the_one_rank_steps(world, name):
    """adafactor (the factored means over a split dim, the RMSs) and lamb
    (the norms) at fsdp 2 against one process on the whole batch: the same
    losses, grad norms, masters and optimizer state (gathered), each within
    the order of the sums."""
    one = toy_trainer(dict(TOY_OPT, optimizer=name), TOY_STEPS)
    r0, r1 = (r[f"optim_fsdp:{name}"] for r in world["ranks"])
    # the [128, 256] weight along dim 1 (adafactor's d0), the [255, 128] one
    # along dim 1 (its d1); the JAX rules keep every bias whole
    assert r0["split"] == {"0.weight": 1, "2.weight": 1}
    for a, b, w in zip(r0["metrics"], r1["metrics"], one["metrics"]):
        assert a == b
        np.testing.assert_allclose(a["loss"], w["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["gnorm"], w["gnorm"], rtol=1e-6)
    def close(got, want, what):
        # the gradients sum the ranks' rows in another order: each tensor
        # within 1e-5 of its largest element
        assert got.shape == want.shape, what
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), what

    model, opt = one["state"]["model"], one["state"]["optimizer"]
    for n, want in model.items():
        assert torch.equal(r0["state"]["model"][n], r1["state"]["model"][n]), n
        close(r0["state"]["model"][n], want, n)
    kinds = ("v_row", "v_col", "v") if name == "adafactor" else ("mu", "nu")
    for kind in kinds:
        assert opt[kind].keys() == r0["state"]["optimizer"][kind].keys()
        for n, want in opt[kind].items():
            close(r0["state"]["optimizer"][kind][n], want, f"{kind}/{n}")


def test_fsdp_checkpoint_resumes_on_one_rank(world):
    """Rank 0's checkpoint of the fsdp run (the shares gathered) loads into a
    one-process Trainer with the same masters and moments, which then
    steps on the whole batch."""
    state = torch.load(world["tmp"] / "fsdp_ckpt.pt", weights_only=False)
    f0 = world["ranks"][0]["avsr_trainer:fsdp"]
    system = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    system.module.load_state_dict(torch.load(world["state"]))

    def loss_fn(b, generator):
        loss, aux = system.module(b, train=False)
        return loss, {"n_tokens": aux["n_valid"]}

    trainer = Trainer(loss_fn, system.module, OptimizationConfig(**OPT),
                      system.frozen_patterns())
    trainer.load_state_dict(state)
    back = trainer.state_dict()
    assert back["step"] == STEPS
    for n, m in f0["masters"].items():
        assert torch.equal(back["model"][n], m) and torch.equal(trainer.master[n], m), n
        assert torch.equal(back["optimizer"]["mu"][n], f0["mu"][n]), n
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in world["batch"].items()})
    data = world["ranks"][0]["avsr_trainer:data"]["metrics"][0]
    assert np.isfinite(out["loss"]) and out["n_tokens"] == data["n_tokens"]


def test_checkpoint_resumes_on_two_ranks(world):
    """Rank 0's checkpoint loaded on both ranks: rank 0 takes the file's
    generator state and rank 1 a seed drawn from it and its rank (through
    its own generator's ``manual_seed``), so the two draw apart; the step
    after the resume is the uninterrupted run's step, bitwise, on both."""
    from multimodalvc_tpu_torch.parallel.mesh import SEED_STRIDE

    r0, r1 = (r["avsr_resume"] for r in world["ranks"])
    saved = r0["saved_generator"]
    assert torch.equal(r1["saved_generator"], saved)
    assert torch.equal(r0["restored_generator"], saved)
    want = torch.Generator().manual_seed(int(saved.to(torch.int64).sum()) + SEED_STRIDE)
    assert torch.equal(r1["restored_generator"], want.get_state())
    assert r0["new"]["draw"] == r0["old"]["draw"]
    assert r1["new"]["draw"] != r0["new"]["draw"]
    for r in (r0, r1):
        assert r["new"]["metrics"]["loss"] == r["old"]["metrics"]["loss"]
        assert r["new"]["metrics"]["gnorm"] == r["old"]["metrics"]["gnorm"]
        for n, m in r["old"]["masters"].items():
            assert torch.equal(r["new"]["masters"][n], m), n
    assert r0["new"]["metrics"] == r1["new"]["metrics"]


def test_every_rank_takes_rank_0s_metrics(world):
    a, b = (r["agree"] for r in world["ranks"])
    assert a["mesh"] == b["mesh"] == {"loss": 0.0, "accuracy": 0.5}
    assert a["local"] == {"loss": 0.0, "accuracy": 0.5}
    assert b["local"] == {"loss": 1.0, "accuracy": 1.5}


def test_batch_norm_statistics_are_the_global_batch(world):
    x, w = world["bn"]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def f(xx):
        out, upd = bn.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd)

    (_, (out, upd)), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    for r, rank in enumerate(world["ranks"]):
        got = rank["batch_norm"]
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(out)[2 * r:2 * r + 2],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["grad"].numpy(), np.asarray(grad)[2 * r:2 * r + 2],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["mean"].numpy(), np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["var"].numpy(), np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_at_sequence_2_is_exact_attention(world, case):
    c = world["ring_cases"][case]
    rng = np.random.default_rng(c["seed"])
    q, k, v, w = (rng.standard_normal(c["shape"]).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(exact_attention(q, k, v, c["causal"], c["kv_len"]) * w)

    want = exact_attention(*(jnp.asarray(a) for a in (q, k, v)), c["causal"], c["kv_len"])
    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for rank in world["ranks"]:
        got = rank["ring"][case]
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), atol=ATTN_TOL)
        for g, jg in zip(got["grads"], grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATTN_TOL)


def test_bmuf_syncs_two_ranks(world):
    """Three local SGD steps, the sync, then two more: the workers agree at
    the sync with the JAX transformation on a 2-device data mesh, and part
    again after it."""
    a, b = (r["bmuf"] for r in world["ranks"])
    assert a[:2] != b[:2] and a[3:] != b[3:]
    assert a[2] == b[2] < 1.0
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    tx = bmuf(optax.sgd(0.05), sync_every=3, block_momentum=0.875, axis_name="data")
    grads = jnp.arange(2, dtype=jnp.float32)[:, None] / 8.0 + 0.5

    def worker(p, g):
        state = tx.init(p)
        for _ in range(3):
            u, state = tx.update(g, state, p)
            p = optax.apply_updates(p, u)
        return p

    run = jax.shard_map(worker, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"))
    out = np.asarray(jax.jit(run)(jnp.ones((2, 1), jnp.float32), grads)).reshape(-1)
    make_mesh({"data": -1})
    np.testing.assert_allclose([a[2], b[2]], out, rtol=1e-6)


def test_vocoder_gan_steps_on_two_ranks_equal_one_process(world):
    """Both optimizers of the GAN step sum their row-weighted gradients over
    the ranks: two steps on two ranks' halves give the one-process steps on
    the whole batch (f32; the gradients summed in another order)."""
    data = np.load(world["tmp"] / "vocoder.npz")
    voc = tiny_vocoder()
    for _ in range(2):
        voc.train_step({k: torch.from_numpy(v) for k, v in data.items()})
    a, b = (r["vocoder"] for r in world["ranks"])
    for side, want in (("gen", voc.gen_master), ("disc", voc.disc_master)):
        for n, m in a[side].items():
            assert torch.equal(m, b[side][n]), (side, n)
            np.testing.assert_allclose(m.numpy(), want[n].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{side} {n}")
