"""The tensor axis of the port (parallel/sharding.py, parallel/tensor.py)
against the JAX package.

The rule test: for each tiny tree, the (tensor dim, fsdp dim) that the port
gives each of its leaves equals the JAX ``infer_param_specs`` spec of the
same leaf, translated to the torch layout by the weight bridge, at
{tensor 2} and {fsdp 2, tensor 2}; the JAX trees come from
``jax.eval_shape`` of each model's init (nothing compiled): ~50 s for the
15 rule cases, most of it tracing the inits.  Four gloo ranks
(tests/torch_dist_worker.py, one spawn of ~80 s) run every mix of the
tensor axis with another: {data 2, tensor 2} and {fsdp 2, tensor 2} give
the data-2 run's AVSR steps ({data 2, sequence 2}) and hold half of each
split leaf; the pipelined AVSR loss at {pipeline 2, tensor 2} gives the
plain loss; the ring-attention encoder at {sequence 2, tensor 2} gives
the serial encoder; the MoE NoLLM head at {expert 2, tensor 2} takes the
one-process steps; ``cli.train``'s E2E GAN and vocoder loops run on
{data 2, tensor 2} and log the data-2 run's losses.  The two-rank
{tensor 2} cases against the JAX Trainer ride tests/test_torch_dist_train.py's
world."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from test_torch_cli_gan import GAN_TERMS, e2e_tree, vocoder_tree
from test_torch_dist_train import (
    LOSS_RTOL,
    MASTER_RTOL,
    OPT,
    STEPS,
    _jax_run,
    batch4,
    nollm_batch,
    tiny_variables,
)
from torch_dist_worker import VOCODER_GEN, nollm_steps, spawn
from torch_parity import to_numpy_tree

from multimodalvc_tpu.models import avhubert_pretrain as jpre
from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.models import speech as jsp
from multimodalvc_tpu.nn import hifigan as jhg
from multimodalvc_tpu.parallel.mesh import AXIS_ORDER as JAX_AXES
from multimodalvc_tpu.parallel.sharding import infer_param_specs
from multimodalvc_tpu_torch.interop.from_flax import _convert, flax_to_state_dict
from multimodalvc_tpu_torch.models import avhubert_pretrain as tpre
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.models import speech as tsp
from multimodalvc_tpu_torch.models import vocoder as tvoc
from multimodalvc_tpu_torch.nn import hifigan as thg
from multimodalvc_tpu_torch.nn.init import init_random_
from multimodalvc_tpu_torch.nn.layers import TransformerEncoder
from multimodalvc_tpu_torch.parallel.sharding import LeafSpec, param_specs

from tests.fixtures import make_corpus

KEY = jax.random.PRNGKey(0)
MESHES = {"tensor2": {"tensor": 2}, "fsdp2_tensor2": {"fsdp": 2, "tensor": 2}}


def speech_batch(cfg, b=2):
    rng = np.random.default_rng(0)
    t_v = cfg.max_video_frames
    return {
        "audio_feats": rng.standard_normal((b, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
        .astype(np.float32),
        "video": rng.standard_normal((b, t_v, 24, 24, 1)).astype(np.float32),
        "video_lengths": np.resize([t_v, t_v // 2], b).astype(np.int32),
        "instruction": rng.integers(1, 200, (b, 4)).astype(np.int32),
        "audio_lengths": np.full((b,), cfg.max_mel_frames * 160, np.int32),
    }


def _speech_cfg(package, **over):
    return dataclasses.replace(package.SpeechConfig.tiny(), **over)


def _avsr():
    cfg = javsr.AVSRConfig.tiny()
    return (lambda: javsr.AVSRSystem(cfg).init(KEY, batch4(cfg)),
            lambda: tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu").module)


def _speech(jcls, tcls, extra=(), **over):
    def jax_init():
        cfg = _speech_cfg(jsp, **over)
        return jcls(cfg, *extra).init(KEY, {**speech_batch(cfg), "modality_mode": np.int32(0)})

    def port():
        targs = tuple(thg.HifiGanConfig(**VOCODER_GEN) for _ in extra)
        return tcls(_speech_cfg(tsp, **over), *targs, device="cpu")

    return jax_init, port


def _vocoder():
    gen = jhg.HifiGanConfig(**VOCODER_GEN)

    def jax_init():
        mel = np.zeros((2, 10, 128), np.float32)
        wav = np.zeros((2, 1600, 1), np.float32)
        return {"params": {
            "generator": jhg.HifiGanGenerator(gen).init(KEY, mel)["params"],
            "discriminator": jhg.HifiGanDiscriminator((2, 3), 3, 16).init(KEY, wav)["params"]}}

    def port():
        voc = tvoc.VocoderModel(tvoc.VocoderConfig(generator=thg.HifiGanConfig(**VOCODER_GEN),
                                                   disc_periods=(2, 3), disc_scales=3,
                                                   disc_channels_cap=16), device="cpu")
        voc.init_state(0)
        return torch.nn.ModuleDict({"generator": voc.generator,
                                    "discriminator": voc.discriminator})

    return jax_init, port


def _pretrain():
    def jax_init():
        cfg = jpre.AVHubertPretrainConfig.tiny()
        t = 8
        return jpre.AVHubertPretrainModel(cfg).init(
            {"params": KEY, "mask": KEY}, np.zeros((2, t, cfg.encoder.audio_feat_dim), np.float32),
            np.zeros((2, t, 24, 24, 1), np.float32), np.zeros((2, t), np.int32),
            np.full((2,), t, np.int32), train=True)

    return jax_init, lambda: tpre.AVHubertPretrainModel(tpre.AVHubertPretrainConfig.tiny())


TREES = {
    "avsr": _avsr,
    "nollm": lambda: _speech(jsp.SpeechNoLLMModel, lambda c, device: tsp.SpeechNoLLMSystem(
        c, device=device).module, modality_dropout=True),
    "llm_head": lambda: _speech(jsp.SpeechLLMModel, lambda c, device: tsp.SpeechLLMSystem(
        c, device=device).module),
    "e2e_generator": lambda: _speech(
        jsp.SpeechE2EModel, lambda c, v, device: tsp.SpeechE2ESystem(c, v, device=device).module,
        extra=(jhg.HifiGanConfig(**VOCODER_GEN),)),
    "vocoder": _vocoder,
    "avhubert_pretrain": _pretrain,
    "moe_conformer": lambda: _speech(jsp.SpeechNoLLMModel, lambda c, device: tsp.SpeechNoLLMSystem(
        c, device=device).module, conformer_moe_experts=4),
}


def _jax_mesh(sizes):
    shape = tuple(sizes.get(a, 1) for a in JAX_AXES)
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), JAX_AXES)


def jax_leaf_specs(params, sizes):
    """{port state_dict name: LeafSpec} of the JAX specs, each leaf named and
    its dims moved as the weight bridge moves them."""
    specs = infer_param_specs(params, _jax_mesh(sizes))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(leaves, spec_leaves, strict=True):
        keys = [str(getattr(k, "key", k)) for k in path]
        shape = tuple(leaf.shape)
        probe = np.empty(tuple(range(2, 2 + len(shape))))  # distinct dim sizes
        name, moved = _convert(keys[-1], probe)
        to_torch = [moved.shape.index(n) for n in probe.shape]
        dims = {axis: to_torch[i] for i, axis in enumerate(tuple(spec))
                if axis in ("tensor", "fsdp") and sizes.get(axis, 1) > 1}
        out[".".join(keys[:-1] + [name])] = LeafSpec(dims.get("tensor"), dims.get("fsdp"))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("tree", list(TREES))
def test_rules_split_what_the_jax_rules_split(tree, mesh):
    """Every leaf of the tree: the same tensor and fsdp dims as the JAX
    spec (the same leaves: the port's parameters are the JAX params)."""
    jax_init, port = TREES[tree]()
    params = jax.eval_shape(jax_init)["params"]
    want = jax_leaf_specs(params, MESHES[mesh])
    got = param_specs(port(), MESHES[mesh])
    assert set(got) == set(want)
    assert got == want
    if tree != "vocoder":
        assert any(s.tensor is not None for s in got.values())


def test_the_known_rule_quirks_are_kept():
    """The JAX rules' misses and accidental matches, ported as they are."""
    specs = param_specs(tsp.SpeechLLMSystem(_speech_cfg(tsp), device="cpu").module,
                        {"tensor": 2})
    q = "encoder.qformer.layers_0"
    assert specs[f"{q}.intermediate_query.weight"].tensor == 0  # "query": a column split
    assert specs[f"{q}.output_query.weight"].tensor == 0
    assert specs["encoder.avhubert.video_proj.weight"].tensor == 1  # "o_proj": a row split
    assert specs["llama.layers_0.self_attn.q_proj.base.weight"].tensor is None  # under base
    assert specs["llama.layers_0.mlp.down_proj.weight"].tensor is None
    assert specs["llama.layers_0.mlp.gate_proj.weight"].tensor == 0
    assert specs["llama.embed_tokens.weight"].tensor == 0
    assert specs["llama.layers_0.self_attn.q_proj.lora_b"] == LeafSpec()  # ends in "b"
    assert specs["head.conformer.blocks_0.ff.w_1.weight"].tensor is None  # w_1, not w1


# ---- four gloo ranks -----------------------------------------------------------------


def gan_tree(root, save_dir, task, mesh):
    tree = (e2e_tree if task == "e2e" else vocoder_tree)(root, str(save_dir))
    tree["mesh"] = mesh
    return tree


MIX_STEPS = 2


def encoder_files(tmp):
    """The sequence-parallel encoder's weights (the port's, random from seed
    0), input, lengths and output weights, as files."""
    rng = np.random.default_rng(8)
    enc = TransformerEncoder(32, 2, 4, 64, sequence_parallel=True)
    init_random_(enc, 0)
    torch.save(enc.state_dict(), tmp / "enc.pt")
    np.save(tmp / "enc_x.npy", rng.standard_normal((2, 64, 32)).astype(np.float32))
    np.save(tmp / "enc_len.npy", np.asarray([64, 40], np.int32))
    np.save(tmp / "enc_w.npy", rng.standard_normal((2, 64, 32)).astype(np.float32))
    return {k: str(tmp / f"enc{s}") for k, s in (("state", ".pt"), ("x", "_x.npy"),
                                                   ("lengths", "_len.npy"), ("w", "_w.npy"))}


GAN_MESHES = {"tensor": {"data": 2, "tensor": 2}, "replicas": {"data": 2, "sequence": 2}}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor4")
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = batch4(cfg)
    state = str(tmp / "avsr.pt")
    variables = tiny_variables(jsys, batch)
    torch.save(flax_to_state_dict(to_numpy_tree(variables)), state)
    np.savez(tmp / "batch.npz", **batch)
    root, _ = make_corpus(str(tmp / "corpus"), frame_sizes=(10, 14, 16))
    np.savez(tmp / "nollm.npz", **nollm_batch())
    enc = encoder_files(tmp)
    kw = dict(state=state, batch=str(tmp / "batch.npz"), opt=OPT, steps=STEPS)
    jobs = [("avsr_trainer:data", dict(kw, mesh={"data": 2, "sequence": 2})),
            ("avsr_trainer:data_tensor", dict(kw, mesh={"data": 2, "tensor": 2})),
            ("avsr_trainer:fsdp_tensor", dict(kw, mesh={"fsdp": 2, "tensor": 2}, fsdp_min=64)),
            ("avsr_pipeline", dict(mesh={"pipeline": 2, "tensor": 2}, state=state,
                                   batch=str(tmp / "batch.npz"), microbatches=2)),
            ("encoder_sp", dict(mesh={"sequence": 2, "tensor": 2}, **enc)),
            ("nollm_tensor", dict(mesh={"expert": 2, "tensor": 2}, batch=str(tmp / "nollm.npz"),
                                  opt=OPT, steps=MIX_STEPS, moe_experts=4))]
    jobs += [(f"cli_train:{task}_{m}", dict(tree=gan_tree(root, tmp / f"{task}_{m}", task, mesh),
                                            dropout=True))
             for task in ("e2e", "vocoder") for m, mesh in GAN_MESHES.items()]
    return {"ranks": spawn(tmp, 4, jobs), "tmp": tmp, "enc": enc, "jsys": jsys,
            "variables": variables, "batch": batch}


def test_the_data_run_is_the_jax_data_step(four):
    """The baseline of the mixed meshes below, {data 2, sequence 2} (the
    data-2 numbers, each batch held by two ranks), against the JAX Trainer
    on a {data: 2} mesh."""
    jm, jparams = _jax_run(four, {"data": 2})
    got = four["ranks"][0]["avsr_trainer:data"]
    for a, j in zip(got["metrics"], jm):
        np.testing.assert_allclose(a["loss"], float(j["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["gnorm"], float(j["gnorm"]), rtol=1e-4)
    for n, m in got["masters"].items():
        np.testing.assert_allclose(m.numpy(), jparams[n].numpy(), rtol=MASTER_RTOL, atol=1e-7,
                                   err_msg=n)


@pytest.mark.parametrize("mesh", ["data_tensor", "fsdp_tensor"])
def test_data2_tensor2_equals_the_data_run(four, mesh):
    """{data 2, tensor 2} and {fsdp 2, tensor 2} against {data 2, sequence
    2} (the data-2 numbers, each batch held by two ranks): the same losses,
    grad norms and masters (gathered), and each rank holds half the bytes
    of each tensor-split leaf (module weight, master and moments); under
    fsdp the master and moments of each fsdp-split leaf's slice halve
    again."""
    for rank in four["ranks"]:
        data, got = rank["avsr_trainer:data"], rank[f"avsr_trainer:{mesh}"]
        assert got["tensor_split"] and not data["tensor_split"]
        if mesh == "fsdp_tensor":
            assert got["split"] and 2 * got["held_bytes"] == got["whole_bytes"]
            assert set(got["split"]) & set(got["tensor_split"])  # both axes on one leaf
        else:
            assert all(2 * held == whole for held, whole in got["tensor_bytes"].values())
        for a, d in zip(got["metrics"], data["metrics"]):
            np.testing.assert_allclose(a["loss"], d["loss"], rtol=1e-6)
            np.testing.assert_allclose(a["gnorm"], d["gnorm"], rtol=1e-5)
            assert a["n_tokens"] == d["n_tokens"]
        for n, m in got["masters"].items():
            np.testing.assert_allclose(m.numpy(), data["masters"][n].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=n)


@pytest.mark.parametrize("task", ["e2e", "vocoder"])
def test_cli_gan_loops_run_on_a_tensor_mesh(four, task):
    """Both GAN loops of ``cli.train`` on {data 2, tensor 2}, dropout on:
    every rank logs the losses of the same loop on {data 2, sequence 2}
    (the data-2 run; the E2E trunk's split attention draws the whole
    dropout masks)."""
    for rank in four["ranks"]:
        got = rank[f"cli_train:{task}_tensor"]["train"]
        want = rank[f"cli_train:{task}_replicas"]["train"]
        assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
        for (_, g), (_, w) in zip(got, want):
            for k in GAN_TERMS:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def test_pipeline2_tensor2_pipelined_loss_gives_the_plain_loss(four):
    """The AVSR pipelined loss at {pipeline 2, tensor 2} (the LLaMA MLP and
    embedding split in each stage, the Q-Former in the encoders) and its
    trainable gradients against the plain loss of the whole batch."""
    for rank in four["ranks"]:
        got = rank["avsr_pipeline"]
        assert got["fn"].startswith("AVSRSystem.make_pipeline_loss_fn")
        np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=2e-4)
        for n, g in got["grads"].items():
            ref = got["ref_grads"][n]
            assert float(torch.linalg.norm(g - ref)) <= 1e-4 * float(
                torch.linalg.norm(ref)) + 1e-7, n
    assert any(float(g.abs().sum()) > 0 for n, g in four["ranks"][0]["avsr_pipeline"][
        "grads"].items() if n.startswith("encoder.qformer."))


def test_sequence2_tensor2_encoder_is_the_serial_encoder(four):
    """Ring attention on each rank's heads ({sequence 2, tensor 2}): the
    serial encoder's output and parameter gradients."""
    files = four["enc"]
    enc = TransformerEncoder(32, 2, 4, 64, sequence_parallel=True)
    enc.load_state_dict(torch.load(files["state"]))
    x, lens, w = (torch.from_numpy(np.load(files[k])) for k in ("x", "lengths", "w"))
    out = enc(x, lengths=lens)
    named = dict(enc.named_parameters())
    want = dict(zip(named, torch.autograd.grad((out * w).sum(), list(named.values()))))
    for rank in four["ranks"]:
        got = rank["encoder_sp"]
        np.testing.assert_allclose(got["out"].numpy(), out.detach().numpy(), atol=2e-5)
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=2e-5, err_msg=n)


def test_expert2_tensor2_moe_head_takes_the_one_process_steps(four):
    """The NoLLM head with an expert bank in each Conformer block at
    {expert 2, tensor 2} (two experts a rank, the attention on two heads),
    dropout on: the one-process steps."""
    one = nollm_steps(str(four["tmp"] / "nollm.npz"), OPT, MIX_STEPS, moe_experts=4)
    for rank in four["ranks"]:
        got = rank["nollm_tensor"]
        assert any(".conformer." in n for n in got["split"])
        for a, w in zip(got["metrics"], one["metrics"]):
            np.testing.assert_allclose(a["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["gnorm"], w["gnorm"], rtol=1e-4)
        for n, m in got["masters"].items():
            np.testing.assert_allclose(m.numpy(), one["masters"][n].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=n)
