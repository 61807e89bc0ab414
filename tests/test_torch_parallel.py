"""The port's parallel/ against the JAX package's, in one process: the mesh
axis resolution, the launch variables, the batch sharding, the Sinkhorn
routing and the MoE layer (forward and gradients) on one rank, the ring's
block step, the generator's restore on a data rank, the pipelined-loss switch at one pipeline stage, the pipeline
schedule without a mesh, and BMUF's recursion on one worker.  The
multi-rank checks are tests/test_torch_dist_*.py."""
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import avsr_batch
from torch_parity import jax_variables, max_err, randomize, t, to_numpy_tree

from multimodalvc_tpu import tasks as jtasks
from multimodalvc_tpu.data.batching import shard_batches as jshard
from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.parallel import bmuf as jbmuf
from multimodalvc_tpu.parallel import distributed as jdist
from multimodalvc_tpu.parallel import expert as jexpert
from multimodalvc_tpu.parallel import mesh as jmesh
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.data.batching import shard_batches
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_variables
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn.init import init_random_
from multimodalvc_tpu_torch.ops import ring_attention as tring
from multimodalvc_tpu_torch.parallel import bmuf as tbmuf
from multimodalvc_tpu_torch.parallel import distributed as tdist
from multimodalvc_tpu_torch.parallel import expert as texpert
from multimodalvc_tpu_torch.parallel import mesh as tmesh
from multimodalvc_tpu_torch.parallel.pipeline import microbatch, pipeline_apply, unmicrobatch

jring = importlib.import_module("multimodalvc_tpu.ops.ring_attention")

# f32: the MoE layer's output and gradients through the same ops (a few
# ulps); the routing decisions (argmax, positions) exactly
MOE_TOL = 2e-5

AXIS_CASES = [({"data": -1}, 8), ({"data": 2, "fsdp": -1}, 8), ({"pipeline": 2, "data": -1}, 4),
              ({"expert": 4}, 4), ({"sequence": 2, "data": 2}, 4), ({"data": -1, "fsdp": -1}, 4),
              ({"data": 3}, 4), ({"data": -1, "tensor": 3}, 4), ({"pipeline": 2}, 4)]


@pytest.mark.parametrize("requested,n", AXIS_CASES, ids=[str(i) for i in range(len(AXIS_CASES))])
def test_resolve_axis_sizes_matches_jax(requested, n):
    try:
        want = jmesh.resolve_axis_sizes(requested, n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0].split(" ")[0]):
            tmesh.resolve_axis_sizes(requested, n)
        return
    assert tmesh.resolve_axis_sizes(requested, n) == want
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER and tmesh.BATCH_AXES == jmesh.BATCH_AXES


LAUNCH_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
               "WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_JOB_ID", "SLURM_NTASKS",
               "SLURM_PROCID", "SLURM_LOCALID", "SLURM_JOB_NODELIST", "TPU_WORKER_HOSTNAMES",
               "MEGASCALE_COORDINATOR_ADDRESS")


def test_infer_init_args_matches_jax(monkeypatch):
    """The launches the JAX function reads as one process are one process
    here; torchrun's and SLURM's multi-process launches resolve to the same
    world, rank and address (the JAX side leaves SLURM to its cluster
    detection); the TPU-only variables start nothing."""
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert jdist.infer_init_args() is None and tdist.infer_init_args() is None
    for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "4"),
                 ("RANK", "3")):
        monkeypatch.setenv(k, v)
    j, p = jdist.infer_init_args(), tdist.infer_init_args()
    assert p["init_method"] == f"tcp://{j['coordinator_address']}"
    assert (p["world_size"], p["rank"], p["local_rank"]) == (j["num_processes"],
                                                             j["process_id"], 0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert jdist.infer_init_args() is None and tdist.infer_init_args() is None
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k)
    for k, v in (("SLURM_JOB_ID", "7"), ("SLURM_NTASKS", "8"), ("SLURM_PROCID", "5"),
                 ("SLURM_LOCALID", "1"), ("SLURM_JOB_NODELIST", "gpu[03-04,9]")):
        monkeypatch.setenv(k, v)
    assert jdist.infer_init_args() == {}
    assert tdist.infer_init_args() == {"init_method": "tcp://gpu03:29500", "world_size": 8,
                                       "rank": 5, "local_rank": 1}
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert jdist.infer_init_args() is None and tdist.infer_init_args() is None
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    assert jdist.infer_init_args() == {} and tdist.infer_init_args() is None
    # no launch, no group: one process, rank 0 the master
    assert tdist.distributed_init() == 1 and tdist.is_master()


@pytest.mark.parametrize("n_batches,shards,fill", [(7, 2, True), (7, 3, True), (8, 4, True),
                                                   (7, 3, False), (2, 4, True), (5, 1, True)])
def test_shard_batches_matches_jax(n_batches, shards, fill):
    batches = [np.arange(i, i + 3) for i in range(n_batches)]
    for r in range(shards):
        want = jshard(batches, shards, r, fill)
        got = shard_batches(batches, shards, r, fill)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        shard_batches(batches, shards, shards)


def test_sinkhorn_route_matches_jax():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((64, 4)).astype(np.float32)
    want = np.asarray(jexpert.sinkhorn_route(jnp.asarray(scores), n_iters=20))
    got = texpert.sinkhorn_route(t(scores), n_iters=20)
    assert max_err(want, got) < 1e-6
    np.testing.assert_allclose(got.sum(dim=1).numpy(), np.ones(64), atol=1e-3)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_layer_matches_jax_on_one_rank(capacity_factor):
    """The layer's output and its gradients (input and every weight) against
    the JAX layer on the same weights; at 0.5 a third of the tokens
    overflow and pass through."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jl = jexpert.BaseMoELayer(num_experts=4, ffn_dim=32, capacity_factor=capacity_factor)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(p, xx):
        return jnp.sum(jl.apply({"params": p}, xx) * w)

    out = jax.jit(jl.apply)(variables, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    tl = texpert.BaseMoELayer(16, 4, 32, capacity_factor)
    load_flax_variables(tl, to_numpy_tree(variables))
    h = t(x).requires_grad_(True)
    got = tl(h)
    (got * t(w)).sum().backward()
    assert max_err(out, got) < MOE_TOL
    assert max_err(gx, h.grad) < MOE_TOL
    want_g = flax_to_state_dict({"params": to_numpy_tree(gp)})
    for n, p in tl.named_parameters():
        assert max_err(want_g[n], p.grad) < MOE_TOL * max(1.0, float(want_g[n].abs().max())), n
    cap = max(int(-(-48 // 4) * capacity_factor), 1)
    assert int(tl.load["tokens"].sum()) + int(tl.load["overflow"]) == 48
    assert int(tl.load["tokens"].max()) <= cap
    assert (int(tl.load["overflow"]) > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_block_step_matches_jax(causal):
    """One ring step (the (m, l, acc) of a query chunk against a k / v block
    at other global offsets) against the JAX ``_block_attn``."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 8, 16)).astype(np.float32) for _ in range(3))
    kv_valid = np.asarray([20, 11], np.int32)[:, None, None, None]
    want = jring._block_attn(*(jnp.asarray(a) for a in (q, k, v)), 0.25, 16, 8,
                             jnp.asarray(kv_valid), causal)
    got = tring._block_attn(t(q), t(k), t(v), 0.25, 16, 8, t(kv_valid), causal)
    for a, b in zip(want, got):
        assert max_err(a, b) < 1e-5


def test_restore_generator_reseeds_through_the_generator_itself():
    """At batch-group rank 1 a restored state becomes a seed for the
    generator's own ``manual_seed``, so that a state of another size (a CUDA
    generator's 16 bytes, as a checkpoint written on the card holds) never
    reaches ``set_state``; at rank 0 the state is set as it is."""
    cuda_sized = torch.arange(16, dtype=torch.uint8)
    rank1 = tmesh.Mesh(tmesh.resolve_axis_sizes({"data": 2}, 2), rank=1)
    g = torch.Generator()
    tmesh.restore_generator_(g, cuda_sized, rank1)
    want = torch.Generator().manual_seed(int(cuda_sized.sum()) + tmesh.SEED_STRIDE)
    assert torch.equal(g.get_state(), want.get_state())
    saved = torch.Generator().manual_seed(7).get_state()
    rank0 = tmesh.Mesh(rank1.sizes, rank=0)
    tmesh.restore_generator_(g, saved, rank0)
    assert torch.equal(g.get_state(), saved)


def test_pipeline_without_a_mesh_runs_the_stage_in_turn():
    x = torch.randn(12, 3)
    mb = microbatch(x, 4)
    assert tuple(mb.shape) == (4, 3, 3) and torch.equal(unmicrobatch(mb), x)
    out = pipeline_apply(lambda h, m: torch.tanh(h) + m, [], mb, None)
    assert torch.equal(out, torch.stack([torch.tanh(mb[m]) + m for m in range(4)]))


def test_make_loss_fn_at_one_pipeline_stage_matches_jax(monkeypatch):
    """``pipeline_microbatches=4`` on one device: both tasks take the plain
    loss (the JAX task whenever the mesh has one pipeline stage), and the
    losses agree (dropout off on both sides, as tests/test_torch_cli.py)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(tavsr, "train_rng", lambda train, generator: None)
    jmesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    tmesh.make_mesh({"data": -1})
    jcfg, tcfg = javsr.AVSRConfig.tiny(), tavsr.AVSRConfig.tiny()
    jtask = jtasks.AVSRTask(jtasks.AVSRTaskConfig(pipeline_microbatches=4), jcfg)
    ttask = ttasks.AVSRTask(ttasks.AVSRTaskConfig(pipeline_microbatches=4), tcfg, device="cpu")
    batch = avsr_batch(jcfg)
    init_random_(ttask.module, 0)
    variables = randomize(jax_variables(jtask.system.init, batch, ttask.module))
    load_flax_variables(ttask.module, to_numpy_tree(variables))
    colls = {k: v for k, v in variables.items() if k != "params"}
    jloss, (jm, _) = jax.jit(jtask.make_loss_fn())(variables["params"], colls, batch,
                                                   jax.random.PRNGKey(1))
    fn = ttask.make_loss_fn()
    assert fn.__qualname__.startswith("AVSRSystem.make_trainer_loss_fn")
    tloss, tm = fn({k: t(v) for k, v in batch.items()}, torch.Generator())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert int(tm["n_tokens"]) == int(jm["n_tokens"])
    jmesh.make_mesh({"data": -1})


def test_bmuf_matches_reference_math():
    """One worker (no group): the block-momentum recursion of
    tests/test_bmuf.py's case, and the JAX transformation on the same steps
    with and without Nesterov."""
    for nesterov in (False, True):
        tx = jbmuf.bmuf(optax.sgd(0.1), sync_every=2, block_momentum=0.5, block_lr=1.0,
                        use_nesterov=nesterov, axis_name=None)
        jp = {"w": jnp.asarray(1.0)}
        state = tx.init(jp)
        params = {"w": torch.ones(())}

        class SGD:
            def update(self, grads, p):
                p["w"].sub_(0.1 * grads["w"])

        opt = tbmuf.BMUF(SGD(), params, sync_every=2, block_momentum=0.5, block_lr=1.0,
                         use_nesterov=nesterov)
        for _ in range(6):
            u, state = tx.update({"w": jnp.asarray(1.0)}, state, jp)
            jp = optax.apply_updates(jp, u)
            opt.update({"w": torch.ones(())}, params)
            np.testing.assert_allclose(float(params["w"]), float(jp["w"]), rtol=1e-6)
            np.testing.assert_allclose(float(opt.delta["w"]), float(state.delta["w"]),
                                       rtol=1e-6, atol=1e-9)
        if not nesterov:
            # the test_bmuf.py numbers after the first sync
            opt2 = tbmuf.BMUF(SGD(), {"w": torch.ones(())}, sync_every=2, block_momentum=0.5,
                              use_nesterov=False)
            p2 = {"w": torch.ones(())}
            opt2.global_params = {"w": torch.ones(())}
            for _ in range(2):
                opt2.update({"w": torch.ones(())}, p2)
            np.testing.assert_allclose(float(p2["w"]), 0.9, rtol=1e-6)
            np.testing.assert_allclose(float(opt2.delta["w"]), -0.1, rtol=1e-6)
