"""The speech heads' training against the JAX package's, in f32 at the tiny
configurations: the Conformer in training (BatchNorm on batch statistics
over a buffer with padded frames, flax's running-statistics update) against
``apply(..., mutable=["batch_stats"])``; the Conformer's dropout sites by
their kept share and scale; and ``SpeechTask`` "nollm" and "llm" through the
port's ``Trainer`` against the JAX ``Trainer``, three steps with the same
modality modes, every dropout rate at 0 on both sides (their random streams
differ), the losses step by step, the leaves and the running statistics
after, the frozen leaves unchanged."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_speech import _batch
from torch_parity import loaded, max_err, randomize, t, to_numpy_tree

from multimodalvc_tpu import tasks as jtasks
from multimodalvc_tpu.config.configs import OptimizationConfig as JaxOptimizationConfig
from multimodalvc_tpu.models import speech as jsp
from multimodalvc_tpu.nn import conformer as jconf
from multimodalvc_tpu.runtime import trainer as jtrainer
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from multimodalvc_tpu_torch.models import speech as tsp
from multimodalvc_tpu_torch.nn import conformer as tconf
from multimodalvc_tpu_torch.nn import layers as tlayers
from multimodalvc_tpu_torch.runtime.trainer import Trainer

# f32 through two Conformer blocks in training: outputs to 1e-4 absolute (O(1)
# values), the running statistics to 1e-5 (a tenth of a batch mean each); the
# gradient of a loss through the batch statistics to 1e-4 of its norm.  The
# trainers: the first step's gradients (video-only mode) to rel L2 1e-4 over
# all trainable leaves and per leaf to 1e-4 of the leaf's norm plus 1e-5 of
# the whole gradient's (measured: 1.7e-5 whole, a leaf at most 1.6e-5 of the
# whole; the audio-visual mode agrees to 1.6e-6); each step's loss
# to rel 1e-5; the change of the trainable leaves over the three steps to rel
# L2 1e-3 (test_torch_trainer.py's bound) and each leaf's to 1e-2 of its own
# move plus 1e-4 of the whole: Adam's normalisation turns the rounding of
# gradient elements that cancel to ~1e-5 of the gradient's scale into
# visible steps (the last block's FFN moved 1.46e-3 of itself apart from
# gradients that agree to 7e-7); the leaves the loss does not depend on in
# exact arithmetic (the attention key biases, the conv biases before a
# BatchNorm on batch statistics) move by at most lr a step; the running
# statistics to 1e-4.  Adam's eps is 1e-5 here (the default 1e-8 turns
# elements whose gradient is rounding-sized into full lr-sized steps of
# either sign, and the LLM-conditioned head's FFNs then part by 5e-3 of
# their move; the optimizer alone is held to optax at the default in
# test_torch_trainer.py).
TOL, STATS_TOL, GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5, 1e-4, 1e-5
LOSS_RTOL, PARAM_RTOL, LEAF_RTOL, PARAM_FLOOR, TRAIN_STATS_TOL = 1e-5, 1e-3, 1e-2, 1e-4, 1e-4
SMALL = dict(num_blocks=2, attention_dim=48, attention_heads=4, linear_units=96, cnn_kernel=7)
STEPS = 3
OPT = dict(lr=2e-3, lr_scheduler="cosine", warmup_updates=2, max_update=10, clip_norm=1.0,
           adam_eps=1e-5)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax's Dropout as the identity (the trainers' train=True forwards)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def zero_dropout(module: torch.nn.Module) -> None:
    """Every dropout rate of the port's module set to 0."""
    for m in module.modules():
        for attr in ("dropout", "dropout_rate"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)


def _check_stats(want, old, sd, tol) -> None:
    """The port's running statistics (``sd``) against the JAX batch_stats
    ``want``; the Conformer's moved away from ``old`` (the frozen encoders'
    BatchNorms stay on their running statistics in training, on both
    sides)."""
    old = dict(jax.tree_util.tree_flatten_with_path(to_numpy_tree(old))[0])
    for path, stat in jax.tree_util.tree_flatten_with_path(to_numpy_tree(want))[0]:
        names = [p.key for p in path]
        key = ".".join(names[:-1]) + (".running_mean" if names[-1] == "mean" else ".running_var")
        assert max_err(stat, sd[key]) < tol, key
        if "conformer" in key:
            assert np.abs(stat - old[path]).max() > 100 * tol, key


def _conformers(dropout_rate=0.0):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 40)).astype(np.float32)
    lens = np.asarray([40, 23], np.int32)
    jm = jconf.ConformerEncoder(jconf.ConformerConfig.sized("S", dropout_rate=0.0, **SMALL))
    variables = randomize(jax.jit(lambda k: jm.init(k, jnp.asarray(x), lengths=jnp.asarray(lens)))(
        jax.random.PRNGKey(0)))
    tm = loaded(tconf.ConformerEncoder(tconf.ConformerConfig.sized(
        "S", dropout_rate=dropout_rate, **SMALL), 40), variables)
    return jm, variables, tm, x, lens


def test_conformer_training_matches_jax():
    """Batch statistics over all 80 frames (17 of row 1 padded), the running
    statistics moved as 0.9 ra + 0.1 batch with the biased variance, and the
    gradient through the statistics."""
    jm, variables, tm, x, lens = _conformers()

    def jloss(params, x):
        out, new = jm.apply({**variables, "params": params}, x, lengths=jnp.asarray(lens),
                            deterministic=False, mutable=["batch_stats"])
        return (out * out).mean(), (out, new)

    (jl, (want, new)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], jnp.asarray(x))
    params = dict(tm.named_parameters())
    out = tm(t(x), lengths=t(lens), train=True)
    loss = (out * out).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    assert max_err(want, out) < TOL
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _check_stats(new["batch_stats"], variables["batch_stats"], tm.state_dict(), STATS_TOL)
    want_g = state_dict_to_flax(dict(zip(params, grads)), to_numpy_tree(jgrads))
    flat_w = np.concatenate([np.ravel(a) for a in jax.tree.leaves(to_numpy_tree(jgrads))])
    flat_g = np.concatenate([np.ravel(a) for a in jax.tree.leaves(want_g)])
    assert np.linalg.norm(flat_g - flat_w) <= GRAD_RTOL * np.linalg.norm(flat_w)
    # evaluation leaves the running statistics and uses them
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tm(t(x), lengths=t(lens))
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())


def test_conformer_dropout_sites():
    """In training every site drops at the configured rate: the kept share
    of each mask (over the nonzero inputs: half a ReLU's are zero) is 1 -
    rate within five binomial sigmas and the kept values are scaled by 1 /
    (1 - rate); one draw at the positional encoding, seven
    a block (the two FFN insides, the four residual branches, the attention
    output); evaluation draws nothing."""
    rate = 0.1
    *_, tm, x, lens = _conformers(dropout_rate=rate)
    calls = []
    real = tlayers.dropout

    def spy(h, r, rng):
        out = real(h, r, rng)
        if rng is not None and r > 0:
            nonzero = h != 0
            kept = (out != 0) & nonzero
            n = int(nonzero.sum())
            calls.append((float(kept.sum()) / n, n, h[kept], out[kept]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        for mod in (tconf, tlayers):
            mp.setattr(mod, "dropout", spy)
        with torch.no_grad():
            tm(t(x), lengths=t(lens), train=True, dropout_rng=torch.Generator().manual_seed(0))
            assert len(calls) == 1 + 7 * SMALL["num_blocks"]
            tm(t(x), lengths=t(lens))
    assert len(calls) == 1 + 7 * SMALL["num_blocks"]
    for share, n, before, after in calls:
        assert abs(share - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
        torch.testing.assert_close(after, before / (1 - rate), rtol=1e-6, atol=0)


def _jax_task(variant):
    cfg = jsp.SpeechConfig.tiny()
    return jtasks.SpeechTask(jtasks.SpeechTaskConfig(variant=variant), cfg)


def _speech_batch(cfg, seed=0):
    batch = _batch(cfg)
    rng = np.random.default_rng(seed + 10)
    batch["target_mel"] = rng.standard_normal((2, cfg.max_mel_frames - 6, 128)).astype(np.float32)
    batch["target_mel_lengths"] = np.asarray([cfg.max_mel_frames - 6, 31], np.int32)
    return batch


def _compare_leaves(jt, tt, flat, init):
    """Each trainable leaf's change over the steps against the JAX trainer's
    (to LEAF_RTOL of its own move plus PARAM_FLOOR of the whole move), the
    whole change to PARAM_RTOL, every frozen leaf unchanged on both
    sides."""
    template = to_numpy_tree(jt.state.params)
    frozen_sd = tt.module.state_dict()
    got = state_dict_to_flax({**frozen_sd, **tt.master}, template)
    start = state_dict_to_flax({**frozen_sd, **init}, template)
    leaves = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    rows = []
    for (path, w), (_, g), (_, g0), m in zip(leaves(template), leaves(got), leaves(start),
                                             jax.tree.leaves(jt.mask)):
        name = jtrainer.path_str(path)
        w, g, g0 = (np.asarray(x, np.float64) for x in (w, g, g0))
        if not m:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in flat:
            assert np.abs(g - w).max() <= 2 * STEPS * OPT["lr"], name
        else:
            rows.append((name, np.linalg.norm(w - g0), np.linalg.norm(g - w)))
    total = np.sqrt(sum(moved ** 2 for _, moved, _ in rows))
    assert np.sqrt(sum(err ** 2 for *_, err in rows)) <= PARAM_RTOL * total
    for name, moved, err in rows:
        assert err <= LEAF_RTOL * moved + PARAM_FLOOR * total, (name, err, moved)


@pytest.mark.parametrize("variant", ["nollm", "llm"])
def test_speech_task_training_matches_jax(no_jax_dropout, variant):
    jtask = _jax_task(variant)
    cfg = jtask.model_cfg
    batch = _speech_batch(cfg)
    variables = randomize(jax.jit(lambda k, b: jtask.module.init(k, b))(
        jax.random.PRNGKey(0), {**batch, "modality_mode": np.int32(0)}))
    params = variables["params"]
    colls = {k: v for k, v in variables.items() if k != "params"}
    jt = jtrainer.Trainer(jtask.make_loss_fn(), params, colls, JaxOptimizationConfig(**OPT),
                          mesh=None, frozen_patterns=jtask.frozen_patterns(), donate=False)

    ttask = ttasks.SpeechTask(ttasks.SpeechTaskConfig(variant=variant), tsp.SpeechConfig.tiny(),
                              device="cpu")
    assert ttask.model_cfg.modality_dropout == cfg.modality_dropout == (variant == "nollm")
    loaded(ttask.module, variables)
    zero_dropout(ttask.module)
    tt = Trainer(ttask.make_loss_fn(), ttask.module, OptimizationConfig(**OPT),
                 ttask.frozen_patterns())
    assert ttask.frozen_patterns() == jtask.frozen_patterns()
    frozen = {n: x.clone() for n, x in tt.module.named_parameters() if n not in tt.master}
    assert frozen and all(not x.requires_grad for n, x in tt.module.named_parameters()
                          if n in frozen)
    init = {n: m.clone() for n, m in tt.master.items()}

    # the first step's gradients (a training forward whose move of the
    # running statistics is undone) against the JAX gradients of the same
    # loss; the leaves whose gradient is rounding noise: the attention key
    # biases (softmax is shift-invariant) and the conv bias before each
    # BatchNorm (batch statistics take the mean out)
    buffers = {n: b.clone() for n, b in ttask.module.named_buffers()}
    probe = {**batch, "modality_mode": np.int32(1)}
    jloss = jtask.make_loss_fn()
    want = flax_to_state_dict({"params": to_numpy_tree(jax.jit(jax.grad(lambda p: jloss(
        p, colls, {k: jnp.asarray(v) for k, v in probe.items()}, jax.random.PRNGKey(1))[0]))(
        params))})
    loss, _ = ttask.make_loss_fn()({k: t(v) for k, v in probe.items()}, torch.Generator())
    names = list(tt.params)
    grads = dict(zip(names, torch.autograd.grad(loss, [tt.params[n] for n in names],
                                                allow_unused=True)))
    total = float(torch.cat([want[n].reshape(-1) for n in names]).norm())
    errs = {n: float(((torch.zeros_like(want[n]) if g is None else g) - want[n]).norm())
            for n, g in grads.items()}
    assert sum(e * e for e in errs.values()) ** 0.5 <= GRAD_RTOL * total
    for n, e in errs.items():
        assert e <= GRAD_RTOL * float(want[n].norm()) + GRAD_FLOOR * total, n
    flat = {n.replace(".", "/") for n, g in grads.items()
            if g is None or float(g.norm()) < 1e-6 * total}
    assert any(n.endswith("depthwise_conv/bias") for n in flat)
    with torch.no_grad():
        for n, b in ttask.module.named_buffers():
            b.copy_(buffers[n])

    for _ in range(STEPS):
        jb = jtask.prepare_batch(batch)
        tb = ttask.prepare_batch({k: t(v) for k, v in batch.items()})
        if variant == "nollm":  # the same draws of default_rng(7)
            assert int(tb["modality_mode"]) == int(jb["modality_mode"])
        jm = jt.train_step({k: jnp.asarray(v) for k, v in jb.items()})
        tm = tt.train_step(tb)
        assert set(tm) == {"loss", "mel_l1", "gnorm"}
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["mel_l1"], float(jm["mel_l1"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["gnorm"], float(jm["gnorm"]), rtol=1e-4)
    _compare_leaves(jt, tt, flat, init)
    assert all(torch.equal(x, frozen[n]) for n, x in tt.module.named_parameters() if n in frozen)
    # the running statistics took three batch-statistics updates on both sides
    _check_stats(jt.state.collections["batch_stats"], colls["batch_stats"],
                 tt.module.state_dict(), TRAIN_STATS_TOL)
    # validation: the criterion at evaluation, mcd and ssim beside the L1
    metrics = ttask.valid_step_fn()(ttask.prepare_batch({k: t(v) for k, v in batch.items()},
                                                        train=False))
    assert set(metrics) == {"loss", "mel_l1", "mcd", "ssim"}
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_speech_trainer_checkpoint_resumes_running_statistics(tmp_path):
    """A slim checkpoint (no frozen leaves) of a NoLLM training run holds the
    Conformer's running statistics: a fresh trainer restored from it takes
    the next step bit for bit as the one that went on."""
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    cfg = tsp.SpeechConfig.tiny()
    batch = {k: t(v) for k, v in _speech_batch(cfg).items()}

    def make():
        task = ttasks.SpeechTask(ttasks.SpeechTaskConfig(), tsp.SpeechConfig.tiny(), device="cpu")
        task.init_random(2)
        return task, Trainer(task.make_loss_fn(), task.module, OptimizationConfig(**OPT),
                             task.frozen_patterns(), seed=4)

    task, a = make()
    for _ in range(2):
        a.train_step(task.prepare_batch(batch))
    manager = CheckpointManager(str(tmp_path / "speech"))
    manager.save(a.state_dict(include_frozen=False), a.step)
    assert any(k.endswith("conv_module.norm.running_var") for k in manager.restore()["model"])
    _, b = make()
    b.load_state_dict(manager.restore())
    tb = task.prepare_batch(batch)
    assert a.train_step(tb) == b.train_step(tb)
    for (n, x), y in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(x, y), n
