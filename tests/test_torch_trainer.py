"""The port's Trainer against the JAX Trainer(mesh=None) on the tiny AVSR
model (f32, the evaluation loss on both sides so that no dropout draw enters
the comparison): the eight learning-rate schedules step by step, five steps
with update_freq 1 and 2, a non-finite batch skipped as optax skips it, the
reduce-on-plateau scale, and a ~40-step overfit whose loss curve follows
JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import avsr_batch
from torch_parity import loaded, randomize, t, to_numpy_tree

from multimodalvc_tpu.config.configs import OptimizationConfig as JaxOptimizationConfig
from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.runtime import trainer as jtrainer
from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.interop.from_flax import state_dict_to_flax
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.runtime import trainer as ttrainer
from multimodalvc_tpu_torch.utils.wer import wer

# the schedules: the JAX ones are f32 (rtol 1e-6); the losses of two f32
# trainers on one graph agree to ~1e-7 relative a step (rtol 1e-5); each
# trainable leaf's change over the steps to rel L2 1e-3 (the largest in
# sound runs 8.2e-4, the Q-Former's first self-attention out_proj, where
# Adam's normalisation magnifies the gradients' rounding; the others under
# 1e-4), except the leaves the loss does not depend on in exact arithmetic
# (the Q-Former's attention key biases: softmax is shift-invariant), where
# Adam turns rounding noise of either sign into full steps; those move by at
# most lr a step.  The optimizer alone, on fixed gradients, to rel 1e-6
# (OPT_RTOL), where the weight decay moves a leaf by 1e-3 of itself.
SCHED_RTOL, LOSS_RTOL, PARAM_RTOL, OPT_RTOL = 1e-6, 1e-5, 1e-3, 1e-6
# the overfit: 40 steps at lr 3e-3; the two curves drift apart by the
# trainers' roundings compounded through Adam (rtol 1e-3 a step)
OVERFIT_STEPS, OVERFIT_RTOL = 40, 1e-3

SCHEDULES = {
    "cosine": dict(lr_scheduler="cosine", warmup_updates=3, max_update=20, min_lr=1e-5),
    "inverse_sqrt": dict(lr_scheduler="inverse_sqrt", warmup_updates=4),
    "tri_stage": dict(lr_scheduler="tri_stage", warmup_updates=3, max_update=20, min_lr=1e-6),
    "tri_stage_ratio": dict(lr_scheduler="tri_stage", max_update=20, phase_ratio=(0.2, 0.3, 0.5)),
    "polynomial": dict(lr_scheduler="polynomial", warmup_updates=3, max_update=20, min_lr=1e-5),
    "polynomial_no_warmup": dict(lr_scheduler="polynomial", warmup_updates=0, max_update=20),
    "triangular": dict(lr_scheduler="triangular", lr_period_updates=6, lr_shrink=0.5,
                       min_lr=1e-5),
    "manual": dict(lr_scheduler="manual", lr_milestones={"5": 3e-4, "12": 2e-5}),
    "fixed": dict(lr_scheduler="fixed"),
    "reduce_lr_on_plateau": dict(lr_scheduler="reduce_lr_on_plateau", warmup_updates=4),
}


def _jax_schedule(kw, steps):
    """The JAX trainer's schedule, read off its optimizer: plain SGD on one
    scalar with gradient 1 updates it by -lr(count)."""
    cfg = JaxOptimizationConfig(lr=1e-3, optimizer="sgd", clip_norm=0.0,
                                skip_nonfinite_grads=False, **kw)
    params = {"w": jnp.zeros(())}
    tx, _ = jtrainer.build_optimizer(cfg, params, [])
    state, out = tx.init(params), []
    for _ in range(steps):
        upd, state = tx.update({"w": jnp.ones(())}, state, params)
        out.append(-float(upd["w"]))
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    steps = 25
    want = _jax_schedule(SCHEDULES[name], steps)
    schedule = ttrainer.make_schedule(OptimizationConfig(lr=1e-3, **SCHEDULES[name]))
    got = [schedule(s) for s in range(steps)]
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=1e-12)


def test_adamw_steps_match_optax():
    """The optimizer alone against the JAX trainer's optax chain on fixed
    gradients: three updates with the cosine warmup, AdamW's decoupled
    weight decay at 0.1 and gradients whose global norm (over 5) is past the
    clip (1.0).  Every leaf agrees within OPT_RTOL of its largest value; the
    same run without weight decay lands 1e-4 of it away or more."""
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0, warmup_updates=2, max_update=10,
              adam_betas=(0.9, 0.98))
    rng = np.random.default_rng(5)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tx, _ = jtrainer.build_optimizer(JaxOptimizationConfig(**kw), jp, [])
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)

    def port(**extra):
        master = {k: torch.tensor(v) for k, v in init.items()}
        opt = ttrainer.build_optimizer(OptimizationConfig(**{**kw, **extra}), master)
        for g in grads:
            assert float(ttrainer.global_norm(torch.tensor(v) for v in g.values())) > 5.0
            assert opt.update({k: torch.tensor(v) for k, v in g.items()}, master)
        return master

    got, no_decay = port(), port(weight_decay=0.0)
    for k, want in jp.items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert np.abs(got[k].numpy() - want).max() <= OPT_RTOL * scale, k
        assert np.abs(no_decay[k].numpy() - want).max() >= 1e-4 * scale, k


@pytest.fixture(scope="module")
def tiny():
    cfg = javsr.AVSRConfig.tiny()
    jsys = javsr.AVSRSystem(cfg)
    batch = avsr_batch(cfg)
    variables = randomize(jsys.init(jax.random.PRNGKey(0), batch))
    # the leaves the loss does not depend on: their gradient is rounding noise
    tt, _ = _port_trainer(variables, {})
    loss, _ = tt.loss_fn({k: t(v) for k, v in batch.items()}, None)
    names = list(tt.params)
    grads = torch.autograd.grad(loss, [tt.params[n] for n in names], allow_unused=True)
    norms = {n: float(g.norm()) for n, g in zip(names, grads) if g is not None}
    total = sum(x * x for x in norms.values()) ** 0.5
    flat = {n for n, x in norms.items() if x < 1e-6 * total}
    return jsys, variables, batch, flat


def _jax_trainer(jsys, variables, kw):
    params = variables["params"]
    colls = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p, c, b, rng):
        loss, aux = jsys.module.apply({"params": p, **c}, b, train=False)
        acc = aux["n_correct"] / jnp.maximum(aux["n_valid"], 1)
        return loss, ({"accuracy": acc, "n_tokens": aux["n_valid"]}, c)

    return jtrainer.Trainer(loss_fn, params, colls, JaxOptimizationConfig(**kw), mesh=None,
                            frozen_patterns=jsys.frozen_patterns(), donate=False)


def _port_trainer(variables, kw):
    tsys = tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu")
    loaded(tsys.module, variables)

    def loss_fn(b, generator):
        loss, aux = tsys.module(b, train=False)
        return loss, {"accuracy": aux["n_correct"] / aux["n_valid"].clamp(min=1),
                      "n_tokens": aux["n_valid"]}

    return ttrainer.Trainer(loss_fn, tsys.module, OptimizationConfig(**kw),
                            frozen_patterns=tsys.frozen_patterns()), tsys


def _nan_batch(batch):
    bad = dict(batch)
    bad["audio_feats"] = batch["audio_feats"].copy()
    bad["audio_feats"][0, 0, 0] = np.nan
    return bad


def _compare_leaves(jt, tt, flat, steps, lr, init):
    """The port's trained leaves carried back into the JAX tree
    (``state_dict_to_flax``), held against the JAX trainer's leaf by leaf:
    each trainable leaf's change over the steps, and every frozen leaf
    unchanged on both sides."""
    template = to_numpy_tree(jt.state.params)
    frozen_sd = tt.module.state_dict()
    got = state_dict_to_flax({**frozen_sd, **tt.master}, template)
    start = state_dict_to_flax({**frozen_sd, **init}, template)
    flat = {n.replace(".", "/") for n in flat}
    leaves = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    for (path, w), (_, g), (_, g0), m in zip(leaves(template), leaves(got), leaves(start),
                                             jax.tree.leaves(jt.mask)):
        name = jtrainer.path_str(path)
        w, g, g0 = (np.asarray(x, np.float64) for x in (w, g, g0))
        if not m:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in flat:
            assert np.abs(g - w).max() <= 2 * steps * lr, name
        else:
            moved, err = np.linalg.norm(w - g0), np.linalg.norm(g - w)
            assert err <= PARAM_RTOL * moved + 1e-12, (name, err, moved)


TRAINER_CASES = {
    # step 2's batch holds a NaN: skipped as optax skips it
    "update_freq1_nonfinite_skipped": (dict(update_freq=1), 5, 2),
    "update_freq2": (dict(update_freq=2), 6, None),
}


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_trainer_matches_jax(tiny, case):
    jsys, variables, batch, flat = tiny
    extra, steps, nan_at = TRAINER_CASES[case]
    kw = dict(lr=1e-3, warmup_updates=2, max_update=10, **extra)
    jt, (tt, _) = _jax_trainer(jsys, variables, kw), _port_trainer(variables, kw)
    init = {n: m.clone() for n, m in tt.master.items()}
    for step in range(steps):
        b = _nan_batch(batch) if step == nan_at else batch
        jm = jt.train_step({k: jnp.asarray(v) for k, v in b.items()})
        tm = tt.train_step({k: t(v) for k, v in b.items()})
        if step == nan_at:
            assert np.isnan(tm["loss"]) and np.isnan(float(jm["loss"]))
        else:
            np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=LOSS_RTOL)
            np.testing.assert_allclose(tm["gnorm"], float(jm["gnorm"]), rtol=1e-4)
            assert tm["n_tokens"] == int(jm["n_tokens"]) == 12
    assert tt.step == int(jt.state.step) == steps
    if nan_at is not None:
        # the skipped step advanced neither optax's count nor the port's
        assert tt.optimizer.total_notfinite == int(jt.state.opt_state.total_notfinite) == 1
        assert tt.optimizer.count == steps - 1
    if extra["update_freq"] == 2:
        assert tt.optimizer.gradient_step == int(jt.state.opt_state.gradient_step) == steps // 2
        assert tt.optimizer.count == steps // 2
    _compare_leaves(jt, tt, flat, steps, kw["lr"], init)


def test_nonfinite_steps_in_a_row_raise(tiny):
    """More than 25 consecutive non-finite steps raise (where optax would
    apply the non-finite update)."""
    _, variables, batch, _ = tiny
    tt, _ = _port_trainer(variables, dict(lr=1e-3, warmup_updates=2, max_update=10))
    tt.optimizer.notfinite_count = ttrainer.MAX_CONSECUTIVE_NONFINITE
    with pytest.raises(FloatingPointError):
        tt.train_step({k: t(v) for k, v in _nan_batch(batch).items()})


@pytest.mark.parametrize("maximize", [False, True])
def test_plateau_scale_matches_jax(maximize):
    """reduce_lr_on_plateau: the host-side decisions over a run of
    validation values, the scale and best they keep (JAX's
    ``plateau_update_state`` on its optimizer's state), and the scale on the
    update (optax's ``scale_by_plateau``: the update times the scale)."""
    kw = dict(lr=1e-3, lr_scheduler="reduce_lr_on_plateau", warmup_updates=1, lr_patience=1,
              lr_shrink=0.5, max_update=10, plateau_maximize=maximize)
    params = {"w": jnp.ones((3,))}
    jcfg = JaxOptimizationConfig(**kw)
    tx, _ = jtrainer.build_optimizer(jcfg, params, [])
    jstate = tx.init(params)
    opt = ttrainer.build_optimizer(OptimizationConfig(**kw), {"w": torch.ones(3)})
    # three plateaus of 2, 3 and 4 validations: patience 1 shrinks twice
    values = [1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 3.0]
    for value in (v if maximize else 6.0 - v for v in values):
        jstate, jscale = jtrainer.plateau_update_state(jstate, value, jcfg)
        assert opt.plateau_update(value) == pytest.approx(jscale, rel=1e-7)
    assert opt.plateau["scale"] == 0.25
    # one update at scale 0.125 moves a leaf 0.125 times as far as at 1
    grads = {"w": torch.tensor([0.5, -1.0, 2.0])}
    moved = []
    for scale in (1.0, 0.125):
        twin = ttrainer.build_optimizer(OptimizationConfig(**kw), {"w": torch.zeros(3)})
        twin.count, twin.plateau["scale"] = 1, scale
        w = torch.zeros(3)
        twin.update(grads, {"w": w})
        moved.append(w)
    assert bool((moved[0] != 0).all())
    torch.testing.assert_close(moved[1], moved[0] * 0.125, rtol=1e-6, atol=0)


def test_overfit_follows_jax(tiny):
    """~40 steps on one batch (the mms-llama optimizer at lr 3e-3): the
    port's loss falls and follows the JAX curve at every step; afterwards
    both predict the same label tokens (teacher-forced argmax), scored with
    the WER of their token strings against each other and the labels."""
    jsys, variables, batch, _ = tiny
    kw = dict(lr=3e-3, warmup_updates=2, max_update=OVERFIT_STEPS, adam_betas=(0.9, 0.98),
              weight_decay=0.01, clip_norm=1.0)
    jt, (tt, tsys) = _jax_trainer(jsys, variables, kw), _port_trainer(variables, kw)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, {k: t(v) for k, v in batch.items()}
    curve = []
    for _ in range(OVERFIT_STEPS):
        want = float(jt.train_step(jb)["loss"])
        got = tt.train_step(tb)["loss"]
        curve.append(got)
        np.testing.assert_allclose(got, want, rtol=OVERFIT_RTOL)
    assert curve[-1] < 0.5 * curve[0]
    params = {"params": jt.state.params,
              **{k: v for k, v in variables.items() if k != "params"}}
    _, jaux = jax.jit(lambda v, b: jsys.module.apply(v, b, train=False))(params, jb)
    with torch.no_grad():
        _, taux = tsys.module(tb, train=False)

    def texts(logits, labels):
        pred = np.asarray(logits)[:, :-1].argmax(-1)
        lab = np.asarray(labels)[:, 1:]
        return ([" ".join(map(str, p[l != -100])) for p, l in zip(pred, lab)],
                [" ".join(map(str, l[l != -100])) for l in lab])

    jhyp, refs = texts(jaux["logits"], jaux["labels"])
    thyp, _ = texts(taux["logits"].numpy(), taux["labels"].numpy())
    assert wer(thyp, jhyp)[0] == 0.0
    assert wer(thyp, refs) == wer(jhyp, refs)
