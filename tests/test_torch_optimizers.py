"""The port's optimizers against the JAX ``build_optimizer`` on the same
gradients: each of the eight names of ``OptimizationConfig.optimizer`` with
two schedules, masked (a frozen leaf), clipped, accumulated over two
micro-steps, with one non-finite micro-step; a [128, 256] leaf (adafactor's
factored path) beside a small one; a ``state_dict`` resume equal to the
straight run; ``build_composite_optimizer`` against the JAX one."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity  # noqa: F401 (one torch thread)

from multimodalvc_tpu.config.configs import OptimizationConfig as JaxOptimizationConfig
from multimodalvc_tpu.runtime import trainer as jtrainer
from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.runtime import trainer as ttrainer

# each leaf within 1e-6 of its largest value after every update (both sides
# in f32; the orders of the sums differ; the largest error 7.5e-7, adamw's).
# The leaves start at 0.01 scale, so that five updates move them by about
# their own size and the gate sees the update, not the start
OPT_RTOL = 1e-6
SCHEDULES = {
    "cosine": dict(lr_scheduler="cosine", warmup_updates=2, max_update=10),
    "fixed": dict(lr_scheduler="fixed"),
}
# update_freq 2: 6 windows of 2 micro-steps, the NaN in the last one (after a
# skipped update optax's accumulator keeps the NaN, 0 * NaN, and skips every
# later update; the port's restarts from zero), so 5 updates apply
MICRO, NAN_AT, UPDATES = 12, 10, 5
SHAPES = {"w": (128, 256), "b": (5,), "frozen": (4, 3)}


def _config(name, schedule, **extra):
    return dict(lr=1e-2, optimizer=name, weight_decay=0.1, clip_norm=1.0, update_freq=2,
                adam_betas=(0.9, 0.98), **SCHEDULES[schedule], **extra)


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    init = {k: (0.01 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (3.0 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(MICRO)]
    grads[NAN_AT]["b"][1] = np.nan
    return init, grads


def _jax_run(kw, init, grads):
    """The JAX chain's params after each applied update."""
    params = {k: jnp.asarray(v) for k, v in init.items()}
    tx, mask = jtrainer.build_optimizer(JaxOptimizationConfig(**kw), params, ["^frozen"])
    assert not mask["frozen"]
    state, out = tx.init(params), []
    update = jax.jit(tx.update)
    for i, g in enumerate(grads):
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)
        if i % 2 == 1 and i != NAN_AT + 1:
            out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _port_opt(kw, init):
    master = {k: torch.tensor(v) for k, v in init.items() if k != "frozen"}
    return master, ttrainer.build_optimizer(OptimizationConfig(**kw), master)


def _port_run(kw, init, grads, opt=None, master=None, start=0):
    if opt is None:
        master, opt = _port_opt(kw, init)
    out = []
    for i, g in enumerate(grads[start:], start):
        moved = opt.update({k: torch.tensor(v) for k, v in g.items() if k != "frozen"}, master)
        assert moved == (i % 2 == 1 and i != NAN_AT + 1), i
        if moved:
            out.append({k: t.clone().numpy() for k, t in master.items()})
    return out, opt, master


def _close(got, want, what):
    for k, w in want.items():
        if k == "frozen":
            continue
        scale = np.abs(w).max()
        assert np.abs(got[k] - w).max() <= OPT_RTOL * scale, (what, k)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("name", ttrainer.OPTIMIZERS)
def test_optimizer_matches_optax(name, schedule):
    init, grads = _inputs()
    kw = _config(name, schedule)
    want = _jax_run(kw, init, grads)
    got, opt, master = _port_run(kw, init, grads)
    assert len(got) == len(want) == UPDATES
    for step, (g, w) in enumerate(zip(got, want)):
        _close(g, w, (name, schedule, step))
    assert opt.count == UPDATES and opt.total_notfinite == 1
    assert not np.array_equal(got[-1]["w"], init["w"])
    if name == "adafactor":  # the factored statistics of w, the full one of b
        st = opt.state_dict()
        assert st["v_row"]["w"].shape == (128,) and st["v_col"]["w"].shape == (256,)
        assert set(st["v"]) == {"b"}


@pytest.mark.parametrize("name", ttrainer.OPTIMIZERS)
def test_state_dict_resume_equals_straight_run(name):
    """Three windows, a state_dict through torch.save into a new optimizer,
    then the rest: the masters and every state tensor equal the straight
    run's bit for bit."""
    import io

    init, grads = _inputs(7)
    kw = _config(name, "cosine")
    straight, opt, _ = _port_run(kw, init, grads)
    _, first, master = _port_run(kw, init, grads[:6])
    buf = io.BytesIO()
    torch.save({"opt": first.state_dict(), "master": master}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=False)
    master2, second = _port_opt(kw, init)
    for k, t in master2.items():
        t.copy_(saved["master"][k])
    second.load_state_dict(saved["opt"])
    rest, second, master2 = _port_run(kw, init, grads, second, master2, start=6)
    for k in master2:
        assert np.array_equal(rest[-1][k], straight[-1][k]), k
    for kind in second.tensor_kinds():
        for n, t in second.state_dict()[kind].items():
            assert torch.equal(t, opt.state_dict()[kind][n]), (kind, n)


def test_factored_dims_follow_the_jax_layout():
    """optax factors over the two largest dims; on equal sizes it takes
    numpy's argsort order, which for an nn.Linear weight (torch [out, in],
    flax [in, out]) the port reads on the reversed shape."""
    assert ttrainer.factored_dims((128, 256)) == (0, 1)
    assert ttrainer.factored_dims((256, 128)) == (1, 0)
    assert ttrainer.factored_dims((127, 256)) is None
    assert ttrainer.factored_dims((256, 256)) == (0, 1)
    assert ttrainer.factored_dims((256, 256), reverse=True) == (1, 0)
    assert ttrainer.factored_dims((3, 256, 128), reverse=True) == (2, 1)


@pytest.mark.parametrize("default", [None, "sgd"])
def test_composite_optimizer_matches_jax(default):
    """Leaves routed by path regex (first match wins) to adam and sgd, the
    rest frozen or to the default, three updates each."""
    rng = np.random.default_rng(2)
    init = {"encoder.w": rng.standard_normal((4, 3)).astype(np.float32),
            "encoder.head.b": rng.standard_normal(3).astype(np.float32),
            "head.w": rng.standard_normal(5).astype(np.float32),
            "other.w": rng.standard_normal(2).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    tree = lambda d: {"encoder": {"w": d["encoder.w"], "head": {"b": d["encoder.head.b"]}},  # noqa: E731
                      "head": {"w": d["head.w"]}, "other": {"w": d["other.w"]}}
    jp = jax.tree.map(jnp.asarray, tree(init))
    tx = jtrainer.build_composite_optimizer(
        [("^encoder/", optax.adam(1e-2)), ("head/", optax.sgd(0.5))], jp,
        default=None if default is None else optax.sgd(0.1))
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, tree(g)), state, jp)
        jp = optax.apply_updates(jp, upd)
    master = {k: torch.tensor(v) for k, v in init.items()}
    opt = ttrainer.build_composite_optimizer(
        [("^encoder/", ttrainer.alias("adam", 1e-2)), ("head/", ttrainer.alias("sgd", 0.5))],
        master, default=None if default is None else ttrainer.alias("sgd", 0.1))
    for g in grads:
        opt.update({k: torch.tensor(v) for k, v in g.items()}, master)
    assert opt.labels == {"encoder.w": "g0", "encoder.head.b": "g0", "head.w": "g1",
                          "other.w": "default"}
    want = {"encoder.w": jp["encoder"]["w"], "encoder.head.b": jp["encoder"]["head"]["b"],
            "head.w": jp["head"]["w"], "other.w": jp["other"]["w"]}
    for k, w in want.items():
        np.testing.assert_allclose(master[k].numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    if default is None:
        assert np.array_equal(master["other.w"].numpy(), init["other.w"])
    assert set(opt.state_dict()) == ({"g0", "g1"} | ({"default"} if default else set()))
