"""AV-HuBERT masked-prediction pretraining against the JAX package, in f32 at
the tiny configuration: the model's losses, masked accuracy and mask count
on the same span-mask uniforms (the JAX draw is replaced by the uniforms
the port's draw is given: the two RNGs cannot replay each other); the
unmasked evaluation (its accuracy is ``acc_masked``, 0, as in the JAX
task); the ``output_layer`` features; and ``AVHubertPretrainTask`` through
the port's ``Trainer`` against the JAX ``Trainer(mesh=None)``, two steps on
the same masks: the losses, the moved leaves and the ResNet's running
statistics.  The pretraining tree crosses the weight bridge as it is
(``mask_emb``, ``label_embs_concat``, ``final_proj``, ``audio_proj`` and
the ResNet's ``batch_stats``)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t, to_numpy_tree

from multimodalvc_tpu import tasks as jtasks
from multimodalvc_tpu.config.configs import OptimizationConfig as JaxOptimizationConfig
from multimodalvc_tpu.models import avhubert_pretrain as jpre
from multimodalvc_tpu.ops import masking as jmask
from multimodalvc_tpu.runtime import trainer as jtrainer
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.config import registry as tregistry
from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from multimodalvc_tpu_torch.models import avhubert_pretrain as tpre
from multimodalvc_tpu_torch.ops import masking as tmask
from multimodalvc_tpu_torch.runtime.trainer import Trainer

# f32 through the ResNet, two transformer layers and the cosine logits at
# temperature 0.1 (logits up to 10): the losses to rel 1e-5, features to
# 1e-4 of O(1) values (test_torch_encoders.py's TOL).  The trainers (Adam's
# eps 1e-5, as test_torch_speech_train.py explains): each step's loss to rel
# 1e-5, gnorm to rel 1e-4, the leaves' move over the steps to rel L2 1e-3
# and each leaf's to 1e-2 of its own move plus 1e-4 of the whole; the
# running statistics to 1e-4.
TOL, LOSS_RTOL, PARAM_RTOL, LEAF_RTOL, PARAM_FLOOR, STATS_TOL = 1e-4, 1e-5, 1e-3, 1e-2, 1e-4, 1e-4
OPT = dict(lr=2e-3, lr_scheduler="polynomial", warmup_updates=1, max_update=10, clip_norm=1.0,
           adam_eps=1e-5)
B, T, LENGTHS = 2, 12, [12, 8]


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    cfg = tpre.AVHubertPretrainConfig.tiny()
    return {
        "audio": rng.standard_normal((B, T, 104)).astype(np.float32),
        "video": rng.standard_normal((B, T, 24, 24, 1)).astype(np.float32),
        "targets": rng.integers(0, cfg.num_classes, (B, T)).astype(np.int32),
        "lengths": np.asarray(LENGTHS, np.int32),
    }


def _uniforms(seed=0):
    cfg = tpre.AVHubertPretrainConfig.tiny()
    n = tmask.num_spans(T, cfg.mask_prob, cfg.mask_length)
    return np.random.default_rng(seed + 100).random((B, n)).astype(np.float32)


@pytest.fixture
def same_masks(monkeypatch):
    """Both packages' span masks from the uniforms ``_uniforms()``: the JAX
    function's draw (its ``jax.random.uniform``) and the port's
    ``span_uniforms`` return them."""
    u = _uniforms()
    shim = types.SimpleNamespace(random=types.SimpleNamespace(
        split=jax.random.split, uniform=lambda key, shape: jnp.asarray(u)))
    monkeypatch.setattr(jmask, "jax", shim)
    monkeypatch.setattr(tpre, "span_uniforms", lambda g, b, t_, p, L: torch.from_numpy(u))
    return u


def _variables(batch):
    jm = jpre.AVHubertPretrainModel(jpre.AVHubertPretrainConfig.tiny())
    init = jax.jit(lambda k, b: jm.init({"params": k, "mask": k}, b["audio"], b["video"],
                                        b["targets"], b["lengths"], train=True))
    return jm, randomize(init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))


def _port(variables):
    tm = tpre.AVHubertPretrainModel(tpre.AVHubertPretrainConfig.tiny())
    sd = flax_to_state_dict(to_numpy_tree(variables))
    for name in ("mask_emb", "label_embs_concat", "final_proj.weight", "audio_proj.weight",
                 "video_resnet.frontend_bn.running_var"):
        assert name in sd, name
    return loaded(tm, variables)


def test_registered_under_the_jax_names():
    assert tregistry.lookup("task", "avhubert_pretraining")[0] is ttasks.AVHubertPretrainTask
    cls, cfg_cls = tregistry.lookup("model", "av_hubert_pretrain")
    assert cls is tpre.AVHubertPretrainSystem and cfg_cls is tpre.AVHubertPretrainConfig
    assert ttasks.AVHubertPretrainTask(ttasks.AVHubertPretrainTaskConfig(),
                                       tpre.AVHubertPretrainConfig.tiny(),
                                       device="cpu").frozen_patterns() == []


def test_pretrain_losses_match_jax(same_masks):
    """The training forward (batch statistics, the given masks): the masked
    and unmasked losses, the count of masked frames, the masked accuracy,
    the mask and the moved running statistics; then the evaluation forward
    (no mask: the loss over all valid frames, accuracy 0)."""
    batch = _batch()
    jm, v = _variables(batch)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    want, new = jax.jit(lambda v, b: jm.apply(v, b["audio"], b["video"], b["targets"],
                                              b["lengths"], train=True,
                                              rngs={"mask": jax.random.PRNGKey(1)},
                                              mutable=["batch_stats"]))(v, jb)
    tm = _port(v)
    got = tm(t(batch["audio"]), t(batch["video"]), t(batch["targets"]), t(batch["lengths"]),
             train=True, generator=torch.Generator())
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert 0 < int(got["n_masked"]) == int(want["n_masked"]) < sum(LENGTHS)
    for key in ("loss_masked", "loss_unmasked", "acc_masked"):
        np.testing.assert_allclose(float(got[key].detach()), float(want[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    sd = tm.state_dict()
    for path, stat in jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0]:
        names = [p.key for p in path]
        key = ".".join(names[:-1]) + (".running_mean" if names[-1] == "mean" else ".running_var")
        assert max_err(stat, sd[key]) < 1e-5, key
    with pytest.raises(ValueError, match="generator"):
        tm(t(batch["audio"]), t(batch["video"]), t(batch["targets"]), t(batch["lengths"]))

    v = {**v, **new}
    want = jax.jit(lambda v, b: jm.apply(v, b["audio"], b["video"], b["targets"], b["lengths"],
                                         train=False))(v, jb)
    with torch.no_grad():
        got = tm(t(batch["audio"]), t(batch["video"]), t(batch["targets"]), t(batch["lengths"]),
                 train=False)
    assert not got["mask"].any() and float(got["acc_masked"]) == float(want["acc_masked"]) == 0.0
    np.testing.assert_allclose(float(got["loss_unmasked"]), float(want["loss_unmasked"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_output_layer_features_match_jax(layer):
    """The feature-dump forward: no mask, the front end (0) or the state
    after layer N without the final LayerNorm."""
    batch = _batch(1)
    jm, v = _variables(batch)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    want = jax.jit(lambda v, b: jm.apply(v, b["audio"], b["video"], b["targets"], b["lengths"],
                                         train=False, output_layer=layer))(v, jb)
    with torch.no_grad():
        got = _port(v)(t(batch["audio"]), t(batch["video"]), t(batch["targets"]),
                       t(batch["lengths"]), train=False, output_layer=layer)
    assert got.shape == (B, T, 64)
    assert max_err(want, got) < TOL


def test_pretrain_task_steps_match_jax(same_masks):
    """Two ``AVHubertPretrainTask`` training steps through each package's
    Trainer on the same batch and masks: loss, loss_masked, acc_masked and
    gnorm a step, the leaves' move, the running statistics; then the
    validation step's metrics."""
    batch = _batch(2)
    jtask = jtasks.AVHubertPretrainTask(jtasks.AVHubertPretrainTaskConfig(loss_unmasked_weight=0.5),
                                        jpre.AVHubertPretrainConfig.tiny())
    variables = randomize(jtask.init_variables(jax.random.PRNGKey(0),
                                               {k: jnp.asarray(x) for k, x in batch.items()}))
    params = variables["params"]
    colls = {k: x for k, x in variables.items() if k != "params"}
    jt = jtrainer.Trainer(jtask.make_loss_fn(), params, colls, JaxOptimizationConfig(**OPT),
                          mesh=None, frozen_patterns=jtask.frozen_patterns(), donate=False)
    ttask = ttasks.AVHubertPretrainTask(ttasks.AVHubertPretrainTaskConfig(loss_unmasked_weight=0.5),
                                        tpre.AVHubertPretrainConfig.tiny(), device="cpu")
    loaded(ttask.module, variables)
    tt = Trainer(ttask.make_loss_fn(), ttask.module, OptimizationConfig(**OPT),
                 ttask.frozen_patterns())
    init = {n: m.clone() for n, m in tt.master.items()}
    for _ in range(2):
        jm = jt.train_step({k: jnp.asarray(x) for k, x in batch.items()})
        tm = tt.train_step(ttask.prepare_batch({k: t(x) for k, x in batch.items()}))
        assert set(tm) == {"loss", "loss_masked", "acc_masked", "gnorm"}
        for key in ("loss", "loss_masked", "acc_masked"):
            np.testing.assert_allclose(tm[key], float(jm[key]), rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(tm["gnorm"], float(jm["gnorm"]), rtol=1e-4)
    template = to_numpy_tree(jt.state.params)
    got = state_dict_to_flax({**tt.module.state_dict(), **tt.master}, template)
    start = state_dict_to_flax({**tt.module.state_dict(), **init}, template)
    rows = []
    leaves = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    for (path, w), (_, g), (_, g0) in zip(leaves(template), leaves(got), leaves(start)):
        w, g, g0 = (np.asarray(x, np.float64) for x in (w, g, g0))
        rows.append((jtrainer.path_str(path), np.linalg.norm(w - g0), np.linalg.norm(g - w)))
    total = np.sqrt(sum(moved ** 2 for _, moved, _ in rows))
    assert np.sqrt(sum(err ** 2 for *_, err in rows)) <= PARAM_RTOL * total
    for name, moved, err in rows:
        assert err <= LEAF_RTOL * moved + PARAM_FLOOR * total, (name, err, moved)
    sd = tt.module.state_dict()
    for path, stat in leaves(to_numpy_tree(jt.state.collections["batch_stats"])):
        names = [p.key for p in path]
        key = ".".join(names[:-1]) + (".running_mean" if names[-1] == "mean" else ".running_var")
        assert max_err(stat, sd[key]) < STATS_TOL, key
    jvalid = jax.jit(jtask.valid_step_fn())(jt.state.params, jt.state.collections,
                                            {k: jnp.asarray(x) for k, x in batch.items()})
    tvalid = ttask.valid_step_fn()({k: t(x) for k, x in batch.items()})
    assert set(tvalid) == {"loss", "accuracy"} and float(tvalid["accuracy"]) == 0.0
    np.testing.assert_allclose(float(tvalid["loss"]), float(jvalid["loss"]), rtol=1e-4)


def _cli_cfg(root, save_dir, updates, workers=1):
    from multimodalvc_tpu_torch import config as tconfig

    tree = tconfig.load_yaml("conf/avhubert-pretrain.yaml")
    tconfig.apply_overrides(tree, [
        f"dataset.data={root}", f"dataset.num_workers={workers}", "dataset.max_tokens=64",
        "dataset.valid_subset=valid", "task.length_buckets=[16,32]", "task.image_crop_size=24",
        "model.preset=tiny", "common.compute_dtype=float32", "common.log_interval=1",
        f"optimization.max_update={updates}", "optimization.warmup_updates=1",
        f"checkpoint.save_dir={save_dir}"])
    return tconfig.from_dict(tconfig.TrainRootConfig, tree)


def test_cli_train_pretrains_and_resumes(tmp_path):
    """``cli.train`` on conf/avhubert-pretrain.yaml (the tiny model, a small
    corpus with .km labels): the task and model resolve from the preset, the
    checkpoint holds the ResNet's running statistics, moved from their
    init, and a run to 2 updates resumed to 4 ends bit for bit where a
    straight run to 4 does (masks from the checkpointed generator, the
    crops from the loader's per-batch seeds)."""
    from multimodalvc_tpu_torch.cli import train as ttrain
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    from tests.fixtures import make_corpus

    root, _ = make_corpus(str(tmp_path / "corpus"), n=4, frame_sizes=(12, 20))
    rng = np.random.default_rng(0)
    for subset in ("train", "valid"):
        (tmp_path / "corpus" / f"{subset}.km").write_text("".join(
            " ".join(map(str, rng.integers(0, 50, 4 * f))) + "\n" for f in (12, 20, 12, 20)))
    val = ttrain.main(_cli_cfg(root, tmp_path / "a", 2), device="cpu")
    assert set(val) >= {"loss", "accuracy"} and val["accuracy"] == 0.0
    state = CheckpointManager(str(tmp_path / "a")).restore()
    assert state["step"] == 2
    var = state["model"]["video_resnet.frontend_bn.running_var"]
    assert not torch.equal(var, torch.ones_like(var))
    ttrain.main(_cli_cfg(root, tmp_path / "a", 4), device="cpu")
    ttrain.main(_cli_cfg(root, tmp_path / "b", 4), device="cpu")
    a, b = (CheckpointManager(str(tmp_path / d)).restore() for d in "ab")
    assert a["step"] == b["step"] == 4
    for name, x in b["model"].items():
        assert torch.equal(a["model"][name], x), name
