"""The port's configuration layer against the JAX package's: every preset
under conf/ loads into the port's TrainRootConfig as into the JAX one (the
same ``to_dict``, with and without dotted overrides, which parse alike);
the served presets' task and model groups build the port's registered
configs as the JAX ones; chip_smoke.py's override lists are their presets;
a mesh is resolved over the world as the JAX CLI resolves it over its
devices (a mesh beyond one process's device raises the same ValueError; a
tensor axis resolves as the JAX one), what the port's CLI cannot run
(``checkpoint.init_from_pt`` in the E2E GAN loop) raises
NotImplementedError, and
``checkpoint.init_from_pt`` warm starts an AVSR task."""
import dataclasses
import glob
import os

import pytest
from torch_parity import t  # noqa: F401 (sets one torch thread)

import chip_smoke
from multimodalvc_tpu import config as jconfig
from multimodalvc_tpu import tasks as jtasks  # noqa: F401 (registers the tasks)
from multimodalvc_tpu.parallel import mesh as jmesh
from multimodalvc_tpu.models import avhubert_pretrain as _javh  # noqa: F401
from multimodalvc_tpu.models import avsr as _javsr, speech as _jsp, vocoder as _jvoc  # noqa: F401
from multimodalvc_tpu_torch import config as tconfig
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import registry as tregistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(REPO, "conf", "*.yaml")))
# the presets whose task and model the port's CLI serves
SERVED = ["avhubert-pretrain", "hifigan-vocoder", "mms-llama", "mms-llama-speech",
          "mms-speech-nollm", "mms-speech-nollm-e2e", "s2s_decode"]
OVERRIDES = ["dataset.data=/data/manifest", "task.noise_wav=/data/babble.wav",
             "optimization.max_update=12", "optimization.lr=3.0e-5",
             "optimization.adam_betas=[0.9,0.95]", "dataset.length_buckets=[50,100]",
             "dataset.batch_size=null", "generation.weight_quant=int8",
             "generation.ancestry_decode=true", "checkpoint.restore_file=a,b",
             "common.profile=false", "model.queries_per_sec=4", "task.image_aug=false"]


def both(tree_fn):
    """(JAX, port) TrainRootConfig of the tree ``tree_fn(module)`` builds."""
    return (jconfig.from_dict(jconfig.TrainRootConfig, tree_fn(jconfig)),
            tconfig.from_dict(tconfig.TrainRootConfig, tree_fn(tconfig)))


def preset_path(name: str) -> str:
    return os.path.join(REPO, "conf", f"{name}.yaml")


@pytest.mark.parametrize("with_overrides", [False, True], ids=["plain", "overridden"])
@pytest.mark.parametrize("preset", PRESETS)
def test_presets_load_as_in_jax(preset, with_overrides):
    ov = OVERRIDES if with_overrides else []
    want, got = both(lambda m: m.apply_overrides(m.load_yaml(preset_path(preset)), ov))
    assert tconfig.to_dict(got) == jconfig.to_dict(want)
    assert tconfig.load_yaml(preset_path(preset)) == jconfig.load_yaml(preset_path(preset))


def test_defaults_and_groups_match_jax():
    want, got = both(lambda m: {})
    assert tconfig.to_dict(got) == jconfig.to_dict(want)
    for name in ("CommonConfig", "MeshConfig", "DatasetConfig", "OptimizationConfig",
                 "CheckpointConfig", "GenerationConfig"):
        fields = lambda cls: [(f.name, f.default if f.default is not dataclasses.MISSING  # noqa
                               else None) for f in dataclasses.fields(cls)]
        assert fields(getattr(tconfig, name)) == fields(getattr(jconfig, name)), name
    assert tconfig.MISSING == jconfig.MISSING


@pytest.mark.parametrize("raw", ["null", "None", "~", "true", "False", "7", "-3", "2.5e-4",
                                 "[1,2,3]", "[]", "[a, 2.0]", "text", "1e3"])
def test_overrides_parse_alike(raw):
    from multimodalvc_tpu.config import structured as js
    from multimodalvc_tpu_torch.config import structured as ts

    assert ts._parse_scalar(raw) == js._parse_scalar(raw)
    assert ts.apply_overrides({}, [f"a.b={raw}"]) == js.apply_overrides({}, [f"a.b={raw}"])
    with pytest.raises(ValueError):
        ts.apply_overrides({}, ["no_equals_sign"])
    with pytest.raises(KeyError):
        tconfig.from_dict(tconfig.TrainRootConfig, {"nope": 1})


@pytest.mark.parametrize("preset", SERVED)
def test_served_presets_build_the_registered_configs(preset):
    """The task group builds the registered task config (dataset.data flows
    in), the model group the registered model config, as in the JAX
    package: the same fields where both have them."""
    tree = tconfig.load_yaml(preset_path(preset))
    tree["dataset"]["data"] = "/data/manifest"
    cfg = tconfig.from_dict(tconfig.TrainRootConfig, tree)
    task = dict(cfg.task)
    tcls, tcfg_cls = tregistry.lookup("task", task.pop("name"))
    jcls, jcfg_cls = jconfig.registry.lookup("task", cfg.task["name"])
    assert tcls.__name__ == jcls.__name__
    assert tconfig.to_dict(tconfig.from_dict(tcfg_cls, task)) == \
        jconfig.to_dict(jconfig.from_dict(jcfg_cls, task))
    model = dict(cfg.model)
    name = model.pop("name")
    _, tm = tregistry.lookup("model", name)
    _, jm = jconfig.registry.lookup("model", name)
    got, want = tconfig.to_dict(tconfig.from_dict(tm, model)), jconfig.to_dict(
        jconfig.from_dict(jm, model))
    for k in got.keys() & want.keys():
        if not isinstance(got[k], dict):
            assert got[k] == want[k], k


@pytest.mark.parametrize("preset", sorted(chip_smoke.PRESETS))
def test_smoke_overrides_are_their_presets(preset):
    extra = ["dataset.data=/corpus", "task.noise_wav=/corpus/babble.wav"]
    from_file = tconfig.apply_overrides(tconfig.load_yaml(preset_path(preset)), extra)
    from_list = tconfig.apply_overrides({}, chip_smoke.PRESETS[preset] + extra)
    assert from_list == from_file
    assert tconfig.to_dict(tconfig.from_dict(tconfig.TrainRootConfig, from_list)) == \
        jconfig.to_dict(jconfig.from_dict(jconfig.TrainRootConfig, from_file))


MESHES = [{"pipeline": 2}, {"data": 2}, {"data": -1, "fsdp": -1}, {"expert": 4},
          {"tensor": 2, "data": -1}]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "_".join(f"{k}{v}" for k, v in m.items()))
def test_meshes_beyond_one_device_raise(mesh):
    """In one process (one device) a mesh beyond it raises the JAX
    ``resolve_axis_sizes`` error; over four devices every mesh resolves as
    the JAX one does, a tensor axis too."""
    cfg = tconfig.from_dict(tconfig.TrainRootConfig, {"mesh": mesh})
    with pytest.raises(ValueError):
        ttrain.main(cfg, device="cpu")
    with pytest.raises(ValueError):
        jmesh.resolve_axis_sizes(mesh, 1)
    axes = {k: v for k, v in dataclasses.asdict(cfg.mesh).items() if k != "microbatches"}
    try:
        want = jmesh.resolve_axis_sizes(axes, 4)
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            ttrain.mesh_sizes(cfg, 4)
    else:
        assert ttrain.mesh_sizes(cfg, 4) == want
    for ok in ({"data": -1}, {"data": 1}, {"data": -1, "fsdp": 1, "pipeline": 1}):
        sizes = ttrain.mesh_sizes(tconfig.from_dict(tconfig.TrainRootConfig, {"mesh": ok}))
        assert set(sizes.values()) == {1}


def test_presets_beyond_one_device_raise():
    """The two presets whose mesh needs several devices raise the mesh
    error in one process; on a mesh of one device each builds its model:
    the pipeline preset's loss is the plain one at one pipeline stage (as
    in JAX), the MoE preset's Conformer blocks hold the expert bank."""
    from multimodalvc_tpu_torch.nn.conformer import ConformerBlock

    for preset in ("mms-llama-pp", "mms-speech-nollm-moe"):
        tree = tconfig.load_yaml(preset_path(preset))
        with pytest.raises(ValueError):
            ttrain.main(tconfig.from_dict(tconfig.TrainRootConfig, tree), device="cpu")
        over = ["mesh.pipeline=1", "mesh.expert=1", "model.preset=tiny"]
        cfg = tconfig.from_dict(tconfig.TrainRootConfig, tconfig.apply_overrides(tree, over))
        with ttrain.mesh_scope(ttrain.mesh_sizes(cfg)):
            task = ttrain.build_task(cfg, device="cpu")
        if preset == "mms-llama-pp":
            assert task.cfg.pipeline_microbatches == 4
            assert task.make_loss_fn().__qualname__.startswith("AVSRSystem.make_trainer_loss_fn")
        else:
            blocks = [m for m in task.module.modules() if isinstance(m, ConformerBlock)]
            assert blocks and all(hasattr(b, "ff_moe") and not hasattr(b, "ff") for b in blocks)


def test_multi_process_launch_raises(monkeypatch):
    """A launch of four processes (torchrun's variables) is read as such,
    and a tensor axis over it resolves as the JAX mesh does."""
    for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "4"),
                 ("RANK", "3"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    from multimodalvc_tpu_torch.parallel.distributed import infer_init_args

    assert infer_init_args() == {"init_method": "tcp://10.0.0.1:29500", "world_size": 4,
                                 "rank": 3, "local_rank": 1}
    cfg = tconfig.from_dict(tconfig.TrainRootConfig, {"mesh": {"data": -1, "tensor": 2}})
    sizes = ttrain.mesh_sizes(cfg, 4)
    assert sizes == jmesh.resolve_axis_sizes(
        {k: v for k, v in dataclasses.asdict(cfg.mesh).items() if k != "microbatches"}, 4)
    assert sizes["tensor"] == 2 and sizes["data"] == 2
    assert ttrain.mesh_sizes(tconfig.TrainRootConfig(), 4)["data"] == 4


class _Built(Exception):
    """Raised by a stand-in Trainer: the loop got as far as building it."""


@pytest.mark.parametrize("task", ["avsr_training", "e2e_gan_training"])
def test_init_from_pt(task, tmp_path, monkeypatch):
    """The AVSR task imports a reference product .pt over its fresh module
    before the trainer takes it; the E2E GAN loop refuses the field, which
    the JAX E2E loop never reads."""
    import argparse

    import torch

    from multimodalvc_tpu_torch import tasks as ttasks

    model = {"avsr_training": "mms_llama_avsr", "e2e_gan_training": "mms_speech_nollm_e2e"}
    g = torch.Generator().manual_seed(3)
    state = {"query_tokens": torch.randn(1, 80, 32, generator=g),
             "avfeat_to_llm.layers.0.weight": torch.randn(48, 32, generator=g),
             "avfeat_to_llm.layers.0.bias": torch.randn(48, generator=g),
             "avfeat_to_llm.layers.1.weight": torch.randn(64, 48, generator=g),
             "avfeat_to_llm.layers.1.bias": torch.randn(64, generator=g),
             "llama.model.layers.1.self_attn.v_proj.lora_B.default.weight":
                 torch.randn(32, 16, generator=g)}
    path = tmp_path / "product.pt"
    torch.save({"model": state, "args": argparse.Namespace(lr=1e-4)}, path)
    cfg = tconfig.from_dict(tconfig.TrainRootConfig, {
        "common": {"compute_dtype": "float32"},
        "checkpoint": {"init_from_pt": str(path)},
        "task": {"name": task},
        "model": {"name": model[task], "preset": "tiny"}})
    if task == "e2e_gan_training":
        with pytest.raises(NotImplementedError, match="JAX E2E loop never reads"):
            ttrain.main(cfg, device="cpu")
        return
    seen = {}

    def trainer(loss_fn, module, *a, **k):
        seen.update(module.state_dict())
        raise _Built

    monkeypatch.setattr(ttasks.AVSRTask, "load_dataset", lambda self, subset: None)
    monkeypatch.setattr(ttrain, "Trainer", trainer)
    with pytest.raises(_Built):
        ttrain.main(cfg, device="cpu")
    assert torch.equal(seen["encoder.qformer.query_tokens"], state["query_tokens"])
    for j in (0, 1):
        for leaf in ("weight", "bias"):
            assert torch.equal(seen[f"encoder.avfeat_to_llm.layers_{j}.{leaf}"],
                               state[f"avfeat_to_llm.layers.{j}.{leaf}"])
    assert torch.equal(seen["llama.layers_1.self_attn.v_proj.lora_b"],
                       state["llama.model.layers.1.self_attn.v_proj.lora_B.default.weight"].t())


def test_registries_name_the_jax_tasks_and_models():
    assert set(tregistry.available("task")) == {
        "avsr_training", "speech_training", "vocoder_training", "e2e_gan_training",
        "avhubert_pretraining"}
    assert set(tregistry.available("task")) <= set(jconfig.registry.available("task"))
    assert set(tregistry.available("model")) == {
        "mms_llama_avsr", "mms_llama_speech", "mms_speech_nollm", "mms_speech_nollm_e2e",
        "hifigan_vocoder", "av_hubert_pretrain"}
    assert set(tregistry.available("model")) <= set(jconfig.registry.available("model"))
    with pytest.raises(KeyError, match="available"):
        tregistry.lookup("task", "dummy_avsr")  # the JAX benchmark task, not ported
