"""The port's ``.pt`` reader (runtime/pt_loader.py) against the JAX package's
on tests/test_pt_loader.py's four cases: values bit for bit (bf16 after
``.float()``, which the JAX reader widens to f32), the same
``flatten_state_dict`` keys; the port keeps the stored dtype and the
storage sharing of views.  Then the vocoder's ``.pt`` import, which goes
through the reader, on a trainer's dict with an ``argparse.Namespace``
beside the generators."""
from argparse import Namespace

import numpy as np
import pytest
import torch
from torch_parity import t  # noqa: F401 (sets one torch thread)

from multimodalvc_tpu.runtime.pt_loader import flatten_state_dict as jflatten
from multimodalvc_tpu.runtime.pt_loader import load_pt as jload
from multimodalvc_tpu_torch.runtime import flatten_state_dict, load_pt


def _round_trip(rng):
    return {
        "model": {
            "w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
            "b": torch.arange(5, dtype=torch.int64),
            "h": torch.from_numpy(rng.standard_normal(7).astype(np.float16)),
        },
        "step": 123,
        "nested": {"scale": torch.tensor(2.5)},
    }


def _shared_and_strided(rng):
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    return {"a": base, "b": base.t()}


def _bf16(rng):
    return {"x": torch.linspace(-2, 2, 16, dtype=torch.bfloat16)}


def _unknown_objects(rng):
    return {"cfg": Namespace(lr=0.1), "w": torch.ones(2)}


CASES = {"round_trip": _round_trip, "shared_and_strided": _shared_and_strided,
         "bf16": _bf16, "unknown_objects": _unknown_objects}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_pt_matches_jax(case, tmp_path):
    state = CASES[case](np.random.default_rng(0))
    path = tmp_path / f"{case}.pt"
    torch.save(state, path)
    got, want = flatten_state_dict(load_pt(str(path))), jflatten(jload(str(path)))
    saved = flatten_state_dict(state)
    assert sorted(got) == sorted(want) == sorted(saved)
    for key, x in got.items():
        assert x.dtype == saved[key].dtype, key  # the stored dtype (bf16 stays bf16)
        assert torch.equal(x, saved[key]), key
        wide = x.float() if x.dtype == torch.bfloat16 else x
        assert np.array_equal(wide.numpy(), np.asarray(want[key])), key


def test_load_pt_keeps_views_and_objects(tmp_path):
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    torch.save({"a": base, "b": base.t(), "cfg": Namespace(lr=0.1), "n": 7}, tmp_path / "v.pt")
    raw = load_pt(str(tmp_path / "v.pt"))
    assert raw["b"].stride() == (1, 4)  # the transposed view, over the shared storage
    assert raw["a"].untyped_storage().data_ptr() == raw["b"].untyped_storage().data_ptr()
    assert raw["n"] == 7 and not isinstance(raw["cfg"], Namespace)  # an inert shell
    assert raw["cfg"].state == {"lr": 0.1}


@pytest.mark.parametrize("layout", ["ema_generator", "generator"])
def test_vocoder_reads_a_trainer_dict_with_a_namespace(layout, tmp_path):
    """A reference trainer's dict (``ema_generator`` / ``generator`` beside
    ``args``) loads in both packages, to equal generators."""
    import jax

    from multimodalvc_tpu.models.vocoder import VocoderConfig as JCfg
    from multimodalvc_tpu.models.vocoder import VocoderModel as JVoc
    from multimodalvc_tpu.nn.hifigan import HifiGanConfig as JGen
    from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict
    from multimodalvc_tpu_torch.models.vocoder import VocoderConfig, VocoderModel
    from multimodalvc_tpu_torch.nn.hifigan import HifiGanConfig

    small = dict(upsample_initial_channel=16)
    voc = VocoderModel(VocoderConfig(generator=HifiGanConfig(**small)), device="cpu")
    voc.init_random(3)
    own = {k: v.clone() for k, v in voc.generator.state_dict().items()}
    voc.init_random(4)  # the import must overwrite
    ref = {reference_name(n): x.reshape(-1, 1, 1) if n.endswith(".g") else x
           for n, x in own.items()}
    decoy = {k: torch.zeros_like(v) for k, v in ref.items()}
    raw = {layout: ref, "args": Namespace(segment_length=8320)}
    if layout == "ema_generator":
        raw["generator"] = decoy  # the EMA copy is taken first
    torch.save(raw, tmp_path / "voc.pt")
    with pytest.raises(Exception):  # what the reader replaces
        torch.load(tmp_path / "voc.pt", weights_only=True)

    got = voc.import_torch_checkpoint(str(tmp_path / "voc.pt"))
    jvoc = JVoc(JCfg(generator=JGen(**small)))
    want = flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, jvoc.import_torch_checkpoint(str(tmp_path / "voc.pt"))
                                ["params"])})
    loaded = voc.generator.state_dict()
    assert sorted(got) == sorted(want) == sorted(own)
    for key in own:
        assert torch.equal(loaded[key], own[key]), key
        assert torch.equal(got[key].reshape(want[key].shape), want[key]), key


def reference_name(key):
    """The reference generator's name of a port generator entry."""
    base, leaf = key.rsplit(".", 1)
    for part in ("ups", "resblocks", "convs1", "convs2"):
        base = base.replace(f"{part}_", f"{part}.")
    return f"{base}.{dict(v='weight_v', g='weight_g').get(leaf, leaf)}"
