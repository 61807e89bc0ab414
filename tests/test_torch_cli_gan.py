"""The port's vocoder loop of ``cli.train`` against the JAX package's on the
synthetic corpus of tests/fixtures.py, on the CPU: 2 updates of a 16-channel
generator against a test discriminator stack, from the same start weights
(the JAX run's, carried into the port through ``interop/from_flax.py``),
both sides' AdamW at eps 1e-6 (tests/test_torch_vocoder_train.py says why).
f32: each loss term of each update and the validation mel L1 to rel 1e-5
(measured <= 1.9e-6); the full-state checkpoint resumes to a third update.
The helpers serve tests/test_torch_cli_e2e.py too."""
import functools
import types

import jax
import numpy as np
import optax
import pytest
from test_torch_cli import LogTap
from torch_parity import to_numpy_tree

from multimodalvc_tpu.cli import train as jtrain
from multimodalvc_tpu.config import TrainRootConfig as JaxRoot
from multimodalvc_tpu.config import from_dict as jax_from_dict
from multimodalvc_tpu.models import vocoder as jvoc
from multimodalvc_tpu.parallel import mesh as jmesh
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
from multimodalvc_tpu_torch.interop.from_flax import load_flax_variables
from multimodalvc_tpu_torch.models import vocoder as tvoc
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager
from multimodalvc_tpu_torch.runtime.trainer import AdamW

from tests.fixtures import make_corpus

GAN_TERMS = ("loss_gen", "loss_disc", "loss_mel", "loss_fm", "loss_adv")
GEN = {"in_channels": 128, "upsample_initial_channel": 16, "upsample_factors": [10, 4, 2, 2],
       "upsample_kernel_sizes": [20, 8, 4, 4], "resblock_kernel_sizes": [3],
       "resblock_dilations": [[1, 3, 5]]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("torchcligan")), frame_sizes=(10, 14, 16))


def vocoder_tree(root, save_dir, max_update=2):
    return {
        "common": {"log_interval": 1, "compute_dtype": "float32"},
        "mesh": {"data": 1},
        "dataset": {"data": root, "batch_size": 2, "num_workers": 0},
        "optimization": {"max_update": max_update},
        "checkpoint": {"save_dir": save_dir},
        "task": {"name": "vocoder_training", "segment_length": 1600},
        "model": {"name": "hifigan_vocoder", "segment_length": 1600, "generator": GEN,
                  "disc_periods": [2, 3], "disc_scales": 2, "disc_channels_cap": 32},
    }


def e2e_tree(root, save_dir, max_update=2):
    return {
        "common": {"log_interval": 1, "compute_dtype": "float32"},
        "mesh": {"data": 1},
        "dataset": {"data": root, "batch_size": 2, "num_workers": 0},
        "optimization": {"max_update": max_update},
        "checkpoint": {"save_dir": save_dir},
        "task": {"name": "e2e_gan_training", "stage1_freeze": False, "max_video_frames": 16,
                 "length_buckets": [16], "max_mel_frames": 32,
                 "vocoder_initial_channels": 16, "vocoder_resblock_kernels": [3],
                 "disc_periods": [2, 3], "disc_scales": 2, "disc_channels_cap": 32},
        "model": {"name": "mms_speech_nollm_e2e", "preset": "tiny"},
    }


def optax_with_eps(eps):
    """optax with its adamw's eps raised to ``eps``."""
    return types.SimpleNamespace(**{**vars(optax),
                                    "adamw": functools.partial(optax.adamw, eps=eps)})


def one_device(mp):
    mp.setattr(jtrain, "make_mesh",
               lambda sizes: jmesh.make_mesh(sizes, devices=jax.devices()[:1]))


def load_discriminator(disc, state):
    load_flax_variables(disc, {"params": to_numpy_tree(state.disc_params),
                               "spectral": to_numpy_tree(state.spectral)})


def compare(jtap, ttap, rtols, valid_keys, valid_rtol):
    """Each loss term of update i within ``rtols[i]``, the validation metrics
    ``valid_keys`` within ``valid_rtol``."""
    want, got = jtap.of("train"), ttap.of("train")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    for (_, w), (step, g), rtol in zip(want, got, rtols):
        for k in GAN_TERMS:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"step {step} {k}")
    (_, wv), = jtap.of("valid")
    (_, gv), = ttap.of("valid")
    for k in valid_keys:
        np.testing.assert_allclose(gv[k], wv[k], rtol=valid_rtol, err_msg=k)


def test_vocoder_loop_matches_jax(corpus, tmp_path):
    root, _ = corpus
    eps = 1e-6
    start = {}
    with pytest.MonkeyPatch.context() as mp:
        one_device(mp)
        mp.setattr(jvoc, "optax", optax_with_eps(eps))
        real_init = jvoc.VocoderModel.init_state
        mp.setattr(jvoc.VocoderModel, "init_state", lambda self, *a, **k: start.setdefault(
            "state", real_init(self, *a, **k)))
        jtap = LogTap(mp, jtrain)
        jtrain.main(jax_from_dict(JaxRoot, vocoder_tree(root, str(tmp_path / "jax"))))

        mp.setattr(tvoc, "AdamW", functools.partial(AdamW, eps=eps))
        real_tinit = tvoc.VocoderModel.init_state

        def init_state(self, seed=0):
            real_tinit(self, seed)
            state = start["state"]
            load_flax_variables(self.generator, {"params": to_numpy_tree(state.gen_params)})
            load_discriminator(self.discriminator, state)
            self.reset_optimizers()

        mp.setattr(tvoc.VocoderModel, "init_state", init_state)
        ttap = LogTap(mp, ttrain)
        save_dir = str(tmp_path / "port")
        ttrain.main(from_dict(TrainRootConfig, vocoder_tree(root, save_dir)), device="cpu")
        compare(jtap, ttap, (1e-5, 1e-5), ("mel_l1",), 1e-5)
        # the full state resumes: a third update from the checkpoint equals
        # one straight on from it
        state = CheckpointManager(save_dir).restore()
        assert state["step"] == 2 and {"generator", "discriminator", "gen_opt", "disc_opt",
                                       "ema"} <= set(state)
        ttrain.main(from_dict(TrainRootConfig, vocoder_tree(root, save_dir, 3)), device="cpu")
        assert CheckpointManager(save_dir).meta["step"] == 3


def test_vocoder_preset_trains_its_generator_in_f32():
    """conf/hifigan-vocoder.yaml leaves ``common.compute_dtype`` at its
    bfloat16 default; the standalone generator is built in f32 all the same,
    as the JAX task trains it (exact: every parameter's dtype)."""
    import os

    import torch

    preset = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "conf", "hifigan-vocoder.yaml")
    cfg, _ = ttrain.parse_args(["--config", preset, "dataset.data=unused"])
    assert cfg.common.compute_dtype == "bfloat16"
    task = ttrain.build_task(cfg, device="cpu")
    assert type(task).__name__ == "VocoderTask"
    assert {p.dtype for p in task.model.generator.parameters()} == {torch.float32}
