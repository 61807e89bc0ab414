"""The port's E2E GAN loop of ``cli.train`` against the JAX package's on the
synthetic corpus of tests/fixtures.py, on the CPU: 2 updates of stage 2 (the
encoders frozen) of SpeechConfig.tiny() with a 16-channel generator and a
test discriminator stack, from the same start weights (the JAX run's,
carried into the port through ``interop/from_flax.py``), with the same
modality modes, no dropout, and both sides' AdamW at eps 1e-3
(tests/test_torch_e2e_gan.py says why).

f32.  The first update's loss terms agree to rel 1e-5 (measured <= 1.1e-6).
The second update's and the validation mel L1 run through the first
update's leaves, which part by ~1e-3 of their move in this random setup
(tests/test_torch_e2e_gan.py measures 2.5e-3 rel L2 over two stage-2
steps): rel 2e-3 (measured <= 6.9e-4 and 8.0e-4).  The validation MCD, a log
cepstral distance of random-weight waveforms, takes the same difference to
5.8e-2 and is not compared.  The JAX loop takes ~100 s on one CPU worker,
so this comparison has a file of its own."""
import functools

import flax.linen as fnn
import numpy as np
import pytest
import torch
from test_torch_cli import LogTap
from test_torch_cli_gan import (
    compare,
    e2e_tree,
    load_discriminator,
    one_device,
    optax_with_eps,
)
from test_torch_speech_train import zero_dropout
from torch_parity import loaded

from multimodalvc_tpu import tasks as jtasks
from multimodalvc_tpu.cli import train as jtrain
from multimodalvc_tpu.config import TrainRootConfig as JaxRoot
from multimodalvc_tpu.config import from_dict as jax_from_dict
from multimodalvc_tpu.criterions import gan as jgan
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.config import TrainRootConfig, from_dict
from multimodalvc_tpu_torch.criterions import gan as tgan
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager
from multimodalvc_tpu_torch.runtime.trainer import AdamW

from tests.fixtures import make_corpus

STEP1_RTOL, STEP2_RTOL = 1e-5, 2e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("torchclie2e")), frame_sizes=(10, 14, 16))


def test_e2e_gan_loop_matches_jax(corpus, tmp_path):
    root, _ = corpus
    eps = 1e-3
    start = {}
    with pytest.MonkeyPatch.context() as mp:
        one_device(mp)
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jgan, "optax", optax_with_eps(eps))
        real_make = jtasks.E2EGanTask.make_trainer

        def make_trainer(self, rng, sample_batch):
            trainer, state = real_make(self, rng, sample_batch)
            start["state"] = state
            self._mode_rng = np.random.default_rng(7)  # the sample batch drew a mode
            return trainer, state

        mp.setattr(jtasks.E2EGanTask, "make_trainer", make_trainer)
        jtap = LogTap(mp, jtrain)
        jtrain.main(jax_from_dict(JaxRoot, e2e_tree(root, str(tmp_path / "jax"))))

        def init_random(self, seed=0):
            state = start["state"]
            loaded(self.model, {"params": state.gen_params, **state.collections})
            zero_dropout(self.model)

        real_tmake = ttasks.E2EGanTask.make_trainer

        def tmake_trainer(self, seed=0):
            trainer = real_tmake(self, seed)
            load_discriminator(trainer.discriminator, start["state"])
            trainer.reset_optimizers()
            return trainer

        mp.setattr(ttasks.E2EGanTask, "init_random", init_random)
        mp.setattr(ttasks.E2EGanTask, "make_trainer", tmake_trainer)
        mp.setattr(tgan, "AdamW", functools.partial(AdamW, eps=eps))
        mp.setattr(tavsr, "train_rng", lambda train, generator: None)
        ttap = LogTap(mp, ttrain)
        save_dir = str(tmp_path / "port")
        ttrain.main(from_dict(TrainRootConfig, e2e_tree(root, save_dir)), device="cpu")
        compare(jtap, ttap, (STEP1_RTOL, STEP2_RTOL), ("mel_l1",), STEP2_RTOL)
        state = CheckpointManager(save_dir).restore()
        assert state["step"] == 2 and any(k.startswith("trunk.encoder.whisper.")
                                          for k in state["model"])
        assert torch.is_tensor(state["generator"])
