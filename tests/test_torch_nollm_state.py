"""A NoLLM training step does not depend on what the process ran before it.

``chip_smoke.py --parallel`` switches the dropout off for its data-parallel
phase by replacing ``models/avsr.py: train_rng`` for the phase; the speech
models, imported for the first time inside that phase, had bound the
replacement by name and kept it, so every later NoLLM step in the process
trained without dropout (step-1 loss 1.6078 against 1.6016 on the H100).
Here a child process imports the speech task under the same replacement,
then takes the tiny NoLLM steps, which must be bit for bit the steps of
this process, which imported it plainly (~10 s)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
from torch_dist_worker import nollm_batch, nollm_steps
from torch_parity import t  # noqa: F401 (sets one torch thread)

TESTS = Path(__file__).resolve().parent
OPT = dict(lr=1e-3, warmup_updates=2, max_update=10, adam_eps=1e-3)
STEPS = 2

CHILD = """
import json, sys
from unittest import mock
import torch
torch.set_num_threads(1)
from multimodalvc_tpu_torch.models import avsr
with mock.patch.object(avsr, "train_rng", lambda train, generator: None):
    from multimodalvc_tpu_torch import tasks  # noqa: F401  (the speech models' first import)
sys.path.insert(0, {tests!r})
from torch_dist_worker import nollm_steps
print(json.dumps(nollm_steps({batch!r}, {opt!r}, {steps})["metrics"]))
"""


def test_nollm_steps_ignore_a_replacement_undone_before_them(tmp_path):
    batch = str(tmp_path / "nollm.npz")
    np.savez(batch, **nollm_batch())
    code = CHILD.format(tests=str(TESTS), batch=batch, opt=OPT, steps=STEPS)
    child = subprocess.run([sys.executable, "-c", code], cwd=TESTS.parent, capture_output=True,
                           text=True, timeout=300, check=True)
    got = json.loads(child.stdout.strip().splitlines()[-1])
    want = nollm_steps(batch, OPT, STEPS)["metrics"]
    assert len(got) == STEPS and got == want
