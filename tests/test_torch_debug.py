"""The port's failure detection (runtime/debug.py) as tests/test_debug.py
holds the JAX one: NanDetector localises a non-finite gradient (the same
leaves as the JAX detector on the same loss), checkify_loss raises at the
first non-finite module output, check_cross_process_scalar is True for one
process; and cli.train calls them where the JAX CLI does."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalvc_tpu.runtime import debug as jdebug
from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.runtime import debug as tdebug


def test_nan_detector_localises_grad_nan_as_jax():
    # sqrt at 0: a NaN gradient in exactly one leaf
    def jloss(params, batch):
        return jnp.sum(jnp.sqrt(params["a"])) + jnp.sum(params["b"] * batch), None

    def tloss(params, batch):
        return torch.sqrt(params["a"]).sum() + (params["b"] * batch).sum(), None

    want = jdebug.NanDetector(jloss).run({"a": jnp.zeros(2), "b": jnp.ones(2)}, jnp.ones(2))
    got = tdebug.NanDetector(tloss).run({"a": torch.zeros(2), "b": torch.ones(2)},
                                        torch.ones(2))
    assert got == want
    assert got["nonfinite_grads"] == ["grads/a (2/2 non-finite)"]
    assert not got["loss_nonfinite"] and got["nonfinite_params"] == []


def test_nan_detector_over_a_modules_parameters():
    """With ``params`` (a module's, as cli.train passes Trainer.params) the
    loss is re-run with its gradient; a non-finite weight and the gradients
    it poisons are listed."""
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight[0, 1] = float("inf")
    report = tdebug.NanDetector(lambda x: (lin(x).square().sum(), {}),
                                dict(lin.named_parameters())).run(torch.ones(4, 3))
    assert report["loss_nonfinite"]
    assert report["nonfinite_params"] == ["params/weight (1/6 non-finite)"]
    assert any(line.startswith("grads/") for line in report["nonfinite_grads"])


def test_checkify_loss_raises_on_nan():
    wrapped = tdebug.checkify_loss(lambda x: torch.log(x).sum())
    assert np.isfinite(float(wrapped(torch.ones(3))))
    with pytest.raises(FloatingPointError):
        wrapped(torch.zeros(3) - 1.0)  # log of a negative: NaN
    jwrapped = jdebug.checkify_loss(lambda x: jnp.log(x).sum())
    with pytest.raises(Exception):
        jwrapped(jnp.zeros(3) - 1.0)


def test_checkify_loss_names_the_first_module():
    net = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.ReLU(), torch.nn.Linear(3, 1))
    with torch.no_grad():
        net[2].weight.fill_(float("nan"))
    wrapped = tdebug.checkify_loss(lambda x: net(x).sum(), net)
    with pytest.raises(FloatingPointError, match="module 2"):
        wrapped(torch.ones(2, 3))
    with torch.no_grad():
        net[2].weight.fill_(1.0)
    assert np.isfinite(float(wrapped(torch.ones(2, 3)).detach()))
    assert not net[2]._forward_hooks  # the hooks last for the call only


def test_cross_process_scalar_single_process():
    assert tdebug.check_cross_process_scalar("gnorm", 1.234)
    assert jdebug.check_cross_process_scalar("gnorm", 1.234)


def test_cli_train_calls_the_detector_and_the_cross_check():
    src = inspect.getsource(ttrain._train_loop)
    assert "NanDetector(trainer.loss_fn, trainer.params).run(" in src
    assert 'check_cross_process_scalar("gnorm"' in src
