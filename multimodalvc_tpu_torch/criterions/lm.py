"""Decoder-only LM criterion: token accuracy, perplexity and token count.

Port of ``multimodalvc_tpu/criterions/lm.py``: the loss comes from the
model's LLaMA forward (``nn/llama.py: cross_entropy_lm_loss``); ``lm_metrics``
adds the token accuracy, the perplexity and the token count.  The trainer's
loss (``AVSRSystem.make_trainer_loss_fn``) and the task's validation step
report through it.  The JAX config's ``label_smoothing``, which nothing
reads there, is not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..parallel.mesh import batch_total


def lm_metrics(loss: torch.Tensor, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """loss, ppl, accuracy (argmax hits over the valid label tokens) and
    n_tokens of a forward's (loss, aux); on a mesh the batch group's (the
    same on every rank)."""
    loss = batch_total(loss)
    n_valid = batch_total(aux["n_valid"])
    return {
        "loss": loss,
        "ppl": torch.exp(loss),
        "accuracy": batch_total(aux["n_correct"]) / n_valid.clamp(min=1),
        "n_tokens": n_valid,
    }
