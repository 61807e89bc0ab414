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


def lm_metrics(loss: torch.Tensor, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """loss, ppl, accuracy (argmax hits over the valid label tokens) and
    n_tokens of a forward's (loss, aux)."""
    return {
        "loss": loss,
        "ppl": torch.exp(loss),
        "accuracy": aux["n_correct"] / aux["n_valid"].clamp(min=1),
        "n_tokens": aux["n_valid"],
    }
