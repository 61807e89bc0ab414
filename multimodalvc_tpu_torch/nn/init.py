"""Random weights from a seed, for any module of the port."""
from __future__ import annotations

import torch
from torch import nn

from .llama import RMSNorm
from .wn_conv import SNConv1d, reset_weight_norm_


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0) -> None:
    """Random weights from ``seed``, drawn on the module's device in the
    order of ``module.modules()``: matrices, convs, embeddings and learned
    tokens N(0, 0.02); LoRA ``lora_a`` N(0, 0.01) and ``lora_b`` zero (as the
    JAX init); the mask embeddings and the pretraining label embeddings
    U[0, 1) (as the JAX init); norms
    one, biases zero, PReLU 0.25, BatchNorm running statistics (0, 1),
    spectral-norm vectors N(0, 1) / sqrt(size); then each weight-normalized
    conv's g = ||v||, so its weight is its v."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm, RMSNorm)):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif isinstance(mod, nn.PReLU):
                p.fill_(0.25)
            elif name == "bias" or name == "lora_b":
                p.zero_()
            elif name.endswith("mask_emb") or name == "label_embs_concat":
                p.uniform_(0.0, 1.0, generator=gen)
            else:
                p.normal_(0.0, 0.01 if name == "lora_a" else 0.02, generator=gen)
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_running_stats()
        if isinstance(mod, SNConv1d):
            mod.reset_spectral_(gen)
    reset_weight_norm_(module)
