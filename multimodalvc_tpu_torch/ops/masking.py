"""Span masking for masked-prediction pretraining, static-shape.

Port of ``multimodalvc_tpu/ops/masking.py``: a fixed budget of span starts
a row, uniform over [0, max(len - L, 1)), each span L frames long, OR-ed
into one boolean mask and cut to the row's valid frames (the statistics of
fairseq's ``compute_mask_indices`` in expectation, "static" span lengths).

The draw and the mask are apart: ``span_uniforms`` draws the [B, n_spans]
uniforms from a ``torch.Generator``; ``span_mask_from_uniforms`` is a pure
function of them, the JAX arithmetic exactly (an f32 product truncated to
int32), so given JAX's uniforms it gives JAX's mask bit for bit.
"""
from __future__ import annotations

import torch


def num_spans(seq_len: int, mask_prob: float = 0.8, mask_length: int = 10,
              min_masks: int = 2) -> int:
    """Span starts a row: round(mask_prob * T / L), at least ``min_masks``."""
    return max(int(mask_prob * seq_len / float(mask_length) + 0.5), min_masks)


def span_uniforms(generator: torch.Generator, batch: int, seq_len: int, mask_prob: float = 0.8,
                  mask_length: int = 10, min_masks: int = 2) -> torch.Tensor:
    """[B, n_spans] f32 uniforms in [0, 1) from ``generator``, on its device."""
    n = num_spans(seq_len, mask_prob, mask_length, min_masks)
    return torch.rand((batch, n), generator=generator, device=generator.device)


def span_mask_from_uniforms(u: torch.Tensor, seq_len: int, lengths: torch.Tensor,
                            mask_length: int = 10) -> torch.Tensor:
    """bool [B, T], True = masked, from the uniforms ``u`` [B, n_spans]: the
    span starts ``int32(u * max(len - L, 1))``; only valid frames mask."""
    max_start = torch.clamp(lengths.to(torch.int32) - mask_length, min=1)[:, None].float()
    starts = (u.float() * max_start).to(torch.int32)  # truncation, as astype(int32)
    pos = torch.arange(seq_len, device=u.device)[None, None, :]
    spans = (pos >= starts[..., None]) & (pos < starts[..., None] + mask_length)
    valid = torch.arange(seq_len, device=u.device)[None, :] < lengths[:, None]
    return spans.any(dim=1) & valid


def apply_feature_mask(x: torch.Tensor, mask: torch.Tensor, mask_emb: torch.Tensor) -> torch.Tensor:
    """Replace the masked frames of x [B, T, D] with the learned embedding."""
    return torch.where(mask[..., None], mask_emb.to(x.dtype), x)
