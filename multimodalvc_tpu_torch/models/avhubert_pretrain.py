"""AV-HuBERT masked-prediction pretraining.

Port of ``multimodalvc_tpu/models/avhubert_pretrain.py``: the fused front end
of ``nn/avhubert.py`` (both streams, ``audio_proj`` included), span masks on
the fused features (``ops/masking.py``, the learned ``mask_emb`` in the
masked frames), the transformer, then cosine-similarity logits of
``final_proj``'s output against ``label_embs_concat`` at ``logit_temp``
(norms floored at 1e-8), an f32 log-softmax, and the cross-entropy means
over the masked and the unmasked valid frames with the masked accuracy.
The encoder is built as the JAX model builds it: no dropout and the
default positional conv, whatever ``encoder.dropout`` and ``conv_pos``
say.  The span-mask uniforms come from the generator the caller passes.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import torch
from torch import nn

from ..config.registry import register_model
from ..nn.avhubert import AVHubertConfig, AVHubertModel
from ..ops.masking import apply_feature_mask, span_mask_from_uniforms, span_uniforms
from ..parallel.mesh import batch_total


@dataclass
class AVHubertPretrainConfig:
    encoder: AVHubertConfig = field(default_factory=AVHubertConfig)
    num_classes: int = 2004  # k-means clusters + specials (large_vox recipe)
    final_dim: int = 256
    logit_temp: float = 0.1
    mask_prob: float = 0.8
    mask_length: int = 10
    masking_type: str = "feature"  # input | feature

    @classmethod
    def tiny(cls):
        return cls(
            encoder=AVHubertConfig.tiny(),
            num_classes=16,
            final_dim=16,
            mask_length=3,
        )


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


class AVHubertPretrainModel(AVHubertModel):
    def __init__(self, cfg: AVHubertPretrainConfig, device=None, dtype=None):
        # the JAX model's encoder: no dropout, the default positional conv
        enc = replace(cfg.encoder, dropout=0.0, conv_pos=AVHubertConfig.conv_pos,
                      conv_pos_groups=AVHubertConfig.conv_pos_groups)
        super().__init__(enc, audio=True, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.pretrain_cfg = cfg
        d = cfg.encoder.encoder_embed_dim
        self.mask_emb = nn.Parameter(torch.zeros(d, **kw))
        self.final_proj = nn.Linear(d, cfg.final_dim, **kw)
        self.label_embs_concat = nn.Parameter(torch.zeros(cfg.num_classes, cfg.final_dim, **kw))

    def forward(self, audio: Optional[torch.Tensor], video: Optional[torch.Tensor],
                targets: torch.Tensor, lengths: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None,
                output_layer: Optional[int] = None):
        """The losses (a dict), or with ``output_layer`` the unmasked [B, T, D]
        state after that encoder layer (0: the fused front end), the
        iteration-2 feature dump.  ``train`` masks (uniforms from
        ``generator``) and runs the ResNet on batch statistics."""
        cfg = self.pretrain_cfg
        masking = train and output_layer is None
        if masking and generator is None:
            raise ValueError("a training forward draws its span masks from a generator")
        x = self.features(audio, video, train)
        if output_layer == 0:
            return x
        b, t = x.shape[:2]
        if masking:
            u = span_uniforms(generator, b, t, cfg.mask_prob, cfg.mask_length)
            mask = span_mask_from_uniforms(u, t, lengths, cfg.mask_length)
        else:
            mask = torch.zeros((b, t), dtype=torch.bool, device=x.device)
        x = apply_feature_mask(x, mask, self.mask_emb)
        x = self.encoder(x, lengths=lengths, output_layer=output_layer)
        if output_layer is not None:
            return x

        pn = _unit(self.final_proj(x))
        ln = _unit(self.label_embs_concat).to(pn.dtype)
        temp = torch.tensor(cfg.logit_temp, dtype=pn.dtype, device=pn.device)
        logits = torch.einsum("btd,cd->btc", pn, ln) / temp
        valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        masked = mask & valid
        logp = torch.log_softmax(logits.float(), dim=-1)
        token_logp = logp.gather(-1, targets.long()[..., None])[..., 0]

        def masked_mean(sel):
            # on a mesh: the batch group's count, the rank's share of the mean
            n = torch.clamp(batch_total(sel.sum()), min=1)
            return -torch.where(sel, token_logp, 0.0).sum() / n, n

        loss_m, n_m = masked_mean(masked)
        loss_u, _ = masked_mean(~mask & valid)
        hits = masked & (logits.argmax(dim=-1) == targets.long())
        acc_m = batch_total(hits.sum()) / torch.clamp(batch_total(masked.sum()), min=1)
        return {"loss_masked": loss_m, "loss_unmasked": loss_u, "n_masked": n_m,
                "acc_masked": acc_m, "mask": mask}


@register_model("av_hubert_pretrain", config=AVHubertPretrainConfig)
class AVHubertPretrainSystem:
    def __init__(self, cfg: AVHubertPretrainConfig, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        self.cfg = cfg
        self.module = AVHubertPretrainModel(cfg, device=device, dtype=dtype).eval()

    @classmethod
    def from_config(cls, cfg, dtype: torch.dtype = torch.float32, device="cuda"):
        return cls(cfg, dtype, device)
