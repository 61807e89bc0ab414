"""Speech synthesis: the LLM-conditioned, NoLLM and E2E speech heads.

Port of ``multimodalvc_tpu/models/speech.py``:

- ``SpeechLLMModel``: the AVSR front end and LLaMA without its unembed;
  the query slots' hidden states (``extract_query_hiddens``) drive the mel
  head: proj1 -> resize to the mel frames -> proj2 -> Conformer -> 128-band
  mel head.
- ``SpeechNoLLMModel``: the projected Q-Former queries drive the head
  directly (with LayerNorms ln1 / ln2 / ln3), and the batch's
  ``modality_mode`` selects the streams (with ``modality_dropout``).
- ``SpeechE2EModel``: the NoLLM trunk's Conformer features go through a
  HiFi-GAN generator (``nn/hifigan.py``) to a waveform, masked by the mel
  lengths at every stage.

Every head writes a static buffer of ``max_mel_frames`` frames (2400, 24 s
at 100 Hz); row i is valid up to ``mel_lengths[i]`` = audio samples // 160.
``synthesize`` is the model half of the JAX ``cli/generate.py --mode
synthesize``: NoLLM mel, cut to each row's frames, then the vocoder.  On
the card each system serves in bf16, as ``AVSRSystem`` does (K1 takes bf16
only); ``device="cpu"`` runs the plain versions.

Every module's ``forward(batch, train=False, generator=None)`` is also the
training forward (the JAX ``deterministic=not train``): with ``train`` the
Q-Former, the LLaMA's LoRA adapters and the Conformer drop, their masks
drawn from ``generator``, and the Conformer's BatchNorm takes batch
statistics (``nn/conformer.py``).  The modules stay in eval mode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from ..config.registry import register_model
from ..nn.conformer import ConformerConfig, ConformerEncoder
from ..nn.hifigan import HifiGanConfig, HifiGanGenerator
from ..nn.init import init_random_
from ..nn.llama import LlamaModel
from ..ops.interpolate import linear_resize_batched
from ..runtime.tracing import span
# ``train_rng`` is called through its module: a caller that switches the
# dropout off replaces ``avsr.train_rng`` for a while, and a name bound here
# would keep whatever stood there when this module was first imported
from . import avsr
from .avsr import AVSRConfig, AVSREncoder, assemble_left_padded

MEL_BINS = 128
HOP = 160


@dataclass
class SpeechConfig(AVSRConfig):
    conformer_size: str = "L"
    # > 1 swaps each Conformer block's final FFN for an expert bank
    # (nn/conformer.py: BaseMoELayer, expert-parallel on a mesh)
    conformer_moe_experts: int = 0
    proj_mid_dim: int = 768
    head_dim: int = 512
    max_mel_frames: int = 2400  # 24 s at 100 Hz

    @classmethod
    def tiny(cls):
        base = AVSRConfig.tiny()
        return cls(
            whisper=base.whisper,
            avhubert=base.avhubert,
            llama=base.llama,
            qformer_dim=32,
            queries_per_sec=2,
            use_sr_predictor=False,
            max_video_frames=16,
            eos_token_id=2,
            pad_token_id=0,
            conformer_size="S",
            proj_mid_dim=48,
            head_dim=144,
            max_mel_frames=80,
        )


def mel_lengths_from_samples(audio_lengths: torch.Tensor) -> torch.Tensor:
    """max(samples // 160, 1): the mel frames of each row's audio."""
    return torch.clamp(audio_lengths // HOP, min=1).to(torch.int32)


def extract_query_hiddens(hidden: torch.Tensor, query_lens: torch.Tensor,
                          max_queries: int) -> torch.Tensor:
    """The query slots' hidden states out of the left-padded sequence [B, L,
    D]: query k of row i sits at slot L - q_i + k; [B, max_queries, D], zero
    past q_i."""
    b, l, d = hidden.shape
    k = torch.arange(max_queries, device=hidden.device)[None, :]
    idx = (l - query_lens.long()[:, None] + k).clamp(0, l - 1)
    out = torch.gather(hidden, 1, idx[..., None].expand(-1, -1, d))
    valid = (k < query_lens[:, None])[..., None]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


class SpeechHead(nn.Module):
    """proj1 -> (ln1) -> resize to the mel frames -> proj2 -> (ln2) ->
    Conformer -> (ln3) -> the mel head, or (``emit_mel=False``) the
    Conformer's features.  ``use_layer_norms`` is the NoLLM form."""

    def __init__(self, cfg: SpeechConfig, in_dim: int, use_layer_norms: bool = False,
                 emit_mel: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.use_layer_norms, self.emit_mel = cfg, use_layer_norms, emit_mel
        conf_cfg = ConformerConfig.sized(cfg.conformer_size, moe_experts=cfg.conformer_moe_experts)
        d = conf_cfg.attention_dim
        self.proj1 = nn.Linear(in_dim, cfg.proj_mid_dim, **kw)
        self.proj2 = nn.Linear(cfg.proj_mid_dim, cfg.head_dim, **kw)
        if use_layer_norms:
            self.ln1 = nn.LayerNorm(cfg.proj_mid_dim, eps=1e-5, **kw)
            self.ln2 = nn.LayerNorm(cfg.head_dim, eps=1e-5, **kw)
            self.ln3 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.conformer = ConformerEncoder(conf_cfg, cfg.head_dim, **kw)
        if emit_mel:
            self.mel_head = nn.Linear(d, MEL_BINS, **kw)

    def forward(self, tokens, token_lens, mel_lens, train: bool = False,
                dropout_rng: Optional[torch.Generator] = None):
        """tokens [B, Q, in_dim] valid to token_lens -> [B, max_mel_frames,
        128 (or the Conformer's width)] valid to mel_lens."""
        with span("layer.head"):
            x = self._norm("ln1", self.proj1(tokens))
            x = linear_resize_batched(x, token_lens, mel_lens, self.cfg.max_mel_frames)
            x = self._norm("ln2", self.proj2(x))
            x = self._norm("ln3", self.conformer(x, lengths=mel_lens, train=train,
                                                 dropout_rng=dropout_rng))
            return self.mel_head(x) if self.emit_mel else x

    def _norm(self, name: str, x):
        return getattr(self, name)(x) if self.use_layer_norms else x


class SpeechLLMModel(nn.Module):
    """LLaMA's hidden states on the query slots drive the mel head."""

    def __init__(self, cfg: SpeechConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = AVSREncoder(cfg, **kw)
        self.llama = LlamaModel(cfg.llama, **kw)
        self.head = SpeechHead(cfg, cfg.llama.hidden_size, use_layer_norms=False, **kw)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = avsr.train_rng(train, generator)
        queries, query_lens = self.encoder(batch["audio_feats"], batch["video"],
                                           batch["video_lengths"], dropout_rng=rng)
        dev = queries.device
        pad_emb = self.llama.embed(torch.tensor(cfg.pad_token_id, device=dev))
        inst_emb = self.llama.embed(batch["instruction"].long())
        emb, attn_mask = assemble_left_padded(pad_emb, inst_emb, queries.to(inst_emb.dtype),
                                              query_lens)
        out = self.llama(inputs_embeds=emb, attn_mask=attn_mask, dropout_rng=rng,
                         return_hidden=True, compute_logits=False)
        av_hidden = extract_query_hiddens(out["hidden"], query_lens, cfg.max_queries)
        mel_lens = mel_lengths_from_samples(batch["audio_lengths"])
        return {"melspec": self.head(av_hidden, query_lens, mel_lens, train, rng),
                "mel_lengths": mel_lens}


class SpeechNoLLMModel(nn.Module):
    """The projected Q-Former queries feed the head; the batch's
    ``modality_mode`` (0 both streams, 1 video only, 2 audio only) is
    honoured with ``modality_dropout``."""

    def __init__(self, cfg: SpeechConfig, emit_mel: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.emit_mel = cfg, emit_mel
        self.encoder = AVSREncoder(cfg, **kw)
        self.head = SpeechHead(cfg, cfg.llama.hidden_size, use_layer_norms=True,
                               emit_mel=emit_mel, **kw)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        rng = avsr.train_rng(train, generator)
        queries, query_lens = self.encoder(batch["audio_feats"], batch["video"],
                                           batch["video_lengths"], dropout_rng=rng,
                                           modality_mode=batch.get("modality_mode"))
        mel_lens = mel_lengths_from_samples(batch["audio_lengths"])
        out = self.head(queries, query_lens, mel_lens, train, rng)
        return {"melspec" if self.emit_mel else "features": out, "mel_lengths": mel_lens}


class SpeechE2EModel(nn.Module):
    """NoLLM trunk (Conformer features) -> HiFi-GAN -> waveform [B,
    max_mel_frames * 160, 1]; the generator's conv_pre takes the head's
    width (it is the head-to-vocoder adapter).  The generator may be kept
    in another dtype than the trunk (the GAN trainer keeps it in f32 under a
    bf16 trunk): the features are cast to it."""

    def __init__(self, cfg: SpeechConfig, vocoder: Optional[HifiGanConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        voc = vocoder or HifiGanConfig()
        self.cfg = cfg
        self.trunk = SpeechNoLLMModel(cfg, emit_mel=False, **kw)
        self.generator = HifiGanGenerator(HifiGanConfig(
            in_channels=cfg.head_dim,
            resblock_kernel_sizes=voc.resblock_kernel_sizes,
            resblock_dilations=voc.resblock_dilations,
            upsample_factors=voc.upsample_factors,
            upsample_kernel_sizes=voc.upsample_kernel_sizes,
            upsample_initial_channel=voc.upsample_initial_channel,
        ), **kw)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        out = self.trunk(batch, train, generator)
        features = out["features"].to(self.generator.conv_pre.v.dtype)
        wav = self.generator(features, lengths=out["mel_lengths"])
        return {"waveform": wav, "mel_lengths": out["mel_lengths"]}


class _SpeechSystem:
    """A speech module built on ``device`` (the card unless the caller passes
    "cpu") in ``dtype``, in eval mode.  ``system(batch)`` runs it under
    inference mode; flax trees load into ``system.module`` through the
    bridge."""

    def __init__(self, module: nn.Module):
        self.cfg = module.cfg
        self.module = module.eval()

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        init_random_(self.module, seed)

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.module(batch)


@register_model("mms_llama_speech", config=SpeechConfig)
class SpeechLLMSystem(_SpeechSystem):
    def __init__(self, cfg: SpeechConfig, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__(SpeechLLMModel(cfg, device=device, dtype=dtype))


@register_model("mms_speech_nollm", config=SpeechConfig)
class SpeechNoLLMSystem(_SpeechSystem):
    def __init__(self, cfg: SpeechConfig, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__(SpeechNoLLMModel(cfg, device=device, dtype=dtype))


@register_model("mms_speech_nollm_e2e", config=SpeechConfig)
class SpeechE2ESystem(_SpeechSystem):
    def __init__(self, cfg: SpeechConfig, vocoder: Optional[HifiGanConfig] = None,
                 dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"):
        super().__init__(SpeechE2EModel(cfg, vocoder, device=device, dtype=dtype))


@torch.inference_mode()
def synthesize(speech_system: SpeechNoLLMSystem, vocoder,
               batch: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Video + audio features -> one waveform a row: the NoLLM mel, each row
    cut to its ``mel_lengths`` frames, through ``vocoder.generate``
    (``models/vocoder.py: VocoderModel``); rows of one length share a call.
    Returns [mel_lengths[i] * 160] waveforms."""
    with span("synth.batch"):
        out = speech_system(batch)
        with span("synth.lengths.wait"):
            lens = out["mel_lengths"].tolist()
        mel = out["melspec"]
        wavs: List[Optional[torch.Tensor]] = [None] * len(lens)
        with span("synth.vocoder"):
            for n in sorted(set(lens)):
                rows = [i for i, m in enumerate(lens) if m == n]
                with span("synth.rows.wait"):  # the row list copied to the device
                    chosen = mel[rows, :n]
                wav = vocoder.generate(chosen)
                for j, i in enumerate(rows):
                    wavs[i] = wav[j]
        return wavs
