"""MMS-LLaMA-class AVSR serving: Whisper + AV-HuBERT -> Q-Former -> LLaMA.

Port of ``multimodalvc_tpu/models/avsr.py`` for the serving path:
``AVSRSystem.generate`` runs the encoders (optionally in batch chunks),
assembles the left-padded prompt, prefills LLaMA and beam-decodes over the
split cache (ancestry decode with an int8 or bf16 KV cache, or the gather
reorder), with float, int8 or int4 weights (``enable_quantized_decode``),
n-gram blocking, lexical constraints and ensembles of systems;
``generate_long_form`` decodes clips longer than one window in chunks.

Training: ``AVSRModel.forward(batch, train)`` is the LM-loss forward (the
frozen encoders and the speech-rate predictor under ``torch.no_grad()``, as
the JAX package stops their gradient; dropout in the Q-Former and the LoRA
adapters drawn from an explicit generator), ``AVSRSystem.loss_fn`` /
``make_trainer_loss_fn`` feed ``runtime/trainer.py``, and
``FROZEN_PATTERNS`` names what the trainer freezes.  The modules stay in
eval mode throughout (the ResNet's BatchNorm on its running statistics):
dropout follows the generator passed in, not the module mode.

``AVSRConfig`` carries the JAX package's encoder configurations: the
fusion (``modality_fuse`` "concat", "add" or "cross-att"), the speech-rate
predictor (``use_sr_predictor``) and batch-level modality dropout
(``modality_dropout``, the mode taken from the batch), which the speech
heads (``models/speech.py``) build on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.registry import register_model
from ..criterions.lm import lm_metrics
from ..nn.avhubert import AVHubertConfig, AVHubertModel
from ..nn.init import init_random_
from ..nn.llama import (
    LlamaConfig,
    LlamaModel,
    cross_entropy_lm_loss,
    generate_beam,
    pipeline_lm_forward,
    quantize_llama_,
)
from ..nn.modules import MultimodalAttention, Projector, SpeechRatePredictor
from ..nn.qformer import QFormer, QFormerConfig
from ..nn.whisper import WhisperEncoder, WhisperEncoderConfig
from ..ops.constraints import (
    SequenceArrays,
    TrieArrays,
    build_ordered,
    build_unordered,
    pack_constraints,
)
from ..ops.interpolate import linear_resize_batched
from ..parallel.tensor import vocab_parallel
from ..runtime.tracing import span

LLAMA3_EOS = 128001  # <|end_of_text|>
LLAMA3_PAD = 128004  # <|finetune_right_pad_id|>
IGNORE_INDEX = -100


@dataclass
class AVSRConfig:
    whisper: WhisperEncoderConfig = field(default_factory=WhisperEncoderConfig)
    avhubert: AVHubertConfig = field(default_factory=AVHubertConfig)
    llama: LlamaConfig = field(default_factory=LlamaConfig)
    qformer_layers: int = 2
    qformer_dim: int = 1024
    modality_fuse: str = "concat"  # concat | add | cross-att
    use_qformer: bool = True  # carried for the config files; the Q-Former always runs, as in JAX
    queries_per_sec: int = 3
    use_sr_predictor: bool = True
    sr_predictor_layers: int = 2
    max_video_frames: int = 500  # 20 s at 25 Hz
    eos_token_id: int = LLAMA3_EOS
    pad_token_id: int = LLAMA3_PAD
    # learned mask embeddings that replace a whole encoder stream, the
    # stream chosen by the batch's modality_mode (0 both, 1 video only,
    # 2 audio only)
    modality_dropout: bool = False

    @property
    def max_queries(self) -> int:
        # queries_per_sec * 20 s, doubled for the speech-rate predictor's range
        return int(self.queries_per_sec * 20 * (2 if self.use_sr_predictor else 1))

    @property
    def fused_dim(self) -> int:
        """The fused width of the full-width encoders (1024 each)."""
        return 2 * 1024 if self.modality_fuse == "concat" else 1024

    @classmethod
    def tiny(cls):
        return cls(
            whisper=WhisperEncoderConfig(
                n_mels=80, d_model=64, num_layers=2, num_heads=4, ffn_dim=128, max_frames=64
            ),
            avhubert=AVHubertConfig.tiny(),
            llama=LlamaConfig.tiny(vocab_size=512),
            qformer_dim=32,
            queries_per_sec=2,
            use_sr_predictor=True,
            max_video_frames=16,
            eos_token_id=2,
            pad_token_id=0,
        )


FUSE_MODES = ("concat", "add", "cross-att")


class AVSREncoder(nn.Module):
    """Everything before the LLM: acoustic/visual encoders -> fused queries.
    The audio stream (Whisper, halved to the video rate) and the video
    stream (AV-HuBERT) are concatenated, added, or fused by
    ``MultimodalAttention``; with ``modality_dropout`` the batch's mode
    swaps one stream for its mask embedding first."""

    def __init__(self, cfg: AVSRConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        if cfg.modality_fuse not in FUSE_MODES:
            raise ValueError(f"modality_fuse {cfg.modality_fuse!r} not in {FUSE_MODES}")
        wd, ad = cfg.whisper.d_model, cfg.avhubert.encoder_embed_dim
        self.fused_a = 1024 if wd == 1024 else wd
        if cfg.modality_dropout:
            self.audio_mask_emb = nn.Parameter(torch.zeros(self.fused_a, **kw))
            self.video_mask_emb = nn.Parameter(torch.zeros(self.fused_a, **kw))
        self.whisper = WhisperEncoder(cfg.whisper, **kw)
        self.avhubert = AVHubertModel(cfg.avhubert, **kw)
        if ad != self.fused_a:
            self.avhubert_bridge = nn.Linear(ad, self.fused_a, **kw)
        if cfg.use_sr_predictor:
            if wd != 1024:
                self.sr_bridge = nn.Linear(wd, 1024, **kw)
            self.sr_predictor = SpeechRatePredictor(1024, cfg.sr_predictor_layers, **kw)
        self.afeat_1d_conv = nn.Conv1d(wd, self.fused_a, 2, stride=2, **kw)
        if cfg.modality_fuse == "cross-att":
            self.fusion = MultimodalAttention(self.fused_a, num_heads=8, **kw)
        self.qformer = QFormer(
            QFormerConfig(
                num_layers=cfg.qformer_layers,
                hidden_size=cfg.qformer_dim,
                num_heads=max(cfg.qformer_dim // 64, 1),
                intermediate_size=cfg.qformer_dim * 4,
                encoder_width=(2 if cfg.modality_fuse == "concat" else 1) * self.fused_a,
                max_queries=cfg.max_queries,
            ),
            **kw,
        )
        llama_dim = cfg.llama.hidden_size
        self.avfeat_to_llm = Projector(
            cfg.qformer_dim, (cfg.qformer_dim + llama_dim) // 2, llama_dim, **kw
        )

    def forward(self, audio_feats: torch.Tensor, video: torch.Tensor,
                video_lengths: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None,
                modality_mode=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio_feats [B, n_mels, 2F], video [B, T_v, H, W, 1], video_lengths
        [B] -> (queries [B, Q, llama_dim], query_lens [B]).  The frozen
        encoders and the speech-rate predictor run without a gradient;
        ``dropout_rng`` (training) draws the Q-Former's dropout.
        ``modality_mode`` (a scalar for the whole batch: 0 both streams, 1
        video only, 2 audio only; None is 0) takes effect with
        ``modality_dropout``; both encoders run in every mode."""
        with span("layer.encoder"):
            return self._forward(audio_feats, video, video_lengths, dropout_rng, modality_mode)

    def _forward(self, audio_feats, video, video_lengths, dropout_rng, modality_mode):
        cfg = self.cfg
        t_v = video.shape[1]
        with torch.no_grad():
            whisper_out = self.whisper(audio_feats)
            av_out = self.avhubert(video=video, lengths=video_lengths)
        if hasattr(self, "avhubert_bridge"):
            av_out = self.avhubert_bridge(av_out)

        # speech-rate-aware query budget
        base_queries = video_lengths.float() / 25.0 * cfg.queries_per_sec
        if cfg.use_sr_predictor:
            with torch.no_grad():
                sr_in = whisper_out[:, : 2 * t_v : 4, :]  # 50 Hz -> 12.5 Hz view
                if hasattr(self, "sr_bridge"):
                    sr_in = self.sr_bridge(sr_in)
                factor = torch.clamp(self.sr_predictor(sr_in)[:, 0], 1.0, 2.0)
        else:
            factor = torch.ones_like(base_queries)
        query_lens = torch.clamp((base_queries * factor).to(torch.int32), min=cfg.queries_per_sec)
        query_lens = torch.clamp(query_lens, max=cfg.max_queries)
        resized_lens = torch.clamp((factor * video_lengths.float()).to(torch.int32), min=1)

        # 50 Hz -> 25 Hz audio conv, then align to the video frames
        a = self.afeat_1d_conv(whisper_out.transpose(1, 2)).transpose(1, 2)[:, :t_v]
        if cfg.modality_dropout:
            mode = torch.as_tensor(0 if modality_mode is None else modality_mode)
            if mode.device != a.device:
                with span("encoder.mode.wait"):  # a host number copied to the device
                    mode = mode.to(a.device)
            a = torch.where(mode == 1, self.audio_mask_emb.to(a.dtype).expand_as(a), a)
            av_out = torch.where(mode == 2, self.video_mask_emb.to(av_out.dtype)
                                 .expand_as(av_out), av_out)
        if cfg.modality_fuse == "concat":
            av_feat = torch.cat([a, av_out], dim=-1)
        elif cfg.modality_fuse == "add":
            av_feat = a + av_out
        else:
            av_feat = self.fusion(a, av_out, kv_lens=video_lengths)
        av_feat = linear_resize_batched(av_feat, video_lengths, resized_lens, 2 * t_v)
        queries = self.qformer(av_feat, query_lens=query_lens, enc_lens=resized_lens,
                               dropout_rng=dropout_rng)
        return self.avfeat_to_llm(queries), query_lens


def assemble_left_padded(
    pad_emb: torch.Tensor,  # [D]
    inst_emb: torch.Tensor,  # [B, Ti, D]
    queries: torch.Tensor,  # [B, Q, D]
    query_lens: torch.Tensor,  # [B]
    label_emb: Optional[torch.Tensor] = None,  # [B, Tl, D]
    label_tokens: Optional[torch.Tensor] = None,  # [B, Tl] (pad entries ignored)
    label_lens: Optional[torch.Tensor] = None,  # [B]
):
    """Vectorized [pad.. | instruction | queries | labels] left-pad assembly:
    output slot j of row i holds content index j - (L - c_i), routed to the
    instruction, the queries or the labels by range, else the pad
    embedding.  Returns (embeds [B, L, D], attn_mask [B, L] int32), and with
    labels also the slot labels [B, L] (the label tokens on their slots,
    ``IGNORE_INDEX`` elsewhere)."""
    b, ti, d = inst_emb.shape
    q = queries.shape[1]
    tl = label_emb.shape[1] if label_emb is not None else 0
    l_total = ti + q + tl
    dev = inst_emb.device
    q_lens = query_lens.long()
    lab_lens = label_lens.long() if label_lens is not None else torch.zeros_like(q_lens)
    content_len = ti + q_lens + lab_lens  # [B]
    j = torch.arange(l_total, device=dev)[None, :]
    ci = j - (l_total - content_len[:, None])  # content index per slot
    in_inst = (ci >= 0) & (ci < ti)
    in_query = (ci >= ti) & (ci < ti + q_lens[:, None])
    gather = lambda src, i: torch.gather(src, 1, i[..., None].expand(-1, -1, d))  # noqa: E731
    out = torch.where(in_inst[..., None], gather(inst_emb, ci.clamp(0, ti - 1)), pad_emb[None, None, :])
    out = torch.where(in_query[..., None], gather(queries, (ci - ti).clamp(0, q - 1)), out)
    mask = (ci >= 0).to(torch.int32)
    if label_emb is None:
        return out, mask
    in_label = ci >= ti + q_lens[:, None]
    lab_idx = (ci - ti - q_lens[:, None]).clamp(0, tl - 1)
    out = torch.where(in_label[..., None], gather(label_emb, lab_idx), out)
    labels = torch.where(in_label, torch.gather(label_tokens.long(), 1, lab_idx),
                         torch.full_like(lab_idx, IGNORE_INDEX))
    return out, mask, labels


def train_rng(train: bool, generator: Optional[torch.Generator]):
    """The generator a forward draws its dropout from: ``generator`` in
    training (which needs one), None in evaluation."""
    if train and generator is None:
        raise ValueError("a training forward draws its dropout from a torch.Generator")
    return generator if train else None


class AVSRModel(nn.Module):
    """Encoder + prompt assembly + the LLaMA trunk (the flax AVSRModel tree)."""

    def __init__(self, cfg: AVSRConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = AVSREncoder(cfg, device=device, dtype=dtype)
        self.llama = LlamaModel(cfg.llama, device=device, dtype=dtype)

    def encode_queries(self, batch: Dict[str, torch.Tensor],
                       dropout_rng: Optional[torch.Generator] = None):
        return self.encoder(batch["audio_feats"], batch["video"], batch["video_lengths"],
                            dropout_rng)

    def build_prompt(self, queries, query_lens, batch, with_labels: bool = False):
        dev = queries.device
        pad_emb = self.llama.embed(torch.tensor(self.cfg.pad_token_id, device=dev))
        inst_emb = self.llama.embed(batch["instruction"].long())
        queries = queries.to(inst_emb.dtype)
        if not with_labels:
            return assemble_left_padded(pad_emb, inst_emb, queries, query_lens)
        labels = batch["labels"].long()
        return assemble_left_padded(pad_emb, inst_emb, queries, query_lens,
                                    self.llama.embed(labels.clamp(min=0)), labels,
                                    batch["label_lengths"])

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The training / validation forward: (loss, aux) with the LM loss
        over the label slots and aux's logits, labels, hidden, attn_mask,
        query_lens, n_correct, n_valid.  ``train`` draws the dropout (the
        Q-Former's and LoRA's) from ``generator``."""
        rng = train_rng(train, generator)
        queries, query_lens = self.encode_queries(batch, rng)
        emb, attn_mask, labels = self.build_prompt(queries, query_lens, batch, with_labels=True)
        out = self.llama(inputs_embeds=emb, attn_mask=attn_mask, dropout_rng=rng,
                         return_hidden=True)
        loss, n_correct, n_valid = cross_entropy_lm_loss(
            out["logits"], labels, vocab=vocab_parallel(self.llama.embed_tokens))
        return loss, {"logits": out["logits"], "labels": labels, "hidden": out["hidden"],
                      "attn_mask": attn_mask, "query_lens": query_lens,
                      "n_correct": n_correct, "n_valid": n_valid}

    def prompt_for_training(self, batch: Dict[str, torch.Tensor], train: bool = True,
                            generator: Optional[torch.Generator] = None):
        """Encoders + prompt assembly with the labels: (embeds, attn_mask,
        slot labels), the front half of ``forward``, for a caller that runs
        the LLaMA trunk itself (the JAX package's pipelined loss)."""
        queries, query_lens = self.encode_queries(batch, train_rng(train, generator))
        return self.build_prompt(queries, query_lens, batch, with_labels=True)

    def prompt_for_generation(self, batch: Dict[str, torch.Tensor]):
        queries, query_lens = self.encode_queries(batch)
        return self.build_prompt(queries, query_lens, batch)


def merge_token_rows(rows, eos_token_id: int, pad_token_id: int, dedup: bool = True) -> np.ndarray:
    """Stitch per-chunk transcripts into one token row (whisper-style).

    Each row is cleaned (cut at EOS, pad dropped); with ``dedup``
    consecutive rows are joined with the longest exact suffix/prefix token
    overlap removed.  ``dedup=False`` (for chunks that do not overlap)
    concatenates unchanged, so genuinely repeated words across a chunk
    boundary survive."""

    def clean(row):
        out = []
        for t in row:
            t = int(t)
            if t == eos_token_id:
                break
            if t != pad_token_id:
                out.append(t)
        return out

    rows = list(rows)
    merged = clean(rows[0]) if rows else []
    for row in rows[1:]:
        nxt = clean(row)
        k = 0
        if dedup:
            for cand in range(min(len(merged), len(nxt)), 0, -1):
                if merged[len(merged) - cand :] == nxt[:cand]:
                    k = cand
                    break
        merged.extend(nxt[k:])
    return np.asarray(merged, np.int32)


def resolve_ancestry_reorder(kv_quant: Optional[str], device: torch.device | str) -> bool:
    """``generate``'s default beam reorder, the JAX package's rule
    (models/avsr.py:516-517) with CUDA as the accelerator: the ancestry decode
    for an int8 KV cache or on the accelerator, the gather reorder on the CPU."""
    return bool(kv_quant) or torch.device(device).type == "cuda"


@register_model("mms_llama_avsr", config=AVSRConfig)
class AVSRSystem:
    """Bundles the module with generation (HF-generate-equivalent decode) and
    the training loss."""

    # frozen in training, matched against the state_dict names joined by "/"
    # (runtime/trainer.py: trainable_mask); the LoRA adapters of the LLaMA
    # always train
    FROZEN_PATTERNS = [
        r"encoder/whisper/",
        r"encoder/avhubert/",
        r"encoder/sr_predictor/",
        r"^llama/",
    ]

    def __init__(self, cfg: AVSRConfig, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.module = AVSRModel(cfg, device=device, dtype=dtype).eval()
        self.llama_module = self.module.llama

    def frozen_patterns(self):
        return list(self.FROZEN_PATTERNS)

    def loss_fn(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None):
        """(loss, aux) of the module's training forward: the JAX
        ``AVSRSystem.loss_fn``, kept under its name for callers ported from
        the JAX package."""
        return self.module(batch, train=train, generator=generator)

    def make_trainer_loss_fn(self):
        """(batch, generator) -> (loss, metrics) for ``Trainer``: the training
        forward with dropout, and the criterion's metrics (``lm_metrics``)."""

        def loss_fn(batch, generator):
            loss, aux = self.module(batch, train=True, generator=generator)
            return loss, lm_metrics(loss, aux)

        return loss_fn

    def make_pipeline_loss_fn(self, mesh, n_microbatches: int):
        """(batch, generator) -> (loss, metrics) with the LLaMA decoder
        pipelined over the mesh's pipeline axis (GPipe; the JAX
        ``make_pipeline_loss_fn``).  Every pipeline rank runs the encoders
        and the prompt assembly on its batch, with the same dropout draws;
        the LoRA dropout of the trunk draws from one seed taken from
        ``generator`` (``pipeline_lm_forward``).  The trunk's final norm and
        embedding table run on every stage and must be frozen (they are:
        ``^llama/``)."""
        module, lora = self.module, self.cfg.llama.lora
        use_dropout = lora is not None and lora.dropout > 0

        def loss_fn(batch, generator):
            emb, attn_mask, labels = module.prompt_for_training(batch, train=True,
                                                                generator=generator)
            seed = None
            if use_dropout:
                seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                                         device=generator.device))
            logits = pipeline_lm_forward(module.llama, emb, attn_mask, mesh, n_microbatches,
                                         dropout_seed=seed)
            loss, n_correct, n_valid = cross_entropy_lm_loss(
                logits, labels, vocab=vocab_parallel(module.llama.embed_tokens))
            return loss, lm_metrics(loss, {"n_correct": n_correct, "n_valid": n_valid})

        return loss_fn

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        init_random_(self.module, seed)

    def enable_quantized_decode(self, mode: str = "int8") -> None:
        """Serve the LLaMA with weight-only quantized weights: quantize the
        live trunk and the tied unembed in place on their device (``mode``
        "int8", or "int4" with group-128 scales) and free the float base
        weights, so one trunk stays resident.  The prompt assembly reads the
        input table, which drops to bf16, as in the JAX package."""
        quantize_llama_(self.llama_module, mode)

    def enable_int8_decode(self) -> None:
        self.enable_quantized_decode("int8")

    @torch.inference_mode()
    def prompt(self, batch: Dict[str, torch.Tensor], encoder_microbatch: int = 0):
        """Encoders + prompt assembly: (embeddings [B, L, D], mask [B, L]).
        ``encoder_microbatch`` > 1 runs them in that many sequential batch
        chunks; the prompt width (instruction + ``max_queries``) does not
        depend on the chunk, so the chunks concatenate."""
        if encoder_microbatch <= 1:
            return self.module.prompt_for_generation(batch)
        nb = next(iter(batch.values())).shape[0]
        if nb % encoder_microbatch:
            raise ValueError(
                f"batch {nb} not divisible by encoder_microbatch {encoder_microbatch}")
        size = nb // encoder_microbatch
        parts = [self.module.prompt_for_generation({k: x[i : i + size] for k, x in batch.items()})
                 for i in range(0, nb, size)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, torch.Tensor],
        num_beams: int = 5,
        max_new_tokens: int = 100,
        length_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        cache_dtype: torch.dtype = torch.bfloat16,
        ancestry_reorder: Optional[bool] = None,
        kv_quant: Optional[str] = None,
        encoder_microbatch: int = 0,
        constraints=None,
        constraints_mode: str = "unordered",
        ensemble: Sequence["AVSRSystem"] = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search transcription: (sequences [B, K, max_new_tokens],
        scores [B, K]).  ``ancestry_reorder=None`` resolves as in the JAX
        package (``resolve_ancestry_reorder``); ``kv_quant="int8"`` needs the
        ancestry decode.  ``encoder_microbatch`` > 1 runs the encoders and
        the prompt assembly in that many batch chunks.

        ``constraints``: lexically constrained transcription, a per-row list
        of phrases, each a list of token ids (an empty list leaves its row
        unconstrained), or a built ``TrieArrays`` / ``SequenceArrays``;
        ``constraints_mode`` "unordered" or "ordered".  Constraints take the
        gather reorder and a float KV cache, as in the JAX package.

        ``ensemble``: further systems of the same config (their own weights)
        that decode together with this one; each runs its own encoders, and
        every step averages the members' log-probs."""
        constraint_set = None
        if constraints is not None:
            if isinstance(constraints, (TrieArrays, SequenceArrays)):
                constraint_set = constraints
            else:
                build = build_ordered if constraints_mode == "ordered" else build_unordered
                constraint_set = build(pack_constraints(constraints))
            ancestry_reorder, kv_quant = False, None
        if ancestry_reorder is None:
            ancestry_reorder = resolve_ancestry_reorder(
                kv_quant, self.llama_module.norm.weight.device)
        systems = [self, *ensemble]
        prompts = [s.prompt(batch, encoder_microbatch) for s in systems]
        single = len(systems) == 1
        return generate_beam(
            self.llama_module if single else [s.llama_module for s in systems],
            prompts[0][0] if single else [p[0] for p in prompts],
            prompts[0][1] if single else [p[1] for p in prompts],
            eos_token_id=self.cfg.eos_token_id, pad_token_id=self.cfg.pad_token_id,
            num_beams=num_beams, max_new_tokens=max_new_tokens,
            length_penalty=length_penalty, no_repeat_ngram_size=no_repeat_ngram_size,
            cache_dtype=cache_dtype, ancestry_reorder=ancestry_reorder, kv_quant=kv_quant,
            constraints=constraint_set, constraints_mode=constraints_mode,
        )

    def generate_long_form(
        self,
        batch: Dict[str, torch.Tensor],
        chunk_frames: int = 400,
        overlap_frames: int = 0,
        merge: bool = True,
        **gen_kwargs,
    ):
        """Chunked long-form transcription: a window of ``chunk_frames`` video
        frames slides over the clip (stride ``chunk_frames -
        overlap_frames``), the mel features following at 4 frames per video
        frame, and each window is decoded by ``generate``.

        ``batch["audio_feats"]`` must be the full-clip mel features [B, 80,
        >= 4 * video frames].  With ``merge`` (the default) each sample's
        chunk transcripts are stitched by ``merge_token_rows`` (the overlap
        dedup only where the windows overlap) into one token row per sample;
        ``merge=False`` returns the per-chunk best rows of each sample."""
        video = batch["video"]
        lengths = batch["video_lengths"].cpu().numpy()
        b, t_total = video.shape[0], video.shape[1]
        stride = chunk_frames - overlap_frames
        if stride <= 0:
            raise ValueError("overlap must be smaller than the chunk")
        audio_feats = batch["audio_feats"]
        # 8 mel frames of slack: real corpora round audio a frame or two short
        if t_total > chunk_frames and audio_feats.shape[-1] < 4 * int(max(lengths)) - 8:
            raise ValueError(
                f"audio_feats covers {audio_feats.shape[-1]} mel frames but the clip spans "
                f"{int(max(lengths))} video frames (~{4 * int(max(lengths))} mel frames at "
                "100 Hz); pass full-clip mel features, not a single 30 s whisper window")
        texts = [[] for _ in range(b)]
        a_window = 2 * self.cfg.whisper.max_frames  # the encoder's window
        for start in range(0, max(t_total - overlap_frames, 1), stride):
            end = min(start + chunk_frames, t_total)
            if end <= start:
                break
            v = video[:, start:end]
            pad = chunk_frames - (end - start)
            if pad:
                v = torch.cat([v, v.new_zeros((b, pad) + tuple(v.shape[2:]))], dim=1)
            chunk_lens = np.clip(lengths - start, 0, chunk_frames).astype(np.int32)
            # the mel features run at 4x the video rate
            a_start = min(4 * start, max(audio_feats.shape[-1] - 1, 0))
            a = audio_feats[..., a_start : a_start + a_window]
            a = F.pad(a, (0, a_window - a.shape[-1]))
            chunk_batch = {**batch, "video": v, "audio_feats": a,
                           "video_lengths": torch.from_numpy(np.maximum(chunk_lens, 1)).to(
                               batch["video_lengths"].device)}
            seqs, _ = self.generate(chunk_batch, **gen_kwargs)
            best = seqs[:, 0].cpu().numpy()
            for i in range(b):
                if chunk_lens[i] > 0:
                    texts[i].append(best[i])
        if not merge:
            return texts
        return [merge_token_rows(rows, self.cfg.eos_token_id, self.cfg.pad_token_id,
                                 dedup=overlap_frames > 0) for rows in texts]
