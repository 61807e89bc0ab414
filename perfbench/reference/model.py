"""The plain reference of the speech systems the benchmark drives.

Frozen copies of the PyTorch port's plain modules, written again in plain
``torch`` with no kernel, cache, mesh or tensor split: Whisper-medium's
encoder, AV-HuBERT-Large with its ResNet-18 front end, the speech-rate
predictor, the Q-Former and projector (``AVSREncoder``), the NoLLM speech
head (Conformer-L and the 128-band mel head), the E2E model and the HiFi-GAN
generator, and the masked mel L1.  Attention is the plain softmax product
wherever the port launches its flash kernel.  Parameter and buffer names are
the port's, so one state dict loads into both.

Departures from the port, none of which changes the mathematics: Whisper
runs its 1500 frames unpadded (the port pads to 1536 and masks the pad out
of every key set); the resize of the head takes its gradient through plain
gathers; a trained Conformer block keeps only its input for the backward
and runs again there, its dropout masks replayed (``_remat``).

``set_precision(model, "fp8")`` rounds the operands of every product and
convolution (weights, inputs, attention's q, k, v and probabilities) to
float8 e4m3 with one scale a tensor, the gradient passing straight through:
the control that computes the reference one precision below bf16.

Imports: torch and numpy only.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax -> 448); the gradient
    passes straight through."""
    d = x.detach()
    scale = d.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = (d.float() / scale).to(torch.float8_e4m3fn).float().mul(scale).to(x.dtype)
    return x + (q - d)


class _Prec:
    """Mixin: ``self.fp8`` rounds the operands of this layer's product."""

    fp8 = False

    def r(self, t):
        return fp8_round(t) if self.fp8 and t is not None else t


def set_precision(model: nn.Module, mode: Optional[str]) -> None:
    """None: the operands as given (f32 in the reference); "fp8": rounded."""
    if mode not in (None, "fp8"):
        raise ValueError(mode)
    for m in model.modules():
        if isinstance(m, _Prec):
            m.fp8 = mode == "fp8"


class Linear(_Prec, nn.Linear):
    def forward(self, x):
        return F.linear(self.r(x), self.r(self.weight), self.bias)


class Conv1d(_Prec, nn.Conv1d):
    def forward(self, x):
        return F.conv1d(self.r(x), self.r(self.weight), self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Conv2d(_Prec, nn.Conv2d):
    def forward(self, x):
        return F.conv2d(self.r(x), self.r(self.weight), self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class _Attend(_Prec, nn.Module):
    """Softmax attention over [B, H, T, D]; keys past ``kv_lens`` masked."""

    def forward(self, q, k, v, kv_lens=None):
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.einsum("bhqd,bhkd->bhqk", self.r(q).float(), self.r(k).float()) * scale
        if kv_lens is not None:
            keep = torch.arange(k.shape[2], device=q.device)[None, None, None, :] \
                < kv_lens[:, None, None, None]
            s = torch.where(keep, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", self.r(p).to(v.dtype), self.r(v))


def dropout(x, rate: float, rng: Optional[torch.Generator]):
    """flax Dropout with the mask ``rand >= rate`` drawn from ``rng``."""
    if rng is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def batch_norm_train(h, norm, momentum: float = 0.9, channel_dim: int = -1):
    """flax BatchNorm on batch statistics (biased variance); moves the
    running statistics of ``norm`` in place."""
    dims = [d for d in range(h.ndim) if d != channel_dim % h.ndim]
    shape = [1] * h.ndim
    shape[channel_dim] = -1
    mean, mean_sq = h.mean(dim=dims), (h * h).mean(dim=dims)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        for stat, b in ((norm.running_mean, mean), (norm.running_var, var)):
            stat.copy_(momentum * stat.float() + (1.0 - momentum) * b)
    scale = torch.rsqrt(var + norm.eps) * norm.weight.float()
    return (h - mean.view(shape)) * scale.view(shape) + norm.bias.float().view(shape)


def _remat(fn, *args, rng=None):
    """``fn(*args)`` keeping only its inputs for the backward; the dropout
    draws of the recompute are the forward's (the generator replayed)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    before, calls = (rng.get_state() if rng is not None else None), []

    def replayed(*a):
        if not calls or rng is None:
            calls.append(1)
            return fn(*a)
        now = rng.get_state()
        rng.set_state(before)
        try:
            return fn(*a)
        finally:
            rng.set_state(now)

    return checkpoint(replayed, *args, use_reentrant=False)


def _layers(module, layers, prefix="layers"):
    for i, layer in enumerate(layers):
        module.add_module(f"{prefix}_{i}", layer)
    return list(layers)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# ---- attention and transformer blocks ----------------------------------------


class MHA(nn.Module):
    def __init__(self, d, heads, kv_dim=None, dropout=0.0, k_bias=True):
        super().__init__()
        self.heads, self.dropout = heads, dropout
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(kv_dim or d, d, bias=k_bias)
        self.v_proj = Linear(kv_dim or d, d)
        self.out_proj = Linear(d, d)
        self.attend = _Attend()

    def forward(self, x, kv=None, kv_lens=None, rng=None):
        kv = x if kv is None else kv
        b, tq, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, hd).transpose(1, 2)

        out = self.attend(split(self.q_proj(x)), split(self.k_proj(kv)), split(self.v_proj(kv)),
                          kv_lens)
        out = dropout(out.transpose(1, 2).reshape(b, tq, d), self.dropout, rng)
        return self.out_proj(out)


class FFN(nn.Module):
    def __init__(self, d, hidden, act):
        super().__init__()
        self.act = act
        self.fc1, self.fc2 = Linear(d, hidden), Linear(hidden, d)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class TLayer(nn.Module):
    """wav2vec2 pre-LN layer (no dropout: the encoders here are frozen)."""

    def __init__(self, d, heads, ffn):
        super().__init__()
        self.self_attn = MHA(d, heads)
        self.ffn = FFN(d, ffn, gelu_tanh)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, kv_lens=None):
        x = x + self.self_attn(self.self_attn_layer_norm(x), kv_lens=kv_lens)
        return x + self.ffn(self.final_layer_norm(x))


class PosConv(nn.Module):
    def __init__(self, d, k, groups):
        super().__init__()
        self.k = k
        self.conv = Conv1d(d, d, k, padding=k // 2, groups=groups)

    def forward(self, x):
        pos = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.k % 2 == 0:
            pos = pos[:, :-1]
        return gelu_tanh(pos)


class TEncoder(nn.Module):
    """wav2vec2 encoder, pre-LN: conv positions, the layers, a final LN."""

    def __init__(self, d, n, heads, ffn, conv_pos=128, conv_groups=16):
        super().__init__()
        self.pos_conv = PosConv(d, conv_pos, conv_groups)
        self.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.layers = _layers(self, [TLayer(d, heads, ffn) for _ in range(n)])

    def forward(self, x, lengths=None):
        if lengths is not None:
            keep = torch.arange(x.shape[1], device=x.device)[None, :, None] < lengths[:, None, None]
            x = x * keep.to(x.dtype)
        x = x + self.pos_conv(x)
        for layer in self.layers:
            x = layer(x, kv_lens=lengths)
        return self.layer_norm(x)


# ---- Whisper --------------------------------------------------------------------


def sinusoids(n, dim, base=10000.0):
    half = dim // 2
    freq = np.exp(-math.log(base) * np.arange(half) / (half - 1 if half > 1 else 1))
    pos = np.arange(n)[:, None] * freq[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32)


class WhisperLayer(nn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = MHA(d, heads, k_bias=False)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.ffn = FFN(d, ffn, F.gelu)

    def forward(self, x):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.ffn(self.final_layer_norm(x))


class Whisper(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c["d_model"]
        self.conv1 = Conv1d(c["n_mels"], d, 3, padding=1)
        self.conv2 = Conv1d(d, d, 3, stride=2, padding=1)
        self.layers = _layers(self, [WhisperLayer(d, c["num_heads"], c["ffn_dim"])
                                     for _ in range(c["num_layers"])])
        self.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.register_buffer("positions", torch.tensor(sinusoids(c["max_frames"], d)),
                             persistent=False)

    def forward(self, mel):
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positions[None, :x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


# ---- AV-HuBERT ------------------------------------------------------------------


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5)


def bn_eval(x, n):
    return F.batch_norm(x, n.running_mean, n.running_var, n.weight, n.bias, False, 0.0, n.eps)


class Block(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1, self.relu1 = _bn(planes), nn.PReLU(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2, self.relu2 = _bn(planes), nn.PReLU(planes)
        self.down = stride != 1 or cin != planes
        if self.down:
            self.downsample_conv = Conv2d(cin, planes, 1, stride, 0, bias=False)
            self.downsample_bn = _bn(planes)

    def forward(self, x):
        h = self.relu1(bn_eval(self.conv1(x), self.bn1))
        h = bn_eval(self.conv2(h), self.bn2)
        r = bn_eval(self.downsample_conv(x), self.downsample_bn) if self.down else x
        return self.relu2(h + r)


class Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 64
        for li, (planes, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            for bi in range(2):
                self.add_module(f"layer{li + 1}_{bi}", Block(cin, planes, stride if bi == 0 else 1))
                cin = planes

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x.mean(dim=(2, 3))


class ResNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.frontend_conv = Conv2d(5, 64, 7, stride=2, padding=3, bias=False)
        self.frontend_bn, self.frontend_relu = _bn(64), nn.PReLU(64)
        self.trunk = Trunk()

    def forward(self, video):
        b, t, h, w, _ = video.shape
        frames = F.pad(video[..., 0], (0, 0, 0, 0, 2, 2))
        taps = torch.stack([frames[:, j:j + t] for j in range(5)], dim=2)
        x = self.frontend_conv(taps.reshape(b * t, 5, h, w))
        x = F.max_pool2d(self.frontend_relu(bn_eval(x, self.frontend_bn)), 3, stride=2, padding=1)
        return self.trunk(x).reshape(b, t, 512)


class AVHubert(nn.Module):
    """The video-only encoder of the AVSR front end (concat fuse, the audio
    stream's features zero)."""

    def __init__(self, c):
        super().__init__()
        d = c["encoder_embed_dim"]
        self.video_resnet = ResNet()
        self.video_proj = Linear(512, d)
        self.layer_norm = nn.LayerNorm(2 * d, eps=1e-5)
        self.post_extract_proj = Linear(2 * d, d)
        self.encoder = TEncoder(d, c["encoder_layers"], c["encoder_attention_heads"],
                                c["encoder_ffn_dim"], c["conv_pos"], c["conv_pos_groups"])

    def forward(self, video, lengths):
        v = self.video_proj(self.video_resnet(video))
        x = self.post_extract_proj(self.layer_norm(torch.cat([torch.zeros_like(v), v], dim=-1)))
        return self.encoder(x, lengths)


class SRPredictor(nn.Module):
    def __init__(self, in_dim, n):
        super().__init__()
        self.linear = Linear(in_dim, 256)
        self.sr_token = nn.Parameter(torch.zeros(1, 1, 256))
        self.encoder = TEncoder(256, n, 4, 1024)
        self.sr_predictor = Linear(256, 1)

    def forward(self, x):
        x = self.linear(x)
        x = torch.cat([self.sr_token.expand(x.shape[0], 1, 256), x], dim=1)
        return F.relu(self.sr_predictor(self.encoder(x)[:, 0]))


# ---- Q-Former and the fused front end ------------------------------------------------


class QLayer(nn.Module):
    def __init__(self, d, heads, inter, enc_width, p):
        super().__init__()
        self.p = p
        self.self_attn = MHA(d, heads, dropout=p)
        self.self_ln = nn.LayerNorm(d, eps=1e-12)
        self.cross_attn = MHA(d, heads, kv_dim=enc_width, dropout=p)
        self.cross_ln = nn.LayerNorm(d, eps=1e-12)
        self.intermediate_query = Linear(d, inter)
        self.output_query = Linear(inter, d)
        self.ffn_ln = nn.LayerNorm(d, eps=1e-12)

    def forward(self, x, enc, query_lens, enc_lens, rng):
        x = self.self_ln(x + self.self_attn(x, kv_lens=query_lens, rng=rng))
        x = self.cross_ln(x + self.cross_attn(x, enc, kv_lens=enc_lens, rng=rng))
        h = self.output_query(F.gelu(self.intermediate_query(x)))
        return self.ffn_ln(x + dropout(h, self.p, rng))


class QFormer(nn.Module):
    def __init__(self, n, d, enc_width, max_queries, p=0.1):
        super().__init__()
        self.p, self.max_queries = p, max_queries
        self.query_tokens = nn.Parameter(torch.zeros(1, max_queries, d))
        self.embeddings_ln = nn.LayerNorm(d, eps=1e-12)
        self.layers = _layers(self, [QLayer(d, max(d // 64, 1), 4 * d, enc_width, p)
                                     for _ in range(n)])

    def forward(self, enc, query_lens, enc_lens, rng):
        x = dropout(self.embeddings_ln(self.query_tokens.expand(enc.shape[0], -1, -1)), self.p, rng)
        for layer in self.layers:
            x = layer(x, enc, query_lens, enc_lens, rng)
        valid = torch.arange(self.max_queries, device=x.device)[None, :, None] \
            < query_lens[:, None, None]
        return torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))


class Projector(nn.Module):
    def __init__(self, i, h, o):
        super().__init__()
        self.layers_0, self.layers_1 = Linear(i, h), Linear(h, o)

    def forward(self, x):
        return self.layers_1(self.layers_0(x))


def linear_resize(x, src_len, tgt_len, t_out):
    """Per-row linear resize along time (half-pixel centres), zero past
    ``tgt_len``."""
    t_in, dev = x.shape[1], x.device
    src, tgt = src_len.float(), tgt_len.float()
    t = torch.arange(t_out, dtype=torch.float32, device=dev)[None, :]
    pos = (t + 0.5) * (src / tgt)[:, None] - 0.5
    pos = torch.minimum(torch.clamp(pos, min=0.0), src[:, None] - 1.0)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.minimum(lo + 1, (src[:, None] - 1).to(torch.int32))
    frac = (pos - lo.float())[..., None].to(x.dtype)
    d = x.shape[2]
    x_lo = torch.gather(x, 1, lo.clamp(0, t_in - 1).long()[..., None].expand(-1, -1, d))
    x_hi = torch.gather(x, 1, hi.clamp(0, t_in - 1).long()[..., None].expand(-1, -1, d))
    out = x_lo * (1.0 - frac) + x_hi * frac
    valid = (torch.arange(t_out, device=dev)[None, :] < tgt_len[:, None])[..., None]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=dev))


class Encoder(nn.Module):
    """Whisper + AV-HuBERT -> concat fusion -> Q-Former -> projector, with
    the speech-rate predictor and batch-level modality dropout."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        wd, ad = c["whisper"]["d_model"], c["avhubert"]["encoder_embed_dim"]
        fa = 1024 if wd == 1024 else wd
        self.sr = c["use_sr_predictor"]
        if c["modality_dropout"]:
            self.audio_mask_emb = nn.Parameter(torch.zeros(fa))
            self.video_mask_emb = nn.Parameter(torch.zeros(fa))
        self.whisper = Whisper(c["whisper"])
        self.avhubert = AVHubert(c["avhubert"])
        if ad != fa:
            self.avhubert_bridge = Linear(ad, fa)
        if self.sr:
            if wd != 1024:
                self.sr_bridge = Linear(wd, 1024)
            self.sr_predictor = SRPredictor(1024, c["sr_predictor_layers"])
        self.afeat_1d_conv = Conv1d(wd, fa, 2, stride=2)
        self.max_queries = c["queries_per_sec"] * 20 * (2 if self.sr else 1)
        self.qformer = QFormer(c["qformer_layers"], c["qformer_dim"], 2 * fa, self.max_queries)
        llama = c["llama"]["hidden_size"]
        self.avfeat_to_llm = Projector(c["qformer_dim"], (c["qformer_dim"] + llama) // 2, llama)

    def forward(self, audio_feats, video, video_lengths, mode, rng=None):
        c = self.c
        t_v = video.shape[1]
        with torch.no_grad():
            w = self.whisper(audio_feats[..., : 2 * c["whisper"]["max_frames"]])
            av = self.avhubert(video, video_lengths)
            factor = torch.ones(video.shape[0], device=video.device)
            if self.sr:
                sr_in = w[:, : 2 * t_v: 4, :]
                if hasattr(self, "sr_bridge"):
                    sr_in = self.sr_bridge(sr_in)
                factor = torch.clamp(self.sr_predictor(sr_in)[:, 0], 1.0, 2.0)
        if hasattr(self, "avhubert_bridge"):
            av = self.avhubert_bridge(av)
        qps = c["queries_per_sec"]
        base = video_lengths.float() / 25.0 * qps
        query_lens = torch.clamp((base * factor).to(torch.int32), min=qps)
        query_lens = torch.clamp(query_lens, max=self.max_queries)
        resized = torch.clamp((factor * video_lengths.float()).to(torch.int32), min=1)
        a = self.afeat_1d_conv(w.transpose(1, 2)).transpose(1, 2)[:, :t_v]
        if self.c["modality_dropout"] and mode == 1:
            a = self.audio_mask_emb.expand_as(a)
        if self.c["modality_dropout"] and mode == 2:
            av = self.video_mask_emb.expand_as(av)
        feat = linear_resize(torch.cat([a, av], dim=-1), video_lengths, resized, 2 * t_v)
        q = self.qformer(feat, query_lens, resized, rng)
        return self.avfeat_to_llm(q), query_lens


# ---- the Conformer head -------------------------------------------------------------------


def conformer_positions(n, dim):
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(np.log(10000.0) / dim))
    pe = np.zeros((n, dim), dtype=np.float32)
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return pe


class PFF(nn.Module):
    def __init__(self, d, h, p):
        super().__init__()
        self.p = p
        self.w_1, self.w_2 = Linear(d, h), Linear(h, d)

    def forward(self, x, rng):
        return self.w_2(dropout(F.relu(self.w_1(x)), self.p, rng))


class ConvModule(nn.Module):
    def __init__(self, d, k):
        super().__init__()
        self.k = k
        self.pointwise_conv1 = Linear(d, 2 * d)
        self.depthwise_conv = Conv1d(d, d, k, padding=(k - 1) // 2, groups=d)
        self.norm = nn.BatchNorm1d(d, eps=1e-5)
        self.pointwise_conv2 = Linear(d, d)

    def forward(self, x, mask, train):
        h = F.glu(self.pointwise_conv1(x), dim=-1) * mask.to(x.dtype)
        h = self.depthwise_conv(h.transpose(1, 2)).transpose(1, 2)
        n = self.norm
        if train:
            h = batch_norm_train(h, n)
        else:
            h = bn_eval(h.transpose(1, 2), n).transpose(1, 2)
        return self.pointwise_conv2(h * torch.sigmoid(h))


class CBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, p = c["attention_dim"], c["dropout_rate"]
        self.p = p
        ln = lambda: nn.LayerNorm(d, eps=1e-12)  # noqa: E731
        self.norm_ff_macaron, self.ff_macaron = ln(), PFF(d, c["linear_units"], p)
        self.norm_mha, self.self_attn = ln(), MHA(d, c["attention_heads"], dropout=p)
        self.norm_conv, self.conv_module = ln(), ConvModule(d, c["cnn_kernel"])
        self.norm_ff, self.ff = ln(), PFF(d, c["linear_units"], p)
        self.norm_final = ln()

    def forward(self, x, lengths, train, rng):
        mask = torch.arange(x.shape[1], device=x.device)[None, :, None] < lengths[:, None, None]
        x = x + 0.5 * dropout(self.ff_macaron(self.norm_ff_macaron(x), rng), self.p, rng)
        x = x + dropout(self.self_attn(self.norm_mha(x), kv_lens=lengths, rng=rng), self.p, rng)
        x = x + dropout(self.conv_module(self.norm_conv(x), mask, train), self.p, rng)
        x = x + 0.5 * dropout(self.ff(self.norm_ff(x), rng), self.p, rng)
        return self.norm_final(x)


class Conformer(nn.Module):
    def __init__(self, c, in_dim):
        super().__init__()
        self.c = c
        if in_dim != c["attention_dim"]:
            self.input_proj = Linear(in_dim, c["attention_dim"])
        self.blocks = _layers(self, [CBlock(c) for _ in range(c["num_blocks"])], prefix="blocks")
        self.after_norm = nn.LayerNorm(c["attention_dim"], eps=1e-12)

    def forward(self, x, lengths, train, rng):
        if hasattr(self, "input_proj"):
            x = self.input_proj(x)
        t, d = x.shape[1], self.c["attention_dim"]
        x = x * math.sqrt(d) + torch.from_numpy(conformer_positions(t, d)).to(x.device)
        x = dropout(x, self.c["dropout_rate"], rng)
        for block in self.blocks:
            x = _remat(lambda h, b=block: b(h, lengths, train, rng), x, rng=rng) if train \
                else block(x, lengths, train, rng)
        return self.after_norm(x)


class Head(nn.Module):
    def __init__(self, c, emit_mel=True):
        super().__init__()
        self.c, self.emit_mel = c, emit_mel
        h = c["conformer"]["attention_dim"]
        self.proj1 = Linear(c["llama"]["hidden_size"], c["proj_mid_dim"])
        self.proj2 = Linear(c["proj_mid_dim"], c["head_dim"])
        self.ln1 = nn.LayerNorm(c["proj_mid_dim"], eps=1e-5)
        self.ln2 = nn.LayerNorm(c["head_dim"], eps=1e-5)
        self.ln3 = nn.LayerNorm(h, eps=1e-5)
        self.conformer = Conformer(c["conformer"], c["head_dim"])
        if emit_mel:
            self.mel_head = Linear(h, c["mel_bins"])

    def forward(self, tokens, token_lens, mel_lens, train, rng):
        x = self.ln1(self.proj1(tokens))
        x = linear_resize(x, token_lens, mel_lens, self.c["max_mel_frames"])
        x = self.ln3(self.conformer(self.ln2(self.proj2(x)), mel_lens, train, rng))
        return self.mel_head(x) if self.emit_mel else x


def mel_lengths(audio_lengths, hop):
    return torch.clamp(audio_lengths // hop, min=1).to(torch.int32)


class NoLLM(nn.Module):
    """The NoLLM speech head: [B, max_mel_frames, 128] mel (or the
    Conformer's features with ``emit_mel=False``)."""

    def __init__(self, c, emit_mel=True):
        super().__init__()
        self.c = c
        self.encoder = Encoder(c)
        self.head = Head(c, emit_mel)

    def forward(self, batch, mode=0, train=False, rng=None):
        q, q_lens = self.encoder(batch["audio_feats"], batch["video"], batch["video_lengths"],
                                 mode, rng)
        mel_lens = mel_lengths(batch["audio_lengths"], self.c["hop"])
        return self.head(q, q_lens, mel_lens, train, rng), mel_lens


def masked_l1(pred, target, lengths):
    t = min(pred.shape[1], target.shape[1])
    pred, target = pred[:, :t], target[:, :t]
    keep = (torch.arange(t, device=pred.device)[None, :] < lengths[:, None])[..., None]
    diff = (pred - target).abs() * keep.to(pred.dtype)
    return diff.sum() / torch.clamp(keep.sum() * pred.shape[-1], min=1.0)


# ---- HiFi-GAN -----------------------------------------------------------------------


def weight_norm(v, g):
    norm = v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return g.reshape(-1, *([1] * (v.ndim - 1))) * v / norm.clamp_min(1e-12)


class WNConv(_Prec, nn.Module):
    """Weight-normalised conv: v [O, I, K] (transposed: [I, O, K]), g, bias."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1, transposed=False):
        super().__init__()
        self.transposed = transposed
        self.v = nn.Parameter(torch.zeros((cin, cout, k) if transposed else (cout, cin, k)))
        self.g = nn.Parameter(torch.ones(cin if transposed else cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x):
        w = self.r(weight_norm(self.v, self.g))
        if self.transposed:
            return F.conv_transpose1d(self.r(x), w, self.bias, self.stride, self.padding)
        return F.conv1d(self.r(x), w, self.bias, self.stride, self.padding, self.dilation)


def _pad(k, d):
    return (k * d - d) // 2


def _masked(h, lengths):
    if lengths is None:
        return h
    return h * (torch.arange(h.shape[-1], device=h.device)[None, None, :]
                < lengths[:, None, None]).to(h.dtype)


class ResBlock(nn.Module):
    def __init__(self, ch, k, dil):
        super().__init__()
        self.n = len(dil)
        for i, d in enumerate(dil):
            self.add_module(f"convs1_{i}", WNConv(ch, ch, k, padding=_pad(k, d), dilation=d))
            self.add_module(f"convs2_{i}", WNConv(ch, ch, k, padding=_pad(k, 1)))

    def forward(self, x, lengths):
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(_masked(F.leaky_relu(x, 0.1), lengths))
            x = x + getattr(self, f"convs2_{i}")(_masked(F.leaky_relu(h, 0.1), lengths))
        return x


class Generator(nn.Module):
    """mel or features [B, T, C] -> waveform [B, T * prod(ups), 1]."""

    def __init__(self, c, in_channels):
        super().__init__()
        self.c = c
        ch = c["upsample_initial_channel"]
        self.conv_pre = WNConv(in_channels, ch, 7, padding=3)
        blocks = []
        for i, (u, k) in enumerate(zip(c["upsample_factors"], c["upsample_kernel_sizes"])):
            ch = c["upsample_initial_channel"] // (2 ** (i + 1))
            self.add_module(f"ups_{i}", WNConv(2 * ch, ch, k, stride=u, padding=(k - u) // 2,
                                               transposed=True))
            blocks += [ResBlock(ch, rk, rd) for rk, rd in
                       zip(c["resblock_kernel_sizes"], c["resblock_dilations"])]
        self.resblocks = _layers(self, blocks, prefix="resblocks")
        self.conv_post = WNConv(ch, 1, 7, padding=3)

    def forward(self, x, lengths=None):
        nk = len(self.c["resblock_kernel_sizes"])
        x = self.conv_pre(_masked(x.transpose(1, 2), lengths))
        for i, u in enumerate(self.c["upsample_factors"]):
            x = getattr(self, f"ups_{i}")(_masked(F.leaky_relu(x, 0.1), lengths))
            lengths = None if lengths is None else lengths * u
            acc = None
            for block in self.resblocks[i * nk:(i + 1) * nk]:
                z = block(x, lengths)
                acc = z if acc is None else acc + z
            x = acc / nk
        x = _masked(F.leaky_relu(x, 0.01), lengths)
        return torch.tanh(self.conv_post(x)).transpose(1, 2)


class E2E(nn.Module):
    """The NoLLM trunk's Conformer features through the generator."""

    def __init__(self, c):
        super().__init__()
        self.trunk = NoLLM(c, emit_mel=False)
        self.generator = Generator(c["vocoder"], c["head_dim"])

    def forward(self, batch):
        feats, lens = self.trunk(batch)
        return self.generator(feats, lens)[..., 0], lens


class Vocoder(nn.Module):
    """The NoLLM synthesis's vocoder: mel [B, T, 128] -> waveform [B, T * 160]."""

    def __init__(self, c):
        super().__init__()
        self.generator = Generator(c["vocoder"], c["mel_bins"])

    def forward(self, mel):
        return self.generator(mel)[..., 0]


def build(config: Dict, part: str) -> nn.Module:
    """The reference module ``part`` ("nollm", "e2e", "vocoder") of a
    configuration file's ``model`` section, in f32 on the CPU."""
    return {"nollm": NoLLM, "e2e": E2E, "vocoder": Vocoder}[part](config)
