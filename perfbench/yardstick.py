"""The arithmetic the metrics are measured against: the card's peaks, the
least time a kernel could take, attention's work and the model FLOPs of a
batch.  Later changes to the program do not move it.

``bound`` and ``flash_bound`` are copied from ``chip_smoke.py`` (``bound``,
``flash_bound``, the peaks ``HBM_BPS`` / ``BF16_FLOPS``): bytes over the memory
rate against operations over the peak, each input read and each output
written once, K1's bytes from the pairs its lengths allow.
"""
from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA's data sheet, H100 SXM, dense: bytes/s of HBM3, bf16 tensor FLOP/s
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12


def bound(moved: float, ops: float = 0.0, peak: float = BF16_FLOPS) -> float:
    """The least seconds the card could take: the larger of ``moved`` bytes
    over the memory rate and ``ops`` operations over ``peak``."""
    return max(moved / HBM_BPS, ops / peak)


def attention_pairs(t: int, kv_lens: Sequence[int]) -> int:
    """(query, key) pairs a self-attention over ``t`` positions computes with
    each row's keys cut at its length: every query row sees its row's
    valid keys."""
    return sum(t * min(int(n), t) for n in kv_lens)


def flash_fwd(b: int, h: int, t: int, d: int, kv_lens: Sequence[int], elem: int = 2) -> Dict:
    """K1's forward at [b, h, t, d], keys cut at ``kv_lens``: QK^T and PV, 4 h d
    operations a pair; q read for the rows that have a valid key, K and V for
    the rows some query sees, the whole output written, the lengths read
    (``chip_smoke.py: flash_bound``)."""
    pairs = attention_pairs(t, kv_lens)
    q_rows = b * t
    kv_rows = sum(min(int(n), t) for n in kv_lens)
    moved = elem * h * d * (q_rows + 2 * kv_rows + b * t) + 4 * b
    ops = 4 * h * d * pairs
    return {"ops": ops, "bytes": moved, "bound_s": bound(moved, ops)}


def flash_bwd(b: int, h: int, t: int, d: int, kv_lens: Sequence[int], elem: int = 2) -> Dict:
    """The attention backward counted as FlashAttention-2's: five products,
    2.5x the forward's operations; q, k, v, o, dO and the f32 row statistics
    read once, dq, dk and dv written once."""
    pairs = attention_pairs(t, kv_lens)
    kv_rows = sum(min(int(n), t) for n in kv_lens)
    q_rows = b * t
    moved = elem * h * d * (3 * q_rows + 2 * kv_rows) + 4 * h * q_rows \
        + elem * h * d * (q_rows + 2 * kv_rows) + 4 * b
    ops = 10 * h * d * pairs
    return {"ops": ops, "bytes": moved, "bound_s": bound(moved, ops)}


# ---- model FLOPs ------------------------------------------------------------------
# Every product and convolution at the positions the inputs need: 2 FLOPs a
# multiply-add.  Normalisations, activations, softmax and masks are not
# counted.


def _linear(n: int, i: int, o: int) -> float:
    return 2.0 * n * i * o


def _attn(b: int, tq: int, tk: int, d: int) -> float:
    return 4.0 * b * tq * tk * d


def _tlayer(b: int, t: int, d: int, ffn: int, tk: int = None) -> float:
    tk = t if tk is None else tk
    return 4 * _linear(b * t, d, d) + _attn(b, t, tk, d) + 2 * _linear(b * t, d, ffn)


def whisper_flops(m: Dict, rows: int) -> float:
    """Whisper's encoder over its whole 30 s window (1500 frames)."""
    w = m["whisper"]
    t, d = w["max_frames"], w["d_model"]
    conv = 2.0 * rows * (2 * t) * w["n_mels"] * d * 3 + 2.0 * rows * t * d * d * 3
    return conv + w["num_layers"] * _tlayer(rows, t, d, w["ffn_dim"])


def _conv2d(n: int, cin: int, cout: int, k: int, hw_out: int) -> float:
    return 2.0 * n * cin * cout * k * k * hw_out * hw_out


def resnet_flops(frames: int, size: int) -> float:
    """The tap-stacked stem and ResNet-18 over ``frames`` frames of size^2."""
    def out(x, k, s, p):
        return (x + 2 * p - k) // s + 1
    h = out(size, 7, 2, 3)
    total = _conv2d(frames, 5, 64, 7, h)
    h = out(h, 3, 2, 1)
    cin = 64
    for planes, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        for bi in range(2):
            s = stride if bi == 0 else 1
            h2 = out(h, 3, s, 1)
            total += _conv2d(frames, cin, planes, 3, h2) + _conv2d(frames, planes, planes, 3, h2)
            if s != 1 or cin != planes:
                total += _conv2d(frames, cin, planes, 1, h2)
            cin, h = planes, h2
    return total


def _tencoder(t: int, d: int, n: int, heads_ffn: int, conv_pos: int, groups: int) -> float:
    pos = 2.0 * t * d * (d // groups) * conv_pos
    return pos + n * _tlayer(1, t, d, heads_ffn)


def avhubert_flops(m: Dict, frames: Sequence[int]) -> float:
    """AV-HuBERT over each clip's valid video frames."""
    a = m["avhubert"]
    d = a["encoder_embed_dim"]
    total = 0.0
    for t in frames:
        total += resnet_flops(t, m["image_size"]) + _linear(t, 512, d) + _linear(t, 2 * d, d)
        total += _tencoder(t, d, a["encoder_layers"], a["encoder_ffn_dim"], a["conv_pos"],
                           a["conv_pos_groups"])
    return total


def sr_flops(m: Dict, frames: Sequence[int]) -> float:
    """The speech-rate predictor over a quarter of each clip's Whisper rows
    (12.5 Hz) and its token."""
    total = 0.0
    for t in frames:
        n = (2 * t + 3) // 4 + 1
        total += _linear(n - 1, 1024, 256) + _tencoder(n, 256, m["sr_predictor_layers"], 1024,
                                                        128, 16) + _linear(1, 256, 1)
    return total


def fusion_flops(m: Dict, frames: Sequence[int], queries: Sequence[int]) -> float:
    """The 50 -> 25 Hz audio conv at the valid frames, the Q-Former's queries
    over the fused frames (2 a video frame) and the projector."""
    wd, q = m["whisper"]["d_model"], m["qformer_dim"]
    llama = m["llama"]["hidden_size"]
    total = 0.0
    for t, nq in zip(frames, queries):
        total += 2.0 * t * wd * wd * 2
        enc = 2 * t
        for _ in range(m["qformer_layers"]):
            total += 4 * _linear(nq, q, q) + _attn(1, nq, nq, q)
            total += 2 * _linear(nq, q, q) + 2 * _linear(enc, 2 * wd, q) + _attn(1, nq, enc, q)
            total += 2 * _linear(nq, q, 4 * q)
        total += _linear(nq, q, (q + llama) // 2) + _linear(nq, (q + llama) // 2, llama)
    return total


def head_flops(m: Dict, queries: Sequence[int], mel: Sequence[int], emit_mel: bool) -> float:
    """proj1 on the queries; proj2, Conformer-L and the mel head at each
    clip's valid mel frames."""
    c = m["conformer"]
    d, u, k = c["attention_dim"], c["linear_units"], c["cnn_kernel"]
    total = 0.0
    for nq, t in zip(queries, mel):
        total += _linear(nq, m["llama"]["hidden_size"], m["proj_mid_dim"])
        total += _linear(t, m["proj_mid_dim"], m["head_dim"])
        block = 2 * 2 * _linear(t, d, u) + 4 * _linear(t, d, d) + _attn(1, t, t, d) \
            + _linear(t, d, 2 * d) + 2.0 * t * d * k + _linear(t, d, d)
        total += c["num_blocks"] * block
        if emit_mel:
            total += _linear(t, d, m["mel_bins"])
    return total


def generator_flops(voc: Dict, in_channels: int, mel: Sequence[int]) -> float:
    """HiFi-GAN at each clip's valid mel frames: conv_pre, each upsampling
    (a transposed conv: 2 Cin Cout K a input frame), the multi-receptive-field
    blocks (two convs a dilation) and conv_post."""
    total = 0.0
    for t in mel:
        ch = voc["upsample_initial_channel"]
        total += 2.0 * t * in_channels * ch * 7
        n = t
        for i, (u, k) in enumerate(zip(voc["upsample_factors"], voc["upsample_kernel_sizes"])):
            out = voc["upsample_initial_channel"] // (2 ** (i + 1))
            total += 2.0 * n * (2 * out) * out * k
            n *= u
            for rk, dil in zip(voc["resblock_kernel_sizes"], voc["resblock_dilations"]):
                total += 2 * len(dil) * 2.0 * n * out * out * rk
            ch = out
        total += 2.0 * n * ch * 1 * 7
    return total


def query_counts(m: Dict, frames: Sequence[int]) -> list:
    """The Q-Former's valid queries a clip at a speech-rate factor of 1:
    frames / 25 * queries_per_sec, at least queries_per_sec."""
    qps = m["queries_per_sec"]
    return [min(max(int(t / 25.0 * qps), qps), qps * 40) for t in frames]


def step_flops(m: Dict, frames: Sequence[int], part: str, train: bool) -> float:
    """The model FLOPs of one batch of clips of ``frames`` video frames:
    frozen encoders forward only, trainable parts forward + 2x backward;
    ``part`` "nollm" (mel head, and with ``vocoder`` the mel vocoder),
    "nollm+vocoder" or "e2e" (the generator on the Conformer's features)."""
    per_frame_mel = 4  # 40 ms video frames, 10 ms mel frames
    mel = [min(per_frame_mel * t, m["max_mel_frames"]) for t in frames]
    queries = query_counts(m, frames)
    frozen = whisper_flops(m, len(frames)) + avhubert_flops(m, frames) + sr_flops(m, frames)
    trained = fusion_flops(m, frames, queries) + head_flops(m, queries, mel, part != "e2e")
    if part == "e2e":
        trained += generator_flops(m["vocoder"], m["head_dim"], mel)
    elif part == "nollm+vocoder":
        trained += generator_flops(m["vocoder"], m["mel_bins"], mel)
    return frozen + (3.0 if train else 1.0) * trained
