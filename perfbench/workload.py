"""The one generator of every traffic mix: clip lengths, batches and inputs.

A mix file (``traffic/<mix>.json``) gives the parameters; this module reads
no mix by name.  Clip lengths sit at fixed quantiles of a log-uniform
distribution, in whole video frames, so every seed has the same set of
lengths; ``--seed`` draws the contents and the order.  Inputs are padded as
the port's collate pads them (``data/dataset.py: AVSRDataset.collate``): the
video to the batch's length bucket, the Whisper features at their fixed 30 s
window, the target mels to the head's buffer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

WHISPER_PAD = -1.0  # the features past a clip's audio (Whisper's silence is a constant)


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, contents, order...)."""
    words = [int(seed) % 2 ** 64] + [sum(ord(c) << (8 * (i % 8)) for i, c in enumerate(str(t)))
                                     % 2 ** 64 for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0] >> 1)


def clip_frames(mix: Dict) -> List[int]:
    """The pool's clip lengths in video frames: quantile (i + 1/2) / n of the
    log-uniform distribution over [min_s, max_s]."""
    n, lo, hi = mix["pool"], mix["min_s"], mix["max_s"]
    fps = 1000.0 / mix["frame_ms"]
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n) * fps)) for i in range(n)]


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Copied from ``multimodalvc_tpu_torch/data/batching.py: bucket_for``."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def batch_by_size(sizes: Sequence[int], max_tokens: Optional[int], buckets: Sequence[int],
                  batch_size: Optional[int] = None) -> List[List[int]]:
    """The recipe's bucket rule, copied from
    ``multimodalvc_tpu_torch/data/batching.py: batches_in_order`` over the
    length-sorted indices (``required_multiple`` 1, unshuffled): a batch of n
    clips padded to bucket B costs n * B tokens, and is flushed when one more
    clip would pass ``max_tokens`` or ``batch_size``, or changes the bucket."""
    sizes = np.asarray(sizes)
    order = np.argsort(sizes, kind="stable")
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_bucket = 0
    for idx in order:
        b = bucket_for(int(sizes[idx]), buckets)
        new_bucket = max(cur_bucket, b)
        n = len(cur) + 1
        over_tokens = max_tokens is not None and n * new_bucket > max_tokens
        over_batch = batch_size is not None and n > batch_size
        if cur and (over_tokens or over_batch or b != cur_bucket):
            batches.append(cur)
            cur = []
            new_bucket = b
        cur.append(int(idx))
        cur_bucket = new_bucket
    if cur:
        batches.append(cur)
    return batches


def pool_batches(mix: Dict, seed: int) -> List[List[int]]:
    """The pool's batches as lists of clip ids, in the order of the first
    pass: the recipe's buckets ("batch_by_size"), or ``batch`` clips at a time,
    one of each length stratum ("stratified")."""
    frames = clip_frames(mix)
    if mix["batching"] == "batch_by_size":
        batches = batch_by_size(frames, mix["max_tokens"], mix["buckets"])
        order = np.random.default_rng(sub_seed(seed, "order", 0)).permutation(len(batches))
        return [batches[i] for i in order]
    if mix["batching"] == "stratified":
        # ``batch`` strata of the lengths, in order; each batch takes one clip
        # of each stratum, the seed choosing which, and arrives in the seed's
        # order, its rows unsorted: every seed's batches hold the same spread
        # of lengths (the same padding and as many distinct lengths)
        k, rng = mix["batch"], np.random.default_rng(sub_seed(seed, "arrival"))
        nb = len(frames) // k
        strata = [rng.permutation(np.arange(s * nb, (s + 1) * nb)) for s in range(k)]
        batches = [[int(strata[s][j]) for s in rng.permutation(k)] for j in range(nb)]
        return [batches[i] for i in rng.permutation(nb)]
    raise ValueError(f"batching {mix['batching']!r}")


def pass_order(mix: Dict, seed: int, n_batches: int, p: int) -> List[int]:
    """The batch order of pass ``p`` (from 0): reshuffled by the seed on every
    pass ("shuffle"), or the first pass's again ("repeat")."""
    if mix["order"] == "repeat" or p == 0:
        return list(range(n_batches))
    if mix["order"] == "shuffle":
        return [int(i) for i in
                np.random.default_rng(sub_seed(seed, "order", p)).permutation(n_batches)]
    raise ValueError(f"order {mix['order']!r}")


def make_batch(ids: Sequence[int], mix: Dict, model: Dict, seed: int, device,
               targets: bool) -> Dict[str, torch.Tensor]:
    """One collated batch of the clips ``ids``, its contents drawn on
    ``device`` from the seed and the first clip id: video frames N(0, 1)
    past the mouth-ROI normalisation, Whisper features N(0, 1) over the
    clip's audio and ``WHISPER_PAD`` after it, and with ``targets`` 128-band
    log-mel targets N(-5, 2) over the clip's frames, zero after."""
    frames = clip_frames(mix)
    lens = [frames[i] for i in ids]
    b, t_v = len(ids), bucket_for(max(lens), mix["buckets"])
    per_frame = round(mix["frame_ms"] * mix["sample_rate"] / 1000)  # audio samples a frame
    hop = model["hop"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "clips", ids[0]))
    v_len = torch.tensor(lens, dtype=torch.int32, device=device)
    a_len = v_len * per_frame
    mel_len = a_len // hop
    size = model["image_size"]
    video = torch.randn(b, t_v, size, size, 1, generator=g, device=device)
    video *= (torch.arange(t_v, device=device)[None, :] < v_len[:, None]).float()[..., None, None,
                                                                                   None]
    n_mels, t_a = model["whisper"]["n_mels"], 2 * model["whisper"]["max_frames"]  # 30 s at 100 Hz
    feats = torch.randn(b, n_mels, t_a, generator=g, device=device)
    past = torch.arange(t_a, device=device)[None, None, :] >= mel_len[:, None, None]
    feats = torch.where(past, torch.full((), WHISPER_PAD, device=device), feats)
    batch = {"video": video, "video_lengths": v_len, "audio_feats": feats,
             "audio_lengths": a_len}
    if targets:
        t = model["max_mel_frames"]
        mel = torch.randn(b, t, model["mel_bins"], generator=g, device=device) * 2.0 - 5.0
        keep = torch.arange(t, device=device)[None, :, None] < mel_len[:, None, None]
        batch["target_mel"] = mel * keep.float()
        batch["target_mel_lengths"] = torch.clamp(mel_len, max=t).to(torch.int32)
    return batch


def audio_seconds(ids: Sequence[int], mix: Dict) -> float:
    """Seconds of valid audio in the clips ``ids``."""
    frames = clip_frames(mix)
    return sum(frames[i] for i in ids) * mix["frame_ms"] / 1000.0


def mode_draws(p: Sequence[float], seed: int, n: int) -> List[int]:
    """The first ``n`` training batches' modality modes (0 both streams, 1
    video only, 2 audio only), drawn as the port's ``SpeechTask`` draws them
    (``tasks.py: _ModeDraw``: numpy's default_rng(seed), one choice a batch)."""
    rng = np.random.default_rng(seed)
    return [int(rng.choice(3, p=list(p))) for _ in range(n)]
