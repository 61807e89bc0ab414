"""Length-bucketed batch construction.

Port of the numpy path of ``multimodalvc_tpu/data/batching.py`` (the JAX
package's native fast path never loads: its ``data/native`` module does not
exist).  fairseq's ``batch_by_size`` cost model over length-sorted indices,
each batch padded to a bucket boundary, with fairseq's remainder carry under
``required_multiple``: no sample is ever dropped.  ``pack_token_blocks`` and
``block_to_dataset_index`` are fairseq's token-block packing (the JAX
package takes its 'complete' modes from ``native/``; the port has its own
numpy loop).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= length (longer lengths clamp to the last)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def batch_by_size(
    sizes: Sequence[int],
    max_tokens: Optional[int] = None,
    batch_size: Optional[int] = None,
    buckets: Sequence[int] = (100, 200, 300, 400, 500),
    required_multiple: int = 1,
    shuffle_seed: Optional[int] = None,
) -> List[np.ndarray]:
    """Group indices into batches of same-bucket samples.  A batch of n
    samples padded to bucket B costs n * B tokens; a batch is flushed when
    one more sample would pass ``max_tokens`` or ``batch_size``, or changes
    the bucket.  Returns a list of index arrays."""
    sizes = np.asarray(sizes)
    order = np.argsort(sizes, kind="stable")
    return _shuffled(batches_in_order(sizes, order, buckets, max_tokens, batch_size,
                                      required_multiple), shuffle_seed)


def batches_in_order(sizes: np.ndarray, order: Sequence[int], buckets: Sequence[int],
                     max_tokens: Optional[int], batch_size: Optional[int],
                     required_multiple: int) -> List[np.ndarray]:
    """``batch_by_size``'s batches over the length-sorted ``order``,
    unshuffled (``native.batch_by_size_native_plain`` shares it)."""
    batches: List[np.ndarray] = []
    cur: List[int] = []
    cur_bucket = 0
    for idx in order:
        b = bucket_for(int(sizes[idx]), buckets)
        new_bucket = max(cur_bucket, b)
        n = len(cur) + 1
        over_tokens = max_tokens is not None and n * new_bucket > max_tokens
        over_batch = batch_size is not None and n > batch_size
        if cur and (over_tokens or over_batch or b != cur_bucket):
            # flush the largest required_multiple-aligned prefix; the
            # remainder carries into the next batch
            keep = len(cur)
            if required_multiple > 1 and len(cur) >= required_multiple:
                keep = (len(cur) // required_multiple) * required_multiple
            batches.append(np.asarray(cur[:keep]))
            cur = cur[keep:]
            new_bucket = b  # carried items are shorter (sorted order)
        cur.append(int(idx))
        cur_bucket = new_bucket
    if cur:
        batches.append(np.asarray(cur))  # the final remainder, whole
    return batches


def _shuffled(batches: List[np.ndarray], seed: Optional[int]) -> List[np.ndarray]:
    if seed is None:
        return batches
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Repeat trailing rows so that dim 0 of every array is a multiple of
    ``multiple`` (the rows are those of the largest dim 0)."""
    sizes = {v.shape[0] for v in batch.values() if hasattr(v, "ndim") and v.ndim >= 1}
    if not sizes:
        return batch
    b = max(sizes)
    target = -(-b // multiple) * multiple
    if target == b:
        return batch
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == b:
            reps = np.concatenate([np.arange(b), np.full(target - b, b - 1)])
            out[k] = v[reps]
        else:
            out[k] = v
    return out


def pad_to(arr: np.ndarray, length: int, axis: int = 0, value=0) -> np.ndarray:
    """Pad or cut along one axis to a static length."""
    cur = arr.shape[axis]
    if cur == length:
        return arr
    if cur > length:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, length)
        return arr[tuple(sl)]
    cfg = [(0, 0)] * arr.ndim
    cfg[axis] = (0, length - cur)
    return np.pad(arr, cfg, constant_values=value)


def shard_batches(batches: List[np.ndarray], num_shards: int, shard_id: int,
                  fill: bool = True) -> List[np.ndarray]:
    """This rank's share of the batch list (fairseq's ``ShardedIterator``):
    every ``num_shards``-th batch from ``shard_id`` (the batch-group rank);
    with ``fill`` the share is topped up by wrapping round the list, so every
    rank takes the same number of steps."""
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} out of range for {num_shards}")
    if num_shards == 1:
        return list(batches)
    mine = batches[shard_id::num_shards]
    if fill:
        n_total = -(-len(batches) // num_shards)
        i = 0
        while len(mine) < n_total and batches:
            mine.append(batches[i % len(batches)])
            i += 1
    return mine


def _complete_blocks(sizes: np.ndarray, block_size: int, complete_doc: bool,
                     document_sep_len: int) -> np.ndarray:
    """Greedy whole-sentence packing (fairseq's 'complete' / 'complete_doc',
    token_block_utils_fast.pyx:66-97): a sentence joins the open block while
    the block stays within ``block_size`` (a longer one opens its own);
    with ``complete_doc`` a sentence of ``document_sep_len`` tokens closes
    the document and is skipped, and single-token blocks are dropped."""
    blocks = []
    tok_idx = curr = i = 0
    min_keep = 1 if complete_doc else 0
    while i < len(sizes):
        size = int(sizes[i])
        is_sep = complete_doc and size == document_sep_len
        if (curr + size <= block_size or curr == 0) and not is_sep:
            curr += size
            i += 1
            continue
        if curr > min_keep:
            blocks.append((tok_idx, tok_idx + curr))
        tok_idx += curr
        curr = 0
        if is_sep:
            tok_idx += size
            i += 1
    if curr > min_keep:
        blocks.append((tok_idx, tok_idx + curr))
    return np.asarray(blocks, np.int64).reshape(-1, 2)


def pack_token_blocks(sizes: Sequence[int], block_size: int, break_mode: Optional[str] = None,
                      document_sep_len: int = 1) -> np.ndarray:
    """Slice a concatenated token stream into LM training blocks: [N, 2]
    int64 (start, end) offsets into the flattened stream (fairseq's
    ``TokenBlockDataset``, token_block_utils_fast.pyx:52-106).  Break modes:

    - None / 'none': fixed ``block_size`` windows across sentence bounds;
    - 'complete': whole sentences packed greedily up to ``block_size`` (a
      longer sentence gets its own block);
    - 'complete_doc': the same, never across documents (a sentence of
      exactly ``document_sep_len`` tokens separates them); single-token
      blocks are dropped;
    - 'eos': one block a sentence.
    """
    sizes = np.asarray(sizes, np.int64)
    if break_mode is None or break_mode == "none":
        total = int(sizes.sum())
        starts = np.arange(0, total, block_size, dtype=np.int64)
        return np.stack([starts, np.minimum(starts + block_size, total)], axis=1)
    if break_mode == "eos":
        cum = sizes.cumsum()
        out = np.zeros((len(sizes), 2), np.int64)
        out[1:, 0] = cum[:-1]
        out[:, 1] = cum
        return out
    if break_mode not in ("complete", "complete_doc"):
        raise ValueError(f"Invalid break_mode: {break_mode}")
    return _complete_blocks(sizes, block_size, break_mode == "complete_doc", document_sep_len)


def block_to_dataset_index(sizes: Sequence[int], slice_indices: np.ndarray) -> np.ndarray:
    """Each (start, end) block as (start sentence, offset in it, end
    sentence) of the per-sentence dataset (token_block_utils_fast.pyx:109-139,
    ``DatasetSearcher``); an empty block (end <= start) ends where it
    starts."""
    sizes = np.asarray(sizes, np.int64)
    cum = np.concatenate([[0], sizes.cumsum()])
    out = np.zeros((len(slice_indices), 3), np.int64)
    s = slice_indices[:, 0]
    e = np.maximum(slice_indices[:, 1], s + 1)
    start_idx = np.searchsorted(cum, s, side="right") - 1
    end_idx = np.searchsorted(cum, e - 1, side="right") - 1
    out[:, 0] = start_idx
    out[:, 1] = s - cum[start_idx]
    out[:, 2] = np.where(slice_indices[:, 1] <= s, start_idx, end_idx)
    return out
