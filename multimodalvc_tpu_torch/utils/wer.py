"""Word and character error rates by Levenshtein distance.

Port of ``multimodalvc_tpu/utils/wer.py`` (its dynamic program; the JAX
package's optional native fast path is not needed at the sizes the port
scores).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = np.arange(lb + 1)
    cur = np.empty(lb + 1, dtype=np.int64)
    for i in range(1, la + 1):
        cur[0] = i
        ai = a[i - 1]
        for j in range(1, lb + 1):
            cost = 0 if ai == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev, cur = cur, prev
    return int(prev[lb])


def wer(hyps: List[str], refs: List[str]) -> Tuple[float, int, int]:
    """Corpus WER: (wer %, total errors, total reference words)."""
    errs = words = 0
    for h, r in zip(hyps, refs):
        hw, rw = h.split(), r.split()
        errs += edit_distance(hw, rw)
        words += len(rw)
    return (100.0 * errs / max(words, 1), errs, words)


def cer(hyps: List[str], refs: List[str]) -> float:
    errs = chars = 0
    for h, r in zip(hyps, refs):
        errs += edit_distance(list(h), list(r))
        chars += len(r)
    return 100.0 * errs / max(chars, 1)
