"""Host C++ routines bound with ctypes: edit distance, batching, token
blocks, the balanced assignment, BLEU counts and the n-gram ban.

Port of ``multimodalvc_tpu/native/__init__.py`` with its own copy of the five
sources (``editdist.cpp``, ``batching.cpp``, ``balanced_assignment.cpp``,
``ngram_block.cpp``, ``bleu.cpp``; reference: fairseq's libnat, the Cython
``batch_by_size`` and token blocks, libbase and libbleu).  The public
functions keep the JAX names and signatures.

Build: the host compiler (``$CXX``, else ``g++``) compiles the five sources
with ``-O3 -fPIC -std=c++17 -shared`` into one library at first use, keyed
on a hash of the sources, the compiler (its path and version) and the
flags, under ``build/native/`` at the repository root (listed in
``.gitignore``); the source tree is never written.  Nothing is built when
this module is imported.  There is no fallback: if the compiler is
missing, the build fails or the library does not load, the call raises
``NativeBuildError``.

Each public function has a plain Python / numpy twin named ``*_plain``,
used by the tests and the smoke run only: the JAX package's own fallback,
ported as it is (the edit distance's dynamic program is ``utils/wer.py``'s,
the batching loop ``data/batching.py``'s, the token blocks
``data/batching.py: _complete_blocks``).  ``balanced_assignment`` is the one
function whose two versions differ on purpose, as they do in the JAX
package: the C++ is an epsilon-scaling auction (every worker gets exactly
``n_jobs / n_workers`` jobs, a near-optimal total score), the plain version
the greedy fill (all pairs by score, each worker up to capacity, leftovers
to the least loaded).  Each is held against its own JAX twin.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..data.batching import _complete_blocks, batches_in_order
from ..utils.wer import edit_distance

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("editdist.cpp", "batching.cpp", "balanced_assignment.cpp", "ngram_block.cpp",
           "bleu.cpp")
BUILD_DIR = SRC_DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signatures of the sources: (restype, argtypes)
SIGNATURES = {
    "mmvc_edit_distance_i32": (_I64, [_P, _I64, _P, _I64]),
    "mmvc_batch_by_size": (_I64, [_P, _P, _I64, _P, _I64, _I64, _I64, _I64, _P]),
    "mmvc_token_blocks_complete": (_I64, [_P, _I64, _I64, _I64, _I64, _P]),
    "mmvc_balanced_assignment": (None, [_P, _I64, _I64, _P]),
    "mmvc_bleu_counts": (None, [_P, _I64, _P, _I64, _I64, _P, _P]),
    "mmvc_ngram_repeat_block": (None, [_P, _I64, _I64, _I64, _P, _I64, _P]),
}


class NativeBuildError(RuntimeError):
    pass


_LOCK = threading.Lock()
_LOADED: Optional[ctypes.CDLL] = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def compiler_id(cxx: str) -> str:
    """The compiler's path and the first line of its ``--version``."""
    path = shutil.which(cxx)
    if path is None:
        raise NativeBuildError(
            f"C++ compiler {cxx!r} not found: the host routines of "
            "multimodalvc_tpu_torch.native cannot be built, and there is no fallback")
    version = subprocess.run([path, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True).stdout
    return " ".join([path, *version.splitlines()[:1]])


def sources_hash(cxx_id: str) -> str:
    h = hashlib.sha256(" ".join((cxx_id, *CXX_FLAGS)).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path, cxx: str) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: concurrent processes never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(lib), *(str(SRC_DIR / s) for s in SOURCES)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise NativeBuildError(f"{cxx} failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}")
        os.replace(lib, out)


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; raise
    ``NativeBuildError`` if either fails."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        cxx = compiler()
        path = BUILD_DIR / f"libmmvc_native_{sources_hash(compiler_id(cxx))}.so"
        if not path.exists():
            _build(path, cxx)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LOADED = lib
        return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def edit_distance_native(a: Sequence, b: Sequence) -> int:
    """Edit distance over hashable items (words) through an id mapping."""
    lib = load()
    vocab: dict = {}
    ea, eb = (np.asarray([vocab.setdefault(x, len(vocab)) for x in seq], dtype=np.int32)
              for seq in (a, b))
    return int(lib.mmvc_edit_distance_i32(_ptr(ea), len(ea), _ptr(eb), len(eb)))


def edit_distance_native_plain(a: Sequence, b: Sequence) -> int:
    return edit_distance(a, b)


def batch_by_size_native(sizes: np.ndarray, order: np.ndarray, buckets: List[int],
                         max_tokens: int, batch_size: int,
                         required_multiple: int) -> List[np.ndarray]:
    """Bucketed batches of the length-sorted ``order`` (``max_tokens`` or
    ``batch_size`` 0: no limit), fairseq's remainder carry under
    ``required_multiple``: every index lands in exactly one batch."""
    lib = load()
    sizes64 = np.ascontiguousarray(sizes, dtype=np.int64)
    order64 = np.ascontiguousarray(order, dtype=np.int64)
    buckets64 = np.ascontiguousarray(buckets, dtype=np.int64)
    out = np.empty(len(order64), dtype=np.int32)
    n_batches = int(lib.mmvc_batch_by_size(
        _ptr(sizes64), _ptr(order64), len(order64), _ptr(buckets64), len(buckets64),
        max_tokens, batch_size, required_multiple, _ptr(out)))
    if n_batches == 0:
        return []
    # each batch's positions in order (the C++ numbers batches by position)
    by_batch = np.argsort(out, kind="stable")
    ends = np.cumsum(np.bincount(out, minlength=n_batches))[:-1]
    return np.split(order64[by_batch], ends)


def batch_by_size_native_plain(sizes: np.ndarray, order: np.ndarray, buckets: List[int],
                               max_tokens: int, batch_size: int,
                               required_multiple: int) -> List[np.ndarray]:
    return batches_in_order(np.asarray(sizes), order, buckets, max_tokens or None,
                            batch_size or None, required_multiple)


def token_blocks_complete(sizes: np.ndarray, block_size: int, complete_doc: bool = False,
                          document_sep_len: int = 1) -> np.ndarray:
    """Greedy whole-sentence block packing (fairseq's 'complete' /
    'complete_doc' break modes, token_block_utils_fast.pyx:66-97): [N, 2]
    int64 (start, end) token offsets."""
    lib = load()
    sizes64 = np.ascontiguousarray(sizes, dtype=np.int64)
    n = len(sizes64)
    out = np.empty((max(n, 1), 2), dtype=np.int64)
    nb = lib.mmvc_token_blocks_complete(_ptr(sizes64), n, block_size, int(bool(complete_doc)),
                                        document_sep_len, _ptr(out))
    return out[: int(nb)].copy()


def token_blocks_complete_plain(sizes: np.ndarray, block_size: int, complete_doc: bool = False,
                                document_sep_len: int = 1) -> np.ndarray:
    return _complete_blocks(np.asarray(sizes, np.int64), block_size, complete_doc,
                            document_sep_len)


def balanced_assignment(scores: np.ndarray) -> np.ndarray:
    """scores [n_workers, n_jobs] -> the worker of each job, every worker
    ``n_jobs / n_workers`` of them (the auction; ``n_jobs`` must be a
    multiple of ``n_workers``, or the auction would never settle)."""
    n_workers, n_jobs = scores.shape
    if n_jobs % n_workers:
        raise ValueError(f"balanced_assignment: {n_jobs} jobs do not split evenly over "
                         f"{n_workers} workers")
    lib = load()
    s = np.ascontiguousarray(scores, dtype=np.float32)
    out = np.empty(n_jobs, dtype=np.int32)
    lib.mmvc_balanced_assignment(_ptr(s), n_workers, n_jobs, _ptr(out))
    return out


def balanced_assignment_plain(scores: np.ndarray) -> np.ndarray:
    """The greedy fill: all (worker, job) pairs by score, each worker up to
    ``n_jobs // n_workers``; leftovers to the least loaded."""
    n_workers, n_jobs = scores.shape
    cap = n_jobs // n_workers
    order = np.argsort(-scores, axis=None)
    assigned = np.full(n_jobs, -1, dtype=np.int32)
    load_ = np.zeros(n_workers, dtype=np.int64)
    for flat in order:
        w, j = divmod(int(flat), n_jobs)
        if assigned[j] == -1 and load_[w] < cap:
            assigned[j] = w
            load_[w] += 1
    for j in np.where(assigned == -1)[0]:
        w = int(np.argmin(load_))
        assigned[j] = w
        load_[w] += 1
    return assigned


def bleu_counts(sys_ids: Sequence[int], ref_ids: Sequence[int], max_order: int = 4) -> tuple:
    """Clipped n-gram (matches, totals) of each order for one sentence pair
    (fairseq/fairseq/clib/libbleu/libbleu.cpp)."""
    lib = load()
    s = np.ascontiguousarray(sys_ids, dtype=np.int32)
    r = np.ascontiguousarray(ref_ids, dtype=np.int32)
    matches = np.zeros(max_order, dtype=np.int64)
    totals = np.zeros(max_order, dtype=np.int64)
    lib.mmvc_bleu_counts(_ptr(s), len(s), _ptr(r), len(r), max_order, _ptr(matches),
                         _ptr(totals))
    return matches, totals


def bleu_counts_plain(sys_ids: Sequence[int], ref_ids: Sequence[int],
                      max_order: int = 4) -> tuple:
    s = np.ascontiguousarray(sys_ids, dtype=np.int32)
    r = np.ascontiguousarray(ref_ids, dtype=np.int32)
    matches = np.zeros(max_order, dtype=np.int64)
    totals = np.zeros(max_order, dtype=np.int64)
    for n in range(1, max_order + 1):
        sys_ng = [tuple(s[i: i + n]) for i in range(len(s) - n + 1)]
        ref_ng = Counter(tuple(r[i: i + n]) for i in range(len(r) - n + 1))
        totals[n - 1] = len(sys_ng)
        matches[n - 1] = sum((Counter(sys_ng) & ref_ng).values())
    return matches, totals


class BleuScorer:
    """Corpus BLEU accumulator (fairseq/fairseq/scoring/bleu.py over
    libbleu counts); ``counts`` is ``bleu_counts`` or its plain twin."""

    def __init__(self, max_order: int = 4, counts: Callable = bleu_counts):
        self.max_order = max_order
        self.counts = counts
        self.matches = np.zeros(max_order, dtype=np.int64)
        self.totals = np.zeros(max_order, dtype=np.int64)
        self.sys_len = 0
        self.ref_len = 0

    def add(self, sys_ids: Sequence[int], ref_ids: Sequence[int]) -> None:
        m, t = self.counts(sys_ids, ref_ids, self.max_order)
        self.matches += m
        self.totals += t
        self.sys_len += len(sys_ids)
        self.ref_len += len(ref_ids)

    def score(self) -> float:
        """BLEU-4 in percent with the brevity penalty (0 where an order has
        no match)."""
        if self.sys_len == 0:
            return 0.0
        logs = 0.0
        for m, t in zip(self.matches, self.totals):
            p = m / t if t > 0 else 0.0
            logs += math.log(p) if p > 0 else float("-inf")
        if logs == float("-inf"):
            return 0.0
        bp = min(1.0, math.exp(1.0 - self.ref_len / max(self.sys_len, 1)))
        return 100.0 * bp * math.exp(logs / self.max_order)


def ngram_banned_tokens(tokens: np.ndarray, ngram: int, max_banned: int = 64) -> List[List[int]]:
    """Each row's banned next tokens under no-repeat-ngram: the token after
    every earlier occurrence of the row's last ``ngram - 1`` tokens."""
    lib = load()
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    bsz, length = tokens.shape
    banned = np.zeros((bsz, max_banned), dtype=np.int32)
    counts = np.zeros(bsz, dtype=np.int32)
    lib.mmvc_ngram_repeat_block(_ptr(tokens), bsz, length, ngram, _ptr(banned), max_banned,
                                _ptr(counts))
    return [banned[i, : counts[i]].tolist() for i in range(bsz)]


def ngram_banned_tokens_plain(tokens: np.ndarray, ngram: int,
                              max_banned: int = 64) -> List[List[int]]:
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    length = tokens.shape[1]
    out = []
    k = ngram - 1
    for row in tokens:
        bans = []
        if length >= k and k > 0:
            suffix = row[length - k:]
            for start in range(length - ngram + 1):
                if np.array_equal(row[start: start + k], suffix):
                    bans.append(int(row[start + k]))
        out.append(bans[:max_banned])
    return out
