"""Build and load the hand-written CUDA kernels under ``csrc/``.

The kernels are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface and bound with ``ctypes``: a build takes
seconds, where a source that includes PyTorch's headers takes minutes.  Each
source compiles in its own ``nvcc`` process, all started together, then one
link.  The build happens at first use, keyed on a hash of the sources and the
flags, into ``build/kernels/`` at the repository root (listed in
``.gitignore``).  Nothing is built or imported when this module is imported.

There is no fallback: if ``nvcc`` is missing or the build fails, ``load()``
raises.  The wrappers in ``ops/`` call it only for CUDA tensors; for CPU
tensors they run their plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
# no --use_fast_math: the beam top-k kernel must reproduce PyTorch's f32
# arithmetic bit for bit
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of csrc/*.cu; every function returns a cudaError_t
SIGNATURES = {
    "mmvc_flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "mmvc_prompt_attention": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ],
    "mmvc_gen_attention_ancestor": [
        _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ],
    "mmvc_beam_topk_columns": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ],
    "mmvc_beam_topk": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mmvc_gather_rows": [_P, _P, _P, _I, _I, _L, _P],
    "mmvc_int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mmvc_int4_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    pass


class _Library:
    """The loaded library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float, log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s  # 0.0 when an earlier build was reused
        self.log = log
        self._err = lib.mmvc_error_string
        self._err.argtypes = [_I]
        self._err.restype = ctypes.c_char_p
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        chunk = lib.mmvc_beam_topk_chunk_columns
        chunk.argtypes, chunk.restype = [], _I
        self.topk_chunk_columns = chunk()

    def call(self, name: str, *args) -> None:
        """Launch through the C entry point; raise on any CUDA error."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(
                f"{name} failed: CUDA error {rc} ({self._err(rc).decode()})"
            )


_LOCK = threading.Lock()
_LOADED: Optional[_Library] = None


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> Optional[str]:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    return None


def _build(out: Path) -> str:
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of multimodalvc_tpu_torch cannot be built, and there "
            "is no fallback to the plain PyTorch versions for CUDA tensors"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    # build in a private directory, then rename: concurrent processes never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        lib = str(Path(tmp) / out.name)
        link = [nvcc, *ARCH, "-shared", "-o", lib, *objs]
        failed = [(c, p.returncode, log) for c, p, log in zip(cmds, procs, logs) if p.returncode]
        if not failed:
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(proc.stdout)
            if proc.returncode:
                failed.append((link, proc.returncode, proc.stdout))
        if failed:
            raise KernelBuildError("\n".join(
                f"nvcc failed ({rc}):\n{' '.join(c)}\n{log}" for c, rc, log in failed))
        os.replace(lib, out)
    return "".join(logs)


def load() -> _Library:
    """Build (once per source hash) and load the kernel library."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        path = BUILD_DIR / f"libmmvc_kernels_{sources_hash()}.so"
        log, build_s = "", 0.0
        if not path.exists():
            t0 = time.perf_counter()
            log = _build(path)
            build_s = time.perf_counter() - t0
        _LOADED = _Library(ctypes.CDLL(str(path)), path, build_s, log)
        return _LOADED


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel operand: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
