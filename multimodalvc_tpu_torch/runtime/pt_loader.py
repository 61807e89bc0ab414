"""A safe reader for PyTorch ``.pt`` / ``.pth`` checkpoints (the zip format).

Port of ``multimodalvc_tpu/runtime/pt_loader.py``.  The reference ships
every pretrained artifact as a torch checkpoint (the AVSR and speech
products, AV-HuBERT, the speech-rate predictor, the HiFi-GAN vocoder with
its EMA copy), and fairseq's carry non-tensor objects beside the weights
(``args``, ``cfg``), which ``torch.load(weights_only=True)`` refuses.  This
module reads the archive itself: ``data.pkl`` is a pickle stream whose
persistent ids name storage files under ``data/``.  Only whitelisted
globals are honoured; every other class becomes an inert shell that
swallows its state, so nothing in the file executes.

Each storage is read once and rebuilt with ``torch.frombuffer`` in its
stored dtype (bf16 stays bf16); each tensor is a view of its storage at the
saved offset and strides, so tensors that shared a storage share it again
and transposed views come back transposed.
"""
from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, BinaryIO, Callable, Dict

import numpy as np
import torch

_DTYPE_MAP = {
    "FloatStorage": torch.float32,
    "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16,
    "LongStorage": torch.int64,
    "IntStorage": torch.int32,
    "ShortStorage": torch.int16,
    "CharStorage": torch.int8,
    "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
    "BFloat16Storage": torch.bfloat16,
}


def _storage_tensor(data: bytes, dtype: torch.dtype) -> torch.Tensor:
    """The flat tensor of one storage file."""
    if not data:
        return torch.empty(0, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype)


def _rebuild_tensor(storage: torch.Tensor, offset, size, stride, *_args, **_kw):
    return storage.as_strided(tuple(int(s) for s in size), tuple(int(s) for s in stride),
                              int(offset))


def _rebuild_parameter(data, requires_grad=False, hooks=None):
    return data


class _Skip:
    """Stand-in for the objects of a checkpoint that are not tensors
    (configs, namespaces): it takes any arguments and state and does
    nothing."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __call__(self, *args, **kwargs):
        return _Skip()

    def __setstate__(self, state):
        self.state = state


def _numpy_reconstruct():
    """numpy's array unpickler, read where numpy 2 keeps it (``numpy.core``
    warns when touched)."""
    core = getattr(np, "_core", None) or getattr(np, "core", None)
    return getattr(getattr(core, "multiarray", None), "_reconstruct", _Skip)


_SAFE_GLOBALS = {
    ("collections", "OrderedDict"): dict,
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor,
    ("torch._utils", "_rebuild_tensor"): _rebuild_tensor,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch.serialization", "_get_layout"): _Skip,
    ("numpy.core.multiarray", "scalar"): lambda dt, val: np.frombuffer(val, dtype=dt)[0],
    ("numpy.core.multiarray", "_reconstruct"): _numpy_reconstruct(),
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("_codecs", "encode"): lambda s, enc: s.encode(enc),
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "slice"): slice,
    ("builtins", "complex"): complex,
}


class _TorchUnpickler(pickle.Unpickler):
    def __init__(self, file: BinaryIO, storage_loader: Callable[[str, torch.dtype], torch.Tensor]):
        super().__init__(file)
        self._storage_loader = storage_loader

    def find_class(self, module: str, name: str):
        key = (module, name)
        if key in _SAFE_GLOBALS:
            return _SAFE_GLOBALS[key]
        if module.startswith("torch") and name.endswith("Storage"):
            return name  # a marker that persistent_load reads
        if module == "torch" and name == "Size":
            return tuple
        if module == "torch" and name.endswith("dtype"):
            return _Skip
        # unknown classes (argparse.Namespace, omegaconf nodes, fairseq
        # dataclasses...): an inert shell that swallows their state
        return type(name, (_Skip,), {"__module__": module})

    def persistent_load(self, pid):
        typename = pid[0]
        if typename == "storage":
            storage_type, key = pid[1], pid[2]
            name = storage_type if isinstance(storage_type, str) else \
                getattr(storage_type, "__name__", str(storage_type))
            dtype = _DTYPE_MAP.get(name)
            if dtype is None:
                raise ValueError(f"unsupported torch storage type {name}")
            return self._storage_loader(key, dtype)
        raise pickle.UnpicklingError(f"unsupported persistent id {typename}")


def load_pt(path: str) -> Any:
    """A torch zip-format checkpoint as nested dicts of CPU tensors.

    Objects that are not tensors (configs, namespaces) come back as inert
    ``_Skip`` shells; tensors are exact, in their stored dtype."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl_name = next(n for n in names if n.endswith("data.pkl"))
        prefix = pkl_name[: -len("data.pkl")]
        storages: Dict[str, torch.Tensor] = {}

        def storage_loader(key: str, dtype: torch.dtype) -> torch.Tensor:
            if key not in storages:
                with zf.open(f"{prefix}data/{key}") as f:
                    storages[key] = _storage_tensor(f.read(), dtype)
            return storages[key]

        with zf.open(pkl_name) as f:
            return _TorchUnpickler(io.BytesIO(f.read()), storage_loader).load()


def flatten_state_dict(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts flattened to ``{"a.b.c": tensor}``; numpy arrays and
    scalars become tensors, and leaves that are neither are dropped."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            out.update(flatten_state_dict(v, key))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, (np.ndarray, np.floating, np.integer)):
        out[prefix] = torch.from_numpy(np.array(tree))
    return out
