"""Structured configs: nested dataclasses <-> dicts, dotted overrides.

Port of ``multimodalvc_tpu/config/structured.py``: YAML presets give a
nested dict, command-line arguments ``a.b.c=value`` override its leaves, and
the result is built into typed dataclasses.  ``load_yaml`` imports PyYAML
when it is called; nothing else needs it.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

MISSING = "???"


def _resolve_optional(tp):
    """Optional[X] -> (X, True); anything else -> (tp, False)."""
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _coerce(tp, value):
    if value is None:
        return None
    tp, _ = _resolve_optional(tp)
    origin = typing.get_origin(tp)
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, value)
    if origin in (list, List, tuple, typing.Tuple, Sequence) or tp in (list, tuple):
        args = typing.get_args(tp)
        elem_tp = args[0] if args else Any
        if isinstance(value, str):
            value = [v for v in value.strip("[]() ").split(",") if v != ""]
        out = [_coerce(elem_tp, v) if elem_tp is not Any else v for v in value]
        return tuple(out) if origin in (tuple, typing.Tuple) or tp is tuple else list(out)
    if tp is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if tp is int:
        return int(value)
    if tp is float:
        return float(value)
    if tp is str:
        return str(value)
    return value


def from_dict(cls, data: Optional[Mapping[str, Any]]):
    """Build dataclass ``cls`` from a (possibly nested) mapping; an unknown
    key raises."""
    if data is None:
        data = {}
    if dataclasses.is_dataclass(data):
        data = to_dict(data)
    if not isinstance(data, Mapping):
        raise TypeError(f"cannot build {cls.__name__} from {type(data)}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = [k for k in data if k not in fields]
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {unknown}")
    kwargs = {}
    for name, f in fields.items():
        if name in data:
            tp = f.type if not isinstance(f.type, str) else _eval_type(cls, f)
            kwargs[name] = _coerce(tp, data[name])
    return cls(**kwargs)


def _eval_type(cls, f):
    return typing.get_type_hints(cls).get(f.name, Any)


def to_dict(obj) -> Dict[str, Any]:
    if dataclasses.is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_dict(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def _parse_scalar(text: str):
    t = text.strip()
    if t.lower() in ("null", "none", "~"):
        return None
    if t.lower() == "true":
        return True
    if t.lower() == "false":
        return False
    for conv in (int, float):
        try:
            return conv(t)
        except ValueError:
            pass
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_parse_scalar(v) for v in inner.split(",")] if inner else []
    return t


def set_by_path(tree: Dict[str, Any], path: str, value: Any) -> None:
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise TypeError(f"override path '{path}' crosses non-dict node '{k}'")
    node[keys[-1]] = value


def apply_overrides(tree: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` strings onto a nested dict (in place) and
    return it."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not of the form key=value")
        path, _, raw = ov.partition("=")
        set_by_path(tree, path.strip(), _parse_scalar(raw))
    return tree


def merge(base: Dict[str, Any], extra: Mapping[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``extra`` onto ``base`` (in place) and return ``base``."""
    for k, v in extra.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), dict):
            merge(base[k], v)
        else:
            base[k] = v
    return base


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}

