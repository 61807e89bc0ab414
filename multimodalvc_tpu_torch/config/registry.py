"""Registries of tasks and models.

Port of ``multimodalvc_tpu/config/registry.py``: a registered entry pairs a
class with its config dataclass, so that the command line builds anything
from ``kind.name`` and YAML / dotted overrides.  The port's registries are
its own: the names are the JAX package's, the classes the port's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

_REGISTRIES: Dict[str, Dict[str, Tuple[type, Optional[type]]]] = {}


def _registry(kind: str) -> Dict[str, Tuple[type, Optional[type]]]:
    return _REGISTRIES.setdefault(kind, {})


def register(kind: str, name: str, config: Optional[type] = None) -> Callable[[type], type]:
    """Decorator: register ``cls`` under ``kind``/``name`` with a config
    dataclass."""

    def wrapper(cls: type) -> type:
        reg = _registry(kind)
        if name in reg and reg[name][0] is not cls:
            raise ValueError(f"{kind} '{name}' already registered to {reg[name][0]}")
        if config is not None and not dataclasses.is_dataclass(config):
            raise TypeError(f"config for {kind} '{name}' must be a dataclass")
        reg[name] = (cls, config)
        cls.registry_name = name
        return cls

    return wrapper


def register_model(name: str, config: Optional[type] = None):
    return register("model", name, config)


def register_task(name: str, config: Optional[type] = None):
    return register("task", name, config)


def lookup(kind: str, name: str) -> Tuple[type, Optional[type]]:
    reg = _registry(kind)
    if name not in reg:
        avail = ", ".join(sorted(reg)) or "<none>"
        raise KeyError(f"unknown {kind} '{name}' (available: {avail})")
    return reg[name]


def available(kind: str):
    return sorted(_registry(kind))

