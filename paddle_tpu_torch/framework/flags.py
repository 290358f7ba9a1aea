"""Typed global flag registry (port of paddle_tpu/framework/flags.py).

Only the registry and the flags the ported path reads live here.  Flags
are env-seeded (``FLAGS_<name>``) and readable/writable at run time.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["define_flag", "flag", "get_flags", "set_flags"]

_registry: Dict[str, Any] = {}
_lock = threading.Lock()


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    with _lock:
        _registry[name] = value
    return value


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _registry:
        raise ValueError(f"unknown flag {name}")
    return key


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: _registry[_key(n)] for n in names}


def set_flags(flags: dict):
    for n, v in flags.items():
        key = _key(n)
        with _lock:
            _registry[key] = v


def flag(name: str):
    return _registry[name]


define_flag("gpt_fused_ce", False,
            "route gpt_loss through the fused linear+cross-entropy kernel "
            "(ops/cuda/fused_ce.py): the (B, S, V) logits never reach "
            "device memory")
