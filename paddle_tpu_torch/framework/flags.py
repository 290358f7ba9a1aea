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
define_flag("zero_wire_dtype", "bf16",
            "wire encoding of the ZeRO sharded-update collectives "
            "(parallel/zero.py ShardedUpdateTrainStep reduce-scatter and "
            "all-gather legs): 'bf16' (half the f32 bytes), 'int8' (a "
            "quarter, plus one f32 scale a chunk), 'int4' (an eighth, "
            "packed nibbles plus one scale a chunk) or 'f32' (the exact "
            "leg).  The default of ShardedUpdateTrainStep(wire_dtype=None), "
            "kept as the reference's name for it; callers pass wire_dtype")
define_flag("zero_ring_collectives", False,
            "run the dp collective legs as the quantized ring "
            "(parallel/ring.py): one neighbour hop a step, the encode and "
            "decode between hops.  ShardedUpdateTrainStep and "
            "CompressedAllReduceTrainStep; the f32 wire keeps the plain "
            "collectives.  The default of ring=None, kept as the "
            "reference's name for it; callers pass ring")
define_flag("check_nan_inf", False,
            "jit.TrainStep (__call__ and multi_step) raises "
            "FloatingPointError on a non-finite loss: before any state is "
            "left changed without donation, after the write-back with it.  "
            "One read of the losses from the device a call when armed, "
            "none when not")
define_flag("ps_prefetch_depth", 1,
            "max in-flight prefetched pulls in PSTrainStep's pipeline "
            "(distributed/ps PSTrainStep.prefetch): 0 disables the "
            "pipeline, 1 is the double buffer: the next batch's pull runs "
            "on a background thread while the card runs the current step, "
            "after the previous step's push")
define_flag("ps_hot_row_k", 0,
            "bounded top-k hot-row sketch per host embedding table "
            "(space-saving counters over pulled ids, "
            "distributed/ps/device_table.py HotRowSketch); 0 disables it")
