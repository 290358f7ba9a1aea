"""DistributedStrategy, the typed strategy config (port of
paddle_tpu/distributed/fleet/strategy.py).

One plain object with the reference's field names, defaults and dict
round-trip (``strategy.amp = True; strategy.amp_configs = {...}``): a
switch takes a bool, a config a dict of known keys, and
``save_to_prototxt`` / ``load_from_prototxt`` write and read it as JSON
(``:154-160``).  The AMP config's ``use_bf16`` defaults to True, as the
reference's.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict

__all__ = ["DistributedStrategy"]

_DEFAULTS: Dict[str, Any] = {
    # meta-optimizer switches (proto distributed_strategy.proto:190-220)
    "amp": False,
    "recompute": False,
    "sharding": False,
    "pipeline": False,
    "gradient_merge": False,
    "localsgd": False,
    "adaptive_localsgd": False,
    "dgc": False,
    "lamb": False,
    "lars": False,
    "fp16_allreduce": False,
    "a_sync": False,
    "heter_ccl_mode": False,
    "cudnn_exhaustive_search": False,
    "sync_nccl_allreduce": True,
    "nccl_comm_num": 1,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "find_unused_parameters": False,
    "without_graph_optimization": False,
}

_CONFIG_DEFAULTS: Dict[str, Dict[str, Any]] = {
    # AMPConfig (proto :25)
    "amp_configs": {
        "init_loss_scaling": 32768.0,
        "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2,
        "incr_ratio": 2.0,
        "decr_ratio": 0.8,
        "use_dynamic_loss_scaling": True,
        "custom_white_list": [],
        "custom_black_list": [],
        "custom_black_varnames": [],
        "use_pure_fp16": False,
        "use_bf16": True,            # TPU-first default dtype
        "use_fp16_guard": True,
    },
    # RecomputeConfig
    "recompute_configs": {
        "checkpoints": [],
        "enable_offload": False,
        "checkpoint_shape": [],
    },
    # ShardingConfig (proto :40; 4-D hybrid at
    # sharding_optimizer.py:115-138)
    "sharding_configs": {
        "segment_broadcast_MB": 32.0,
        "segment_anchors": [],
        "sharding_degree": 8,
        "mp_degree": 1,
        "dp_degree": 1,
        "pp_degree": 1,
        "hybrid_dp": False,
        "gradient_merge_acc_step": 1,
        "optimize_offload": False,
        "stage": 1,
    },
    "pipeline_configs": {
        "micro_batch_size": 1,
        "accumulate_steps": 1,
        "schedule_mode": "1F1B",
        "p2p_cache_shape": True,
    },
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "adaptive_localsgd_configs": {"init_k_steps": 1, "begin_step": 1},
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999], "momentum": 0.9},
    "lamb_configs": {"lamb_weight_decay": 0.01,
                     "exclude_from_weight_decay": []},
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                     "epsilon": 0.0, "exclude_from_weight_decay": []},
    "a_sync_configs": {"k_steps": -1, "max_merge_var_num": 1,
                       "send_queue_size": 16,
                       "independent_recv_thread": False,
                       "thread_pool_size": 1, "send_wait_times": 1,
                       "runtime_split_send_recv": False,
                       "launch_barrier": True, "use_ps_gpu": False},
    # dygraph hybrid (fleet_base hybrid_configs)
    "hybrid_configs": {"dp_degree": -1, "mp_degree": 1, "pp_degree": 1,
                       "sharding_degree": 1, "sep_degree": 1},
    "build_strategy": {},
    "execution_strategy": {},
}


class DistributedStrategy:
    def __init__(self):
        self.__dict__["_flags"] = copy.deepcopy(_DEFAULTS)
        self.__dict__["_configs"] = copy.deepcopy(_CONFIG_DEFAULTS)

    def __getattr__(self, name):
        if name in self._flags:
            return self._flags[name]
        if name in self._configs:
            return self._configs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._flags:
            if not isinstance(value, bool) and isinstance(
                    _DEFAULTS[name], bool):
                raise ValueError(f"{name} expects bool, got {type(value)}")
            self._flags[name] = value
        elif name in self._configs:
            if not isinstance(value, dict):
                raise ValueError(f"{name} expects dict")
            cfg = self._configs[name]
            unknown = set(value) - set(cfg)
            if unknown:
                raise ValueError(f"unknown keys for {name}: {sorted(unknown)}")
            cfg.update(value)
        else:
            object.__setattr__(self, name, value)

    # -- serialization (proto parity: the reference pickles the proto) ------
    def to_dict(self) -> dict:
        return {"flags": copy.deepcopy(self._flags),
                "configs": copy.deepcopy(self._configs)}

    @classmethod
    def from_dict(cls, d: dict) -> "DistributedStrategy":
        s = cls()
        s._flags.update(d.get("flags", {}))
        for k, v in d.get("configs", {}).items():
            if k in s._configs:
                s._configs[k].update(v)
        return s

    def save_to_prototxt(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def load_from_prototxt(self, path: str):
        with open(path) as f:
            d = json.load(f)
        self._flags.update(d.get("flags", {}))
        for k, v in d.get("configs", {}).items():
            if k in self._configs:
                self._configs[k].update(v)

    def __repr__(self):
        on = [k for k, v in self._flags.items()
              if isinstance(v, bool) and v and not _DEFAULTS[k]]
        return f"DistributedStrategy(enabled={on})"
