"""Carry the reference model's parameters and optimizer state into the
port.

The JAX package keeps GPT's parameters as stacked arrays named by
``_PARAM_ORDER``; the port keeps the same names and shapes, so the
conversion is a checked copy.  Take the arrays from a reference model as
``{n: np.asarray(model._parameters[n]._data) for n in _PARAM_ORDER}``,
and the optimizer state from a reference ``TrainStep`` as
``{n: {k: np.asarray(a) for k, a in st.items()} for n, st in
step._opt_states.items()}``.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.models.gpt import _PARAM_ORDER

__all__ = ["params_from_jax", "opt_states_from_jax"]

_ADAM_KEYS = ("moment1", "moment2", "beta1_pow", "beta2_pow")


def params_from_jax(np_params: dict) -> dict:
    """{name: np.ndarray} keyed by ``_PARAM_ORDER`` -> {name: torch.Tensor}
    (CPU, same dtype; copies, so the caller's arrays stay untouched)."""
    missing = [n for n in _PARAM_ORDER if n not in np_params]
    extra = [n for n in np_params if n not in _PARAM_ORDER]
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing}, unexpected "
                         f"{extra}")
    return {n: torch.from_numpy(np.array(np_params[n], copy=True))
            for n in _PARAM_ORDER}


def opt_states_from_jax(states: dict) -> dict:
    """{name: {moment1, moment2, beta1_pow, beta2_pow} as numpy} (the
    reference TrainStep's ``_opt_states``) -> the same structure as f32
    CPU tensors, for ``TrainStep.set_opt_states``: a run continues from
    the reference's state."""
    out = {}
    for name, st in states.items():
        if set(st) != set(_ADAM_KEYS):
            raise ValueError(f"opt_states_from_jax: {name} has keys "
                             f"{sorted(st)}, expected {list(_ADAM_KEYS)}")
        out[name] = {k: torch.from_numpy(np.array(st[k], dtype=np.float32,
                                                  copy=True))
                     for k in _ADAM_KEYS}
    return out
