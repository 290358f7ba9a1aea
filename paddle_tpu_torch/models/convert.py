"""Carry the reference model's parameters into the port.

The JAX package keeps GPT's parameters as stacked arrays named by
``_PARAM_ORDER``; the port keeps the same names and shapes, so the
conversion is a checked copy.  Take the arrays from a reference model as
``{n: np.asarray(model._parameters[n]._data) for n in _PARAM_ORDER}``.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.models.gpt import _PARAM_ORDER

__all__ = ["params_from_jax"]


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
