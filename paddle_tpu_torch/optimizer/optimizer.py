"""Adam and AdamW, the functional path (port of
paddle_tpu/optimizer/optimizer.py).

What ``jit.TrainStep`` runs: ``functional_init_states`` and
``functional_update`` over {name: tensor} dictionaries, the reference's
pure update rules (``:181-206``, ``:350-368``, ``:422-428``) written as
plain PyTorch tensor arithmetic.  The reference's unfused update is plain
XLA, not a Pallas kernel, so no kernel stands behind it here.

State per parameter is keyed by the parameter's name, with the
reference's keys ``moment1``, ``moment2``, ``beta1_pow`` and
``beta2_pow``, all float32 (the beta pows are 0-d tensors on the
parameter's device, so a step never reads a number back to the host).

Not in this slice, and raising ``NotImplementedError`` rather than being
ignored: ``use_fused=True`` (the fused Adam kernel), ``grad_clip``, a
learning-rate scheduler, and AdamW's ``apply_decay_param_fun`` and
``lr_ratio``.  The eager ``step()`` / ``clear_grad()`` API is not ported:
training goes through ``jit.TrainStep``.
"""
from __future__ import annotations

import numbers

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]

_NEXT = "next slice of the port (2b, the fused training path)"


def _check_lr(value) -> float:
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise NotImplementedError(
            f"learning rate {value!r}: only a constant float rate is "
            f"ported; LRScheduler rates (optimizer/lr.py) come with the "
            f"{_NEXT}")
    return float(value)


class Optimizer:
    """Base (reference ``Optimizer`` :31): the learning rate, the step
    count and the functional bridge that ``jit.TrainStep`` calls.
    ``parameters`` is accepted for the reference's signature: TrainStep
    hands the parameters to each update."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if grad_clip is not None:
            raise NotImplementedError(
                f"grad_clip ({type(grad_clip).__name__}): gradient clipping "
                f"comes with the {_NEXT}")
        if weight_decay is not None and (
                isinstance(weight_decay, bool)
                or not isinstance(weight_decay, numbers.Real)):
            raise NotImplementedError(
                f"weight_decay {weight_decay!r}: only a float L2 "
                "coefficient is ported")
        self._lr = _check_lr(learning_rate)
        self._weight_decay = weight_decay
        self._global_step = 0

    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value):
        self._lr = _check_lr(value)

    def init_state(self, value) -> dict:
        return {}

    def update(self, param, grad, state: dict, lr):
        """Pure update rule: (tensor, tensor, state dict, lr) →
        (new_param, new_state).  Overridden by subclasses."""
        raise NotImplementedError

    def functional_init_states(self, params: dict) -> dict:
        return {name: self.init_state(p) for name, p in params.items()}

    def functional_update(self, params: dict, grads: dict, states: dict,
                          lr=None, step=None):
        """Pure update over {name: tensor} (reference ``:182``): returns
        (new_params, new_states) and touches neither its arguments nor the
        model.  A parameter without a gradient keeps its value and state."""
        lr = self.get_lr() if lr is None else lr
        new_params, new_states = {}, {}
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                new_params[name] = p
                new_states[name] = states.get(name, {})
                continue
            if self._weight_decay is not None and not isinstance(
                    self, AdamW):
                g = g + float(self._weight_decay) * p   # coupled L2
            new_params[name], new_states[name] = self.update(
                p, g, dict(states.get(name, {})), lr)
        return new_params, new_states


class Adam(Optimizer):
    """Adam with beta-pow accumulators (reference ``Adam`` :328):
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``.  ``lazy_mode``
    concerns sparse gradients, which the port does not produce, and
    ``multi_precision`` is what TrainStep's f32 parameters already are:
    both are accepted."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_fused=False, name=None):
        if use_fused:
            raise NotImplementedError(
                f"use_fused=True: the fused Adam kernel "
                f"(ops/pallas/fused_adam.py) comes with the {_NEXT}")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def init_state(self, value) -> dict:
        one = torch.ones((), dtype=torch.float32, device=value.device)
        return {"moment1": torch.zeros_like(value, dtype=torch.float32),
                "moment2": torch.zeros_like(value, dtype=torch.float32),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        m = b1 * state["moment1"] + (1 - b1) * grad
        v = b2 * state["moment2"] + (1 - b2) * grad * grad
        new_p = param - lr_t * m / (torch.sqrt(v) + eps)
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}


class AdamW(Adam):
    """Decoupled weight decay (reference ``AdamW`` :402): after the Adam
    step, ``p -= lr * coeff * p_old``, on every parameter, as the
    reference's functional path does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, use_fused=False,
                 name=None):
        if apply_decay_param_fun is not None or lr_ratio is not None:
            raise NotImplementedError(
                "AdamW apply_decay_param_fun / lr_ratio: per-parameter "
                "decay and rates are not ported (the reference's "
                "functional path decays every parameter)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         use_fused)
        self._coeff = float(weight_decay)

    def update(self, param, grad, state, lr):
        new_p, new_state = super().update(param, grad, state, lr)
        return new_p - (lr * self._coeff) * param, new_state
