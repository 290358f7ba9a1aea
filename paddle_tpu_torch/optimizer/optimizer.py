"""SGD, Momentum, Adam and AdamW, the functional path (port of
paddle_tpu/optimizer/optimizer.py).

What ``jit.TrainStep`` and the data-parallel steps of ``parallel/`` run:
``functional_init_states`` and ``functional_update`` over {name: tensor}
dictionaries, the reference's pure update rules (``:181-206``,
``:209-240``, ``:350-368``, ``:422-428``).

- Unfused (the default): plain PyTorch tensor arithmetic per parameter,
  as the reference's unfused update is plain XLA.
- ``use_fused=True``: one multi-tensor pass of ``ops/cuda/fused_adam.py``
  over every parameter (the kernel on the card, its plain version on the
  CPU), with AdamW's decoupled decay inside it (reference ``:419-428``).
  The reference falls back to the unfused update where its Pallas kernel
  is not supported; the port does not fall back: a CUDA tensor takes the
  kernel or raises.

State per parameter is keyed by the parameter's name, with the
reference's keys: Adam's ``moment1``, ``moment2``, ``beta1_pow`` and
``beta2_pow``, all float32 (the beta pows are 0-d tensors on the
parameter's device, so a step never reads a number back to the host);
Momentum's ``velocity``; none for SGD.

``learning_rate`` is a float or an ``optimizer.lr.LRScheduler``, whose
current rate ``get_lr`` returns; ``grad_clip`` is kept for
``jit.apply_functional_update`` to apply.  Not ported, and raising
``NotImplementedError`` rather than being ignored: AdamW's
``apply_decay_param_fun`` and ``lr_ratio``, and a learning rate that is
neither.  The eager ``step()`` / ``clear_grad()`` API is not ported:
training goes through ``jit.TrainStep``.
"""
from __future__ import annotations

import numbers

import torch

from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


def _check_lr(value):
    if isinstance(value, LRScheduler):
        return value
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise NotImplementedError(
            f"learning rate {value!r}: the port takes a float or an "
            f"optimizer.lr.LRScheduler")
    return float(value)


class Optimizer:
    """Base (reference ``Optimizer`` :31): the learning rate, the gradient
    clip, the step count and the functional bridge that
    ``jit.TrainStep`` calls.  ``parameters`` is accepted for the
    reference's signature: TrainStep hands the parameters to each
    update."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if weight_decay is not None and (
                isinstance(weight_decay, bool)
                or not isinstance(weight_decay, numbers.Real)):
            raise NotImplementedError(
                f"weight_decay {weight_decay!r}: only a float L2 "
                "coefficient is ported")
        self._lr = _check_lr(learning_rate)
        self._lr_scheduler = (self._lr if isinstance(self._lr, LRScheduler)
                              else None)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._global_step = 0

    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._lr

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._lr = float(value)

    def init_state(self, value) -> dict:
        return {}

    def update(self, param, grad, state: dict, lr):
        """Pure update rule: (tensor, tensor, state dict, lr) →
        (new_param, new_state).  Overridden by subclasses."""
        raise NotImplementedError

    def functional_init_states(self, params: dict) -> dict:
        return {name: self.init_state(p) for name, p in params.items()}

    def _coupled_grad(self, p, g):
        if self._weight_decay is not None and not isinstance(self, AdamW):
            return g + float(self._weight_decay) * p     # coupled L2
        return g

    def functional_update(self, params: dict, grads: dict, states: dict,
                          lr=None, step=None, donate: bool = False):
        """Update over {name: tensor} (reference ``:182``): returns
        (new_params, new_states).  A parameter without a gradient keeps its
        value and state.  Pure unless ``donate``: then an optimizer that
        can (the fused Adam) writes the new values into the parameters' and
        states' own storage and returns those tensors."""
        lr = self.get_lr() if lr is None else lr
        new_params, new_states = {}, {}
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                new_params[name] = p
                new_states[name] = states.get(name, {})
                continue
            new_params[name], new_states[name] = self.update(
                p, self._coupled_grad(p, g), dict(states.get(name, {})), lr)
        return new_params, new_states


class SGD(Optimizer):
    """``p - lr * g`` (reference ``SGD`` :209)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def update(self, param, grad, state, lr):
        return param - lr * grad, {}


class Momentum(Optimizer):
    """Heavy-ball momentum, optionally Nesterov's (reference ``Momentum``
    :224): ``v' = mu v + g``, ``p' = p - lr v'`` or, with
    ``use_nesterov``, ``p' = p - lr (g + mu v')``.  State: ``velocity``,
    in the parameter's dtype."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, value) -> dict:
        return {"velocity": torch.zeros_like(value)}

    def update(self, param, grad, state, lr):
        v = self._momentum * state["velocity"] + grad
        if self._nesterov:
            new_p = param - lr * (grad + self._momentum * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}


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
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._use_fused = bool(use_fused)

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

    def _fused_wd_lr(self, lr):
        """The decoupled decay the fused pass applies: none for Adam, whose
        L2 decay arrives inside the gradient."""
        return lr * 0.0

    def functional_update(self, params: dict, grads: dict, states: dict,
                          lr=None, step=None, donate: bool = False):
        if not self._use_fused:
            return super().functional_update(params, grads, states, lr, step,
                                             donate)
        from paddle_tpu_torch.ops.cuda import fused_adam
        names = [n for n in params if grads.get(n) is not None]
        new_params = {n: p for n, p in params.items()}
        new_states = {n: states.get(n, {}) for n in params}
        if not names:
            return new_params, new_states
        dev = params[names[0]].device
        lr = self.get_lr() if lr is None else lr
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        st = [states[n] for n in names]
        # every tensor's lr_t from its own beta pows, in f32 on the device
        b1p = torch.stack([s["beta1_pow"] for s in st]) * self._beta1
        b2p = torch.stack([s["beta2_pow"] for s in st]) * self._beta2
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        ps = [params[n] for n in names]
        m1 = [s["moment1"] for s in st]
        m2 = [s["moment2"] for s in st]
        out = (ps, m1, m2) if donate else None
        new_p, new_m1, new_m2 = fused_adam.fused_adam(
            ps, [self._coupled_grad(params[n], grads[n]) for n in names], m1,
            m2, lr_t, self._fused_wd_lr(lr), self._beta1, self._beta2,
            self._epsilon, out=out)
        for i, n in enumerate(names):
            new_params[n] = new_p[i]
            new_states[n] = {"moment1": new_m1[i], "moment2": new_m2[i],
                             "beta1_pow": b1p[i], "beta2_pow": b2p[i]}
        return new_params, new_states


class AdamW(Adam):
    """Decoupled weight decay (reference ``AdamW`` :402): after the Adam
    step, ``p -= lr * coeff * p_old``, on every parameter, as the
    reference's functional path does; inside the fused pass with
    ``use_fused=True``."""

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

    def _fused_wd_lr(self, lr):
        return lr * self._coeff

    def update(self, param, grad, state, lr):
        new_p, new_state = super().update(param, grad, state, lr)
        return new_p - (lr * self._coeff) * param, new_state
