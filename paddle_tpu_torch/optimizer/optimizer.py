"""The optimizers (port of paddle_tpu/optimizer/optimizer.py): SGD,
Momentum, LarsMomentum, Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp
and Lamb, each with both of the reference's paths.

- **Eager** (the dygraph loop, reference ``:31-207``):
  ``loss.backward(); opt.step(); opt.clear_grad()``.  ``step()`` updates
  each parameter of ``parameters`` that has a gradient and is trainable,
  in place: the gradient clip over the (parameter, gradient) pairs, the
  parameter's ``optimize_attr`` learning-rate scale, and the coupled decay
  of ``_apply_decay`` (a ``ParamAttr`` regularizer wins over the
  optimizer's ``weight_decay``, a float or an ``L1Decay`` / ``L2Decay``).
  ``minimize(loss)`` calls ``loss.backward()`` itself, then ``step()``.
  ``state_dict()`` keys are ``{parameter name}_{state}``, with
  ``LR_Scheduler`` and ``@global_step``; ``set_state_dict`` takes one
  back.
- **Functional** (what ``jit.TrainStep`` and ``parallel/`` run):
  ``functional_init_states`` and ``functional_update`` over {name:
  tensor} dictionaries (reference ``:181-206``), where the optimizer's
  ``weight_decay`` decays every parameter.

State per parameter has the reference's keys and dtypes (each
``init_state``): Adam's ``moment1``, ``moment2``, ``beta1_pow`` and
``beta2_pow`` in the parameter's dtype (so bf16 under ``amp.decorate``
O2, where the eager update runs on the bf16 parameters); Adamax's and
Lamb's beta pows in f32; Momentum's and Lars's ``velocity``; Adagrad's
``moment`` from ``initial_accumulator_value``; Adadelta's
``avg_squared_grad`` / ``avg_squared_update``; RMSProp's ``mean_square``,
``momentum`` and, centred, ``mean_grad``.  The beta pows are 0-d tensors
on the parameter's device, so a step reads nothing back to the host.

Arithmetic follows JAX's rules for a Python number beside an array: the
number is rounded to the array's dtype first (``_rounded``), so a bf16
update rounds as the reference's does.

``use_fused=True`` (Adam, AdamW): one multi-tensor pass of
``ops/cuda/fused_adam.py`` over the parameters (the kernel on the card,
its plain version on the CPU; f32 or bf16 storage), with AdamW's
decoupled decay inside it (reference ``:350-363``, ``:419-428``), in
both paths.  The reference falls back to the unfused update where its
Pallas kernel is not supported; the port does not: a CUDA tensor takes
the kernel or raises.

Row-sparse gradients (``embedding(sparse=True)``, a sparse COO ``.grad``;
``framework/selected_rows.py``) take the reference's sparse branch of the
eager ``step()`` (``:98-131``): the rows are merged (sorted, a repeated
row's values summed); ``SGD`` and ``Adam`` update only those rows
(``update_sparse``; Adam's moments too with ``lazy_mode``, while without
it the merged rows are densified and take Adam's dense update), with no
weight decay or regularizer either way; every other optimizer densifies
the merged rows and takes its dense update, decay included.  A
``grad_clip`` densifies every gradient first, and the dense update
follows.  ``AdamW`` is never lazy: it hands its ``lazy_mode`` on to
nothing, as the reference's ``AdamW`` does.

Not ported, raising ``NotImplementedError`` rather than being ignored:
``AdamW(lr_ratio=...)``, AdamW's ``apply_decay_param_fun`` and Lamb's
``exclude_from_weight_decay_fn`` on the functional path (the reference's
functional path decays every parameter; its eager ``step()`` honours
them, and so does the port's), and a learning rate that is neither a
float nor an ``optimizer.lr.LRScheduler``.
"""
from __future__ import annotations

import functools
import numbers

import torch

from paddle_tpu_torch.framework.parameter import clear_gradient
from paddle_tpu_torch.framework.selected_rows import SelectedRows, dense
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "LarsMomentum", "Adam", "AdamW",
           "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb"]


def _check_lr(value):
    if isinstance(value, LRScheduler):
        return value
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise NotImplementedError(
            f"learning rate {value!r}: the port takes a float or an "
            f"optimizer.lr.LRScheduler")
    return float(value)


@functools.lru_cache(maxsize=4096)
def _round_one(dtype, value):
    return float(torch.tensor(value, dtype=dtype))


def _rounded(dtype, *values):
    """Each Python number rounded to ``dtype``, as JAX rounds a weakly
    typed scalar before it meets an array of that dtype; a tensor (the
    learning rate ``TrainStep`` hands over) passes as it is."""
    out = tuple(v if isinstance(v, torch.Tensor) else _round_one(dtype,
                                                                 float(v))
                for v in values)
    return out if len(out) > 1 else out[0]


def _lr_scale(p) -> float:
    return getattr(p, "optimize_attr", {"learning_rate": 1.0})[
        "learning_rate"]


def _name(p, i) -> str:
    """The parameter's name (``framework.parameter.Parameter`` carries
    one), else ``param_{i}`` by its place in the parameter list."""
    name = getattr(p, "name", None)
    return name if name is not None else f"param_{i}"


def _trainable(p) -> bool:
    return getattr(p, "trainable", True) and p.requires_grad


class Optimizer:
    """Base (reference ``Optimizer`` :31): the learning rate, the gradient
    clip, the step count, the eager ``step()`` over ``parameters`` and the
    functional bridge that ``jit.TrainStep`` calls."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if weight_decay is not None and (
                isinstance(weight_decay, bool) or not (
                    isinstance(weight_decay, numbers.Real)
                    or callable(weight_decay))):
            raise TypeError(
                f"weight_decay {weight_decay!r}: a float L2 coefficient or "
                "a regularizer (L1Decay, L2Decay)")
        self._lr = _check_lr(learning_rate)
        self._lr_scheduler = (self._lr if isinstance(self._lr, LRScheduler)
                              else None)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators: dict = {}     # id(parameter) -> state dict
        self._global_step = 0

    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._lr

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._lr = float(value)

    # -- state ---------------------------------------------------------------
    def init_state(self, value) -> dict:
        return {}

    def _state_for(self, p) -> dict:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self.init_state(p.detach())
        return st

    def update(self, param, grad, state: dict, lr):
        """Pure update rule: (tensor, tensor, state dict, lr) →
        (new_param, new_state).  Overridden by subclasses."""
        raise NotImplementedError

    # -- eager ---------------------------------------------------------------
    def _grads_and_params(self, densify: bool = False) -> list:
        """(parameter, gradient) of every trainable parameter that has a
        gradient, clipped by ``grad_clip``; a sparse gradient is merged and
        densified before a clip, or everywhere with ``densify``."""
        if self._parameter_list is None:
            raise ValueError("Optimizer created without parameters")
        pairs = [(p, p.grad) for p in self._parameter_list
                 if p.grad is not None and _trainable(p)]
        if densify or self._grad_clip is not None:
            pairs = [(p, dense(g)) for p, g in pairs]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        return pairs

    def _apply_decay(self, p, grad):
        """Coupled decay folded into the gradient (reference ``:80-95``): a
        ``ParamAttr`` regularizer wins over the optimizer's
        ``weight_decay``."""
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            return grad + reg(p.detach())
        return self._coupled_grad(p.detach(), grad)

    def _step_sparse(self, p, grad, lr):
        """The sparse branch (reference ``:118-131``): the merged rows
        through ``update_sparse`` where the optimizer has one, without
        decay, else densified through the dense update, with it."""
        state = self._state_for(p)
        rows = SelectedRows.from_grad(grad).merge()
        if hasattr(self, "update_sparse"):
            new_p, new_state = self.update_sparse(p.detach(), rows, state, lr)
        else:
            new_p, new_state = self.update(
                p.detach(), self._apply_decay(p, rows.to_dense()), state, lr)
        p.copy_(new_p)
        state.update(new_state)

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter with a gradient, in
        place (reference ``:97-135``)."""
        lr = self.get_lr()
        pairs = self._grads_and_params()
        self._global_step += 1
        for p, g in pairs:
            if g.is_sparse:
                self._step_sparse(p, g, lr * _lr_scale(p))
                continue
            state = self._state_for(p)
            new_p, new_state = self.update(
                p.detach(), self._apply_decay(p, g), state,
                lr * _lr_scale(p))
            p.copy_(new_p)
            state.update(new_state)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()`` (reference ``:137-142``): a
        caller who has already run the backward accumulates the gradient
        twice, as in the reference."""
        loss.backward()
        self.step()
        return None, None

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        """Drop every gradient, or with ``set_to_zero`` make it zeros (a
        sparse one dense zeros, as the reference's ``clear_gradient``)."""
        for p in self._parameter_list or []:
            clear_gradient(p, set_to_zero)

    clear_gradients = clear_grad

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self) -> dict:
        """{``{p.name}_{key}``: a copy of each state tensor} of the
        parameters that have state, ``LR_Scheduler`` and ``@global_step``
        (reference ``:152-165``)."""
        sd = {}
        for i, p in enumerate(self._parameter_list or []):
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[f"{_name(p, i)}_{k}"] = (v.detach().clone()
                                       if isinstance(v, torch.Tensor) else v)
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        sd["@global_step"] = self._global_step
        return sd

    def set_state_dict(self, state_dict):
        """Take back a ``state_dict()`` (reference ``:167-180``): each
        parameter's state is made, then every key present is copied in,
        on the parameter's device and in the saved dtype."""
        self._global_step = int(state_dict.get("@global_step", 0))
        if self._lr_scheduler is not None and "LR_Scheduler" in state_dict:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list or []):
            st = self._state_for(p)
            for k in list(st):
                v = state_dict.get(f"{_name(p, i)}_{k}")
                if v is None:
                    continue
                st[k] = (torch.as_tensor(v).detach().to(p.device).clone()
                         if not isinstance(v, numbers.Number) else v)

    # -- functional ----------------------------------------------------------
    def functional_init_states(self, params: dict) -> dict:
        return {name: self.init_state(p) for name, p in params.items()}

    def _coupled_grad(self, p, g):
        """``g`` plus the optimizer's ``weight_decay`` term: a regularizer's,
        or ``coeff * p`` for a float."""
        wd = self._weight_decay
        if wd is None:
            return g
        if callable(wd):
            return g + wd(p)
        return g + _rounded(p.dtype, wd) * p

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
        return param - _rounded(param.dtype, lr) * grad, {}

    def update_sparse(self, param, rows, state, lr):
        """Only the merged ``rows`` move (reference ``:219-221``)."""
        return param.index_add(0, rows.rows, -_rounded(param.dtype, lr)
                               * rows.values.to(param.dtype)), {}


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
        mu, lr = _rounded(param.dtype, self._momentum, lr)
        v = mu * state["velocity"] + grad
        if self._nesterov:
            new_p = param - lr * (grad + mu * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate scaling with momentum (reference
    ``LarsMomentum`` :246-325):

        local_lr = lr * coeff * ||p|| / (||g|| + wd * ||p|| + eps)
        v' = mu * v + local_lr * (g + wd * p);  p' = p - v'

    (``lr`` where either norm is 0), the norms in f32.  A parameter whose
    name contains one of ``exclude_from_weight_decay`` takes wd = 0, in the
    eager and the functional path.  Its eager ``step()`` applies no
    regularizer, as the reference's."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=1e-9, parameters=None,
                 exclude_from_weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = tuple(exclude_from_weight_decay or ())

    def init_state(self, value) -> dict:
        return {"velocity": torch.zeros_like(value)}

    def _wd_for(self, name) -> float:
        if name and any(s in name for s in self._exclude):
            return 0.0
        return self._lars_weight_decay

    def update(self, param, grad, state, lr, wd=None):
        wd = self._lars_weight_decay if wd is None else wd
        p_norm = torch.sqrt(torch.sum(param.float() ** 2))
        g_norm = torch.sqrt(torch.sum(grad.float() ** 2))
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * p_norm / (g_norm + wd * p_norm
                                              + self._epsilon),
            lr).to(param.dtype)
        mu, wd_ = _rounded(param.dtype, self._momentum, wd)
        v = mu * state["velocity"] + local_lr * (grad + wd_ * param)
        return param - v, {"velocity": v}

    @torch.no_grad()
    def step(self):
        lr = self.get_lr()
        pairs = self._grads_and_params(densify=True)
        self._global_step += 1
        for p, g in pairs:
            state = self._state_for(p)
            new_p, new_state = self.update(p.detach(), g, state,
                                           lr * _lr_scale(p),
                                           wd=self._wd_for(p.name))
            p.copy_(new_p)
            state.update(new_state)

    def functional_update(self, params: dict, grads: dict, states: dict,
                          lr=None, step=None, donate: bool = False):
        lr = self.get_lr() if lr is None else lr
        new_params, new_states = {}, {}
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                new_params[name] = p
                new_states[name] = states.get(name, {})
                continue
            new_params[name], new_states[name] = self.update(
                p, g, dict(states.get(name, {})), lr, wd=self._wd_for(name))
        return new_params, new_states


class Adam(Optimizer):
    """Adam with beta-pow accumulators (reference ``Adam`` :328):
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, formed in the
    state's dtype.  ``lazy_mode`` moves only a sparse gradient's rows, and
    their moments (``update_sparse``); ``multi_precision`` is accepted
    and, as in the reference, read by nothing."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_fused=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = bool(lazy_mode)
        self._use_fused = bool(use_fused)

    def init_state(self, value) -> dict:
        dt = value.dtype if value.is_floating_point() else torch.float32
        one = torch.ones((), dtype=dt, device=value.device)
        return {"moment1": torch.zeros_like(value),
                "moment2": torch.zeros_like(value),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _pows_and_rate(self, b1p, b2p, lr):
        """The next beta1^t, beta2^t and lr_t from the current pows, in
        their dtype (0-d, or stacked (T,))."""
        b1, b2, lr = _rounded(b1p.dtype, self._beta1, self._beta2, lr)
        b1p = b1p * b1
        b2p = b2p * b2
        return b1p, b2p, lr * torch.sqrt(1 - b2p) / (1 - b1p)

    def update(self, param, grad, state, lr):
        b1p, b2p, lr_t = self._pows_and_rate(state["beta1_pow"],
                                             state["beta2_pow"], lr)
        b1, c1, b2, c2, eps = _rounded(
            param.dtype, self._beta1, 1 - self._beta1, self._beta2,
            1 - self._beta2, self._epsilon)
        m = b1 * state["moment1"] + c1 * grad
        v = b2 * state["moment2"] + c2 * grad * grad
        new_p = param - lr_t * m / (torch.sqrt(v) + eps)
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}

    def update_sparse(self, param, rows, state, lr):
        """The merged ``rows`` of a sparse gradient (reference
        ``:379-400``): with ``lazy_mode`` the parameter and both moments
        move on those rows only (the beta pows advance); without it the
        rows are densified and take the dense update (the fused pass's
        with ``use_fused``)."""
        if not self._lazy_mode:
            g = rows.to_dense()
            if self._use_fused:
                (new_p,), (new_state,) = self._fused([param], [g], [state],
                                                     lr, out=False)
                return new_p, new_state
            return self.update(param, g, state, lr)
        b1p, b2p, lr_t = self._pows_and_rate(state["beta1_pow"],
                                             state["beta2_pow"], lr)
        b1, c1, b2, c2, eps = _rounded(
            param.dtype, self._beta1, 1 - self._beta1, self._beta2,
            1 - self._beta2, self._epsilon)
        idx, vals = rows.rows, rows.values.to(param.dtype)
        m_r = b1 * state["moment1"][idx] + c1 * vals
        v_r = b2 * state["moment2"][idx] + c2 * vals * vals
        new_p = param.index_add(0, idx, -lr_t * m_r / (torch.sqrt(v_r) + eps))
        return new_p, {"moment1": state["moment1"].index_copy(0, idx, m_r),
                       "moment2": state["moment2"].index_copy(0, idx, v_r),
                       "beta1_pow": b1p, "beta2_pow": b2p}

    def _fused_wd(self):
        """The decoupled decay coefficient of the fused pass: none for
        Adam, whose L2 decay arrives inside the gradient."""
        return 0.0

    def _fused(self, params, grads, states, lr, out):
        """One fused pass over parallel lists: (new params, new states).
        ``lr`` is one rate for every tensor (a float or a 0-d tensor)."""
        from paddle_tpu_torch.ops.cuda import fused_adam
        dev = params[0].device
        # every tensor's lr_t from its own beta pows, in their dtype on the
        # device, widened to f32 for the kernel as the reference widens it
        b1p, b2p, lr_t = self._pows_and_rate(
            torch.stack([s["beta1_pow"] for s in states]),
            torch.stack([s["beta2_pow"] for s in states]), lr)
        wd = lr * self._fused_wd()
        wd_lr = (wd.float() if isinstance(wd, torch.Tensor) else
                 torch.full((), wd, dtype=torch.float32, device=dev))
        m1 = [s["moment1"] for s in states]
        m2 = [s["moment2"] for s in states]
        new_p, new_m1, new_m2 = fused_adam.fused_adam(
            params, grads, m1, m2, lr_t.float(), wd_lr, self._beta1,
            self._beta2, self._epsilon,
            out=(params, m1, m2) if out else None)
        return new_p, [{"moment1": a, "moment2": b, "beta1_pow": b1p[i],
                        "beta2_pow": b2p[i]}
                       for i, (a, b) in enumerate(zip(new_m1, new_m2))]

    @torch.no_grad()
    def step(self):
        if not self._use_fused:
            return super().step()
        lr = self.get_lr()
        pairs = self._grads_and_params()
        self._global_step += 1
        # one pass for each learning-rate scale: the kernel takes one decay
        groups: dict = {}
        for p, g in pairs:
            if g.is_sparse:
                self._step_sparse(p, g, lr * _lr_scale(p))
                continue
            groups.setdefault(_lr_scale(p), []).append((p, g))
        for scale, grp in groups.items():
            ps = [p.detach() for p, _ in grp]
            states = [self._state_for(p) for p, _ in grp]
            _, new_states = self._fused(
                ps, [self._apply_decay(p, g) for p, g in grp], states,
                lr * scale, out=True)
            for st, new in zip(states, new_states):
                st.update(new)

    def functional_update(self, params: dict, grads: dict, states: dict,
                          lr=None, step=None, donate: bool = False):
        if not self._use_fused:
            return super().functional_update(params, grads, states, lr, step,
                                             donate)
        names = [n for n in params if grads.get(n) is not None]
        new_params = {n: p for n, p in params.items()}
        new_states = {n: states.get(n, {}) for n in params}
        if not names:
            return new_params, new_states
        lr = self.get_lr() if lr is None else lr
        new_p, new_st = self._fused(
            [params[n] for n in names],
            [self._coupled_grad(params[n], grads[n]) for n in names],
            [states[n] for n in names], lr, out=donate)
        for n, p, st in zip(names, new_p, new_st):
            new_params[n] = p
            new_states[n] = st
        return new_params, new_states


class AdamW(Adam):
    """Decoupled weight decay (reference ``AdamW`` :402): after the Adam
    step, ``p -= lr * coeff * p_old``, on every parameter; inside the fused
    pass with ``use_fused=True``.  The eager ``step()`` applies no
    regularizer (reference ``:419``); with ``apply_decay_param_fun`` it is
    the reference's own loop (``:430-456``): unfused, decaying only the
    parameters whose name the function accepts, at the optimizer's rate
    without ``optimize_attr``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, use_fused=False,
                 name=None):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW lr_ratio: per-parameter rates "
                                      "are not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, False, multi_precision, use_fused)
        self._coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_decay(self, p, grad):
        return grad

    def _fused_wd(self):
        return self._coeff

    def update(self, param, grad, state, lr):
        new_p, new_state = super().update(param, grad, state, lr)
        decay = lr * self._coeff
        return new_p - _rounded(param.dtype, decay) * param, new_state

    @torch.no_grad()
    def step(self):
        if self._apply_decay_param_fun is None:
            return super().step()
        lr = self.get_lr()
        self._global_step += 1
        for p, g in self._grads_and_params(densify=True):
            state = self._state_for(p)
            new_p, new_state = Adam.update(self, p.detach(), g, state, lr)
            if self._apply_decay_param_fun(p.name):
                new_p = new_p - _rounded(p.dtype, lr * self._coeff) * p
            p.copy_(new_p)
            state.update(new_state)

    def functional_update(self, params: dict, grads: dict, states: dict,
                          lr=None, step=None, donate: bool = False):
        if self._apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW apply_decay_param_fun on the functional path: the "
                "reference's functional update decays every parameter; use "
                "the eager step()")
        return super().functional_update(params, grads, states, lr, step,
                                         donate)


class Adamax(Optimizer):
    """Adam on the infinity norm (reference ``Adamax`` :459):
    ``u' = max(b2 u, |g|)``, ``p' = p - lr / (1 - b1^t) * m' / (u' + eps)``;
    ``beta1_pow`` in f32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, value) -> dict:
        return {"moment": torch.zeros_like(value),
                "inf_norm": torch.zeros_like(value),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=value.device)}

    def update(self, param, grad, state, lr):
        b1, c1, b2, eps = _rounded(param.dtype, self._beta1, 1 - self._beta1,
                                   self._beta2, self._epsilon)
        m = b1 * state["moment"] + c1 * grad
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(grad))
        b1p = state["beta1_pow"] * _rounded(torch.float32, self._beta1)
        new_p = param - (_rounded(torch.float32, lr) / (1 - b1p)) * m / (
            u + eps)
        return new_p, {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class Adagrad(Optimizer):
    """``acc' = acc + g g``, ``p' = p - lr g / (sqrt(acc') + eps)``
    (reference ``Adagrad`` :480); ``moment`` starts at
    ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, value) -> dict:
        return {"moment": torch.full_like(value, self._init_acc)}

    def update(self, param, grad, state, lr):
        lr, eps = _rounded(param.dtype, lr, self._epsilon)
        acc = state["moment"] + grad * grad
        return param - lr * grad / (torch.sqrt(acc) + eps), {"moment": acc}


class Adadelta(Optimizer):
    """Adadelta (reference ``Adadelta`` :497): running averages of the
    squared gradient and the squared update, ``rho`` and ``epsilon``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def init_state(self, value) -> dict:
        return {"avg_squared_grad": torch.zeros_like(value),
                "avg_squared_update": torch.zeros_like(value)}

    def update(self, param, grad, state, lr):
        rho, c, eps, lr = _rounded(param.dtype, self._rho, 1 - self._rho,
                                   self._epsilon, lr)
        asg = rho * state["avg_squared_grad"] + c * grad * grad
        upd = grad * torch.sqrt(state["avg_squared_update"] + eps) / \
            torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + c * upd * upd
        return param - lr * upd, {"avg_squared_grad": asg,
                                  "avg_squared_update": asu}


class RMSProp(Optimizer):
    """RMSProp with momentum, centred or not (reference ``RMSProp`` :518):
    ``ms' = rho ms + (1 - rho) g g``, centred ``mg' = rho mg + (1 - rho)
    g`` and ``denom = sqrt(ms' - mg'^2 + eps)`` (else ``sqrt(ms' + eps)``),
    ``mom' = momentum mom + lr g / denom``, ``p' = p - mom'``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, value) -> dict:
        st = {"mean_square": torch.zeros_like(value),
              "momentum": torch.zeros_like(value)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(value)
        return st

    def update(self, param, grad, state, lr):
        rho, c, eps, mu, lr = _rounded(param.dtype, self._rho, 1 - self._rho,
                                       self._epsilon, self._momentum, lr)
        ms = rho * state["mean_square"] + c * grad * grad
        st = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + c * grad
            denom = torch.sqrt(ms - mg * mg + eps)
            st["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + eps)
        st["momentum"] = mu * state["momentum"] + lr * grad / denom
        return param - st["momentum"], st


class Lamb(Optimizer):
    """Layer-wise trust ratio over Adam's step (reference ``Lamb``
    :550-602), ``r = m̂ / (sqrt(v̂) + eps) + wd p``, ``p' = p - lr
    (||p|| / ||r||) r`` (trust 1 where either norm is 0); beta pows in f32.
    With ``exclude_from_weight_decay_fn`` the eager ``step()`` is the
    reference's own loop (no ``optimize_attr``, no regularizer, wd off
    where the function accepts the parameter)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, value) -> dict:
        one = torch.ones((), dtype=torch.float32, device=value.device)
        return {"moment1": torch.zeros_like(value),
                "moment2": torch.zeros_like(value),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def update(self, param, grad, state, lr, decay=True):
        b1, c1, b2, c2, eps, wd = _rounded(
            param.dtype, self._beta1, 1 - self._beta1, self._beta2,
            1 - self._beta2, self._epsilon, self._lamb_wd)
        m = b1 * state["moment1"] + c1 * grad
        v = b2 * state["moment2"] + c2 * grad * grad
        f32b1, f32b2 = _rounded(torch.float32, self._beta1, self._beta2)
        b1p = state["beta1_pow"] * f32b1
        b2p = state["beta2_pow"] * f32b2
        r = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + eps)
        if decay:
            r = r + wd * param
        w_norm = torch.linalg.vector_norm(param.reshape(-1))
        r_norm = torch.linalg.vector_norm(r.reshape(-1))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        new_p = param - _rounded(param.dtype, lr) * trust * r
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}

    @torch.no_grad()
    def step(self):
        if self._exclude_fn is None:
            return super().step()
        lr = self.get_lr()
        self._global_step += 1
        for p, g in self._grads_and_params(densify=True):
            state = self._state_for(p)
            new_p, new_state = self.update(p.detach(), g, state, lr,
                                           decay=not self._exclude_fn(p))
            p.copy_(new_p)
            state.update(new_state)

    def functional_update(self, params: dict, grads: dict, states: dict,
                          lr=None, step=None, donate: bool = False):
        if self._exclude_fn is not None:
            raise NotImplementedError(
                "Lamb exclude_from_weight_decay_fn on the functional path: "
                "the reference's functional update decays every parameter; "
                "use the eager step()")
        return super().functional_update(params, grads, states, lr, step,
                                         donate)
