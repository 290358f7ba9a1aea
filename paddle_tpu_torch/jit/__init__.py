"""TrainStep: forward, backward and optimizer update in one call (port of
paddle_tpu/jit/__init__.py ``functional_loss_call`` :270,
``apply_functional_update`` :300 and ``TrainStep`` :309).

The reference traces the step into one XLA computation; PyTorch runs it
eagerly, in the same order: the loss under autograd (with the AMP cast),
the gradients of every parameter, then the optimizer's functional update
under ``torch.no_grad()``, written back into the module's parameters.

AMP O2: each floating parameter with ``ndim >= 1`` is cast to the AMP
dtype for the forward (``torch.func.functional_call`` over the cast
copies), while the module's f32 parameters stay the masters that receive
the gradient and the update, as in the reference's ``functional_loss_call``.

Not in this slice, and raising ``NotImplementedError``: ``amp_level="O1"``,
``accumulate_steps > 1`` and ``recompute=True``.  ``donate`` is accepted
and means nothing in eager PyTorch: the update is written into the
parameters' own storage, so one copy of them is live either way.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

__all__ = ["TrainStep", "functional_loss_call", "apply_functional_update"]

_NEXT = "next slice of the port (2b, the fused training path)"


class _Bound(nn.Module):
    """``loss_fn(model, *inputs)`` as a module, so that
    ``torch.func.functional_call`` can swap the model's parameters."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *inputs):
        return self.loss_fn(self.model, *inputs)


def functional_loss_call(model, loss_fn, params: dict, inputs,
                         amp: bool = False, amp_dtype=torch.bfloat16):
    """``loss_fn(model, *inputs)`` as an f32 scalar on autograd's tape.
    With ``amp``, floating parameters of ``ndim >= 1`` and floating inputs
    are cast to ``amp_dtype`` for the call; ``params`` ({name: parameter})
    stay the leaves that receive the gradient."""
    if not amp:
        loss = loss_fn(model, *inputs)
    else:
        cast = {f"model.{n}": (p.to(amp_dtype)
                               if p.is_floating_point() and p.dim() >= 1
                               else p)
                for n, p in params.items()}
        inputs = [i.to(amp_dtype) if i.is_floating_point() else i
                  for i in inputs]
        loss = torch.func.functional_call(_Bound(model, loss_fn), cast,
                                          tuple(inputs))
    return loss.float()


def apply_functional_update(opt, grads: dict, params: dict, opt_states,
                            lr):
    """The optimizer's functional update (reference ``:300``; gradient
    clipping is not in this slice and the optimizer refuses it)."""
    return opt.functional_update(params, grads, opt_states, lr=lr)


class TrainStep:
    """One training step per call: forward, backward, optimizer update.

    ``loss_fn(model, *inputs) -> scalar``.  ``step(*inputs)`` returns the
    f32 scalar loss (detached) and advances ``optimizer._global_step``.
    The optimizer's state lives here, in ``_opt_states`` ({parameter name:
    {moment1, moment2, beta1_pow, beta2_pow}}), created at the first call;
    :meth:`set_opt_states` installs one, e.g. from
    ``models.convert.opt_states_from_jax``.  The update runs inside a
    ``TrainStep.update`` profiler range, which ``tools/profile_gpt.py
    --train`` reads to tell the optimizer's kernels from the model's.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 amp_level: Optional[str] = None, amp_dtype="bfloat16",
                 accumulate_steps: int = 1, donate: bool = True,
                 recompute: bool = False):
        if amp_level == "O1":
            raise NotImplementedError(
                f"amp_level='O1' (op-level autocast lists) comes with the "
                f"{_NEXT}")
        if amp_level not in (None, "O0", "O2"):
            raise ValueError(f"amp_level must be None, 'O0' or 'O2', got "
                             f"{amp_level!r}")
        if accumulate_steps != 1:
            raise NotImplementedError(
                f"accumulate_steps={accumulate_steps}: gradient merge comes "
                f"with the {_NEXT}")
        if recompute:
            raise NotImplementedError(
                "recompute=True: activation recompute is not ported")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = (torch.bfloat16 if str(amp_dtype) in (
            "bfloat16", "bf16", "torch.bfloat16") else torch.float16)
        self.accumulate_steps = accumulate_steps
        self.donate = donate
        self.recompute = recompute
        self._opt_states: Optional[dict] = None

    def _params(self) -> dict:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def set_opt_states(self, states: dict):
        """Install optimizer state {name: {key: tensor}} for the model's
        parameters, moved to each parameter's device."""
        params = self._params()
        if set(states) != set(params):
            raise ValueError(f"opt states name {sorted(states)}, the model's "
                             f"parameters are {sorted(params)}")
        self._opt_states = {
            n: {k: t.to(params[n].device) for k, t in st.items()}
            for n, st in states.items()}

    def __call__(self, *inputs):
        params = self._params()
        dev = next(iter(params.values())).device
        if self._opt_states is None:
            self._opt_states = self.optimizer.functional_init_states(
                {n: p.detach() for n, p in params.items()})
        inputs = [torch.as_tensor(i).to(dev) for i in inputs]
        lr = torch.tensor(self.optimizer.get_lr(), dtype=torch.float32,
                          device=dev)
        amp = self.amp_level == "O2"
        with torch.enable_grad():
            loss = functional_loss_call(self.model, self.loss_fn, params,
                                        inputs, amp=amp,
                                        amp_dtype=self.amp_dtype)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        # an unused parameter gets a zero gradient, as jax.grad gives it
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.update"):
            new_params, self._opt_states = apply_functional_update(
                self.optimizer, grads,
                {n: p.detach() for n, p in params.items()},
                self._opt_states, lr)
            for n, p in params.items():
                p.copy_(new_params[n])
        self.optimizer._global_step += 1
        return loss.detach()
