"""TrainStep: forward, backward and optimizer update in one call (port of
paddle_tpu/jit/__init__.py ``functional_loss_call`` :270,
``apply_functional_update`` :300 and ``TrainStep`` :309).

The reference traces the step into one XLA computation; PyTorch runs it
eagerly, in the same order: the loss under autograd (with the AMP cast),
the gradients of every parameter (summed over micro-batches with
``accumulate_steps``), the gradient clip, then the optimizer's functional
update under ``torch.no_grad()``, written back into the module's
parameters.

AMP: with ``amp_level`` "O1" or "O2" each floating parameter with
``ndim >= 1`` is cast to the AMP dtype for the forward
(``torch.func.functional_call`` over the cast copies), while the module's
f32 parameters stay the masters that receive the gradient and the update,
as in the reference's ``functional_loss_call``.  The reference's
TrainStep treats O1 as O2 (``amp = self.amp_level in ("O1", "O2")``,
:363), and so does the port.

Buffers (BatchNorm's running statistics) are the module's own tensors:
``functional_call`` is handed the cast parameters only, so a training
forward updates the buffers in place, off autograd's tape, where the
reference threads them through the step as functional outputs
(``functional_loss_call`` :270-297).  They are never cast by AMP and take
no gradient; with ``accumulate_steps = k`` micro-batch j normalises by its
own statistics and leaves the running stats for micro-batch j + 1, as the
reference's scan carries them (:385-396).

``donate`` (the default) lets the optimizer write the new parameters and
moments into their own storage where it can (the fused Adam): one copy of
them stays live, as the reference's donation keeps one.  Not ported, and
raising ``NotImplementedError``: ``recompute=True``, and a gradient clip
without ``functional_clip``, which the reference's step silently skips.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

__all__ = ["TrainStep", "functional_loss_call", "apply_functional_update"]


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
    stay the leaves that receive the gradient.  The module's buffers are
    used, and updated by a training forward, as they are: never cast."""
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


def apply_functional_update(opt, grads: dict, params: dict, opt_states, lr,
                            donate: bool = False):
    """Clip with the optimizer's ``grad_clip``, then its functional update
    (reference ``:300``).  A clip without ``functional_clip`` raises where
    the reference skips it."""
    grad_clip = getattr(opt, "_grad_clip", None)
    if grad_clip is not None:
        if not hasattr(grad_clip, "functional_clip"):
            raise NotImplementedError(
                f"grad_clip {type(grad_clip).__name__} has no "
                "functional_clip: the reference's TrainStep skips it "
                "silently, the port does not train without it")
        grads = grad_clip.functional_clip(grads)
    return opt.functional_update(params, grads, opt_states, lr=lr,
                                 donate=donate)


class TrainStep:
    """One training step per call: forward, backward, optimizer update.

    ``loss_fn(model, *inputs) -> scalar``.  ``step(*inputs)`` returns the
    f32 scalar loss (detached) and advances ``optimizer._global_step``.
    With ``accumulate_steps = k > 1`` each input is split along its first
    axis into k micro-batches (reference ``:378-396``): their gradients
    are summed in f32 in order and divided by k, the loss is the mean of
    theirs, and one update follows.  The optimizer's state lives here, in
    ``_opt_states`` ({parameter name: {moment1, moment2, beta1_pow,
    beta2_pow}}), created at the first call; :meth:`set_opt_states`
    installs one, e.g. from ``models.convert.opt_states_from_jax``.  The
    clip and the update run inside a ``TrainStep.update`` profiler range,
    which ``tools/profile_gpt.py --train`` reads to tell the optimizer's
    kernels from the model's.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 amp_level: Optional[str] = None, amp_dtype="bfloat16",
                 accumulate_steps: int = 1, donate: bool = True,
                 recompute: bool = False):
        if amp_level not in (None, "O0", "O1", "O2"):
            raise ValueError(f"amp_level must be None, 'O0', 'O1' or 'O2', "
                             f"got {amp_level!r}")
        if int(accumulate_steps) != accumulate_steps or accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be a positive integer, "
                             f"got {accumulate_steps!r}")
        if recompute:
            raise NotImplementedError(
                "recompute=True: activation recompute is not ported")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = (torch.bfloat16 if str(amp_dtype) in (
            "bfloat16", "bf16", "torch.bfloat16") else torch.float16)
        self.accumulate_steps = int(accumulate_steps)
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

    def _loss_and_grads(self, params: dict, inputs):
        """(f32 loss, [gradient of each parameter]) of one batch; an unused
        parameter gets a zero gradient, as jax.grad gives it."""
        loss = functional_loss_call(
            self.model, self.loss_fn, params, inputs,
            amp=self.amp_level in ("O1", "O2"), amp_dtype=self.amp_dtype)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params.values(), grads)]

    def __call__(self, *inputs):
        params = self._params()
        dev = next(iter(params.values())).device
        if self._opt_states is None:
            self._opt_states = self.optimizer.functional_init_states(
                {n: p.detach() for n, p in params.items()})
        inputs = [torch.as_tensor(i).to(dev) for i in inputs]
        # a fill kernel: the rate reaches the card as a launch argument
        lr = torch.full((), self.optimizer.get_lr(), dtype=torch.float32,
                        device=dev)
        micro = self.accumulate_steps
        parts = [i.reshape((micro, -1) + tuple(i.shape[1:])) for i in inputs]
        losses, grads = [], None
        with torch.enable_grad():
            for k in range(micro):
                loss_k, g_k = self._loss_and_grads(params,
                                                   [p[k] for p in parts])
                losses.append(loss_k)
                grads = g_k if grads is None else [
                    a + b for a, b in zip(grads, g_k)]
        if micro > 1:
            grads = [g / micro for g in grads]
        loss = torch.stack(losses).mean()
        grads = dict(zip(params, grads))
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.update"):
            new_params, self._opt_states = apply_functional_update(
                self.optimizer, grads,
                {n: p.detach() for n, p in params.items()},
                self._opt_states, lr, donate=self.donate)
            for n, p in params.items():
                if new_params[n].data_ptr() != p.data_ptr():
                    p.copy_(new_params[n])
        self.optimizer._global_step += 1
        return loss
