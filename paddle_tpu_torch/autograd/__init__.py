"""Reverse-mode differentiation (port of paddle_tpu/autograd/__init__.py
``:21``, ``:220-291``) over torch's autograd.

- :func:`backward` / :func:`backward_from` accumulate into ``.grad``; a
  missing gradient of an output is ones, whatever its shape.
- :func:`grad` returns the gradients of ``outputs`` with respect to
  ``inputs`` and leaves ``.grad`` alone.  ``retain_graph`` defaults to
  ``create_graph``; an input the outputs do not reach raises unless
  ``allow_unused`` (then its gradient is None); ``create_graph=True``
  gives gradients that differentiate again; ``no_grad_vars`` stops the
  gradient at those tensors (the reference accepts and ignores it).
- :func:`no_grad` and :func:`enable_grad` work as ``with no_grad():``,
  as ``@no_grad`` on a function and as ``@no_grad()``;
  :func:`set_grad_enabled` sets the mode when called and works as a
  context manager too.
"""
from __future__ import annotations

import torch

__all__ = ["backward", "backward_from", "grad", "no_grad", "enable_grad",
           "is_grad_enabled", "set_grad_enabled", "set_grad_enabled_"]


def _as_list(v):
    return [v] if isinstance(v, torch.Tensor) else list(v)


def _cotangents(outputs, grads):
    if grads is None:
        grads = [None] * len(outputs)
    elif isinstance(grads, torch.Tensor):
        grads = [grads]
    return [torch.ones_like(t) if g is None else
            torch.as_tensor(g, dtype=t.dtype, device=t.device)
            for t, g in zip(outputs, grads)]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` (seeded by
    ``grad_tensors``, ones where None) into the leaves' ``.grad``."""
    tensors = _as_list(tensors)
    torch.autograd.backward(tensors, _cotangents(tensors, grad_tensors),
                            retain_graph=retain_graph)


def backward_from(tensor, grad_tensor=None, retain_graph=False):
    backward([tensor], [grad_tensor], retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The list of d(outputs)/d(input) for each of ``inputs``."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if retain_graph is None:
        retain_graph = create_graph
    stops = [] if no_grad_vars is None else _as_list(no_grad_vars)
    handles = [v.register_hook(torch.zeros_like) for v in stops
               if v.requires_grad]
    try:
        got = torch.autograd.grad(outputs, inputs,
                                  _cotangents(outputs, grad_outputs),
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    for i, g in enumerate(got):
        if g is None and not allow_unused:
            raise RuntimeError(
                f"input {i} is unused in the graph (pass allow_unused=True "
                "to get None)")
    return list(got)


def no_grad(func=None):
    """A context manager and decorator that turns gradients off."""
    return torch.no_grad() if func is None else torch.no_grad()(func)


def enable_grad(func=None):
    return torch.enable_grad() if func is None else torch.enable_grad()(func)


is_grad_enabled = torch.is_grad_enabled
set_grad_enabled = torch.set_grad_enabled


def set_grad_enabled_(mode):
    torch.set_grad_enabled(bool(mode))
