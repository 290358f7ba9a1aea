"""Activation recompute for the whole port (the reference's
``jax.checkpoint``: ``TrainStep(recompute=True)``, ``jit/__init__.py:371-376``;
per-layer ``remat``, ``models/gpt.py:218`` and ``models/bert.py:219``; and
``distributed/fleet/utils`` ``recompute``).

:func:`recompute` runs ``function(*args, **kwargs)`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps none of the tensors the backward reads, and the backward replays the
function to rebuild them.  The autograd graph is the one the plain call
records, so the gradients are bitwise those without recompute wherever the
replay computes the same values.  Outside autograd (``torch.is_grad_enabled()``
false: serving, ``inference_mode``) it is the plain call.

The reference is pure: ``jax.checkpoint`` replays the same key, and
buffers are functional outputs.  PyTorch's replay runs the function's side
effects again, and its ``preserve_rng_state`` rewinds only the default CPU
and CUDA generators.  So a region also restores, on replay:

- each explicit ``torch.Generator`` that a draw in the region announced
  with :func:`note_generator` (``nn.functional.dropout`` does): rewound to
  its state before the region's first draw from it, and put back after the
  replay to the state it had before it, so the replay draws the forward's
  masks and leaves the generator where the forward left it;
- for :func:`recompute_capturing` (``fleet.utils.recompute``), the
  parameter substitutions of :func:`substituted_call` (the AMP cast of
  ``jit.functional_loss_call``), live during the forward and over by the
  time the backward runs: the replay re-enters them, so a block that reads
  a module attribute such as ``self.weight`` reads the same cast copy.
  :func:`recompute` does not: the models' layers take every weight as an
  argument, and ``TrainStep(recompute=True)``'s region opens its own
  substitution, so re-entering, a ``functional_call`` over the whole
  model, would only cost host time in each replay;

and in a replay ``framework.replay.replaying()`` is true, so BatchNorm
skips the in-place momentum update of its running statistics, which the
forward made once.  The regions being run live in
``framework.replay``'s thread-local stack, which the functional layers
read; the substitutions in this module's.  A replay runs inside a
``recompute.replay`` profiler range (``tools/profile_gpt.py`` and
``chip_smoke.py`` read its host time).
"""
from __future__ import annotations

import threading
from typing import Callable

import torch
from torch import nn

from paddle_tpu_torch.framework.replay import regions
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["recompute", "recompute_capturing", "substituted_call"]

_local = threading.local()


def _subs() -> list:
    """This thread's stack of live substitutions, innermost last."""
    st = getattr(_local, "subs", None)
    if st is None:
        st = _local.subs = []
    return st


class _Bound(Layer):
    """``fn(model, *inputs)`` as a module, so that
    ``torch.func.functional_call`` can swap the model's parameters."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(self.model, *inputs)


def substituted_call(model: nn.Module, fn: Callable, params: dict, inputs):
    """``fn(model, *inputs)`` with ``params`` ({"model.<name>": tensor})
    standing in for the model's parameters (``torch.func.functional_call``).
    A :func:`recompute_capturing` region opened inside replays under the
    same substitution."""
    subs = _subs()
    subs.append((model, params))
    try:
        return torch.func.functional_call(_Bound(model, fn), params,
                                          tuple(inputs))
    finally:
        subs.pop()


def _reenter(subs, fn: Callable):
    """``fn()`` under each substitution of ``subs``, outermost first."""
    if not subs:
        return fn()
    (model, params), rest = subs[0], subs[1:]
    return substituted_call(model, lambda m: _reenter(rest, fn), params, ())


class _Region:
    """One checkpointed call: its first run is the forward, every later
    run a replay."""

    def __init__(self, function: Callable, kwargs: dict, preserve: bool,
                 subs: tuple):
        self.function = function
        self.kwargs = kwargs
        self.preserve = preserve
        self.subs = subs               # the substitutions a replay re-enters
        self.generators: dict = {}     # id -> (generator, state at 1st draw)
        self.ran = False
        self.replay = False

    def note(self, generator: torch.Generator):
        if not self.replay and id(generator) not in self.generators:
            self.generators[id(generator)] = (generator,
                                              generator.get_state())

    def __call__(self, *args):
        stack = regions()
        if not self.ran:
            self.ran = True
            stack.append(self)
            try:
                return self.function(*args, **self.kwargs)
            finally:
                stack.pop()
        with torch.profiler.record_function("recompute.replay"):
            return self._replay(args)

    def _replay(self, args):
        self.replay = True
        rewind = list(self.generators.values()) if self.preserve else []
        after = [(g, g.get_state()) for g, _ in rewind]
        for g, state in rewind:
            g.set_state(state)
        stack = regions()
        stack.append(self)
        try:
            return _reenter(self.subs,
                            lambda: self.function(*args, **self.kwargs))
        finally:
            stack.pop()
            for g, state in after:
                g.set_state(state)


def _checkpoint(function: Callable, args, kwargs: dict, preserve: bool,
                subs: tuple):
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    return torch.utils.checkpoint.checkpoint(
        _Region(function, kwargs, preserve, subs), *args, use_reentrant=False,
        preserve_rng_state=preserve)


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              **kwargs):
    """``function(*args, **kwargs)``, its activations rebuilt in the
    backward by a replay instead of kept (see the module docstring), for a
    function that takes every tensor it reads as an argument or opens its
    own parameter substitution (the models' layers, TrainStep's loss).
    Outputs may be a tensor, a tuple or an argument passed through.
    ``preserve_rng_state=False`` lets the replay draw fresh random numbers,
    default and explicit generators alike."""
    return _checkpoint(function, args, kwargs, preserve_rng_state, ())


def recompute_capturing(function: Callable, *args,
                        preserve_rng_state: bool = True, **kwargs):
    """:func:`recompute` for a function that may read the tensors it
    captures, such as a module's parameters: gradients reach them, and the
    replay re-enters the parameter substitutions live at this call (the
    AMP cast of an enclosing ``jit.TrainStep``), so it reads the tensors
    the forward read.  ``fleet.utils.recompute`` is this function."""
    return _checkpoint(function, args, kwargs, preserve_rng_state,
                       tuple(_subs()))
