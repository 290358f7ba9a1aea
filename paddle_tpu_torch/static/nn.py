"""Control flow: ``static.nn.{while_loop, cond, case, switch_case}`` (port
of paddle_tpu/static/nn.py).

One API, two regimes, as in the reference:

- **eager** (concrete tensors): plain Python control flow; autograd
  records the branch or the iterations that ran.  A predicate on the card
  is read back by ``bool(pred)``, as the reference's eager mode reads it.
- **under capture** (``torch.export``, which ``jit.to_static`` and
  ``jit.save`` run): ``torch.cond`` and the ``while_loop`` higher-order
  op, so the captured graph keeps the control flow instead of one traced
  path.  A value is traced when it is a tensor and an export is running
  (:func:`_is_traced`), where the reference tests for a JAX tracer
  (``:38``); a Python predicate stays Python.

Loop state is a flat list or tuple of tensors whose shapes and dtypes the
body keeps; under capture a Python number among it becomes a tensor on the
loop's device.  ``torch.cond``'s branches return tensors (or tuples of
them) of one structure.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["while_loop", "cond", "case", "switch_case"]


def _is_traced(x) -> bool:
    return isinstance(x, torch.Tensor) and torch.compiler.is_exporting()


def _scalar(pred) -> torch.Tensor:
    return pred.reshape(()).to(torch.bool)


def _device_of(vals, pred=None):
    for v in list(vals) + [pred]:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def _as_tuple(out):
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _fresh(fn):
    """``fn`` whose tensor outputs are new tensors: a ``torch.cond``
    branch may not return a tensor it closes over as it is."""
    def run():
        return pytree.tree_map_only(torch.Tensor, torch.clone, fn())
    return run


def while_loop(cond: Callable, body: Callable, loop_vars: Sequence,
               is_test: bool = False, name: Optional[str] = None) -> List:
    """Reference ``:54``: ``cond(*vars) -> scalar bool``, ``body(*vars) ->
    new vars`` (same structure, shapes and dtypes)."""
    if not callable(cond) or not callable(body):
        raise TypeError("cond and body must be callable")
    loop_vars = list(loop_vars)
    if not loop_vars:
        raise ValueError("loop_vars cannot be empty")
    first = cond(*loop_vars)
    if not any(_is_traced(v) for v in loop_vars) and not _is_traced(first):
        vals, t = loop_vars, first
        while bool(t):
            vals = list(_as_tuple(body(*vals)))
            if len(vals) != len(loop_vars):
                raise ValueError(f"body returned {len(vals)} vars, expected "
                                 f"{len(loop_vars)}")
            t = cond(*vals)
        return vals
    from torch._higher_order_ops import while_loop as _while
    dev = _device_of(loop_vars, first)
    init = tuple(v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(v, device=dev) for v in loop_vars)

    def step(*c):
        # the body may not return a carry as it is
        out = _as_tuple(body(*c))
        return tuple(o.clone() if any(o is x for x in c) else o for o in out)
    out = _while(lambda *c: _scalar(cond(*c)), step, init)
    return list(out)


def cond(pred, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name: Optional[str] = None):
    """Reference ``:92``.  Both branches return one structure."""
    if _is_traced(pred):
        tf = true_fn or (lambda: None)
        ff = false_fn or (lambda: None)
        return torch.cond(_scalar(pred), _fresh(tf), _fresh(ff))
    taken = true_fn if bool(pred) else false_fn
    return taken() if taken is not None else None


def case(pred_fn_pairs: Sequence[Tuple], default: Optional[Callable] = None,
         name: Optional[str] = None):
    """Reference ``:113``: the first true predicate's branch; under
    capture a chain of ``torch.cond``, whose last else is ``default`` (or
    the last branch, as the reference's ``default=None``)."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs cannot be empty")
    for _, f in pred_fn_pairs:
        if not callable(f):
            raise TypeError("branch fns must be callable")
    if not any(_is_traced(p) for p, _ in pred_fn_pairs):
        for p, f in pred_fn_pairs:
            if bool(p):
                return f()
        if default is None:
            raise ValueError("no predicate true and no default given")
        return default()
    pairs = list(pred_fn_pairs)
    if default is None:
        default = pairs.pop()[1]

    def build(i):
        if i == len(pairs):
            return default
        p, f = pairs[i]
        nxt = build(i + 1)
        return lambda: torch.cond(_scalar(torch.as_tensor(p)), _fresh(f),
                                  _fresh(nxt))
    return build(0)()


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name: Optional[str] = None):
    """Reference ``:148``.  ``branch_fns``: {int: fn}, or a sequence of
    (int, fn) pairs or bare fns.  An index that matches no key takes
    ``default`` (or the largest key's branch, as the reference)."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        pairs = [(i, f) if callable(f) else tuple(f)
                 for i, f in enumerate(branch_fns)]
        pairs = [(int(k), f) for k, f in pairs]
    keys = [k for k, _ in pairs]
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate branch indices")
    if default is None:
        default = pairs[-1][1]
    if not _is_traced(branch_index):
        k = int(branch_index)
        for key, f in pairs:
            if key == k:
                return f()
        return default()
    idx = branch_index.reshape(()).to(torch.int64)

    def build(i):
        if i == len(pairs):
            return default
        key, f = pairs[i]
        nxt = build(i + 1)
        return lambda: torch.cond(idx == key, _fresh(f), _fresh(nxt))
    return build(0)()
