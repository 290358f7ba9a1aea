"""The state a recompute region's replay must restore, shared by the
layers that hold such state and the helper that runs the regions
(``jit/recompute.py``).

PyTorch's checkpoint replays a function's side effects and rewinds only
the default generators.  Two kinds of state need more:

- an explicit ``torch.Generator`` (``nn.functional.dropout``): a draw
  announces it with :func:`note_generator`, and each region being run in
  its forward records the generator's state before its first draw, to
  rewind it in the replay;
- a running statistic updated in place (``nn.functional.batch_norm``):
  it is not updated again while :func:`replaying` is true.

The regions being run form a thread-local stack (:func:`regions`), so
ranks run as threads (``parallel.mesh.LoopbackWorld``) do not see each
other's.  A region has a ``replay`` attribute, true in its replay, and a
``note(generator)`` method.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["regions", "replaying", "note_generator"]

_local = threading.local()


def regions() -> list:
    """This thread's stack of the recompute regions being run, innermost
    last."""
    st = getattr(_local, "regions", None)
    if st is None:
        st = _local.regions = []
    return st


def replaying() -> bool:
    """True inside the backward's replay of a recompute region (and in a
    region that a replay opens): a running statistic is not updated
    again."""
    return any(r.replay for r in regions())


def note_generator(generator: torch.Generator):
    """Announce a draw from an explicit ``generator`` to each region being
    run, which records its state before the region's first draw."""
    for r in regions():
        r.note(generator)
