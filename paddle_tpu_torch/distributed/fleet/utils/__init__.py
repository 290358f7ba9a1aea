"""fleet.utils — user-facing activation recompute (port of
paddle_tpu/distributed/fleet/utils/__init__.py :28-120).

``recompute(function, *args, preserve_rng_state=True, **kwargs)`` runs
``function`` without keeping its activations; the backward replays it
(``jit/recompute.py`` ``recompute_capturing``).  The reference's contract
holds: one snapshot of the random state before the forward, a forward
that advances the generators as usual, a replay that rewinds to the
snapshot and then puts them back; gradients that reach the tensor
arguments and the parameters the function captures; tuple and
pass-through outputs.  Inside
``jit.TrainStep`` it replays under the step's AMP cast, so a module called
in the block reads the same cast weights in both runs.  ``fs`` holds the
file systems (``LocalFS`` with its crash-safe ``atomic_write``,
``HDFSClient`` over the ``hadoop`` command).
"""
from paddle_tpu_torch.distributed.fleet.utils import fs  # noqa: F401
from paddle_tpu_torch.jit.recompute import recompute_capturing as recompute

__all__ = ["recompute", "fs"]
