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
in the block reads the same cast weights in both runs.
"""
from paddle_tpu_torch._pending import pending_modules
from paddle_tpu_torch.jit.recompute import recompute_capturing as recompute

__all__ = ["recompute"]
__getattr__ = pending_modules("paddle_tpu_torch.distributed.fleet.utils", {
    "fs": ("5", "the file systems of checkpoints")})
