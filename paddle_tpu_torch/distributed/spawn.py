"""``distributed.spawn`` (port of paddle_tpu/distributed/spawn.py
:18-36).

The reference runs ``func`` once, in this process, after
``init_parallel_env``, and warns when ``nprocs > 1``: its one controller
drives every chip.  The port does exactly that; a job of several ranks
starts one process a rank with the ``PADDLE_*`` environment (or a
``LoopbackWorld``) instead.  ``device="cpu"`` among ``options`` starts
the process group on gloo.
"""
from __future__ import annotations

import warnings
from typing import Optional

__all__ = ["spawn"]


def spawn(func, args=(), nprocs: Optional[int] = -1, join: bool = True,
          daemon: bool = False, **options):
    import torch

    from paddle_tpu_torch.distributed.parallel import init_parallel_env
    n = (max(1, torch.cuda.device_count()) if nprocs in (-1, None)
         else nprocs)
    if n > 1:
        warnings.warn(
            "spawn(): runs func once in this process (%d processes were "
            "asked for); start one process a rank to train on several"
            % n)
    init_parallel_env(device=options.get("device"))
    result = func(*args)

    class _Context:
        def join(self):
            return True
    ctx = _Context()
    ctx.result = result
    return ctx
