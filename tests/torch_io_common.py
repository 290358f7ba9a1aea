"""Datasets for the port's DataLoader worker-process tests
(``test_torch_io.py``): module-level and importing only numpy and torch,
so a spawned worker unpickles them without importing JAX."""
import os
import signal
import time

import numpy as np


class Squares:
    """Sample i: (a (3,) float32 row of i, i squared)."""

    def __len__(self):
        return 24

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), np.int64(i * i)


class CountingSquares(Squares):
    """Squares that count each fetch into the worker's monitor registry
    and report the worker's view of the card."""

    def __getitem__(self, i):
        import torch
        from paddle_tpu_torch.framework import monitor
        monitor.stat_add("test_worker_fetches_total")
        env = (os.environ.get("CUDA_VISIBLE_DEVICES"),
               os.environ.get("PADDLE_TPU_TORCH_WORKER"),
               torch.cuda.device_count())
        return np.full((3,), i, np.float32), np.int64(i * i), \
            np.asarray(env[2]), str(env)


class DiesAt(Squares):
    """Kills its own process at sample ``at``."""

    def __init__(self, at):
        self.at = at

    def __getitem__(self, i):
        if i == self.at:
            os.kill(os.getpid(), signal.SIGKILL)
        return super().__getitem__(i)


class SlowAt(Squares):
    """Sleeps ``seconds`` at sample ``at``."""

    def __init__(self, at, seconds):
        self.at, self.seconds = at, seconds

    def __getitem__(self, i):
        if i == self.at:
            time.sleep(self.seconds)
        return super().__getitem__(i)
