"""Optimizers of the port (paddle_tpu/optimizer): Adam and AdamW, the
functional update that jit.TrainStep applies."""
from paddle_tpu_torch.optimizer.optimizer import (  # noqa: F401
    Adam, AdamW, Optimizer)
