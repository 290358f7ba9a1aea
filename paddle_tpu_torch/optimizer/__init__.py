"""Optimizers of the port (paddle_tpu/optimizer): SGD, Momentum,
LarsMomentum, Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp and Lamb,
each with the eager ``step()`` API and the functional update that
jit.TrainStep applies (fused or not), and the learning-rate schedulers of
optimizer.lr."""
from paddle_tpu_torch.optimizer import lr  # noqa: F401
from paddle_tpu_torch.optimizer.optimizer import (  # noqa: F401
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, LarsMomentum,
    Momentum, Optimizer, RMSProp)
