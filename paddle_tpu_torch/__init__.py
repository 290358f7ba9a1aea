"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module layout.  It imports ``torch`` and ``numpy`` only.  Entry
points run on the card (``"cuda"``) unless the caller passes
``device="cpu"``; the hand-written kernels are built from ``csrc/`` at
first use (``ops/cuda/_build.py``).
"""
from paddle_tpu_torch.device import get_device, set_device  # noqa: F401

__version__ = "0.1.0"

__all__ = ["__version__", "get_device", "set_device"]
