"""Device resolution (port of paddle_tpu/device.py).

The card is the default: an entry point runs on ``"cuda"`` unless the
caller asks for ``"cpu"``.  Asking for CUDA where there is none raises;
nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["get_device", "set_device", "resolve_device"]

_default = "cuda"


def _check(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def set_device(device) -> torch.device:
    """Set the default device of the port's entry points."""
    global _default
    dev = _check(device)
    _default = str(dev)
    return dev


def get_device() -> str:
    return _default


def resolve_device(device=None) -> torch.device:
    """``device`` or the default, checked: raises if CUDA is asked for and
    absent."""
    return _check(_default if device is None else device)
