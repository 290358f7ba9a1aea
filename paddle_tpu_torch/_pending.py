"""The reference's names the port has not ported yet: calling one (or
reading a pending submodule) raises ``NotImplementedError`` naming its
ROADMAP Queue 1 item."""
from __future__ import annotations


def _message(name: str, item: str, what: str) -> str:
    return (f"{name} ({what}) is ROADMAP Queue 1 item {item}, not ported "
            "yet")


def pending(name: str, item: str, what: str):
    """A stand-in for the reference's callable ``name``."""
    def call(*args, **kwargs):
        raise NotImplementedError(_message(name, item, what))
    call.__name__ = call.__qualname__ = name
    call.__doc__ = _message(name, item, what)
    return call


def pending_modules(module: str, table: dict):
    """A module ``__getattr__`` for the pending submodules of ``module``:
    {name: (item, what)}."""
    def __getattr__(name):
        if name in table:
            raise NotImplementedError(_message(f"{module}.{name}",
                                               *table[name]))
        raise AttributeError(f"module {module!r} has no attribute {name!r}")
    return __getattr__
