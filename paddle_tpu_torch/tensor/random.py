"""Random sampling and the global generator (port of
paddle_tpu/tensor/random.py).

The reference draws every sample from one global ``jax.random`` key
stream.  Here ``default_generator`` is PyTorch's own default generator
of each device (``torch.default_generator`` on the CPU, the card's in
``torch.cuda.default_generators``), so the samplers below, the
initializers (``nn.initializer``) and dropout draw from one stream a
device, and ``seed(v)`` reseeds every one of them.  The distributions
are the reference's; the streams are not (JAX's threefry draws are not
reproduced, as ``nn.initializer`` decided).

``get_rng_state`` / ``set_rng_state`` take and restore a stream exactly;
the state is PyTorch's generator state (a uint8 tensor), not the
reference's key.

Samplers run on the port's default device unless ``device=`` asks for
another; ``rand``, ``randn``, ``uniform`` and ``normal`` take the
default dtype (``get_default_dtype()``), ``randint`` and ``randperm``
int64.  The in-place samplers update a leaf that requires grad outside
autograd, as the reference's do.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.dtype import convert_dtype, default_dtype

__all__ = [
    "Generator", "seed", "get_rng_state", "set_rng_state", "default_generator",
    "rand", "randn", "randint", "randint_like", "uniform", "normal",
    "standard_normal", "poisson", "bernoulli", "multinomial", "randperm",
    "uniform_", "normal_", "exponential_",
]


class Generator:
    """A seeded stream: a ``torch.Generator`` on ``device`` (the port's
    default device unless given)."""

    def __init__(self, seed: int = 0, device=None):
        self._device = resolve_device(device)
        self._gen = torch.Generator(device=self._device)
        self.manual_seed(seed)

    def generator(self, device=None) -> torch.Generator:
        """The ``torch.Generator`` draws on ``device`` take."""
        dev = resolve_device(device)
        if dev.type != self._device.type:
            raise ValueError(f"this Generator draws on {self._device}, "
                             f"not {dev}")
        return self._gen

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        self._gen.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def get_state(self):
        return self._gen.get_state()

    def set_state(self, state):
        self._gen.set_state(state)


class _DefaultGenerator(Generator):
    """PyTorch's default generator of whichever device a draw is on."""

    def __init__(self):
        self._seed = torch.initial_seed()

    def generator(self, device=None) -> torch.Generator:
        dev = resolve_device(device)
        if dev.type == "cpu":
            return torch.default_generator
        torch.cuda.init()
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[idx]

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        torch.manual_seed(self._seed)     # the CPU's and every card's
        return self

    def get_state(self, device=None):
        return self.generator(device).get_state()

    def set_state(self, state, device=None):
        self.generator(device).set_state(state)


default_generator = _DefaultGenerator()


def seed(value: int):
    """Reseed ``default_generator``: PyTorch's default generators of the
    CPU and of every card."""
    return default_generator.manual_seed(value)


def get_rng_state(device=None):
    """The default stream's state on ``device`` (the port's default)."""
    return default_generator.get_state(device)


def set_rng_state(state, device=None):
    default_generator.set_state(state, device)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.reshape(-1).tolist()]
    if isinstance(shape, int):
        return [shape]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in shape]


def _float(dtype):
    return convert_dtype(dtype) if dtype else default_dtype()


def _draw(fn, shape, dtype, device, gen=None):
    dev = resolve_device(device)
    out = torch.empty(_shape(shape), dtype=dtype, device=dev)
    return fn(out, gen or default_generator.generator(dev))


def rand(shape, dtype=None, name=None, device=None):
    """U[0, 1)."""
    return _draw(lambda o, g: o.uniform_(0.0, 1.0, generator=g), shape,
                 _float(dtype), device)


def randn(shape, dtype=None, name=None, device=None):
    """N(0, 1)."""
    return _draw(lambda o, g: o.normal_(0.0, 1.0, generator=g), shape,
                 _float(dtype), device)


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            device=None):
    """Integers in [low, high); ``randint(n)`` alone draws from [0, n)."""
    if high is None:
        low, high = 0, low
    return _draw(lambda o, g: o.random_(low, high, generator=g), shape,
                 convert_dtype(dtype), device)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, shape=list(x.shape), dtype=dtype or x.dtype,
                   device=x.device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device=None):
    """U[min, max).  A ``seed`` other than 0 draws from a new generator
    seeded with it, whatever the default stream's state."""
    dev = resolve_device(device)
    gen = None
    if seed:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    return _draw(lambda o, g: o.uniform_(float(min), float(max),
                                         generator=g),
                 shape, _float(dtype), dev, gen)


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    """``mean + std * z`` with z ~ N(0, 1) in the default dtype, of
    ``shape`` or of the broadcast shape of tensor ``mean`` and ``std``
    (on their device), by the reference's promotion."""
    from paddle_tpu_torch.tensor import math as tmath
    tensors = [v for v in (mean, std) if isinstance(v, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        out_shape = (torch.broadcast_shapes(*(tuple(v.shape)
                                              for v in tensors))
                     if shape is None else _shape(shape))
    else:
        dev = resolve_device(device)
        out_shape = _shape(shape) if shape is not None else []
    z = randn(out_shape, device=dev)
    return tmath.add(mean, tmath.multiply(std, z))


def poisson(x, name=None):
    """Poisson draws of the rates ``x``, in x's dtype."""
    g = default_generator.generator(x.device)
    rates = x.detach().to(torch.promote_types(x.dtype, torch.float32))
    return torch.poisson(rates, generator=g).to(x.dtype)


def bernoulli(x, name=None):
    """1 with probability ``x``, else 0, in x's dtype."""
    g = default_generator.generator(x.device)
    p = x.detach().to(torch.promote_types(x.dtype, torch.float32))
    return torch.bernoulli(p, generator=g).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 indices of ``num_samples`` draws from each row of the
    (unnormalised) probabilities ``x``, taken as ``log(max(p, 1e-30))``
    (reference ``:139-150``).  Without replacement a Gumbel top-k, so a
    row with fewer non-zero entries than ``num_samples`` is sampled too
    (``torch.multinomial`` refuses it)."""
    g = default_generator.generator(x.device)
    dt = torch.promote_types(x.dtype, torch.float32)
    logits = torch.log(x.detach().to(dt).clamp_min(1e-30))
    if replacement:
        probs = torch.exp(logits - logits.amax(-1, keepdim=True))
        flat = probs.reshape(-1, probs.shape[-1])
        out = torch.multinomial(flat, num_samples, replacement=True,
                                generator=g)
        return out.reshape(*probs.shape[:-1], num_samples)
    u = torch.empty_like(logits).uniform_(generator=g)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(dt).tiny)))
    return torch.topk(logits + gumbel, num_samples, dim=-1).indices


def randperm(n, dtype="int64", name=None, device=None):
    """A random permutation of 0 .. n - 1."""
    dev = resolve_device(device)
    return torch.randperm(n, generator=default_generator.generator(dev),
                          device=dev, dtype=convert_dtype(dtype))


@torch.no_grad()
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    """Fill x with U[min, max) draws of the default stream (``seed`` is
    not read, as in the reference)."""
    return x.uniform_(float(min), float(max),
                      generator=default_generator.generator(x.device))


@torch.no_grad()
def normal_(x, mean=0.0, std=1.0, name=None):
    return x.normal_(float(mean), float(std),
                     generator=default_generator.generator(x.device))


@torch.no_grad()
def exponential_(x, lam=1.0, name=None):
    """Fill x with Exp(lam) draws, in x's dtype."""
    return x.exponential_(float(lam),
                          generator=default_generator.generator(x.device))
