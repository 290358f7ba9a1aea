"""Tensor-parallel primitives of the port: how a rank's parameter is cut
from the full one, the differentiable collectives of the Megatron program
(port of what GSPMD inserts around the reference's ``mp`` ``DistAttr``s,
``paddle_tpu/distributed/tp_layers.py`` and ``models/gpt.py:115-274``),
and the vocabulary-parallel cross entropy.

The reference writes dense layers whose parameters carry an ``mp``
annotation and lets XLA partition them.  The port writes the partitioned
program by hand: each rank holds only its slice of a split parameter, and
four autograd functions move activations across the ``mp`` group, each
the conjugate of another (Megatron's f and g):

- :func:`copy_to`: identity forward, the sum over the group in the
  backward (a replicated activation entering a column-split product);
- :func:`reduce`: the sum over the group forward, identity backward (the
  partial products of a row-split product, a vocabulary-split lookup);
- :func:`gather`: the all-gather along a dim forward, this rank's slice
  of the gradient backward;
- :func:`scatter`: this rank's slice forward, the all-gather backward.

Every sum is :func:`parallel.mesh.sum_over`, added in rank order: the same
bits on every rank, on loopback threads, gloo and NCCL.  So a replicated
activation and every gradient taken from it are bitwise equal over the
group, and the loss is the same on every rank.

**The host hop.** On ranks simulated as threads of one process
(``LoopbackWorld``) on the card, autograd runs every backward node whose
gradients lie on the card on its one device thread, shared by all ranks:
a collective there makes one rank's wait block the other's.  A function
whose backward is a collective (:func:`copy_to`, :func:`scatter` and the
ring attention's) therefore hands its forward output over on the host, so
its backward node runs on the rank's own thread; the caller moves it back.
The bytes each rank moves so, both ways and in both passes, count in
:func:`host_bytes` (the simulation's cost: one process a card needs
none).  The hop is taken only where a backward will run (grad enabled,
an input requiring grad).

:class:`Split` says how a parameter is cut: along ``dim``, seen as
``groups`` equal blocks, each cut into ``n`` contiguous parts, the rank
taking part ``index`` of every block.  One block is the usual contiguous
cut; GPT's fused ``qkv`` axis is three blocks (q, k, v), so a rank takes
the same heads of each.  A sharded parameter carries ``p.mp_split =
(split, n, index)``; :func:`full_parameters` all-gathers them back into
the reference's full layout.
"""
from __future__ import annotations

import threading
from typing import Dict, NamedTuple

import torch

from paddle_tpu_torch.parallel.mesh import in_loopback, sum_over

__all__ = ["Split", "copy_to", "reduce", "gather", "scatter", "host_bytes",
           "reset_host_bytes", "needs_hop", "shard_parameter",
           "full_parameters", "vocab_parallel_ce"]


class Split(NamedTuple):
    """A cut of ``dim`` into ``n`` parts of each of ``groups`` blocks."""
    dim: int
    groups: int = 1

    def take(self, full: torch.Tensor, n: int, index: int) -> torch.Tensor:
        """Rank ``index``'s part of ``full`` (a contiguous copy)."""
        d = self.dim % full.dim()
        size = full.shape[d]
        if size % (self.groups * n):
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not split "
                             f"into {self.groups} x {n} parts")
        w = size // (self.groups * n)
        blocks = full.unflatten(d, (self.groups, size // self.groups))
        return blocks.narrow(d + 1, index * w, w).flatten(d, d + 1) \
            .contiguous()

    def assemble(self, parts) -> torch.Tensor:
        """The full tensor of the ranks' parts, in rank order."""
        d = self.dim % parts[0].dim()
        blocks = [p.unflatten(d, (self.groups, -1)) for p in parts]
        return torch.cat(blocks, d + 1).flatten(d, d + 1)


# -- the host hop and its byte count -----------------------------------------
_LOCAL = threading.local()


def host_bytes() -> int:
    """Bytes this thread (rank) moved between the card and the host for
    the hop since the last :func:`reset_host_bytes`."""
    return getattr(_LOCAL, "bytes", 0)


def reset_host_bytes():
    _LOCAL.bytes = 0


def _count(t: torch.Tensor, times: int = 1):
    _LOCAL.bytes = host_bytes() + times * t.numel() * t.element_size()


def needs_hop(*ts) -> bool:
    """Whether a function whose backward is a collective hands its output
    over on the host: a CUDA input on a loopback rank, under autograd."""
    return (torch.is_grad_enabled() and in_loopback()
            and any(t.is_cuda for t in ts)
            and any(t.requires_grad for t in ts))


def _out(y: torch.Tensor, hop: bool) -> torch.Tensor:
    if hop:
        _count(y, 2)                     # to the host, and back
        return y.detach().cpu()
    return y


def _back(g: torch.Tensor, device, hop: bool) -> torch.Tensor:
    if hop:
        _count(g, 2)
        return g.to(device)
    return g


def _live(group) -> bool:
    return group is not None and group.size > 1


# -- the four conjugate functions --------------------------------------------
class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, hop):
        ctx.group, ctx.device, ctx.hop = group, x.device, hop
        return _out(x.detach(), hop) if hop else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _back(g, ctx.device, ctx.hop)
        return sum_over(ctx.group, g.contiguous()), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_over(group, x.detach().contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = group.all_gather(x.detach().contiguous())
        return torch.cat(list(parts.unbind(0)), dim)

    @staticmethod
    def backward(ctx, g):
        w = g.shape[ctx.dim] // ctx.group.size
        return g.narrow(ctx.dim, ctx.group.rank * w, w), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, hop):
        ctx.group, ctx.dim, ctx.device, ctx.hop = group, dim, x.device, hop
        w = x.shape[dim] // group.size
        y = x.detach().narrow(dim, group.rank * w, w).contiguous()
        return _out(y, hop)

    @staticmethod
    def backward(ctx, g):
        g = _back(g, ctx.device, ctx.hop).contiguous()
        parts = ctx.group.all_gather(g)
        return torch.cat(list(parts.unbind(0)), ctx.dim), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; its gradient summed over ``group`` in the backward."""
    if not _live(group):
        return x
    hop = needs_hop(x)
    y = _Copy.apply(x, group, hop)
    return y.to(x.device) if hop else y


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over ``group`` in rank order; identity backward."""
    if not _live(group):
        return x
    return _Reduce.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in rank order; the backward
    takes this rank's slice."""
    if not _live(group):
        return x
    return _Gather.apply(x, group, dim % x.dim())


def scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's slice of x along ``dim``; the backward all-gathers."""
    if not _live(group):
        return x
    d = dim % x.dim()
    if x.shape[d] % group.size:
        raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over "
                         f"{group.size} ranks")
    hop = needs_hop(x)
    y = _Scatter.apply(x, group, d, hop)
    return y.to(x.device) if hop else y


# -- parameters --------------------------------------------------------------
def shard_parameter(p: torch.nn.Parameter, split: Split, n: int, index: int):
    """Replace ``p``'s data by rank ``index``'s part (in place, the same
    Parameter object) and mark it ``p.mp_split``."""
    with torch.no_grad():
        p.data = split.take(p.data, n, index)
    p.mp_split = (split, n, index)
    return p


def full_parameters(module: torch.nn.Module, group
                    ) -> Dict[str, torch.Tensor]:
    """{name: the full tensor} of ``module``'s parameters: a split one
    all-gathered over ``group`` (its ``mp`` ranks) and assembled, the
    others as they are (detached).  Every rank of the group calls it."""
    out = {}
    for name, p in module.named_parameters():
        sp = getattr(p, "mp_split", None)
        out[name] = p.detach() if sp is None else sp[0].assemble(
            group.all_gather(p.detach().contiguous()).unbind(0))
    return out


# -- the vocabulary-parallel cross entropy -----------------------------------
def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                      group) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` of (N, V/m) f32
    logits, this rank's vocabulary columns [lo, lo + V/m), without
    gathering the (N, V) logits: the max over the ranks (no gradient), the
    sum of exp summed over the group in rank order, the gold logit from
    the rank that owns it.  A negative label reads 0 gold (the caller
    masks it)."""
    vr = logits.shape[-1]
    if not _live(group):
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
        return logz - gold
    m = logits.detach().amax(-1)
    gm = group.all_gather(m.contiguous()).amax(0)
    se = reduce(torch.exp(logits - gm[:, None]).sum(-1), group)
    t = labels - lo
    own = (t >= 0) & (t < vr)
    gold = logits.gather(-1, t.clamp(0, vr - 1)[:, None])[:, 0]
    gold = reduce(torch.where(own, gold, torch.zeros_like(gold)), group)
    return gm + torch.log(se) - gold
