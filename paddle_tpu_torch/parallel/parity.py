"""Runtime replica-parity probe (port of paddle_tpu/parallel/parity.py).

A data-parallel step keeps its parameters (and, unsharded, its optimizer
state) replicated over the ``dp`` axis: every replica must hold the same
bits after every step.  A reduction that drifts (a compressed all-reduce,
a collective that skipped a rank) leaves replicas that silently differ.
With ``FLAGS_replica_parity`` armed the step classes hash every
replicated parameter and optimizer-state leaf on the device every
``FLAGS_replica_parity_every`` steps and compare the hashes over the
axis:

* the hash is the reference's: a position-weighted sum of the leaf's raw
  bits taken as 32-bit words (weight ``2 i + 1``), wrapped mod 2^32;
  8-byte leaves are two words an element.  :func:`leaf_hash_device`
  computes it on the leaf's own device with int64 arithmetic that never
  overflows (each word split into 16-bit halves), and equals
  :func:`leaf_hash_host` of the same bits, bitwise;
* each replica all-gathers its hash vector over the axis (one int64 a
  leaf); the host verdict compares the gathered matrix exactly and
  checks the reference's ``sum == dp * h`` agreement mod 2^32;
* a divergent leaf fires one ``parity.divergence`` flight event naming
  the first divergent leaf in sorted order and counts
  ``parity_divergence_total``; the probe never raises (the
  ``parity.observe`` chaos point and ``parity_observe_errors_total``).

Where the reference compares the buffers of one ``shard_map`` in one
process, the port's replicas are ranks: ``LoopbackWorld`` threads or
processes over ``torch.distributed``.  The gather runs before the chaos
point, so a fault on one rank never leaves its peers waiting in the
collective; on ``LoopbackWorld`` ranks only the lead thread counts and
records.  Leaves sharded over the axis are skipped: the optimizer state
of a ZeRO step (``ShardedUpdateTrainStep``, ``ShardedTrainStep`` at
stage >= 1), whose chunks differ by design.

Disarmed, the hook is one flag lookup a step: nothing is hashed, read or
synchronised.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.framework import chaos, monitor
from paddle_tpu_torch.framework.flags import flag

__all__ = ["enabled", "probe_every", "ParityRecord", "ParityProbe",
           "maybe_observe", "reset", "leaf_hash_host", "leaf_hash_device"]

_MASK32 = 0xFFFFFFFF
# elements hashed at once on the device: bounds the int64 temporaries
_CHUNK = 1 << 24


def enabled() -> bool:
    """True when the probe is armed (``FLAGS_replica_parity``)."""
    return bool(flag("replica_parity"))


def probe_every() -> int:
    """Probe cadence in steps (``FLAGS_replica_parity_every``; min 1)."""
    return max(1, int(flag("replica_parity_every")))


# ---------------------------------------------------------------------------
# the hash
# ---------------------------------------------------------------------------

def _words(t: torch.Tensor) -> torch.Tensor:
    """The leaf's raw bits as a flat int64 tensor of 32-bit words (each in
    [0, 2^32)), in the order numpy's ``view(uint32)`` gives them."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    size = flat.element_size()
    if size == 1:
        return flat.view(torch.uint8).to(torch.int64)
    if size == 2:
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 4:
        return flat.view(torch.int32).to(torch.int64) & _MASK32
    # 8-byte: two words an element, low word first (little endian)
    return flat.view(torch.int32).to(torch.int64) & _MASK32


def leaf_hash_device(t: torch.Tensor) -> torch.Tensor:
    """The leaf's content hash as a 0-d int64 tensor on its device:
    ``sum_i bits_i * (2 i + 1) mod 2^32`` over its 32-bit words, bitwise
    :func:`leaf_hash_host` of the same bits.  Every product is formed from
    16-bit halves of the word (``lo * w`` and ``hi * w`` stay below
    2^48), so no int64 operation overflows; the per-word terms (below
    2^32) are summed in int64 a chunk at a time."""
    words = _words(t)
    n = words.numel()
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    for start in range(0, n, _CHUNK):
        bits = words[start:start + _CHUNK]
        w = (torch.arange(start, start + bits.numel(), dtype=torch.int64,
                          device=bits.device) * 2 + 1) & _MASK32
        lo, hi = bits & 0xFFFF, bits >> 16
        term = ((lo * w) + (((hi * w) & 0xFFFF) << 16)) & _MASK32
        total = (total + term.sum()) & _MASK32
    return total


def leaf_hash_host(x) -> int:
    """The same hash of a HOST array with numpy (the reference's,
    unchanged): the postmortem plane (framework/incident.py,
    tools/replay.py) hashes recorded and re-executed state with it, so a
    replay names the leaf either probe would."""
    if isinstance(x, torch.Tensor):
        x = _host_numpy(x)
    flat = np.ascontiguousarray(np.asarray(x)).reshape(-1)
    if flat.dtype == np.bool_:
        flat = flat.astype(np.uint8)
    size = flat.dtype.itemsize
    if size == 1:
        bits = flat.astype(np.uint32)
    elif size == 2:
        bits = flat.view(np.uint16).astype(np.uint32)
    elif size == 4:
        bits = flat.view(np.uint32)
    else:                            # 8-byte: two uint32 words per element
        bits = flat.view(np.uint32)
    if bits.shape[0] == 0:
        return 0
    w = np.arange(bits.shape[0], dtype=np.uint32) * np.uint32(2) \
        + np.uint32(1)
    with np.errstate(over="ignore"):
        return int((bits * w).sum(dtype=np.uint32))


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a numpy array (bf16 as its uint16 words, which
    numpy cannot hold as floats)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# ---------------------------------------------------------------------------
# host-side record
# ---------------------------------------------------------------------------

class ParityRecord:
    """One probe's verdict: per-leaf hashes per replica + agreement."""

    __slots__ = ("names", "hashes", "agree", "step")

    def __init__(self, names: List[str], hashes: np.ndarray,
                 agree: np.ndarray, step: Optional[int] = None):
        self.names = list(names)
        self.hashes = np.asarray(hashes)      # (replicas, leaves) uint32
        self.agree = np.asarray(agree)        # (replicas, leaves) bool
        self.step = step

    def divergent_leaves(self) -> List[str]:
        """Leaves whose hash differs across replicas (an exact compare of
        the gathered matrix)."""
        if self.hashes.size == 0:
            return []
        differs = (self.hashes != self.hashes[0:1]).any(axis=0)
        differs |= ~self.agree.all(axis=0)
        return [n for n, d in zip(self.names, differs) if d]

    def first_divergent_leaf(self) -> Optional[str]:
        bad = self.divergent_leaves()
        return bad[0] if bad else None

    def ok(self) -> bool:
        return not self.divergent_leaves()

    def to_dict(self) -> dict:
        return {"step": self.step, "leaves": len(self.names),
                "divergent": self.divergent_leaves()}


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

class ParityProbe:
    """Replica-agreement check over one mesh axis.  One instance a step
    object (each rank's step has its own): the every-K gate counts that
    step's calls, so the ranks of a world probe at the same steps."""

    def __init__(self, mesh=None, axis: str = "dp",
                 every: Optional[int] = None):
        from paddle_tpu_torch.parallel.mesh import get_mesh
        self.mesh = mesh or get_mesh()
        self.axis = axis
        self.every = every
        self._calls = 0
        self._lock = threading.Lock()

    def _group(self):
        if self.mesh.shape.get(self.axis, 1) <= 1:
            return None
        return self.mesh.axis_group(self.axis)

    def hashes(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """This replica's (leaves,) int64 hash vector on the device, in
        sorted leaf order."""
        names = sorted(tree)
        if not names:
            return torch.zeros(0, dtype=torch.int64)
        return torch.stack([leaf_hash_device(tree[n]) for n in names])

    def gather(self, tree: Dict[str, torch.Tensor]):
        """(sorted names, the (replicas, leaves) int64 hash matrix on the
        host), or None when the axis has one replica or nothing to
        probe.  A collective: every replica of the axis calls it."""
        group = self._group()
        if group is None or not tree:
            return None
        names = sorted(tree)
        mat = group.all_gather(self.hashes(tree))
        return names, mat.cpu().numpy()

    @staticmethod
    def verdict(names, mat: np.ndarray, k: int,
                step: Optional[int] = None) -> ParityRecord:
        """The record of a gathered hash matrix: the exact compare, and
        the reference's ``sum == k * h`` agreement mod 2^32."""
        sums = mat.sum(axis=0) & _MASK32
        agree = sums[None, :] == (mat * k) & _MASK32
        return ParityRecord(names, mat.astype(np.uint32), agree, step=step)

    def check(self, tree: Dict[str, torch.Tensor],
              step: Optional[int] = None) -> Optional[ParityRecord]:
        """Hash-compare every leaf across the replicas.  None when the
        axis has one replica or ``tree`` is empty."""
        got = self.gather(tree)
        if got is None:
            return None
        return self.verdict(got[0], got[1],
                            self.mesh.shape.get(self.axis, 1), step=step)

    def observe(self, tree: Dict[str, torch.Tensor],
                step: Optional[int] = None) -> Optional[ParityRecord]:
        """The armed per-step entry: the every-K gate, the gather, the
        chaos point and the flight event on divergence.  Never raises: a
        fault is swallowed and counted."""
        if not enabled():
            return None
        with self._lock:
            self._calls += 1
            due = (self._calls % (self.every or probe_every())) == 0
        if not due:
            return None
        from paddle_tpu_torch.framework.observability import flight
        from paddle_tpu_torch.parallel.mesh import lead_thread
        lead = lead_thread()
        try:
            got = self.gather(tree)
            chaos.fault_point("parity.observe", meta={"step": step})
        except Exception:                # noqa: BLE001 - swallow and count
            monitor.stat_add("parity_observe_errors_total")
            return None
        if got is None:
            return None
        rec = self.verdict(got[0], got[1],
                           self.mesh.shape.get(self.axis, 1), step=step)
        if lead:
            monitor.stat_add("parity_checks_total")
        bad = rec.divergent_leaves()
        if bad and lead:
            monitor.stat_add("parity_divergence_total")
            flight.record("parity.divergence", severity="error",
                          first_bad_leaf=bad[0], leaves=bad, step=step)
        return rec


# ---------------------------------------------------------------------------
# train-step hook
# ---------------------------------------------------------------------------

def _opt_leaves(states) -> Dict[str, torch.Tensor]:
    """Optimizer leaves by the reference's name, ``"opt" +
    jax.tree_util.keystr(path)`` of the nested state dict:
    ``opt['<param>']['<slot>']``."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + f"[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + f"[{i}]")
        elif hasattr(node, "shape"):
            out["opt" + path] = node
    walk(states, "")
    return out


def _state_tree(step, replicated_only: bool = False) -> Dict[str, object]:
    """Parameter and optimizer-state leaves of a TrainStep-surface object
    as one flat name -> tensor dict (parameters by name, optimizer leaves
    as :func:`_opt_leaves` names them).  ``replicated_only`` leaves out
    optimizer state sharded over the data axis (a ZeRO step's chunks)."""
    tree = {}
    model = getattr(step, "model", None)
    if model is not None:
        for n, p in model.named_parameters():
            tree[n] = p.detach()
    sharded = ("_opt_shards" in vars(step)
               or getattr(step, "sharding_stage", 0) >= 1)
    states = getattr(step, "_opt_states", None)
    if states is not None and not (replicated_only and sharded):
        tree.update(_opt_leaves(states))
    return tree


def _has_world() -> bool:
    """Whether a mesh can be had: a process group, or LoopbackWorld
    ranks."""
    import torch.distributed as dist
    from paddle_tpu_torch.parallel.mesh import in_loopback
    return in_loopback() or (dist.is_available() and dist.is_initialized())


def maybe_observe(step, mesh=None, axis: str = "dp"):
    """The hook the train-step classes call after committing a step: one
    flag lookup unless ``FLAGS_replica_parity`` is armed; armed, attaches
    a :class:`ParityProbe` to ``step`` at first use and observes."""
    if not enabled():
        return None
    probe = getattr(step, "_parity_probe", None)
    if probe is None:
        if mesh is None and not _has_world():
            # one process, no process group: one replica, nothing to probe
            return None
        probe = ParityProbe(mesh=mesh, axis=axis)
        step._parity_probe = probe
    opt = getattr(step, "optimizer", None)
    at = int(getattr(opt, "_global_step", 0)) if opt is not None else None
    return probe.observe(_state_tree(step, replicated_only=True), step=at)


def reset():
    """Nothing module-global to clear (probes live on their steps); kept
    for symmetry with the other observability planes."""
