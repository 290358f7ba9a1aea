"""Model-numerics observability plane (port of
paddle_tpu/framework/numerics.py): on-device tensor stats, NaN
provenance, and gradient-drift signals.

Cheap reductions computed **on the device inside the step** — per-leaf
and global grad norms, param norms, update/param ratios, max-abs, and
non-finite counts — returned by ``TrainStep`` / ``PSTrainStep`` /
``ShardedUpdateTrainStep`` and published into the host planes (monitor
gauges + histograms, health detectors, flight recorder).

* **cheap when off** — arming is ``FLAGS_numerics``; disarmed, the steps
  do no extra work and no extra synchronisation (one flag read);
* **one read when armed** — :func:`compute_aux` issues O(#leaf) fused
  reductions (``torch._foreach_norm``) and packs every vector into one
  float64 buffer on the device; the host reads that buffer once, where
  the record is first read (``publish`` reads it at the step);
* **rank aware** — under ``ShardedUpdateTrainStep`` each leaf is a 1/dp
  chunk: sums of squares and non-finite counts are summed over the dp
  group in rank order and max-abs is the maximum over it, so the
  exported global grad norm is the replicated step's;
* **NaN provenance** — the per-leaf non-finite counts name the first
  offending parameter leaf (sorted leaf-name order);
* **the watcher never crashes the watched** — host-side publishing runs
  behind the ``numerics.observe`` chaos fault point: an injected error
  is swallowed and counted (``numerics_observe_errors_total``).

Exported metrics (monitor), as the reference's:

==============================  ============================================
``grad_norm`` (histogram)        global L2 grad norm per step
``param_norm`` (histogram)       global L2 param norm per step
``update_ratio`` (histogram)     global update-norm / param-norm per step
``numerics_grad_norm`` …         gauges: the latest global values
``numerics_grad_norm[<leaf>]``…  per-leaf gauges at the sampled cadence
                                 (``FLAGS_numerics_sample_every``)
``numerics_nonfinite_steps_total``  steps with any non-finite stat
``numerics_observe_errors_total``   swallowed publish faults
==============================  ============================================

Detector feed: every global value is offered to ``health.observe``
under the signals ``grad_norm`` / ``update_ratio``; a non-finite value
is an anomaly by definition (flagged at once, never folded into the
baseline).  Histograms only ever record finite values.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.framework import chaos, monitor
from paddle_tpu_torch.framework.flags import flag

__all__ = ["AUX_KEYS", "sum_aux_over", "DRIFT_SIGNALS", "enabled", "sample_every",
           "compute_aux", "NumericsRecord", "publish", "watch_defaults",
           "reset"]

#: the aux every armed step returns — per-leaf f32/int32 vectors of
#: length L (#parameter leaves) plus one scalar for the loss
AUX_KEYS = ("grad_sq", "param_sq", "update_sq", "grad_maxabs",
            "grad_nonfinite", "param_nonfinite", "loss_nonfinite")

#: the drift signals this plane feeds — the per-signal detector kwargs
#: live in ``health.DEFAULT_SIGNALS`` (one source of truth; the grad
#: norm entries there document the floor rationale), so
#: ``FLAGS_health_detectors=default`` arms them too
DRIFT_SIGNALS = ("grad_norm", "update_ratio")


def enabled() -> bool:
    """True when the on-device stats are armed (``FLAGS_numerics``)."""
    return bool(flag("numerics"))


def sample_every() -> int:
    """Per-leaf export cadence (``FLAGS_numerics_sample_every``): the
    per-leaf gauges refresh every Nth published step; 0 disables the
    per-leaf export (global gauges/histograms still publish every
    step)."""
    return int(flag("numerics_sample_every"))


# ---------------------------------------------------------------------------
# on-device computation (inside the step)
# ---------------------------------------------------------------------------

def _f32(ts):
    return [t.detach().float() for t in ts]


def _sq(norms) -> torch.Tensor:
    return torch.stack(norms) ** 2


def compute_aux(grads: dict, params: dict, new_params: dict, loss,
                group=None) -> dict:
    """The numerics aux of one step, on the device.

    ``grads`` / ``params`` / ``new_params`` are same-keyed dicts of
    (possibly rank-local) tensors, ``params`` the values before the
    update; ``loss`` the step's scalar loss.  Leaf order is SORTED key
    order (the reference's; the step builds its :class:`NumericsRecord`
    with the same names).  Returns {key: view} over ONE packed float64
    device buffer (``AUX_KEYS`` in order, each vector L long, then the
    loss's count): f32 sums of squares and maxima, exact counts.

    ``group`` (the dp group of the ZeRO step): sums of squares and
    non-finite counts are summed over it in rank order (padding chunks
    add exact zeros), max-abs is the maximum over it; every rank leaves
    with the identical global vectors.  The loss must already be the
    ranks' mean."""
    names = sorted(grads)
    loss = torch.as_tensor(loss).detach().float()
    lnf = (~torch.isfinite(loss)).sum()
    if not names:
        empty = loss.new_zeros(0, dtype=torch.float64)
        return dict(zip(AUX_KEYS, [empty] * 6 + [lnf.double()]))
    L = len(names)
    g = _f32(grads[n] for n in names)
    p = _f32(params[n] for n in names)
    q = _f32(new_params[n] for n in names)
    gsq = _sq(torch._foreach_norm(g))
    psq = _sq(torch._foreach_norm(p))
    usq = _sq(torch._foreach_norm(torch._foreach_sub(q, p)))
    gmax = torch.stack([torch.linalg.vector_norm(t, float("inf"))
                        if t.numel() else t.new_zeros(()) for t in g])
    gnf = torch.stack([(~torch.isfinite(t)).sum() for t in g])
    pnf = torch.stack([(~torch.isfinite(t)).sum() for t in q])
    if group is not None and group.size > 1:
        from paddle_tpu_torch.parallel.mesh import sum_over
        summed = sum_over(group, torch.cat(
            [t.double() for t in (gsq, psq, usq, gnf, pnf)]))
        gsq, psq, usq = (summed[i * L:(i + 1) * L].float()
                         for i in range(3))
        gnf, pnf = summed[3 * L:4 * L], summed[4 * L:]
        gmax = group.all_gather(gmax).amax(0)
    packed = torch.cat([gsq.double(), psq.double(), usq.double(),
                        gmax.double(), gnf.double(), pnf.double(),
                        lnf.double().reshape(1)])
    views = [packed[i * L:(i + 1) * L] for i in range(6)]
    views.append(packed[6 * L])
    return dict(zip(AUX_KEYS, views))


def sum_aux_over(aux: dict, axes) -> dict:
    """The global aux of a step whose leaves are spread over mesh axes
    (``ShardedTrainStep`` at mp, pp or a ZeRO stage), from each rank's
    :func:`compute_aux` of its local pieces.

    ``axes`` is a sequence of ``(group, split)``: ``split[i]`` says leaf
    i (sorted order) is split over the group's axis, so its partial sums
    of squares and non-finite counts add over the group; a leaf that is
    whole on every rank of the axis counts once (the axis rank 0's).
    Sums run in rank order (``mesh.sum_over``) in float64, axis after
    axis; max-abs is the maximum over each group.  Every rank leaves with
    the identical vectors, packed in one buffer as :func:`compute_aux`
    packs them (one read for the record)."""
    from paddle_tpu_torch.parallel.mesh import sum_over
    L = aux["grad_sq"].numel()
    gsq, psq, usq, gmax, gnf, pnf = (aux[k].double() for k in AUX_KEYS[:6])
    for group, split in axes:
        if group is None or group.size == 1:
            continue
        m = torch.tensor([1.0 if s or group.rank == 0 else 0.0
                          for s in split], dtype=torch.float64,
                         device=gsq.device)
        summed = sum_over(group, torch.cat(
            [t * m for t in (gsq, psq, usq, gnf, pnf)]))
        gsq, psq, usq, gnf, pnf = (summed[i * L:(i + 1) * L]
                                   for i in range(5))
        gmax = group.all_gather(gmax).amax(0)
    packed = torch.cat([gsq, psq, usq, gmax, gnf, pnf,
                        aux[AUX_KEYS[6]].double().reshape(1)])
    views = [packed[i * L:(i + 1) * L] for i in range(6)]
    views.append(packed[6 * L])
    return dict(zip(AUX_KEYS, views))


# ---------------------------------------------------------------------------
# host-side record
# ---------------------------------------------------------------------------

class NumericsRecord:
    """One step's numerics aux, host side.

    Holds the device views and converts them to numpy LAZILY on first
    read: one copy of the packed buffer (:func:`compute_aux`) for all
    keys, the one synchronisation an armed step adds.
    Global norms derive from the per-leaf sum-of-squares; update_ratio
    is update-norm / param-norm (0 when the param norm is 0).

    ``names`` is canonicalized to sorted order — the order
    :func:`compute_aux` stacked the per-leaf vectors in.
    """

    __slots__ = ("names", "step", "_aux", "_np")

    def __init__(self, names: List[str], aux: dict,
                 step: Optional[int] = None):
        self.names = sorted(names)
        self.step = step
        self._aux = aux
        self._np: Optional[Dict[str, np.ndarray]] = None

    def _fetch(self) -> Dict[str, np.ndarray]:
        if self._np is None:
            vals = list(self._aux.values())
            base = vals[0]._base if vals else None
            if base is not None and all(v._base is base for v in vals):
                host = base.cpu().numpy()             # the one read
                L = len(self.names)
                got = [host[i * L:(i + 1) * L] for i in range(6)]
                got.append(host[6 * L])
            else:
                got = [v.detach().cpu().numpy() for v in vals]
            self._np = {}
            for k, v in zip(self._aux, got):
                kind = np.int32 if k.endswith("nonfinite") else np.float32
                self._np[k] = np.asarray(v).astype(kind)
            self._aux = None          # drop the device refs once read
        return self._np

    # -- global scalars ------------------------------------------------------
    @staticmethod
    def _norm(sq) -> float:
        """sqrt of a sum-of-squares, NaN/Inf-PROPAGATING: ``max(0.0,
        nan)`` is 0.0 in Python, so a naive clamp would silently report
        a blown-up step as a zero norm — exactly the value that would
        poison a drift detector's baseline while hiding the blow-up."""
        s = float(sq)
        if math.isnan(s):
            return s
        return math.sqrt(max(0.0, s))

    @property
    def grad_norm(self) -> float:
        return self._norm(self._fetch()["grad_sq"].sum())

    @property
    def param_norm(self) -> float:
        return self._norm(self._fetch()["param_sq"].sum())

    @property
    def update_norm(self) -> float:
        return self._norm(self._fetch()["update_sq"].sum())

    @property
    def update_ratio(self) -> float:
        p = self.param_norm
        if math.isnan(p):
            return p
        return self.update_norm / p if p > 0.0 else 0.0

    @property
    def max_abs_grad(self) -> float:
        a = self._fetch()["grad_maxabs"]
        return float(a.max()) if a.size else 0.0

    @property
    def nonfinite_grads(self) -> int:
        return int(self._fetch()["grad_nonfinite"].sum())

    @property
    def nonfinite_params(self) -> int:
        return int(self._fetch()["param_nonfinite"].sum())

    @property
    def nonfinite_loss(self) -> int:
        return int(self._fetch()["loss_nonfinite"])

    # -- provenance ----------------------------------------------------------
    def finite(self, check_params: bool = True) -> bool:
        """The on-device finite verdict: loss and every grad leaf finite
        (and every post-update param leaf when ``check_params``)."""
        if self.nonfinite_loss or self.nonfinite_grads:
            return False
        if check_params and self.nonfinite_params:
            return False
        return True

    def first_bad_leaf(self) -> Optional[str]:
        """The first parameter leaf (sorted leaf-name order) with a
        non-finite gradient — falling back to the first leaf with a
        non-finite post-update param, then None (loss-only blow-up)."""
        a = self._fetch()
        for key in ("grad_nonfinite", "param_nonfinite"):
            bad = np.nonzero(a[key])[0]
            if bad.size:
                return self.names[int(bad[0])]
        return None

    def bad_leaves(self) -> List[str]:
        """Every leaf with a non-finite grad or post-update param."""
        a = self._fetch()
        mask = (a["grad_nonfinite"] > 0) | (a["param_nonfinite"] > 0)
        return [n for n, m in zip(self.names, mask) if m]

    # -- per-leaf view -------------------------------------------------------
    def per_leaf(self) -> Dict[str, dict]:
        a = self._fetch()
        out = {}
        for i, n in enumerate(self.names):
            pn = self._norm(a["param_sq"][i])
            un = self._norm(a["update_sq"][i])
            # NaN-propagating like the global property: `nan > 0.0` is
            # False, and 0.0 would read as a healthy leaf
            ratio = pn if math.isnan(pn) else (
                un / pn if pn > 0.0 else 0.0)
            out[n] = {
                "grad_norm": self._norm(a["grad_sq"][i]),
                "param_norm": pn,
                "update_ratio": ratio,
                "max_abs_grad": float(a["grad_maxabs"][i]),
                "nonfinite": int(a["grad_nonfinite"][i]
                                 + a["param_nonfinite"][i]),
            }
        return out

    def to_dict(self) -> dict:
        return {"step": self.step, "grad_norm": self.grad_norm,
                "param_norm": self.param_norm,
                "update_ratio": self.update_ratio,
                "max_abs_grad": self.max_abs_grad,
                "nonfinite": {"loss": self.nonfinite_loss,
                              "grads": self.nonfinite_grads,
                              "params": self.nonfinite_params},
                "first_bad_leaf": self.first_bad_leaf()}

    def __repr__(self):
        return (f"NumericsRecord(step={self.step} "
                f"grad_norm={self.grad_norm:.4g} "
                f"update_ratio={self.update_ratio:.4g} "
                f"nonfinite={self.nonfinite_grads + self.nonfinite_params + self.nonfinite_loss})")


# ---------------------------------------------------------------------------
# publishing (gauges, histograms, detectors, per-leaf sampling)
# ---------------------------------------------------------------------------

_publish_calls = 0
_publish_lock = threading.Lock()


def publish(record: NumericsRecord) -> Optional[NumericsRecord]:
    """Fold one step's record into the monitor/health planes.

    Global gauges + histograms every call; per-leaf gauges at the
    ``FLAGS_numerics_sample_every`` cadence.  Global values feed the
    ``grad_norm`` / ``update_ratio`` health detectors — a non-finite
    value flags immediately (Detector z=inf rule) while staying out of
    the baselines and histograms, and is counted
    (``numerics_nonfinite_steps_total``).  The ``numerics.observe``
    chaos fault point fires at the
    head: an injected error is swallowed and counted — the watcher must
    never crash the watched train step.  Returns the record (None when
    a fault swallowed the publish).
    """
    from paddle_tpu_torch.framework import health
    try:
        chaos.fault_point("numerics.observe",
                          meta={"step": record.step})
    except chaos.InjectedFault:
        # the watcher must never crash the watched: swallow, count
        monitor.stat_add("numerics_observe_errors_total")
        return None
    g, p, r, mx = (record.grad_norm, record.param_norm,
                   record.update_ratio, record.max_abs_grad)
    monitor.stat_set("numerics_grad_norm", g)
    monitor.stat_set("numerics_param_norm", p)
    monitor.stat_set("numerics_update_ratio", r)
    monitor.stat_set("numerics_max_abs_grad", mx)
    nonfinite = (record.nonfinite_loss or record.nonfinite_grads
                 or record.nonfinite_params)
    if nonfinite:
        monitor.stat_add("numerics_nonfinite_steps_total")
    for name, v in (("grad_norm", g), ("param_norm", p),
                    ("update_ratio", r)):
        if np.isfinite(v):
            monitor.observe(name, v)
        if name != "param_norm":
            # drift detectors see every value: a non-finite one flags
            # immediately (Detector's z=inf rule) without ever entering
            # the baseline — the detector fires AT the blown-up step,
            # provenance then names the leaf
            health.observe(name, v)
    global _publish_calls
    every = sample_every()
    due = False
    if every > 0:
        with _publish_lock:
            _publish_calls += 1
            due = _publish_calls % every == 0
        due = due or bool(nonfinite)
    # per-leaf attribution: sampled on the healthy path (L gauges per
    # refresh is the whole cost), always on a non-finite step — the
    # post-mortem wants the leaf split exactly then.  every=0 is a HARD
    # off (the operator's metric-cardinality cap; NaN provenance still
    # reaches the flight event via first_bad_leaf, not these gauges)
    if due:
        for leaf, d in record.per_leaf().items():
            monitor.stat_set(f"numerics_grad_norm[{leaf}]",
                             d["grad_norm"])
            monitor.stat_set(f"numerics_update_ratio[{leaf}]",
                             d["update_ratio"])
            monitor.stat_set(f"numerics_max_abs_grad[{leaf}]",
                             d["max_abs_grad"])
            if d["nonfinite"]:
                monitor.stat_add(f"numerics_nonfinite[{leaf}]",
                                 d["nonfinite"])
    return record


def watch_defaults(**overrides):
    """Arm the plane's default drift detectors (:data:`DRIFT_SIGNALS`)
    on the process health monitor — idempotent, like every
    ``health.watch``.  ``overrides`` update the per-signal kwargs
    (e.g. ``warmup=8`` for short test runs)."""
    from paddle_tpu_torch.framework import health
    dets = {}
    for signal in DRIFT_SIGNALS:
        kw = dict(health.DEFAULT_SIGNALS.get(signal, {}))
        kw.update(overrides)
        dets[signal] = health.watch(signal, **kw)
    return dets


def reset():
    """Per-test clean slate for the publish cadence counter (gauges and
    detectors are owned by monitor/health reset as usual)."""
    global _publish_calls
    with _publish_lock:
        _publish_calls = 0
