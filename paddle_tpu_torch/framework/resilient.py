"""Step-granularity NaN rollback (port of
paddle_tpu/framework/resilient.py).

``FLAGS_check_nan_inf`` detects a blow-up and the auto-checkpoint
(``TrainEpochRange``) recovers at epoch boundaries.
:class:`ResilientTrainStep` closes the gap: it keeps a host copy of the
last good training state, checks each step for a non-finite loss (or,
with ``check_state``, non-finite parameters), and on a bad step restores
the copy and skips the batch instead of letting it corrupt the run,
raising only after ``max_consecutive_bad`` bad steps in a row.

It wraps any step with the TrainStep surface (``model``, ``optimizer``,
``_opt_states``, a call returning the loss): ``jit.TrainStep``,
``ShardedTrainStep`` (at ZeRO stage 3 its parameter chunks are gathered
whole for a snapshot or a restore and chunked again), ``PSTrainStep``'s
dense tier.  A snapshot copies the
parameters, buffers, optimizer state and ``_global_step`` to the host:
into pinned buffers allocated at the first snapshot and reused by every
later one (one copy per snapshot, no allocation), finished before the
step returns.  A restore copies them back into the live tensors in
place, so a donating step (the fused Adam writes in place) finds its
storage as before.  A snapshot taken before the step's optimizer state
exists restores to "none yet": the next call initialises it afresh, as
the reference's first step would.

AMP: with a ``GradScaler`` passed as ``scaler``, every bad step feeds its
dynamic scaling (found_inf, then ``update()``).

The ``train.step_grads`` chaos point runs over the step inputs before
the call: ``mode="nan"`` poisons the floating inputs, the real forward
and backward carry the poison into the loss and gradients, and the
rollback runs end to end.

Numerics (``FLAGS_numerics``): when the wrapped step leaves a fresh
``last_numerics`` record, the finite verdict reads it (the loss, every
gradient leaf and, with ``check_state``, every updated parameter, in the
one read the record costs) instead of reading the loss and sweeping the
parameters, and a skipped step's ``train.nan_skip`` flight event names
``first_bad_leaf``.
"""
from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.framework import chaos, incident, monitor
from paddle_tpu_torch.framework.observability import flight

__all__ = ["ResilientTrainStep"]


def _put_back(live: torch.Tensor, host: torch.Tensor):
    with torch.no_grad():
        live.copy_(host, non_blocking=live.is_cuda)


class ResilientTrainStep:
    """Rollback wrapper: snapshot every ``snapshot_every`` good steps,
    restore and skip on a non-finite step, raise ``FloatingPointError``
    after ``max_consecutive_bad`` consecutive bad steps.

    A rollback restores the newest snapshot: with ``snapshot_every=K`` up
    to K - 1 good steps are lost again; K = 1 (the default) makes the
    rollback exact at one host copy of the state a step.

    Returns the step's loss.  On a skipped step it is the non-finite loss
    (a NaN scalar when the wrapped step raised before returning one) and
    ``last_step_skipped`` is True."""

    def __init__(self, step, snapshot_every: int = 1,
                 max_consecutive_bad: int = 3, scaler=None,
                 check_state: bool = False):
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        if max_consecutive_bad < 1:
            raise ValueError("max_consecutive_bad must be >= 1")
        self.step = step
        self.snapshot_every = snapshot_every
        self.max_consecutive_bad = max_consecutive_bad
        self.scaler = scaler
        self.check_state = check_state
        self._snap: Optional[dict] = None
        self._good_since_snap = 0
        self.consecutive_bad = 0
        self.skipped_steps = 0
        self.rollbacks = 0
        self.last_step_skipped = False
        # the first leaf with a non-finite gradient or parameter on the
        # newest skipped step (FLAGS_numerics armed on the wrapped step)
        self.last_bad_leaf: Optional[str] = None
        self.membership_epoch: Optional[int] = None
        self.membership_events = 0
        self._durable = None
        self._durable_every = 0
        self._durable_mode = "async"
        self._durable_ws: Optional[int] = None

    # -- durable tier --------------------------------------------------------
    def attach_durable(self, manager, every: int = 0, mode: str = "async",
                       world_size: Optional[int] = None,
                       arm_preemption: bool = True):
        """Persist generations through ``manager``
        (``distributed.durable.CheckpointManager``): a verified, committed
        generation after every ``every``-th good step (0 leaves the
        cadence to the caller); a rolled-back step never becomes one.
        ``arm_preemption`` registers the SIGTERM emergency save of the
        last good state."""
        self._durable = manager
        self._durable_every = int(every)
        self._durable_mode = mode
        self._durable_ws = world_size
        if arm_preemption:
            manager.arm_emergency_save(
                self.step,
                lambda: int(getattr(self.step.optimizer,
                                    "_global_step", 0)))
        return manager

    def _maybe_save_durable(self):
        if self._durable is None or self._durable_every <= 0:
            return
        gen = int(getattr(self.step.optimizer, "_global_step", 0))
        if gen > 0 and gen % self._durable_every == 0:
            self._durable.save(self.step, gen, world_size=self._durable_ws,
                               mode=self._durable_mode)

    # -- snapshot / restore --------------------------------------------------
    def snapshot(self):
        """Copy the wrapped step's training state (parameters, buffers,
        optimizer slots, global step) to the host; stage 3's parameters
        whole (:func:`incident.whole_params`)."""
        opt = self.step.optimizer
        old = self._snap or {}
        with incident.whole_params(self.step) as surf:
            states = surf._opt_states
            snap = {
                "params": incident.host_copy(
                    dict(surf.model.named_parameters()), old.get("params")),
                "buffers": incident.host_copy(
                    {n: b for n, b in surf.model.named_buffers()
                     if b is not None}, old.get("buffers")),
                "opt_states": None if states is None else incident.host_copy(
                    {n: {k: v for k, v in st.items()
                         if isinstance(v, torch.Tensor)}
                     for n, st in states.items()}, old.get("opt_states")),
                "global_step": int(getattr(opt, "_global_step", 0)),
            }
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self._snap = snap
        self._good_since_snap = 0

    def snapshot_bytes(self) -> int:
        """Bytes one snapshot holds on the host."""
        if self._snap is None:
            return 0
        ts = list(self._snap["params"].values()) + list(
            self._snap["buffers"].values()) + [
            t for st in (self._snap["opt_states"] or {}).values()
            for t in st.values()]
        return sum(t.numel() * t.element_size() for t in ts)

    def restore(self):
        """Put the newest snapshot back into the live model and
        optimizer."""
        if self._snap is None:
            raise RuntimeError("no snapshot to restore")
        model, opt = self.step.model, self.step.optimizer
        snap = self._snap
        # stage 3 gathers its (bad) chunks, takes the good parameters
        # whole and chunks them again on the way out
        with incident.whole_params(self.step):
            for n, p in model.named_parameters():
                _put_back(p, snap["params"][n])
        for n, b in model.named_buffers():
            if b is not None and n in snap["buffers"]:
                _put_back(b, snap["buffers"][n])
        if snap["opt_states"] is None:
            # the state did not exist at the snapshot: the next call
            # initialises it afresh
            self.step._opt_states = None
        else:
            live = self.step._opt_states or {}
            fresh = {}
            for n, st in snap["opt_states"].items():
                cur = dict(live.get(n) or {})
                for k, h in st.items():
                    t = cur.get(k)
                    if isinstance(t, torch.Tensor) and t.shape == h.shape \
                            and t.dtype == h.dtype:
                        _put_back(t, h)
                    else:
                        dev = _model_device(model)
                        cur[k] = h.to(dev, copy=True)
                fresh[n] = cur
            self.step._opt_states = fresh
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if hasattr(opt, "_global_step"):
            opt._global_step = snap["global_step"]
        self._good_since_snap = 0
        monitor.stat_add("train_restores_total")
        flight.record("train.restore", severity="warn",
                      restored_step=snap["global_step"],
                      rollbacks=self.rollbacks)

    def membership_changed(self, epoch: Optional[int] = None):
        """A membership epoch (elastic shrink or grow): snapshot the
        current last good state now, before the re-form changes roles
        and layouts (``distributed.elastic.reform`` calls it)."""
        self.membership_epoch = epoch
        self.membership_events += 1
        self.snapshot()

    # -- detection -----------------------------------------------------------
    def _finite(self, loss, numerics_rec=None) -> bool:
        """The step's finite verdict: from a fresh numerics record when
        the wrapped step left one, else one read of the loss and (with
        ``check_state``) of each floating parameter's finiteness."""
        if numerics_rec is not None:
            return numerics_rec.finite(check_params=self.check_state)
        if not bool(torch.isfinite(torch.as_tensor(loss)).all()):
            return False
        if self.check_state:
            with incident.whole_params(self.step) as surf:
                return all(bool(torch.isfinite(p).all())
                           for _, p in surf.model.named_parameters()
                           if p.is_floating_point())
        return True

    # -- step ----------------------------------------------------------------
    def __call__(self, *inputs):
        if self._snap is None:
            self.snapshot()
        # the postmortem ring: the inputs before the poison, the random
        # state and the pre-step state (host reads; one flag lookup
        # disarmed)
        incident.maybe_note(self, inputs)
        inputs = chaos.fault_point("train.step_grads", payload=inputs)
        self.last_step_skipped = False
        # a record left by the wrapped step during this call (identity
        # compared around it); an earlier step's record is not trusted
        rec_before = getattr(self.step, "last_numerics", None)
        rec = None
        try:
            loss = self.step(*inputs)
            rec = getattr(self.step, "last_numerics", None)
            rec = rec if rec is not rec_before else None
            finite = self._finite(loss, rec)
        except FloatingPointError:
            # FLAGS_check_nan_inf inside the wrapped step: the same
            # recovery; a NaN scalar stands in for the loss it never
            # returned
            rec = getattr(self.step, "last_numerics", None)
            rec = rec if rec is not rec_before else None
            loss = torch.tensor(float("nan"))
            finite = False
        if self.scaler is not None:
            self.scaler._found_inf = not finite
            self.scaler.update()
        if finite:
            self.consecutive_bad = 0
            self._good_since_snap += 1
            if self._good_since_snap >= self.snapshot_every:
                self.snapshot()
            self._maybe_save_durable()
            return loss
        self.consecutive_bad += 1
        self.skipped_steps += 1
        self.rollbacks += 1
        self.last_step_skipped = True
        self.last_bad_leaf = rec.first_bad_leaf() if rec is not None \
            else None
        monitor.stat_add("train_nan_skips_total")
        flight.record("train.nan_skip", severity="warn",
                      consecutive=self.consecutive_bad,
                      skipped_total=self.skipped_steps,
                      first_bad_leaf=self.last_bad_leaf)
        self.restore()
        if self.consecutive_bad >= self.max_consecutive_bad:
            flight.record("train.abort", severity="error",
                          consecutive=self.consecutive_bad)
            raise FloatingPointError(
                f"ResilientTrainStep: {self.consecutive_bad} consecutive "
                "non-finite steps: rollback cannot outrun a systematic "
                "blow-up (check lr / data / loss scale)")
        return loss

    def flush(self):
        if hasattr(self.step, "flush"):
            self.step.flush()


def _model_device(model) -> torch.device:
    for p in model.parameters():
        return p.device
    return torch.device("cpu")
