"""TrainStep: forward, backward and optimizer update in one call (port of
paddle_tpu/jit/__init__.py ``functional_loss_call`` :270,
``apply_functional_update`` :300 and ``TrainStep`` :309).

The reference traces the step into one XLA computation; PyTorch runs it
eagerly, in the same order: the loss under autograd (with the AMP cast),
the gradients of every parameter (summed over micro-batches with
``accumulate_steps``), the gradient clip, then the optimizer's functional
update under ``torch.no_grad()``, written back into the module's
parameters.

AMP: with ``amp_level`` "O1" or "O2" each floating parameter with
``ndim >= 1`` is cast to the AMP dtype for the forward
(``torch.func.functional_call`` over the cast copies), while the module's
f32 parameters stay the masters that receive the gradient and the update,
as in the reference's ``functional_loss_call``.  The reference's
TrainStep treats O1 as O2 (``amp = self.amp_level in ("O1", "O2")``,
:363), and so does the port.

Buffers (BatchNorm's running statistics) are the module's own tensors:
``functional_call`` is handed the cast parameters only, so a training
forward updates the buffers in place, off autograd's tape, where the
reference threads them through the step as functional outputs
(``functional_loss_call`` :270-297).  They are never cast by AMP and take
no gradient; with ``accumulate_steps = k`` micro-batch j normalises by its
own statistics and leaves the running stats for micro-batch j + 1, as the
reference's scan carries them (:385-396).

``donate`` (the default) lets the optimizer write the new parameters and
moments into their own storage where it can (the fused Adam): one copy of
them stays live, as the reference's donation keeps one.

``recompute=True`` makes the whole ``functional_loss_call`` one recompute
region (``jit/recompute.py``; the reference's ``jax.checkpoint`` over
``loss_from``, :371-376): the backward replays the forward, the O2 cast
included, and the gradients are bitwise those without it.

``FLAGS_check_nan_inf`` (reference ``_commit_step`` :437-460): armed, a
non-finite loss raises ``FloatingPointError`` after one read of the losses
from the device.  With ``donate=False`` the raise comes before any
parameter, moment or buffer is written: the new parameters and moments go
from step to step as new tensors and are written only after the check,
and the buffers, which a training forward updates in place, are copied
first and put back.  With ``donate=True`` the raise comes after the
write-back, as the reference's donated buffers force.  Disarmed, the step
reads nothing back.

The host planes (``framework/{monitor,health,observability}.py``,
``profiler``) see each call as the reference's (``:548-636``): a
``train.step`` span, a ``TrainStep`` / ``TrainStep.multi_step`` profiler
range, the first call under a new signature (the reference's cache key)
timed as a compile, ``train_step_ms``, ``train_steps_total``, the health
detector and the memory sample; no device synchronisation is added.
After the commit the replica-parity probe runs (``FLAGS_replica_parity``,
``parallel/parity.py``; a one-replica step probes nothing), and the
construction applies ``FLAGS_autotune_profile`` once a process
(``framework/autopilot.py``).  ``ResilientTrainStep``
(``framework/resilient.py``) is exported here, as in the reference.

Not ported, and raising ``NotImplementedError``: a gradient clip without
``functional_clip``, which the reference's step silently skips.

``to_static`` (reference ``:44-267``) captures a function or a layer's
forward with ``torch.export`` (non-strict) once per input signature and
runs the exported graph; ``save`` / ``load`` / ``TranslatedLayer``
(reference ``:712-887``) write and read the deployment artifact.  Both
live in ``jit/static.py``; ``analyze`` and ``compiled_text`` are not
ported and raise.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Optional

import torch
from torch import nn

from paddle_tpu_torch.framework import health, monitor, numerics
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.framework.observability import tracer
from paddle_tpu_torch.framework.selected_rows import dense_gradients
from paddle_tpu_torch.jit import recompute as _recompute
from paddle_tpu_torch.jit.recompute import substituted_call
from paddle_tpu_torch.profiler import RecordEvent

__all__ = ["TrainStep", "ResilientTrainStep", "functional_loss_call", "apply_functional_update",
           "loss_closure", "loss_and_grads", "to_static", "not_to_static",
           "StaticFunction", "save", "load", "TranslatedLayer"]


def functional_loss_call(model, loss_fn, params: dict, inputs,
                         amp: bool = False, amp_dtype=torch.bfloat16,
                         lead_tensors=()):
    """``loss_fn(model, *lead_tensors, *inputs)`` as an f32 scalar on
    autograd's tape.  ``lead_tensors`` go in as they are (the parameter
    server's pulled rows, ``distributed.ps``), never cast.
    With ``amp``, floating parameters of ``ndim >= 1`` and floating inputs
    are cast to ``amp_dtype`` for the call; ``params`` ({name: parameter})
    stay the leaves that receive the gradient.  Without it, ``params``
    that are not the module's own parameters (new parameters carried from
    step to step, ``TrainStep`` under ``check_nan_inf``) stand in for
    them.  The module's buffers are used, and updated by a training
    forward, as they are: never cast.  Every gradient is dense,
    ``embedding(sparse=True)``'s included, as under the reference's
    trace."""
    inputs = list(inputs)
    if not amp:
        inputs = [*lead_tensors, *inputs]
    with dense_gradients():
        if not amp and all(isinstance(p, nn.Parameter)
                           for p in params.values()):
            loss = loss_fn(model, *inputs)
        elif not amp:
            loss = substituted_call(
                model, loss_fn, {f"model.{n}": p for n, p in params.items()},
                inputs)
        else:
            cast = {f"model.{n}": (p.to(amp_dtype)
                                   if p.is_floating_point() and p.dim() >= 1
                                   else p)
                    for n, p in params.items()}
            inputs = [*lead_tensors] + [
                i.to(amp_dtype) if i.is_floating_point() else i
                for i in inputs]
            loss = substituted_call(model, loss_fn, cast, inputs)
    return loss.float()


def loss_closure(model, loss_fn: Callable, amp_level=None,
                 amp_dtype=torch.bfloat16, recompute: bool = False):
    """(params {name: parameter}, inputs) -> f32 loss on autograd's tape:
    ``functional_loss_call`` with the AMP cast for O1 and O2 alike (the
    reference's ``TrainStep`` and ``dp_meta._loss_closure`` :80-81 treat
    them so), and with ``recompute`` the whole call as one recompute
    region."""
    amp = amp_level in ("O1", "O2")

    def loss_from(params, inputs):
        return functional_loss_call(model, loss_fn, params, inputs, amp=amp,
                                    amp_dtype=amp_dtype)
    if recompute:
        return functools.partial(_recompute.recompute, loss_from)
    return loss_from


def loss_and_grads(loss_from, params: dict, inputs):
    """(detached f32 loss, {name: gradient}) of one batch; an unused
    parameter gets a zero gradient, as jax.grad gives it.  Every gradient
    is dense, a recompute region's replay included."""
    with torch.enable_grad(), dense_gradients():
        loss = loss_from(params, inputs)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(params.items(), grads)}


def apply_functional_update(opt, grads: dict, params: dict, opt_states, lr,
                            donate: bool = False):
    """Clip with the optimizer's ``grad_clip``, then its functional update
    (reference ``:300``).  A clip without ``functional_clip`` raises where
    the reference skips it."""
    grad_clip = getattr(opt, "_grad_clip", None)
    if grad_clip is not None:
        if not hasattr(grad_clip, "functional_clip"):
            raise NotImplementedError(
                f"grad_clip {type(grad_clip).__name__} has no "
                "functional_clip: the reference's TrainStep skips it "
                "silently, the port does not train without it")
        grads = grad_clip.functional_clip(grads)
    return opt.functional_update(params, grads, opt_states, lr=lr,
                                 donate=donate)


def _sig_of(tensors, tag: str) -> tuple:
    """The reference's signature leaves (``jit/__init__.py:44``): (tag,
    shape, dtype name), ``"T"`` for a parameter, ``"A"`` for an input."""
    return tuple((tag, tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in tensors)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _record_step(step, losses, steps: Optional[int], t_start: float):
    """The statistics of one ``TrainStep`` call, after its commit
    (reference ``:570``, ``:626-636``): a multi_step adds its K steps to
    ``train_steps_total``; a step records its host wall time into
    ``train_step_ms`` and the health detector, and the memory sample
    attributes the parameters', optimizer state's and buffers' bytes.
    Reads nothing from the device: ``losses`` stays where it is."""
    if steps is not None:
        monitor.stat_add("train_steps_total", steps)
        return
    step_ms = (time.perf_counter() - t_start) * 1e3
    monitor.observe("train_step_ms", step_ms)
    monitor.stat_add("train_steps_total")
    health.observe("train_step_ms", step_ms)
    model = step.model
    health.maybe_sample_memory(lambda: {
        "params": _nbytes(model.parameters()),
        "opt_state": _nbytes(t for st in (step._opt_states or {}).values()
                             for t in st.values()
                             if isinstance(t, torch.Tensor)),
        "buffers": _nbytes(model.buffers())})


class TrainStep:
    """One training step per call: forward, backward, optimizer update.

    ``loss_fn(model, *inputs) -> scalar``.  ``step(*inputs)`` returns the
    f32 scalar loss (detached) and advances ``optimizer._global_step``;
    :meth:`multi_step` makes K steps in one call.  With
    ``accumulate_steps = k > 1`` each input is split along its first axis
    into k micro-batches (reference ``:378-396``): their gradients are
    summed in f32 in order and divided by k, the loss is the mean of
    theirs, and one update follows.  The optimizer's state lives here, in
    ``_opt_states`` ({parameter name: {moment1, moment2, beta1_pow,
    beta2_pow}}), created at the first call; :meth:`set_opt_states`
    installs one, e.g. from ``models.convert.opt_states_from_jax``.  The
    clip and the update run inside a ``TrainStep.update`` profiler range,
    which ``tools/profile_gpt.py --train`` reads to tell the optimizer's
    kernels from the model's.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 amp_level: Optional[str] = None, amp_dtype="bfloat16",
                 accumulate_steps: int = 1, donate: bool = True,
                 recompute: bool = False):
        if amp_level not in (None, "O0", "O1", "O2"):
            raise ValueError(f"amp_level must be None, 'O0', 'O1' or 'O2', "
                             f"got {amp_level!r}")
        if int(accumulate_steps) != accumulate_steps or accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be a positive integer, "
                             f"got {accumulate_steps!r}")
        # the tuned startup profile (FLAGS_autotune_profile, reference
        # :329-332) lands before any flag-derived knob is read
        from paddle_tpu_torch.framework.autopilot import \
            maybe_apply_tuned_profile
        maybe_apply_tuned_profile(source="TrainStep")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = (torch.bfloat16 if str(amp_dtype) in (
            "bfloat16", "bf16", "torch.bfloat16") else torch.float16)
        self.accumulate_steps = int(accumulate_steps)
        self.donate = donate
        self.recompute = recompute
        self._loss_from = loss_closure(model, loss_fn, amp_level,
                                       self.amp_dtype, recompute)
        self._opt_states: Optional[dict] = None
        self._signatures: set = set()

    def _params(self) -> dict:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def set_opt_states(self, states: dict):
        """Install optimizer state {name: {key: tensor}} for the model's
        parameters, moved to each parameter's device."""
        params = self._params()
        if set(states) != set(params):
            raise ValueError(f"opt states name {sorted(states)}, the model's "
                             f"parameters are {sorted(params)}")
        self._opt_states = {
            n: {k: t.to(params[n].device) for k, t in st.items()}
            for n, st in states.items()}

    def _one_step(self, params: dict, inputs, lr, states,
                  numerics_aux: bool = False):
        """The step body of ``__call__`` and ``multi_step`` (the reference's
        ``_build_one_step`` :347-410): the loss and gradients of each
        micro-batch, their mean, the clip and the update.  Returns the f32
        loss, the new parameters and the new optimizer state; the caller
        writes them.  With ``numerics_aux`` (``FLAGS_numerics``, reference
        ``:403-405``) a fourth item: ``numerics.compute_aux`` of the
        pre-clip gradients, the parameters before and after the update
        (copied first when the update writes them in place)."""
        micro = self.accumulate_steps
        parts = [i.reshape((micro, -1) + tuple(i.shape[1:])) for i in inputs]
        losses, grads = [], None
        for k in range(micro):
            loss_k, g_k = loss_and_grads(self._loss_from, params,
                                         [p[k] for p in parts])
            losses.append(loss_k)
            grads = g_k if grads is None else {
                n: grads[n] + g_k[n] for n in grads}
        if micro > 1:
            grads = {n: g / micro for n, g in grads.items()}
        loss = torch.stack(losses).mean()
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.update"):
            before = {n: p.detach() for n, p in params.items()}
            if numerics_aux and self.donate:
                before = {n: t.clone() for n, t in before.items()}
            new_params, states = apply_functional_update(
                self.optimizer, grads,
                {n: p.detach() for n, p in params.items()}, states, lr,
                donate=self.donate)
            if numerics_aux:
                return loss, new_params, states, numerics.compute_aux(
                    grads, before, new_params, loss)
        return loss, new_params, states

    @staticmethod
    def _write(params: dict, new_params: dict):
        with torch.no_grad():
            for n, p in params.items():
                if new_params[n].data_ptr() != p.data_ptr():
                    p.copy_(new_params[n])

    def _note_signature(self, sig: tuple, site: str):
        """The compile cause of a first call under ``sig`` at ``site``
        (None on a repeat, counted as a cache hit): the reference's cache
        keys (``:548-601``), each multi_step key classified against the
        multi_step keys only and each ``__call__`` key against the
        others."""
        if sig in self._signatures:
            health.note_cache_hit(site)
            return None
        multi = bool(sig) and sig[0] == "multi"
        cause = health.classify_recompile(
            sig, [s for s in self._signatures
                  if (bool(s) and s[0] == "multi") == multi])
        self._signatures.add(sig)
        return cause

    def _run(self, inputs, steps: Optional[int], what: str,
             unroll: bool = False) -> torch.Tensor:
        """The dispatch shared by ``__call__`` (``steps`` None) and
        ``multi_step`` (``steps`` = K, a leading axis on every input): the
        learning rate read once, the step bodies, then the check_nan_inf
        sweep over their losses (reference ``_commit_step``) and the
        global step.  Returns the (K,) f32 losses, or the one loss.

        The host planes see it as the reference's step: a ``train.step``
        span (``__call__``) and a ``TrainStep`` / ``TrainStep.multi_step``
        profiler range around the bodies, the first call under a new
        signature timed as a compile, then ``train_step_ms`` (host wall
        time of the call: no synchronisation is added),
        ``train_steps_total``, the health detector and the memory sample.
        On the ranks of a ``LoopbackWorld`` only rank 0's thread records
        (``parallel.mesh.lead_thread``)."""
        from paddle_tpu_torch.parallel.mesh import lead_thread
        t_start = time.perf_counter()
        lead = lead_thread()
        params = self._params()
        dev = next(iter(params.values())).device
        if self._opt_states is None:
            self._opt_states = self.optimizer.functional_init_states(
                {n: p.detach() for n, p in params.items()})
        inputs = [torch.as_tensor(i).to(dev) for i in inputs]
        site = "TrainStep" if steps is None else "TrainStep.multi_step"
        armed = steps is None and numerics.enabled()
        cause = None
        if lead:
            named = [p for _, p in self.model.named_parameters()]
            sig = _sig_of(named, "T") + _sig_of(inputs, "A")
            if steps is not None:
                sig = ("multi", bool(unroll)) + sig
            if armed:
                sig = sig + ("numerics",)
            cause = self._note_signature(sig, site)
        # a fill kernel: the rate reaches the card as a launch argument
        lr = torch.full((), self.optimizer.get_lr(), dtype=torch.float32,
                        device=dev)
        check = flag("check_nan_inf")
        # armed without donation, nothing is written before the check: the
        # parameters go from step to step as new leaves, the state as new
        # dicts; the buffers, updated in place by the forward, are copied
        hold = check and not self.donate
        buffers = ({n: b.clone() for n, b in self.model.named_buffers()}
                   if hold else None)
        batches = ([inputs] if steps is None else
                   [[i[j] for i in inputs] for j in range(steps)])
        cur, states, losses = params, self._opt_states, []
        span = tracer.start_span(
            "train.step", attrs={"step": int(self.optimizer._global_step)}
        ) if lead and steps is None else contextlib.nullcontext()
        with span, RecordEvent(site), health.timed_compile(site, cause):
            for batch in batches:
                loss, new_params, states, *aux = self._one_step(
                    cur, batch, lr, states, numerics_aux=armed)
                losses.append(loss)
                if hold:
                    cur = {n: t.requires_grad_()
                           for n, t in new_params.items()}
                else:
                    self._write(params, new_params)
                    self._opt_states = states
        losses = losses[0] if steps is None else torch.stack(losses)
        if armed and aux:
            # published before the check_nan_inf raise below, so the
            # provenance record is readable after it (reference :596-606);
            # every rank of a LoopbackWorld keeps its record, its lead
            # thread publishes
            rec = numerics.NumericsRecord(
                list(params), aux[0], step=int(self.optimizer._global_step))
            if lead:
                numerics.publish(rec)
            self.last_numerics = rec
        if check and not bool(torch.isfinite(losses).all()):
            if hold:
                with torch.no_grad():
                    for n, b in self.model.named_buffers():
                        b.copy_(buffers[n])
            raise FloatingPointError(f"{what} produced a non-finite loss "
                                     "(FLAGS_check_nan_inf is set)")
        if hold:
            self._write(params, cur)
            self._opt_states = states
        self.optimizer._global_step += 1 if steps is None else steps
        if lead:
            _record_step(self, losses, steps, t_start)
        # the replica-parity probe (FLAGS_replica_parity, reference
        # :637-642): one flag lookup disarmed; a one-replica mesh probes
        # nothing
        from paddle_tpu_torch.parallel import parity
        parity.maybe_observe(self, mesh=getattr(self, "mesh", None))
        return losses

    def __call__(self, *inputs):
        return self._run(inputs, None, "TrainStep")

    def analyze(self, *args, **kwargs):
        raise NotImplementedError(
            "TrainStep.analyze is the reference's jaxpr analysis plane, not "
            "ported (ROADMAP Queue 1 item 8)")

    def compiled_text(self, *args, **kwargs):
        raise NotImplementedError(
            "TrainStep.compiled_text is the reference's XLA text, not "
            "ported (ROADMAP Queue 1 item 8)")

    def multi_step(self, *inputs, unroll: bool = False):
        """K optimizer steps in one call (reference ``:473-571``): every
        input carries a leading K axis, (K, B, ...), and step j trains on
        slice j through the body of ``__call__`` (``accumulate_steps``,
        AMP, recompute and buffers as there).  Returns the K losses as one
        (K,) f32 tensor and adds K to ``optimizer._global_step``.

        The learning rate is read once, at the call, and held for all K
        steps, as the reference's loop holds it: keep K within one
        scheduler interval, or step the scheduler once per call.
        ``FLAGS_check_nan_inf`` sweeps the K losses once, after the last
        step, ordered by donation as in ``__call__``.  ``unroll`` chooses
        between the reference's ``lax.scan`` and its straight-line loop;
        in eager PyTorch the two forms are one loop, and the result is the
        same either way."""
        if not inputs:
            raise ValueError("multi_step needs at least one input")
        ks = {int(torch.as_tensor(i).shape[0]) for i in inputs}
        if len(ks) != 1:
            raise ValueError(f"multi_step inputs disagree on the leading "
                             f"steps axis: {sorted(ks)}")
        return self._run(inputs, ks.pop(), "TrainStep.multi_step",
                         unroll=unroll)


from paddle_tpu_torch.jit.static import (  # noqa: E402,F401
    StaticFunction, TranslatedLayer, _cipher_for, _read_artifact, load,
    not_to_static, save, to_static)
from paddle_tpu_torch.framework.resilient import (  # noqa: E402,F401
    ResilientTrainStep)
