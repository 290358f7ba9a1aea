"""Automatic mixed precision for the eager loop (port of
paddle_tpu/amp/__init__.py): ``auto_cast`` / ``amp_guard``, ``decorate``
and ``GradScaler``, with the reference's ``white_list`` and
``black_list``.

Where the cast happens.  The reference casts at ``core.apply``, by the
op's name (``core.py:845-846``), the inputs of each op that one ``apply``
records.  The port casts at the counterpart of each such op: the
functional (``linear``, ``conv2d``, ``batch_norm``, ``relu6``, ...) or
the model entry (``gpt_forward``, ``gpt_loss``, ``gpt_loss_fused``,
``bert_forward``, ``bert_pretrain_loss``) is wrapped by :func:`amp_op`,
or calls :func:`amp_cast_for_op` on the tensors its reference op takes,
and then runs inside :func:`_op_scope`, so that the port's own
functionals inside a composite (the GPT forward's GELU) do not cast
again: inside one reference ``apply`` nothing is cast.  Ops the reference
records as tensor methods (``+``, ``@``, ``reshape``) are PyTorch's and
are not cast.  A cast is ``Tensor.to``, differentiable, as the
reference's ``apply1(..., name="amp_cast")``.

``torch.autocast`` is not used: its lists differ from the reference's, it
has no O2, and it casts ops the reference leaves alone.

Reproduced on purpose (``ROADMAP.md``):
- ``decorate(level="O2")`` casts every floating parameter in place, and
  the optimizers' state follows the parameters' dtype: the eager update
  runs on bf16 parameters.  The reference's unused f32 ``master_data``
  copy (``:134``) is not kept.
- ``GradScaler`` multiplies the loss by ``init_loss_scaling`` (2^15) in
  bf16 too, as the reference's code does (``:175-179``), whatever its
  docstring says about identity scaling.
- ``GradScaler.minimize`` and ``Optimizer.minimize`` call ``backward()``
  themselves (``:206-209``).

``update``'s flight record and monitor statistics belong to the telemetry
planes, which are not ported; the state they read,
``_consecutive_downscales``, is kept.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "white_list",
           "black_list", "amp_cast_for_op", "amp_op", "trace_ops"]

# the reference's op-name lists (``:29-42``)
white_list = {
    "matmul", "mm", "bmm", "mv", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "linear",
    "einsum", "flash_attention", "sdp_attention", "addmm",
}
black_list = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "mean", "sum",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "bce_with_logits",
    "binary_cross_entropy", "mse_loss", "l1_loss", "smooth_l1_loss", "kl_div",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "norm",
    "cumsum", "softmax_with_cross_entropy", "pow", "square", "sqrt", "rsqrt",
}

_state = threading.local()


def _amp_dtype(dtype) -> torch.dtype:
    """``float16`` / ``fp16`` map to bf16, as the reference maps them."""
    if str(dtype).replace("torch.", "") in ("bfloat16", "bf16", "float16",
                                            "fp16"):
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _level():
    if getattr(_state, "depth", 0):
        return None                       # inside one reference op
    return getattr(_state, "level", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Cast each op's inputs by the lists while the block runs (reference
    ``:63-88``).  O2: every op but the black-listed to ``dtype``, those to
    f32; any other level as O1: white-listed ops to ``dtype``,
    black-listed to f32, the rest as they come.  ``enable=False``
    switches casting off inside the block."""
    prev = tuple(getattr(_state, k, None) for k in (
        "level", "dtype", "custom_white", "custom_black"))
    if enable:
        _state.level = level
        _state.dtype = _amp_dtype(dtype)
        _state.custom_white = set(custom_white_list or ())
        _state.custom_black = set(custom_black_list or ())
    else:
        _state.level = None
    try:
        yield
    finally:
        (_state.level, _state.dtype, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def _cast(a, to):
    if not isinstance(a, torch.Tensor) or not a.is_floating_point() or \
            a.dtype == to:
        return a
    return a.to(to)


def amp_cast_for_op(name: str, args):
    """The inputs of op ``name`` cast as the active level and lists say
    (reference ``:90-118``): a list of the same length; tensors that are
    not floating, and everything else, pass as they are.  Outside
    ``auto_cast``, or inside another op, nothing is cast."""
    level = _level()
    if level is None:
        return list(args)
    dtype = _state.dtype
    cw, cb = _state.custom_white, _state.custom_black
    in_white = (name in white_list or name in cw) and name not in cb
    in_black = name in black_list or name in cb
    if level == "O2":
        to = torch.float32 if in_black else dtype
    elif in_white:
        to = dtype
    elif in_black:
        to = torch.float32
    else:
        to = None
    out = list(args) if to is None else [_cast(a, to) for a in args]
    trace = getattr(_state, "trace", None)
    if trace is not None:
        trace.append((name, [a.dtype for a in out
                             if isinstance(a, torch.Tensor)
                             and a.is_floating_point()]))
    return out


@contextlib.contextmanager
def trace_ops():
    """Record, while the block runs under ``auto_cast``, each op's name
    and the dtypes of its floating inputs after the cast: yields the list
    of (name, [dtype, ...]) it fills."""
    prev = getattr(_state, "trace", None)
    _state.trace = []
    try:
        yield _state.trace
    finally:
        _state.trace = prev


@contextlib.contextmanager
def _op_scope():
    """The body of one reference op: no functional inside it casts."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def amp_op(name: str):
    """Decorator: the functional is the counterpart of the reference's op
    ``name``; under ``auto_cast`` its tensor arguments (positional and
    keyword, as the reference hands them all to ``apply``) are cast first,
    and it runs as one op."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _level() is None:
                return fn(*args, **kwargs)
            keys = list(kwargs)
            cast = amp_cast_for_op(name, list(args) + [kwargs[k]
                                                       for k in keys])
            with _op_scope():
                return fn(*cast[:len(args)],
                          **dict(zip(keys, cast[len(args):])))
        return wrapper
    return deco


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: every floating parameter of the models cast to ``dtype`` in
    place (reference ``:122-140``); the ``Parameter`` objects, and so the
    optimizers' lists, stay the same.  No f32 master copy is kept (the
    reference's is read by nothing).  O1 leaves the models as they are.
    Returns the models (and the optimizers, when given) as passed."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        dt = _amp_dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (reference ``:141-289``).  ``scale`` multiplies
    the loss by the scale (2^15 at first; in bf16 too); ``unscale_``
    divides every gradient of the optimizer's parameters by it in place and
    reads once, for all of them, whether any is not finite; ``step`` skips
    the optimizer's step then; ``update`` halves the scale after
    ``decr_every_n_nan_or_inf`` bad steps in a row (not below 1) and
    doubles it after ``incr_every_n_steps`` good ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # scale decreases with no good step between them (the telemetry's
        # loss-scale-collapse signal reads it)
        self._consecutive_downscales = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        """``var * scale``, the reference's ``scale`` op (cast as one under
        ``auto_cast``)."""
        if not self._enable:
            return var
        (var,) = amp_cast_for_op("scale", [var])
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        from paddle_tpu_torch.optimizer.optimizer import _rounded
        flags = []
        for g in grads:
            g.mul_(_rounded(g.dtype, 1.0 / self._scale))
            flags.append(~torch.isfinite(g).all())
        # one read back to the host for the whole parameter list
        self._found_inf = bool(torch.stack(flags).any())

    def minimize(self, optimizer, scaled_loss):
        """``scaled_loss.backward()``, then ``step`` and ``update``: a
        caller who has already run the backward accumulates the gradient
        twice, as in the reference."""
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        """The dynamic scale's state machine (reference ``:219-251``), its
        scale exported as the ``amp_loss_scale`` statistic; every K
        consecutive downscales (``FLAGS_numerics_scale_collapse_k``) record
        a ``numerics.scale_collapse`` flight event and count into
        ``amp_scale_collapses_total``."""
        if not self._enable or not self._dynamic:
            return
        # local imports: amp loads before the framework's planes
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import flag
        from paddle_tpu_torch.framework.observability import flight
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
                self._consecutive_downscales += 1
                k = int(flag("numerics_scale_collapse_k"))
                cd = self._consecutive_downscales
                if k > 0 and cd >= k and cd % k == 0:
                    # K downscales with no good step between them: the
                    # overflow is systematic, not a transient batch
                    flight.record("numerics.scale_collapse",
                                  severity="warn", scale=self._scale,
                                  consecutive_downscales=cd)
                    monitor.stat_add("amp_scale_collapses_total")
        else:
            self._good_steps += 1
            self._bad_steps = 0
            self._consecutive_downscales = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        monitor.stat_set("amp_loss_scale", self._scale)
        self._found_inf = False

    def tighten_growth(self, factor: float = 4.0) -> dict:
        """Multiply the growth interval by ``factor`` and restart the count
        of good steps; returns the previous growth state for
        :meth:`restore_growth`."""
        prev = {"incr_every_n_steps": self._incr_every,
                "good_steps": self._good_steps}
        self._incr_every = max(1, int(self._incr_every * factor))
        self._good_steps = 0
        return prev

    def restore_growth(self, prev: dict) -> None:
        """Undo a :meth:`tighten_growth` with the dict it returned."""
        self._incr_every = max(1, int(
            prev.get("incr_every_n_steps", self._incr_every)))
        self._good_steps = int(prev.get("good_steps", self._good_steps))

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "consecutive_downscales": self._consecutive_downscales}

    def set_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
        self._consecutive_downscales = sd.get("consecutive_downscales", 0)
