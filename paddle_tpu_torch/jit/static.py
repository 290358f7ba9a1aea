"""Static capture and the deployment artifact (port of
paddle_tpu/jit/__init__.py ``StaticFunction`` / ``to_static`` /
``not_to_static`` :73-267 and ``TranslatedLayer`` / ``save`` / ``load``
:712-887).

``to_static(layer_or_fn)`` rewrites native control flow over tensors
(``jit/dy2static.py``), then captures the forward with
``torch.export.export(strict=False)`` once per input signature and runs
the exported graph.  The contract is the reference's (``:150-236``):

- the signature covers the shapes, dtypes and devices of the parameters,
  buffers and tensor arguments, the static (non-tensor) arguments,
  ``training`` and the keyword arguments; a repeat does not capture again
  (``captures`` counts the captures);
- parameters and buffers are inputs of the graph at every call, so an
  eager optimizer step between two calls is seen by the next: the graph
  is exported over (parameters, buffers, inputs) through
  ``torch.nn.utils.stateless`` and holds no copy of them;
- the buffers enter the graph as copies whose new values come out as
  outputs and are written back (BatchNorm's running statistics in
  training mode);
- with a gradient wanted, the whole graph is one node on autograd's tape
  (:class:`_Captured`): gradients reach the parameters and the tensor
  arguments, the buffers take none;
- random ops stay ops of the graph and draw from the default generator at
  each call, fresh without a new capture;
- the output keeps its tree structure;
- cuDNN's TF32 is off while a graph runs, forward and backward, as the
  port's eager f32 convolutions (``nn/functional/conv.py`` ``_F32Conv``)
  switch it off around themselves: that switch acts at the call, so a
  trace does not keep it.

The kernels of ``ops/cuda`` are ``torch.library`` custom ops with fake
implementations, so they stay nodes of the graph and launch (and count)
when it runs.  ``torch.compile`` is not used.

``save(layer, path, input_spec)`` writes ``path.pdparams`` (the state
dict, ``framework/io.py``: it crosses between the packages both ways) and,
with an ``input_spec``, ``path.pdmodel``: a ``torch.export.save`` archive
whose inputs are the state dict's tensors, in its order, then the inputs
(a None / -1 dim of a spec a dynamic dim), with a ``paddle_tpu_torch.json``
entry naming the tensors, the inputs and the device the graph was captured
on.  The reference's ``.pdmodel`` is serialized StableHLO: ``load`` refuses
it by name, and the reference cannot read this one.  ``encrypt_key``
writes ciphertext only (``framework/crypto.py``, the reference's cipher
and byte format).
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import warnings
import zipfile
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils import _pytree as pytree

from paddle_tpu_torch.framework import health
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["StaticFunction", "to_static", "not_to_static", "save", "load",
           "TranslatedLayer"]

_META = "paddle_tpu_torch.json"
_FORMAT = "paddle_tpu_torch.pdmodel"


def _sig_of(args) -> tuple:
    """The reference's signature leaves (shape, dtype name) with the
    device the capture is specialised to."""
    return tuple(("T", tuple(a.shape), str(a.dtype).replace("torch.", ""),
                  str(a.device))
                 if isinstance(a, torch.Tensor) else ("S", a) for a in args)


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


class _Pure(nn.Module):
    """What a capture exports: ``forward(state, inputs)`` calls ``fn`` with
    ``state`` ({name: tensor} in ``names``' order) swapped into ``layer``
    and ``inputs`` in the tensor slots of ``static_args``; returns the
    flat outputs, then the new values of ``buffer_names`` (entered as
    copies).  ``fn`` and ``layer`` are held outside the module's
    registry, so the graph has no parameter of its own: tensors of the
    layer that ``state`` does not name become constants of the graph."""

    def __init__(self, fn, layer, names, buffer_names, static_args,
                 kwargs, record):
        super().__init__()
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_layer", layer)
        self._names = list(names)
        self._buffer_names = list(buffer_names)
        self._static_args = static_args
        self._kwargs = kwargs
        # takes the output's tree structure at the trace (a function: the
        # export works on a copy of this module)
        object.__setattr__(self, "_record", record)

    def forward(self, state, inputs):
        it = iter(inputs)
        args = [next(it) if kind == "tensor" else spec
                for kind, spec in self._static_args]
        if self._layer is None:
            out, new = self._fn(*args, **self._kwargs), []
        else:
            swap = dict(zip(self._names, state))
            for n in self._buffer_names:
                swap[n] = swap[n].clone()
            with _reparametrize_module(self._layer, swap, tie_weights=True):
                out = self._fn(*args, **self._kwargs)
            new = [swap[n] for n in self._buffer_names]
        flat, spec = pytree.tree_flatten(out)
        self._record(spec)
        flat = [o if isinstance(o, torch.Tensor) else torch.as_tensor(o)
                for o in flat]
        return tuple(flat) + tuple(new)


@contextlib.contextmanager
def _no_cudnn_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Captured(torch.autograd.Function):
    """A captured graph as one node of autograd's tape (the reference's
    ``apply(..., name="to_static")``, one ``jax.vjp`` of the jitted
    function): the forward runs the graph on detached inputs under
    autograd, the backward differentiates that inner graph.  The last
    ``n_buf`` outputs (new buffer values) take no gradient."""

    @staticmethod
    def forward(ctx, run, n_buf, *flat):
        needs = ctx.needs_input_grad[2:]
        leaves = [t.detach().requires_grad_() if need else t
                  for t, need in zip(flat, needs)]
        with torch.enable_grad():
            outs = run(leaves)
        ctx.leaves, ctx.outs, ctx.needs = leaves, outs, needs
        res = tuple(o.detach() for o in outs)
        if n_buf:
            ctx.mark_non_differentiable(*res[len(res) - n_buf:])
        return res

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        idx = [i for i, need in enumerate(ctx.needs) if need]
        got = [None] * len(idx)
        if pairs and idx:
            with _no_cudnn_tf32():
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [ctx.leaves[i] for i in idx],
                    [g for _, g in pairs], allow_unused=True)
        res = [None] * len(ctx.needs)
        for i, g in zip(idx, got):
            res[i] = g
        del ctx.outs, ctx.leaves
        return (None, None, *res)


def _indexed(dev) -> torch.device:
    """``dev`` with its index: "cuda" is the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _default_device(layer) -> torch.device:
    if layer is not None:
        for t in list(layer.parameters()) + list(layer.buffers()):
            return t.device
    from paddle_tpu_torch.device import resolve_device
    return resolve_device(None)


class StaticFunction:
    """A captured forward (reference ``:73``).  ``captures`` counts the
    exports made, one per signature (``_cache``)."""

    def __init__(self, function: Callable, layer: Optional[nn.Module] = None,
                 input_spec=None):
        self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._cache: Dict[tuple, tuple] = {}
        self.captures = 0
        functools.update_wrapper(self, function)

    @property
    def forward(self):
        return self

    def concrete_program(self):
        raise NotImplementedError(
            "StaticFunction.concrete_program belongs to the analysis plane, "
            "not ported (ROADMAP Queue 1 item 8)")

    def analyze(self, *example_inputs, **analyze_kwargs):
        raise NotImplementedError(
            "StaticFunction.analyze is the reference's jaxpr analysis, not "
            "ported (ROADMAP Queue 1 item 8)")

    def _capture(self, named_params, named_buffers, static_args,
                 tensor_args, kwargs):
        names = [n for n, _ in named_params] + [n for n, _ in named_buffers]
        specs = []
        pure = _Pure(self._function, self._layer, names,
                     [n for n, _ in named_buffers], static_args, kwargs,
                     specs.append)
        state = [t for _, t in named_params] + [t for _, t in named_buffers]
        ep = torch.export.export(pure, (state, list(tensor_args)),
                                 strict=False)
        return ep.module(), specs[-1]

    def __call__(self, *args, **kwargs):
        layer = self._layer
        named_params = list(layer.named_parameters()) if layer is not None \
            else []
        named_buffers = [(n, b) for n, b in layer.named_buffers()
                         if b is not None] if layer is not None else []
        static_args, tensor_args = [], []
        for a in args:
            if isinstance(a, np.ndarray):
                a = torch.as_tensor(a, device=_default_device(layer))
            if isinstance(a, torch.Tensor):
                static_args.append(("tensor", None))
                tensor_args.append(a)
            else:
                static_args.append(("static", a))
        training = layer.training if layer is not None else False
        sig = (_sig_of([p for _, p in named_params])
               + _sig_of([b for _, b in named_buffers])
               + _sig_of(tensor_args)
               + tuple(_hashable(s) for k, s in static_args if k == "static")
               + (training, _hashable(kwargs)))
        # a capture is the compile of the health plane's site: its cause
        # is classified against the signatures captured before it, and
        # the capture and first run are timed into compile_ms
        site = f"to_static:{getattr(self._function, '__name__', '?')}"
        entry = self._cache.get(sig)
        cause = None
        if entry is None:
            cause = health.classify_recompile(sig, list(self._cache))
        else:
            health.note_cache_hit(site)
        with health.timed_compile(site, cause):
            if entry is None:
                entry = self._capture(named_params, named_buffers,
                                      static_args, tensor_args, kwargs)
                self._cache[sig] = entry
                self.captures += 1
            return self._run_captured(entry, named_params, named_buffers,
                                      tensor_args)

    @staticmethod
    def _run_captured(entry, named_params, named_buffers, tensor_args):
        graph, out_spec = entry
        state = [p for _, p in named_params] + [b for _, b in named_buffers]
        n_state = len(state)

        def run(flat):
            with _no_cudnn_tf32():
                return graph(list(flat[:n_state]), list(flat[n_state:]))
        flat = state + tensor_args
        n_buf = len(named_buffers)
        if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
            outs = _Captured.apply(run, n_buf, *flat)
        else:
            outs = run(flat)
        n_out = len(outs) - n_buf
        if n_buf:
            with torch.no_grad():
                for (_, b), new in zip(named_buffers, outs[n_out:]):
                    b.copy_(new)
        return pytree.tree_unflatten(list(outs[:n_out]), out_spec)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator / wrapper (reference ``:238``): a Layer gets a
    ``StaticFunction`` as its ``forward`` and is returned; a bound method
    of a Layer or a plain function becomes a ``StaticFunction``.  The AST
    pass (``dy2static.convert_to_static``) runs first."""
    def decorate(obj):
        from paddle_tpu_torch.jit.dy2static import convert_to_static
        if isinstance(obj, nn.Module):
            obj.forward = StaticFunction(convert_to_static(obj.forward),
                                         layer=obj, input_spec=input_spec)
            return obj
        layer = getattr(obj, "__self__", None)
        return StaticFunction(convert_to_static(obj),
                              layer=layer if isinstance(layer, nn.Module)
                              else None, input_spec=input_spec)
    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(func):
    func._not_to_static = True
    return func


# ---------------------------------------------------------------------------
# jit.save / jit.load
# ---------------------------------------------------------------------------


class TranslatedLayer(Layer):
    """A loaded artifact, an ``nn.Layer`` (reference ``:712``): the
    exported graph run on the ``.pdparams`` tensors, in the state dict's
    order, then the inputs.  One output comes back as a tensor, several
    as a list.  ``device`` is where it runs: an input tensor on another
    device raises (load it with ``jit.load(path, device=...)``)."""

    def __init__(self, program, params, meta):
        super().__init__()
        object.__setattr__(self, "_program", program)
        self._params = [p.detach() for p in params]
        self._meta = meta
        self.device = _indexed(meta["device"])

    def forward(self, *inputs):
        args = []
        for i in inputs:
            t = torch.as_tensor(i, device=self.device) \
                if not isinstance(i, torch.Tensor) else i
            if _indexed(t.device) != self.device:
                raise ValueError(
                    f"TranslatedLayer: the artifact runs on {self.device}, "
                    f"got an input on {t.device}; move the input, or load "
                    f"the artifact with jit.load(path, device=...)")
            args.append(t)
        with _no_cudnn_tf32():
            outs = list(self._program(self._params, args))
        return outs[0] if len(outs) == 1 else outs


def _cipher_for(key):
    """(AESCipher, key bytes) for a user key (reference ``:733``): a raw
    16 / 24 / 32-byte key is used as it is; any str or other length is
    sha256-hashed to an AES-256 key."""
    import hashlib

    from paddle_tpu_torch.framework.crypto import AESCipher
    if isinstance(key, (bytes, bytearray)) and len(key) in (16, 24, 32):
        kb = bytes(key)
    else:
        if isinstance(key, str):
            key = key.encode()
        kb = hashlib.sha256(bytes(key)).digest()
    return AESCipher(len(kb)), kb


def _spec_inputs(input_spec, device):
    """Example inputs and dynamic shapes of ``input_spec`` (InputSpecs or
    tensors); a None / -1 dim is dynamic, exported at an example size of
    2 (an export specialises sizes 0 and 1)."""
    from paddle_tpu_torch.static import InputSpec
    examples, dyn, specs = [], [], []
    for i, spec in enumerate(input_spec):
        if isinstance(spec, torch.Tensor):
            spec = InputSpec.from_tensor(spec)
        dt = spec.torch_dtype()
        shape = [2 if s == -1 else int(s) for s in spec.shape]
        examples.append(torch.zeros(shape, dtype=dt, device=device))
        dims = {a: torch.export.Dim(f"in{i}_d{a}")
                for a, s in enumerate(spec.shape) if s == -1}
        dyn.append(dims or None)
        specs.append([list(spec.shape), str(dt).replace("torch.", "")])
    return examples, dyn, specs


def _export_artifact(layer, input_spec) -> bytes:
    """``path.pdmodel``'s bytes: the eval-mode forward exported over (the
    state dict's tensors, the inputs), the batch dynamic where the spec
    says so.  As the reference (``:820-833``), an export that cannot keep
    a dim dynamic falls back to a concrete one (dynamic dims at 1) with a
    warning."""
    fwd = layer.forward
    fn = fwd._function if isinstance(fwd, StaticFunction) else fwd
    state = layer.state_dict(keep_vars=True)
    names = list(state)
    weights = [t.detach() for t in state.values()]
    device = _default_device(layer)
    examples, dyn, specs = _spec_inputs(input_spec, device)
    pure = _Pure(fn, layer, names, [], [("tensor", None)] * len(examples),
                 {}, lambda spec: None)
    was_training = layer.training
    layer.eval()
    try:
        dynamic = any(d is not None for d in dyn)
        try:
            ep = torch.export.export(
                pure, (weights, examples),
                dynamic_shapes=([None] * len(weights), dyn), strict=False)
        except Exception as e:                     # noqa: BLE001
            if not dynamic:
                raise
            warnings.warn(
                f"jit.save: the export with dynamic dims failed ({e!r}); "
                "falling back to a CONCRETE export with those dims at 1: "
                "the loaded model will only accept the saved shapes",
                stacklevel=3)
            dynamic = False
            examples = [torch.zeros([1 if s == -1 else s for s in shp],
                                    dtype=x.dtype, device=device)
                        for (shp, _), x in zip(specs, examples)]
            ep = torch.export.export(pure, (weights, examples),
                                     strict=False)
    finally:
        if was_training:
            layer.train()
    # the example inputs are the weights: the .pdparams file holds them
    ep.example_inputs = None
    meta = {"format": _FORMAT, "version": 1, "device": str(device),
            "names": names, "inputs": specs, "dynamic": dynamic}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def save(layer, path, input_spec=None, encrypt_key=None, **configs):
    """``path.pdparams`` (the state dict) and, with ``input_spec``,
    ``path.pdmodel`` (reference ``:752``).  ``encrypt_key`` encrypts both
    in memory: no plaintext reaches the file system."""
    from paddle_tpu_torch.framework.io import dumps as _dumps
    from paddle_tpu_torch.framework.io import save as _save
    if isinstance(layer, StaticFunction):
        layer = layer._layer
    cipher = None
    if encrypt_key is not None:
        cipher, kb = _cipher_for(encrypt_key)
        with open(path + ".pdparams", "wb") as f:
            f.write(cipher.encrypt(_dumps(layer.state_dict()), kb))
    else:
        _save(layer.state_dict(), path + ".pdparams")
    if input_spec:
        blob = _export_artifact(layer, input_spec)
        if cipher is not None:
            blob = cipher.encrypt(blob, kb)
        with open(path + ".pdmodel", "wb") as f:
            f.write(blob)


def _read_artifact(path, decrypt_key):
    """A saved file's bytes, decrypted in memory when it carries the
    cipher's magic (reference ``:860``)."""
    from paddle_tpu_torch.framework import crypto
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(crypto._MAGIC):
        if decrypt_key is None:
            raise ValueError(
                f"{path} is encrypted — pass decrypt_key= (jit.load) or "
                "Config(decrypt_key=...) (inference)")
        cipher, kb = _cipher_for(decrypt_key)
        data = cipher.decrypt(data, kb)
    return data


def _register_ops():
    """Import the kernel modules, whose custom ops a graph may call."""
    from paddle_tpu_torch.ops.cuda import flash_attention, fused_ce  # noqa


def load(path, decrypt_key=None, device=None, **configs):
    """The ``TranslatedLayer`` of ``save``'s artifact (reference ``:874``),
    on ``device`` (the default device when None).  A graph captured on
    another device is moved there explicitly
    (``torch.export.passes.move_to_device_pass``).  Wrong keys and
    tampered files raise (the HMAC), as does a ``.pdmodel`` that is not
    this package's."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.framework.io import loads as _loads
    target = resolve_device(device)
    state = _loads(_read_artifact(path + ".pdparams", decrypt_key),
                   device=target)
    if not os.path.exists(path + ".pdmodel"):
        raise FileNotFoundError(f"{path}.pdmodel not found")
    blob = _read_artifact(path + ".pdmodel", decrypt_key)
    if not zipfile.is_zipfile(io.BytesIO(blob)):
        raise ValueError(
            f"{path}.pdmodel is not a torch.export artifact written by "
            "paddle_tpu_torch.jit.save: the JAX package paddle_tpu writes "
            "its .pdmodel as serialized StableHLO, which this package "
            "cannot run; only the .pdparams file crosses between them")
    _register_ops()
    extra = {_META: ""}
    ep = torch.export.load(io.BytesIO(blob), extra_files=extra)
    meta = json.loads(extra[_META] or "{}")
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}.pdmodel lacks {_META}: it was not written "
                         "by paddle_tpu_torch.jit.save")
    missing = [n for n in meta["names"] if n not in state]
    if missing:
        raise ValueError(f"{path}.pdparams lacks {missing} of the graph's "
                         "inputs")
    if torch.device(meta["device"]).type != target.type:
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, target)
    meta["device"] = str(target)
    return TranslatedLayer(ep.module(), [state[n] for n in meta["names"]],
                           meta)
