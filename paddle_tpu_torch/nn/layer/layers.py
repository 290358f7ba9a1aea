"""``Layer``, the base class of every layer and model of the port, and the
containers ``Sequential``, ``LayerList`` and ``ParameterList`` (port of
paddle_tpu/nn/layer/layers.py :21-446).

``Layer`` is a ``torch.nn.Module`` that carries the reference's methods,
so a PyTorch caller (``torch.func.functional_call``, ``.to("cuda")``,
``load_state_dict``, ``eval()``) and a PaddlePaddle caller both find what
they call.  Where the two name the same method, the reference's meaning
wins and PyTorch's arguments are accepted beside its own:

- ``parameters`` and ``buffers`` return lists (``include_sublayers`` or
  ``recurse``); ``named_parameters`` / ``named_buffers`` take
  ``include_sublayers`` or ``recurse`` and ``remove_duplicate``;
- ``state_dict`` holds every parameter first, then the persistable
  buffers (reference ``:235-252``; PyTorch interleaves them module by
  module), detached unless ``keep_vars``; ``set_state_dict`` copies in
  place and returns (missing, unexpected);
- ``apply`` visits the layer itself first, then its sublayers in
  pre-order (``:218-221``; PyTorch's order is post-order);
- ``register_buffer`` takes ``persistable`` or ``persistent``;
- ``to(device, dtype, blocking)`` takes PyTorch's forms too (a dtype or a
  device alone, ``non_blocking``);
- ``register_forward_pre_hook`` and ``register_forward_post_hook`` run the
  reference's hooks (``hook(layer, inputs)`` may return new inputs,
  ``hook(layer, inputs, outputs)`` new outputs) in the order they were
  registered, the two kinds numbered by one counter of the layer
  (``:120-128``), and return a ``HookRemoveHelper``;
- assigning a tensor that is not a ``Parameter`` to a parameter's name
  copies its value into the parameter in place (``:65-70``).

``create_parameter`` makes its parameter on the card unless
``device="cpu"`` is given, as every layer of the port does.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.framework.dtype import convert_dtype

__all__ = ["Layer", "HookRemoveHelper", "Sequential", "LayerList",
           "ParameterList"]


class HookRemoveHelper:
    """The handle a hook registration returns: ``remove()`` drops it."""

    def __init__(self, hooks: dict, key: int):
        self._hooks = hooks
        self._key = key

    def remove(self):
        self._hooks.pop(self._key, None)


def _run_pre_hooks(layer, inputs):
    for hook in list(layer._layer_pre_hooks.values()):
        out = hook(layer, inputs)
        if out is not None:
            inputs = out if isinstance(out, tuple) else (out,)
    return inputs


def _run_post_hooks(layer, inputs, outputs):
    for hook in list(layer._layer_post_hooks.values()):
        res = hook(layer, inputs, outputs)
        if res is not None:
            outputs = res
    return outputs


def _torch_dtype(dtype) -> torch.dtype:
    return convert_dtype(dtype)


def _is_dtype(value) -> bool:
    return isinstance(value, torch.dtype) or (
        isinstance(value, str) and isinstance(getattr(torch, value, None),
                                              torch.dtype))


class Layer(nn.Module):
    """The base class of layers (reference ``Layer`` :30): parameters,
    sublayers and buffers registered by attribute or by the ``add_*`` /
    ``register_*`` methods, forward hooks, the state dict and the dtype
    moves.  Subclasses define ``forward``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = name_scope or type(self).__name__.lower()
        self._hook_id = 0
        self._layer_pre_hooks = OrderedDict()
        self._layer_post_hooks = OrderedDict()
        self._hooks_installed = False

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if (params is not None and params.get(name) is not None
                and isinstance(value, torch.Tensor)
                and not isinstance(value, nn.Parameter)):
            target = params[name]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"set_value shape mismatch: "
                                 f"{tuple(value.shape)} vs "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(value)
            return
        super().__setattr__(name, value)

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    # -- hooks ----------------------------------------------------------
    def _add_hook(self, hooks: dict, hook) -> HookRemoveHelper:
        if not self._hooks_installed:
            # one PyTorch hook of each kind runs the layer's own, in order
            super().register_forward_pre_hook(_run_pre_hooks)
            super().register_forward_hook(_run_post_hooks)
            self._hooks_installed = True
        self._hook_id += 1
        hooks[self._hook_id] = hook
        return HookRemoveHelper(hooks, self._hook_id)

    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs)`` before each forward; a value it returns
        (a tuple, or one input) replaces the inputs."""
        return self._add_hook(self._layer_pre_hooks, hook)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)`` after each forward; a value it
        returns replaces the outputs."""
        return self._add_hook(self._layer_post_hooks, hook)

    # -- registry -------------------------------------------------------
    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent=None):
        """A buffer; one that is not ``persistable`` stays out of
        ``state_dict``."""
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        """A parameter made as the layers make theirs
        (``nn.initializer._create_param``): zeros for a bias, else
        Xavier-uniform unless ``attr`` or ``default_initializer`` says
        otherwise, in the layer's dtype, on the card unless ``device`` is
        "cpu"."""
        from paddle_tpu_torch.device import resolve_device
        from paddle_tpu_torch.nn.initializer import _create_param
        return _create_param(shape, dtype or self._dtype, attr=attr,
                             is_bias=is_bias,
                             default_initializer=default_initializer,
                             device=resolve_device(device))

    # -- iteration ------------------------------------------------------
    def parameters(self, include_sublayers: bool = True, recurse=None):
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers: bool = True, recurse=None):
        return list(super().buffers(
            include_sublayers if recurse is None else recurse))

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      remove_duplicate: bool = True, recurse=None):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        """(dotted name, layer) of every sublayer, pre-order; a layer
        reached by two paths is yielded under each."""
        if include_self:
            yield prefix, self
        for name, sub in self._modules.items():
            if sub is None:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, Layer):
                yield from sub.named_sublayers(sub_prefix, include_self=True)
            else:
                yield from sub.named_modules(prefix=sub_prefix)

    def sublayers(self, include_self: bool = False) -> list:
        return [lyr for _, lyr in self.named_sublayers(
            include_self=include_self)]

    def apply(self, fn):
        """``fn(layer)`` on this layer, then on every sublayer in
        pre-order."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -- state dict -----------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """{dotted name: tensor}: every parameter, then every persistable
        buffer; detached unless ``keep_vars``."""
        dest = OrderedDict() if destination is None else destination
        pre = (structured_name_prefix if prefix is None else prefix)
        pre = pre.rstrip(".")
        for name, p in self.named_parameters(pre, include_sublayers):
            dest[name] = p if keep_vars else p.detach()
        layers = (self.named_modules(prefix=pre) if include_sublayers
                  else [(pre, self)])
        skip = {f"{lp}.{b}" if lp else b for lp, lyr in layers
                for b in lyr._non_persistent_buffers_set}
        for name, b in self.named_buffers(pre, include_sublayers):
            if name not in skip:
                dest[name] = b if keep_vars else b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or arrays) into the
        parameter or buffer of its name, in place, in the target's dtype;
        a shape that differs raises.  Returns (missing, unexpected): the
        layer's names absent from ``state_dict``, and its names the layer
        lacks."""
        own = self.state_dict(keep_vars=True)
        unexpected = []
        with torch.no_grad():
            for name, value in state_dict.items():
                if name not in own:
                    unexpected.append(name)
                    continue
                target = own[name]
                v = (value if isinstance(value, torch.Tensor)
                     else torch.from_numpy(np.array(value)))
                if tuple(v.shape) != tuple(target.shape):
                    raise ValueError(f"shape mismatch for {name}: "
                                     f"{tuple(v.shape)} vs "
                                     f"{tuple(target.shape)}")
                target.copy_(v)
        return [n for n in own if n not in state_dict], unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- device and dtype -----------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, *,
           non_blocking=False, **kwargs):
        """Move and/or cast (floating tensors only): ``to("cuda")``,
        ``to(torch.bfloat16)``, ``to(dtype="float16")``, ``to(device,
        dtype, blocking)``, ``to(tensor)``."""
        if isinstance(device, torch.Tensor):
            return super().to(device, non_blocking=non_blocking, **kwargs)
        if dtype is None and _is_dtype(device):
            device, dtype = None, device
        if dtype is not None:
            dtype = _torch_dtype(dtype)
        if blocking is not None:
            non_blocking = not blocking
        super().to(device=device, dtype=dtype, non_blocking=non_blocking,
                   **kwargs)
        if dtype is not None:
            for layer in self.sublayers(include_self=True):
                if isinstance(layer, Layer):
                    layer._dtype = str(dtype).replace("torch.", "")
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=torch.float32)

    def half(self):
        return self.to(dtype=torch.float16)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        """The name scope given at construction, else the class's name in
        lower case."""
        return self._full_name

    def functional_state(self):
        """({name: parameter}, {name: buffer}), detached, keyed by the
        dotted names that ``torch.func.functional_call`` takes."""
        return ({n: p.detach() for n, p in self.named_parameters()},
                {n: b.detach() for n, b in self.named_buffers()})


class Sequential(Layer):
    """Layers called in order (reference ``:357``); each argument is a
    layer, named ``0``, ``1``, ... by its place, or a (name, layer)
    pair."""

    def __init__(self, *layers):
        super().__init__()
        for i, item in enumerate(layers):
            name, layer = item if isinstance(item, tuple) else (str(i), item)
            self.add_sublayer(name, layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """A list of sublayers named ``0``, ``1``, ... (reference ``:387``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __setitem__(self, idx, layer):
        self._modules[list(self._modules)[idx]] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        """``layer`` at ``index``; the sublayers are renamed by place."""
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, lyr in enumerate(layers):
            self._modules[str(i)] = lyr

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    """A list of parameters named ``0``, ``1``, ... (reference ``:427``)."""

    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[list(self._parameters)[idx]]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
