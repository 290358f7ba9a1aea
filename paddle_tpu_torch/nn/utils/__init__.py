"""``weight_norm``, ``remove_weight_norm``, ``spectral_norm``,
``parameters_to_vector`` and ``vector_to_parameters`` (port of
paddle_tpu/nn/utils/__init__.py :14-94).

``weight_norm`` and ``spectral_norm`` replace a layer's parameter by
others and rebuild it before each forward in a forward pre-hook of
``nn.Layer``, once at wrapping too; the rebuilt weight is a plain
attribute of the layer.  The reference's quirks are kept:

- ``weight_norm(dim=None)`` leaves axis 0 out of the norm, as
  ``dim=0`` does;
- ``remove_weight_norm`` folds ``g * v / ||v||`` back with the norm over
  every axis but 0, whatever ``dim`` the wrap took;
- the new parameters are named ``{name}_g`` and ``{name}_v`` (or
  ``{name}_orig``), without a unique suffix;
- ``spectral_norm(dim=None)`` means dim 0; its ``SpectralNorm`` sublayer
  (``{name}_spectral_norm``) holds ``weight_u`` and ``weight_v``.

A wrapped layer carries its rebuilt weight as a tensor on autograd's tape
and so cannot be deep-copied; carry its state by ``state_dict``.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp import _op_scope, amp_cast_for_op
from paddle_tpu_torch.framework.parameter import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(v, axis):
    """sqrt(sum(v^2)) over every axis but ``axis``, kept as size 1."""
    axes = tuple(i for i in range(v.dim()) if i != axis)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as ``g * v / ||v||`` (reference
    ``:14-47``), ``g`` the norm over every axis but ``dim`` (0 when
    None)."""
    axis = 0 if dim is None else dim
    w = getattr(layer, name)
    with torch.no_grad():
        g = Parameter(_norm_except(w.detach(), axis), name=f"{name}_g")
        v = Parameter(w.detach().clone(), name=f"{name}_v")
    delattr(layer, name)
    layer.add_parameter(f"{name}_g", g)
    layer.add_parameter(f"{name}_v", v)

    def hook(lyr, inputs):
        gg, vv = amp_cast_for_op("weight_norm", [getattr(lyr, f"{name}_g"),
                                                 getattr(lyr, f"{name}_v")])
        with _op_scope():
            setattr(lyr, name, gg * vv / _norm_except(vv, axis).clamp_min(
                1e-12))
    layer._weight_norm_handle = layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g`` and ``v`` back into one parameter ``name`` (reference
    ``:50-64``), the norm over every axis but 0."""
    g = getattr(layer, f"{name}_g")
    v = getattr(layer, f"{name}_v")
    with torch.no_grad():
        w = Parameter(g * v / _norm_except(v, 0).clamp_min(1e-12), name=name)
    delattr(layer, f"{name}_g")
    delattr(layer, f"{name}_v")
    handle = getattr(layer, "_weight_norm_handle", None)
    if handle is not None:
        handle.remove()
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, w)
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its spectral norm before each forward
    (reference ``:67-85``): the parameter becomes ``{name}_orig`` and a
    ``SpectralNorm`` sublayer ``{name}_spectral_norm`` computes the
    weight."""
    from paddle_tpu_torch.nn.layer.norm import SpectralNorm
    w = getattr(layer, name)
    layer.add_sublayer(f"{name}_spectral_norm", SpectralNorm(
        list(w.shape), dim=dim or 0, power_iters=n_power_iterations,
        eps=eps, device=w.device))

    def hook(lyr, inputs):
        sn = getattr(lyr, f"{name}_spectral_norm")
        setattr(lyr, name, sn(lyr._parameters[f"{name}_orig"]))
    delattr(layer, name)
    layer.add_parameter(f"{name}_orig", w)
    layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated, on autograd's tape."""
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into the parameters, in
    place."""
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n
