"""Generic parameter reparameterization, as ``apex_tpu/reparameterization/
reparameterization.py``, in two forms with the same names.

- **Dict form**, on a ``{name: tensor}`` mapping or a nested dict of them
  (the JAX package's pytree form): :func:`apply_reparameterization`
  replaces each selected leaf ``k`` by ``k_g`` / ``k_v`` entries, and
  :func:`merge` recomputes ``k`` from them; :func:`reparameterized_apply`
  wraps a function that takes such a dict (for example through
  ``torch.func.functional_call``), so that autograd differentiates
  through the decomposition.
- **Module form**, the reference's mechanism (``reparameterization.py:
  57-145``) in PyTorch's idiom: on an ``nn.Module``,
  :func:`apply_reparameterization` replaces each selected parameter ``k``
  of every submodule by parameters ``k_g`` and ``k_v`` and registers a
  forward-pre hook that recomputes ``k`` as a plain tensor attribute
  before each forward of that submodule;
  :func:`remove_reparameterization` bakes the current weight back into a
  parameter ``k`` and removes the hook.

The new parameters sit on the submodule that held ``k``, so their paths
are ``k``'s with a suffix: amp's keep-fp32 filter (which matches
parameter paths against ``"norm"``, ``"bn"`` and other fragments) treats
them as it treats ``k``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch
from torch import nn

G_SUFFIX = "_g"
V_SUFFIX = "_v"


class Reparameterization:
    """Decompose and recompose one parameter tensor: subclasses implement
    :meth:`reparameterize` (tensor -> dict of auxiliary tensors) and
    :meth:`compute_weight` (that dict -> tensor), the pair the reference
    requires (``reparameterization.py:28-55``)."""

    def reparameterize(self, name: str, weight: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def compute_weight(self, name: str, aux: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        raise NotImplementedError


def default_filter(name: str, leaf: Any) -> bool:
    """Every floating tensor of at least 2 dimensions (the reference
    leaves vectors and scalars alone)."""
    return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
            and leaf.is_floating_point())


class _Hook:
    """The forward-pre hook of one reparameterized parameter ``name``:
    recomputes it from ``name_g`` / ``name_v`` as a plain attribute."""

    def __init__(self, name: str, reparam: Reparameterization):
        self.name, self.reparam = name, reparam
        self.handle = None

    def compute(self, module: nn.Module) -> torch.Tensor:
        g, v = self.name + G_SUFFIX, self.name + V_SUFFIX
        return self.reparam.compute_weight(
            self.name, {g: getattr(module, g), v: getattr(module, v)})

    def __call__(self, module: nn.Module, args) -> None:
        setattr(module, self.name, self.compute(module))


def _hooks(module: nn.Module) -> Dict[str, _Hook]:
    if "_reparam_hooks" not in module.__dict__:
        module._reparam_hooks = {}
    return module._reparam_hooks


def _apply_module(module: nn.Module, reparam: Reparameterization,
                  name: str, filter_fn: Callable) -> nn.Module:
    for m in module.modules():
        for k, p in list(m._parameters.items()):
            if p is None or not (name == "" or k == name) \
                    or not filter_fn(k, p):
                continue
            aux = reparam.reparameterize(k, p.detach())
            del m._parameters[k]
            for ak, av in aux.items():
                m.register_parameter(ak, nn.Parameter(
                    av, requires_grad=p.requires_grad))
            hook = _Hook(k, reparam)
            hook.handle = m.register_forward_pre_hook(hook)
            _hooks(m)[k] = hook
            hook(m, ())
    return module


def _remove_module(module: nn.Module,
                   reparam: Reparameterization) -> nn.Module:
    for m in module.modules():
        hooks = m.__dict__.get("_reparam_hooks", {})
        for k, hook in list(hooks.items()):
            if not isinstance(hook.reparam, type(reparam)):
                continue
            g = m._parameters[k + G_SUFFIX]
            with torch.no_grad():
                w = hook.compute(m)
            hook.handle.remove()
            del hooks[k], m._parameters[k + G_SUFFIX], \
                m._parameters[k + V_SUFFIX]
            m.__dict__.pop(k, None)
            m.register_parameter(k, nn.Parameter(
                w, requires_grad=g.requires_grad))
    return module


def _walk(params: Mapping, leaf_fn: Callable) -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = _walk(v, leaf_fn)
        else:
            out.update(leaf_fn(params, k, v))
    return out


def apply_reparameterization(params: Any, reparam: Reparameterization,
                             name: str = "",
                             filter_fn: Callable[[str, Any], bool]
                             = default_filter) -> Any:
    """Replace the selected leaves (``name=""``: every leaf passing
    ``filter_fn``; else only leaves of that key) by their decomposition:
    a new nested dict where each selected ``k`` is ``k_g`` / ``k_v``
    (dict form), or ``params`` itself, an ``nn.Module`` reparameterized
    in place (module form)."""
    if isinstance(params, nn.Module):
        return _apply_module(params, reparam, name, filter_fn)

    def leaf(node, k, v):
        if (name == "" or k == name) and filter_fn(k, v):
            return reparam.reparameterize(k, v)
        return {k: v}

    return _walk(params, leaf)


def merge(params: Mapping, reparam: Reparameterization) -> dict:
    """Every decomposed leaf of the dict form recomputed (``k_g`` /
    ``k_v`` -> ``k``); other leaves pass through."""
    def leaf(node, k, v):
        if k.endswith(G_SUFFIX) and k[:-len(G_SUFFIX)] + V_SUFFIX in node:
            base = k[:-len(G_SUFFIX)]
            vk = base + V_SUFFIX
            return {base: reparam.compute_weight(base, {k: v,
                                                        vk: node[vk]})}
        if k.endswith(V_SUFFIX) and k[:-len(V_SUFFIX)] + G_SUFFIX in node:
            return {}                 # consumed with its _g partner
        return {k: v}

    return _walk(params, leaf)


def remove_reparameterization(params: Any,
                              reparam: Reparameterization) -> Any:
    """The current effective weights baked back into plain parameters
    (the reference's ``remove``, ``reparameterization.py:127-137``): the
    dict form merged, or the module form's hooks of ``reparam``'s kind
    removed, each weight computed by the reparameterization it was
    applied with."""
    if isinstance(params, nn.Module):
        return _remove_module(params, reparam)
    return merge(params, reparam)


def reparameterized_apply(apply_fn: Callable, reparam: Reparameterization
                          ) -> Callable:
    """``apply_fn(params, ...)`` taking decomposed params: they are
    merged first, inside the call, so gradients reach ``k_g`` / ``k_v``.
    A dict with a ``"params"`` entry (flax's variables) has that entry
    merged."""
    def wrapped(variables, *args, **kwargs):
        if isinstance(variables, Mapping) and "params" in variables:
            merged = dict(variables)
            merged["params"] = merge(variables["params"], reparam)
        else:
            merged = merge(variables, reparam)
        return apply_fn(merged, *args, **kwargs)

    return wrapped
