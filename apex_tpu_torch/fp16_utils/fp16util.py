"""Dtype-conversion and master-parameter utilities, as ``apex_tpu/
fp16_utils/fp16util.py`` (the reference's ``apex/fp16_utils/fp16util.py``).

A "tree" is a tensor or a nested dict / list / tuple of them (the JAX
package's pytrees); the conversions also take an ``nn.Module``, whose
parameters they cast in place.  The fused copies run through
``multi_tensor_applier(multi_tensor_scale, ...)`` (K6 on the card) and
the gradient norm through ``multi_tensor_l2norm`` (K9).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn

from apex_tpu_torch.amp.frontend import default_keep_fp32_filter
from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops.multi_tensor import (
    multi_tensor_l2norm,
    multi_tensor_scale,
)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _names(path) -> tuple:
    """A pytree key path as the dict keys and sequence indices on it."""
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


def _cast(tree: Any, cast: Callable) -> Any:
    """``cast(path, leaf) -> dtype or None`` applied to a tree (new
    tensors) or to a module's parameters (in place, returning it)."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                dt = cast(tuple(name.split(".")), p) if _is_float(p) \
                    else None
                if dt is not None and p.dtype != dt:
                    p.data = p.data.to(dt)
        return tree

    def leaf(path, x):
        dt = cast(_names(path), x) if _is_float(x) else None
        return x if dt is None else x.to(dt)
    return pytree.tree_map_with_path(leaf, tree)


def tree_to_half(params: Any, half_dtype: torch.dtype = torch.bfloat16
                 ) -> Any:
    """Cast every floating leaf to the half dtype (the reference's
    ``tofp16`` / ``network_to_half``)."""
    return _cast(params, lambda _p, _x: half_dtype)


def tree_to_float(params: Any) -> Any:
    """Cast every floating leaf to fp32."""
    return _cast(params, lambda _p, _x: torch.float32)


def convert_network(params: Any, dtype: torch.dtype,
                    keep_fp32_filter: Callable = default_keep_fp32_filter
                    ) -> Any:
    """Batchnorm-safe conversion: floating leaves to ``dtype`` except
    those on normalization paths, which stay fp32."""
    return _cast(params, lambda path, _x: torch.float32
                 if keep_fp32_filter(path) else dtype)


def BN_convert_float(params: Any,
                     keep_fp32_filter: Callable = default_keep_fp32_filter
                     ) -> Any:
    """Force normalization-path leaves back to fp32."""
    return _cast(params, lambda path, _x: torch.float32
                 if keep_fp32_filter(path) else None)


def convert_module(params: Any, dtype: torch.dtype) -> Any:
    """Cast one module's parameters (or a tree) to ``dtype``
    unconditionally."""
    return tree_to_half(params, dtype)


class FP16Model(nn.Module):
    """A network run in half precision: its floating parameters are cast
    to ``half_dtype`` (``network_to_half``) and so are the floating tensor
    inputs of ``forward``; other arguments pass as they are."""

    def __init__(self, network: nn.Module,
                 half_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.half_dtype = half_dtype
        self.network = tree_to_half(network, half_dtype)

    def forward(self, *args, **kwargs):
        args, kwargs = pytree.tree_map(
            lambda x: x.to(self.half_dtype) if _is_float(x) else x,
            (args, kwargs))
        return self.network(*args, **kwargs)


def prep_param_lists(params: Any, flat_master: bool = False
                     ) -> Tuple[Any, Any]:
    """``(params, master)``: ``master`` an fp32 copy of the tree, or with
    ``flat_master`` ``(flat_vector, unravel)``, the floating leaves in one
    fp32 vector and ``unravel(vec)`` the tree with those leaves as views
    of ``vec`` (other leaves pass through)."""
    leaves, spec = pytree.tree_flatten(params)
    if flat_master:
        float_idx = [i for i, x in enumerate(leaves) if _is_float(x)]
        if not float_idx:
            raise ValueError("no floating params to build a flat master "
                             "from")
        with torch.no_grad():
            flat = torch.cat([leaves[i].detach().reshape(-1).float()
                              for i in float_idx])
        shapes = [leaves[i].shape for i in float_idx]
        sizes = [leaves[i].numel() for i in float_idx]

        def unravel(vec: torch.Tensor) -> Any:
            out = list(leaves)
            for i, part, s in zip(float_idx, vec.split(sizes), shapes):
                out[i] = part.view(s)
            return pytree.tree_unflatten(out, spec)

        return params, (flat, unravel)
    with torch.no_grad():
        master = pytree.tree_map(
            lambda x: x.detach().to(torch.float32, copy=True)
            if _is_float(x) else x, params)
    return params, master


def model_grads_to_master_grads(model_grads: Any) -> Any:
    """Half model gradients to fp32 master gradients in one fused pass."""
    leaves, spec = pytree.tree_flatten(model_grads)
    outs, _ = multi_tensor_applier(multi_tensor_scale, [leaves], 1.0,
                                   out_dtype=torch.float32)
    return pytree.tree_unflatten(outs, spec)


def master_params_to_model_params(master_params: Any,
                                  model_dtype: torch.dtype) -> Any:
    """fp32 masters to model-dtype parameters in one fused pass."""
    leaves, spec = pytree.tree_flatten(master_params)
    outs, _ = multi_tensor_applier(multi_tensor_scale, [leaves], 1.0,
                                   out_dtype=model_dtype)
    return pytree.tree_unflatten(outs, spec)


def to_python_float(t) -> float:
    """A host scalar: a device sync, never inside the hot loop."""
    return float(t)


def clip_grad_norm(grads: Any, max_norm: float, norm_type: float = 2.0
                   ) -> Tuple[Any, torch.Tensor]:
    """Global-norm clipping: ``(clipped grads, norm)``, each leaf scaled
    by ``min(1, max_norm / (norm + 1e-6))`` in fp32 and cast back to its
    dtype.  The 2-norm comes from ``multi_tensor_l2norm`` (K9)."""
    leaves, spec = pytree.tree_flatten(grads)
    if norm_type == 2.0:
        norm, _ = multi_tensor_applier(multi_tensor_l2norm, [leaves])
    else:
        norm = sum((l.float().abs() ** norm_type).sum()
                   for l in leaves) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return pytree.tree_unflatten([(l.float() * scale).to(l.dtype)
                                  for l in leaves], spec), norm
