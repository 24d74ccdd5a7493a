"""Weight normalization, ``w = g · v / ‖v‖`` (Salimans and Kingma,
arXiv:1602.07868), as ``apex_tpu/reparameterization/weight_norm.py``.

``dim`` is the axis kept (one norm a slice along it); the norm reduces
over every other axis.  Kernels are ``(in, out)``, so the default
``dim=-1`` gives one norm an output column; ``dim=None`` takes one norm
over the whole tensor.  Norms are taken in fp32 with ``eps`` inside the
square root; ``w`` is computed in fp32 and cast to ``v``'s dtype; ``g``
starts at ``‖w‖`` in ``w``'s dtype, so that applying and merging gives
the weights back.  Both forms of
:mod:`~apex_tpu_torch.reparameterization.reparameterization` take it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from apex_tpu_torch.reparameterization.reparameterization import (
    G_SUFFIX,
    V_SUFFIX,
    Reparameterization,
    apply_reparameterization,
    default_filter,
    remove_reparameterization,
)


def _norm_axes(ndim: int, dim: Optional[int]) -> Tuple[int, ...]:
    if dim is None:
        return tuple(range(ndim))
    dim = dim % ndim
    return tuple(a for a in range(ndim) if a != dim)


def _sumsq(t: torch.Tensor, axes) -> torch.Tensor:
    t = t.float()
    return torch.sum(t * t, dim=axes, keepdim=True)


@dataclasses.dataclass(frozen=True)
class WeightNorm(Reparameterization):
    """The ``g`` / ``v`` decomposition over the axes other than ``dim``,
    with norms in fp32."""

    dim: Optional[int] = -1
    eps: float = 0.0

    def reparameterize(self, name: str, weight: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        g = torch.sqrt(_sumsq(weight, _norm_axes(weight.dim(), self.dim)))
        return {name + G_SUFFIX: g.to(weight.dtype), name + V_SUFFIX: weight}

    def compute_weight(self, name: str, aux: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        g, v = aux[name + G_SUFFIX], aux[name + V_SUFFIX]
        norm = torch.sqrt(_sumsq(v, _norm_axes(v.dim(), self.dim))
                          + self.eps)
        return (g.float() * v.float() / norm).to(v.dtype)


def apply_weight_norm(params: Any, name: str = "", dim: Optional[int] = -1,
                      filter_fn: Callable = default_filter) -> Any:
    """Decompose the selected leaves into ``*_g`` / ``*_v``
    (``name=""``: every floating leaf of at least 2 dimensions): a new
    dict (dict form) or the module, hooked in place (module form)."""
    return apply_reparameterization(params, WeightNorm(dim=dim), name=name,
                                    filter_fn=filter_fn)


def remove_weight_norm(params: Any, dim: Optional[int] = -1) -> Any:
    """The current effective weights baked back into plain parameters;
    the module form bakes each with the ``dim`` it was applied with."""
    return remove_reparameterization(params, WeightNorm(dim=dim))
