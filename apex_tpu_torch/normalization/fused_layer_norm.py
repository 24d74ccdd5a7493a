"""FusedLayerNorm: fp32 statistics and affine, output in the input dtype,
as ``apex_tpu/normalization/fused_layer_norm.py``.

The input is viewed as ``(n1, n2)`` around ``normalized_shape`` and goes
to :func:`apex_tpu_torch.ops.cuda.layer_norm_fwd` (the CUDA kernel on
the card, its plain version on the CPU); the gradient is
:class:`LayerNormFunction`, whose backward is
:func:`apex_tpu_torch.ops.cuda.layer_norm_bwd` (the counterpart of the
JAX package's ``_ln_affine`` / ``_ln_plain`` custom VJPs).  Every width
is taken: the kernels have no counterpart of the TPU path's ``n2 % 128``
and VMEM caps.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.ops.cuda import layer_norm_bwd, layer_norm_fwd

Shape = Union[int, Sequence[int]]


def _normalized_shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


class LayerNormFunction(torch.autograd.Function):
    """Layer norm of ``x2d (n1, n2)`` with an optional affine: saves
    ``(x2d, w, mean, inv)`` from the forward kernel; the backward kernel
    returns dx in x's dtype and dw, db in the weight's dtype."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps):
        y, mean, inv = layer_norm_fwd(x2d, weight, bias, eps)
        ctx.save_for_backward(x2d, weight, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, inv = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy.contiguous(), x2d, weight, mean, inv)
        return dx, dw, db, None


def fused_layer_norm_affine(x: torch.Tensor, weight: Optional[torch.Tensor],
                            bias: Optional[torch.Tensor],
                            normalized_shape: Shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """Affine layer norm over the trailing ``normalized_shape`` dims.
    Differentiable; under ``torch.no_grad`` (or when nothing requires
    grad) it is one forward kernel call and no autograd node."""
    nshape = _normalized_shape(normalized_shape)
    if tuple(x.shape[x.dim() - len(nshape):]) != nshape:
        raise ValueError(f"trailing dims of {tuple(x.shape)} must equal "
                         f"normalized_shape {nshape}")
    n2 = 1
    for d in nshape:
        n2 *= d
    x2d = x.reshape(-1, n2).contiguous()
    w = None if weight is None else weight.reshape(n2)
    b = None if bias is None else bias.reshape(n2)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2d, w, b)):
        y = LayerNormFunction.apply(x2d, w, b, eps)
    else:
        y, _mean, _inv = layer_norm_fwd(x2d, w, b, eps)
    return y.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, normalized_shape: Shape,
                     eps: float = 1e-5) -> torch.Tensor:
    """Non-affine layer norm."""
    return fused_layer_norm_affine(x, None, None, normalized_shape, eps)


class FusedLayerNorm(nn.Module):
    """Affine layer norm with parameters named as the flax module names
    them: ``scale`` (initialised to 1) and ``bias`` (0)."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.normalized_shape = _normalized_shape(normalized_shape)
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(
            self.normalized_shape, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(
            self.normalized_shape, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm_affine(x, self.scale, self.bias,
                                       self.normalized_shape, self.eps)
