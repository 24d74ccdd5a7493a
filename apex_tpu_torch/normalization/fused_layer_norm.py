"""FusedLayerNorm: fp32 statistics and affine, output in the input dtype,
as ``apex_tpu/normalization/fused_layer_norm.py``.

The input is viewed as ``(n1, n2)`` around ``normalized_shape`` and goes
to :func:`apex_tpu_torch.ops.cuda.layer_norm_fwd` (the CUDA kernel on
the card, its plain version on the CPU).  Every width is taken: the
kernel has no counterpart of the TPU path's ``n2 % 128`` and VMEM caps.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.ops.cuda import layer_norm_fwd

Shape = Union[int, Sequence[int]]


def _normalized_shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def fused_layer_norm_affine(x: torch.Tensor, weight: Optional[torch.Tensor],
                            bias: Optional[torch.Tensor],
                            normalized_shape: Shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """Affine layer norm over the trailing ``normalized_shape`` dims."""
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
