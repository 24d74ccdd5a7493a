"""K1: the layer-norm forward kernel (``csrc/layer_norm_fwd.cu``) and its
plain PyTorch version.

The CUDA kernel replaces the Pallas forward
``apex_tpu/ops/pallas/layer_norm_kernels.py`` ``_forward``
(``_fwd_kernel``).  :func:`layer_norm_fwd` launches it for a CUDA tensor
and runs :func:`layer_norm_fwd_ref` for a CPU tensor; it never falls back
from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_fwd_ref(x2d: torch.Tensor, weight: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor], eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, inv)``: per row of ``x2d (n1, n2)`` the fp32 mean, the
    centred variance, ``inv = rsqrt(var + eps)``, and ``y = (x - mean) *
    inv * w + b`` in fp32 cast to x's dtype; ``mean``/``inv`` are
    ``(n1,)`` fp32."""
    x = x2d.float()
    mean = x.mean(dim=1, keepdim=True)
    xc = x - mean
    inv = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * inv
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2d.dtype), mean[:, 0], inv[:, 0]


def layer_norm_fwd(x2d: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`layer_norm_fwd_ref`'s function; on a CUDA tensor, one launch
    of the hand-written kernel (counted in ``layer_norm_fwd.launches``)."""
    if x2d.device.type == "cpu":
        return layer_norm_fwd_ref(x2d, weight, bias, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x2d.device}")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError("layer_norm_fwd: x must be a contiguous (n1, n2) "
                         f"tensor, got shape {tuple(x2d.shape)}")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fwd: x dtype {x2d.dtype} unsupported")
    n1, n2 = x2d.shape
    if (weight is None) != (bias is None):
        raise ValueError("layer_norm_fwd: give both weight and bias or "
                         "neither")
    w_code = 0
    if weight is not None:
        for name, t in (("weight", weight), ("bias", bias)):
            if t.shape != (n2,) or not t.is_contiguous() \
                    or t.device != x2d.device:
                raise ValueError(f"layer_norm_fwd: {name} must be a "
                                 f"contiguous ({n2},) tensor on "
                                 f"{x2d.device}")
        if weight.dtype != bias.dtype or weight.dtype not in (
                torch.float32, x2d.dtype):
            raise TypeError("layer_norm_fwd: weight/bias must share a dtype, "
                            "float32 or x's")
        w_code = _DTYPES[weight.dtype]
    build.refuse_grad("layer_norm_fwd", x2d, weight, bias)
    y = torch.empty_like(x2d)
    mean = torch.empty(n1, dtype=torch.float32, device=x2d.device)
    inv = torch.empty(n1, dtype=torch.float32, device=x2d.device)
    if n1 == 0:
        return y, mean, inv
    lib = build.library()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_layer_norm_fwd(
            x2d.data_ptr(),
            None if weight is None else weight.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(), mean.data_ptr(), inv.data_ptr(), n1, n2,
            float(eps), _DTYPES[x2d.dtype], w_code, stream)
    build.check(err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, inv


layer_norm_fwd.launches = 0
