"""K1 and K3: the layer-norm forward and backward kernels
(``csrc/layer_norm_fwd.cu``, ``csrc/layer_norm_bwd.cu``) and their plain
PyTorch versions.

The CUDA kernels replace the Pallas ``_forward`` (``_fwd_kernel``) and
``_backward`` (``_bwd_kernel``) of
``apex_tpu/ops/pallas/layer_norm_kernels.py``.  :func:`layer_norm_fwd` and
:func:`layer_norm_bwd` launch them for CUDA tensors and run
:func:`layer_norm_fwd_ref` / :func:`layer_norm_bwd_ref` for CPU tensors;
they never fall back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
    y = torch.empty_like(x2d)
    mean = torch.empty(n1, dtype=torch.float32, device=x2d.device)
    inv = torch.empty(n1, dtype=torch.float32, device=x2d.device)
    if n1 == 0:
        return y, mean, inv
    err = build.library().apex_layer_norm_fwd(
        x2d.data_ptr(), None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), n1, n2, float(eps),
        _DTYPES[x2d.dtype], w_code, build.stream_of(x2d))
    build.check(err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, inv


layer_norm_fwd.launches = 0


def layer_norm_bwd_ref(dy: torch.Tensor, x2d: torch.Tensor,
                       weight: Optional[torch.Tensor], mean: torch.Tensor,
                       inv: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """``(dx, dw, db)`` of :func:`layer_norm_fwd_ref` for the cotangent
    ``dy (n1, n2)``, given its ``(n1,)`` fp32 ``mean``/``inv``: in fp32,
    ``xhat = (x - mean) * inv``, ``wdy = dy * w``, ``dx = inv * (wdy -
    mean(wdy) - xhat * mean(wdy * xhat))`` cast to x's dtype; ``dw =
    sum_rows(dy * xhat)`` and ``db = sum_rows(dy)`` cast to w's dtype
    (``None`` without a weight)."""
    d = dy.float()
    xhat = (x2d.float() - mean[:, None]) * inv[:, None]
    wdy = d if weight is None else d * weight.float()
    m1 = wdy.mean(dim=1, keepdim=True)
    m2 = (wdy * xhat).mean(dim=1, keepdim=True)
    dx = (inv[:, None] * (wdy - m1 - xhat * m2)).to(x2d.dtype)
    if weight is None:
        return dx, None, None
    return (dx, (d * xhat).sum(dim=0).to(weight.dtype),
            d.sum(dim=0).to(weight.dtype))


def layer_norm_bwd(dy: torch.Tensor, x2d: torch.Tensor,
                   weight: Optional[torch.Tensor], mean: torch.Tensor,
                   inv: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """:func:`layer_norm_bwd_ref`'s function; on CUDA tensors the
    hand-written kernels, bitwise repeatable: dx with per-block dw/db
    partials, then (with a weight) their fixed-order sum, two launches
    counted in ``layer_norm_bwd.launches`` (one without a weight)."""
    if x2d.device.type == "cpu":
        return layer_norm_bwd_ref(dy, x2d, weight, mean, inv)
    if x2d.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: unsupported device {x2d.device}")
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.dtype not in _DTYPES:
        raise ValueError("layer_norm_bwd: x must be a contiguous (n1, n2) "
                         "float32, bfloat16 or float16 tensor")
    n1, n2 = x2d.shape
    if dy.shape != x2d.shape or dy.dtype != x2d.dtype \
            or dy.device != x2d.device or not dy.is_contiguous():
        raise ValueError("layer_norm_bwd: dy must match x (shape, dtype, "
                         "device, contiguous)")
    for name, t in (("mean", mean), ("inv", inv)):
        if t.shape != (n1,) or t.dtype != torch.float32 \
                or t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"layer_norm_bwd: {name} must be a contiguous "
                             f"({n1},) float32 tensor on {x2d.device}")
    dx = torch.empty_like(x2d)
    dw = db = part_w = part_b = None
    w_code = 0
    lib = build.library()
    if weight is not None:
        if weight.shape != (n2,) or not weight.is_contiguous() \
                or weight.device != x2d.device \
                or weight.dtype not in (torch.float32, x2d.dtype):
            raise ValueError("layer_norm_bwd: weight must be a contiguous "
                             f"({n2},) tensor, float32 or x's dtype")
        w_code = _DTYPES[weight.dtype]
        dw = torch.empty_like(weight)
        db = torch.empty_like(weight)
        parts = lib.apex_layer_norm_bwd_parts(n1, n2)
        part_w = torch.empty((parts, n2), dtype=torch.float32,
                             device=x2d.device)
        part_b = torch.empty_like(part_w)
    if n1 == 0:
        if dw is not None:
            dw.zero_()
            db.zero_()
        return dx, dw, db

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = lib.apex_layer_norm_bwd(
        dy.data_ptr(), x2d.data_ptr(), ptr(weight), mean.data_ptr(),
        inv.data_ptr(), dx.data_ptr(), ptr(dw), ptr(db), ptr(part_w),
        ptr(part_b), n1, n2, _DTYPES[x2d.dtype], w_code,
        build.stream_of(x2d))
    build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1 if weight is None else 2
    return dx, dw, db


layer_norm_bwd.launches = 0
