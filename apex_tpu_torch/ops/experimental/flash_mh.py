"""Multi-head flash attention on the native ``(B, L, H, D)`` layout, as
``apex_tpu/ops/pallas/experimental/flash_mh.py``'s
``flash_attention_mh``: the forward is K17 and the backward K18 (or,
above the partials budget, K13 / K14), through
:mod:`apex_tpu_torch.ops.cuda.flash_mh`."""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.cuda.flash_mh import flash_mh_bwd, flash_mh_fwd


class FlashAttentionMH(torch.autograd.Function):
    """``(o, lse)`` of :func:`~apex_tpu_torch.ops.cuda.flash_mh.
    flash_mh_fwd`; the backward is :func:`~apex_tpu_torch.ops.cuda.
    flash_mh.flash_mh_bwd` with both cotangents (the JAX custom VJP's
    ``_mh_bwd_rule``), and no gradient for the mask or the options."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal):
        o, lse = flash_mh_fwd(q, k, v, causal=causal, kv_mask=kv_mask,
                              scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse,
                                  causal=ctx.causal, kv_mask=kv_mask,
                                  scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_mh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = False,
                       kv_mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None,
                       return_lse: bool = False):
    """Exact attention of ``(B, L, H, D)`` q, k, v read in their native
    layout (no transposed copy): ``o`` in q's dtype, or ``(o, lse (B, L,
    H) fp32)`` with ``return_lse``.  Requirements as the JAX
    function's: Lq == Lk and D a multiple of 8.  ``kv_mask (B, L)`` bool,
    True = attend; ``scale`` defaults to ``1 / sqrt(D)`` and multiplies q
    in its own dtype.  Differentiable in q, k and v, through the lse
    too."""
    b, l, h, d = q.shape
    if d % 8:
        raise ValueError(f"head_dim {d} must be a multiple of 8")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_mh: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want one "
                         f"shape (self-attention, Lq == Lk)")
    if scale is None:
        scale = 1.0 / d ** 0.5
    o, lse = FlashAttentionMH.apply(q, k, v, kv_mask, float(scale),
                                    bool(causal))
    return (o, lse) if return_lse else o
