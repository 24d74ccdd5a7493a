"""Attention, as ``apex_tpu/attention``.

:func:`local_attention` is the ``axis_name=None`` branch of the JAX
package's ``attention``: exact attention over ``(B, L, H, D)`` through
the flash kernels of :mod:`apex_tpu_torch.ops.cuda` (the CUDA kernels on
the card, their plain versions on the CPU), differentiable through
:class:`FlashAttention`, the counterpart of the JAX package's ``_flash``
custom VJP.  Its backward is the fused flash backward (K4), or the
two-pass one (K13 for dq, K14 for dk / dv) where K4's fp32 dq partial
planes would exceed ``APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES`` (1 GiB by
default), as the JAX package routes it.

:mod:`~apex_tpu_torch.attention.ring` holds the sequence-parallel
engines (:func:`ring_attention`, :func:`ulysses_attention`) and the
dispatcher :func:`attention`, which is :func:`local_attention` when no
``axis_name`` is given."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda import flash_attn_bwd, flash_attn_fwd
from apex_tpu_torch.ops.rope import KernelRopeTables


class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of the flash forward; the backward is
    :func:`~apex_tpu_torch.ops.cuda.flash_attn_bwd`, the fused backward
    or, above the partials budget, the two-pass one, with the semantics
    of ``_flash_fwd_rule`` / ``_flash_bwd_rule``: it saves the unrotated
    q, k, v (the kernels pre-scale and rotate q and k again on load, as
    they did in the forward) with o and lse, returns dq with the one
    deferred scale, dk and dv as they come out, and no gradient for the
    mask, the rope tables or the options."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, cos_t, sin_t, scale, causal):
        rope = None if cos_t is None else (cos_t, sin_t)
        o, lse = flash_attn_fwd(q, k, v, causal=causal, kv_mask=kv_mask,
                                scale=scale, return_lse=True, rope=rope)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask, cos_t, sin_t)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_mask, cos_t, sin_t = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        rope = None if cos_t is None else (cos_t, sin_t)
        dq, dk, dv = flash_attn_bwd(q, k, v, o, lse, do, dlse=dlse,
                                    causal=ctx.causal, kv_mask=kv_mask,
                                    scale=ctx.scale, rope=rope)
        return dq, dk, dv, None, None, None, None, None


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, return_lse: bool = False,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    = None, layout: str = "blhd"):
    """``o (B, L, H, D)`` in q's dtype, or ``(o, lse (B, L, H) fp32)``
    with ``return_lse``.  ``layout="bhld"`` takes and returns ``(B, H,
    L, D)`` tensors, as the JAX ``flash_attention`` does: they reach the
    kernels as permuted views (the kernels read through strides, so the
    forward copies nothing) and the lse stays ``(B, L, H)``.  ``kv_mask (B, Lk)`` bool, True = attend; a row
    that sees no key gives zeros and ``lse = -1e30``.  ``scale``
    defaults to ``1 / sqrt(D)``.  ``rope``: full-width kernel tables
    (:class:`~apex_tpu_torch.ops.rope.KernelRopeTables` or a ``(cos_full,
    sin_signed)`` pair, ``(B, L, D)``), cast to q's dtype and applied to
    the unrotated q and k inside the kernels; gradients are w.r.t. the
    unrotated inputs.  Differentiable; under ``torch.no_grad`` (or when
    nothing requires grad) it is one forward kernel call and no autograd
    node."""
    if layout not in ("blhd", "bhld"):
        raise ValueError(f"layout {layout!r}: want 'blhd' or 'bhld'")
    if layout == "bhld":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    cos_t = sin_t = None
    if rope is not None:
        if isinstance(rope, KernelRopeTables):
            rope = (rope.cos_full, rope.sin_signed)
        cos_t, sin_t = (t.to(q.dtype) for t in rope)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        out = flash_attn_fwd(q, k, v, causal=causal, kv_mask=kv_mask,
                             scale=scale, return_lse=return_lse,
                             rope=None if cos_t is None else (cos_t, sin_t))
        o, lse = out if return_lse else (out, None)
    else:
        o, lse = FlashAttention.apply(q, k, v, kv_mask, cos_t, sin_t,
                                      float(scale), bool(causal))
    if layout == "bhld":
        o = o.transpose(1, 2)
    return (o, lse) if return_lse else o


# the dispatcher and the sequence-parallel engines read local_attention
from apex_tpu_torch.attention.ring import (  # noqa: E402
    attention,
    ring_attention,
    ulysses_attention,
)

__all__ = ["FlashAttention", "attention", "local_attention",
           "ring_attention", "ulysses_attention"]
