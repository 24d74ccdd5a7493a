"""K17 and K18: the multi-head flash-attention forward and fused backward
(``csrc/flash_fwd_sm90.cu``, K2's Hopper kernel, and
``csrc/flash_bwd_fused_sm90.cu``, K4's Hopper kernel, with its finish
pass) of ``apex_tpu/ops/pallas/experimental/flash_mh.py``, each beside its
plain PyTorch version.

The semantics are the JAX module's (``_mh_core``, ``_mh_bwd_rule``): q is
multiplied by ``scale`` in its own dtype before the kernels (the scale
rounded to that dtype), the scores, the online softmax and the lse are
fp32, a key mask hides keys, a row that sees no key gives zeros and lse
``NEG_INF``; the backward recomputes the probabilities from the lse, uses
``delta = rowsum(o * do) - dlse`` per head (so a cotangent on the lse
reaches the inputs), returns dk from the pre-scaled q and dq cast to q's
dtype, then times the scale in that dtype.  :func:`flash_mh_bwd` takes
K18 while its fp32 dq partial planes (:func:`mh_partials_bytes`, the JAX
rule's ``partials_bytes`` at the port's 64-key tile) fit
:func:`~apex_tpu_torch.ops.cuda.flash_attention.fused_bwd_max_bytes`,
else the two-pass kernels K13 / K14 on strided views of the pre-scaled q
(the JAX rule's fallback, without its relayout).

On CUDA tensors the tensor-core kernels (K17, K18, K13 / K14) take bf16
and fp16, D a multiple of 8 up to 128; fp32 at any D, and half types above
D 128, take the generic kernels (``flash_fwd_simt``, ``flash_bwd_simt``)
up to D 512, by the routes of :mod:`~apex_tpu_torch.ops.cuda.
flash_attention`; Lq == Lk, any strides with unit stride over D (16-byte
aligned rows in half types); anything else raises.  On CPU tensors each
wrapper runs its plain version; none falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda.flash_attention import (
    BWD_KEY_TILE,
    _bwd_operands,
    _check_bwd,
    _default_scale,
    _fused_pass,
    _fwd_launch,
    _fwd_operands,
    _half_scale,
    _simt_bwd,
    _simt_fwd,
    attn_delta,
    bwd_route,
    flash_attn_bwd_ref,
    flash_attn_fwd_ref,
    fused_bwd_max_bytes,
    fwd_route,
    two_pass_bwd,
)


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` in q's dtype (the scale itself rounded to it), the
    JAX wrapper's ``q3 * jnp.asarray(scale, q3.dtype)``."""
    return q * torch.tensor(scale, dtype=q.dtype)


def flash_mh_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = False,
                     kv_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o (B, L, H, D) in q's dtype, lse (B, L, H) fp32)`` of the
    pre-scaled q, by materialising the fp32 scores."""
    qf = _scaled_q(q, _default_scale(q, scale))
    return flash_attn_fwd_ref(qf, k, v, causal=causal, kv_mask=kv_mask,
                              scale=1.0)


def flash_mh_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = False,
                 kv_mask: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_mh_fwd_ref`'s function: on CUDA tensors, for bf16 /
    fp16 up to D 128, one launch of K17 (K2's Hopper kernel, which
    pre-scales q in its own dtype; counted in ``flash_mh_fwd.launches``),
    else the generic kernel (counted in ``flash_fwd_simt.launches``); on
    CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_mh_fwd_ref(q, k, v, causal=causal, kv_mask=kv_mask,
                                scale=scale)
    what = "flash_mh_fwd"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() == 4 and fwd_route(q.dtype, q.shape[-1]) == "simt":
        return _simt_fwd(what, q, k, v, kv_mask, causal, scale, None, True)
    o, lse = _fwd_launch(_fwd_operands(what, q, k, v, kv_mask, causal,
                                       scale, None), True)
    flash_mh_fwd.launches += 1
    return o, lse


flash_mh_fwd.launches = 0


def mh_partials_bytes(b: int, l: int, h: int, d: int) -> int:
    """Bytes of K18's fp32 dq partial planes: one ``(b, l, h, d)`` plane
    per 64-key tile (the JAX rule's ``(lp // block_k) * b * lp * hd *
    4``), growing with ``l**2``."""
    return -(-l // BWD_KEY_TILE) * b * l * h * d * 4


def mh_fused_bwd(q: torch.Tensor) -> bool:
    """Whether :func:`flash_mh_bwd` keeps to one pass for ``q``: its planes
    fit :func:`fused_bwd_max_bytes` (the gate of ``_mh_bwd_rule``).  On
    the card that pass is K18 in bf16 / fp16 up to D 128, the generic
    kernels otherwise (:func:`mh_bwd_route`)."""
    return mh_partials_bytes(*q.shape) <= fused_bwd_max_bytes()


def mh_bwd_route(dtype: torch.dtype, d: int, partials_bytes: int,
                 budget: int) -> str:
    """The kernels :func:`flash_mh_bwd` takes on the card: ``"simt"`` for
    fp32 and for half types above D 128, else ``"fused"`` (K18, any width
    that is a multiple of 8 up to 128) while the planes fit ``budget``,
    else ``"two_pass"`` (K13 + K14): :func:`bwd_route`'s table."""
    return bwd_route(dtype, d, partials_bytes, budget)


def flash_mh_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     *, dlse: Optional[torch.Tensor] = None,
                     causal: bool = False,
                     kv_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_mh_fwd_ref` for the cotangents
    ``do`` and ``dlse`` (None: zero), by materialising the scores."""
    scale = _default_scale(q, scale)
    qf = _scaled_q(q, scale)
    dq, dk, dv = flash_attn_bwd_ref(qf, k, v, o, lse, do, dlse=dlse,
                                    causal=causal, kv_mask=kv_mask,
                                    scale=1.0)
    return dq * torch.tensor(scale, dtype=dq.dtype), dk, dv


def flash_mh_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                 dlse: Optional[torch.Tensor] = None, causal: bool = False,
                 kv_mask: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_mh_bwd_ref`'s function, by the route the JAX rule
    picks (:func:`mh_bwd_route` on the card): while :func:`mh_fused_bwd`,
    on CUDA tensors the prologue (q pre-scaled in its dtype, counted in
    ``flash_bwd_prologue.launches``), one launch of K18 (K4's kernel,
    counted in ``flash_mh_bwd.launches``) and the finish pass, which sums
    its partial planes in a fixed order (no atomics: two runs give equal
    bits) and applies the scale in q's dtype; or, for fp32 and half types
    above D 128, the generic kernels (``flash_bwd_simt``); above the
    budget the two-pass kernels K13 then K14 (counted under their own
    names) on the pre-scaled q, with no prologue launch (no rope, scale
    1).  On CPU tensors the same routes run their plain versions."""
    scale = _default_scale(q, scale)
    scale_t = torch.tensor(scale, dtype=q.dtype)
    fused = mh_fused_bwd(q)
    if q.device.type == "cpu":
        if fused:
            return flash_mh_bwd_ref(q, k, v, o, lse, do, dlse=dlse,
                                    causal=causal, kv_mask=kv_mask,
                                    scale=scale)
        route = "two_pass"
    else:
        what = "flash_mh_bwd"
        if q.device.type != "cuda":
            raise ValueError(f"{what}: unsupported device {q.device}")
        if q.dim() != 4:
            raise ValueError(f"{what}: q must be (B, L, H, D), got "
                             f"{tuple(q.shape)}")
        route = mh_bwd_route(q.dtype, q.shape[-1], mh_partials_bytes(
            *q.shape), fused_bwd_max_bytes())
    if route == "two_pass":
        dq, dk, dv = two_pass_bwd(_scaled_q(q, scale), k, v, do, lse,
                                  attn_delta(o, do, dlse), causal=causal,
                                  kv_mask=kv_mask, scale=1.0)
        return dq * scale_t, dk, dv
    delta = attn_delta(o, do, dlse)
    if route == "fused":
        return _fused_pass(_bwd_operands(what, q, k, v, do, lse, delta,
                                         causal, kv_mask, scale, None),
                           flash_mh_bwd)
    do, lse, delta, mask, _, _ = _check_bwd(what, q, k, v, do, lse, delta,
                                            kv_mask, None)
    dq, dk, dv = _simt_bwd(what, q, k, v, do, lse, delta, mask, None, None,
                           _half_scale(scale, q.dtype), causal)
    return dq.to(q.dtype) * scale_t, dk, dv


flash_mh_bwd.launches = 0
