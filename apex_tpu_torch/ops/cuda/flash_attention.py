"""K2 and K4: the flash-attention forward and backward kernels
(``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``) and their plain
PyTorch versions.

The CUDA kernels replace the Pallas ``_flash_fwd`` (``_fwd_kernel``) and
``_flash_bwd_fused`` (``_bwd_fused_kernel``) of
``apex_tpu/ops/pallas/flash_attention.py``, with the semantics of that
module's ``flash_attention`` wrapper and its custom VJP: ``(B, L, H, D)``
tensors, q pre-scaled in its storage dtype, optional rope applied inside
the kernel from full-width tables (:func:`apex_tpu_torch.ops.rope.
rope_kernel_tables`), fp32 online softmax, an optional ``(B, L)`` key
mask, zeros and ``NEG_INF`` lse for rows that see no key.  The backward
recomputes the probabilities from the lse and returns gradients w.r.t.
the unrotated, unscaled inputs.  :func:`flash_attn_fwd` /
:func:`flash_attn_bwd` launch the kernels for CUDA tensors and run
:func:`flash_attn_fwd_ref` / :func:`flash_attn_bwd_ref` for CPU tensors;
they never fall back from one to the other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda import build
from apex_tpu_torch.ops.rope import rotate_full

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
#: rows of one key tile of the bf16 backward (one dq partial plane each)
BWD_KEY_TILE = 64

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _scaled_rotated(q: torch.Tensor, k: torch.Tensor, scale: float,
                    rope: Rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """q pre-scaled in its storage dtype (the scale itself rounded to that
    dtype, as the TPU wrapper folds it), then q and k rotated in fp32 and
    rounded back to the storage dtype: what the kernels' score product
    sees."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    if rope is None:
        return qs, k
    cos_t, sin_t = rope
    return (rotate_full(qs, cos_t, sin_t).to(q.dtype),
            rotate_full(k, cos_t, sin_t).to(k.dtype))


def _visible(q: torch.Tensor, lk: int, causal: bool,
             kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    lq = q.shape[1]
    visible = torch.ones((q.shape[0], 1, lq, lk), dtype=torch.bool,
                         device=q.device)
    if kv_mask is not None:
        visible = visible & kv_mask[:, None, None, :].bool()
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None]
        kpos = torch.arange(lk, device=q.device)[None, :]
        visible = visible & (qpos >= kpos)[None, None]
    return visible


def flash_attn_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False,
                       kv_mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None, rope: Rope = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` by materialising the fp32 scores: the form of the JAX
    package's ``flash_attention._jnp_attention``.  ``q (B, Lq, H, D)``,
    ``k``/``v (B, Lk, H, D)``, ``kv_mask (B, Lk)`` bool (True = attend);
    ``o`` has q's dtype, ``lse (B, Lq, H)`` is fp32 and ``NEG_INF`` where
    a row sees no key (its ``o`` row is zeros).  With ``rope`` (full-width
    ``(cos_full, sin_signed)`` tables, ``(B, L, D)``), q is pre-scaled in
    its dtype and q, k are rotated first, as the kernel does."""
    scale = _default_scale(q, scale)
    if rope is not None:
        q, k = _scaled_rotated(q, k, scale, rope)
        scale = 1.0
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    visible = _visible(q, k.shape[1], causal, kv_mask)
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / safe_l, v.float()).to(q.dtype)
    lse = torch.where(l[..., 0] == 0.0,
                      torch.full_like(l[..., 0], NEG_INF),
                      m[..., 0] + torch.log(safe_l[..., 0]))
    return o, lse.permute(0, 2, 1)


def _check_operand(what: str, name: str, t: torch.Tensor, shape, dtype,
                   device) -> None:
    if t.shape != shape or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{what}: {name} is {tuple(t.shape)} {t.dtype} on "
            f"{t.device}; want {tuple(shape)} {dtype} on {device} "
            f"(self-attention: Lq == Lk)")
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: {name} needs unit stride over D")
    if dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
        raise ValueError(f"{what}: bf16 {name} rows must start on "
                         f"16-byte boundaries (strides {t.stride()})")


def _check_common(what: str, q, k, v, kv_mask, rope):
    """Validate a kernel call; returns ``(mask_u8, cos_t, sin_t)``."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, L, H, D), got "
                         f"{tuple(q.shape)}")
    b, l, h, d = q.shape
    if q.dtype not in _DTYPES or d not in _HEAD_DIMS:
        raise ValueError(f"{what}: dtype {q.dtype} / head dim {d} "
                         f"unsupported (want bf16/fp32, D in {_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(what, name, t, q.shape, q.dtype, q.device)
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (b, l) or kv_mask.device != q.device:
            raise ValueError(f"{what}: kv_mask must be ({b}, {l}) on "
                             f"{q.device}")
        mask = kv_mask.to(torch.bool).contiguous().view(torch.uint8)
    cos_t = sin_t = None
    if rope is not None:
        cos_t, sin_t = (t.to(q.dtype).contiguous() for t in rope)
        for t in (cos_t, sin_t):
            if t.shape != (b, l, d) or t.device != q.device:
                raise ValueError(f"{what}: rope tables must be ({b}, {l}, "
                                 f"{d}) on {q.device}, got "
                                 f"{tuple(t.shape)} on {t.device}")
    return mask, cos_t, sin_t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   return_lse: bool = False, rope: Rope = None):
    """Exact attention of ``q``, ``k``, ``v`` ``(B, L, H, D)``; returns
    ``o`` or, with ``return_lse``, ``(o, lse)``.  ``rope``: optional
    full-width ``(cos_full, sin_signed)`` tables ``(B, L, D)``, cast to
    q's dtype, applied to q (after its pre-scale) and k inside the
    kernel.  On CUDA tensors one launch of the hand-written kernel
    (counted in ``flash_attn_fwd.launches``), which takes bf16 or fp32,
    D in (64, 128), Lq == Lk, and any strides with unit stride over D; on
    CPU tensors :func:`flash_attn_fwd_ref`."""
    if q.device.type == "cpu":
        o, lse = flash_attn_fwd_ref(q, k, v, causal=causal,
                                    kv_mask=kv_mask, scale=scale, rope=rope)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    mask, cos_t, sin_t = _check_common("flash_attn_fwd", q, k, v, kv_mask,
                                       rope)
    b, l, h, d = q.shape
    scale = _default_scale(q, scale)
    # the TPU wrapper folds the scale into q in q's dtype: scale rounded
    # to that dtype, product rounded back (done in the kernel's q load)
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, l, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = build.library().apex_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), o.data_ptr(),
        _ptr(lse), _ptr(cos_t), _ptr(sin_t), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], b, l, h, d, scale_q,
        int(bool(causal)), _DTYPES[q.dtype], build.stream_of(q))
    build.check(err, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return (o, lse) if return_lse else o


flash_attn_fwd.launches = 0


def attn_delta(o: torch.Tensor, do: torch.Tensor,
               dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """``rowsum(o * do) - dlse`` in fp32, ``(B, L, H)``: the per-row
    offset of ``dS = P * (dP - delta)`` (the JAX package's ``_delta``; a
    cotangent on the lse folds in here)."""
    delta = (o.float() * do.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def flash_attn_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       *, dlse: Optional[torch.Tensor] = None,
                       causal: bool = False,
                       kv_mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None, rope: Rope = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attn_fwd_ref`, by materialising the
    scores, with the kernel's roundings: ``P = exp(S - lse)`` from the
    pre-scaled, rotated q and rotated k; ``dV = P^T dO`` with P in the
    storage dtype; ``dS = P (dP - delta)``, rounded to the storage dtype
    for ``dK = dS^T Q`` and ``dQ = dS K``; dq and dk inverse-rotated; dq
    cast to q's dtype, then times the scale in that dtype (the one
    deferred scale of the TPU path)."""
    scale = _default_scale(q, scale)
    dt = q.dtype
    qr, kr = _scaled_rotated(q, k, scale, rope)
    s = torch.einsum("bqhd,bkhd->bhqk", qr.float(), kr.float())
    lse_t = lse.permute(0, 2, 1)[..., None]                  # (B, H, L, 1)
    visible = _visible(q, k.shape[1], causal, kv_mask) \
        & (lse_t > NEG_INF / 2)
    p = torch.where(visible, torch.exp(s - lse_t), torch.zeros_like(s))
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = attn_delta(o, do, dlse).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(dt).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qr.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr.float())
    if rope is not None:
        cos_t, sin_t = (t.to(dt) for t in rope)
        dq = rotate_full(dq, cos_t, -sin_t)
        dk = rotate_full(dk, cos_t, -sin_t)
    dq = dq.to(dt) * torch.tensor(scale, dtype=dt)
    return dq, dk.to(dt), dv.to(dt)


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   dlse: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, rope: Rope = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attn_bwd_ref`'s function.  On CUDA tensors the
    hand-written kernels, each launch counted in
    ``flash_attn_bwd.launches``: in bf16 one launch, where each 64-key
    tile writes its fp32 dq contribution into its own partial plane, and
    the planes are summed here in a fixed order; in fp32 two launches of
    SIMT kernels (dk and dv, then dq) write the gradients directly.  No
    atomics: two runs give equal bits.  ``delta`` (``rowsum(o * do) -
    dlse``) and the final ``dq * scale`` are plain PyTorch ops, as the
    JAX path leaves them to XLA."""
    if q.device.type == "cpu":
        return flash_attn_bwd_ref(q, k, v, o, lse, do, dlse=dlse,
                                  causal=causal, kv_mask=kv_mask,
                                  scale=scale, rope=rope)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd: unsupported device {q.device}")
    mask, cos_t, sin_t = _check_common("flash_attn_bwd", q, k, v, kv_mask,
                                       rope)
    b, l, h, d = q.shape
    do = do.contiguous()
    _check_operand("flash_attn_bwd", "do", do, q.shape, q.dtype, q.device)
    if lse.shape != (b, l, h) or lse.dtype != torch.float32:
        raise ValueError("flash_attn_bwd: lse must be (B, L, H) float32")
    lse = lse.contiguous()
    delta = attn_delta(o, do, dlse).contiguous()
    scale = _default_scale(q, scale)
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    if q.dtype == torch.bfloat16:
        planes = -(-l // BWD_KEY_TILE)
        dq_acc = torch.zeros((planes, b, l, h, d), dtype=torch.float32,
                             device=q.device)
    else:
        dq_acc = torch.empty((b, l, h, d), dtype=torch.float32,
                             device=q.device)
    dk = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = build.library().apex_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(cos_t),
        _ptr(sin_t), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        b, l, h, d, scale_q, int(bool(causal)), _DTYPES[q.dtype],
        build.stream_of(q))
    build.check(err, "flash_attn_bwd")
    flash_attn_bwd.launches += 1 if q.dtype == torch.bfloat16 else 2
    dq = dq_acc.sum(dim=0) if dq_acc.dim() == 5 else dq_acc
    dq = dq.to(q.dtype) * torch.tensor(scale, dtype=q.dtype)
    return dq, dk, dv


flash_attn_bwd.launches = 0
