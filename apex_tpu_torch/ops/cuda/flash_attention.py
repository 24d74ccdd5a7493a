"""K2: the flash-attention forward kernel (``csrc/flash_attn_fwd.cu``) and
its plain PyTorch version.

The CUDA kernel replaces the Pallas forward
``apex_tpu/ops/pallas/flash_attention.py`` ``_flash_fwd``
(``_fwd_kernel``), with the semantics of that module's
``flash_attention`` wrapper: ``(B, L, H, D)`` tensors, q pre-scaled in
its storage dtype, fp32 online softmax, an optional ``(B, L)`` key mask,
zeros and ``NEG_INF`` lse for rows that see no key.
:func:`flash_attn_fwd` launches it for CUDA tensors and runs
:func:`flash_attn_fwd_ref` for CPU tensors; it never falls back from one
to the other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attn_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False,
                       kv_mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` by materialising the fp32 scores: the form of the JAX
    package's ``flash_attention._jnp_attention``.  ``q (B, Lq, H, D)``,
    ``k``/``v (B, Lk, H, D)``, ``kv_mask (B, Lk)`` bool (True = attend);
    ``o`` has q's dtype, ``lse (B, Lq, H)`` is fp32 and ``NEG_INF`` where
    a row sees no key (its ``o`` row is zeros)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lq, lk = q.shape[1], k.shape[1]
    visible = torch.ones((q.shape[0], 1, lq, lk), dtype=torch.bool,
                         device=q.device)
    if kv_mask is not None:
        visible = visible & kv_mask[:, None, None, :].bool()
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None]
        kpos = torch.arange(lk, device=q.device)[None, :]
        visible = visible & (qpos >= kpos)[None, None]
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


def _check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.shape != shape or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"flash_attn_fwd: {name} is {tuple(t.shape)} {t.dtype} on "
            f"{t.device}; want {tuple(shape)} {dtype} on {device} "
            f"(self-attention: Lq == Lk)")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attn_fwd: {name} needs unit stride over D")
    if dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
        raise ValueError(f"flash_attn_fwd: bf16 {name} rows must start on "
                         f"16-byte boundaries (strides {t.stride()})")


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   return_lse: bool = False):
    """Exact attention of ``q``, ``k``, ``v`` ``(B, L, H, D)``; returns
    ``o`` or, with ``return_lse``, ``(o, lse)``.  On CUDA tensors one
    launch of the hand-written kernel (counted in
    ``flash_attn_fwd.launches``), which takes bf16 or fp32, D in (64,
    128), Lq == Lk, and any strides with unit stride over D; on CPU
    tensors :func:`flash_attn_fwd_ref`."""
    if q.device.type == "cpu":
        o, lse = flash_attn_fwd_ref(q, k, v, causal=causal,
                                    kv_mask=kv_mask, scale=scale)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_attn_fwd: q must be (B, L, H, D), got "
                         f"{tuple(q.shape)}")
    b, l, h, d = q.shape
    if q.dtype not in _DTYPES or d not in _HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd: dtype {q.dtype} / head dim {d} "
                         f"unsupported (want bf16/fp32, D in {_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.shape, q.dtype, q.device)
    build.refuse_grad("flash_attn_fwd", q, k, v)
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (b, l) or kv_mask.device != q.device:
            raise ValueError(f"flash_attn_fwd: kv_mask must be ({b}, {l}) "
                             f"on {q.device}")
        mask = kv_mask.to(torch.bool).contiguous().view(torch.uint8)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # the TPU wrapper folds the scale into q in q's dtype: scale rounded
    # to that dtype, product rounded back (done in the kernel's q load)
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, l, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            b, l, h, d, scale_q, int(bool(causal)), _DTYPES[q.dtype],
            stream)
    build.check(err, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return (o, lse) if return_lse else o


flash_attn_fwd.launches = 0
