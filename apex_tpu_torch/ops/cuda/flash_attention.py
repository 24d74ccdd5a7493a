"""K2, K4, K13 and K14: the flash-attention forward and backward kernels
(``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``,
``csrc/flash_attn_bwd_dq.cu``, ``csrc/flash_attn_bwd_dkv.cu``, with the
two-pass kernels' prologue ``csrc/flash_bwd_prologue.cu``) and their plain
PyTorch versions.

The CUDA kernels replace the Pallas ``_flash_fwd`` (``_fwd_kernel``),
``_flash_bwd_fused`` (``_bwd_fused_kernel``) and ``_flash_bwd``
(``_dq_kernel``, ``_dkv_kernel``) of
``apex_tpu/ops/pallas/flash_attention.py``, with the semantics of that
module's ``flash_attention`` wrapper and its custom VJP: ``(B, L, H, D)``
tensors, q pre-scaled in its storage dtype, optional rope applied inside
the kernel from full-width tables (:func:`apex_tpu_torch.ops.rope.
rope_kernel_tables`), fp32 online softmax, an optional ``(B, L)`` key
mask, zeros and ``NEG_INF`` lse for rows that see no key.  The backward
recomputes the probabilities from the lse and returns gradients w.r.t.
the unrotated, unscaled inputs.  :func:`flash_attn_bwd` takes the fused
backward (K4) while its fp32 dq partial planes fit
:func:`fused_bwd_max_bytes` and the two-pass backward (K13 for dq, then
K14 for dk / dv) above it, as the JAX package's gate does.  Each wrapper
launches its kernel for CUDA tensors and runs its plain version
(``*_ref``) for CPU tensors; none falls back from one to the other.

K13 and K14 are Hopper kernels: ``wgmma`` on tiles that TMA brings into a
ring of shared-memory stages.  TMA copies bytes, so a prologue kernel
(:func:`flash_bwd_prologue`) first writes q pre-scaled and rotated and k
rotated, once per call; each operand then reads through a 4-D tensor map
whose geometry :func:`tma_geometry` computes here (any head width that is
a multiple of 8 up to 128 runs padded to 64 or 128).
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda import build
from apex_tpu_torch.ops.rope import rotate_full

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
#: rows of one key tile of the bf16 backward (one dq partial plane each)
BWD_KEY_TILE = 64
#: the byte budget of K4's dq partial planes (the JAX package's variable)
FUSED_BWD_MAX_BYTES_ENV = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"
#: rows and columns of one TMA box of the two-pass kernels (K13, K14)
TMA_BOX = 64
_TMA_BOX_DIMS = (TMA_BOX, 1, TMA_BOX, 1)      # (D, H, L, B)
#: the map words of the four operands (q^, k^, v, do) of a two-pass call
_GeoWords = ctypes.c_longlong * 28

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


def _two_pass_head_dim(d: int) -> bool:
    """Whether K13 / K14 take head width ``d``: a multiple of 8 up to 128
    (TMA zero-fills the columns up to the padded width)."""
    return d % 8 == 0 and 8 <= d <= 128


def _check_common(what: str, q, k, v, kv_mask, rope, two_pass=False):
    """Validate a kernel call; returns ``(mask_u8, cos_t, sin_t)``.  The
    two-pass kernels take bf16 and every head width that is a multiple of
    8 up to 128; the others bf16 or fp32 and D in ``_HEAD_DIMS``."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, L, H, D), got "
                         f"{tuple(q.shape)}")
    b, l, h, d = q.shape
    if two_pass:
        if q.dtype != torch.bfloat16:
            raise ValueError(f"{what}: the two-pass kernels take bf16, got "
                             f"{q.dtype} (fp32 takes flash_attn_bwd's SIMT "
                             f"kernels)")
        if not _two_pass_head_dim(d):
            raise ValueError(f"{what}: head dim {d} unsupported (want a "
                             f"multiple of 8 up to 128)")
    elif q.dtype not in _DTYPES or d not in _HEAD_DIMS:
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
    cotangent on the lse folds in here).  Both backward routes share it."""
    delta = (o.float() * do.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def fused_bwd_max_bytes() -> int:
    """The budget, in bytes, of the fused backward's fp32 dq partial
    planes: ``APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES`` (read on every call;
    ``0`` forces the two-pass route wherever K4 would allocate planes), by
    default 1 GiB, as the JAX package's ``_fused_bwd_max_bytes``: one
    variable steers both packages."""
    env = os.environ.get(FUSED_BWD_MAX_BYTES_ENV)
    if env is not None:
        try:
            return int(env)
        except ValueError:
            raise ValueError(
                f"{FUSED_BWD_MAX_BYTES_ENV} must be a plain integer byte "
                f"count, got {env!r}") from None
    return 1 << 30


def fused_bwd_partials_bytes(b: int, l: int, h: int, d: int,
                             dtype: torch.dtype) -> int:
    """Bytes of the fp32 dq partial planes that K4 allocates for a bf16
    ``(b, l, h, d)`` backward: one ``(b, l, h, d)`` plane per 64-key tile,
    growing with ``l**2``.  0 in fp32, whose SIMT backward writes dq
    directly.  The gate measures the port's own buffer (not the TPU's
    1024-row blocks): it is the port's memory that runs out."""
    if dtype != torch.bfloat16:
        return 0
    return -(-l // BWD_KEY_TILE) * b * l * h * d * 4


def fused_bwd(q: torch.Tensor) -> bool:
    """Whether :func:`flash_attn_bwd` takes the fused route for ``q``: its
    partial planes fit :func:`fused_bwd_max_bytes` (the JAX package's
    gate in ``_flash_bwd_rule``)."""
    if q.dim() != 4:
        return True              # the fused route's checks refuse it
    b, l, h, d = q.shape
    return fused_bwd_partials_bytes(b, l, h, d, q.dtype) \
        <= fused_bwd_max_bytes()


def _bwd_scores(q, k, v, do, lse, delta, causal, kv_mask, scale, rope):
    """What both passes recompute, by materialising the scores with the
    kernels' roundings: ``P = exp(S - lse)`` in fp32 from the pre-scaled,
    rotated q and the rotated k (zero where a pair is hidden or its row
    sees no key), and ``dS = P (dP - delta)`` rounded to the storage
    dtype; ``(B, H, Lq, Lk)`` each, with the rotated q and k."""
    qr, kr = _scaled_rotated(q, k, scale, rope)
    s = torch.einsum("bqhd,bkhd->bhqk", qr.float(), kr.float())
    lse_t = lse.permute(0, 2, 1)[..., None]                  # (B, H, L, 1)
    visible = _visible(q, k.shape[1], causal, kv_mask) \
        & (lse_t > NEG_INF / 2)
    p = torch.where(visible, torch.exp(s - lse_t), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta.permute(0, 2, 1)[..., None])).to(q.dtype).float()
    return p, ds, qr, kr


def _unrotate(g: torch.Tensor, rope: Rope, dtype) -> torch.Tensor:
    if rope is None:
        return g
    cos_t, sin_t = (t.to(dtype) for t in rope)
    return rotate_full(g, cos_t, -sin_t)


def flash_attn_bwd_dq_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor,
                          delta: torch.Tensor, *, causal: bool = False,
                          kv_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None, rope: Rope = None
                          ) -> torch.Tensor:
    """dq of :func:`flash_attn_fwd_ref` given ``delta`` (:func:`attn_delta`):
    ``dQ = dS K`` with dS in the storage dtype, inverse-rotated, cast to
    q's dtype, then times the scale in that dtype (the one deferred scale
    of the TPU path: ``_dq_kernel`` emits q's dtype and
    ``_flash_bwd_rule`` scales it)."""
    scale = _default_scale(q, scale)
    _, ds, _, kr = _bwd_scores(q, k, v, do, lse, delta, causal, kv_mask,
                               scale, rope)
    dq = _unrotate(torch.einsum("bhqk,bkhd->bqhd", ds, kr.float()), rope,
                   q.dtype)
    return dq.to(q.dtype) * torch.tensor(scale, dtype=q.dtype)


def flash_attn_bwd_dkv_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, *,
                           causal: bool = False,
                           kv_mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None, rope: Rope = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of :func:`flash_attn_fwd_ref` given ``delta``: ``dV =
    P^T dO`` with P in the storage dtype, ``dK = dS^T Q`` from the
    pre-scaled, rotated q (exact: the scale lives in q), dk
    inverse-rotated; both in the input dtype."""
    scale = _default_scale(q, scale)
    dt = q.dtype
    p, ds, qr, _ = _bwd_scores(q, k, v, do, lse, delta, causal, kv_mask,
                               scale, rope)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dk = _unrotate(torch.einsum("bhqk,bqhd->bkhd", ds, qr.float()), rope, dt)
    return dk.to(dt), dv.to(dt)


def flash_attn_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       *, dlse: Optional[torch.Tensor] = None,
                       causal: bool = False,
                       kv_mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None, rope: Rope = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attn_fwd_ref`:
    :func:`flash_attn_bwd_dq_ref` and :func:`flash_attn_bwd_dkv_ref` on
    the shared ``delta``.  Both routes of :func:`flash_attn_bwd` compute
    this function; only their summation orders differ."""
    delta = attn_delta(o, do, dlse)
    kw = dict(causal=causal, kv_mask=kv_mask, scale=scale, rope=rope)
    dq = flash_attn_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_attn_bwd_dkv_ref(q, k, v, do, lse, delta, **kw))


def _check_bwd(what, q, k, v, do, lse, delta, kv_mask, rope,
               two_pass=False):
    """Validate a backward kernel call; returns ``(do, lse, delta, mask_u8,
    cos_t, sin_t)`` as the kernels take them."""
    mask, cos_t, sin_t = _check_common(what, q, k, v, kv_mask, rope,
                                       two_pass)
    b, l, h, _ = q.shape
    do = do.contiguous()
    _check_operand(what, "do", do, q.shape, q.dtype, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, l, h) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be (B, L, H) float32")
    return do, lse.contiguous(), delta.contiguous(), mask, cos_t, sin_t


class TmaGeometry(NamedTuple):
    """The 4-D TMA map of one bf16 ``(B, L, H, D)`` operand of K13 / K14:
    ``dims`` (D, H, L, B), innermost first; ``strides`` the byte strides
    of H, L and B; ``box`` (64 columns, 1 head, 64 rows, 1 batch); and
    ``padded_d``, the width the kernels run at (64 or 128: the box's
    columns past D load as zeros, as do its rows past L)."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    padded_d: int

    def words(self) -> Tuple[int, ...]:
        """The seven words the C entry points read: dims, then strides."""
        return self.dims + self.strides


def tma_geometry(t: torch.Tensor, name: str = "operand") -> TmaGeometry:
    """The map geometry of ``t`` (any device: shapes, strides and the
    address only).  Raises ``ValueError`` on what TMA refuses: a dtype
    other than bf16, a head width that is not a multiple of 8 up to 128,
    a stride over D other than 1, a base address or a byte stride off a
    16-byte boundary, a stride of 2**40 bytes or more.  A dimension of
    extent 1 is never stepped over, so its stride is set to the row's
    bytes, whatever PyTorch reports for it.  (Called for each operand of
    each two-pass call: it reads the shape and strides once.)"""
    shape, stride = t.shape, t.stride()
    if len(shape) != 4 or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: want a bf16 (B, L, H, D) tensor, got "
                         f"{t.dtype} {tuple(shape)}")
    b, l, h, d = shape
    if not _two_pass_head_dim(d):
        raise ValueError(f"{name}: head dim {d} unsupported (want a "
                         f"multiple of 8 up to 128)")
    if stride[3] != 1:
        raise ValueError(f"{name}: needs unit stride over D, got strides "
                         f"{stride}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base address {t.data_ptr():#x} is not "
                         f"on a 16-byte boundary")
    # bytes of H, L, B (bf16: 2 bytes an element)
    strides = (2 * stride[2] if h > 1 else 2 * d,
               2 * stride[1] if l > 1 else 2 * d,
               2 * stride[0] if b > 1 else 2 * d)
    for dim, nbytes in zip((2, 1, 0), strides):
        if nbytes % 16 or not 0 < nbytes < 1 << 40:
            raise ValueError(f"{name}: byte stride {nbytes} of dim {dim} "
                             f"is not a multiple of 16 below 2**40 "
                             f"(strides {stride})")
    return TmaGeometry((d, h, l, b), strides, _TMA_BOX_DIMS,
                       64 if d <= 64 else 128)


def _bf16_scale(scale: float) -> float:
    """The scale rounded to bf16 as q's pre-scale folds it (what
    ``torch.tensor(scale, dtype=torch.bfloat16)`` gives: to fp32, then to
    nearest, ties to even), without a tensor on the host path of every
    call."""
    bits = struct.unpack("<I", struct.pack("<f", scale))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def flash_bwd_prologue_ref(q: torch.Tensor, k: torch.Tensor, *,
                           scale: float, rope: Rope = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q^, k^)``: :func:`_scaled_rotated`, what the two passes' score
    product reads."""
    return _scaled_rotated(q, k, scale, rope)


def flash_bwd_prologue(q: torch.Tensor, k: torch.Tensor, *, scale: float,
                       rope: Rope = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q^, k^)`` of :func:`flash_bwd_prologue_ref`, once per two-pass
    backward.  On CUDA tensors (bf16, the operand rules of the two-pass
    kernels) one launch of ``csrc/flash_bwd_prologue.cu`` (counted in
    ``flash_bwd_prologue.launches``) writing contiguous q^ and, with rope
    tables, k^ (else k^ is k); no launch when there is nothing to do (no
    tables and a scale of 1 in bf16: q^ is q).  The results are bitwise
    the plain version's.  On CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_prologue_ref(q, k, scale=scale, rope=rope)
    what = "flash_bwd_prologue"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    _, cos_t, sin_t = _check_common(what, q, k, k, None, rope,
                                    two_pass=True)
    return _prologue(q, k, _bf16_scale(scale), cos_t, sin_t,
                     build.stream_of(q))


def _prologue(q, k, scale_q: float, cos_t, sin_t, stream: int):
    """:func:`flash_bwd_prologue` on operands already checked."""
    if cos_t is None and scale_q == 1.0:
        return q, k
    qh = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kh = torch.empty_like(qh) if cos_t is not None else None
    b, l, h, d = q.shape
    err = build.library().apex_flash_bwd_prologue(
        q.data_ptr(), k.data_ptr(), _ptr(cos_t), _ptr(sin_t), qh.data_ptr(),
        _ptr(kh), *q.stride()[:3], *k.stride()[:3], b, l, h, d, scale_q,
        stream)
    build.check(err, "flash_bwd_prologue")
    flash_bwd_prologue.launches += 1
    return qh, (k if kh is None else kh)


flash_bwd_prologue.launches = 0


class _TwoPass(NamedTuple):
    """What both passes read, made once a call: q^ / k^ (the prologue's), v
    and do, the four maps' words, lse and delta (contiguous ``(B, L, H)``
    fp32), the key mask as ``(B, L)`` uint8 or None, the bf16 tables or
    None, dq's deferred scale rounded to bf16, causality, the stream."""

    qh: torch.Tensor
    kh: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor
    geo: ctypes.Array
    lse: torch.Tensor
    delta: torch.Tensor
    mask: Optional[torch.Tensor]
    cos_t: Optional[torch.Tensor]
    sin_t: Optional[torch.Tensor]
    scale_q: float
    causal: int
    stream: int


def _two_pass_operands(what, q, k, v, do, lse, delta, causal, kv_mask,
                       scale, rope) -> _TwoPass:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    do, lse, delta, mask, cos_t, sin_t = _check_bwd(
        what, q, k, v, do, lse, delta, kv_mask, rope, two_pass=True)
    scale_q = _bf16_scale(_default_scale(q, scale))
    stream = build.stream_of(q)
    qh, kh = _prologue(q, k, scale_q, cos_t, sin_t, stream)
    words = []
    for name, t in (("q^", qh), ("k^", kh), ("v", v), ("do", do)):
        words += tma_geometry(t, name).words()
    return _TwoPass(qh, kh, v, do, _GeoWords(*words), lse, delta, mask,
                    cos_t, sin_t, scale_q, int(bool(causal)), stream)


def _maps_args(ops: _TwoPass):
    return (ops.qh.data_ptr(), ops.kh.data_ptr(), ops.v.data_ptr(),
            ops.do.data_ptr(), ctypes.addressof(ops.geo), ops.lse.data_ptr(),
            ops.delta.data_ptr(), _ptr(ops.mask), _ptr(ops.cos_t),
            _ptr(ops.sin_t))


def _dq_pass(ops: _TwoPass) -> torch.Tensor:
    b, l, h, d = ops.qh.shape
    dq = torch.empty((b, l, h, d), dtype=ops.qh.dtype, device=ops.qh.device)
    err = build.library().apex_flash_attn_bwd_dq(
        *_maps_args(ops), dq.data_ptr(), b, l, h, d, ops.scale_q,
        ops.causal, ops.stream)
    build.check(err, "flash_attn_bwd_dq")
    flash_attn_bwd_dq.launches += 1
    return dq


def _dkv_pass(ops: _TwoPass) -> Tuple[torch.Tensor, torch.Tensor]:
    b, l, h, d = ops.qh.shape
    dk = torch.empty((b, l, h, d), dtype=ops.qh.dtype, device=ops.qh.device)
    dv = torch.empty_like(dk)
    err = build.library().apex_flash_attn_bwd_dkv(
        *_maps_args(ops), dk.data_ptr(), dv.data_ptr(), b, l, h, d,
        ops.causal, ops.stream)
    build.check(err, "flash_attn_bwd_dkv")
    flash_attn_bwd_dkv.launches += 1
    return dk, dv


def flash_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, *, causal: bool = False,
                      kv_mask: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None, rope: Rope = None
                      ) -> torch.Tensor:
    """:func:`flash_attn_bwd_dq_ref`'s function, the dq pass of the
    two-pass backward.  On CUDA tensors :func:`flash_bwd_prologue`, then
    one launch of K13 (``csrc/flash_attn_bwd_dq.cu``, counted in
    ``flash_attn_bwd_dq.launches``): bf16, D a multiple of 8 up to 128,
    any strides that :func:`tma_geometry` takes; dq accumulates in
    registers over the key tiles and is written once, scale applied, with
    no partial planes.  On CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_attn_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                     kv_mask=kv_mask, scale=scale,
                                     rope=rope)
    return _dq_pass(_two_pass_operands("flash_attn_bwd_dq", q, k, v, do, lse,
                                       delta, causal, kv_mask, scale, rope))


flash_attn_bwd_dq.launches = 0


def flash_attn_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, *, causal: bool = False,
                       kv_mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None, rope: Rope = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attn_bwd_dkv_ref`'s function, the dk / dv pass of the
    two-pass backward.  On CUDA tensors :func:`flash_bwd_prologue`, then
    one launch of K14 (``csrc/flash_attn_bwd_dkv.cu``, counted in
    ``flash_attn_bwd_dkv.launches``), on the operands of
    :func:`flash_attn_bwd_dq`.  On CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_attn_bwd_dkv_ref(q, k, v, do, lse, delta,
                                      causal=causal, kv_mask=kv_mask,
                                      scale=scale, rope=rope)
    return _dkv_pass(_two_pass_operands("flash_attn_bwd_dkv", q, k, v, do,
                                        lse, delta, causal, kv_mask, scale,
                                        rope))


flash_attn_bwd_dkv.launches = 0


def two_pass_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 *, causal: bool = False,
                 kv_mask: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None, rope: Rope = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` by the two-pass backward: on CUDA tensors one
    :func:`flash_bwd_prologue` shared by K13 then K14; on CPU tensors the
    plain versions."""
    kw = dict(causal=causal, kv_mask=kv_mask, scale=scale, rope=rope)
    if q.device.type == "cpu":
        return (flash_attn_bwd_dq(q, k, v, do, lse, delta, **kw),
                *flash_attn_bwd_dkv(q, k, v, do, lse, delta, **kw))
    ops = _two_pass_operands("flash_attn_bwd", q, k, v, do, lse, delta,
                             **kw)
    return (_dq_pass(ops), *_dkv_pass(ops))


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   dlse: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, rope: Rope = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attn_bwd_ref`'s function, by one of two routes, as the
    JAX package's ``_flash_bwd_rule`` picks them: the fused backward while
    its dq partial planes (:func:`fused_bwd_partials_bytes`) fit
    :func:`fused_bwd_max_bytes`, else the two-pass backward
    (:func:`two_pass_bwd`: one prologue, then K13 and K14).  The route is
    the same on the CPU, where each runs its plain version.

    The fused route on CUDA tensors, each launch counted in
    ``flash_attn_bwd.launches`` (K4 only): in bf16 one launch, where each
    64-key tile writes its fp32 dq contribution into its own partial
    plane, and the planes are summed here in a fixed order; in fp32 two
    launches of SIMT kernels (dk and dv, then dq) write the gradients
    directly (no planes, so fp32 is always fused).  No atomics on either
    route: two runs give equal bits.  ``delta`` (``rowsum(o * do) -
    dlse``) and the fused route's final ``dq * scale`` are plain PyTorch
    ops, as the JAX path leaves them to XLA."""
    if not fused_bwd(q):
        return two_pass_bwd(q, k, v, do, lse, attn_delta(o, do, dlse),
                            causal=causal, kv_mask=kv_mask, scale=scale,
                            rope=rope)
    if q.device.type == "cpu":
        return flash_attn_bwd_ref(q, k, v, o, lse, do, dlse=dlse,
                                  causal=causal, kv_mask=kv_mask,
                                  scale=scale, rope=rope)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd: unsupported device {q.device}")
    do, lse, delta, mask, cos_t, sin_t = _check_bwd(
        "flash_attn_bwd", q, k, v, do, lse, attn_delta(o, do, dlse),
        kv_mask, rope)
    b, l, h, d = q.shape
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
