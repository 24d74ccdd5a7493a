"""K2, K4, K13 and K14: the flash-attention forward and backward kernels
(``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_fused_sm90.cu`` with its
finish pass, ``csrc/flash_attn_bwd_dq.cu``, ``csrc/flash_attn_bwd_dkv.cu``,
with the prologue ``csrc/flash_bwd_prologue.cu`` and the generic kernels
``csrc/flash_simt.cu``) and their plain PyTorch versions.

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

K2, K4, K13 and K14 are Hopper kernels: ``wgmma`` on tiles that TMA
brings into a ring of shared-memory stages, in bf16 or fp16.  TMA copies
bytes, so a prologue kernel writes the rotated k (:func:`flash_fwd_prologue`,
for K2) or q pre-scaled and rotated and k rotated
(:func:`flash_bwd_prologue`, for K4, K13 and K14) once per call; K2
pre-scales and rotates its own q tile in shared memory.  Each operand
reads through a 4-D tensor map whose geometry :func:`tma_geometry`
computes here (any head width that is a multiple of 8 up to 128 runs
padded to 64 or 128).  K4 writes dq as fp32 partial planes, one per
64 keys; :func:`flash_bwd_finish` sums them, inverse-rotates, rounds and
scales.

Which kernel a call takes is a pure function of the dtype, the head width
and, for the backward, the partial planes' bytes against the budget
(:func:`fwd_route`, :func:`bwd_route`): bf16 and fp16 up to D 128 take the
tensor-core kernels; fp32, and half types above D 128, the generic kernels
(``flash_fwd_simt``, ``flash_bwd_simt``, on CUDA cores in fp32), up to D
:data:`MAX_HEAD_DIM`.  The generic kernels take one of two layouts, which
:func:`simt_layout` picks from the dtype and the head width: ``"tiled"``
(query and key tiles in shared memory, register micro-tiles on FFMA, one
softmax reduction a tile) up to D :data:`TILED_MAX_HEAD_DIM`, ``"rows"``
(a warp a row) above.  Every kernel counts its own launches.
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the storage types of the tensor-core kernels
HALF_DTYPES = (torch.bfloat16, torch.float16)
#: the widest head of the tensor-core kernels (TMA pads to 64 or 128)
MAX_TC_HEAD_DIM = 128
#: the widest head of the generic kernels: above D 512 their rows layout
#: keeps each of a warp's rows in shared memory, and the dk / dv pass's six
#: fp32 rows of one warp (64 * ceil(D / 64) floats each) must fit one
#: block's 227 KB
MAX_HEAD_DIM = 9664
#: the widest head of the generic kernels' tiled layout (their output's
#: register micro-tile: 16 columns a thread at D 256)
TILED_MAX_HEAD_DIM = 256
#: the C entry points' mode word of each layout of the generic kernels
_LAYOUTS = {"tiled": 0, "rows": 1}
#: keys of one consumer warpgroup of the fused backward (K4 / K18): one
#: dq partial plane each
BWD_KEY_TILE = 64
#: the byte budget of K4's dq partial planes (the JAX package's variable)
FUSED_BWD_MAX_BYTES_ENV = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"
#: rows and columns of one TMA box of the two-pass kernels (K13, K14)
TMA_BOX = 64
_TMA_BOX_DIMS = (TMA_BOX, 1, TMA_BOX, 1)      # (D, H, L, B)
#: the map words of the four operands (q^, k^, v, do) of a two-pass call
_GeoWords = ctypes.c_longlong * 28
#: the map words of the forward's three operands (q, k^, v)
_FwdGeoWords = ctypes.c_longlong * 21

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
    if dtype in HALF_DTYPES and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
        raise ValueError(f"{what}: {dtype} {name} rows must start on "
                         f"16-byte boundaries (strides {t.stride()})")


def _tc_head_dim(d: int) -> bool:
    """Whether the tensor-core kernels (K2 / K17, K13 / K14) take head
    width ``d``: a multiple of 8 up to 128 (TMA zero-fills the columns up
    to the padded width)."""
    return d % 8 == 0 and 8 <= d <= MAX_TC_HEAD_DIM


def _check_route(what: str, dtype: torch.dtype, d: int) -> None:
    """Raise on what no kernel takes: a dtype other than fp32, bf16 or
    fp16, or a head width that is not a multiple of 8 up to
    :data:`MAX_HEAD_DIM`."""
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {dtype} unsupported (want fp32, "
                         f"bf16 or fp16)")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} unsupported (want a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}: the generic "
                         f"kernels' six fp32 rows of a warp fill one "
                         f"block's 227 KB of shared memory there)")


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel a call takes: ``"sm90"`` (K2 / K17, ``wgmma`` +
    TMA) for bf16 and fp16 up to D 128, else ``"simt"`` (the generic
    kernel).  Raises ``ValueError`` on what no kernel takes."""
    _check_route("flash forward", dtype, d)
    return "sm90" if dtype in HALF_DTYPES and d <= MAX_TC_HEAD_DIM \
        else "simt"


def bwd_route(dtype: torch.dtype, d: int, partials_bytes: int,
              budget: int) -> str:
    """The backward kernels a call takes: ``"simt"`` (the generic pair)
    for fp32 and for half types above D 128; else ``"fused"`` (K4, or
    K18) where its partial planes fit ``budget``; else ``"two_pass"``
    (K13 then K14).  Raises ``ValueError`` on what no kernel takes."""
    _check_route("flash backward", dtype, d)
    if dtype not in HALF_DTYPES or d > MAX_TC_HEAD_DIM:
        return "simt"
    return "fused" if partials_bytes <= budget else "two_pass"


def simt_layout(dtype: torch.dtype, d: int) -> str:
    """The layout the generic kernels take for ``dtype`` and head width
    ``d`` (passed to their C entry points as a mode word): ``"tiled"``
    (query and key tiles in shared memory, register micro-tiles on FFMA)
    for every ``d`` up to :data:`TILED_MAX_HEAD_DIM`, whatever the dtype;
    ``"rows"`` (a warp a row) above, up to :data:`MAX_HEAD_DIM`, whose
    output rows a thread's registers cannot hold as a tile.  Raises
    ``ValueError`` on what no kernel takes."""
    _check_route("flash generic kernels", dtype, d)
    return "tiled" if d <= TILED_MAX_HEAD_DIM else "rows"


def _check_common(what: str, q, k, v, kv_mask, rope, tensor_cores=False):
    """Validate a kernel call; returns ``(mask_u8, cos_t, sin_t)``.  The
    tensor-core kernels (``tensor_cores``) take bf16 or fp16 and every head
    width that is a multiple of 8 up to 128; the generic ones fp32, bf16
    or fp16 at every head width that is a multiple of 8 up to
    :data:`MAX_HEAD_DIM`."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, L, H, D), got "
                         f"{tuple(q.shape)}")
    b, l, h, d = q.shape
    _check_route(what, q.dtype, d)
    if tensor_cores and (q.dtype not in HALF_DTYPES
                         or not _tc_head_dim(d)):
        raise ValueError(f"{what}: the tensor-core kernels take bf16 or "
                         f"fp16 up to D {MAX_TC_HEAD_DIM}, got {q.dtype} "
                         f"D {d}")
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


class _FwdOps(NamedTuple):
    """What one launch of the Hopper forward reads, made once a call: q, k^
    (the prologue's k rotated, or k), v, the three maps' words, the key
    mask as ``(B, L)`` uint8 or None, the tables (q is rotated with them
    in the kernel) or None, the scale rounded to q's dtype, whether the
    kernel pre-scales and rotates q, causality, the stream."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    geo: ctypes.Array
    mask: Optional[torch.Tensor]
    cos_t: Optional[torch.Tensor]
    sin_t: Optional[torch.Tensor]
    scale_q: float
    prep_q: int
    causal: int
    stream: int


def _fwd_operands(what, q, k, v, kv_mask, causal, scale, rope) -> _FwdOps:
    """Check a tensor-core forward call and prepare its operands: with
    rope, one :func:`flash_fwd_prologue` launch writes k^; the maps'
    geometry of q, k^ and v."""
    mask, cos_t, sin_t = _check_common(what, q, k, v, kv_mask, rope,
                                       tensor_cores=True)
    scale_q = _half_scale(_default_scale(q, scale), q.dtype)
    stream = build.stream_of(q)
    kh = k if cos_t is None else _prologue(None, k, 1.0, cos_t, sin_t,
                                           stream, flash_fwd_prologue)[1]
    words = []
    for name, t in (("q", q), ("k^", kh), ("v", v)):
        words += tma_geometry(t, name).words()
    return _FwdOps(q, kh, v, _FwdGeoWords(*words), mask, cos_t, sin_t,
                   scale_q, int(cos_t is not None or scale_q != 1.0),
                   int(bool(causal)), stream)


def _fwd_launch(ops: _FwdOps, return_lse: bool):
    """One launch of the Hopper forward (``csrc/flash_fwd_sm90.cu``) on
    prepared operands; returns ``(o, lse or None)``.  The caller counts
    the launch under its own name (K2 or K17)."""
    b, l, h, d = ops.q.shape
    o = torch.empty((b, l, h, d), dtype=ops.q.dtype, device=ops.q.device)
    lse = (torch.empty((b, l, h), dtype=torch.float32, device=ops.q.device)
           if return_lse else None)
    err = build.library().apex_flash_fwd_sm90(
        ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
        ctypes.addressof(ops.geo), _ptr(ops.mask), _ptr(ops.cos_t),
        _ptr(ops.sin_t), o.data_ptr(), _ptr(lse), b, l, h, d, ops.scale_q,
        ops.prep_q, ops.causal, _DTYPES[ops.q.dtype], ops.stream)
    build.check(err, "flash_fwd_sm90")
    return o, lse


def _simt_fwd(what, q, k, v, kv_mask, causal, scale, rope, return_lse):
    """The generic forward (``csrc/flash_simt.cu``) in the layout of
    :func:`simt_layout`, one launch counted in ``flash_fwd_simt.launches``;
    returns ``(o, lse or None)``."""
    mask, cos_t, sin_t = _check_common(what, q, k, v, kv_mask, rope)
    b, l, h, d = q.shape
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, l, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = build.library().apex_flash_fwd_simt(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(cos_t),
        _ptr(sin_t), o.data_ptr(), _ptr(lse), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], b, l, h, d,
        _half_scale(_default_scale(q, scale), q.dtype), int(bool(causal)),
        _DTYPES[q.dtype], _LAYOUTS[simt_layout(q.dtype, d)],
        build.stream_of(q))
    build.check(err, what)
    flash_fwd_simt.launches += 1
    return o, lse


def flash_fwd_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, return_lse: bool = False,
                   rope: Rope = None):
    """:func:`flash_attn_fwd_ref`'s function by the generic kernel alone,
    whatever the route (the cases :func:`fwd_route` sends it: fp32, and
    half types above D 128; it takes bf16 / fp16 at any width too).  On
    CUDA tensors one launch counted in ``flash_fwd_simt.launches``; on
    CPU tensors the plain version."""
    if q.device.type == "cpu":
        o, lse = flash_attn_fwd_ref(q, k, v, causal=causal,
                                    kv_mask=kv_mask, scale=scale, rope=rope)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_simt: unsupported device {q.device}")
    o, lse = _simt_fwd("flash_fwd_simt", q, k, v, kv_mask, causal, scale,
                       rope, return_lse)
    return (o, lse) if return_lse else o


flash_fwd_simt.launches = 0


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   return_lse: bool = False, rope: Rope = None):
    """Exact attention of ``q``, ``k``, ``v`` ``(B, L, H, D)``; returns
    ``o`` or, with ``return_lse``, ``(o, lse)``.  ``rope``: optional
    full-width ``(cos_full, sin_signed)`` tables ``(B, L, D)``, cast to
    q's dtype, applied to q (after its pre-scale) and k.  On CUDA tensors,
    by :func:`fwd_route`: for bf16 / fp16 up to D 128 one launch of K2
    (``csrc/flash_fwd_sm90.cu``, counted in ``flash_attn_fwd.launches``),
    after one :func:`flash_fwd_prologue` launch with rope; for fp32, and
    half types above D 128, the generic kernel (:func:`flash_fwd_simt`).
    Lq == Lk; D a multiple of 8 up to :data:`MAX_HEAD_DIM`; any strides
    with unit stride over D (16-byte aligned rows in half types).  On CPU
    tensors :func:`flash_attn_fwd_ref`."""
    if q.device.type == "cpu":
        o, lse = flash_attn_fwd_ref(q, k, v, causal=causal,
                                    kv_mask=kv_mask, scale=scale, rope=rope)
        return (o, lse) if return_lse else o
    what = "flash_attn_fwd"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() == 4 and fwd_route(q.dtype, q.shape[-1]) == "simt":
        o, lse = _simt_fwd(what, q, k, v, kv_mask, causal, scale, rope,
                           return_lse)
    else:
        o, lse = _fwd_launch(_fwd_operands(what, q, k, v, kv_mask, causal,
                                           scale, rope), return_lse)
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
    """Bytes of the fp32 dq partial planes that K4 allocates for a bf16 or
    fp16 ``(b, l, h, d)`` backward: one ``(b, l, h, d)`` plane per 64 keys
    (:data:`BWD_KEY_TILE`), growing with ``l**2``.  0 in fp32, whose
    generic backward writes dq directly.  The gate measures the port's own
    buffer (not the TPU's 1024-row blocks): it is the port's memory that
    runs out."""
    if dtype not in HALF_DTYPES:
        return 0
    return -(-l // BWD_KEY_TILE) * b * l * h * d * 4


def fused_bwd(q: torch.Tensor) -> bool:
    """Whether :func:`flash_attn_bwd` keeps to one pass for ``q`` (K4, or
    the generic kernels), as the JAX package's gate in ``_flash_bwd_rule``
    does while the partial planes fit :func:`fused_bwd_max_bytes`; False
    where it takes the two-pass kernels (:func:`bwd_route`: planes over
    the budget)."""
    if q.dim() != 4:
        return True              # the fused route's checks refuse it
    b, l, h, d = q.shape
    if q.dtype not in _DTYPES or d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        return True              # the fused route's checks refuse it
    return bwd_route(q.dtype, d,
                     fused_bwd_partials_bytes(b, l, h, d, q.dtype),
                     fused_bwd_max_bytes()) != "two_pass"


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
               tensor_cores=False):
    """Validate a backward kernel call; returns ``(do, lse, delta, mask_u8,
    cos_t, sin_t)`` as the kernels take them."""
    mask, cos_t, sin_t = _check_common(what, q, k, v, kv_mask, rope,
                                       tensor_cores)
    b, l, h, _ = q.shape
    do = do.contiguous()
    _check_operand(what, "do", do, q.shape, q.dtype, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, l, h) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be (B, L, H) float32")
    return do, lse.contiguous(), delta.contiguous(), mask, cos_t, sin_t


class TmaGeometry(NamedTuple):
    """The 4-D TMA map of one bf16 or fp16 ``(B, L, H, D)`` operand of
    K2 / K17, K13 or K14:
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
    other than bf16 or fp16, a head width that is not a multiple of 8 up
    to 128,
    a stride over D other than 1, a base address or a byte stride off a
    16-byte boundary, a stride of 2**40 bytes or more.  A dimension of
    extent 1 is never stepped over, so its stride is set to the row's
    bytes, whatever PyTorch reports for it.  (Called for each operand of
    each tensor-core call: it reads the shape and strides once.)"""
    shape, stride = t.shape, t.stride()
    if len(shape) != 4 or t.dtype not in HALF_DTYPES:
        raise ValueError(f"{name}: want a bf16 or fp16 (B, L, H, D) "
                         f"tensor, got {t.dtype} {tuple(shape)}")
    b, l, h, d = shape
    if not _tc_head_dim(d):
        raise ValueError(f"{name}: head dim {d} unsupported (want a "
                         f"multiple of 8 up to 128)")
    if stride[3] != 1:
        raise ValueError(f"{name}: needs unit stride over D, got strides "
                         f"{stride}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base address {t.data_ptr():#x} is not "
                         f"on a 16-byte boundary")
    # bytes of H, L, B (2 bytes an element)
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


def _half_scale(scale: float, dtype: torch.dtype) -> float:
    """The scale rounded to ``dtype`` as q's pre-scale folds it:
    ``torch.tensor(scale, dtype=dtype)``'s value (bf16 without a
    tensor)."""
    if dtype == torch.bfloat16:
        return _bf16_scale(scale)
    return float(torch.tensor(scale, dtype=dtype))


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
    backward.  On CUDA tensors (bf16 or fp16, the operand rules of the
    tensor-core kernels) one launch of ``csrc/flash_bwd_prologue.cu``
    (counted in ``flash_bwd_prologue.launches``) writing contiguous q^
    and, with rope tables, k^ (else k^ is k); no launch when there is
    nothing to do (no tables and a scale of 1 in q's dtype: q^ is q).
    The results are bitwise the plain version's.  On CPU tensors the plain
    version."""
    if q.device.type == "cpu":
        return flash_bwd_prologue_ref(q, k, scale=scale, rope=rope)
    what = "flash_bwd_prologue"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    _, cos_t, sin_t = _check_common(what, q, k, k, None, rope,
                                    tensor_cores=True)
    return _prologue(q, k, _half_scale(scale, q.dtype), cos_t, sin_t,
                     build.stream_of(q), flash_bwd_prologue)


flash_bwd_prologue.launches = 0


def flash_fwd_prologue_ref(k: torch.Tensor, rope) -> torch.Tensor:
    """k^: k rotated by the full-width tables in fp32, rounded to k's
    dtype (what K2's score product reads)."""
    cos_t, sin_t = (t.to(k.dtype) for t in rope)
    return rotate_full(k, cos_t, sin_t).to(k.dtype)


def flash_fwd_prologue(k: torch.Tensor, rope) -> torch.Tensor:
    """k^ of :func:`flash_fwd_prologue_ref`, once per rope forward: on CUDA
    tensors (bf16 or fp16, the tensor-core operand rules) one launch of
    ``csrc/flash_bwd_prologue.cu`` with no q (counted in
    ``flash_fwd_prologue.launches``), contiguous, bitwise the plain
    version's; on CPU tensors the plain version."""
    if k.device.type == "cpu":
        return flash_fwd_prologue_ref(k, rope)
    what = "flash_fwd_prologue"
    if k.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {k.device}")
    _, cos_t, sin_t = _check_common(what, k, k, k, None, rope,
                                    tensor_cores=True)
    return _prologue(None, k, 1.0, cos_t, sin_t, build.stream_of(k),
                     flash_fwd_prologue)[1]


flash_fwd_prologue.launches = 0


def _prologue(q, k, scale_q: float, cos_t, sin_t, stream: int, counter):
    """One prologue launch on operands already checked, counted in
    ``counter.launches``: q^ unless ``q`` is None, k^ with tables (else k
    is returned as k^); no launch when q^ would be q and k^ k."""
    if cos_t is None and (q is None or scale_q == 1.0):
        return q, k
    qh = None if q is None else torch.empty(q.shape, dtype=q.dtype,
                                            device=q.device)
    kh = torch.empty(k.shape, dtype=k.dtype, device=k.device) \
        if cos_t is not None else None
    b, l, h, d = k.shape
    sq = q.stride()[:3] if q is not None else (0, 0, 0)
    err = build.library().apex_flash_bwd_prologue(
        _ptr(q), k.data_ptr(), _ptr(cos_t), _ptr(sin_t), _ptr(qh),
        _ptr(kh), *sq, *k.stride()[:3], b, l, h, d, scale_q,
        _DTYPES[k.dtype], stream)
    build.check(err, counter.__name__)
    counter.launches += 1
    return qh, (k if kh is None else kh)


class _BwdOps(NamedTuple):
    """What the Hopper backward kernels read (K4, or K13 then K14), made
    once a call: q^ / k^ (the prologue's), v and do, the four maps' words,
    lse and delta (contiguous ``(B, L, H)`` fp32), the key mask as ``(B,
    L)`` uint8 or None, the tables or None, dq's deferred scale rounded to
    q's dtype, causality, the stream."""

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


def _bwd_operands(what, q, k, v, do, lse, delta, causal, kv_mask, scale,
                  rope) -> _BwdOps:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    do, lse, delta, mask, cos_t, sin_t = _check_bwd(
        what, q, k, v, do, lse, delta, kv_mask, rope, tensor_cores=True)
    scale_q = _half_scale(_default_scale(q, scale), q.dtype)
    stream = build.stream_of(q)
    qh, kh = _prologue(q, k, scale_q, cos_t, sin_t, stream,
                       flash_bwd_prologue)
    words = []
    for name, t in (("q^", qh), ("k^", kh), ("v", v), ("do", do)):
        words += tma_geometry(t, name).words()
    return _BwdOps(qh, kh, v, do, _GeoWords(*words), lse, delta, mask,
                   cos_t, sin_t, scale_q, int(bool(causal)), stream)


def _maps_args(ops: _BwdOps):
    return (ops.qh.data_ptr(), ops.kh.data_ptr(), ops.v.data_ptr(),
            ops.do.data_ptr(), ctypes.addressof(ops.geo), ops.lse.data_ptr(),
            ops.delta.data_ptr(), _ptr(ops.mask), _ptr(ops.cos_t),
            _ptr(ops.sin_t))


def _dq_pass(ops: _BwdOps) -> torch.Tensor:
    b, l, h, d = ops.qh.shape
    dq = torch.empty((b, l, h, d), dtype=ops.qh.dtype, device=ops.qh.device)
    err = build.library().apex_flash_attn_bwd_dq(
        *_maps_args(ops), dq.data_ptr(), b, l, h, d, ops.scale_q,
        ops.causal, _DTYPES[ops.qh.dtype], ops.stream)
    build.check(err, "flash_attn_bwd_dq")
    flash_attn_bwd_dq.launches += 1
    return dq


def _dkv_pass(ops: _BwdOps) -> Tuple[torch.Tensor, torch.Tensor]:
    b, l, h, d = ops.qh.shape
    dk = torch.empty((b, l, h, d), dtype=ops.qh.dtype, device=ops.qh.device)
    dv = torch.empty_like(dk)
    err = build.library().apex_flash_attn_bwd_dkv(
        *_maps_args(ops), dk.data_ptr(), dv.data_ptr(), b, l, h, d,
        ops.causal, _DTYPES[ops.qh.dtype], ops.stream)
    build.check(err, "flash_attn_bwd_dkv")
    flash_attn_bwd_dkv.launches += 1
    return dk, dv


def _fused_launch(ops: _BwdOps, counter):
    """One launch of the fused backward (``csrc/flash_bwd_fused_sm90.cu``)
    on prepared operands, counted in ``counter.launches`` (K4 or K18);
    returns ``(planes, dk, dv)``: the fp32 dq partial planes (unreached
    causal rows left unwritten) and dk, dv in q's dtype."""
    b, l, h, d = ops.qh.shape
    planes = torch.empty((-(-l // BWD_KEY_TILE), b, l, h, d),
                         dtype=torch.float32, device=ops.qh.device)
    dk = torch.empty((b, l, h, d), dtype=ops.qh.dtype, device=ops.qh.device)
    dv = torch.empty_like(dk)
    err = build.library().apex_flash_bwd_fused(
        *_maps_args(ops), planes.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, l, h, d, ops.causal, _DTYPES[ops.qh.dtype], ops.stream)
    build.check(err, counter.__name__)
    counter.launches += 1
    return planes, dk, dv


def _finish(planes: torch.Tensor, cos_t, sin_t, scale_q: float,
            causal: int, dtype: torch.dtype, stream: int) -> torch.Tensor:
    """One launch of the finish pass on checked operands, counted in
    ``flash_bwd_finish.launches``: dq in ``dtype``."""
    n, b, l, h, d = planes.shape
    dq = torch.empty((b, l, h, d), dtype=dtype, device=planes.device)
    err = build.library().apex_flash_bwd_finish(
        planes.data_ptr(), _ptr(cos_t), _ptr(sin_t), dq.data_ptr(), b, l, h,
        d, n, scale_q, causal, _DTYPES[dtype], stream)
    build.check(err, "flash_bwd_finish")
    flash_bwd_finish.launches += 1
    return dq


def _fused_pass(ops: _BwdOps, counter
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` by the fused route on prepared operands: one K4 /
    K18 launch (counted in ``counter.launches``), then the finish pass."""
    planes, dk, dv = _fused_launch(ops, counter)
    return (_finish(planes, ops.cos_t, ops.sin_t, ops.scale_q, ops.causal,
                    ops.qh.dtype, ops.stream), dk, dv)


def flash_bwd_finish_ref(planes: torch.Tensor, *, causal: bool = False,
                         rope: Rope = None, scale: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """dq from the fused backward's fp32 partial planes ``(n, B, L, H,
    D)`` (plane j: the keys ``64 j ..``): each row's planes summed in
    ascending j in fp32, under causality only those that reach the row (j
    <= l / 64: the other rows of a plane are never written); the sum
    inverse-rotated in fp32 by the tables (cast to ``dtype``), rounded to
    ``dtype`` and multiplied by the scale in ``dtype`` (the scale rounded
    to it)."""
    n, b, l, h, d = planes.shape
    acc = torch.zeros((b, l, h, d), dtype=torch.float32,
                      device=planes.device)
    for j in range(n):
        r0 = BWD_KEY_TILE * j if causal else 0
        acc[:, r0:] += planes[j, :, r0:]
    return _unrotate(acc, rope, dtype).to(dtype) \
        * torch.tensor(scale, dtype=dtype)


def flash_bwd_finish(planes: torch.Tensor, *, causal: bool = False,
                     rope: Rope = None, scale: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """:func:`flash_bwd_finish_ref`'s function: on CUDA tensors one launch
    of the finish pass (``csrc/flash_bwd_fused_sm90.cu``, counted in
    ``flash_bwd_finish.launches``; bitwise the plain version's), contiguous
    fp32 planes, ``dtype`` bf16 or fp16, D a multiple of 8; on CPU tensors
    the plain version."""
    if planes.device.type == "cpu":
        return flash_bwd_finish_ref(planes, causal=causal, rope=rope,
                                    scale=scale, dtype=dtype)
    what = "flash_bwd_finish"
    if planes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {planes.device}")
    if planes.dim() != 5 or planes.dtype != torch.float32 \
            or not planes.is_contiguous() or dtype not in HALF_DTYPES \
            or planes.shape[-1] % 8:
        raise ValueError(f"{what}: want contiguous fp32 (n, B, L, H, D) "
                         f"planes, D a multiple of 8, and a bf16 / fp16 "
                         f"dtype; got {planes.dtype} {tuple(planes.shape)}"
                         f" -> {dtype}")
    _, b, l, _, d = planes.shape
    cos_t = sin_t = None
    if rope is not None:
        cos_t, sin_t = (t.to(dtype).contiguous() for t in rope)
        for t in (cos_t, sin_t):
            if t.shape != (b, l, d) or t.device != planes.device:
                raise ValueError(f"{what}: rope tables must be ({b}, {l}, "
                                 f"{d}) on {planes.device}")
    return _finish(planes, cos_t, sin_t, _half_scale(scale, dtype),
                   int(bool(causal)), dtype, build.stream_of(planes))


flash_bwd_finish.launches = 0


def flash_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, *, causal: bool = False,
                      kv_mask: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None, rope: Rope = None
                      ) -> torch.Tensor:
    """:func:`flash_attn_bwd_dq_ref`'s function, the dq pass of the
    two-pass backward.  On CUDA tensors :func:`flash_bwd_prologue`, then
    one launch of K13 (``csrc/flash_attn_bwd_dq.cu``, counted in
    ``flash_attn_bwd_dq.launches``): bf16 or fp16, D a multiple of 8 up to
    128,
    any strides that :func:`tma_geometry` takes; dq accumulates in
    registers over the key tiles and is written once, scale applied, with
    no partial planes.  On CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_attn_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                     kv_mask=kv_mask, scale=scale,
                                     rope=rope)
    return _dq_pass(_bwd_operands("flash_attn_bwd_dq", q, k, v, do, lse,
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
    return _dkv_pass(_bwd_operands("flash_attn_bwd_dkv", q, k, v, do, lse,
                                   delta, causal, kv_mask, scale, rope))


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
    ops = _bwd_operands("flash_attn_bwd", q, k, v, do, lse, delta, **kw)
    return (_dq_pass(ops), *_dkv_pass(ops))


def _simt_bwd(what, q, k, v, do, lse, delta, mask, cos_t, sin_t, scale_q,
              causal):
    """The generic backward (``csrc/flash_simt.cu``) on checked operands,
    in the layout of :func:`simt_layout`: two launches (dk / dv, then dq)
    counted in ``flash_bwd_simt.launches``; returns dq in fp32 before its
    deferred scale, dk and dv."""
    b, l, h, d = q.shape
    dq = torch.empty((b, l, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = build.library().apex_flash_bwd_simt(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(cos_t),
        _ptr(sin_t), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        b, l, h, d, scale_q, int(bool(causal)), _DTYPES[q.dtype],
        _LAYOUTS[simt_layout(q.dtype, d)], build.stream_of(q))
    build.check(err, what)
    flash_bwd_simt.launches += 2
    return dq, dk, dv


def flash_bwd_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   dlse: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, rope: Rope = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attn_bwd_ref`'s function by the generic kernels alone,
    whatever the route (the cases :func:`bwd_route` sends them: fp32, and
    half types above D 128).  On CUDA tensors two launches counted in
    ``flash_bwd_simt.launches``, then dq cast and scaled in q's dtype; on
    CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_attn_bwd_ref(q, k, v, o, lse, do, dlse=dlse,
                                  causal=causal, kv_mask=kv_mask,
                                  scale=scale, rope=rope)
    what = "flash_bwd_simt"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    do, lse, delta, mask, cos_t, sin_t = _check_bwd(
        what, q, k, v, do, lse, attn_delta(o, do, dlse), kv_mask, rope)
    scale = _default_scale(q, scale)
    dq, dk, dv = _simt_bwd(what, q, k, v, do, lse, delta, mask, cos_t,
                           sin_t, _half_scale(scale, q.dtype), causal)
    return dq.to(q.dtype) * torch.tensor(scale, dtype=q.dtype), dk, dv


flash_bwd_simt.launches = 0


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   dlse: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, rope: Rope = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attn_bwd_ref`'s function, by the route
    :func:`bwd_route` picks, as the JAX package's ``_flash_bwd_rule``
    picks its own: the fused backward while its dq partial planes
    (:func:`fused_bwd_partials_bytes`) fit :func:`fused_bwd_max_bytes`,
    else the two-pass backward (:func:`two_pass_bwd`: one prologue, then
    K13 and K14).  The route is the same on the CPU, where each runs its
    plain version.

    On CUDA tensors: bf16 / fp16 up to D 128 within the budget,
    :func:`flash_bwd_prologue`, one launch of K4 (counted in
    ``flash_attn_bwd.launches``), where each 64 keys write their fp32 dq
    contribution into their own partial plane, then one launch of the
    finish pass (``flash_bwd_finish.launches``), which sums the planes in
    a fixed order, inverse-rotates, rounds and applies the deferred
    scale; planes over the budget, the two-pass kernels; fp32 at any
    width, and half types above D 128, the generic kernels (dk and dv,
    then dq, written directly: no planes, counted in
    ``flash_bwd_simt.launches``).  No atomics on any route: two runs give
    equal bits.  ``delta`` (``rowsum(o * do) - dlse``) is plain PyTorch,
    as the JAX path leaves it to XLA."""
    if not fused_bwd(q):
        return two_pass_bwd(q, k, v, do, lse, attn_delta(o, do, dlse),
                            causal=causal, kv_mask=kv_mask, scale=scale,
                            rope=rope)
    if q.device.type == "cpu":
        return flash_attn_bwd_ref(q, k, v, o, lse, do, dlse=dlse,
                                  causal=causal, kv_mask=kv_mask,
                                  scale=scale, rope=rope)
    what = "flash_attn_bwd"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    delta = attn_delta(o, do, dlse)
    if q.dim() == 4 and bwd_route(q.dtype, q.shape[-1], 0, 0) != "simt":
        return _fused_pass(_bwd_operands(what, q, k, v, do, lse, delta,
                                         causal, kv_mask, scale, rope),
                           flash_attn_bwd)
    do, lse, delta, mask, cos_t, sin_t = _check_bwd(
        what, q, k, v, do, lse, delta, kv_mask, rope)
    scale = _default_scale(q, scale)
    dq, dk, dv = _simt_bwd(what, q, k, v, do, lse, delta, mask, cos_t,
                           sin_t, _half_scale(scale, q.dtype), causal)
    return dq.to(q.dtype) * torch.tensor(scale, dtype=q.dtype), dk, dv


flash_attn_bwd.launches = 0
