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

from functools import lru_cache
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.cuda import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: K1's routes (``ln_fwd_route``) and their codes in the C entry point
LN_FWD_ROUTES = {"warp": 0, "block": 1, "loop": 2}
#: the warp route holds a row in one warp's registers: at most 8 groups
#: of 16 bytes a lane (2048 bf16 / fp16, 1024 fp32 elements)
WARP_GROUPS_MAX = 32 * 8
#: the block route holds a row in one block's registers: at most 1024
#: threads of 2 groups (16384 bf16 / fp16, 8192 fp32 elements)
BLOCK_GROUPS_MAX = 1024 * 2
#: at most this many rows take the block route (a row a block) where the
#: warp route could hold them; more take the warp route (a row a warp,
#: four a block).  The crossover measured on the card (PERF.md).
BLOCK_ROWS_MAX = 512


def ln_fwd_route(n1: int, n2: int, dtype: torch.dtype,
                 aligned: bool = True) -> str:
    """K1's kernel for ``(n1, n2)`` rows of ``dtype``: ``"<kind>_vec"``
    (16-byte loads and stores: ``aligned`` says that x, w and b start on
    16-byte boundaries, and n2 must be a multiple of ``16 / itemsize``)
    or ``"<kind>_scalar"`` (element accesses, any offset and width).
    ``kind``: ``"block"`` (a row a block) for at most
    :data:`BLOCK_ROWS_MAX` rows, or for rows wider than the warp route
    holds; ``"warp"`` (a row a warp) for more rows; ``"loop"`` (three
    passes a row) for rows wider than a block holds."""
    per = 16 // dtype.itemsize
    groups = -(-n2 // per)
    if groups > BLOCK_GROUPS_MAX:
        kind = "loop"
    elif n1 <= BLOCK_ROWS_MAX or groups > WARP_GROUPS_MAX:
        kind = "block"
    else:
        kind = "warp"
    vec = aligned and n2 % per == 0
    return f"{kind}_{'vec' if vec else 'scalar'}"


@lru_cache(maxsize=512)
def _mode(n1: int, n2: int, dtype: torch.dtype, w_code: int,
          aligned: bool, route: Optional[str]) -> int:
    """The C entry point's ``mode`` word: x's and w's dtype codes, the
    route (``ln_fwd_route``'s, or ``route`` when given) and the vector
    bit."""
    route = route or ln_fwd_route(n1, n2, dtype, aligned)
    kind, _, access = route.partition("_")
    if kind not in LN_FWD_ROUTES or access not in ("vec", "scalar"):
        raise ValueError(f"layer_norm_fwd: no route {route!r}")
    if access == "vec" and ln_fwd_route(n1, n2, dtype, aligned)[-3:] \
            != "vec":
        raise ValueError(f"layer_norm_fwd: route {route} needs 16-byte "
                         f"aligned x, w, b and n2 a multiple of 16 bytes")
    return (_DTYPES[dtype] | w_code << 2 | LN_FWD_ROUTES[kind] << 4
            | (access == "vec") << 6)


#: K3's routes (``ln_bwd_route``) and their codes in the C entry point
LN_BWD_ROUTES = {"warp": 0, "block": 1, "loop": 2}
#: K3's warp route holds a row in one warp's registers: at most 32
#: 16-bit or 24 fp32 elements a lane (1024 or 768 in all)
BWD_WARP_ELEMS_MAX = {2: 32 * 32, 4: 32 * 24}
#: K3's block route holds a row in one block's registers: at most 512
#: threads of up to 16 elements (8192 elements in all, in any dtype)
BWD_BLOCK_ELEMS_MAX = 8192
#: at most this many rows take K3's block route (a row a block) where the
#: warp route could hold them, so that few rows still reach many SMs
BWD_BLOCK_ROWS_MAX = 64


def ln_bwd_route(n1: int, n2: int, dtype: torch.dtype,
                 aligned: bool = True) -> str:
    """K3's stage 1 for ``(n1, n2)`` rows of ``dtype``: ``"<kind>_vec"``
    (16-byte groups: ``aligned`` says that dy, x, dx and w start on
    16-byte boundaries, and n2 must be a multiple of ``16 / itemsize``) or
    ``"<kind>_scalar"`` (element accesses).  ``kind``: ``"warp"`` (a row a
    warp, each warp walking rows in a fixed stride) for rows of up to
    :data:`BWD_WARP_ELEMS_MAX` elements (by itemsize) and more than
    :data:`BWD_BLOCK_ROWS_MAX` rows; ``"block"`` (a row a block) for fewer
    rows or wider rows, up to :data:`BWD_BLOCK_ELEMS_MAX` elements;
    ``"loop"`` (three passes a row, element accesses) above."""
    per = 16 // dtype.itemsize
    if n2 > BWD_BLOCK_ELEMS_MAX:
        return "loop_scalar"
    if n2 <= BWD_WARP_ELEMS_MAX[dtype.itemsize] and n1 > BWD_BLOCK_ROWS_MAX:
        kind = "warp"
    else:
        kind = "block"
    vec = aligned and n2 % per == 0
    return f"{kind}_{'vec' if vec else 'scalar'}"


@lru_cache(maxsize=512)
def _bwd_mode(n1: int, n2: int, dtype: torch.dtype, w_code: int,
              aligned: bool) -> int:
    """K3's C entry point ``mode`` word: x's and w's dtype codes, the
    route of :func:`ln_bwd_route` and the vector bit."""
    kind, _, access = ln_bwd_route(n1, n2, dtype, aligned).partition("_")
    return (_DTYPES[dtype] | w_code << 2 | LN_BWD_ROUTES[kind] << 4
            | (access == "vec") << 6)


@lru_cache(maxsize=512)
def _bwd_parts(n1: int, n2: int, mode: int) -> int:
    """Partial rows K3's stage 1 writes on ``mode``'s route (the C entry
    point's count, by shape: the call's host path skips the C call)."""
    return build.library().apex_layer_norm_bwd_parts(n1, n2, mode)


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


def _refuse(x, weight, bias):
    """The refusal for arguments the fast checks turned down."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x.device}")
    if x.dim() == 0 or not x.is_contiguous() or x.shape[-1] == 0:
        raise ValueError("layer_norm_fwd: x must be a contiguous tensor of "
                         f"rows (..., n2), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fwd: x dtype {x.dtype} unsupported")
    if (weight is None) != (bias is None):
        raise ValueError("layer_norm_fwd: give both weight and bias or "
                         "neither")
    n2 = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (n2,) or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"layer_norm_fwd: {name} must be a "
                             f"contiguous ({n2},) tensor on {x.device}")
    raise TypeError("layer_norm_fwd: weight/bias must share a dtype, "
                    "float32 or x's")


def layer_norm_fwd(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float,
                   stats: bool = True, route: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """:func:`layer_norm_fwd_ref`'s function over the rows of ``x``: its
    last dimension (``n2``), ``n1 = x.numel() / n2`` rows; ``y`` has x's
    shape.  On a CUDA tensor, one launch of the hand-written kernel
    (counted in ``layer_norm_fwd.launches``) on the route
    :func:`ln_fwd_route` picks (``route`` names another, to compare
    them).  ``stats=False`` returns ``(y, None, None)`` and, on the
    card, stores no mean and inv (``y``'s bits are the same).  The
    checks come first in their cheapest form; a refusal is a
    ``ValueError`` (device, layout, shapes) or a ``TypeError`` (dtypes),
    with its message built only then."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            _refuse(x, weight, bias)
        n2 = x.shape[-1]
        y, mean, inv = layer_norm_fwd_ref(x.reshape(-1, n2), weight, bias,
                                          eps)
        y = y.view(x.shape)
        return (y, mean, inv) if stats else (y, None, None)
    dtype = x.dtype
    if dtype not in _DTYPES or not x.is_contiguous() or x.dim() == 0:
        _refuse(x, weight, bias)
    n2 = x.shape[-1]
    if n2 == 0:
        _refuse(x, weight, bias)
    n1 = x.numel() // n2
    xp = x.data_ptr()
    if weight is None:
        if bias is not None:
            _refuse(x, weight, bias)
        wp = bp = None
        w_code = 0
        aligned = xp % 16 == 0
    else:
        wdt = weight.dtype
        dev = x.get_device()
        if bias is None or bias.dtype != wdt or not (
                wdt == torch.float32 or wdt == dtype) \
                or weight.shape != (n2,) or bias.shape != (n2,) \
                or not (weight.is_contiguous() and bias.is_contiguous()) \
                or weight.get_device() != dev or bias.get_device() != dev:
            _refuse(x, weight, bias)
        wp, bp = weight.data_ptr(), bias.data_ptr()
        w_code = _DTYPES[wdt]
        aligned = (xp | wp | bp) % 16 == 0
    y = torch.empty_like(x)
    mp = ip = mean = inv = None
    if stats:
        # two allocations: on the card's host they cost less than one
        # (2, n1) buffer and its two views (chip_split.py, ln_decode_split)
        dev = x.device
        mean = torch.empty(n1, dtype=torch.float32, device=dev)
        inv = torch.empty(n1, dtype=torch.float32, device=dev)
        mp, ip = mean.data_ptr(), inv.data_ptr()
    if n1 == 0:
        return y, mean, inv
    err = build.library().apex_layer_norm_fwd(
        xp, wp, bp, y.data_ptr(), mp, ip, n1, n2, eps,
        _mode(n1, n2, dtype, w_code, aligned, route), build.stream_of(x))
    if err:
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
    partials on the route :func:`ln_bwd_route` picks, then (with a
    weight) their fixed-order sum, two launches counted in
    ``layer_norm_bwd.launches`` (one without a weight)."""
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
    ptrs = [dy.data_ptr(), x2d.data_ptr(), dx.data_ptr()]
    if weight is not None:
        if weight.shape != (n2,) or not weight.is_contiguous() \
                or weight.device != x2d.device \
                or weight.dtype not in (torch.float32, x2d.dtype):
            raise ValueError("layer_norm_bwd: weight must be a contiguous "
                             f"({n2},) tensor, float32 or x's dtype")
        w_code = _DTYPES[weight.dtype]
        ptrs.append(weight.data_ptr())
    mode = _bwd_mode(n1, n2, x2d.dtype, w_code,
                     all(p % 16 == 0 for p in ptrs))
    if weight is not None:
        dw = torch.empty_like(weight)
        db = torch.empty_like(weight)
        parts = _bwd_parts(n1, n2, mode)
        part_w = torch.empty((max(parts, 1), n2), dtype=torch.float32,
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
        ptr(part_b), n1, n2, mode, build.stream_of(x2d))
    build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1 if weight is None else 2
    return dx, dw, db


layer_norm_bwd.launches = 0
