"""K16: the fused backward of a 1x1 stride-1 NHWC convolution
(``csrc/conv1x1_bwd.cu``) and its plain PyTorch version.

The CUDA kernel replaces the Pallas ``_bwd_fused`` (``_bwd_kernel``) of
``apex_tpu/ops/pallas/experimental/conv1x1.py``.  A 1x1 stride-1 conv is
a matrix product over the flat ``(M, C)`` view, ``M = B * H * W``, so its
backward is two products sharing ``dy``: ``dx = dy @ W^T`` and ``dW =
x^T @ dy``, both summed in fp32.

:func:`conv1x1` is the routed conv: the library conv forward (as JAX's is
XLA's) and :func:`conv1x1_bwd` as its backward.  :func:`routeable` is the
JAX package's eligibility predicate, :func:`enabled` its switch
(``APEX_TPU_FUSED_CONV1X1=1``, read on every call, off by default);
:func:`apex_tpu_torch.amp.ops.conv_general_dilated` asks both.
:func:`conv1x1_bwd` launches the kernel for CUDA tensors and runs
:func:`conv1x1_bwd_ref` for CPU tensors; it never falls back from one to
the other.  On the card it takes one of three routes that
:func:`conv1x1_route` picks (two Hopper kernels on TMA and ``wgmma`` for
bf16 / fp16, CUDA-core FMAs for fp32 and for what TMA cannot take).
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops.cuda import build

ENV = "APEX_TPU_FUSED_CONV1X1"
DN = ("NHWC", "HWIO", "NHWC")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: K16's routes (``conv1x1_route``) and their codes in the C entry point
ROUTES = {"fma": 0, "one_pass": 1, "two_role": 2}
#: one_pass holds all of dW in the consumers' registers: at most this many
#: 64 x 64 tiles of it (cin x cout <= 256 x 128)
ONE_PASS_TILES_MAX = 8


def conv1x1_route(m: int, cin: int, cout: int, dtype: torch.dtype,
                  aligned: bool = True) -> str:
    """K16's kernel for ``x (m, cin)``, ``dy (m, cout)`` of ``dtype``:
    ``"fma"`` (CUDA-core fp32 FMAs) for fp32, and for bf16 / fp16 whose
    channel counts are not multiples of 8 or whose pointers are not
    16-byte ``aligned`` (TMA needs a 16-byte row pitch and base);
    ``"one_pass"`` (x and dy read once, dW in registers) where dW is at
    most :data:`ONE_PASS_TILES_MAX` tiles of 64 x 64; ``"two_role"`` (dx
    blocks and split-M dW blocks in one launch) above.  ``m`` sizes each
    route's grid; it decides the route only from 2^31 rows up (``fma``:
    TMA's coordinates are 32-bit)."""
    if dtype == torch.float32 or not aligned or cin % 8 or cout % 8 \
            or m >= 2 ** 31:
        return "fma"
    if -(-cin // 64) * -(-cout // 64) <= ONE_PASS_TILES_MAX:
        return "one_pass"
    return "two_role"


@lru_cache(maxsize=256)
def _sizes(m: int, cin: int, cout: int, code: int) -> Tuple[int, int]:
    """(fp32 partial floats, ticket words) a launch on route ``code``
    needs, by shape: the call's host path skips the C calls."""
    lib = build.library()
    return (lib.apex_conv1x1_bwd_part_floats(m, cin, cout, code),
            lib.apex_conv1x1_bwd_tickets(m, cin, cout, code))


def plan(m: int, cin: int, cout: int, route: str) -> Dict[str, int]:
    """The launch a route makes for a shape (for records): ``blocks``,
    ``dw_blocks`` (two_role, fma), ``planes`` (fp32 dW partial planes)
    and ``stages`` (the TMA ring's, on the Hopper routes)."""
    out = (ctypes.c_longlong * 4)()
    build.library().apex_conv1x1_bwd_plan(m, cin, cout, ROUTES[route], out)
    return dict(zip(("blocks", "dw_blocks", "planes", "stages"), out))


def enabled() -> bool:
    """Whether eligible convs route here: ``APEX_TPU_FUSED_CONV1X1=1``."""
    return os.environ.get(ENV, "0") == "1"


def routeable(x, kernel, window_strides, padding, dimension_numbers,
              kwargs) -> bool:
    """Is this conv an eligible 1x1 stride-1 NHWC case, with the switch
    on?  The JAX package's predicate: a 4-d x and HWIO kernel of one
    dtype (bf16, fp16 or fp32), a 1x1 window, stride 1, explicit
    NHWC/HWIO/NHWC dimension numbers, no extra arguments, and padding
    ``"SAME"``, ``"VALID"`` or explicit zeros."""
    if not enabled() or kwargs:
        return False
    if getattr(x, "ndim", 0) != 4 or getattr(kernel, "ndim", 0) != 4:
        return False
    if kernel.shape[0] != 1 or kernel.shape[1] != 1:
        return False
    if tuple(window_strides) != (1, 1):
        return False
    # None would mean NCHW/OIHW operands, which this product misreads
    if dimension_numbers is None or tuple(dimension_numbers) != DN:
        return False
    if x.dtype != kernel.dtype or x.dtype not in _DTYPES:
        return False
    if isinstance(padding, str):
        return padding in ("SAME", "VALID")
    try:
        return all(tuple(p) == (0, 0) for p in padding)
    except TypeError:
        return False


def conv1x1_bwd_ref(x2d: torch.Tensor, dy2d: torch.Tensor,
                    w2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of ``y = x2d @ w2d`` for the cotangent ``dy2d``: ``dx =
    dy @ w^T`` and ``dw = x^T @ dy``, each in fp32 and cast to x's and w's
    dtype."""
    dy = dy2d.float()
    return ((dy @ w2d.float().t()).to(x2d.dtype),
            (x2d.float().t() @ dy).to(w2d.dtype))


#: per device, the fma route's dW tiles' tickets (uint32, zero between
#: launches: each launch leaves them zero); grown to the largest count seen
_TICKETS: Dict[torch.device, torch.Tensor] = {}
#: per device, the Hopper routes' grid barrier (arrivals, generation; the
#: arrivals are zero between launches)
_GRID_SYNC: Dict[torch.device, torch.Tensor] = {}


def _tickets(dev: torch.device, n: int, route: str) -> torch.Tensor:
    if route != "fma":
        t = _GRID_SYNC.get(dev)
        if t is None:
            t = _GRID_SYNC[dev] = torch.zeros(2, dtype=torch.int32,
                                              device=dev)
        return t
    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        t = torch.zeros(n, dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def conv1x1_bwd(x2d: torch.Tensor, dy2d: torch.Tensor, w2d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`conv1x1_bwd_ref`'s function for contiguous ``x2d (M, cin)``,
    ``dy2d (M, cout)`` and ``w2d (cin, cout)`` of one dtype.  On CUDA
    tensors one launch of the hand-written kernel (counted in
    ``conv1x1_bwd.launches``) on the route :func:`conv1x1_route` picks:
    dx, and dW summed in fp32 over chunks of M into partial planes that
    are added in a fixed order, so two runs give equal bits.  Calls on
    one device share the tickets: run them on one stream."""
    if x2d.device.type == "cpu":
        return conv1x1_bwd_ref(x2d, dy2d, w2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"conv1x1_bwd: unsupported device {x2d.device}")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"conv1x1_bwd: dtype {x2d.dtype} unsupported")
    if x2d.dim() != 2 or dy2d.dim() != 2 or w2d.dim() != 2:
        raise ValueError("conv1x1_bwd: x, dy and w must be 2-d")
    m, cin = x2d.shape
    cout = dy2d.shape[1]
    if dy2d.shape[0] != m or tuple(w2d.shape) != (cin, cout):
        raise ValueError(f"conv1x1_bwd: shapes x {tuple(x2d.shape)}, dy "
                         f"{tuple(dy2d.shape)}, w {tuple(w2d.shape)} do "
                         "not match")
    for name, t in (("dy", dy2d), ("w", w2d)):
        if t.dtype != x2d.dtype or t.device != x2d.device:
            raise ValueError(f"conv1x1_bwd: {name} must match x's dtype "
                             "and device")
    if not (x2d.is_contiguous() and dy2d.is_contiguous()
            and w2d.is_contiguous()):
        raise ValueError("conv1x1_bwd: x, dy and w must be contiguous")
    dx = torch.empty_like(x2d)
    dw = torch.empty_like(w2d)
    if m == 0 or cin == 0 or cout == 0:
        dx.zero_()
        return dx, dw.zero_()
    lib = build.library()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2d, dy2d, w2d, dx, dw))
    route = conv1x1_route(m, cin, cout, x2d.dtype, aligned)
    code = ROUTES[route]
    floats, words = _sizes(m, cin, cout, code)
    part = torch.empty(floats, dtype=torch.float32, device=x2d.device)
    tickets = _tickets(x2d.device, words, route)
    per_vec = 16 // x2d.element_size()
    vec = int(aligned and cin % per_vec == 0 and cout % per_vec == 0)
    err = lib.apex_conv1x1_bwd(
        x2d.data_ptr(), dy2d.data_ptr(), w2d.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), tickets.data_ptr(), m, cin, cout,
        _DTYPES[x2d.dtype] | code << 2 | vec << 4, build.stream_of(x2d))
    build.check(err, "conv1x1_bwd")
    conv1x1_bwd.launches += 1
    return dx, dw


conv1x1_bwd.launches = 0


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x.permute(0, 3, 1, 2),
                        w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        b, h, wd, cin = x.shape
        cout = w.shape[-1]
        m = b * h * wd
        dx, dw = conv1x1_bwd(x.reshape(m, cin).contiguous(),
                             dy.reshape(m, cout).contiguous(),
                             w.reshape(cin, cout).contiguous())
        return dx.reshape(x.shape), dw.reshape(w.shape)


def conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 stride-1 NHWC conv, ``x (B, H, W, cin)``, ``w (1, 1, cin,
    cout)``: the library conv forward (the one the unrouted path takes),
    :func:`conv1x1_bwd` as its backward."""
    return _Conv1x1.apply(x, w)
