"""The policy-aware op layer of amp O1, as ``apex_tpu/amp/ops.py``, and
the conv route every convolution of the port takes.

1. A thread-local cast policy: :func:`cast_context` turns O1 op casting
   on for its extent (``Amp.run`` enters it when the policy has
   ``cast_ops``), :func:`disable_casts` suspends it, :func:`active_policy`
   reads it.  :func:`recompute_context` carries it into the recompute of
   ``torch.utils.checkpoint``, which runs on autograd's thread.
2. Decorators for user functions, :func:`half_function`,
   :func:`float_function`, :func:`promote_function` and
   :func:`banned_function`, with the ``register_*`` forms that patch a
   module attribute and :func:`deactivate_registrations` that undoes them.
3. The op namespace the ported layers and models call, one op per entry
   of :mod:`apex_tpu_torch.amp.lists`, with the JAX package's signatures
   (``axis=``, ``keepdims=``): under a policy each casts its floating
   inputs as the JAX op does (half, fp32, widest), and outside one it
   passes them through unchanged, so O0, O2 and O3 compute what they
   computed before.  ``linear`` adds its bias in the product's dtype.

The conv route (:func:`conv_general_dilated`, :func:`conv_transpose`):
activations stay NHWC and kernels HWIO, as in the JAX package; the
library conv sees them as ``x.permute(0, 3, 1, 2)`` (on a contiguous NHWC
tensor that view is channels-last, so nothing is copied) and
``kernel.permute(3, 2, 0, 1)``.  lax's padding (``"SAME"``, ``"VALID"``,
explicit pairs) becomes explicit, possibly asymmetric pads
(:func:`pads_of`, lax's ``padtype_to_pads``): the symmetric ones ride the
conv, the others an ``F.pad`` before it.  ``lhs_dilation`` (the
transposed conv) spreads the input with zeros first; lax's transposed
padding is :func:`conv_transpose_pads`.  With
``APEX_TPU_FUSED_CONV1X1=1`` each eligible 1x1 stride-1 conv goes to
:func:`apex_tpu_torch.ops.cuda.conv1x1.conv1x1` (its backward is K16).

The fp8 (O4) half: under a policy with ``fp8`` and an open
:func:`fp8_trace` (``make_train_step`` opens one around the forward),
each contraction (``FP8_OPS``) casts its first two floating operands
(the input and weight classes) to the half dtype, records their amaxes
on the trace and quantize-dequantizes them onto e4m3 at the delayed
scales (:func:`apex_tpu_torch.quant.fp8.qdq_ste`: the cotangent passes
unrounded), half-casts the rest, and rounds its output's cotangent onto
e5m2 (:func:`~apex_tpu_torch.quant.fp8.bwd_qdq`).  Every e4m3 value is a
bf16 value, so the product of the rounded bf16 operands accumulates what
an fp8-operand product would.  Without an open trace (a bare
``Amp.run`` under O4) the contractions take the plain half cast, as the
JAX package's do.
"""

from __future__ import annotations

import contextlib
import functools
import string
import threading
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp.policy import Properties
from apex_tpu_torch.ops.cuda import conv1x1 as c1
from apex_tpu_torch.quant import fp8 as fp8_lib

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
Padding = Union[str, Sequence[Tuple[int, int]]]


class _CastState(threading.local):
    def __init__(self):
        self.policy: Optional[Properties] = None
        self.disable_depth: int = 0


_state = _CastState()


def active_policy() -> Optional[Properties]:
    """The policy in effect for op casting, or None."""
    if _state.disable_depth > 0:
        return None
    p = _state.policy
    if p is not None and p.enabled and p.cast_ops:
        return p
    return None


@contextlib.contextmanager
def cast_context(props: Optional[Properties]):
    """O1 op casting under ``props`` for the dynamic extent (``Amp.run``
    enters it around the model and loss of an O1 step)."""
    prev = _state.policy
    _state.policy = props
    try:
        yield
    finally:
        _state.policy = prev


@contextlib.contextmanager
def disable_casts():
    """Suspend op casting, e.g. to run a numerically sensitive region in
    fp32 inside an O1 step."""
    _state.disable_depth += 1
    try:
        yield
    finally:
        _state.disable_depth -= 1


@contextlib.contextmanager
def _state_set(policy: Optional[Properties], depth: int):
    prev = (_state.policy, _state.disable_depth)
    _state.policy, _state.disable_depth = policy, depth
    try:
        yield
    finally:
        _state.policy, _state.disable_depth = prev


def recompute_context():
    """``(forward, recompute)`` contexts for ``torch.utils.checkpoint``'s
    ``context_fn``: the recompute, which autograd may run on another
    thread, sees the policy (and the :func:`disable_casts` depth) and the
    fp8 trace's scales that the forward saw, so it computes in the same
    dtypes on the same fp8 grids (its amaxes are not recorded again)."""
    return contextlib.nullcontext(), _recompute_state(
        _state.policy, _state.disable_depth, _fp8_state.scales)


@contextlib.contextmanager
def _recompute_state(policy, depth, scales):
    with _state_set(policy, depth):
        prev = (_fp8_state.scales, _fp8_state.amaxes)
        _fp8_state.scales = scales
        _fp8_state.amaxes = {"input": [], "weight": []}
        try:
            yield
        finally:
            _fp8_state.scales, _fp8_state.amaxes = prev


# -- fp8 (O4) operand quantization ---------------------------------------------

class _Fp8TraceState(threading.local):
    def __init__(self):
        self.scales = None    # {"input", "weight", "grad"}: 0-d fp32
        self.amaxes = None    # {"input", "weight"}: lists of 0-d fp32


_fp8_state = _Fp8TraceState()


@contextlib.contextmanager
def fp8_trace(fp8_train_state, grad_scale=None):
    """fp8 operand quantization for the dynamic extent: the
    :class:`~apex_tpu_torch.quant.fp8.Fp8TrainState` gives the delayed
    scales, and each call's forward amaxes collect on the yielded object
    (``.amaxes``) for the end-of-step roll.  ``grad_scale`` overrides the
    e5m2 cotangent scale: the train step passes ``grad.scale /
    loss_scale``, since the cotangents are loss-scaled while the grad
    history is kept in unscaled units."""
    prev = (_fp8_state.scales, _fp8_state.amaxes)
    _fp8_state.scales = {"input": fp8_train_state.input.scale,
                         "weight": fp8_train_state.weight.scale,
                         "grad": (grad_scale if grad_scale is not None
                                  else fp8_train_state.grad.scale)}
    _fp8_state.amaxes = {"input": [], "weight": []}
    try:
        yield _fp8_state
    finally:
        _fp8_state.scales, _fp8_state.amaxes = prev


def _active_fp8():
    """The open fp8 trace, or None: it takes an fp8 policy in effect and
    an open :func:`fp8_trace`."""
    p = active_policy()
    if p is None or not p.fp8 or _fp8_state.scales is None:
        return None
    return _fp8_state


def collected_fp8_amaxes(trace) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trace's per-call amaxes reduced to one ``(input, weight)``
    pair of 0-d fp32 tensors (zeros when nothing was quantized)."""
    out = []
    for kind in ("input", "weight"):
        vals = trace.amaxes.get(kind, [])
        out.append(torch.stack(vals).amax() if vals else torch.zeros(
            (), dtype=torch.float32,
            device=trace.scales["input"].device))
    return tuple(out)


def _fp8_call(fn, args, kwargs, p):
    """The fp8 path of a contraction: the first two floating tensor
    operands (input, weight classes) half-cast, their amaxes recorded and
    quantize-dequantized onto the forward format at the delayed scales,
    the rest half-cast, the output's cotangent rounded onto e5m2.  None
    when no trace is open or the call has fewer than two floating
    operands (the caller half-casts)."""
    tr = _active_fp8()
    if tr is None:
        return None
    flat = list(args)
    idx = [i for i, a in enumerate(flat) if _is_float(a)]
    if len(idx) < 2:
        return None
    i, j = idx[0], idx[1]
    x, w = flat[i].to(p.half_dtype), flat[j].to(p.half_dtype)
    tr.amaxes["input"].append(fp8_lib.tensor_amax(x.detach()))
    tr.amaxes["weight"].append(fp8_lib.tensor_amax(w.detach()))
    flat[i] = fp8_lib.qdq_ste(x, tr.scales["input"], p.fp8_dtype_fwd)
    flat[j] = fp8_lib.qdq_ste(w, tr.scales["weight"], p.fp8_dtype_fwd)
    rest, rkw = _cast_tree((flat[j + 1:], kwargs), p.half_dtype)
    out = fn(*flat[:j + 1], *rest, **rkw)
    return fp8_lib.bwd_qdq(out, tr.scales["grad"])


# -- cast helpers -----------------------------------------------------------

def _is_float(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor leaf cast to ``dtype``; integer and bool
    tensors and non-tensors left alone."""
    return pytree.tree_map(
        lambda x: x.to(dtype) if _is_float(x) and x.dtype != dtype else x,
        tree)


def _widest_float(tree: Any) -> Optional[torch.dtype]:
    """The widest floating dtype among the tensor leaves (the first seen
    of equal width: bf16 and fp16 tie, as in the JAX package)."""
    widest = None
    for leaf in pytree.tree_leaves(tree):
        if _is_float(leaf) and (widest is None or torch.finfo(
                leaf.dtype).bits > torch.finfo(widest).bits):
            widest = leaf.dtype
    return widest


# -- wrapper factories --------------------------------------------------------

def half_function(fn: Callable, fp8_eligible: bool = True) -> Callable:
    """Run ``fn`` with its floating inputs cast to the policy's half
    dtype.  Under an fp8 policy with an open :func:`fp8_trace` its two
    contraction operands also quantize onto e4m3 (and its cotangent onto
    e5m2), the ``FP8_OPS`` behaviour; ``fp8_eligible=False`` pins a half
    op that is no contraction (``prelu``) to the plain half cast."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = active_policy()
        if p is None:
            return fn(*args, **kwargs)
        if fp8_eligible and p.fp8:
            out = _fp8_call(fn, args, kwargs, p)
            if out is not None:
                return out
        args, kwargs = _cast_tree((args, kwargs), p.half_dtype)
        return fn(*args, **kwargs)
    wrapper.__amp_wrapped__ = "half"
    return wrapper


def fp8_function(fn: Callable) -> Callable:
    """Opt a user contraction into fp8 operand quantization: the half
    wrapper (operands quantized under an fp8 policy, half-cast under a
    16-bit one, both suspended by :func:`disable_casts`)."""
    wrapper = half_function(fn)
    wrapper.__amp_wrapped__ = "fp8"
    return wrapper


def float_function(fn: Callable) -> Callable:
    """Run ``fn`` with its floating inputs cast to fp32."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if active_policy() is None:
            return fn(*args, **kwargs)
        args, kwargs = _cast_tree((args, kwargs), torch.float32)
        return fn(*args, **kwargs)
    wrapper.__amp_wrapped__ = "float"
    return wrapper


def promote_function(fn: Callable) -> Callable:
    """Run ``fn`` with its floating inputs cast to the widest floating
    input dtype."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if active_policy() is None:
            return fn(*args, **kwargs)
        widest = _widest_float((args, kwargs))
        if widest is not None:
            args, kwargs = _cast_tree((args, kwargs), widest)
        return fn(*args, **kwargs)
    wrapper.__amp_wrapped__ = "promote"
    return wrapper


def banned_function(fn: Callable, message: str = lists.BANNED_MESSAGE,
                    allow_banned: bool = False) -> Callable:
    """Raise ``NotImplementedError`` when ``fn`` is called under a policy
    with any input in the half dtype."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = active_policy()
        if p is not None and not allow_banned:
            for leaf in pytree.tree_leaves((args, kwargs)):
                if _is_float(leaf) and leaf.dtype == p.half_dtype:
                    raise NotImplementedError(message)
        return fn(*args, **kwargs)
    wrapper.__amp_wrapped__ = "banned"
    return wrapper


def _sequence_promote(fn: Callable) -> Callable:
    """Cast a list of tensors (the first argument) to its widest floating
    dtype."""
    @functools.wraps(fn)
    def wrapper(arrays, *args, **kwargs):
        if active_policy() is None:
            return fn(arrays, *args, **kwargs)
        widest = _widest_float(list(arrays))
        if widest is not None:
            arrays = [_cast_tree(a, widest) for a in arrays]
        return fn(arrays, *args, **kwargs)
    wrapper.__amp_wrapped__ = "sequence_promote"
    return wrapper


_saved_registrations = []


def _register(module: Any, name: str, maker: Callable[[Callable], Callable]):
    orig = getattr(module, name)
    if getattr(orig, "__amp_wrapped__", None) is not None:
        return  # idempotent
    _saved_registrations.append((module, name, orig))
    setattr(module, name, maker(orig))


def register_half_function(module: Any, name: str) -> None:
    """Replace ``module.name`` by its :func:`half_function`."""
    _register(module, name, half_function)


def register_float_function(module: Any, name: str) -> None:
    """Replace ``module.name`` by its :func:`float_function`."""
    _register(module, name, float_function)


def register_promote_function(module: Any, name: str) -> None:
    """Replace ``module.name`` by its :func:`promote_function`."""
    _register(module, name, promote_function)


def register_fp8_function(module: Any, name: str) -> None:
    """Replace ``module.name`` by its :func:`fp8_function`."""
    _register(module, name, fp8_function)


def deactivate_registrations() -> None:
    """Undo every ``register_*`` patch, last first."""
    while _saved_registrations:
        module, name, orig = _saved_registrations.pop()
        setattr(module, name, orig)


# -- the conv route -----------------------------------------------------------

def pads_of(in_hw: Sequence[int], window: Sequence[int],
            strides: Sequence[int], padding: Padding,
            dilation: Sequence[int] = (1, 1)) -> Pads:
    """``((top, bottom), (left, right))`` pads of a 2-d window, as lax's
    ``padtype_to_pads``: ``"SAME"`` gives ``ceil(in / stride)`` outputs,
    the odd pixel at the end (the 7x7/2 stem at 224 pads (2, 3), a 3x3/2
    window at 112 (0, 1)); ``"VALID"`` none; explicit pairs as given."""
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0), (0, 0))
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for n, k, s, d in zip(in_hw, window, strides, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if len(pads) != 2:
        raise ValueError(f"want two (lo, hi) pairs, got {padding!r}")
    return pads


def conv_transpose_pads(window: Sequence[int], strides: Sequence[int],
                        padding: Padding) -> Pads:
    """The pads of the dilated-input conv a transposed conv is, as lax's
    ``_conv_transpose_padding`` per dimension (``window`` already
    dilated): ``"SAME"`` gives ``in * stride`` outputs, ``"VALID"``
    ``in * stride + max(k - stride, 0)``; explicit pairs as given."""
    if not isinstance(padding, str):
        return pads_of((), (), (), padding)
    out = []
    for k, s in zip(window, strides):
        if padding == "SAME":
            total = k + s - 2
            lo = k - 1 if s > k - 1 else -(-total // 2)
        elif padding == "VALID":
            total = k + s - 2 + max(k - s, 0)
            lo = k - 1
        else:
            raise ValueError(f"unknown padding {padding!r}")
        out.append((lo, total - lo))
    return tuple(out)


def pad_nchw(x: torch.Tensor, pads: Pads, value: float = 0.0
             ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``(x', sym)``: an NCHW view ``x`` and the symmetric padding a conv
    or pool takes for ``pads``; asymmetric (or negative) pads are applied
    here instead (``F.pad`` keeps the channels-last layout) and ``sym``
    is zero."""
    (t, b), (l, r) = pads
    if t == b and l == r and t >= 0 and l >= 0:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _dilate_nhwc(x: torch.Tensor, dil: Tuple[int, int]) -> torch.Tensor:
    """NHWC ``x`` with ``dil - 1`` zeros between neighbouring pixels (lax's
    ``lhs_dilation``)."""
    n, h, w, c = x.shape
    out = x.new_zeros((n, (h - 1) * dil[0] + 1, (w - 1) * dil[1] + 1, c))
    out[:, ::dil[0], ::dil[1], :] = x
    return out


def _conv_general_dilated(x: torch.Tensor, kernel: torch.Tensor,
                          window_strides: Sequence[int], padding: Padding,
                          lhs_dilation: Optional[Sequence[int]] = None,
                          rhs_dilation: Optional[Sequence[int]] = None,
                          dimension_numbers=None,
                          feature_group_count: int = 1,
                          batch_group_count: int = 1, precision=None,
                          preferred_element_type=None,
                          **kwargs) -> torch.Tensor:
    """lax's positional signature, for NHWC / HWIO / NHWC operands.
    Routes eligible 1x1 stride-1 convs to the fused-backward kernel when
    switched on (:mod:`apex_tpu_torch.ops.cuda.conv1x1`); the rest run
    through ``F.conv2d``, after spreading the input for ``lhs_dilation``.
    Batch groups, ``precision`` and ``preferred_element_type`` are not
    ported and raise."""
    extras = dict(kwargs)
    if feature_group_count != 1:
        extras["feature_group_count"] = feature_group_count
    if batch_group_count != 1:
        extras["batch_group_count"] = batch_group_count
    if precision is not None:
        extras["precision"] = precision
    if preferred_element_type is not None:
        extras["preferred_element_type"] = preferred_element_type
    if (lhs_dilation is None and rhs_dilation is None
            and c1.routeable(x, kernel, window_strides, padding,
                             dimension_numbers, extras)):
        return c1.conv1x1(x, kernel)
    if dimension_numbers is None or tuple(dimension_numbers) != c1.DN:
        raise NotImplementedError(
            f"conv_general_dilated: only {c1.DN} operands are ported, got "
            f"{dimension_numbers!r}")
    unported = set(extras) - {"feature_group_count"}
    if unported:
        raise NotImplementedError(
            f"conv_general_dilated: {sorted(unported)} not ported")
    dil = tuple(rhs_dilation) if rhs_dilation is not None else (1, 1)
    strides = tuple(window_strides)
    spread = lhs_dilation is not None and tuple(lhs_dilation) != (1, 1)
    if spread and isinstance(padding, str):
        raise ValueError(
            "String padding is not implemented for transposed convolution "
            "using this op (as in lax): give explicit pads or use "
            "conv_transpose")
    pads = pads_of(x.shape[1:3], kernel.shape[:2], strides, padding, dil)
    if spread:
        x = _dilate_nhwc(x, tuple(lhs_dilation))
    xc, sym = pad_nchw(x.permute(0, 3, 1, 2), pads)
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), None, strides, sym, dil,
                 feature_group_count)
    return y.permute(0, 2, 3, 1)


def _conv_transpose(lhs: torch.Tensor, rhs: torch.Tensor,
                    strides: Sequence[int], padding: Padding,
                    rhs_dilation: Optional[Sequence[int]] = None,
                    dimension_numbers=None, transpose_kernel: bool = False,
                    precision=None, preferred_element_type=None
                    ) -> torch.Tensor:
    """``lax.conv_transpose`` for NHWC / HWIO / NHWC operands: the conv of
    the input spread by ``strides`` (``lhs_dilation``) at unit stride,
    padded by :func:`conv_transpose_pads`; ``transpose_kernel`` flips the
    window and swaps the kernel's in / out axes first."""
    dn = c1.DN if dimension_numbers is None else dimension_numbers
    dil = tuple(rhs_dilation) if rhs_dilation is not None else (1, 1)
    window = [(k - 1) * d + 1 for k, d in zip(rhs.shape[:2], dil)]
    pads = conv_transpose_pads(window, strides, padding)
    if transpose_kernel:
        rhs = rhs.flip((0, 1)).transpose(2, 3)
    return _conv_general_dilated(lhs, rhs, (1, 1), pads,
                                 lhs_dilation=tuple(strides),
                                 rhs_dilation=dil, dimension_numbers=dn,
                                 precision=precision,
                                 preferred_element_type=preferred_element_type)


def _conv(x, kernel, bias=None, *, window_strides=None, padding="SAME",
          dimension_numbers=None, **kw):
    """``F.conv*``'s spelling: one entry point with an optional bias,
    stride 1, ``"SAME"`` and channels-last dimension numbers by default
    (2-d only in the port)."""
    if window_strides is None:
        window_strides = (1,) * (x.dim() - 2)
    if dimension_numbers is None:
        dimension_numbers = c1.DN
    y = _conv_general_dilated(x, kernel, window_strides, padding,
                              dimension_numbers=dimension_numbers, **kw)
    if bias is not None:
        y = y + bias
    return y


# -- HALF_OPS -------------------------------------------------------------------

def _linear(x, kernel, bias=None):
    y = x @ kernel
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _dot(a, b):
    """``jnp.dot``: a product over a's last axis and b's second-to-last
    (its only one when 1-d)."""
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1],
                                       [max(b.dim() - 2, 0)]))


def _tensordot(a, b, axes=2):
    return torch.tensordot(a, b, dims=axes)


def _dot_general(lhs, rhs, dimension_numbers, precision=None,
                 preferred_element_type=None):
    """``lax.dot_general`` as one einsum: batch axes first, then lhs's
    free axes, then rhs's."""
    (lc, rc), (lb, rb) = dimension_numbers
    names = iter(string.ascii_letters)
    ls, rs = [None] * lhs.dim(), [None] * rhs.dim()
    for a, b in list(zip(lb, rb)) + list(zip(lc, rc)):
        ls[a] = rs[b] = next(names)
    ls = [n or next(names) for n in ls]
    rs = [n or next(names) for n in rs]
    out = [ls[a] for a in lb] \
        + [n for i, n in enumerate(ls) if i not in lc and i not in lb] \
        + [n for i, n in enumerate(rs) if i not in rc and i not in rb]
    y = torch.einsum(f"{''.join(ls)},{''.join(rs)}->{''.join(out)}",
                     lhs, rhs)
    return y if preferred_element_type is None \
        else y.to(preferred_element_type)


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


matmul = half_function(torch.matmul)
dot = half_function(_dot)
tensordot = half_function(_tensordot)
einsum = half_function(torch.einsum)
dot_general = half_function(_dot_general)
conv_general_dilated = half_function(_conv_general_dilated)
conv_transpose = half_function(_conv_transpose)
linear = half_function(_linear)
conv = half_function(_conv)
# a half op but in FP8_DENY_OPS: a pointwise select, not a contraction
prelu = half_function(_prelu, fp8_eligible=False)


# -- FP32_OPS -------------------------------------------------------------------

def _axes(x, axis):
    """``axis`` (None, an int or a tuple) as torch's ``dim``."""
    if axis is None:
        return tuple(range(x.dim()))
    return axis


def _reduce(fn):
    def op(x, axis=None, keepdims=False):
        if axis is None and not keepdims:
            return fn(x)
        return fn(x, dim=_axes(x, axis), keepdim=keepdims)
    return op


def _prod(x, axis=None, keepdims=False):
    if axis is None:
        y = torch.prod(x)
        return y.reshape((1,) * x.dim()) if keepdims else y
    for a in sorted((axis,) if isinstance(axis, int) else axis,
                    reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _moment(fn):
    def op(x, axis=None, ddof=0, keepdims=False):
        return fn(x, dim=_axes(x, axis), correction=ddof, keepdim=keepdims)
    return op


def _scan(fn):
    def op(x, axis=None):
        return fn(x.reshape(-1), dim=0) if axis is None else fn(x, dim=axis)
    return op


def _logsumexp(x, axis=None, keepdims=False):
    return torch.logsumexp(x, dim=_axes(x, axis), keepdim=keepdims)


def _softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def _log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def _softmin(x, axis=-1):
    return torch.softmax(-x, dim=axis)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _norm(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


def _layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5):
    """``F.layer_norm``'s semantics with the JAX package's formula: the
    biased variance over the trailing dims, ``(x - mean) * rsqrt(var +
    eps)``."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def _group_norm(x, num_groups, weight=None, bias=None, eps=1e-5):
    """``F.group_norm`` with the channels last."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    shape = x.shape
    g = x.reshape(shape[:-1] + (num_groups, c // num_groups))
    axes = tuple(range(1, g.dim() - 2)) + (g.dim() - 1,)
    mean = g.mean(dim=axes, keepdim=True)
    var = g.var(dim=axes, correction=0, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(shape)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def _batch_norm(x, running_mean, running_var, weight=None, bias=None,
                training=False, eps=1e-5):
    """Normalization over the channels-last axis, with the batch's
    statistics when ``training`` (a pure function: the running stats are
    the caller's, as in the JAX package)."""
    if training:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, correction=0)
    else:
        mean, var = running_mean, running_var
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def _nll_loss(log_probs, targets):
    picked = torch.gather(log_probs, -1, targets[..., None].long())
    return -picked.mean()


def _cross_entropy(logits, targets):
    return _nll_loss(torch.log_softmax(logits, dim=-1), targets)


def _l1_loss(pred, target):
    return (pred - target).abs().mean()


def _mse_loss(pred, target):
    return (pred - target).square().mean()


def _smooth_l1_loss(pred, target, beta=1.0):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def _kl_div(log_pred, target):
    """``target * (log(target) - log_pred)``, mean-reduced, 0 where the
    target is 0."""
    pointwise = torch.where(
        target > 0,
        target * (torch.log(torch.clamp_min(target, 1e-38)) - log_pred),
        torch.zeros_like(target))
    return pointwise.mean()


def _poisson_nll_loss(log_input, target):
    return (torch.exp(log_input) - target * log_input).mean()


def _cosine_embedding_loss(x1, x2, y, margin=0.0, eps=1e-8):
    cos = (x1 * x2).sum(-1) * torch.rsqrt(torch.clamp_min(
        (x1 * x1).sum(-1) * (x2 * x2).sum(-1), eps * eps))
    loss = torch.where(y == 1, 1.0 - cos, torch.clamp_min(cos - margin, 0.0))
    return loss.mean()


exp = float_function(torch.exp)
expm1 = float_function(torch.expm1)
log = float_function(torch.log)
log1p = float_function(torch.log1p)
log2 = float_function(torch.log2)
log10 = float_function(torch.log10)
pow = float_function(torch.pow)  # noqa: A001 - the table's name
reciprocal = float_function(torch.reciprocal)
rsqrt = float_function(torch.rsqrt)
sinh = float_function(torch.sinh)
cosh = float_function(torch.cosh)
tan = float_function(torch.tan)
acos = float_function(torch.acos)
asin = float_function(torch.asin)
erfinv = float_function(torch.erfinv)
sum = float_function(_reduce(torch.sum))  # noqa: A001
prod = float_function(_prod)
mean = float_function(_reduce(torch.mean))
var = float_function(_moment(torch.var))
std = float_function(_moment(torch.std))
cumsum = float_function(_scan(torch.cumsum))
cumprod = float_function(_scan(torch.cumprod))
logsumexp = float_function(_logsumexp)
softmax = float_function(_softmax)
log_softmax = float_function(_log_softmax)
softplus = float_function(_softplus)
norm = float_function(_norm)
softmin = float_function(_softmin)
layer_norm = float_function(_layer_norm)
group_norm = float_function(_group_norm)
batch_norm = float_function(_batch_norm)
nll_loss = float_function(_nll_loss)
cross_entropy = float_function(_cross_entropy)
l1_loss = float_function(_l1_loss)
mse_loss = float_function(_mse_loss)
smooth_l1_loss = float_function(_smooth_l1_loss)
kl_div = float_function(_kl_div)
poisson_nll_loss = float_function(_poisson_nll_loss)
cosine_embedding_loss = float_function(_cosine_embedding_loss)

# -- PROMOTE_OPS, SEQUENCE_PROMOTE_OPS, BANNED_OPS ---------------------------

add = promote_function(torch.add)
sub = promote_function(torch.sub)
mul = promote_function(torch.mul)
div = promote_function(torch.div)
atan2 = promote_function(torch.atan2)
maximum = promote_function(torch.maximum)
minimum = promote_function(torch.minimum)
equal = promote_function(torch.eq)
greater = promote_function(torch.gt)
less = promote_function(torch.lt)


def _concatenate(arrays, axis=0):
    return torch.cat(list(arrays), dim=axis)


def _stack(arrays, axis=0):
    return torch.stack(list(arrays), dim=axis)


concatenate = _sequence_promote(_concatenate)
stack = _sequence_promote(_stack)


def _binary_cross_entropy(probs, targets):
    p, t = probs.float(), targets.float()
    return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p)).mean()


binary_cross_entropy = banned_function(_binary_cross_entropy)
