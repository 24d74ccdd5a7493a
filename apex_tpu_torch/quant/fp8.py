"""FP8 quantization with per-tensor scales and delayed scaling, as
``apex_tpu/quant/fp8.py``.

A tensor class is quantized as ``q = clip(x * scale)`` cast to e4m3
(forward activations and weights) or e5m2 (backward cotangents: more
exponent, less mantissa), and the scale is *delayed*: derived from a
rolling history of past steps' absolute maxima, never from the same
step's amax.  The states are NamedTuples of device tensors in the JAX
package's field order (a checkpoint flattens them in that order), and
every transition here returns new tensors without reading one back to
the host.

The functions are eager PyTorch, as the JAX package computes them with
``jnp`` ops outside any Pallas kernel; on the CPU each equals the JAX
function bit for bit (IEEE elementwise ops in the same order: the cast
to fp32 first, the multiply, the clip, the round-to-nearest-even cast;
the dequantize *divides* by the scale).  :func:`scaled_matmul` runs
``torch._scaled_mm`` (fp8 operands, fp32 accumulation) on the card and
its plain version, the fp32 product of the upcast operands, on the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from apex_tpu_torch.ops import DeviceLike, resolve_device

#: the two FP8 storage formats: e4m3 forward (max 448, 3 mantissa bits),
#: e5m2 backward (max 57344: gradients need range over precision)
FP8_E4M3 = torch.float8_e4m3fn
FP8_E5M2 = torch.float8_e5m2

_FP8_MAX = {FP8_E4M3: 448.0, FP8_E5M2: 57344.0}


def fp8_max(dtype) -> float:
    """Largest finite value of an fp8 storage dtype."""
    try:
        return _FP8_MAX[dtype]
    except (KeyError, TypeError):
        raise ValueError(f"not an fp8 dtype: {dtype!r}") from None


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device, made by a fill (no copy
    from the host).  Divisions take it, not a Python number: CUDA divides
    by a host scalar as a multiply by its reciprocal, which rounds
    otherwise than the division the CPU and the JAX package make."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


class DelayedScalingState(NamedTuple):
    """One tensor class's delayed-scaling state: ``amax_history`` a
    rolling ``(history_len,)`` fp32 window of past steps' absolute maxima
    (newest at index 0), ``scale`` the 0-d fp32 scale derived from it at
    the end of the previous step (the delayed scale this step's quantize
    multiplies by)."""

    amax_history: torch.Tensor
    scale: torch.Tensor


def init_delayed_scaling(history_len: int = 16, scale: float = 1.0,
                         device: DeviceLike = None) -> DelayedScalingState:
    """A fresh state on ``device`` (the card by default): a zero history
    and a unit scale.  A zero history derives a unit scale too, so the
    first steps quantize conservatively until amaxes fill the window."""
    if history_len < 1:
        raise ValueError(f"history_len={history_len}")
    dev = resolve_device(device)
    return DelayedScalingState(
        amax_history=torch.zeros(history_len, dtype=torch.float32,
                                 device=dev),
        scale=torch.full((), scale, dtype=torch.float32, device=dev))


def delayed_scale(state: DelayedScalingState, dtype,
                  margin: int = 0) -> torch.Tensor:
    """The next step's scale from the current history: ``fp8_max(dtype) /
    (2**margin * max(history))``, a unit scale while the history is all
    zero (warmup), clipped to [1e-30, 1e30]."""
    amax = state.amax_history.amax()
    target = _const(fp8_max(dtype) / (2.0 ** margin), amax)
    scale = torch.where(amax > 0.0, target / torch.clamp_min(amax, 1e-30),
                        torch.ones_like(amax))
    return torch.clamp(scale, 1e-30, 1e30).to(torch.float32)


def record_amax(state: DelayedScalingState, amax: torch.Tensor, dtype,
                margin: int = 0) -> DelayedScalingState:
    """End-of-step transition: roll ``amax`` into the history (newest
    first) and derive the scale for the next step.  A non-finite amax
    (an overflowed backward, which the loss scaler skips) records as 0,
    so it cannot poison ``max(history)`` for ``history_len`` steps."""
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=state.amax_history.device)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    hist = torch.cat([amax.reshape(1), state.amax_history[:-1]])
    return DelayedScalingState(
        amax_history=hist,
        scale=delayed_scale(DelayedScalingState(hist, state.scale), dtype,
                            margin))


def quantize(x: torch.Tensor, scale: torch.Tensor,
             dtype=FP8_E4M3) -> torch.Tensor:
    """``clip(x * scale)`` cast to fp8 (``x`` cast to fp32 first);
    ``scale`` is the delayed scale, a carried state tensor."""
    m = fp8_max(dtype)
    return torch.clamp(x.float() * scale, -m, m).to(dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """``q / scale`` at ``dtype`` (a division, as the JAX package's: a
    multiply by the reciprocal rounds otherwise)."""
    return (q.float() / scale).to(dtype)


def qdq(x: torch.Tensor, scale: torch.Tensor,
        dtype=FP8_E4M3) -> torch.Tensor:
    """Quantize-dequantize: ``x`` rounded onto the fp8 grid at ``scale``,
    returned in ``x``'s dtype."""
    return dequantize(quantize(x, scale, dtype), scale, x.dtype)


def tensor_amax(x: torch.Tensor) -> torch.Tensor:
    """``max(|x|)`` as a 0-d fp32 tensor (NaN when ``x`` holds one)."""
    return x.abs().amax().float()


def _pad16(q: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A 2-d fp8 ``q`` zero-padded to ``(rows, cols)`` (its bytes padded
    as uint8: the zero byte is +0 in both formats)."""
    r, c = q.shape
    if (r, c) == (rows, cols):
        return q
    return F.pad(q.view(torch.uint8), (0, cols - c, 0, rows - r)) \
        .view(q.dtype)


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def scaled_mm_product(qx: torch.Tensor, qw: torch.Tensor,
                      x_scale: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """``(qx @ qw) / (x_scale * w_scale)`` in fp32 for fp8 ``qx (..., K)``
    and ``qw (K, N)``: on the card one ``torch._scaled_mm`` (fp8
    operands, fp32 accumulation, the reciprocal scales as its dequant
    factors), on the CPU :func:`scaled_mm_product_ref`.  ``_scaled_mm``
    takes dims that are multiples of 16 and a column-major second
    operand: the operands are zero-padded to 16 (exact: a padded
    contraction term is 0) and ``qw`` is laid out as ``(N, K)`` rows."""
    if not qx.is_cuda:
        return scaled_mm_product_ref(qx, qw, x_scale, w_scale)
    lead, k = qx.shape[:-1], qx.shape[-1]
    n = qw.shape[1]
    a = qx.reshape(-1, k)
    m = a.shape[0]
    mp, kp, np_ = _up16(m), _up16(k), _up16(n)
    a = _pad16(a.contiguous(), mp, kp)
    b = _pad16(qw.t().contiguous(), np_, kp).t()        # (K, N) col-major
    y = torch._scaled_mm(a, b, scale_a=x_scale.reciprocal().reshape(()),
                         scale_b=w_scale.reciprocal().reshape(()),
                         out_dtype=torch.float32)
    return y[:m, :n].reshape(*lead, n)


def scaled_mm_product_ref(qx: torch.Tensor, qw: torch.Tensor,
                          x_scale: torch.Tensor,
                          w_scale: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`scaled_mm_product`: the fp32 product of
    the upcast fp8 operands, divided by the product of the scales (the
    JAX package's formula)."""
    return torch.matmul(qx.float(), qw.float()) / (x_scale * w_scale)


def scaled_matmul(x: torch.Tensor, w: torch.Tensor,
                  x_scale: torch.Tensor, w_scale: torch.Tensor,
                  dtype=FP8_E4M3, out_dtype=None) -> torch.Tensor:
    """``x @ w`` with both operands quantized to fp8 at their (delayed)
    scales and fp32 accumulation, the product of the scales divided out
    once; output in ``out_dtype`` (``x``'s dtype by default)."""
    y = scaled_mm_product(quantize(x, x_scale, dtype),
                          quantize(w, w_scale, dtype), x_scale, w_scale)
    return y.to(out_dtype if out_dtype is not None else x.dtype)


class _QdqSte(torch.autograd.Function):
    """:func:`qdq` forward; the cotangent passes unrounded and the scale
    gets a zero gradient (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, scale, dtype):
        ctx.scale_meta = (scale.shape, scale.dtype, scale.device)
        return qdq(x, scale, dtype)

    @staticmethod
    def backward(ctx, g):
        shape, dt, dev = ctx.scale_meta
        gs = torch.zeros(shape, dtype=dt, device=dev) \
            if ctx.needs_input_grad[1] else None
        return g, gs, None


def qdq_ste(x: torch.Tensor, scale: torch.Tensor,
            dtype=FP8_E4M3) -> torch.Tensor:
    """:func:`qdq` with a straight-through gradient: the cotangent passes
    unrounded (differentiating the casts would round it onto the forward
    grid too, on top of :func:`bwd_qdq`'s e5m2 rounding)."""
    return _QdqSte.apply(x, scale, dtype)


class _BwdQdq(torch.autograd.Function):
    """Identity forward; the backward rounds the cotangent onto the e5m2
    grid at ``grad_scale`` (the scale gets a zero gradient)."""

    @staticmethod
    def forward(ctx, x, grad_scale):
        ctx.save_for_backward(grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (grad_scale,) = ctx.saved_tensors
        gs = torch.zeros_like(grad_scale) if ctx.needs_input_grad[1] \
            else None
        return qdq(g, grad_scale, FP8_E5M2), gs


def bwd_qdq(x: torch.Tensor, grad_scale: torch.Tensor) -> torch.Tensor:
    """The e5m2 rounding point of the cotangent: identity forward, the
    backward's cotangent quantize-dequantized onto e5m2 at
    ``grad_scale``."""
    return _BwdQdq.apply(x, grad_scale)


class Fp8TrainState(NamedTuple):
    """O4's state, one :class:`DelayedScalingState` per tensor class:
    ``input`` (forward activations, e4m3), ``weight`` (forward weights,
    e4m3), ``grad`` (backward cotangents, e5m2; its amax is recorded from
    the step's gradients)."""

    input: DelayedScalingState
    weight: DelayedScalingState
    grad: DelayedScalingState


def init_train_state(history_len: int = 16,
                     device: DeviceLike = None) -> Fp8TrainState:
    """Three fresh class states on ``device`` (the card by default)."""
    return Fp8TrainState(*(init_delayed_scaling(history_len, device=device)
                           for _ in range(3)))


def update_train_state(state: Fp8TrainState, amax_input: torch.Tensor,
                       amax_weight: torch.Tensor, amax_grad: torch.Tensor,
                       margin: int = 0) -> Fp8TrainState:
    """End-of-step roll of all three classes (the forward amaxes the op
    layer collected, the grad amax from the unscaled gradients)."""
    return Fp8TrainState(
        input=record_amax(state.input, amax_input, FP8_E4M3, margin),
        weight=record_amax(state.weight, amax_weight, FP8_E4M3, margin),
        grad=record_amax(state.grad, amax_grad, FP8_E5M2, margin))


def step_saturation(state: Fp8TrainState, amax_input: torch.Tensor,
                    amax_weight: torch.Tensor, amax_grad: torch.Tensor,
                    margin: int = 0) -> torch.Tensor:
    """The worst class's range use this step, ``max over classes of
    (amax * the scale the step quantized with * 2**margin / fp8_max)``,
    against ``state`` before the end-of-step roll: ~1 is healthy, above 1
    means values were clipped.  A non-finite amax reads as 0."""
    def fin(a):
        a = torch.as_tensor(a, dtype=torch.float32,
                            device=state.input.scale.device)
        return torch.where(torch.isfinite(a), a, torch.zeros_like(a))
    fwd = _const(fp8_max(FP8_E4M3), state.input.scale)
    bwd = _const(fp8_max(FP8_E5M2), state.input.scale)
    parts = [fin(amax_input) * state.input.scale * (2.0 ** margin) / fwd,
             fin(amax_weight) * state.weight.scale * (2.0 ** margin) / fwd,
             fin(amax_grad) * state.grad.scale * (2.0 ** margin) / bwd]
    return torch.stack(parts).amax().to(torch.float32)


def rescale_events(old: Fp8TrainState, new: Fp8TrainState) -> torch.Tensor:
    """How many classes' scales shrank this step (int32, 0..3)."""
    return torch.stack([(n.scale < o.scale).to(torch.int32)
                        for o, n in zip(old, new)]).sum(dtype=torch.int32)


def tree_amax(tree: Any, device: DeviceLike = None) -> torch.Tensor:
    """``max(|leaf|)`` over every floating tensor of a (nested list /
    tuple / dict) tree, as a 0-d fp32 tensor (0 for a tree without one,
    on ``device``).  The leaves of one dtype take one
    ``torch._foreach_norm`` (the inf norm: the largest magnitude, NaN
    when a leaf holds one)."""
    leaves = [t for t in pytree.tree_leaves(tree)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.float32,
                           device=resolve_device(device))
    by_dtype = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t)
    maxes = [m.float() for group in by_dtype.values()
             for m in torch._foreach_norm(group, float("inf"))]
    return torch.stack(maxes).amax()
