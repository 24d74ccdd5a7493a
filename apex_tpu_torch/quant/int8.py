"""Symmetric int8 quantization: per-channel weights and the KV-cache
format the decode path reads, as ``apex_tpu/quant/int8.py``.

- Weights: per-channel absmax, ``q = round(w / s)`` with ``s = amax /
  127`` (fp32 scales, reduced over ``axis``).
- KV cache: one fp32 scale per cached token (its ``(H, D)`` key or value
  vector), computed on write; the scales ride beside the int8 pool
  (``(L, B, M)`` in ``generate``, ``(L, num_blocks, block_size)`` in the
  serve engine's pools) and the read folds them into the attention math
  (:func:`apex_tpu_torch.models.generate._attn_cached`): the K scale
  multiplies the scores, the V scale the probabilities, so no dequantized
  cache is made.

Rounding is half to even (``torch.round``, as ``jnp.rint``), clipped to
[-127, 127] (-128 unused: the grid is symmetric); an all-zero vector gets
scale 1.  Eager PyTorch, bit for bit the JAX package's functions on the
CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

#: symmetric int8 grid edge (-128 is excluded on purpose)
INT8_MAX = 127.0

Axis = Optional[Union[int, Sequence[int]]]


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` where ``amax > 0``, else 1.  The divisor is a device
    tensor: CUDA divides by a host scalar as a multiply by its
    reciprocal, which rounds otherwise than the CPU's division."""
    step = torch.full((), INT8_MAX, dtype=amax.dtype, device=amax.device)
    return torch.where(amax > 0.0, amax / step, torch.ones_like(amax))


def quantize_int8(x: torch.Tensor, axis: Axis = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization: ``axis=None`` per tensor (a
    0-d scale), else per channel with the scale reduced over ``axis``
    (kept as size-1 dims: a ``(K, N)`` weight with ``axis=0`` gets
    ``(1, N)`` scales).  Returns ``(q int8, scale fp32)`` with ``x ~ q *
    scale``."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = _absmax_scale(amax)
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX) \
        .to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` at ``dtype``."""
    return (q.float() * scale).to(dtype)


def quantize_kv(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a K or V write ``(..., H, D)`` with one scale per leading
    position (absmax over the trailing ``(H, D)``): ``(q int8 (..., H,
    D), scales fp32 (...))``."""
    xf = kv.float()
    scale = _absmax_scale(xf.abs().amax(dim=(-2, -1)))
    q = torch.clamp(torch.round(xf / scale[..., None, None]),
                    -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale.to(torch.float32)


def kv_dequant_scales(scale: torch.Tensor) -> torch.Tensor:
    """The per-position dequant factors the attention read folds in: the
    scale is constant over the contracted ``(H, D)``, so scaling a score
    (K) or a probability (V) by it is dequantizing the cache, exactly in
    real arithmetic (the last ulp may differ in floats)."""
    return scale.to(torch.float32)
