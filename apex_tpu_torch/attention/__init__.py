"""Local attention, as the ``axis_name=None`` branch of
``apex_tpu/attention/ring.py`` ``attention``: exact attention over
``(B, L, H, D)`` through :func:`apex_tpu_torch.ops.cuda.flash_attn_fwd`
(the CUDA kernel on the card, its plain version on the CPU).  Ring and
Ulysses sequence parallelism are not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.cuda import flash_attn_fwd


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, kv_mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None, return_lse: bool = False):
    """``o (B, L, H, D)`` in q's dtype, or ``(o, lse (B, L, H) fp32)``
    with ``return_lse``.  ``kv_mask (B, Lk)`` bool, True = attend; a row
    that sees no key gives zeros and ``lse = -1e30``.  ``scale``
    defaults to ``1 / sqrt(D)``."""
    return flash_attn_fwd(q, k, v, causal=causal, kv_mask=kv_mask,
                          scale=scale, return_lse=return_lse)


__all__ = ["attention"]
