"""Rotary position embeddings: tables and the pre-rotated application,
as ``apex_tpu/ops/rope.py`` ``rope_tables`` / ``apply_rope``."""

from __future__ import annotations

import math
from typing import Tuple

import torch


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)`` tables ``(B, L, 1, head_dim // 2)`` from global
    positions ``(B, L)``."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    angles = positions[:, :, None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``(B, L, H, D)`` in fp32 by the tables; result in x's
    dtype."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
