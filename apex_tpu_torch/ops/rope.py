"""Rotary position embeddings: tables, the pre-rotated application, and
the full-width tables the flash kernels rotate with, as
``apex_tpu/ops/rope.py`` ``rope_tables`` / ``apply_rope`` /
``rope_kernel_tables``."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class KernelRopeTables(NamedTuple):
    """Full-width kernel-format tables, ``(B, L, D)`` each: ``cos_full =
    [cos, cos]`` and ``sin_signed = [-sin, sin]``, so that a row rotates
    as ``x * cos_full + rot_half(x) * sin_signed`` with ``rot_half``
    mapping lane ``j`` to ``x[(j + D/2) mod D]``."""

    cos_full: torch.Tensor
    sin_signed: torch.Tensor


def rope_kernel_tables(cos: torch.Tensor, sin: torch.Tensor, b: int,
                       l: int, d: int, dtype: torch.dtype
                       ) -> KernelRopeTables:
    """Half-width ``(cos, sin)`` (``(B, L, 1, D/2)`` or ``(B, L, D/2)``)
    to the kernel's full-width pair in ``dtype`` (the activations'
    dtype: bf16 activations take bf16 tables)."""
    cos = cos.reshape(cos.shape[0], l, d // 2)
    sin = sin.reshape(sin.shape[0], l, d // 2)
    if cos.shape[0] != b:
        cos = cos.expand(b, l, d // 2)
        sin = sin.expand(b, l, d // 2)
    cos_full = torch.cat([cos, cos], dim=-1)
    sin_signed = torch.cat([-sin, sin], dim=-1)
    return KernelRopeTables(cos_full.to(dtype).contiguous(),
                            sin_signed.to(dtype).contiguous())


def rotate_full(x: torch.Tensor, cos_full: torch.Tensor,
                sin_signed: torch.Tensor) -> torch.Tensor:
    """``x (B, L, H, D)`` rotated by full-width tables ``(B, L, D)`` in
    fp32 (the kernels' ``_rot``); the result is fp32.  The inverse
    rotation is the same call with ``-sin_signed``."""
    half = x.shape[-1] // 2
    xr = torch.cat([x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos_full[:, :, None, :].float()
            + xr.float() * sin_signed[:, :, None, :].float())


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
