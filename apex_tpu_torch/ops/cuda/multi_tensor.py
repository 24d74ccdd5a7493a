"""K6: scale with a non-finite check (``csrc/multi_tensor_scale.cu``), the
amp unscale, and K9: the total sum of squares over a tree
(``csrc/multi_tensor_sumsq.cu``), the LAMB global-norm clip; each beside
its plain PyTorch version.

The CUDA kernel replaces the Pallas ``packed_scale`` (``_scale_kernel``)
of ``apex_tpu/ops/pallas/multi_tensor_kernels.py``.  It takes one leaf at
a time (no packing into a flat buffer: on the card a launch per leaf is
cheap next to a pack and unpack pass), and every leaf of a step raises
the same device flag.  :func:`packed_scale` launches it for a CUDA tensor
and runs :func:`packed_scale_ref` for a CPU tensor; it never falls back
from one to the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from apex_tpu_torch.ops.cuda import build
from apex_tpu_torch.ops.multi_tensor import ChunkTable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def packed_scale_ref(x: torch.Tensor, scale: torch.Tensor,
                     out_dtype: torch.dtype, flag: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(x.float() * scale).to(out_dtype)``, written into ``out`` when
    given; sets ``flag`` (one int32) to 1 when any value of ``x`` is not
    finite, without reading it back to the host."""
    bad = ~torch.isfinite(x).all()
    flag.copy_(torch.where(bad, torch.ones_like(flag), flag))
    y = (x.float() * scale.float()).to(out_dtype)
    return y if out is None else out.copy_(y.view(out.shape))


def packed_scale(x: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype, flag: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`packed_scale_ref`'s function.  ``scale``: one float32 and
    ``flag``: one int32, on x's device; ``out``, when given, a contiguous
    ``out_dtype`` tensor of x's size there (a buffer kept across steps).
    On a CUDA tensor one launch of the hand-written kernel (counted in
    ``packed_scale.launches``), any shape, read as its flat contiguous
    view."""
    if x.device.type == "cpu":
        return packed_scale_ref(x, scale, out_dtype, flag, out)
    if x.device.type != "cuda":
        raise ValueError(f"packed_scale: unsupported device {x.device}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"packed_scale: {x.dtype} -> {out_dtype} "
                        f"unsupported (float32 / bfloat16)")
    for name, t, dt in (("scale", scale, torch.float32),
                        ("flag", flag, torch.int32)):
        if t.numel() != 1 or t.dtype != dt or t.device != x.device:
            raise ValueError(f"packed_scale: {name} must be one {dt} on "
                             f"{x.device}")
    x = x.contiguous()
    if out is None:
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    elif out.dtype != out_dtype or out.numel() != x.numel() \
            or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"packed_scale: out must be {x.numel()} "
                         f"contiguous {out_dtype} on {x.device}")
    if x.numel() == 0:
        return out
    err = build.library().apex_multi_tensor_scale(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), flag.data_ptr(),
        x.numel(), _DTYPES[x.dtype], _DTYPES[out_dtype], build.stream_of(x))
    build.check(err, "packed_scale")
    packed_scale.launches += 1
    return out


packed_scale.launches = 0


def packed_sumsq_ref(table: ChunkTable,
                     xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sum(float(x)**2)`` over every element of every leaf, fp32,
    shape ``(1,)``; ``xs`` are the table's leaves."""
    if not table.fits(xs):
        raise ValueError("packed_sumsq: the tensors do not match the chunk "
                         "table's leaf sizes")
    if not xs:
        return torch.zeros(1, dtype=torch.float32, device=table.device)
    return torch.stack([x.float().square().sum() for x in xs]).sum() \
        .reshape(1)


def packed_sumsq(table: ChunkTable,
                 xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`packed_sumsq_ref`'s function.  On CUDA tensors one launch of
    the hand-written kernel over the whole table (counted in
    ``packed_sumsq.launches``): leaves float32 or bfloat16, all of one
    dtype, contiguous.  The result stays on the card."""
    if table.device.type == "cpu":
        return packed_sumsq_ref(table, xs)
    if table.device.type != "cuda":
        raise ValueError(f"packed_sumsq: unsupported device {table.device}")
    dt = table.check("packed_sumsq", "xs", xs, tuple(_DTYPES))
    out = torch.zeros(1, dtype=torch.float32, device=table.device)
    if table.n_chunks == 0:
        return out
    partials = torch.empty(table.n_chunks, dtype=torch.float32,
                           device=table.device)
    err = build.library().apex_multi_tensor_sumsq(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.n_chunks, table.chunk_size,
        table.pointers(xs).data_ptr(), _DTYPES[dt], partials.data_ptr(),
        table.ticket.data_ptr(), out.data_ptr(), build.stream_of(out))
    build.check(err, "packed_sumsq")
    packed_sumsq.launches += 1
    return out


packed_sumsq.launches = 0
