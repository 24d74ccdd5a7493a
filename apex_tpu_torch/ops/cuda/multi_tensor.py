"""K6: scale with a non-finite check (``csrc/multi_tensor_scale.cu``), the
amp unscale, and its plain PyTorch version.

The CUDA kernel replaces the Pallas ``packed_scale`` (``_scale_kernel``)
of ``apex_tpu/ops/pallas/multi_tensor_kernels.py``.  It takes one leaf at
a time (no packing into a flat buffer: on the card a launch per leaf is
cheap next to a pack and unpack pass), and every leaf of a step raises
the same device flag.  :func:`packed_scale` launches it for a CUDA tensor
and runs :func:`packed_scale_ref` for a CPU tensor; it never falls back
from one to the other.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.cuda import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def packed_scale_ref(x: torch.Tensor, scale: torch.Tensor,
                     out_dtype: torch.dtype,
                     flag: torch.Tensor) -> torch.Tensor:
    """``(x.float() * scale).to(out_dtype)``; sets ``flag`` (one int32) to
    1 when any value of ``x`` is not finite, without reading it back to
    the host."""
    bad = ~torch.isfinite(x).all()
    flag.copy_(torch.where(bad, torch.ones_like(flag), flag))
    return (x.float() * scale.float()).to(out_dtype)


def packed_scale(x: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype,
                 flag: torch.Tensor) -> torch.Tensor:
    """:func:`packed_scale_ref`'s function.  ``scale``: one float32 and
    ``flag``: one int32, on x's device.  On a CUDA tensor one launch of
    the hand-written kernel (counted in ``packed_scale.launches``), any
    shape, read as its flat contiguous view."""
    if x.device.type == "cpu":
        return packed_scale_ref(x, scale, out_dtype, flag)
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
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    err = build.library().apex_multi_tensor_scale(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), flag.data_ptr(),
        x.numel(), _DTYPES[x.dtype], _DTYPES[out_dtype], build.stream_of(x))
    build.check(err, "packed_scale")
    packed_scale.launches += 1
    return out


packed_scale.launches = 0
