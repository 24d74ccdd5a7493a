"""K5: the fused Adam step (``csrc/adam.cu``) and its plain PyTorch
version.

The CUDA kernel replaces the Pallas ``packed_adam`` (``_adam_kernel``) of
``apex_tpu/ops/pallas/adam_kernel.py``.  It runs on the flat view of any
leaf, whatever its size: the TPU's ``ADAM_PAD`` alignment has no
counterpart.  Unlike the functional JAX step it updates p, m and v in
place (the state is dead after the step, and the copies would double the
optimizer's memory).  :func:`packed_adam` launches it for CUDA tensors and
runs :func:`packed_adam_ref` for CPU tensors; it never falls back from one
to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.cuda import build

#: eps added to sqrt(v) (the CUDA kernel's MODE_0)
EPS_MODE_OUTSIDE = 0
#: eps under the sqrt: denom = sqrt(v + eps) (MODE_1)
EPS_MODE_INSIDE = 1

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def packed_adam_ref(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, step_size: torch.Tensor,
                    scale: torch.Tensor, noop_flag: Optional[torch.Tensor],
                    *, beta1: float, beta2: float, eps: float,
                    weight_decay: float = 0.0,
                    eps_mode: int = EPS_MODE_OUTSIDE,
                    p_copy: Optional[torch.Tensor] = None) -> None:
    """One Adam update of ``p``, ``m``, ``v`` in place (and of ``p_copy``,
    a half copy of the new p), in fp32 and in the op order of the JAX
    package's ``adam_step``: ``g / scale``, ``+ weight_decay * p`` when
    it is not 0, both moments, ``denom``, ``p - step_size * m / denom``.
    ``step_size``/``scale`` are one-element fp32 tensors; nothing is
    written when ``noop_flag`` (one int32) is nonzero."""
    g32 = g.float() / scale.float()
    p32 = p.float()
    if weight_decay:
        g32 = g32 + weight_decay * p32
    m32 = beta1 * m + (1.0 - beta1) * g32
    v32 = beta2 * v + (1.0 - beta2) * g32 * g32
    if eps_mode == EPS_MODE_INSIDE:
        denom = torch.sqrt(v32 + eps)
    else:
        denom = torch.sqrt(v32) + eps
    p32 = p32 - step_size.float() * m32 / denom
    if noop_flag is not None:
        keep = noop_flag.reshape(()) != 0
        p32 = torch.where(keep, p.float(), p32)
        m32 = torch.where(keep, m, m32)
        v32 = torch.where(keep, v, v32)
        if p_copy is not None:
            p_copy.copy_(torch.where(keep, p_copy, p32.to(p_copy.dtype)))
    elif p_copy is not None:
        p_copy.copy_(p32)
    p.copy_(p32)
    m.copy_(m32)
    v.copy_(v32)


def packed_adam(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, step_size: torch.Tensor,
                scale: torch.Tensor, noop_flag: Optional[torch.Tensor], *,
                beta1: float, beta2: float, eps: float,
                weight_decay: float = 0.0, eps_mode: int = EPS_MODE_OUTSIDE,
                p_copy: Optional[torch.Tensor] = None) -> None:
    """:func:`packed_adam_ref`'s function.  On CUDA tensors one launch of
    the hand-written kernel (counted in ``packed_adam.launches``): p
    float32 or bfloat16, g float32 or p's dtype (widened to fp32, as the
    plain version does), m, v float32, p_copy bfloat16, all contiguous
    and of one size; ``step_size``, ``scale`` and
    ``noop_flag`` stay on the card (the kernel reads them there, so a
    step makes no host sync).  Bit for bit the plain version on the
    card."""
    if p.device.type == "cpu":
        return packed_adam_ref(p, m, v, g, step_size, scale, noop_flag,
                               beta1=beta1, beta2=beta2, eps=eps,
                               weight_decay=weight_decay, eps_mode=eps_mode,
                               p_copy=p_copy)
    if p.device.type != "cuda":
        raise ValueError(f"packed_adam: unsupported device {p.device}")
    if p.dtype not in _DTYPES or g.dtype not in (torch.float32, p.dtype):
        raise TypeError(f"packed_adam: p {p.dtype} with g {g.dtype} "
                        f"unsupported (p float32 or bfloat16, g float32 "
                        f"or p's dtype)")
    n = p.numel()
    for name, t, dt in (("p", p, p.dtype), ("m", m, torch.float32),
                        ("v", v, torch.float32), ("g", g, g.dtype)) + (
            (("p_copy", p_copy, torch.bfloat16),) if p_copy is not None
            else ()):
        if t.numel() != n or t.dtype != dt or t.device != p.device \
                or not t.is_contiguous():
            raise ValueError(f"packed_adam: {name} must be {n} contiguous "
                             f"{dt} elements on {p.device}")
    for name, t, dt in (("step_size", step_size, torch.float32),
                        ("scale", scale, torch.float32)) + (
            (("noop_flag", noop_flag, torch.int32),)
            if noop_flag is not None else ()):
        if t.numel() != 1 or t.dtype != dt or t.device != p.device:
            raise ValueError(f"packed_adam: {name} must be one {dt} on "
                             f"{p.device}")
    if n == 0:
        return None
    err = build.library().apex_adam(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
        None if p_copy is None else p_copy.data_ptr(), step_size.data_ptr(),
        scale.data_ptr(), None if noop_flag is None else noop_flag.data_ptr(),
        n, beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps, weight_decay,
        int(eps_mode == EPS_MODE_INSIDE), _DTYPES[p.dtype], _DTYPES[g.dtype],
        build.stream_of(p))
    build.check(err, "packed_adam")
    packed_adam.launches += 1
    return None


packed_adam.launches = 0
