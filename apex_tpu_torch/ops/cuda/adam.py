"""K5 and K11: the fused Adam step over one leaf and over a whole tree
(``csrc/adam.cu``), and their plain PyTorch versions.

The CUDA kernels replace the Pallas ``packed_adam`` (``_adam_kernel``) and
``packed_adam_tree`` (``_adam_tree_kernel``) of
``apex_tpu/ops/pallas/adam_kernel.py``.  K5 runs on the flat view of any
leaf, whatever its size: the TPU's ``ADAM_PAD`` alignment has no
counterpart.  K11 runs the same element math over a
:class:`~apex_tpu_torch.ops.multi_tensor.ChunkTable`, one launch for a
whole parameter group, with each leaf's own step size.  Unlike the
functional JAX step both update p, m and v in place (the state is dead
after the step, and the copies would double the optimizer's memory).
:func:`packed_adam` / :func:`packed_adam_tree` launch the kernels for
CUDA tensors and run :func:`packed_adam_ref` / :func:`packed_adam_tree_ref`
for CPU tensors; they never fall back from one to the other.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import torch

from apex_tpu_torch.ops.cuda import build

if TYPE_CHECKING:
    from apex_tpu_torch.ops.multi_tensor import ChunkTable

#: eps added to sqrt(v) (the CUDA kernel's MODE_0)
EPS_MODE_OUTSIDE = 0
#: eps under the sqrt: denom = sqrt(v + eps) (MODE_1)
EPS_MODE_INSIDE = 1

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the types of a half copy
_COPY_DTYPES = (torch.bfloat16, torch.float16)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root (the kernels' ``__fsqrt_rn``,
    and XLA's): taken in fp64 and rounded once, which is exact for sqrt
    (fp64 has more than 2 x 24 + 2 bits).  PyTorch's own fp32 sqrt on the
    CPU is off by one ulp at some inputs."""
    return torch.sqrt(x.double()).float()


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
        denom = _sqrt_rn(v32 + eps)
    else:
        denom = _sqrt_rn(v32) + eps
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
    float32, bfloat16 or float16, g float32 or p's dtype (widened to fp32,
    as the plain version does), m, v float32, p_copy bfloat16 or float16,
    all contiguous
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
                        f"unsupported (p float32, bfloat16 or float16, g "
                        f"float32 or p's dtype)")
    if p_copy is not None and p_copy.dtype not in _COPY_DTYPES:
        raise TypeError(f"packed_adam: p_copy {p_copy.dtype} unsupported "
                        f"(bfloat16 or float16)")
    n = p.numel()
    for name, t, dt in (("p", p, p.dtype), ("m", m, torch.float32),
                        ("v", v, torch.float32), ("g", g, g.dtype)) + (
            (("p_copy", p_copy, p_copy.dtype),) if p_copy is not None
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
        _DTYPES[torch.bfloat16 if p_copy is None else p_copy.dtype],
        build.stream_of(p))
    build.check(err, "packed_adam")
    packed_adam.launches += 1
    return None


packed_adam.launches = 0


def packed_adam_tree_ref(table: ChunkTable, p: Sequence[torch.Tensor],
                         m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
                         g: Sequence[torch.Tensor], step_sizes: torch.Tensor,
                         scale: torch.Tensor,
                         noop_flag: Optional[torch.Tensor], *, beta1: float,
                         beta2: float, eps: float, weight_decay: float = 0.0,
                         eps_mode: int = EPS_MODE_OUTSIDE,
                         p_copy: Optional[Sequence[torch.Tensor]] = None
                         ) -> None:
    """:func:`packed_adam_ref` over the table's leaves, leaf ``i`` with
    step size ``step_sizes[i]`` (one fp32 per leaf), all with one
    ``scale`` and ``noop_flag``; ``p_copy``, when given, one half copy per
    leaf."""
    if not all(table.fits(ts) for ts in (p, m, v, g)):
        raise ValueError("packed_adam_tree: the tensors do not match the "
                         "chunk table's leaf sizes")
    for i in range(table.n_leaves):
        packed_adam_ref(p[i], m[i], v[i], g[i], step_sizes[i:i + 1], scale,
                        noop_flag, beta1=beta1, beta2=beta2, eps=eps,
                        weight_decay=weight_decay, eps_mode=eps_mode,
                        p_copy=None if p_copy is None else p_copy[i])


def packed_adam_tree(table: ChunkTable, p: Sequence[torch.Tensor],
                     m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
                     g: Sequence[torch.Tensor], step_sizes: torch.Tensor,
                     scale: torch.Tensor, noop_flag: Optional[torch.Tensor],
                     *, beta1: float, beta2: float, eps: float,
                     weight_decay: float = 0.0,
                     eps_mode: int = EPS_MODE_OUTSIDE,
                     p_copy: Optional[Sequence[torch.Tensor]] = None) -> None:
    """:func:`packed_adam_tree_ref`'s function.  On CUDA tensors one
    launch of the hand-written kernel over the whole table (counted in
    ``packed_adam_tree.launches``): p float32, bfloat16 or float16, g
    float32 or p's dtype, m, v float32, p_copy bfloat16 or float16, each
    list contiguous and of one dtype; ``step_sizes``, ``scale`` and ``noop_flag`` stay on the
    card.  Bit for bit the plain version, and so K5 leaf by leaf."""
    if table.device.type == "cpu":
        return packed_adam_tree_ref(
            table, p, m, v, g, step_sizes, scale, noop_flag, beta1=beta1,
            beta2=beta2, eps=eps, weight_decay=weight_decay,
            eps_mode=eps_mode, p_copy=p_copy)
    if table.device.type != "cuda":
        raise ValueError(f"packed_adam_tree: unsupported device "
                         f"{table.device}")
    what = "packed_adam_tree"
    p_dt = table.check(what, "p", p, tuple(_DTYPES))
    g_dt = table.check(what, "g", g, (torch.float32, p_dt))
    for name, ts in (("m", m), ("v", v)):
        table.check(what, name, ts, (torch.float32,))
    c_dt = torch.bfloat16
    if p_copy is not None:
        c_dt = table.check(what, "p_copy", p_copy, _COPY_DTYPES)
    table.check_scalars(
        what, step_sizes=(step_sizes, torch.float32, table.n_leaves),
        scale=(scale, torch.float32, 1),
        noop_flag=(noop_flag, torch.int32, 1))
    if table.n_chunks == 0:
        return None
    err = build.library().apex_adam_tree(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.n_chunks, table.chunk_size,
        *(table.pointers(ts).data_ptr() for ts in (p, m, v, g)),
        None if p_copy is None else table.pointers(p_copy).data_ptr(),
        step_sizes.data_ptr(), scale.data_ptr(),
        None if noop_flag is None else noop_flag.data_ptr(),
        beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps, weight_decay,
        int(eps_mode == EPS_MODE_INSIDE), _DTYPES[p_dt], _DTYPES[g_dt],
        _DTYPES[c_dt], build.stream_of(scale))
    build.check(err, what)
    packed_adam_tree.launches += 1
    return None


packed_adam_tree.launches = 0
