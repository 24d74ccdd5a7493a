"""K7 and K8: the two LAMB stages (``csrc/lamb.cu``) and their plain
PyTorch versions.

The CUDA kernels replace the Pallas ``packed_lamb_stage1``
(``_stage1_kernel``, ``with_norms=True``) and ``packed_lamb_stage2``
(``_stage2_kernel``) of ``apex_tpu/ops/pallas/lamb_kernels.py``.  They
run over a :class:`~apex_tpu_torch.ops.multi_tensor.ChunkTable` -- one
launch each over the whole tree, leaves read in place -- where the TPU
kernels run over a chunk-aligned packed copy.  Unlike the functional JAX
update they write m, v and p in place (the state is dead after the step,
and copies would double the optimizer's memory); the update ``u`` goes
to a scratch tree the caller owns.

Stage 1 reads the global sum of squares of the gradients (K9) and forms
the clip factor itself; stage 2 sums each leaf's per-chunk norm partials
itself, in a fixed order.  Both read the amp overflow flag on the card
and write nothing when it is set.  :func:`lamb_stage1` /
:func:`lamb_stage2` launch the kernels for CUDA tensors and run
:func:`lamb_stage1_ref` / :func:`lamb_stage2_ref` for CPU tensors; they
never fall back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops.cuda import build
from apex_tpu_torch.ops.multi_tensor import ChunkTable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Leaves = Sequence[torch.Tensor]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _inv_clip(sumsq: torch.Tensor, max_grad_norm: float) -> torch.Tensor:
    """``1 / max(sqrt(sumsq) / max_grad_norm, 1)`` in fp32, on the device
    (the norm divided by a tensor, so the division is the kernel's true
    one)."""
    s = sumsq.float().reshape(1)
    clip = torch.clamp(torch.sqrt(s) / torch.full_like(s, max_grad_norm),
                       min=1.0)
    return 1.0 / clip


def lamb_stage1_ref(table: ChunkTable, p: Leaves, g: Leaves, m: Leaves,
                    v: Leaves, u: Leaves, bc1: torch.Tensor,
                    bc2: torch.Tensor, sumsq: Optional[torch.Tensor],
                    noop_flag: Optional[torch.Tensor], *, beta1: float,
                    beta2: float, eps: float, weight_decay: float,
                    max_grad_norm: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LAMB stage 1 over the table's leaves, in fp32 and in the op order
    of the JAX package's ``fused_lamb``: ``g * inv_clip`` (from ``sumsq``,
    one fp32, when given), both moments, ``u = (m / bc1) / (sqrt(v /
    bc2) + eps) + weight_decay * p`` with ``bc1`` / ``bc2`` one fp32 per
    leaf.  Writes ``m``, ``v`` and ``u`` in place (nothing when
    ``noop_flag``, one int32, is nonzero) and returns the per-chunk fp32
    ``(||p||^2, ||u||^2)`` partials."""
    inv = None if sumsq is None else _inv_clip(sumsq, max_grad_norm)
    keep = None if noop_flag is None else noop_flag.reshape(()) != 0
    p_sq, u_sq = [], []
    for i in range(table.n_leaves):
        g32, p32 = g[i].float(), p[i].float()
        if inv is not None:
            g32 = g32 * inv.reshape(())
        m32 = beta1 * m[i] + (1.0 - beta1) * g32
        v32 = beta2 * v[i] + (1.0 - beta2) * g32 * g32
        u32 = (m32 / bc1[i]) / (torch.sqrt(v32 / bc2[i]) + eps) \
            + weight_decay * p32
        p_sq.append(table.leaf_chunk_sums(p32))
        u_sq.append(table.leaf_chunk_sums(u32))
        if keep is not None:
            m32 = torch.where(keep, m[i], m32)
            v32 = torch.where(keep, v[i], v32)
            u32 = torch.where(keep, u[i], u32)
        m[i].copy_(m32)
        v[i].copy_(v32)
        u[i].copy_(u32)
    dev = table.device
    return (torch.cat(p_sq) if p_sq else torch.zeros(0, device=dev),
            torch.cat(u_sq) if u_sq else torch.zeros(0, device=dev))


def lamb_stage1(table: ChunkTable, p: Leaves, g: Leaves, m: Leaves,
                v: Leaves, u: Leaves, bc1: torch.Tensor, bc2: torch.Tensor,
                sumsq: Optional[torch.Tensor],
                noop_flag: Optional[torch.Tensor], *, beta1: float,
                beta2: float, eps: float, weight_decay: float,
                max_grad_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lamb_stage1_ref`'s function.  On CUDA tensors one launch of
    the hand-written kernel over the whole table (counted in
    ``lamb_stage1.launches``): p float32 or bfloat16, g float32 or p's
    dtype (widened to fp32), m, v, u float32, each list contiguous and
    of one dtype; ``bc1``, ``bc2``, ``sumsq`` and ``noop_flag`` stay on
    the card.  m, v and u equal the plain version's on the card bit for
    bit; the partials are fixed-order sums (equal bits run to run)."""
    if table.device.type == "cpu":
        return lamb_stage1_ref(table, p, g, m, v, u, bc1, bc2, sumsq,
                               noop_flag, beta1=beta1, beta2=beta2, eps=eps,
                               weight_decay=weight_decay,
                               max_grad_norm=max_grad_norm)
    if table.device.type != "cuda":
        raise ValueError(f"lamb_stage1: unsupported device {table.device}")
    what = "lamb_stage1"
    p_dt = table.check(what, "p", p, tuple(_DTYPES))
    g_dt = table.check(what, "g", g, (torch.float32, p_dt))
    for name, ts in (("m", m), ("v", v), ("u", u)):
        table.check(what, name, ts, (torch.float32,))
    _check_scalars(what, table, bc1=(bc1, torch.float32, table.n_leaves),
                   bc2=(bc2, torch.float32, table.n_leaves),
                   sumsq=(sumsq, torch.float32, 1),
                   noop_flag=(noop_flag, torch.int32, 1))
    if sumsq is not None and not max_grad_norm > 0:
        raise ValueError(f"{what}: a clip needs max_grad_norm > 0")
    p_sq = torch.empty(table.n_chunks, dtype=torch.float32,
                       device=table.device)
    u_sq = torch.empty_like(p_sq)
    if table.n_chunks == 0:
        return p_sq, u_sq
    err = build.library().apex_lamb_stage1(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.n_chunks, table.chunk_size,
        *(table.pointers(ts).data_ptr() for ts in (p, g, m, v, u)),
        bc1.data_ptr(), bc2.data_ptr(), _ptr(sumsq), _ptr(noop_flag),
        p_sq.data_ptr(), u_sq.data_ptr(), beta1, beta2, 1.0 - beta1,
        1.0 - beta2, eps, weight_decay,
        max_grad_norm if sumsq is not None else 0.0, _DTYPES[p_dt],
        _DTYPES[g_dt], build.stream_of(p_sq))
    build.check(err, what)
    lamb_stage1.launches += 1
    return p_sq, u_sq


lamb_stage1.launches = 0


def _trust_ratio(table: ChunkTable, i: int, p_sq: torch.Tensor,
                 u_sq: torch.Tensor, lr: float) -> torch.Tensor:
    """``lr * ||p|| / ||u||`` of leaf ``i`` from its chunk partials, or
    ``lr`` when either norm is 0 (0-dim fp32)."""
    c0, c1 = table.first_chunk[i], table.first_chunk[i + 1]
    pn = torch.sqrt(p_sq[c0:c1].sum())
    un = torch.sqrt(u_sq[c0:c1].sum())
    trust = torch.where((pn > 0) & (un > 0),
                        pn / torch.clamp(un, min=1e-38), torch.ones_like(pn))
    return lr * trust


def lamb_stage2_ref(table: ChunkTable, p: Leaves, u: Leaves,
                    p_sq: torch.Tensor, u_sq: torch.Tensor,
                    noop_flag: Optional[torch.Tensor], *, lr: float,
                    p_copy: Optional[Leaves] = None) -> None:
    """LAMB stage 2 over the table's leaves: per leaf the trust ratio
    from stage 1's chunk partials, then ``p - ratio * u`` in fp32 (for a
    bf16 p: the delta rounded to bf16 first, then the bf16 sum, as the
    JAX optimizer casts its update to p's dtype), in place, and a bf16 copy
    into ``p_copy`` when given.  Nothing is written when ``noop_flag``
    is nonzero."""
    keep = None if noop_flag is None else noop_flag.reshape(()) != 0
    for i in range(table.n_leaves):
        ratio = _trust_ratio(table, i, p_sq, u_sq, lr)
        if p[i].dtype == torch.float32:
            new = p[i] - ratio * u[i]
        else:
            delta = (ratio * u[i]).to(p[i].dtype).float()
            new = (p[i].float() - delta).to(p[i].dtype)
        if keep is not None:
            new = torch.where(keep, p[i], new)
        if p_copy is not None:
            p_copy[i].copy_(new if keep is None else torch.where(
                keep, p_copy[i], new.to(p_copy[i].dtype)))
        p[i].copy_(new)


def lamb_stage2(table: ChunkTable, p: Leaves, u: Leaves, p_sq: torch.Tensor,
                u_sq: torch.Tensor, noop_flag: Optional[torch.Tensor], *,
                lr: float, p_copy: Optional[Leaves] = None) -> None:
    """:func:`lamb_stage2_ref`'s function.  On CUDA tensors one launch of
    the hand-written kernel over the whole table (counted in
    ``lamb_stage2.launches``): p float32 or bfloat16, u float32, p_copy
    bfloat16, each list contiguous and of one dtype; the partials and
    ``noop_flag`` stay on the card.  Every block of a leaf sums its
    partials in one fixed order: two runs give equal bits."""
    if table.device.type == "cpu":
        return lamb_stage2_ref(table, p, u, p_sq, u_sq, noop_flag, lr=lr,
                               p_copy=p_copy)
    if table.device.type != "cuda":
        raise ValueError(f"lamb_stage2: unsupported device {table.device}")
    what = "lamb_stage2"
    p_dt = table.check(what, "p", p, tuple(_DTYPES))
    table.check(what, "u", u, (torch.float32,))
    if p_copy is not None:
        table.check(what, "p_copy", p_copy, (torch.bfloat16,))
    _check_scalars(what, table, p_sq=(p_sq, torch.float32, table.n_chunks),
                   u_sq=(u_sq, torch.float32, table.n_chunks),
                   noop_flag=(noop_flag, torch.int32, 1))
    if table.n_chunks == 0:
        return None
    err = build.library().apex_lamb_stage2(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.leaf_first_chunk.data_ptr(),
        table.n_chunks, table.chunk_size, table.pointers(p).data_ptr(),
        table.pointers(u).data_ptr(),
        None if p_copy is None else table.pointers(p_copy).data_ptr(),
        p_sq.data_ptr(), u_sq.data_ptr(), _ptr(noop_flag), lr,
        _DTYPES[p_dt], build.stream_of(p_sq))
    build.check(err, what)
    lamb_stage2.launches += 1
    return None


lamb_stage2.launches = 0


def _check_scalars(what: str, table: ChunkTable, **specs) -> None:
    """Each ``name=(tensor or None, dtype, numel)`` must be that many
    contiguous elements of that dtype on the table's device."""
    for name, (t, dt, n) in specs.items():
        if t is None:
            continue
        if t.dtype != dt or t.numel() != n or t.device != table.device \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be {n} contiguous {dt} "
                             f"on {table.device}")
