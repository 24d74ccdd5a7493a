"""K15, the packed non-finite flag of ``apex_tpu/ops/pallas/experimental/
finite_pack.py`` (``csrc/multi_tensor_nonfinite.cu``), beside its plain
PyTorch version, and :func:`all_finite_packed`, its counterpart of
``all_finite_packed`` (the finite check amp's accumulation path runs
through :func:`apex_tpu_torch.amp.scaler.all_finite`).

:func:`packed_nonfinite` takes a
:class:`~apex_tpu_torch.ops.multi_tensor.ChunkTable` over the leaves, so
the whole tree is one launch with no packing copy, and the leaves keep
their own dtypes (float32, bfloat16, float16 in one launch).  The wrapper
launches the kernel for CUDA tensors and runs :func:`packed_nonfinite_ref`
for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import torch

from apex_tpu_torch.ops.cuda import build

if TYPE_CHECKING:
    from apex_tpu_torch.ops.multi_tensor import ChunkTable

#: the kernel's per-leaf dtype codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def packed_nonfinite_ref(table: ChunkTable,
                         xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """int32 ``(1,)``: 1 if any element of any leaf of ``xs`` (the
    table's leaves) is an inf or a nan, else 0."""
    if not table.fits(xs):
        raise ValueError("packed_nonfinite: the tensors do not match the "
                         "chunk table's leaf sizes")
    bad = [torch.logical_not(torch.isfinite(x).all()) for x in xs]
    if not bad:
        return torch.zeros(1, dtype=torch.int32, device=table.device)
    return torch.stack(bad).any().to(torch.int32).reshape(1)


def packed_nonfinite(table: ChunkTable,
                     xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`packed_nonfinite_ref`'s function.  On CUDA tensors one
    launch of the hand-written kernel over the whole table (counted in
    ``packed_nonfinite.launches``): contiguous float32, bfloat16 or
    float16 leaves, which may mix; the flag stays on the card."""
    if table.device.type == "cpu":
        return packed_nonfinite_ref(table, xs)
    if table.device.type != "cuda":
        raise ValueError(f"packed_nonfinite: unsupported device "
                         f"{table.device}")
    if not table.fits(xs):
        raise ValueError("packed_nonfinite: the tensors do not match the "
                         "chunk table's leaf sizes")
    for x in xs:
        if x.dtype not in DTYPE_CODES:
            raise TypeError(f"packed_nonfinite: {x.dtype} unsupported "
                            f"(float32 / bfloat16 / float16)")
        if x.device != table.device or not x.is_contiguous():
            raise ValueError(f"packed_nonfinite: every leaf must be "
                             f"contiguous on {table.device}")
    flag = torch.zeros(1, dtype=torch.int32, device=table.device)
    if table.n_chunks == 0:
        return flag
    codes = table.codes(tuple(DTYPE_CODES[x.dtype] for x in xs))
    err = build.library().apex_packed_nonfinite(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.n_chunks, table.chunk_size,
        table.pointers(xs).data_ptr(), codes.data_ptr(), flag.data_ptr(),
        build.stream_of(flag))
    build.check(err, "packed_nonfinite")
    packed_nonfinite.launches += 1
    return flag


packed_nonfinite.launches = 0


def all_finite_packed(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-dim bool: every element of every floating tensor is finite
    (integer tensors are skipped; an empty list gives True), as the JAX
    package's ``all_finite_packed``: one :func:`packed_nonfinite` over
    the chunk table of the floating leaves, read in place."""
    from apex_tpu_torch.ops.multi_tensor import table_for
    floats = [t.contiguous() for t in tensors if t.is_floating_point()]
    if not floats:
        return torch.tensor(True)
    flag = packed_nonfinite(table_for(floats), floats)
    return (flag == 0).reshape(())
