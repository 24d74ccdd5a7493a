"""The multi-tensor kernels of ``apex_tpu/ops/pallas/
multi_tensor_kernels.py``, each beside its plain PyTorch version:

- K6 :func:`packed_scale` (``csrc/multi_tensor_scale.cu``, replacing
  ``packed_scale``): scale with a non-finite check, the amp unscale,
  over leaves whose dtypes may mix (one dtype code a leaf).
- K9 :func:`packed_sumsq` (``csrc/multi_tensor_sumsq.cu``, replacing
  ``packed_sumsq``): the total sum of squares over a tree, the LAMB and
  FP16Optimizer global-norm clip.
- K10 :func:`packed_axpby` (``csrc/multi_tensor_axpby.cu``, replacing
  ``packed_axpby``): ``a * x + b * y`` with a non-finite check on x, y or
  both, gradient accumulation.
- K12 :func:`sumsq_per_tensor` (``csrc/multi_tensor_sumsq.cu``,
  replacing ``packed_sumsq_per_chunk`` and its segment add): one sum of
  squares per leaf, the per-tensor norms.

Each runs over a
:class:`~apex_tpu_torch.ops.multi_tensor.ChunkTable`, one launch over the
whole tree.  Each wrapper launches its kernel for CUDA tensors and runs
its ``*_ref`` plain version for CPU tensors; it never falls back from one
to the other.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence

import torch

from apex_tpu_torch.ops.cuda import build

if TYPE_CHECKING:
    from apex_tpu_torch.ops.multi_tensor import ChunkTable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K6 also takes fp16 (the gradients of an fp16 O2 step)
_SCALE_DTYPES = {**_DTYPES, torch.float16: 2}


def _set_flag_where(flag: torch.Tensor, bad: torch.Tensor) -> None:
    flag.copy_(torch.where(bad, torch.ones_like(flag), flag))


def packed_scale_ref(table: ChunkTable, x: Sequence[torch.Tensor],
                     scale: torch.Tensor, flag: torch.Tensor,
                     out: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``out[i] = (float(x[i]) * scale)`` cast to ``out[i]``'s dtype for
    every leaf (``out[i]`` may be ``x[i]``: in place); sets ``flag`` (one
    int32) to 1 when any value of any ``x[i]`` is not finite, without
    reading it back to the host.  Returns ``out``."""
    if not (table.fits(x) and table.fits(out)):
        raise ValueError("packed_scale: the tensors do not match the chunk "
                         "table's leaf sizes")
    s = scale.float()
    for xi, oi in zip(x, out):
        xf = xi.float()
        _set_flag_where(flag, ~torch.isfinite(xf).all())
        oi.copy_((xf * s).view(oi.shape))
    return list(out)


def packed_scale(table: ChunkTable, x: Sequence[torch.Tensor],
                 scale: torch.Tensor, flag: torch.Tensor,
                 out: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`packed_scale_ref`'s function.  On CUDA tensors one launch of
    the hand-written kernel over the whole table (counted in
    ``packed_scale.launches``): ``x`` and ``out`` each one list of the
    table's leaves, float32, bfloat16 or float16 each, in any mix (a
    leaf's input and output dtypes may differ; ``out`` may be ``x``
    itself).  Every leaf must be contiguous: a leaf that is not is
    refused (``ValueError``), not copied, so an in-place call always
    writes where it reads; the callers (``LossScaler.unscale``,
    ``multi_tensor_scale``) make their inputs contiguous first.
    ``scale``: one fp32, ``flag``: one int32, on the card.  Bit for bit
    the plain version."""
    if table.device.type == "cpu":
        return packed_scale_ref(table, x, scale, flag, out)
    if table.device.type != "cuda":
        raise ValueError(f"packed_scale: unsupported device {table.device}")
    what = "packed_scale"
    sizes = table.sizes
    if len(x) != len(sizes) or len(out) != len(sizes):
        raise ValueError(f"{what}: the tensors do not match the chunk "
                         f"table's {table.n_leaves} leaf sizes")
    # one pass over the leaves: a call's host cost grows with their count
    dev = table.device.index
    codes = []
    for xi, oi, n in zip(x, out, sizes):
        if xi.numel() != n or oi.numel() != n:
            raise ValueError(f"{what}: the tensors do not match the chunk "
                             f"table's {table.n_leaves} leaf sizes")
        ci, co = _SCALE_DTYPES.get(xi.dtype), _SCALE_DTYPES.get(oi.dtype)
        if ci is None or co is None:
            raise TypeError(f"{what}: {xi.dtype} -> {oi.dtype} unsupported "
                            f"(float32 / bfloat16 / float16)")
        if not (xi.is_contiguous() and oi.is_contiguous()) \
                or xi.get_device() != dev or oi.get_device() != dev:
            raise ValueError(f"{what}: every leaf must be contiguous on "
                             f"{table.device}")
        codes.append(ci + 3 * co)
    table.check_scalars(what, scale=(scale, torch.float32, 1),
                        flag=(flag, torch.int32, 1))
    if table.n_chunks == 0:
        return list(out)
    err = build.library().apex_multi_tensor_scale(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.n_chunks, table.chunk_size,
        table.pointers(x).data_ptr(), table.pointers(out).data_ptr(),
        table.codes(codes).data_ptr(), scale.data_ptr(), flag.data_ptr(),
        build.stream_of(flag))
    build.check(err, what)
    packed_scale.launches += 1
    return list(out)


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


def packed_axpby_ref(table: ChunkTable, x: Sequence[torch.Tensor],
                     y: Sequence[torch.Tensor], a: torch.Tensor,
                     b: torch.Tensor, flag: torch.Tensor,
                     out: Sequence[torch.Tensor], *,
                     arg_to_check: int = -1) -> None:
    """``out[i] = (a * float(x[i]) + b * float(y[i]))`` cast to
    ``out[i]``'s dtype, each product and the sum rounded on its own;
    ``out[i]`` may be ``x[i]`` or ``y[i]``.  Sets ``flag`` (one int32) to
    1 when a value of x (``arg_to_check=0``), of y (1) or of either (-1)
    is not finite; ``a``, ``b``: one fp32 each."""
    if not (table.fits(x) and table.fits(y) and table.fits(out)):
        raise ValueError("packed_axpby: the tensors do not match the chunk "
                         "table's leaf sizes")
    for xi, yi, oi in zip(x, y, out):
        xf, yf = xi.float(), yi.float()
        if arg_to_check in (-1, 0):
            _set_flag_where(flag, ~torch.isfinite(xf).all())
        if arg_to_check in (-1, 1):
            _set_flag_where(flag, ~torch.isfinite(yf).all())
        oi.copy_((a * xf + b * yf).view(oi.shape))


def packed_axpby(table: ChunkTable, x: Sequence[torch.Tensor],
                 y: Sequence[torch.Tensor], a: torch.Tensor, b: torch.Tensor,
                 flag: torch.Tensor, out: Sequence[torch.Tensor], *,
                 arg_to_check: int = -1) -> None:
    """:func:`packed_axpby_ref`'s function.  On CUDA tensors one launch of
    the hand-written kernel over the whole table (counted in
    ``packed_axpby.launches``): x, y and out each one list of contiguous
    float32 or bfloat16 leaves (out may be the x or the y list itself);
    ``a``, ``b`` and ``flag`` stay on the card.  Bit for bit the plain
    version."""
    if table.device.type == "cpu":
        return packed_axpby_ref(table, x, y, a, b, flag, out,
                                arg_to_check=arg_to_check)
    if table.device.type != "cuda":
        raise ValueError(f"packed_axpby: unsupported device {table.device}")
    what = "packed_axpby"
    if arg_to_check not in (-1, 0, 1):
        raise ValueError(f"{what}: arg_to_check {arg_to_check} not in "
                         f"(-1, 0, 1)")
    dts = [table.check(what, name, ts, tuple(_DTYPES))
           for name, ts in (("x", x), ("y", y), ("out", out))]
    table.check_scalars(what, a=(a, torch.float32, 1),
                        b=(b, torch.float32, 1), flag=(flag, torch.int32, 1))
    if table.n_chunks == 0:
        return None
    err = build.library().apex_multi_tensor_axpby(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.n_chunks, table.chunk_size,
        *(table.pointers(ts).data_ptr() for ts in (x, y, out)),
        a.data_ptr(), b.data_ptr(), flag.data_ptr(), arg_to_check,
        *(_DTYPES[d] for d in dts), build.stream_of(flag))
    build.check(err, what)
    packed_axpby.launches += 1
    return None


packed_axpby.launches = 0


def sumsq_per_tensor_ref(table: ChunkTable,
                         xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """fp32 ``sum(float(x)**2)`` of each leaf, shape ``(n_leaves,)``: the
    per-chunk partials of K9 summed per leaf in chunk order."""
    if not table.fits(xs):
        raise ValueError("sumsq_per_tensor: the tensors do not match the "
                         "chunk table's leaf sizes")
    if not xs:
        return torch.zeros(0, dtype=torch.float32, device=table.device)
    return torch.stack([table.leaf_chunk_sums(x).sum() for x in xs])


def sumsq_per_tensor(table: ChunkTable,
                     xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`sumsq_per_tensor_ref`'s function.  On CUDA tensors one
    launch of the hand-written kernel over the whole table (counted in
    ``sumsq_per_tensor.launches``): leaves float32 or bfloat16, all of
    one dtype, contiguous.  The sums are fixed-order (equal bits run to
    run) and stay on the card."""
    if table.device.type == "cpu":
        return sumsq_per_tensor_ref(table, xs)
    if table.device.type != "cuda":
        raise ValueError(f"sumsq_per_tensor: unsupported device "
                         f"{table.device}")
    dt = table.check("sumsq_per_tensor", "xs", xs, tuple(_DTYPES))
    out = torch.zeros(table.n_leaves, dtype=torch.float32,
                      device=table.device)
    if table.n_chunks == 0:
        return out
    partials = torch.empty(table.n_chunks, dtype=torch.float32,
                           device=table.device)
    err = build.library().apex_multi_tensor_sumsq_per_tensor(
        table.chunk_leaf.data_ptr(), table.chunk_start.data_ptr(),
        table.leaf_numel.data_ptr(), table.leaf_first_chunk.data_ptr(),
        table.n_chunks, table.n_leaves, table.chunk_size,
        table.pointers(xs).data_ptr(), _DTYPES[dt], partials.data_ptr(),
        table.ticket.data_ptr(), out.data_ptr(), build.stream_of(out))
    build.check(err, "sumsq_per_tensor")
    sumsq_per_tensor.launches += 1
    return out


sumsq_per_tensor.launches = 0
