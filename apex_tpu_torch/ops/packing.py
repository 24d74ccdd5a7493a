"""Flat-buffer packing, as ``apex_tpu/ops/packing.py``: a tensor list
concatenated into one flat buffer with its metadata, and sliced back.

:func:`pack` / :func:`unpack` (:class:`PackMeta`) zero-pad the whole
buffer to a multiple of ``chunk_size``; :func:`pack_aligned` /
:func:`pack_into` / :func:`unpack_aligned` (:class:`AlignedMeta`) pad
each tensor to a whole number of chunks, so no chunk straddles two
tensors; :func:`host_pack` / :func:`host_unpack` do the same for numpy
arrays on the host (one dtype a call, the reference's ``apex_C.flatten``
/ ``unflatten``).  The leaf order and the zero padding are the JAX
package's.

The port's kernels do not pack: they walk a chunk table over the leaves
where they lie (:class:`~apex_tpu_torch.ops.multi_tensor.ChunkTable`),
the counterpart of :class:`AlignedMeta`'s chunk ids.  Packing serves
checkpoint staging, host coalescing and flat optimizers.
:func:`streaming_pad`, :data:`STREAM_LANES` and :data:`STREAM_TILE_ROWS`
keep the JAX package's values so the names resolve; they are the Pallas
kernels' lane geometry, which no kernel of the port reads.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.multi_tensor import group_by_dtype

#: the JAX package's Pallas lane width and sublane tile floor (no kernel
#: of the port reads them)
STREAM_LANES = 1024
STREAM_TILE_ROWS = 8


def round_up(x: int, multiple: int) -> int:
    """The smallest multiple of ``multiple`` at least ``x``."""
    return int(-(-x // multiple) * multiple)


def streaming_pad(total: int, *, lanes: int = STREAM_LANES,
                  tile_rows: int = STREAM_TILE_ROWS) -> int:
    """``total`` (at least 1) rounded up to whole ``(tile_rows, lanes)``
    tiles: the JAX package's padding for its streaming Pallas kernels."""
    return round_up(max(total, 1), lanes * tile_rows)


class PackMeta(NamedTuple):
    """A packed list: each tensor's shape, size and offset in the flat
    buffer, the unpadded and padded totals, and the dtype."""

    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    padded: int
    dtype: Any


def leaf_sizes(tensors: Sequence[Any]) -> List[int]:
    """Element counts (a 0-dim tensor counts 1)."""
    return [int(np.prod(tuple(t.shape))) if len(t.shape) else 1
            for t in tensors]


def _offsets(sizes: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(o) for o in np.cumsum((0,) + tuple(sizes[:-1])))


def pack(tensors: Sequence[torch.Tensor],
         chunk_size: int) -> Tuple[torch.Tensor, PackMeta]:
    """The tensors raveled into one flat buffer (their dtype: the first
    tensor's), zero-padded to a multiple of ``chunk_size``."""
    if not tensors:
        raise ValueError("pack: no tensors")
    dtype = tensors[0].dtype
    sizes = tuple(leaf_sizes(tensors))
    total = int(sum(sizes))
    padded = round_up(max(total, 1), chunk_size)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    if padded != total:
        flat = torch.cat([flat, flat.new_zeros(padded - total)])
    return flat, PackMeta(tuple(tuple(t.shape) for t in tensors), sizes,
                          _offsets(sizes), total, padded, dtype)


def unpack(flat: torch.Tensor, meta: PackMeta) -> List[torch.Tensor]:
    """The tensors of :func:`pack` as views of ``flat``."""
    return [flat[o:o + n].view(s) for s, n, o in
            zip(meta.shapes, meta.sizes, meta.offsets)]


def host_pack(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, PackMeta]:
    """Host (numpy) arrays of one dtype in one flat array, unpadded,
    through the native host runtime (:func:`apex_tpu_torch._native.flatten`,
    a multithreaded copy: the ``apex_C.flatten`` analog)."""
    from apex_tpu_torch import _native
    arrays = [np.asarray(a) for a in arrays]
    if not arrays:
        raise ValueError("host_pack requires at least one array")
    flat = _native.flatten(arrays)
    sizes = tuple(int(a.size) for a in arrays)
    return flat, PackMeta(tuple(a.shape for a in arrays), sizes,
                          _offsets(sizes), int(flat.size), int(flat.size),
                          flat.dtype)


def host_unpack(flat: np.ndarray, meta: PackMeta) -> List[np.ndarray]:
    """The arrays of :func:`host_pack`, as new arrays
    (:func:`apex_tpu_torch._native.unflatten`)."""
    from apex_tpu_torch import _native
    return _native.unflatten(np.asarray(flat)[:meta.total], meta.shapes)


class AlignedMeta(NamedTuple):
    """A chunk-aligned packed list: shapes, unpadded sizes, each tensor's
    offset (a multiple of ``chunk_size``), the buffer's length, the
    tensor of each chunk, and the dtype."""

    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    chunk_size: int
    padded: int
    chunk_ids: Tuple[int, ...]
    dtype: Any


def aligned_chunk_count(sizes: Sequence[int], chunk_size: int) -> int:
    """The chunks :func:`pack_aligned` makes of tensors of ``sizes``."""
    return sum(-(-int(s) // chunk_size) for s in sizes)


def pack_aligned(tensors: Sequence[torch.Tensor], chunk_size: int
                 ) -> Tuple[torch.Tensor, AlignedMeta]:
    """The tensors raveled, each zero-padded to whole chunks, in one flat
    buffer (the first tensor's dtype)."""
    if not tensors:
        raise ValueError("pack_aligned: no tensors")
    dtype = tensors[0].dtype
    sizes = leaf_sizes(tensors)
    offsets, chunk_ids, parts, off = [], [], [], 0
    for i, (t, n) in enumerate(zip(tensors, sizes)):
        chunks = -(-n // chunk_size)
        flat = t.reshape(-1).to(dtype)
        if chunks * chunk_size != n:
            flat = torch.cat([flat, flat.new_zeros(chunks * chunk_size - n)])
        parts.append(flat)
        offsets.append(off)
        chunk_ids.extend([i] * chunks)
        off += chunks * chunk_size
    return torch.cat(parts), AlignedMeta(
        tuple(tuple(t.shape) for t in tensors), tuple(sizes), tuple(offsets),
        int(chunk_size), off, tuple(chunk_ids), dtype)


def pack_into(tensors: Sequence[torch.Tensor],
              meta: AlignedMeta) -> torch.Tensor:
    """Tensors of ``meta``'s shapes packed in its layout (one table for
    several same-shaped lists)."""
    buf = torch.zeros(meta.padded, dtype=tensors[0].dtype,
                      device=tensors[0].device)
    for t, n, o in zip(tensors, meta.sizes, meta.offsets):
        buf[o:o + n] = t.reshape(-1)
    return buf


def unpack_aligned(flat: torch.Tensor,
                   meta: AlignedMeta) -> List[torch.Tensor]:
    """The tensors of :func:`pack_aligned` as views of ``flat``."""
    return [flat[o:o + n].view(s) for s, n, o in
            zip(meta.shapes, meta.sizes, meta.offsets)]


__all__ = ["AlignedMeta", "PackMeta", "STREAM_LANES", "STREAM_TILE_ROWS",
           "aligned_chunk_count", "group_by_dtype", "host_pack",
           "host_unpack", "leaf_sizes", "pack", "pack_aligned", "pack_into",
           "round_up", "streaming_pad", "unpack", "unpack_aligned"]
