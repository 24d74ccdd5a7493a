"""The chunk table of the multi-tensor kernels (K7 ``lamb_stage1``, K8
``lamb_stage2``, K9 ``packed_sumsq``).

The counterpart of the chunk-aligned metadata of
``apex_tpu/ops/packing.py`` (``AlignedMeta``, ``aligned_chunk_count``,
``pack_aligned``), without the packing copy: the JAX package packs a
tree into one flat buffer because it is functional, while on the card a
copy of every parameter there and back would cost more than the kernels
themselves.  Instead the table says where each chunk lies: a tree of
leaves is cut into chunks of at most :data:`CHUNK_SIZE` elements, every
chunk inside one leaf, and the device holds per chunk its leaf and its
first element, per leaf its element count and its first chunk.  A list
of tensors (parameters, gradients, moments) is one int64 row of leaf base
pointers (:meth:`ChunkTable.pointers`).  One CUDA block takes one chunk,
so each kernel is one launch over the whole tree, as the reference's
``multi_tensor_apply`` and the JAX package's whole-tree calls are.

Build a table once per optimizer and build it anew when the leaves'
sizes change; the pointer rows follow the tensors' storage on their own.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

import torch

#: elements a chunk holds at most: the reference applier's chunk
#: (``apex/multi_tensor_apply/__init__.py:3``, ``apex_tpu/ops/
#: multi_tensor.py:35``).  One 256-thread block streams it with 64
#: 16-byte loads a thread per list.
CHUNK_SIZE = 2048 * 32

#: element alignment of the leaves in :meth:`ChunkTable.flat_views`, so
#: every view starts on a 16-byte boundary for the kernels' vector loads
VIEW_ALIGN = 64

#: pointer rows kept per table: the six lists of a LAMB step (p, g, m,
#: v, u, the bf16 copies) and room for gradients whose storage moves
#: from step to step (a plain backward with ``set_to_none``; amp keeps
#: its gradient buffers, so under amp every row is uploaded once)
_ROWS_KEPT = 8


class ChunkTable:
    """Chunks of at most ``chunk_size`` elements over leaves of ``sizes``
    elements, on ``device``.

    Host attributes: ``sizes``, ``chunk_size``, ``n_leaves``,
    ``n_chunks``, ``first_chunk`` (per leaf, plus the total).  Device
    tensors: ``chunk_leaf`` (int32), ``chunk_start`` (int64, the chunk's
    first element in its leaf), ``leaf_numel`` (int64) and
    ``leaf_first_chunk`` (int32, ``n_leaves + 1``).  A leaf of no
    elements has no chunk.  Kernels over one table run on one stream (K9
    keeps its ticket here).  ``lookups`` counts the pointer rows asked
    for, ``uploads`` those sent to the card."""

    def __init__(self, sizes: Sequence[int], device, chunk_size: int =
                 CHUNK_SIZE):
        if chunk_size <= 0 or chunk_size % 4:
            raise ValueError(f"chunk_size {chunk_size} must be a positive "
                             f"multiple of 4")
        self.sizes: Tuple[int, ...] = tuple(int(s) for s in sizes)
        self.chunk_size = int(chunk_size)
        self.device = torch.device(device)
        leaf, start, first = [], [], [0]
        for i, n in enumerate(self.sizes):
            for s in range(0, n, self.chunk_size):
                leaf.append(i)
                start.append(s)
            first.append(len(leaf))
        self.n_leaves = len(self.sizes)
        self.n_chunks = len(leaf)
        self.first_chunk: Tuple[int, ...] = tuple(first)
        dev = self.device
        self.chunk_leaf = torch.tensor(leaf, dtype=torch.int32, device=dev)
        self.chunk_start = torch.tensor(start, dtype=torch.int64, device=dev)
        self.leaf_numel = torch.tensor(self.sizes, dtype=torch.int64,
                                       device=dev)
        self.leaf_first_chunk = torch.tensor(first, dtype=torch.int32,
                                             device=dev)
        #: K9's ticket: its blocks count themselves in here, and the last
        #: one (which sums the partials) sets it back to 0
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self._rows: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self.lookups = self.uploads = 0

    @classmethod
    def of(cls, tensors: Sequence[torch.Tensor],
           chunk_size: int = CHUNK_SIZE) -> "ChunkTable":
        """The table over ``tensors``' element counts, on their device."""
        if not tensors:
            raise ValueError("ChunkTable.of: no tensors")
        return cls([t.numel() for t in tensors], tensors[0].device,
                   chunk_size)

    def fits(self, tensors: Sequence[torch.Tensor]) -> bool:
        """Whether ``tensors`` have this table's leaf sizes, in order."""
        return tuple(t.numel() for t in tensors) == self.sizes

    def check(self, what: str, name: str, tensors: Sequence[torch.Tensor],
              dtypes: Sequence[torch.dtype]) -> torch.dtype:
        """Raise unless ``tensors`` are this table's leaves: one per leaf,
        of its size, contiguous, on the table's device, all of one dtype
        among ``dtypes``; returns that dtype."""
        if not self.fits(tensors):
            raise ValueError(f"{what}: {name} does not match the chunk "
                             f"table's {self.n_leaves} leaf sizes")
        kinds = {t.dtype for t in tensors}
        if len(kinds) > 1 or not kinds <= set(dtypes):
            raise TypeError(f"{what}: {name} holds {sorted(map(str, kinds))}"
                            f"; want one of {[str(d) for d in dtypes]}")
        for t in tensors:
            if t.device != self.device or not t.is_contiguous():
                raise ValueError(f"{what}: every {name} leaf must be "
                                 f"contiguous on {self.device}")
        return next(iter(kinds)) if kinds else dtypes[0]

    def pointers(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The int64 row of the leaves' base addresses, on the device
        (uploaded when these addresses were not seen lately, from pinned
        memory and in stream order: the host does not wait)."""
        key = tuple(t.data_ptr() for t in tensors)
        self.lookups += 1
        row = self._rows.get(key)
        if row is None:
            host = torch.tensor(key, dtype=torch.int64)
            if self.device.type == "cuda":
                host = host.pin_memory()
            row = host.to(self.device, non_blocking=True)
            self.uploads += 1
            self._rows[key] = row
            if len(self._rows) > _ROWS_KEPT:
                self._rows.popitem(last=False)
        else:
            self._rows.move_to_end(key)
        return row

    def flat_views(self, shapes: Sequence[torch.Size],
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One zeroed buffer and a view of it per leaf (of ``shapes``, one
        per leaf of the table), each starting on a :data:`VIEW_ALIGN`
        element boundary: scratch such as LAMB's update ``u``."""
        offsets, at = [], 0
        for n in self.sizes:
            offsets.append(at)
            at += -(-n // VIEW_ALIGN) * VIEW_ALIGN
        buf = torch.zeros(at, dtype=dtype, device=self.device)
        views = [buf[o:o + n].view(s) for o, n, s in
                 zip(offsets, self.sizes, shapes)]
        return buf, views

    def leaf_chunk_sums(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 sums of squares of one leaf's chunks, in chunk order: the
        plain version's per-chunk partials."""
        flat = x.reshape(-1).float()
        pad = (-flat.numel()) % self.chunk_size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(-1, self.chunk_size).square().sum(dim=1)


__all__ = ["CHUNK_SIZE", "ChunkTable", "VIEW_ALIGN"]
