"""The chunk table of the multi-tensor kernels (K6 ``packed_scale``, K7
``lamb_stage1``, K8 ``lamb_stage2``, K9 ``packed_sumsq``, K10
``packed_axpby``, K11 ``packed_adam_tree``, K12 ``sumsq_per_tensor``, K15
``packed_nonfinite``), and the functional
multi-tensor surface of ``apex_tpu/ops/multi_tensor.py`` over it.

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

The surface (:func:`multi_tensor_scale`, :func:`multi_tensor_axpby`,
:func:`multi_tensor_l2norm`, :func:`per_tensor_sumsq`) keeps the JAX
signatures ``op(chunk_size, tensor_lists, ...)``, with ``[ins]`` or
``[ins, out_templates]`` giving the output dtype, and returns ``(outs,
flag)`` with the flag one int32 on the device: nothing is read back to
the host.  ``multi_tensor_scale`` is one launch over the whole list,
whatever dtypes it mixes; the others group mixed-dtype lists by dtype,
one launch per group, each group over a table cached by its leaf sizes
and ``chunk_size`` (:func:`table_for`).  ``multi_tensor_axpby`` also
takes ``out=``: tensors to write into (kept buffers, or the inputs
themselves) instead of new ones.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops.cuda import (
    packed_axpby,
    packed_scale,
    packed_sumsq,
    sumsq_per_tensor,
)

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
    and K12 keep their ticket here).  ``lookups`` counts the pointer rows
    asked for, ``uploads`` those sent to the card."""

    def __init__(self, sizes: Sequence[int], device, chunk_size: int =
                 CHUNK_SIZE):
        if chunk_size <= 0 or chunk_size % 4:
            raise ValueError(f"chunk_size {chunk_size} must be a positive "
                             f"multiple of 4")
        self.sizes: Tuple[int, ...] = tuple(int(s) for s in sizes)
        self.chunk_size = int(chunk_size)
        dev = torch.device(device)
        leaf, start, first = [], [], [0]
        for i, n in enumerate(self.sizes):
            for s in range(0, n, self.chunk_size):
                leaf.append(i)
                start.append(s)
            first.append(len(leaf))
        self.n_leaves = len(self.sizes)
        self.n_chunks = len(leaf)
        self.first_chunk: Tuple[int, ...] = tuple(first)
        self.chunk_leaf = torch.tensor(leaf, dtype=torch.int32, device=dev)
        #: the device with its index, as the leaves report theirs
        #: (``"cuda"`` is ``cuda:0`` here)
        self.device = self.chunk_leaf.device
        self.chunk_start = torch.tensor(start, dtype=torch.int64, device=dev)
        self.leaf_numel = torch.tensor(self.sizes, dtype=torch.int64,
                                       device=dev)
        self.leaf_first_chunk = torch.tensor(first, dtype=torch.int32,
                                             device=dev)
        #: K9's and K12's ticket: their blocks count themselves in here,
        #: and the last one (which sums the partials) sets it back to 0
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self._rows: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._codes: Dict[tuple, torch.Tensor] = {}
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
            row = to_device(key, torch.int64, self.device)
            self.uploads += 1
            self._rows[key] = row
            if len(self._rows) > _ROWS_KEPT:
                self._rows.popitem(last=False)
        else:
            self._rows.move_to_end(key)
        return row

    def codes(self, values: Sequence[int]) -> torch.Tensor:
        """One int32 per leaf (K15's dtype codes), on the device, uploaded
        once per distinct row."""
        key = tuple(int(v) for v in values)
        if len(key) != self.n_leaves:
            raise ValueError(f"{len(key)} codes for {self.n_leaves} leaves")
        row = self._codes.get(key)
        if row is None:
            row = self._codes[key] = to_device(key, torch.int32, self.device)
        return row

    def _view_offsets(self, dtypes: Sequence[torch.dtype]
                      ) -> Tuple[List[int], Dict[torch.dtype, int]]:
        """Each leaf's first element in its dtype's buffer, every leaf on a
        :data:`VIEW_ALIGN` element boundary, and each buffer's length."""
        offsets, ends = [], {}
        for n, dt in zip(self.sizes, dtypes):
            at = ends.get(dt, 0)
            offsets.append(at)
            ends[dt] = at + -(-n // VIEW_ALIGN) * VIEW_ALIGN
        return offsets, ends

    def flat_views(self, shapes: Sequence[torch.Size],
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One zeroed buffer and a view of it per leaf (of ``shapes``, one
        per leaf of the table), each starting on a :data:`VIEW_ALIGN`
        element boundary: scratch such as LAMB's update ``u``."""
        offsets, ends = self._view_offsets([dtype] * self.n_leaves)
        buf = torch.zeros(ends.get(dtype, 0), dtype=dtype,
                          device=self.device)
        views = [buf[o:o + n].view(s) for o, n, s in
                 zip(offsets, self.sizes, shapes)]
        return buf, views

    def empty_views(self, shapes: Sequence[torch.Size],
                    dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
        """:meth:`flat_views` without the fill and with a dtype a leaf:
        one uninitialised buffer per dtype, a view of it per leaf (of
        ``shapes`` and ``dtypes``), each on a :data:`VIEW_ALIGN` element
        boundary (16-byte accesses), for outputs every element of which
        a kernel writes (the unscale's)."""
        offsets, ends = self._view_offsets(dtypes)
        bufs = {dt: torch.empty(n, dtype=dt, device=self.device)
                for dt, n in ends.items()}
        return [bufs[dt][o:o + n].view(s) for o, n, s, dt in
                zip(offsets, self.sizes, shapes, dtypes)]

    def check_scalars(self, what: str, **specs) -> None:
        """Each ``name=(tensor or None, dtype, numel)`` must be that many
        contiguous elements of that dtype on the table's device."""
        for name, (t, dt, n) in specs.items():
            if t is None:
                continue
            if t.dtype != dt or t.numel() != n or t.device != self.device \
                    or not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be {n} contiguous "
                                 f"{dt} on {self.device}")

    def leaf_chunk_sums(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 sums of squares of one leaf's chunks, in chunk order: the
        plain version's per-chunk partials."""
        flat = x.reshape(-1).float()
        pad = (-flat.numel()) % self.chunk_size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(-1, self.chunk_size).square().sum(dim=1)


def to_device(values: Sequence, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A small host list as a device tensor: from pinned memory in stream
    order on the card (the host does not wait), as it is on the CPU."""
    host = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


#: tables kept by :func:`table_for`; a training loop sees a few lists of
#: fixed sizes again and again
_TABLES_KEPT = 16
_TABLES: "OrderedDict[tuple, ChunkTable]" = OrderedDict()


def table_for(tensors: Sequence[torch.Tensor],
              chunk_size: int = CHUNK_SIZE) -> ChunkTable:
    """The chunk table over ``tensors``' sizes and device, made once and
    kept (the least recently used of :data:`_TABLES_KEPT` go).  Kernels
    over one table run on one stream (K9 and K12 keep their ticket
    there)."""
    key = (tuple(t.numel() for t in tensors), int(chunk_size),
           tensors[0].device)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = ChunkTable(key[0], key[2], chunk_size)
        if len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return table


def cached_tables() -> List[ChunkTable]:
    """The tables :func:`table_for` keeps (for their row counters)."""
    return list(_TABLES.values())


def group_by_dtype(items: Sequence[Any]) -> Dict[Any, List[int]]:
    """Indices grouped by dtype, in first-seen order (the JAX package's
    ``packing.group_by_dtype``): a tensor's dtype, or the item itself (a
    dtype, or a tuple of the dtypes of several lists)."""
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(items):
        key = t.dtype if isinstance(t, torch.Tensor) else t
        groups.setdefault(key, []).append(i)
    return groups


def _scalar(v, device) -> torch.Tensor:
    """``v`` (a number or a one-element tensor) as one fp32 on ``device``,
    made on the device (no host sync)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(device=device, dtype=torch.float32)
    return torch.full((1,), float(v), dtype=torch.float32, device=device)


def _resolve_out_dtype(tensor_lists, out_dtype):
    if out_dtype is not None:
        return out_dtype
    if len(tensor_lists) > 1 and tensor_lists[-1]:
        return tensor_lists[-1][0].dtype
    return None  # each group's own dtype


def _no_flag() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def multi_tensor_scale(chunk_size: int,
                       tensor_lists: Sequence[Sequence[torch.Tensor]],
                       scale, out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``outs[i] = ins[i] * scale`` in fp32, cast to the output dtype, and
    a 0-dim int32 flag (1 when any input value is not finite).
    ``tensor_lists`` is ``[ins]`` or ``[ins, out_templates]`` (the second
    list gives only the dtype).  K6, one launch over the chunk table of
    ``ins`` at ``chunk_size``, whatever dtypes the leaves mix; the outputs
    are views of one new buffer per output dtype."""
    ins = [t.contiguous() for t in tensor_lists[0]]
    odt = _resolve_out_dtype(tensor_lists, out_dtype)
    if not ins:
        return [], _no_flag()
    dev = ins[0].device
    table = table_for(ins, chunk_size)
    outs = table.empty_views([x.shape for x in ins],
                             [odt or x.dtype for x in ins])
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    packed_scale(table, ins, _scalar(scale, dev), flag, outs)
    return outs, flag.reshape(())


def multi_tensor_axpby(chunk_size: int,
                       tensor_lists: Sequence[Sequence[torch.Tensor]],
                       a, b, arg_to_check: int = -1,
                       out_dtype: Optional[torch.dtype] = None, *,
                       out: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``outs[i] = a * xs[i] + b * ys[i]`` in fp32, cast to the output
    dtype, and a 0-dim int32 flag: 1 when a value of x
    (``arg_to_check=0``), of y (1) or of either (-1) is not finite.
    ``tensor_lists`` is ``[xs, ys]`` or ``[xs, ys, out_templates]``;
    ``out`` may hold the xs or ys themselves (in place).  K10, one launch
    per dtype group over its chunk table."""
    xs, ys = list(tensor_lists[0]), list(tensor_lists[1])
    if len(xs) != len(ys):
        raise ValueError(f"{len(xs)} xs for {len(ys)} ys")
    if arg_to_check not in (-1, 0, 1):
        raise ValueError(f"arg_to_check {arg_to_check} not in (-1, 0, 1)")
    odt = _resolve_out_dtype(tensor_lists, out_dtype) \
        if len(tensor_lists) > 2 else out_dtype
    if not xs:
        return [], _no_flag()
    if out is not None and len(out) != len(xs):
        raise ValueError(f"{len(out)} out tensors for {len(xs)} inputs")
    dev = xs[0].device
    a_t, b_t = _scalar(a, dev), _scalar(b, dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    outs: List[Optional[torch.Tensor]] = list(out) if out is not None \
        else [torch.empty_like(x, dtype=odt or x.dtype) for x in xs]
    keys = [(x.dtype, y.dtype, o.dtype) for x, y, o in zip(xs, ys, outs)]
    for _, idxs in group_by_dtype(keys).items():
        gx = [xs[i].contiguous() for i in idxs]
        packed_axpby(table_for(gx, chunk_size), gx,
                     [ys[i].contiguous() for i in idxs], a_t, b_t, flag,
                     [outs[i] for i in idxs], arg_to_check=arg_to_check)
    return outs, flag.reshape(())


def per_tensor_sumsq(chunk_size: int,
                     tensor_lists: Sequence[Sequence[torch.Tensor]]
                     ) -> torch.Tensor:
    """fp32 sum of squares of each tensor of ``tensor_lists[0]``, one
    vector on the device: K12, one launch per dtype group."""
    ins = list(tensor_lists[0])
    if not ins:
        return torch.zeros(0, dtype=torch.float32)
    groups = group_by_dtype(ins)
    parts = []
    for _, idxs in groups.items():
        g = [ins[i].contiguous() for i in idxs]
        parts.append(sumsq_per_tensor(table_for(g, chunk_size), g))
    if len(groups) == 1:
        return parts[0]
    order = [i for idxs in groups.values() for i in idxs]
    dev = ins[0].device
    per = torch.empty(len(ins), dtype=torch.float32, device=dev)
    return per.index_copy_(0, to_device(order, torch.int64, dev),
                           torch.cat(parts))


def multi_tensor_l2norm(chunk_size: int,
                        tensor_lists: Sequence[Sequence[torch.Tensor]],
                        per_tensor: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The L2 norm of all of ``tensor_lists[0]`` (0-dim fp32) and, with
    ``per_tensor``, each tensor's (as JAX forms them: ``sqrt(sum(per))``
    and ``sqrt(per)`` from the per-tensor sums of squares, K12); without
    it the total of K9 over each dtype group."""
    ins = list(tensor_lists[0])
    if not ins:
        z = torch.zeros((), dtype=torch.float32)
        return z, (torch.zeros(0, dtype=torch.float32) if per_tensor
                   else None)
    if per_tensor:
        per = per_tensor_sumsq(chunk_size, [ins])
        return torch.sqrt(per.sum()), torch.sqrt(per)
    total = None
    for _, idxs in group_by_dtype(ins).items():
        g = [ins[i].contiguous() for i in idxs]
        part = packed_sumsq(table_for(g, chunk_size), g).reshape(())
        total = part if total is None else total + part
    return torch.sqrt(total), None


__all__ = ["CHUNK_SIZE", "ChunkTable", "VIEW_ALIGN", "cached_tables",
           "group_by_dtype", "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_scale", "per_tensor_sumsq", "table_for",
           "to_device"]
