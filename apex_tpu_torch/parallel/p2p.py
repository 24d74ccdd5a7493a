"""Point-to-point collectives as autograd Functions, shared by ring and
Ulysses attention (:mod:`apex_tpu_torch.attention.ring`), the pipeline
(:mod:`~apex_tpu_torch.parallel.pipeline`) and the experts
(:mod:`~apex_tpu_torch.parallel.moe`).  ``torch.distributed``'s ``send``
/ ``recv`` are not differentiable; these are:

- :class:`Hop`: tensors one rank forward (JAX's ``ppermute`` by
  ``i -> i + shift``); the backward sends the cotangents back by
  ``-shift``, the transpose JAX takes.  One node a hop keeps every rank's
  backward in the same order.
- :class:`Anchor`: a tensor itself, with other tensors as inputs whose
  cotangents are zeros, so that a chain of hops whose end a rank does not
  use still lies on its path to the loss and runs its backward.
- :class:`AllToAll`: JAX's tiled ``all_to_all``; the backward is the
  inverse all-to-all.
- :class:`Broadcast`: a tensor of one group rank on every rank; the
  backward is the identity (each rank's loss is the same function of the
  result, as when JAX computes one loss on a replicated value).

The ranks' backend decides how a tensor travels: NCCL moves device
memory; gloo's point-to-point operations read host memory, so under gloo
a CUDA tensor is copied to the host and back, explicitly (counted as
``via_host``).  Every call is counted by kind in
:func:`~apex_tpu_torch.parallel.collective_counts`: a shift as its
``kind`` (``ring_hop`` for the ring, ``pipe_hop`` for the pipeline) and
``send_recv`` a tensor, an all-to-all as ``all_to_all``, a broadcast as
``broadcast``.  At world size 1 a hop is the identity and nothing is
sent.  Each call is one entry of an open collective recording
(:func:`~apex_tpu_torch.parallel.distributed.issue`): a shift a
``collective-permute`` of all its tensors, an all-to-all an
``all-to-all`` a tensor (both ``async``: a batch of point-to-point
operations), a broadcast a ``collective-broadcast``; each entry carries
the caller's dtypes, not the 16-bit integer views that travel.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from apex_tpu_torch.parallel.distributed import (_COUNTS, DeclaredGroup,
                                                 _nbytes, group_rank,
                                                 group_size, issue,
                                                 process_group)


def group_of(axis_name):
    """``(group, rank in it, its size)`` of ``axis_name``."""
    group = process_group(axis_name)
    return group, group_rank(group), group_size(group)


def via_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must be staged on the host for ``group``'s backend
    (gloo moves host memory only)."""
    import torch.distributed as dist
    return t.is_cuda and not isinstance(group, DeclaredGroup) \
        and dist.get_backend(group) == "gloo"


def wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """``t`` as a contiguous tensor of a dtype every backend moves: the
    16-bit floats as int16 and bool as uint8 (the bits unchanged), on the
    host when ``host``."""
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    elif t.dtype == torch.bool:
        t = t.view(torch.uint8)
    if host:
        t = t.cpu()
        _COUNTS["via_host"] += 1
    return t


def unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device).view(like.dtype)


def shift(tensors: Sequence[torch.Tensor], group, by: int,
          kind: str = "ring_hop") -> List[torch.Tensor]:
    """Each tensor sent to group rank ``rank + by`` and received from
    ``rank - by`` (modulo the world), all in one batch of point-to-point
    operations; counted once as ``kind``.  At world size 1, the tensors
    themselves (nothing sent or counted)."""
    import torch.distributed as dist
    rank, world = group_rank(group), group_size(group)
    if world == 1:
        return list(tensors)
    sends = [wire(t, via_host(t, group)) for t in tensors]
    outs = [torch.empty_like(send) for send in sends]
    with issue("collective-permute", group, tensors,
               sum(_nbytes(t) for t in tensors), "async") as dry:
        if not dry:
            dst = dist.get_global_rank(group, (rank + by) % world)
            src = dist.get_global_rank(group, (rank - by) % world)
            ops = []
            for send, recv in zip(sends, outs):
                ops += [dist.P2POp(dist.isend, send, dst, group),
                        dist.P2POp(dist.irecv, recv, src, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    _COUNTS[kind] += 1
    _COUNTS["send_recv"] += len(tensors)
    return [unwire(o, t) for o, t in zip(outs, tensors)]


class Hop(torch.autograd.Function):
    """``Hop.apply(group, kind, *tensors)``: the tensors one rank
    forward; the backward sends their cotangents one rank back."""

    @staticmethod
    def forward(ctx, group, kind, *tensors):
        ctx.group, ctx.kind = group, kind
        return tuple(shift(tensors, group, 1, kind))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(shift(grads, ctx.group, -1, ctx.kind))


class Anchor(torch.autograd.Function):
    """``Anchor.apply(o, *ends)``: ``o`` itself, with ``ends`` as inputs
    whose cotangents are zeros."""

    @staticmethod
    def forward(ctx, o, *ends):
        ctx.like = [(e.shape, e.dtype, e.device) for e in ends]
        return o.view_as(o)

    @staticmethod
    def backward(ctx, do):
        return (do,) + tuple(torch.zeros(s, dtype=d, device=dev)
                             for s, d, dev in ctx.like)


def all_to_all(tensors: Sequence[torch.Tensor], group, split: int,
               concat: int) -> List[torch.Tensor]:
    """Each tensor cut into W chunks along ``split``, chunk j sent to rank
    j, the chunks received joined along ``concat`` in rank order (JAX's
    tiled ``all_to_all``), as one batch of point-to-point operations a
    tensor (gloo has no all-to-all in every PyTorch release; NCCL groups
    the batch as its own all-to-all does)."""
    import torch.distributed as dist
    rank, world = group_rank(group), group_size(group)
    outs = []
    for t in tensors:
        parts = [c.contiguous() for c in wire(t, via_host(t, group))
                 .chunk(world, dim=split)]
        got = [p if j == rank else torch.empty_like(p)
               for j, p in enumerate(parts)]
        with issue("all-to-all", group, [t], _nbytes(t), "async") as dry:
            if not dry and world > 1:
                ops = []
                for j in range(world):
                    if j != rank:
                        peer = dist.get_global_rank(group, j)
                        ops += [dist.P2POp(dist.isend, parts[j], peer, group),
                                dist.P2POp(dist.irecv, got[j], peer, group)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        _COUNTS["all_to_all"] += 1
        outs.append(torch.cat([unwire(g, t) for g in got], dim=concat))
    return outs


class AllToAll(torch.autograd.Function):
    """``AllToAll.apply(group, split, concat, *tensors)``: the tensors cut
    along ``split`` and joined along ``concat`` across the group; the
    backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, group, split, concat, *tensors):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return tuple(all_to_all(tensors, group, split, concat))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            all_to_all(grads, ctx.group, ctx.concat, ctx.split))


class Broadcast(torch.autograd.Function):
    """``Broadcast.apply(group, root, t)``: group rank ``root``'s ``t`` on
    every rank (the bits moved unchanged); the backward passes the
    cotangent through on every rank."""

    @staticmethod
    def forward(ctx, group, root, t):
        import torch.distributed as dist
        # as bytes: gloo's collectives take no 16-bit integers
        buf = t.detach().clone().contiguous().reshape(-1).view(torch.uint8)
        if via_host(t, group):
            buf = buf.cpu()
            _COUNTS["via_host"] += 1
        with issue("collective-broadcast", group, [t], _nbytes(t)) as dry:
            if not dry:
                dist.broadcast(buf, src=dist.get_global_rank(group, root),
                               group=group)
        _COUNTS["broadcast"] += 1
        return buf.to(t.device).view(t.dtype).reshape(t.shape)

    @staticmethod
    def backward(ctx, grad):
        return None, None, grad


__all__ = ["AllToAll", "Anchor", "Broadcast", "Hop", "all_to_all",
           "group_of", "shift", "unwire", "via_host", "wire"]
