"""Pipeline parallelism over a process group, as
``apex_tpu/parallel/pipeline.py``: stage ``s`` of ``S`` lives on group
rank ``s``, microbatch activations travel stage to stage by a
:class:`~apex_tpu_torch.parallel.p2p.Hop` a tick, and the backward
pipeline is autograd's: each hop's backward sends its cotangent one rank
back (GPipe: every microbatch forward, then every one backward).

The schedule is JAX's: ``M + S - 1`` ticks, and every rank runs its stage
at every tick; stage 0 takes microbatch ``min(t, M - 1)`` and the others
what the previous tick's hop delivered (``torch.where`` on a device
flag, as JAX's ``jnp.where``, so a rank's unused inputs still carry a
zero cotangent and every hop lies on every rank's path to the loss: each
rank runs every hop's backward, in the same order).  The last stage's
outputs at ticks ``S-1 .. S-1+M-1`` are the result, which every rank
receives (JAX's ``psum`` of the last rank's output and the others'
zeros, here a broadcast of the same bits).  Its backward passes the
cotangent through: every rank computes the loss of the same ``y``, and
each gets the gradient JAX gives when the loss is taken once; a sum of
the ranks' cotangents would give ``S`` times that.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from apex_tpu_torch.parallel.p2p import Broadcast, Hop, group_of


def stack_stage_params(params_list: Sequence[Any]) -> Any:
    """Per-stage parameter trees stacked along a new leading stage axis
    (rank ``s`` takes slice ``[s:s + 1]``, the layout
    :func:`pipeline_apply` expects)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *params_list)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor,
                   axis_name="pipe", n_microbatches: Optional[int] = None,
                   stacked: bool = True) -> torch.Tensor:
    """Run ``x`` through the ``S`` stages of the group ``axis_name`` (a
    mesh axis, ``"data"`` or a ``ProcessGroup``), this rank holding stage
    ``rank``.

    ``stage_fn(one_stage_params, activation) -> activation`` keeps the
    activation's shape.  ``stage_params``: this rank's slice of a
    :func:`stack_stage_params` tree (every leaf with a leading stage axis
    of size 1, which is squeezed and checked), or with ``stacked=False``
    a tree at the stage's own shapes.  ``x``: the whole batch, the same on
    every rank, split into ``n_microbatches`` (default ``S``) equal
    microbatches along axis 0.  Returns the last stage's ``(batch, ...)``
    output on every rank."""
    group, s, S = group_of(axis_name)
    M = n_microbatches or S
    batch = x.shape[0]
    if batch % M:
        raise ValueError(f"batch {batch} not divisible into {M} "
                         f"microbatches")
    if stacked:
        def squeeze(leaf):
            if not leaf.dim() or leaf.shape[0] != 1:
                raise ValueError(
                    f"stacked stage param has local leading dim "
                    f"{tuple(leaf.shape)}; expected size 1 — pass this "
                    f"rank's slice of the stack_stage_params tree over "
                    f"{axis_name!r}, or pass stacked=False for "
                    "per-stage-shaped params")
            return leaf[0]
        params = pytree.tree_map(squeeze, stage_params)
    else:
        params = stage_params
    micro = x.reshape((M, batch // M) + tuple(x.shape[1:]))
    first = torch.tensor(s == 0, device=x.device)
    buf = torch.zeros_like(micro[0])
    outs = []
    for t in range(M + S - 1):
        inp = torch.where(first, micro[min(t, M - 1)], buf)
        out = stage_fn(params, inp)
        outs.append(out)
        if t < M + S - 2:
            buf, = Hop.apply(group, "pipe_hop", out)
    y = torch.cat(outs[S - 1:S - 1 + M])
    y = torch.where(torch.tensor(s == S - 1, device=x.device), y,
                    torch.zeros_like(y))
    return Broadcast.apply(group, S - 1, y)


__all__ = ["pipeline_apply", "stack_stage_params"]
