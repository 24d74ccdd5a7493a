"""Expert parallelism: switch-style top-1 mixture of experts over a
process group, as ``apex_tpu/parallel/moe.py``.  Tokens are sharded over
the ranks of ``axis_name`` and so are the experts (``E = W · E_local``).

The router is JAX's: softmax in fp32, the expert by the port's
lowest-index :func:`~apex_tpu_torch.models.generate.greedy_argmax`, the
queue position by a cumulative sum, and tokens past an expert's
``capacity = max(1, ceil(cf · T_local / E))`` dropped (they produce
zeros: add the residual outside).  :func:`top1_routing` returns JAX's
dense ``(T, E, C)`` dispatch and combine tensors.  :func:`moe_apply`
dispatches by index instead: each ``(expert, slot)`` holds at most one
token, so scattering the kept tokens into ``(E, C, d)`` and gathering
each token's ``(expert, slot)`` back times its gate computes JAX's
``tec,td->ecd`` and ``tec,ecd->td`` wherever the values are finite, with
no ``T · E · C · d`` product (the gather's backward is a scatter-add).
Two :class:`~apex_tpu_torch.parallel.p2p.AllToAll` exchanges, with JAX's
reshapes and transposes, carry the slots to the ranks that hold their
experts and back.

The Switch load-balancing loss ``E · Σ frac_routed · frac_prob`` is
averaged over the group.  Its backward averages the ranks' cotangents,
the adjoint of the mean when each rank's loss is its own term of one
objective (each rank's loss covers its own tokens): JAX's gradient of a
train step whose loss each rank computes on its shard (the expert mode
of ``examples/pipeline_moe.py``).  A term that every rank adds once
(``0.01 · aux`` on each rank's loss) thus counts once a rank, as the
experts' own gradients sum the ranks' losses through the exchanges.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from apex_tpu_torch.parallel.distributed import _all_reduce_
from apex_tpu_torch.parallel.p2p import AllToAll, group_of


def _route(logits: torch.Tensor, capacity: int):
    """``(expert, slot, keep, gate, aux)`` of each of the ``(T, E)``
    logits' tokens: its expert, its place in that expert's queue, whether
    it fits the capacity, its router probability, and the aux loss."""
    # imported here: the models import attention, which imports this
    # package
    from apex_tpu_torch.models.generate import greedy_argmax
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = greedy_argmax(probs)
    onehot = F.one_hot(expert, e).float()
    # the queue position: the running count down the tokens, scanned
    # along each expert's contiguous row (a scan down the T rows of the
    # (T, E) layout runs E lanes wide)
    rows = onehot.t().contiguous()
    slot = ((torch.cumsum(rows, dim=1) - 1.0) * rows).sum(0).long()
    gate = probs.gather(-1, expert[:, None])[:, 0]
    aux = e * torch.sum(onehot.mean(0) * probs.mean(0))
    return expert, slot, slot < capacity, gate, aux


def top1_routing(logits: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch top-1 routing of ``(T, E)`` logits: ``(dispatch, combine,
    aux_loss)``, ``dispatch`` the fp32 ``(T, E, C)`` one-hot (token t in
    slot c of expert e; dropped tokens all zero), ``combine`` it times
    the router probability, ``aux_loss`` the load-balancing loss."""
    expert, slot, keep, gate, aux = _route(logits, capacity)
    e = logits.shape[-1]
    dispatch = (F.one_hot(slot.clamp(max=capacity - 1), capacity)[:, None, :]
                * F.one_hot(expert, e)[:, :, None]
                * keep[:, None, None]).float()
    return dispatch, dispatch * gate[:, None, None], aux


class _GroupMean(torch.autograd.Function):
    """The mean over the group; the backward averages the cotangents."""

    @staticmethod
    def forward(ctx, group, world, t):
        ctx.group, ctx.world = group, world
        return _all_reduce_(t.detach().clone(), group) / world

    @staticmethod
    def backward(ctx, grad):
        return None, None, _all_reduce_(grad.clone(), ctx.group) / ctx.world


def moe_apply(expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
              expert_params: Any, router_w: torch.Tensor, x: torch.Tensor,
              axis_name="expert", capacity_factor: float = 2.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE layer, experts sharded over the group ``axis_name``.

    ``expert_fn(one_expert_params, (tokens, d)) -> (tokens, d)``;
    ``expert_params``: this rank's experts, every leaf with a leading
    ``E_local`` axis; ``router_w``: ``(d, E)`` (the same on every rank);
    ``x``: this rank's ``(T_local, d)`` tokens.  Returns ``(y, aux)``:
    ``y`` like ``x`` (zeros for dropped tokens), ``aux`` the group's mean
    load-balancing loss."""
    group, _, world = group_of(axis_name)
    t_local, d = x.shape
    e_local = pytree.tree_leaves(expert_params)[0].shape[0]
    e_global = world * e_local
    capacity = max(1, math.ceil(capacity_factor * t_local / e_global))

    logits = x @ router_w.to(x.dtype)
    expert, slot, keep, gate, aux = _route(logits, capacity)
    idx = (expert * capacity + slot)[keep]
    sent = torch.zeros((e_global * capacity, d), dtype=torch.float32,
                       device=x.device).index_add(0, idx, x[keep].float())
    # (E, C, d) -> (W, E_local, C, d) -all_to_all-> the slots of this
    # rank's experts from every rank, (E_local, W * C, d)
    recv, = AllToAll.apply(group, 0, 0,
                           sent.reshape(world, e_local, capacity, d))
    recv = recv.reshape(world, e_local, capacity, d).transpose(0, 1) \
        .reshape(e_local, world * capacity, d).to(x.dtype)
    out = torch.stack([
        expert_fn(pytree.tree_map(lambda l: l[i], expert_params), recv[i])
        for i in range(e_local)]).float()
    out = out.reshape(e_local, world, capacity, d).transpose(0, 1) \
        .reshape(world * e_local, capacity, d)
    back, = AllToAll.apply(group, 0, 0, out)
    picked = back.reshape(e_global * capacity, d).index_select(
        0, (expert * capacity + slot).clamp(max=e_global * capacity - 1))
    y = torch.where(keep[:, None], picked * gate[:, None],
                    torch.zeros_like(picked))
    return y.to(x.dtype), _GroupMean.apply(group, world, aux)


__all__ = ["moe_apply", "top1_routing"]
