"""Data-parallel gradient reduction (``apex_tpu/parallel/distributed.py``)
over ``torch.distributed`` process groups.

The knob set is the JAX package's (``apex/parallel/distributed.py:
134-177``): ``gradient_average`` (multiply by ``f / world`` after the
sum; without it the gradients arrive at ``sum / f``),
``gradient_predivide_factor`` ``f`` (divide each gradient by it before
the sum), ``allreduce_always_fp32`` (sum half gradients in fp32) and the
opt-in ``compression="sign"``.  Each leaf goes through
:func:`reduce_gradients` in ``reduce_leaf``'s order: the fp32 wire
upcast, ``sign``, the predivide, the sum, the post-scale, the cast back.

PyTorch leaves no compiler to coalesce collectives, so the sum runs over
flat buckets: the leaves grouped by (wire) dtype in order, cut by
:func:`plan_buckets` (the JAX package's greedy planner) at
``message_size`` elements, one ``all_reduce`` a bucket, then unflattened
into the leaves.  ResNet-50's 161 leaves take 4 collectives at the
default 10,000,000 elements (3 of bf16 gradients under O2, 1 of the fp32
BatchNorm leaves).

``axis_name`` keeps JAX's name and its default ``"data"``: here it names
``torch.distributed``'s default (world) group, or this rank's group
along a mesh axis of that name (:mod:`~apex_tpu_torch.parallel.mesh`),
and a ``ProcessGroup`` may stand in its place; any other string raises
``ValueError``.  The JAX
package's ``pvary_params`` has no counterpart: PyTorch's gradients are
per rank already, which is what ``pvary_params`` restores under
``shard_map``.

Every collective of :mod:`apex_tpu_torch.parallel` (these functions and
:class:`~apex_tpu_torch.parallel.SyncBatchNorm`'s statistics) is counted
by kind in :func:`collective_counts`.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

#: collectives issued by the port, by kind (``all_reduce``,
#: ``all_gather``, ``broadcast``)
_COUNTS: Dict[str, int] = collections.Counter()


def collective_counts() -> Dict[str, int]:
    """Collectives issued since :func:`reset_collective_counts`, by
    kind."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


class ReduceOp(enum.Enum):
    """The reductions of :func:`all_reduce` (``torch.distributed.
    ReduceOp``'s names, as the JAX package re-exports them)."""
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


AxisName = Union[str, Any]


#: this rank's group of each axis a mesh names
#: (:func:`~apex_tpu_torch.parallel.mesh.make_mesh` registers them)
_AXIS_GROUPS: Dict[str, Any] = {}


def process_group(axis_name: AxisName = "data"):
    """The ``torch.distributed`` group ``axis_name`` names: an axis of the
    last :func:`~apex_tpu_torch.parallel.mesh.make_mesh` (this rank's
    group along it), else ``"data"`` is the default (world) group; a
    ``ProcessGroup`` is itself.  Raises ``RuntimeError`` naming
    :func:`~apex_tpu_torch.parallel.multiproc.initialize` when no group
    is formed, and ``ValueError`` for another name."""
    import torch.distributed as dist
    if isinstance(axis_name, str):
        if axis_name != "data" and axis_name not in _AXIS_GROUPS:
            raise ValueError(
                f"axis_name {axis_name!r}: the port knows the default "
                f"group \"data\", a mesh's axes "
                f"({sorted(_AXIS_GROUPS)}) or a ProcessGroup")
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "no process group is formed: call apex_tpu_torch.parallel."
                "multiproc.initialize() (or torch.distributed."
                "init_process_group) in every rank first")
        return _AXIS_GROUPS.get(axis_name, dist.group.WORLD)
    if not isinstance(axis_name, dist.ProcessGroup):
        raise ValueError(f"axis_name must be an axis name or a "
                         f"ProcessGroup, got {type(axis_name).__name__}")
    return axis_name


def _all_reduce_(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """In-place sum (or ``op``) of ``t`` over ``group``."""
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    _COUNTS["all_reduce"] += 1
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group``, stacked on a new axis 0 in rank
    order."""
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    _COUNTS["all_gather"] += 1
    return torch.stack(parts)


def _broadcast_(t: torch.Tensor, group, root: int) -> torch.Tensor:
    """``t`` of the rank ``root`` of ``group`` (its group rank), in
    place."""
    import torch.distributed as dist
    src = root if group is dist.group.WORLD \
        else dist.get_global_rank(group, root)
    dist.broadcast(t, src=src, group=group)
    _COUNTS["broadcast"] += 1
    return t


def all_reduce(x: Any, axis_name: AxisName = "data",
               op: ReduceOp = ReduceOp.SUM) -> Any:
    """The sum (min, max) over the group of every tensor of ``x`` (a
    tensor or a list / tuple / dict tree of them), as new tensors.
    ``PRODUCT`` raises ``NotImplementedError``, as in the JAX package."""
    import torch.distributed as dist
    ops = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
           ReduceOp.MIN: dist.ReduceOp.MIN}
    if op not in ops:
        raise NotImplementedError(f"ReduceOp {op} is not supported")
    group = process_group(axis_name)
    return pytree.tree_map(
        lambda t: _all_reduce_(t.clone(), group, ops[op]), x)


def all_gather(x: Any, axis_name: AxisName = "data") -> Any:
    """Every tensor of ``x`` from each rank, stacked on a new axis 0
    (``lax.all_gather``'s layout)."""
    group = process_group(axis_name)
    return pytree.tree_map(lambda t: _all_gather(t, group), x)


def broadcast(x: Any, axis_name: AxisName = "data", root: int = 0) -> Any:
    """Rank ``root``'s value of every tensor of ``x``, as new tensors."""
    group = process_group(axis_name)
    return pytree.tree_map(lambda t: _broadcast_(t.clone(), group, root), x)


@dataclasses.dataclass(frozen=True)
class ReduceConfig:
    """The DDP knob set (``distributed.py:134-177``)."""

    gradient_average: bool = True
    gradient_predivide_factor: float = 1.0
    allreduce_always_fp32: bool = False
    compression: Optional[str] = None  # None | "sign"


def _fold_reduce_config(self) -> None:
    """Fold the reference's knob spellings into ``config`` when none is
    given; refuse both at once."""
    knobs = {k: getattr(self, k)
             for k in ("gradient_average", "gradient_predivide_factor",
                       "allreduce_always_fp32", "compression")}
    passed = {k: v for k, v in knobs.items() if v is not None}
    if self.config is None:
        object.__setattr__(self, "config", ReduceConfig(**passed))
        return
    if passed:
        raise ValueError(
            f"pass the reduction knobs either via config= or directly, "
            f"not both (got config={self.config} and {passed})")


def plan_buckets(numels: Sequence[int], message_numel: int,
                 triggers: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Greedy in-order bucket ids, one per tensor: the running bucket
    closes once its element count reaches ``message_numel`` or at a
    trigger tensor (``apex/parallel/distributed.py:339-362``).  Planned
    by the native host runtime (:mod:`apex_tpu_torch._native`, as the
    JAX package plans)."""
    from apex_tpu_torch import _native
    return _native.plan_buckets(numels, message_numel, triggers)


DEFAULT_MESSAGE_SIZE = 10_000_000


def reduce_gradients(grads: Any, axis_name: AxisName = "data",
                     config: ReduceConfig = ReduceConfig(),
                     message_size: int = DEFAULT_MESSAGE_SIZE) -> Any:
    """The reduced copy of a per-rank gradient tree (``allreduce_bucket``,
    ``distributed.py:379-398``): each leaf upcast to fp32 under
    ``allreduce_always_fp32``, ``sign``-compressed, divided by the
    predivide factor, summed over the group in flat buckets of at most
    about ``message_size`` elements (leaves grouped by dtype, in order),
    multiplied by ``f / world`` under ``gradient_average``, and cast back
    to its dtype."""
    group = process_group(axis_name)
    import torch.distributed as dist
    world = dist.get_world_size(group)
    leaves, spec = pytree.tree_flatten(grads)
    wire: List[torch.Tensor] = []
    for g in leaves:
        if config.allreduce_always_fp32:
            g = g.float()
        if config.compression == "sign":
            g = torch.sign(g)
        if config.gradient_predivide_factor != 1.0:
            g = g / config.gradient_predivide_factor
        wire.append(g)
    post = config.gradient_predivide_factor / world \
        if config.gradient_average else 1.0
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, g in enumerate(wire):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idxs in by_dtype.values():
        ids = plan_buckets([wire[i].numel() for i in idxs], message_size)
        for b in range(int(ids[-1]) + 1):
            members = [i for i, bi in zip(idxs, ids) if bi == b]
            with torch.profiler.record_function("ddp_bucket_pack"):
                flat = torch.cat([wire[i].reshape(-1) for i in members])
            _all_reduce_(flat, group)
            with torch.profiler.record_function("ddp_bucket_unpack"):
                if post != 1.0:
                    flat = flat * post
                at = 0
                for i in members:
                    n = wire[i].numel()
                    out[i] = flat[at:at + n].view(leaves[i].shape) \
                        .to(leaves[i].dtype)
                    at += n
    return pytree.tree_unflatten(out, spec)


def _broadcast_module_(module: nn.Module, group, root: int) -> nn.Module:
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            _broadcast_(t.data, group, root)
    return module


@dataclasses.dataclass(frozen=True)
class DistributedDataParallel:
    """The gradient-reducing wrapper (``distributed.py:134``): pass
    ``ddp.reduce_fn`` to :func:`apex_tpu_torch.amp.make_train_step` (or
    call ``ddp.reduce(grads)`` yourself).  It reduces the scaled
    gradients before amp's unscale, as the reference reduces scaled half
    gradients.  ``message_size`` sets the buckets' size in elements;
    :meth:`plan_buckets` shows the assignment."""

    axis_name: AxisName = "data"
    config: Optional[ReduceConfig] = None
    message_size: int = DEFAULT_MESSAGE_SIZE
    gradient_average: Optional[bool] = None
    gradient_predivide_factor: Optional[float] = None
    allreduce_always_fp32: Optional[bool] = None
    compression: Optional[str] = None

    def __post_init__(self):
        _fold_reduce_config(self)

    def reduce(self, grads: Any) -> Any:
        return reduce_gradients(grads, self.axis_name, self.config,
                                self.message_size)

    def plan_buckets(self, grads: Any,
                     triggers: Optional[Any] = None) -> np.ndarray:
        """Greedy in-order bucket ids for the leaves of ``grads``."""
        leaves = pytree.tree_leaves(grads)
        trig = pytree.tree_leaves(triggers) if triggers is not None \
            else None
        return plan_buckets([int(t.numel()) for t in leaves],
                            self.message_size, trig)

    @property
    def reduce_fn(self) -> Callable[[Any], Any]:
        return self.reduce

    def broadcast_params(self, params: Any, root: int = 0) -> Any:
        """Rank ``root``'s parameters everywhere (``distributed.py:242``):
        a module's parameters and buffers in place (it is returned), or
        a new tree of tensors."""
        if isinstance(params, nn.Module):
            return _broadcast_module_(params, process_group(self.axis_name),
                                      root)
        return broadcast(params, self.axis_name, root)


@dataclasses.dataclass(frozen=True)
class Reducer:
    """The manual-trigger variant (``distributed.py:94-131``): the caller
    decides when to reduce, e.g. once over accumulated gradients
    (``make_train_step(..., reduce_fn=reducer.reduce, accum_steps=N)``)."""

    axis_name: AxisName = "data"
    config: Optional[ReduceConfig] = None
    gradient_average: Optional[bool] = None
    gradient_predivide_factor: Optional[float] = None
    allreduce_always_fp32: Optional[bool] = None
    compression: Optional[str] = None

    def __post_init__(self):
        _fold_reduce_config(self)

    def reduce(self, grads: Any) -> Any:
        return reduce_gradients(grads, self.axis_name, self.config)
