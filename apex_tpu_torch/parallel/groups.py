"""Process groups for SyncBatchNorm (``apex_tpu/parallel/groups.py``).

:func:`create_syncbn_process_group` returns the JAX package's rank
lists; :class:`~apex_tpu_torch.parallel.SyncBatchNorm` turns such lists
into ``torch.distributed`` subgroups once (:func:`subgroup_of`), every
rank creating every group in the same order, as PyTorch requires.
:func:`convert_syncbn_model` synchronizes every SyncBatchNorm of a copy
of a model.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

from torch import nn

from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm


def create_syncbn_process_group(group_size: int,
                                world_size: int) -> Optional[List[List[int]]]:
    """``world_size`` ranks in contiguous groups of ``group_size``
    (``parallel/__init__.py:55-92``), or None for ``group_size`` 0 (the
    whole world)."""
    if group_size == 0:
        return None
    if group_size > world_size:
        raise ValueError(
            f"group_size {group_size} exceeds world size {world_size}")
    if world_size % group_size != 0:
        raise ValueError(
            f"world size {world_size} must be divisible by group_size "
            f"{group_size} (reference asserts the same)")
    return [list(range(g * group_size, (g + 1) * group_size))
            for g in range(world_size // group_size)]


#: fields a model declares (and threads into its BatchNorms), as the JAX
#: package's models do; :func:`convert_syncbn_model` sets them too
SYNC_BN_FIELDS = ("bn_axis_name", "bn_process_group")

#: (default group, rank lists) -> (this rank's subgroup, its group ranks)
_SUBGROUPS: Dict[Tuple[int, Tuple[Tuple[int, ...], ...]], tuple] = {}


def subgroup_of(ranks: Sequence[Sequence[int]]):
    """This rank's ``torch.distributed`` subgroup among the partition
    ``ranks`` of the default group, and its member ranks.  Made once per
    partition (``new_subgroups_by_enumeration``: every rank creates every
    group, in order) and cached."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel.distributed import process_group
    world = process_group("data")
    key = (id(world), tuple(tuple(int(r) for r in g) for g in ranks))
    if key not in _SUBGROUPS:
        members = sorted(r for g in key[1] for r in g)
        if members != list(range(dist.get_world_size())):
            raise ValueError(f"process_group {ranks} must partition the "
                             f"{dist.get_world_size()} ranks")
        mine, _ = dist.new_subgroups_by_enumeration(
            [list(g) for g in key[1]])
        me = dist.get_rank()
        _SUBGROUPS[key] = (mine, next(g for g in key[1] if me in g))
    return _SUBGROUPS[key]


def convert_syncbn_model(module: nn.Module, axis_name="data",
                         process_group=None) -> nn.Module:
    """A copy of ``module`` with every
    :class:`~apex_tpu_torch.parallel.SyncBatchNorm` synchronized over
    ``axis_name`` (``"data"``: the default group, or a ``ProcessGroup``)
    and ``process_group`` (rank lists of
    :func:`create_syncbn_process_group`, or None: the whole group)
    (reference ``convert_syncbn_model``, ``parallel/__init__.py:21-53``).
    Parameters and running stats carry over exactly; the model's
    ``bn_axis_name`` / ``bn_process_group`` fields, where it has them,
    are set too."""
    bns = [m for m in module.modules() if isinstance(m, SyncBatchNorm)]
    if not bns:
        raise TypeError(f"{type(module).__name__} holds no SyncBatchNorm to "
                        "synchronize (see apex_tpu_torch.models.resnet)")
    SyncBatchNorm.check_sync(axis_name, process_group)
    out = copy.deepcopy(module)
    for m in out.modules():
        if isinstance(m, SyncBatchNorm):
            m.axis_name, m.process_group = axis_name, process_group
        if all(hasattr(m, f) for f in SYNC_BN_FIELDS):
            m.bn_axis_name, m.bn_process_group = axis_name, process_group
    return out
