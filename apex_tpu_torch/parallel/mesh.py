"""Meshes of ranks, as ``apex_tpu/parallel/mesh.py``, over
``torch.distributed`` process groups.

:func:`make_mesh` lays the world's ranks out as an array of ``shape``
with one name an axis.  For each axis, every rank makes the group of
every line of ranks along it (``torch.distributed.new_group``: each rank
creates every group, in the same order), and this rank's group along
each axis is registered under the axis's name, so that
``process_group("pipe")`` (and every ``axis_name=`` of the port's
collectives) resolves to it.  With no mesh naming it, ``"data"`` stays
the default (world) group.  A line that spans the whole world is the
world group itself.

The JAX package's ``replicated_sharding``, ``partition_spec_of`` and
``intended_specs`` describe JAX placements and the graph lint's intent:
they wait for the port's ``analysis/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.parallel.distributed import _AXIS_GROUPS

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks' layout (``devices``: an int array of global ranks, one
    axis a name), this rank's group along each axis, and its index
    there."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    groups: Dict[str, Any]
    coords: Dict[str, int]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name to size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Lay ``ranks`` (every rank of the default group by default) out as
    an array of ``shape`` (``None``: every rank on the first axis) and
    make and register the groups of each axis.  Every rank of the world
    calls it, with the same arguments; a rank outside ``ranks`` gets no
    group."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group is formed: call apex_tpu_torch."
                           "parallel.multiproc.initialize() first")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} axes, "
                         f"names {axis_names} {len(axis_names)}")
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold the "
                         f"{len(ranks)} ranks")
    devices = np.array(ranks, dtype=np.int64).reshape(shape)
    me = dist.get_rank()
    groups, coords = {}, {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(devices, a, -1).reshape(-1, devices.shape[a])
        for line in lines:
            members = [int(r) for r in line]
            group = dist.group.WORLD if members == list(range(world)) \
                else dist.new_group(members)
            if me in members:
                groups[name] = group
                coords[name] = members.index(me)
    for name in axis_names:
        _AXIS_GROUPS.pop(name, None)
    _AXIS_GROUPS.update(groups)
    return Mesh(devices, axis_names, groups, coords)


def data_parallel_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The DDP mesh: the first ``num_devices`` ranks (all by default) on
    one ``"data"`` axis."""
    import torch.distributed as dist
    n = dist.get_world_size() if num_devices is None else int(num_devices)
    return make_mesh(ranks=range(n))


def world_size(mesh: Mesh, axis_name: str = DATA_AXIS) -> int:
    return mesh.shape[axis_name]


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS):
    """This rank's share of a batch split over ``axis_name``: a function
    from a tensor to its block of the leading axis (``NamedSharding(mesh,
    P(axis_name))`` seen from one rank)."""
    n, i = mesh.shape[axis_name], mesh.coords[axis_name]

    def shard(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            raise ValueError(f"leading dim {x.shape[0]} does not split "
                             f"over {n} ranks of {axis_name!r}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return shard


__all__ = ["DATA_AXIS", "Mesh", "batch_sharding", "data_parallel_mesh",
           "make_mesh", "world_size"]
