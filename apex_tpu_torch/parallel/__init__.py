"""Data parallelism and batch normalization (``apex_tpu/parallel``) over
``torch.distributed`` process groups.

- :mod:`~apex_tpu_torch.parallel.multiproc` (``initialize``, ``spawn``,
  ``python -m apex_tpu_torch.parallel.multiproc``): forming the group;
- :class:`DistributedDataParallel`, :class:`Reducer`,
  :func:`reduce_gradients` (flat buckets), :func:`all_reduce`,
  :func:`all_gather`, :func:`broadcast`;
- :class:`SyncBatchNorm` (alias :data:`BatchNorm`), local or synchronized
  over a group or within rank lists, with :func:`convert_syncbn_model` and
  :func:`create_syncbn_process_group`;
- :mod:`~apex_tpu_torch.parallel.mesh` (:func:`make_mesh`: named axes of
  groups that every ``axis_name=`` resolves);
- :func:`pipeline_apply` / :func:`stack_stage_params` (pipeline stages
  over a group) and :func:`moe_apply` / :func:`top1_routing` (experts
  over a group), on the autograd point-to-point hops of
  :mod:`~apex_tpu_torch.parallel.p2p`.
"""

import importlib

from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    ReduceConfig,
    ReduceOp,
    Reducer,
    all_gather,
    all_reduce,
    broadcast,
    collective_counts,
    plan_buckets,
    reduce_gradients,
    reset_collective_counts,
)
from apex_tpu_torch.parallel import mesh
from apex_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    batch_sharding,
    data_parallel_mesh,
    make_mesh,
    world_size,
)
from apex_tpu_torch.parallel.moe import moe_apply, top1_routing
from apex_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from apex_tpu_torch.parallel.groups import (
    convert_syncbn_model,
    create_syncbn_process_group,
)
from apex_tpu_torch.parallel.sync_batchnorm import (
    BatchNorm,
    SyncBatchNorm,
    batchnorm_backward,
    batchnorm_backward_c_last,
    batchnorm_forward,
    batchnorm_forward_c_last,
    local_mean_var,
    reduce_bn,
    reduce_bn_c_last,
    welford_mean_var,
    welford_mean_var_c_last,
    welford_parallel,
)


def __getattr__(name):
    # imported on first use, so that ``python -m apex_tpu_torch.parallel.
    # multiproc`` does not find the module loaded by the package already
    if name == "multiproc":
        return importlib.import_module("apex_tpu_torch.parallel.multiproc")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BatchNorm", "DATA_AXIS", "DistributedDataParallel", "Mesh",
           "ReduceConfig", "ReduceOp", "Reducer", "SyncBatchNorm",
           "all_gather", "batch_sharding", "data_parallel_mesh",
           "make_mesh", "mesh", "moe_apply", "pipeline_apply",
           "stack_stage_params", "top1_routing", "world_size",
           "all_reduce", "batchnorm_backward", "batchnorm_backward_c_last",
           "batchnorm_forward", "batchnorm_forward_c_last", "broadcast",
           "collective_counts", "convert_syncbn_model",
           "create_syncbn_process_group", "local_mean_var", "multiproc",
           "plan_buckets", "reduce_bn", "reduce_bn_c_last",
           "reduce_gradients", "reset_collective_counts",
           "welford_mean_var", "welford_mean_var_c_last",
           "welford_parallel"]
