"""Data parallelism and batch normalization (``apex_tpu/parallel``).

Ported: :class:`SyncBatchNorm` (alias :data:`BatchNorm`) at world size
one, with the JAX package's statistics, running-stat update and
hand-written backward.  Across processes (``process_group`` /
``axis_name``), ``DistributedDataParallel`` and the rest wait for
ROADMAP.md Queue 1 #4.
"""

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

__all__ = ["BatchNorm", "SyncBatchNorm", "batchnorm_backward",
           "batchnorm_backward_c_last", "batchnorm_forward",
           "batchnorm_forward_c_last", "local_mean_var", "reduce_bn",
           "reduce_bn_c_last", "welford_mean_var", "welford_mean_var_c_last",
           "welford_parallel"]
