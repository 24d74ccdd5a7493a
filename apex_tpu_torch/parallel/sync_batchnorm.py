"""BatchNorm with the JAX package's numerics
(``apex_tpu/parallel/sync_batchnorm.py``), synchronized over processes.

- Statistics: the one-pass fp32 pair ``E[x^2] - E[x]^2`` over every axis
  but the channel one (:func:`local_mean_var`), clamped at 0, whatever the
  input dtype.
- Across processes (``axis_name``: ``"data"``, the default group, or a
  ``ProcessGroup``): with no ``process_group``, Chan's merge as two sum
  rounds over the group (``:333-344``): one ``all_reduce`` of the count
  and ``count * mean`` packed, one of ``count * var + count * (mean -
  global_mean)^2``.  With ``process_group`` rank lists
  (:func:`~apex_tpu_torch.parallel.create_syncbn_process_group`): one
  ``all_gather`` of ``(mean, var, count)`` within this rank's group, then
  :func:`welford_parallel` (``:345-360``).
- Normalize in fp32, cast back to the input dtype
  (:func:`batchnorm_forward`).
- Backward: the reference's hand-written two-stage split, ``reduce_bn ->
  all_reduce -> batchnorm_backward``, as a ``torch.autograd.Function``
  (:func:`_bn_train_apply`) that saves only the input at its own dtype and
  per-channel fp32 vectors; the cotangents of the batch mean and invstd
  are zero, their dependence on x folded into ``grad_input``.  Across
  processes ``mean_dy`` and ``mean_dy_xmu`` go out packed in one
  ``all_reduce`` and are divided by the group's size (the grouped form
  gathers them and takes the mean).  The scale and bias gradients stay
  per rank, as in the reference: data parallelism reduces them with every
  other leaf (the JAX package sums them over the axis inside the
  backward, where ``shard_map`` would otherwise sum them itself).
  ``fused_backward=False`` differentiates the stats graph instead (the
  same total derivative; not with ``process_group`` rank lists).
- Running stats: momentum 0.1 (``new = (1 - m) * old + m * batch``), the
  unbiased ``n / (n - 1)`` variance over the group's total count, in
  ``running_dtype``.  Eval makes no collective.

No ``F.batch_norm``: cuDNN's statistics and rounding are not the JAX
package's.  Unlike the fork's Python path, the module returns its output
(SURVEY.md section 0.2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch.ops import DeviceLike, resolve_device


def _shape(x: torch.Tensor, ch: int):
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return shape


def local_mean_var(x: torch.Tensor, reduce_axes: Sequence[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-channel ``(mean, biased var, count)`` in fp32: the one-pass
    ``E[x^2] - E[x]^2`` pair, clamped at 0."""
    x32 = x.float()
    count = 1
    for a in reduce_axes:
        count *= x.shape[a]
    axes = tuple(reduce_axes)
    mean = x32.mean(dim=axes)
    mean_sq = x32.square().mean(dim=axes)
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    return mean, var, count


#: the reference's spelling; the algorithm is :func:`local_mean_var`'s
welford_mean_var = local_mean_var


def welford_parallel(means: torch.Tensor, vars_: torch.Tensor,
                     counts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chan's merge of per-device ``(mean, biased var, count)`` stacked on
    axis 0: ``(mean, biased var)`` per channel."""
    counts = counts.float()
    if counts.dim() == 1:
        counts = counts[:, None]
    total = counts.sum(dim=0)
    mean = (counts * means).sum(dim=0) / total
    m2 = (counts * vars_).sum(dim=0) \
        + (counts * (means - mean[None, :]).square()).sum(dim=0)
    return mean, m2 / total


def batchnorm_forward(x: torch.Tensor, mean: torch.Tensor,
                      invstd: torch.Tensor, weight: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor],
                      channel_axis: int) -> torch.Tensor:
    """``(x - mean) * invstd * weight + bias`` in fp32, cast to x's
    dtype."""
    shape = _shape(x, channel_axis % x.dim())
    y = (x.float() - mean.reshape(shape)) * invstd.reshape(shape)
    if weight is not None:
        y = y * weight.reshape(shape).float()
    if bias is not None:
        y = y + bias.reshape(shape).float()
    return y.to(x.dtype)


def reduce_bn(grad_out: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
              invstd: torch.Tensor, weight: Optional[torch.Tensor],
              channel_axis: int):
    """Per-channel ``(mean_dy, mean_dy_xmu, grad_weight, grad_bias)`` in
    fp32 from local data (grad_weight / grad_bias whether or not there is
    a weight)."""
    ch = channel_axis % x.dim()
    axes = tuple(a for a in range(x.dim()) if a != ch)
    count = 1
    for a in axes:
        count *= x.shape[a]
    dy = grad_out.float()
    xmu = x.float() - mean.reshape(_shape(x, ch))
    sum_dy = dy.sum(dim=axes)
    sum_dy_xmu = (dy * xmu).sum(dim=axes)
    return sum_dy / count, sum_dy_xmu / count, sum_dy_xmu * invstd, sum_dy


def batchnorm_backward(grad_out: torch.Tensor, x: torch.Tensor,
                       mean: torch.Tensor, invstd: torch.Tensor,
                       weight: Optional[torch.Tensor], mean_dy: torch.Tensor,
                       mean_dy_xmu: torch.Tensor,
                       channel_axis: int) -> torch.Tensor:
    """``grad_input`` from the (global) means of :func:`reduce_bn`:
    ``(dy - mean_dy - (x - mean) * invstd^2 * mean_dy_xmu) * invstd *
    weight`` in fp32, cast to x's dtype."""
    shape = _shape(x, channel_axis % x.dim())
    dy = grad_out.float()
    xmu = x.float() - mean.reshape(shape)
    iv = invstd.reshape(shape)
    gi = (dy - mean_dy.reshape(shape)
          - xmu * iv.square() * mean_dy_xmu.reshape(shape)) * iv
    if weight is not None:
        gi = gi * weight.reshape(shape).float()
    return gi.to(x.dtype)


# _c_last spellings: NHWC's channel axis is the last one
def welford_mean_var_c_last(x: torch.Tensor):
    return welford_mean_var(x, tuple(range(x.dim() - 1)))


def batchnorm_forward_c_last(x, mean, invstd, weight, bias):
    return batchnorm_forward(x, mean, invstd, weight, bias, channel_axis=-1)


def reduce_bn_c_last(grad_out, x, mean, invstd, weight):
    return reduce_bn(grad_out, x, mean, invstd, weight, channel_axis=-1)


def batchnorm_backward_c_last(grad_out, x, mean, invstd, weight, mean_dy,
                              mean_dy_xmu):
    return batchnorm_backward(grad_out, x, mean, invstd, weight, mean_dy,
                              mean_dy_xmu, channel_axis=-1)


def _group_mean_(t: torch.Tensor, sync) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``sync`` (``(group, ranks)``:
    ranks None for the whole group, summed; else gathered)."""
    from apex_tpu_torch.parallel.distributed import (_all_gather,
                                                     _all_reduce_,
                                                     group_size)
    group, ranks = sync
    if ranks is None:
        return _all_reduce_(t, group).div_(group_size(group))
    return _all_gather(t, group).mean(dim=0)


class _BNTrainApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, invstd, weight, bias, channel_axis, sync):
        ctx.channel_axis = channel_axis
        ctx.sync = sync
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x, mean, invstd, weight)
        return batchnorm_forward(x, mean, invstd, weight, bias,
                                 channel_axis)

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, weight = ctx.saved_tensors
        ch = ctx.channel_axis
        mean_dy, mean_dy_xmu, gw, gb = reduce_bn(dy, x, mean, invstd,
                                                 weight, ch)
        if ctx.sync is not None:
            c = mean_dy.numel()
            with torch.profiler.record_function("sync_bn_backward"):
                both = _group_mean_(torch.cat([mean_dy, mean_dy_xmu]),
                                    ctx.sync)
            mean_dy, mean_dy_xmu = both[:c], both[c:]
        gi = batchnorm_backward(dy, x, mean, invstd, weight, mean_dy,
                                mean_dy_xmu, ch)
        return (gi, None, None,
                None if weight is None else gw.to(weight.dtype),
                None if ctx.bias_dtype is None else gb.to(ctx.bias_dtype),
                None, None)


def _bn_train_apply(channel_axis: int, x: torch.Tensor, mean: torch.Tensor,
                    invstd: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], sync=None) -> torch.Tensor:
    """Normalize with (detached) batch statistics; the backward is the
    total derivative through them, ``reduce_bn -> (the group's mean of
    mean_dy and mean_dy_xmu) -> batchnorm_backward``.  ``sync``: None
    (local), or ``(group, ranks)`` as :meth:`SyncBatchNorm.group` gives."""
    return _BNTrainApply.apply(x, mean.detach(), invstd.detach(), weight,
                               bias, channel_axis, sync)


def _synced_stats(mean: torch.Tensor, var: torch.Tensor, count: int,
                  sync, differentiable: bool):
    """The group's ``(mean, biased var, total count)`` from this rank's.
    Whole group: two sum rounds (the count and ``count * mean`` packed,
    then ``count * var + count * (mean - global_mean)^2``).  Rank lists:
    one gather of ``(mean, var, count)`` and :func:`welford_parallel`.
    ``differentiable`` sums through ``torch.distributed.nn`` (whose
    backward sums the cotangents over the group) for the unfused
    backward."""
    from apex_tpu_torch.parallel.distributed import (_COUNTS, _all_gather,
                                                     _all_reduce_, _nbytes,
                                                     issue)
    group, ranks = sync
    c = torch.full((1,), float(count), dtype=torch.float32,
                   device=mean.device)
    if ranks is not None:
        g = _all_gather(torch.cat([mean, var, c]), group)
        n = mean.numel()
        gmean, gvar = welford_parallel(g[:, :n], g[:, n:2 * n], g[:, 2 * n:])
        return gmean, gvar, g[:, 2 * n].sum()
    if differentiable:
        from torch.distributed.nn.functional import all_reduce

        def total(t):
            with issue("all-reduce", group, [t], _nbytes(t)) as dry:
                out = t if dry else all_reduce(t, group=group)
            _COUNTS["all_reduce"] += 1
            return out
    else:
        def total(t):
            return _all_reduce_(t, group)
    first = total(torch.cat([c, c * mean]))
    count_all = first[:1]
    gmean = first[1:] / count_all
    m2 = total(c * var + c * (mean - gmean).square())
    return gmean, m2 / count_all, count_all.reshape(())


class SyncBatchNorm(nn.Module):
    """BatchNorm over every axis but ``channel_axis`` (-1: NHWC), with
    parameters ``scale`` / ``bias`` (``param_dtype``) and buffers ``mean``
    / ``var`` (``running_dtype``), flax's names.

    ``use_running_average`` (here or per call; by default ``not
    self.training``) normalizes with the running stats; otherwise with the
    batch's, updating the running stats.  ``axis_name`` (``"data"``: the
    default ``torch.distributed`` group, or a ``ProcessGroup``; None:
    local) synchronizes the statistics over processes, within the rank
    lists of ``process_group`` where given (made into subgroups at the
    first synchronized forward).  ``fused_backward=False`` takes plain
    autograd through the stats graph (not with ``process_group``)."""

    def __init__(self, num_features: int,
                 use_running_average: Optional[bool] = None,
                 momentum: float = 0.1, epsilon: float = 1e-5,
                 affine: bool = True, axis_name=None,
                 process_group=None, channel_axis: int = -1,
                 param_dtype: torch.dtype = torch.float32,
                 running_dtype: torch.dtype = torch.float32,
                 fused_backward: bool = True, device: DeviceLike = None):
        super().__init__()
        self.check_sync(axis_name, process_group)
        dev = resolve_device(device, allow_meta=True)
        self.num_features = num_features
        self.use_running_average = use_running_average
        self.momentum = momentum
        self.epsilon = epsilon
        self.axis_name = axis_name
        self.process_group = process_group
        self.channel_axis = channel_axis
        self.running_dtype = running_dtype
        self.fused_backward = fused_backward
        if affine:
            self.scale = nn.Parameter(torch.ones(
                num_features, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                num_features, dtype=param_dtype, device=dev))
        else:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)
        self.register_buffer("mean", torch.zeros(
            num_features, dtype=running_dtype, device=dev))
        self.register_buffer("var", torch.ones(
            num_features, dtype=running_dtype, device=dev))

    @staticmethod
    def check_sync(axis_name, process_group) -> None:
        """``axis_name`` must be None, ``"data"`` or a ``ProcessGroup``;
        ``process_group`` None, rank lists, or (with ``axis_name``) a
        ``ProcessGroup``."""
        if isinstance(axis_name, str) and axis_name != "data":
            raise ValueError(f"axis_name {axis_name!r}: the port knows the "
                             "default group \"data\" or a ProcessGroup")
        if process_group is not None and axis_name is None:
            raise ValueError("process_group needs an axis_name")

    def group(self):
        """``(torch.distributed group, ranks)`` the statistics are summed
        over (ranks None) or gathered within (this rank's group of the
        rank lists); None when local.  Raises ``RuntimeError`` naming
        ``initialize`` when no process group is formed."""
        if self.axis_name is None:
            return None
        from apex_tpu_torch.parallel.distributed import process_group
        pg = self.process_group
        if pg is None:
            return process_group(self.axis_name), None
        if isinstance(pg, (list, tuple)):
            process_group(self.axis_name)       # formed, and the default
            from apex_tpu_torch.parallel.groups import subgroup_of
            return subgroup_of(pg)
        return process_group(pg), None

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        use_ra = use_running_average
        if use_ra is None:
            use_ra = self.use_running_average
        if use_ra is None:
            use_ra = not self.training
        ch = self.channel_axis % x.dim()
        if x.shape[ch] != self.num_features:
            raise ValueError(f"SyncBatchNorm: {x.shape[ch]} channels, built "
                             f"for {self.num_features}")
        if use_ra:
            invstd = torch.rsqrt(self.var.float() + self.epsilon)
            return batchnorm_forward(x, self.mean.float(), invstd,
                                     self.scale, self.bias, ch)
        sync = self.group()
        if sync is not None and sync[1] is not None \
                and not self.fused_backward:
            raise ValueError(
                "fused_backward=False is unsupported with a BN "
                "process_group: the grouped gather of the statistics has "
                "no autograd rule here, as JAX's cannot be transposed "
                "under shard_map")
        reduce_axes = [a for a in range(x.dim()) if a != ch]
        # the fused backward differentiates through the stats itself
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.fused_backward):
            mean, var, count = local_mean_var(x, reduce_axes)
            if sync is not None:
                with torch.profiler.record_function("sync_bn_stats"):
                    mean, var, count = _synced_stats(
                        mean, var, count, sync,
                        differentiable=torch.is_grad_enabled())
            invstd = torch.rsqrt(var + self.epsilon)
        with torch.no_grad():
            m = self.momentum
            # the group's total count (a device scalar when synchronized)
            unbiased = var * count / (max(count - 1.0, 1.0)
                                      if sync is None
                                      else torch.clamp_min(count - 1.0, 1.0))
            self.mean.copy_(((1.0 - m) * self.mean.float() + m * mean)
                            .to(self.running_dtype))
            self.var.copy_(((1.0 - m) * self.var.float() + m * unbiased)
                           .to(self.running_dtype))
        if not self.fused_backward:
            return batchnorm_forward(x, mean, invstd, self.scale, self.bias,
                                     ch)
        return _bn_train_apply(ch, x, mean, invstd, self.scale, self.bias,
                               sync)


#: local BatchNorm is SyncBatchNorm without an ``axis_name``
BatchNorm = SyncBatchNorm
