"""BatchNorm with the JAX package's numerics
(``apex_tpu/parallel/sync_batchnorm.py``), at world size one.

- Statistics: the one-pass fp32 pair ``E[x^2] - E[x]^2`` over every axis
  but the channel one (:func:`local_mean_var`), clamped at 0, whatever the
  input dtype.
- Normalize in fp32, cast back to the input dtype
  (:func:`batchnorm_forward`).
- Backward: the reference's hand-written two-stage split, ``reduce_bn ->
  batchnorm_backward``, as a ``torch.autograd.Function``
  (:func:`_bn_train_apply`) that saves only the input at its own dtype and
  per-channel fp32 vectors; the cotangents of the batch mean and invstd
  are zero, their dependence on x folded into ``grad_input``.
  ``fused_backward=False`` differentiates the stats graph instead (the
  same total derivative).
- Running stats: momentum 0.1 (``new = (1 - m) * old + m * batch``), the
  unbiased ``n / (n - 1)`` variance, in ``running_dtype``.

No ``F.batch_norm``: cuDNN's statistics and rounding are not the JAX
package's.  Unlike the fork's Python path, the module returns its output
(SURVEY.md section 0.2).  Synchronizing over processes (``axis_name``,
``process_group``) is not ported yet and raises.
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


class _BNTrainApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, invstd, weight, bias, channel_axis):
        ctx.channel_axis = channel_axis
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
        gi = batchnorm_backward(dy, x, mean, invstd, weight, mean_dy,
                                mean_dy_xmu, ch)
        return (gi, None, None,
                None if weight is None else gw.to(weight.dtype),
                None if ctx.bias_dtype is None else gb.to(ctx.bias_dtype),
                None)


def _bn_train_apply(channel_axis: int, x: torch.Tensor, mean: torch.Tensor,
                    invstd: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Normalize with (detached) batch statistics; the backward is the
    total derivative through them, ``reduce_bn -> batchnorm_backward``."""
    return _BNTrainApply.apply(x, mean.detach(), invstd.detach(), weight,
                               bias, channel_axis)


class SyncBatchNorm(nn.Module):
    """BatchNorm over every axis but ``channel_axis`` (-1: NHWC), with
    parameters ``scale`` / ``bias`` (``param_dtype``) and buffers ``mean``
    / ``var`` (``running_dtype``), flax's names.

    ``use_running_average`` (here or per call; by default ``not
    self.training``) normalizes with the running stats; otherwise with the
    batch's, updating the running stats.  ``fused_backward=False`` takes
    plain autograd through the stats graph.  ``axis_name`` /
    ``process_group`` (synchronizing over processes) raise
    ``NotImplementedError`` until ROADMAP.md Queue 1 #4 ports them."""

    def __init__(self, num_features: int,
                 use_running_average: Optional[bool] = None,
                 momentum: float = 0.1, epsilon: float = 1e-5,
                 affine: bool = True, axis_name: Optional[str] = None,
                 process_group=None, channel_axis: int = -1,
                 param_dtype: torch.dtype = torch.float32,
                 running_dtype: torch.dtype = torch.float32,
                 fused_backward: bool = True, device: DeviceLike = None):
        super().__init__()
        if axis_name is not None or process_group is not None:
            raise NotImplementedError(
                "SyncBatchNorm across processes (axis_name / "
                "process_group) is not ported yet (ROADMAP.md Queue 1 #4); "
                "world size one only")
        dev = resolve_device(device, allow_meta=True)
        self.num_features = num_features
        self.use_running_average = use_running_average
        self.momentum = momentum
        self.epsilon = epsilon
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
        reduce_axes = [a for a in range(x.dim()) if a != ch]
        # the fused backward differentiates through the stats itself
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.fused_backward):
            mean, var, count = local_mean_var(x, reduce_axes)
            invstd = torch.rsqrt(var + self.epsilon)
        with torch.no_grad():
            m = self.momentum
            unbiased = var * count / max(count - 1.0, 1.0)
            self.mean.copy_(((1.0 - m) * self.mean.float() + m * mean)
                            .to(self.running_dtype))
            self.var.copy_(((1.0 - m) * self.var.float() + m * unbiased)
                           .to(self.running_dtype))
        if not self.fused_backward:
            return batchnorm_forward(x, mean, invstd, self.scale, self.bias,
                                     ch)
        return _bn_train_apply(ch, x, mean, invstd, self.scale, self.bias)


#: local BatchNorm is SyncBatchNorm at world size one
BatchNorm = SyncBatchNorm
