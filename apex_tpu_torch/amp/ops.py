"""The conv route of ``apex_tpu/amp/ops.py``: :func:`conv_general_dilated`.

Every :class:`~apex_tpu_torch.layers.Conv` calls it.  Activations stay
NHWC and kernels HWIO, as in the JAX package; the library conv sees them
as ``x.permute(0, 3, 1, 2)`` (on a contiguous NHWC tensor that view is
channels-last, so nothing is copied) and ``kernel.permute(3, 2, 0, 1)``.
lax's padding (``"SAME"``, ``"VALID"``, explicit pairs) becomes explicit,
possibly asymmetric pads (:func:`pads_of`, lax's ``padtype_to_pads``):
the symmetric ones ride the conv, the others an ``F.pad`` before it.
With ``APEX_TPU_FUSED_CONV1X1=1`` each eligible 1x1 stride-1 conv goes
to :func:`apex_tpu_torch.ops.cuda.conv1x1.conv1x1` (its backward is K16).

Not ported yet: the rest of the module, the O1 cast-ops context
(``half_function`` and the policy-cast op namespace) with the
transposed conv it also wraps; both come with amp O1 (ROADMAP.md Queue 1
#3).  Under O0/O2/O3 a conv simply runs in its operands' dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops.cuda import conv1x1 as c1

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
Padding = Union[str, Sequence[Tuple[int, int]]]


def pads_of(in_hw: Sequence[int], window: Sequence[int],
            strides: Sequence[int], padding: Padding,
            dilation: Sequence[int] = (1, 1)) -> Pads:
    """``((top, bottom), (left, right))`` pads of a 2-d window, as lax's
    ``padtype_to_pads``: ``"SAME"`` gives ``ceil(in / stride)`` outputs,
    the odd pixel at the end (the 7x7/2 stem at 224 pads (2, 3), a 3x3/2
    window at 112 (0, 1)); ``"VALID"`` none; explicit pairs as given."""
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0), (0, 0))
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for n, k, s, d in zip(in_hw, window, strides, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if len(pads) != 2:
        raise ValueError(f"want two (lo, hi) pairs, got {padding!r}")
    return pads


def pad_nchw(x: torch.Tensor, pads: Pads, value: float = 0.0
             ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``(x', sym)``: an NCHW view ``x`` and the symmetric padding a conv
    or pool takes for ``pads``; asymmetric pads are applied here instead
    (``F.pad`` keeps the channels-last layout) and ``sym`` is zero."""
    (t, b), (l, r) = pads
    if t == b and l == r and t >= 0 and l >= 0:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def conv_general_dilated(x: torch.Tensor, kernel: torch.Tensor,
                         window_strides: Sequence[int], padding: Padding,
                         lhs_dilation: Optional[Sequence[int]] = None,
                         rhs_dilation: Optional[Sequence[int]] = None,
                         dimension_numbers=None,
                         feature_group_count: int = 1,
                         batch_group_count: int = 1, precision=None,
                         preferred_element_type=None,
                         **kwargs) -> torch.Tensor:
    """lax's positional signature, for NHWC / HWIO / NHWC operands.
    Routes eligible 1x1 stride-1 convs to the fused-backward kernel when
    switched on (:mod:`apex_tpu_torch.ops.cuda.conv1x1`); the rest run
    through ``F.conv2d``.  Transposed convs (``lhs_dilation``), batch
    groups, ``precision`` and ``preferred_element_type`` are not ported
    and raise."""
    extras = dict(kwargs)
    if feature_group_count != 1:
        extras["feature_group_count"] = feature_group_count
    if batch_group_count != 1:
        extras["batch_group_count"] = batch_group_count
    if precision is not None:
        extras["precision"] = precision
    if preferred_element_type is not None:
        extras["preferred_element_type"] = preferred_element_type
    if (lhs_dilation is None and rhs_dilation is None
            and c1.routeable(x, kernel, window_strides, padding,
                             dimension_numbers, extras)):
        return c1.conv1x1(x, kernel)
    if dimension_numbers is None or tuple(dimension_numbers) != c1.DN:
        raise NotImplementedError(
            f"conv_general_dilated: only {c1.DN} operands are ported, got "
            f"{dimension_numbers!r}")
    unported = set(extras) - {"feature_group_count"}
    if lhs_dilation is not None and tuple(lhs_dilation) != (1, 1):
        unported.add("lhs_dilation")
    if unported:
        raise NotImplementedError(
            f"conv_general_dilated: {sorted(unported)} not ported (the "
            "transposed conv comes with amp O1)")
    dil = tuple(rhs_dilation) if rhs_dilation is not None else (1, 1)
    strides = tuple(window_strides)
    pads = pads_of(x.shape[1:3], kernel.shape[:2], strides, padding, dil)
    xc, sym = pad_nchw(x.permute(0, 3, 1, 2), pads)
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), None, strides, sym, dil,
                 feature_group_count)
    return y.permute(0, 2, 3, 1)
