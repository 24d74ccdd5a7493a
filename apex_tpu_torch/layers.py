"""Building-block layers with flax's parameter names and layouts.

:class:`Dense` stores its kernel ``(in, out)`` and :class:`Conv` its
kernel HWIO ``(kh, kw, in, out)``, exactly as flax stores them, so the
converter copies weights across without a transpose (and K16 reads a
1x1 kernel as its ``(in, out)`` view).  The layers call the policy-aware
op layer (:mod:`apex_tpu_torch.amp.ops`), as the JAX package's do: under
amp O1 their products run in the half dtype, and otherwise they follow
their parameters' dtype.  Convolutions run on NHWC activations through
:func:`~apex_tpu_torch.amp.ops.conv_general_dilated` and
:func:`~apex_tpu_torch.amp.ops.conv_transpose`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.amp import ops as amp_ops


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel (in, out)``, drawn from a
    normal of std ``init_std`` (``in ** -0.5`` by default)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None, init_std: Optional[float] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(
            (in_features, out_features), dtype=dtype, device=device))
        nn.init.normal_(self.kernel, std=in_features ** -0.5
                        if init_std is None else init_std)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                out_features, dtype=dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return amp_ops.linear(x, self.kernel, self.bias)


class Conv(nn.Module):
    """NHWC convolution with the HWIO ``kernel (kh, kw, in, features)``,
    drawn as flax's ``variance_scaling(2.0, "fan_out", "normal")`` (std
    ``sqrt(2 / (kh * kw * features))``), and an optional ``bias``.
    ``padding``: ``"SAME"`` (lax's, asymmetric at stride 2), ``"VALID"``,
    an int, or explicit ``(lo, hi)`` pairs."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[str, int, Sequence[Tuple[int, int]]]
                 = "SAME", use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = ([(padding, padding)] * 2
                        if isinstance(padding, int) else padding)
        self.kernel = nn.Parameter(torch.empty(
            (kh, kw, in_features, features), dtype=dtype, device=device))
        nn.init.normal_(self.kernel, std=(2.0 / (kh * kw * features)) ** 0.5)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                features, dtype=dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = amp_ops.conv_general_dilated(
            x, self.kernel, self.strides, self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ConvTranspose(nn.Module):
    """NHWC transposed convolution (lax's ``conv_transpose``: the conv of
    the input spread by ``strides``) with the HWIO ``kernel (kh, kw, in,
    features)``, drawn as flax's ``variance_scaling(1.0, "fan_in",
    "normal")`` (std ``sqrt(1 / (kh * kw * in))``), and an optional
    ``bias``.  ``"SAME"`` padding gives ``in * strides`` outputs."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 4,
                 strides: Union[int, Tuple[int, int]] = 2,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.kernel = nn.Parameter(torch.empty(
            (kh, kw, in_features, features), dtype=dtype, device=device))
        nn.init.normal_(self.kernel, std=(1.0 / (kh * kw * in_features))
                        ** 0.5)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                features, dtype=dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = amp_ops.conv_transpose(
            x, self.kernel, self.strides, self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Embed(nn.Module):
    """Token embedding with flax's parameter name ``embedding``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(
            (num_embeddings, features), dtype=dtype, device=device))
        nn.init.normal_(self.embedding, std=1.0)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]
