"""Building-block layers with flax's parameter names and layouts.

:class:`Dense` stores its kernel ``(in, out)``, exactly as flax stores
it, so ``x @ kernel + bias`` is the JAX package's expression and the
converter copies weights across without a transpose.
"""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel (in, out)``."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(
            (in_features, out_features), dtype=dtype, device=device))
        nn.init.normal_(self.kernel, std=in_features ** -0.5)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                out_features, dtype=dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
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
