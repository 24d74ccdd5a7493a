"""The MNIST-scale MLP of BASELINE config 1 (``examples/simple``, amp O1),
as ``apex_tpu/models/mlp.py``, and the synthetic stream of
``examples/mnist_amp.py``.

The layers are :class:`AmpDense` (the op layer's ``linear``, so under O1
their products run in bf16), named as flax names them (``AmpDense_0``,
...), so :func:`~apex_tpu_torch.convert.mlp_params_from_jax` copies a JAX
tree across by name.  :func:`cross_entropy_loss` is the JAX package's:
``log_softmax`` through the op layer (fp32 under O1), then the mean
one-hot NLL.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.layers import Dense
from apex_tpu_torch.ops import DeviceLike, resolve_device


class AmpDense(Dense):
    """A :class:`~apex_tpu_torch.layers.Dense` (its product goes through
    the op layer's policy-cast ``linear``), named as the JAX module."""


class MLP(nn.Module):
    """ReLU MLP classifier: ``forward(x (B, ...))`` flattens ``x`` to
    ``(B, in_features)`` and returns logits ``(B, num_classes)``.  Built
    on the card unless ``device`` says ``"cpu"`` (or ``"meta"``)."""

    def __init__(self, features: Sequence[int] = (256, 256),
                 num_classes: int = 10, in_features: int = 784,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        dims = (in_features,) + tuple(features) + (num_classes,)
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            setattr(self, f"AmpDense_{i}", AmpDense(
                dims[i], dims[i + 1], dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = getattr(self, f"AmpDense_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy, the log-softmax through the op layer
    (fp32 under O1)."""
    logp = amp_ops.log_softmax(logits, axis=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -(onehot * logp).sum(dim=-1).mean()


def synthetic_mnist(gen: torch.Generator, n: int, batch: int,
                    device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` batches of MNIST-shaped data, as ``examples/mnist_amp.py``
    makes them: labels uniform over 10 classes, images ``centers[label]
    + 0.3 * noise`` with class centers ``0.5 * normal`` (784 features),
    drawn from ``gen`` on the CPU; ``(x (n, batch, 784), y (n, batch))``
    on ``device``."""
    device = resolve_device(device)
    y = torch.randint(0, 10, (n, batch), generator=gen)
    centers = torch.randn((10, 784), generator=gen) * 0.5
    x = centers[y] + 0.3 * torch.randn((n, batch, 784), generator=gen)
    return x.to(device), y.to(device)
