"""The DCGAN of BASELINE config 5 (two optimizers, one dynamic loss scaler
each, amp O1), as ``apex_tpu/models/dcgan.py``, and the iteration of
``examples/dcgan_main_amp.py``.

:class:`Generator` and :class:`Discriminator` are NHWC, named as flax
names them (``project``, ``bn_in``, ``up{i}``, ``bn{i}``, ``to_rgb``;
``down{i}``, ``bn{i}``, ``logit``), with the port's
:class:`~apex_tpu_torch.parallel.SyncBatchNorm` at world size one (its
parameters stay fp32 under O1, and its running stats are buffers).
:func:`gan_losses` is the with-logits BCE in fp32.  :func:`dcgan_step` is
one iteration of the example: a discriminator step on real images and a
stats-frozen, gradient-free fake, then a generator step, each through its
own :class:`~apex_tpu_torch.amp.Amp`, so an overflow in one network's
backward halves only its scale and skips only its step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.layers import Conv, ConvTranspose, Dense
from apex_tpu_torch.ops import DeviceLike, resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm


class Generator(nn.Module):
    """``z (B, zdim)`` to images ``(B, S, S, channels)`` in [-1, 1], ``S =
    8 * 2 ** n_upsample``: a projection to 4 x 4 x ``feature_maps * 2 **
    n_upsample``, then ``n_upsample`` 4x4/2 transposed convs halving the
    features, each with BatchNorm and ReLU, and a 4x4/2 transposed conv to
    RGB with tanh."""

    def __init__(self, feature_maps: int = 64, channels: int = 3,
                 n_upsample: int = 2, zdim: int = 100,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        f = feature_maps * 2 ** n_upsample
        self.f0, self.n_upsample = f, n_upsample
        self.project = Dense(zdim, 16 * f, dtype=dtype, device=dev)
        self.bn_in = SyncBatchNorm(f, device=dev)
        for i in range(n_upsample):
            setattr(self, f"up{i}", ConvTranspose(f, f // 2, 4, 2,
                                                  dtype=dtype, device=dev))
            setattr(self, f"bn{i}", SyncBatchNorm(f // 2, device=dev))
            f //= 2
        self.to_rgb = ConvTranspose(f, channels, 4, 2, dtype=dtype,
                                    device=dev)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.project(z).reshape(z.shape[0], 4, 4, self.f0)
        x = torch.relu(self.bn_in(x, use_running_average=not train))
        for i in range(self.n_upsample):
            x = getattr(self, f"up{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(
                x, use_running_average=not train))
        return torch.tanh(self.to_rgb(x))


class Discriminator(nn.Module):
    """Images ``(B, S, S, channels)`` to one logit each: ``n_down`` 4x4/2
    convs with bias doubling the features from ``feature_maps``,
    BatchNorm after all but the first, leaky ReLU (0.2), then a dense
    logit over the flattened ``S / 2 ** n_down`` square."""

    def __init__(self, feature_maps: int = 64, n_down: int = 3,
                 channels: int = 3, image_size: int = 32,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        self.n_down = n_down
        c, f = channels, feature_maps
        for i in range(n_down):
            setattr(self, f"down{i}", Conv(c, f, 4, 2, use_bias=True,
                                           dtype=dtype, device=dev))
            if i > 0:
                setattr(self, f"bn{i}", SyncBatchNorm(f, device=dev))
            c, f = f, f * 2
        side = image_size // 2 ** n_down
        self.logit = Dense(side * side * c, 1, dtype=dtype, device=dev)

    def forward(self, img: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = img
        for i in range(self.n_down):
            x = getattr(self, f"down{i}")(x)
            if i > 0:
                x = getattr(self, f"bn{i}")(x, use_running_average=not train)
            x = F.leaky_relu(x, 0.2)
        return self.logit(x.reshape(x.shape[0], -1))


def gan_losses(d_real_logits: torch.Tensor, d_fake_logits: torch.Tensor,
               g_fake_logits: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_loss, g_loss)``: the non-saturating losses as fp32
    with-logits BCE, ``max(x, 0) - x * t + log1p(exp(-|x|))``."""
    def bce_logits(logits, target):
        x = logits.float()
        return (torch.clamp_min(x, 0) - x * target
                + torch.log1p(torch.exp(-x.abs()))).mean()

    d_loss = bce_logits(d_real_logits, 1.0) + bce_logits(d_fake_logits, 0.0)
    return d_loss, bce_logits(g_fake_logits, 1.0)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Train-mode forwards of ``module`` inside the block normalize with
    batch statistics but leave its running stats as they were (the JAX
    loop's forward whose updated ``batch_stats`` it drops)."""
    saved = [(b, b.detach().clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def d_loss(D: Discriminator, G: Generator, z: torch.Tensor,
           real: torch.Tensor) -> torch.Tensor:
    """The discriminator's loss: D on the real batch, then on G's fake
    (no gradient to G, G's running stats untouched)."""
    with torch.no_grad(), frozen_stats(G):
        fake = G(z, train=True)
    d_real = D(real, train=True)
    d_fake = D(fake, train=True)
    return gan_losses(d_real, d_fake, d_fake)[0]


def g_loss(G: Generator, D: Discriminator, z: torch.Tensor) -> torch.Tensor:
    """The generator's loss through D on G's fake (both networks' running
    stats move)."""
    logits = D(G(z, train=True), train=True)
    return gan_losses(logits, logits, logits)[1]


def dcgan_step(a_g, a_d, z: torch.Tensor, real: torch.Tensor,
               d_loss_fn: Callable = d_loss,
               g_loss_fn: Callable = g_loss) -> Dict[str, Dict]:
    """One iteration of ``examples/dcgan_main_amp.py``: the D step (its
    loss scaled by ``a_d``'s scaler, its gradients applied by ``a_d``),
    then the G step through ``a_g``.  ``a_g`` / ``a_d`` are the
    :class:`~apex_tpu_torch.amp.Amp` of the generator / discriminator.
    Returns ``{"d": info, "g": info}``, each with ``loss`` and
    :meth:`Amp.apply_gradients`' device tensors; nothing is read back to
    the host."""
    G, D = a_g.model, a_d.model
    with torch.enable_grad():
        dl = a_d.run(d_loss_fn, D, G, z, real)
        d_grads = torch.autograd.grad(a_d.scale_loss(dl), a_d.params)
    d_info = a_d.apply_gradients(d_grads)
    del d_grads
    with torch.enable_grad():
        gl = a_g.run(g_loss_fn, G, D, z)
        g_grads = torch.autograd.grad(a_g.scale_loss(gl), a_g.params)
    g_info = a_g.apply_gradients(g_grads)
    return {"d": {"loss": dl.detach(), **d_info},
            "g": {"loss": gl.detach(), **g_info}}


def synthetic_gan_batch(gen: torch.Generator, batch: int, zdim: int = 100,
                        image_size: int = 32, device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(z (batch, zdim), real (batch, S, S, 3))`` as the example draws
    them: standard normal noise and ``tanh`` of normal "images", from
    ``gen`` on the CPU, moved to ``device``."""
    device = resolve_device(device)
    z = torch.randn((batch, zdim), generator=gen)
    real = torch.tanh(torch.randn((batch, image_size, image_size, 3),
                                  generator=gen))
    return z.to(device), real.to(device)
