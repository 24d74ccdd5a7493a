"""ResNet v1.5 (``apex_tpu/models/resnet.py``) and the pieces of
``examples/imagenet_main_amp.py`` around it: the synthetic batch, the
loss and top-k accuracy.

As in the JAX package: activations NHWC, kernels HWIO, the stride on the
bottleneck's 3x3 (v1.5), lax "SAME" padding (asymmetric at stride 2),
every BatchNorm a :class:`~apex_tpu_torch.parallel.SyncBatchNorm` with
momentum 0.1 and eps 1e-5, and submodules named as the flax tree
(``stem_conv``, ``stem_bn``, ``stage{s}_block{b}`` with ``conv1..3``,
``bn1..3``, ``downsample_conv``, ``downsample_bn``; ``fc``), so
:func:`apex_tpu_torch.convert.resnet_params_from_jax` copies name for
name.  Two stems: ``conv7`` (7x7/2 conv, 3x3/2 max-pool) and ``s2d`` (a
4x4 space-to-depth reshuffle and a 2x2 conv).  With
``APEX_TPU_FUSED_CONV1X1=1`` every 1x1 stride-1 conv (``conv1`` and
``conv3`` of each bottleneck, stage 0's ``downsample_conv``) takes K16
for its backward.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.ops import pad_nchw, pads_of
from apex_tpu_torch.layers import Conv, Dense
from apex_tpu_torch.ops import DeviceLike, resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm


def _bn(features, dev) -> SyncBatchNorm:
    return SyncBatchNorm(features, momentum=0.1, epsilon=1e-5, device=dev)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``max_pool(x, (w, w), (s, s), "SAME")`` on NHWC: pads of lax's
    "SAME" filled with -inf."""
    pads = pads_of(x.shape[1:3], (window, window), (stride, stride), "SAME")
    xc, sym = pad_nchw(x.permute(0, 3, 1, 2), pads, float("-inf"))
    return F.max_pool2d(xc, window, stride, sym).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x features), BN after each, and a
    projection where ``downsample``."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 downsample: bool = False, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        out = features * 4
        self.conv1 = Conv(in_features, features, 1, device=dev)
        self.bn1 = _bn(features, dev)
        self.conv2 = Conv(features, features, 3, strides=strides,
                          device=dev)
        self.bn2 = _bn(features, dev)
        self.conv3 = Conv(features, out, 1, device=dev)
        self.bn3 = _bn(out, dev)
        if downsample:
            self.downsample_conv = Conv(in_features, out, 1,
                                        strides=strides, device=dev)
            self.downsample_bn = _bn(out, dev)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        ra = not train
        y = F.relu(self.bn1(self.conv1(x), ra))
        y = F.relu(self.bn2(self.conv2(y), ra))
        y = self.bn3(self.conv3(y), ra)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), ra)
        return F.relu(y + residual.to(y.dtype))


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3, BN after each (ResNet-18/34); no expansion."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 downsample: bool = False, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        self.conv1 = Conv(in_features, features, 3, strides=strides,
                          device=dev)
        self.bn1 = _bn(features, dev)
        self.conv2 = Conv(features, features, 3, device=dev)
        self.bn2 = _bn(features, dev)
        if downsample:
            self.downsample_conv = Conv(in_features, features, 1,
                                        strides=strides, device=dev)
            self.downsample_bn = _bn(features, dev)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        ra = not train
        y = F.relu(self.bn1(self.conv1(x), ra))
        y = self.bn2(self.conv2(y), ra)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), ra)
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """ResNet v1.5; ``stage_sizes=(3, 4, 6, 3)`` with :class:`Bottleneck`
    is ResNet-50.  ``forward(x, train=None)`` takes NHWC RGB images
    (``train`` None: ``self.training``) and returns ``(B, num_classes)``
    logits.  BatchNorm runs at world size one (no ``bn_axis_name``).
    ``stem="s2d"`` needs spatial dims divisible by 4.  Built on the card
    unless ``device`` says otherwise (``"meta"``: shapes only)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64,
                 block_cls=Bottleneck, stem: str = "conv7",
                 device: DeviceLike = None):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        dev = resolve_device(device, allow_meta=True)
        self.stage_sizes = tuple(stage_sizes)
        self.stem = stem
        if stem == "s2d":
            self.stem_conv = Conv(16 * 3, width, 2, device=dev)
        else:
            self.stem_conv = Conv(3, width, 7, strides=2, device=dev)
        self.stem_bn = _bn(width, dev)
        self.block_names: List[str] = []
        feats = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                # expanding blocks project even at stage 0's first block;
                # expansion-1 blocks only where the shape changes
                downsample = block == 0 and (
                    stage > 0 or block_cls.expansion != 1)
                name = f"stage{stage}_block{block}"
                base = width * 2 ** stage
                self.add_module(name, block_cls(feats, base, strides,
                                                downsample, device=dev))
                self.block_names.append(name)
                feats = base * block_cls.expansion
        self.fc = Dense(feats, num_classes, init_std=0.01, device=dev)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        if self.stem == "s2d":
            b, h, w, c = x.shape
            if h % 4 or w % 4:
                raise ValueError(f"stem='s2d' needs spatial dims divisible "
                                 f"by 4, got {(h, w)}")
            x = x.reshape(b, h // 4, 4, w // 4, 4, c) \
                .permute(0, 1, 3, 2, 4, 5).reshape(b, h // 4, w // 4, 16 * c)
        y = F.relu(self.stem_bn(self.stem_conv(x), not train))
        if self.stem == "conv7":
            y = max_pool_same(y, 3, 2)
        for name in self.block_names:
            y = getattr(self, name)(y, train)
        return self.fc(y.mean(dim=(1, 2)))


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), **kw)


def ResNet18(**kw) -> ResNet:
    kw.setdefault("block_cls", BasicBlock)
    return ResNet(stage_sizes=(2, 2, 2, 2), **kw)


def ResNet34(**kw) -> ResNet:
    kw.setdefault("block_cls", BasicBlock)
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def ResNet50S2D(**kw) -> ResNet:
    kw.setdefault("stem", "s2d")
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


#: ``--arch`` -> constructor, as ``examples/imagenet_main_amp.py``'s
ARCHS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
         "resnet101": ResNet101, "resnet152": ResNet152,
         "resnet50_s2d": ResNet50S2D}


def synthetic_batch(gen: torch.Generator, batch: int, size: int,
                    device: DeviceLike = None, num_classes: int = 1000
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The example's synthetic stream: ``(batch, size, size, 3)`` normal
    fp32 images and int64 labels in ``[0, num_classes)``, drawn from
    ``gen`` (a generator on ``device``, the card by default)."""
    dev = resolve_device(device)
    x = torch.randn((batch, size, size, 3), generator=gen, device=dev)
    y = torch.randint(0, num_classes, (batch,), generator=gen, device=dev)
    return x, y


def resnet_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The example's loss: mean NLL of ``log_softmax`` in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, target: torch.Tensor,
             topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """precision@k in percent for each k of ``topk`` (device scalars)."""
    pred = logits.topk(max(topk), dim=1).indices
    correct = pred == target.long()[:, None]
    return [100.0 * correct[:, :k].sum().float() / target.shape[0]
            for k in topk]
