"""ResNet backbone family with multi-scale endpoints.

Counterpart of ``deepphysinet_tpu/models/backbone.py``: ResNet-18/34/50/101/152
with the reference's ``out_keys`` endpoint selection ('C1'..'C5'), registered in
``BACKBONES``.  The shipped model never calls it (reference
model/backbone/resnet.py:106-209, SURVEY Q6).

The interface is JAX's: inputs and endpoints are NHWC, and ``train`` is an
argument of the call (default False: the running statistics).  Inside, an NHWC
tensor is read as an NCHW view in channels-last memory, so no copy is made.
The arithmetic is flax's where PyTorch's defaults differ:

* ``BatchNorm`` normalises a training batch by its biased variance, E[x^2] - E[x]^2
  in float32 clipped at 0, and moves the running mean and the running variance
  (that same biased variance) with momentum 0.99 and eps 1e-5 (flax's
  ``BatchNorm``), where ``torch.nn.BatchNorm2d`` keeps the unbiased variance;
* max pooling pads with -inf, as ``F.max_pool2d`` does;
* a 1x1 convolution has no padding (flax's 'SAME' pads a 1x1 kernel by 0 at
  strides 1 and 2), the others pad by half the kernel.

Module names follow torchvision (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``); ``train/torch_import.py::resnet_state_dict_from_jax``
maps flax's ``Conv_i`` / ``BatchNorm_i`` / ``BasicBlock_i`` names onto them.
Parameters start from PyTorch's default initialisation; flax's differs, and the
tests carry weights over from JAX.  The convolutions are PyTorch's (cuDNN on the
card), as JAX computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepphysinet_tpu_torch.registry import BACKBONES

BN_MOMENTUM = 0.99  # flax's: the share of the running value that stays
BN_EPS = 1e-5


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d``'s parameters and buffers with flax ``BatchNorm``'s arithmetic, on
    NCHW input; ``train`` picks the batch's statistics (and updates the running ones)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:  # type: ignore[override]
        shape = (1, -1, 1, 1)
        if train:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def _conv(c_in: int, c_out: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, kernel, stride, padding=kernel // 2, bias=False)


class _Downsample(nn.Module):
    """The residual's 1x1 convolution and norm (``downsample.0`` / ``downsample.1``)."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.add_module("0", _conv(c_in, c_out, 1, stride))
        self.add_module("1", BatchNorm(c_out))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return getattr(self, "1")(getattr(self, "0")(x), train)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions; NHWC in and out."""

    expansion = 1

    def __init__(self, c_in: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = _conv(c_in, features, 3, strides)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        # flax adds the projection where the residual's shape differs from the output's
        self.downsample = (_Downsample(c_in, features, strides)
                           if strides != 1 or c_in != features else None)

    def forward_nchw(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x if self.downsample is None else self.downsample(x, train)
        return F.relu(y + residual)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _nhwc(self.forward_nchw(_nchw(x), train))


class Bottleneck(nn.Module):
    """1x1, 3x3 (strided), 1x1 to four times the width; NHWC in and out."""

    expansion = 4

    def __init__(self, c_in: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = _conv(c_in, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, strides)
        self.bn2 = BatchNorm(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = BatchNorm(features * 4)
        self.downsample = (_Downsample(c_in, features * 4, strides)
                           if strides != 1 or c_in != features * 4 else None)

    def forward_nchw(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x if self.downsample is None else self.downsample(x, train)
        return F.relu(y + residual)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _nhwc(self.forward_nchw(_nchw(x), train))


class ResNet(nn.Module):
    """Multi-endpoint ResNet: ``forward(x [B, H, W, in_channels], train=False)`` -> a dict of
    the ``out_keys`` among C1..C5, each NHWC.  ``in_channels`` is the input's width, which
    flax reads from the first call."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BasicBlock,
                 out_keys: Tuple[str, ...] = ("C5",), in_channels: int = 3):
        super().__init__()
        self.out_keys = tuple(out_keys)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        c_in = 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2**stage
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(c_in, features, 2 if (b == 0 and stage > 0) else 1))
                c_in = features * block.expansion
            self.add_module(f"layer{stage + 1}", nn.ModuleList(blocks))
        self.n_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor, train: bool = False) -> dict:
        endpoints = {}
        y = F.relu(self.bn1(self.conv1(_nchw(x)), train))
        endpoints["C1"] = y
        y = F.max_pool2d(y, 3, 2, padding=1)
        for stage in range(self.n_stages):
            for blk in getattr(self, f"layer{stage + 1}"):
                y = blk.forward_nchw(y, train)
            endpoints[f"C{stage + 2}"] = y
        return {k: _nhwc(endpoints[k]) for k in self.out_keys}


@BACKBONES.register("resnet18")
def resnet18(out_keys=("C5",), in_channels: int = 3, **_):
    return ResNet([2, 2, 2, 2], BasicBlock, tuple(out_keys), in_channels)


@BACKBONES.register("resnet34")
def resnet34(out_keys=("C5",), in_channels: int = 3, **_):
    return ResNet([3, 4, 6, 3], BasicBlock, tuple(out_keys), in_channels)


@BACKBONES.register("resnet50")
def resnet50(out_keys=("C5",), in_channels: int = 3, **_):
    return ResNet([3, 4, 6, 3], Bottleneck, tuple(out_keys), in_channels)


@BACKBONES.register("resnet101")
def resnet101(out_keys=("C5",), in_channels: int = 3, **_):
    return ResNet([3, 4, 23, 3], Bottleneck, tuple(out_keys), in_channels)


@BACKBONES.register("resnet152")
def resnet152(out_keys=("C5",), in_channels: int = 3, **_):
    return ResNet([3, 8, 36, 3], Bottleneck, tuple(out_keys), in_channels)


def build_backbone(name: str = "resnet50", **kwargs):
    """model/backbone/builder.py:5-12 equivalent."""
    return BACKBONES.build(name, **kwargs)
