"""Bottleneck ResNet backbone, NCHW (port of
`rrnet_tpu/models/backbones/resnet.py:17-57`, reference
backbones/resnet.py:56-143).

7x7/2 stem (msra init) + BN + ReLU + 3x3/2 max pool, then four bottleneck
stages; the forward returns the (l1, l2, l3, l4) pyramid (strides
4/8/16/32, channels 256/512/1024/2048). The JAX package computes the
stem by space-to-depth, a TPU layout choice over the same (7,7,C,F)
kernel; the plain strided conv here computes the same sums. Module names
follow the flax scopes (`conv1`, `bn1`, `layer{stage}_{block}`), so
`utils.from_flax` carries the JAX package's variables across.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from rrnet_torch.models.layers import BatchNorm, Bottleneck, Conv2d, max_pool


class ResNet(nn.Module):
    def __init__(self, layers: Tuple[int, int, int, int],
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, init="msra",
                            dtype=dtype)
        self.bn1 = BatchNorm(64)
        cin = 64
        self.out_channels = (256, 512, 1024, 2048)
        self.stages = []
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            names = []
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                self.add_module(name, Bottleneck(cin, planes, stride,
                                                 dtype=dtype))
                cin = planes * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor):
        x = max_pool(self.conv1(x, self.bn1, relu=True), 3, 2, 1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs)


def resnet10(dtype=torch.float32) -> ResNet:
    """Bottleneck [1, 1, 1, 1], the reference's tiny variant
    (backbones/resnet.py:110-119)."""
    return ResNet((1, 1, 1, 1), dtype=dtype)


def resnet50(dtype=torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), dtype=dtype)


def resnet101(dtype=torch.float32) -> ResNet:
    return ResNet((3, 4, 23, 3), dtype=dtype)
