"""TridentNet (ResNet-v2) backbone, NCHW (port of
`rrnet_tpu/models/backbones/trident.py`).

A pre-activation bottleneck ResNet whose third stage is a 3-branch
trident: one shared weight applied at dilations (1, 2, 3), one branch
each, the branches concatenated on the batch axis at the stage output,
so l3 and l4 have 3x the batch. With `deform=True` the shared 3x3 is a
modulated deformable conv (`ops.deform_conv`, CUDA kernels on the card)
with a per-branch offset/mask conv.

Module and parameter names follow the flax scopes (`layer3_1.bn1_0`,
`layer3_1.conv2.offset_mask2`, ...) so `utils.from_flax` carries the
JAX package's variables across. BatchNorm follows the module's mode
(`.train()` / `.eval()`), as `models.layers.BatchNorm` does.

The trident runs in f32 only: the JAX package's `SharedConv` applies its
f32 weight uncast, so bf16 activations fail there, and the port raises
for them at construction.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rrnet_torch.models.layers import (BatchNorm, Conv2d, conv2d, max_pool,
                                       msra_init_)
from rrnet_torch.ops.deform_conv import deform_conv2d


class SharedConv(nn.Module):
    """One (features, cin, k, k) weight applied to each branch at its
    dilation, padding = dilation for 3x3 and 0 for 1x1. Deformable: a
    per-branch `offset_mask{i}` conv (with bias, zero init, padding =
    dilation = d) gives 2*G*k*k offsets and G*k*k mask logits."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, dilations: Sequence[int] = (1, 2, 3),
                 deform: bool = False, deformable_groups: int = 4):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.dilations = tuple(dilations)
        self.deform = deform
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        if deform:
            n = deformable_groups * 3 * kernel * kernel
            for i, d in enumerate(self.dilations):
                self.add_module(f"offset_mask{i}", Conv2d(
                    cin, n, kernel, stride, d, bias=True, init="zeros",
                    dilation=d, quantizable=False))

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        features = self.weight.shape[0]
        msra_init_(self.weight, self.kernel * self.kernel * features,
                   generator)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if not self.deform:
            return [conv2d(x, self.weight, None, self.stride,
                           d if self.kernel == 3 else 0, d)
                    for x, d in zip(xs, self.dilations)]
        n_off = self.deformable_groups * 2 * self.kernel * self.kernel
        outs = []
        for i, (x, d) in enumerate(zip(xs, self.dilations)):
            om = getattr(self, f"offset_mask{i}")(x)
            # the CUDA kernels take NCHW tensors; in eval the maps come out
            # channels-last from the cached weights (`Conv2d.eval_weights`)
            offset = om[:, :n_off].contiguous()
            mask = torch.sigmoid(om[:, n_off:]).contiguous()
            outs.append(deform_conv2d(
                x.contiguous(), self.weight, offset, mask, stride=self.stride,
                padding=d, dilation=d,
                deformable_groups=self.deformable_groups))
        return outs


class TridentUnit(nn.Module):
    """Pre-activation trident bottleneck: per-branch BN + ReLU, shared
    1x1 / (deformable) 3x3 / 1x1, residual (a shared strided 1x1 when
    stride is 2)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 deform: bool = False):
        super().__init__()
        mid = features // 4
        for i in range(3):
            self.add_module(f"bn1_{i}", BatchNorm(cin))
        self.conv1 = SharedConv(cin, mid, kernel=1, dilations=(1, 1, 1))
        for i in range(3):
            self.add_module(f"bn2_{i}", BatchNorm(mid))
        self.conv2 = SharedConv(mid, mid, kernel=3, stride=stride,
                                deform=deform)
        for i in range(3):
            self.add_module(f"bn3_{i}", BatchNorm(mid))
        self.conv3 = SharedConv(mid, features, kernel=1, dilations=(1, 1, 1))
        self.downsample = (SharedConv(cin, features, kernel=1, stride=2,
                                      dilations=(1, 1, 1))
                           if stride == 2 else None)

    def _bn_relu(self, name: str, xs):
        return [F.relu(getattr(self, f"{name}_{i}")(x))
                for i, x in enumerate(xs)]

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        residual = xs
        xs = self.conv1(self._bn_relu("bn1", xs))
        xs = self.conv2(self._bn_relu("bn2", xs))
        xs = self.conv3(self._bn_relu("bn3", xs))
        if self.downsample is not None:
            residual = self.downsample(residual)
        return [x + r for x, r in zip(xs, residual)]


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck; the residual is `down_bn(down_conv(x))`
    of the raw input when `downsample`."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        mid = features // 4
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv2d(cin, mid, 1, bias=False, init="msra",
                            quantizable=False)
        self.bn2 = BatchNorm(mid)
        self.conv2 = Conv2d(mid, mid, 3, stride, 1, bias=False, init="msra",
                            quantizable=False)
        self.bn3 = BatchNorm(mid)
        self.conv3 = Conv2d(mid, features, 1, bias=False, init="msra",
                            quantizable=False)
        if downsample:
            self.down_conv = Conv2d(cin, features, 1, stride, bias=False,
                                    init="msra", quantizable=False)
            self.down_bn = BatchNorm(features)
        else:
            self.down_conv = None

    def forward(self, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        residual = (x if self.down_conv is None
                    else self.down_conv(x, self.down_bn))
        return out + residual


class TridentResNet(nn.Module):
    """ResV2TridentNet: stem, stages 1, 2 and 4 of BottleneckV2, and the
    trident stage 3 (one BottleneckV2 downsample block, then TridentUnits
    over 3 branches, concatenated on the batch axis). Returns the NCHW
    maps (l1, l2, l3, l4) at strides 4, 8, 16, 16."""

    def __init__(self, depth: int = 50, deform: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise ValueError(
                f"the trident backbone runs in float32 only, not {dtype}: "
                "the JAX package's SharedConv applies its f32 weight "
                "uncast, so it fails for other activation dtypes too")
        layers = (3, 4, 23, 3) if depth == 101 else (3, 4, 6, 3)
        self.layers = layers
        self.out_channels = (256, 512, 1024, 2048)
        # the plain 7x7/s2 stem: the JAX package's space-to-depth form of
        # it is a TPU layout with the same math
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, init="msra")
        self.bn1 = BatchNorm(64)
        cin = 64
        for name, features, blocks, stride in (("layer1", 256, layers[0], 1),
                                               ("layer2", 512, layers[1], 2)):
            for b in range(blocks):
                self.add_module(f"{name}_{b}", BottleneckV2(
                    cin, features, stride if b == 0 else 1, downsample=b == 0))
                cin = features
        self.layer3_0 = BottleneckV2(cin, 1024, 2, downsample=True)
        for b in range(1, layers[2]):
            self.add_module(f"layer3_{b}", TridentUnit(1024, 1024,
                                                       deform=deform))
        cin = 1024
        for b in range(layers[3]):
            self.add_module(f"layer4_{b}", BottleneckV2(cin, 2048, 1,
                                                        downsample=b == 0))
            cin = 2048

    def _stage(self, name: str, blocks: int, x):
        for b in range(blocks):
            x = getattr(self, f"{name}_{b}")(x)
        return x

    def forward(self, x):
        x = max_pool(self.conv1(x, self.bn1, relu=True), 3, 2, 1)
        l1 = self._stage("layer1", self.layers[0], x)
        l2 = self._stage("layer2", self.layers[1], l1)
        t = self.layer3_0(l2)
        branches = [t, t, t]
        for b in range(1, self.layers[2]):
            branches = getattr(self, f"layer3_{b}")(branches)
        l3 = torch.cat(branches, 0)
        l4 = self._stage("layer4", self.layers[3], l3)
        return l1, l2, l3, l4
