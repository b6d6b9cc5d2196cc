"""HRNet backbones (port of `rrnet_tpu/models/backbones/hrnet.py:52-219`),
NCHW.

One module for the JAX package's two HRNet variants: the pose-style
HRNet-w48/w32 (the last stage-4 module fuses down to its stride-4
branch; returns one map) and, with `last_multi_scale=True`, HRNetV2
(`hrnetv2.py`: all four branches kept and upsampled to stride 4).
Module names follow the flax scopes (`stem1.conv`, `layer1_0.conv1`,
`stage3_2.fuse0_2_conv`, `stage4_0.branch3_block1.down_bn`, ...) so that
`utils.from_flax` maps the JAX package's tree by name.

Fuse: output branch i = relu(sum_j f_ij(branch j)), f_ij the identity
(i == j), a 1x1 conv + BN + JAX's nearest upsample
(`hourglass.resize_nearest`) (i < j), or a chain of stride-2 3x3 conv +
BN (+ ReLU but the last) (i > j).

HRNetV2's output upsample keeps the activation dtype. The JAX package's
weights it in f32, so with bf16 activations its maps 1-3 come out in f32
(the heads cast them to bf16 again; stage 2 aligns ROIs on the f32 map):
in bf16 the port's maps 1-3 are those values rounded to bf16.

`norm_eval=True` keeps every BN of the backbone on its running
statistics when the model trains (`bn_train = train and not norm_eval`
in the JAX package): `train()` leaves this module in eval mode, so its
BN neither normalises by batch statistics nor updates its statistics.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rrnet_torch.models.backbones.hourglass import resize_nearest
from rrnet_torch.models.layers import BatchNorm, Bottleneck, Conv2d
from rrnet_torch.utils import tracing


def resize_bilinear_align_corners(x: torch.Tensor, oh: int,
                                  ow: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, oh, ow), bilinear with corner-aligned
    sampling as the JAX package's `_resize_bilinear_align_corners`
    (torch's `align_corners=True`; the HRNetV2 output upsample)."""
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=True)


class BasicBlock(nn.Module):
    """ResNet BasicBlock, expansion 1, with a 1x1 conv + BN skip when the
    shape changes (reference hrnet.py:45-74)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(planes)
        if stride != 1 or cin != planes:
            self.down_conv = Conv2d(cin, planes, 1, stride, bias=False,
                                    dtype=dtype)
            self.down_bn = BatchNorm(planes)
        else:
            self.down_conv = None

    def forward(self, x):
        with tracing.span("backbone.block"):
            out = F.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            skip = (x if self.down_conv is None
                    else self.down_bn(self.down_conv(x)))
            return F.relu(out + skip)


class ConvBNRelu(nn.Module):
    """3x3 conv (no bias) + BN (+ ReLU); the flax `_ConvBNRelu`."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 relu: bool = True, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, features, 3, stride, 1, bias=False,
                           dtype=dtype)
        self.bn = BatchNorm(features)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class StageModule(nn.Module):
    """One exchange module: `num_blocks` BasicBlocks on each branch, then
    every branch fused into each of the first `output_branches` outputs
    (all of them by default)."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4,
                 output_branches: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        n = len(channels)
        self.n = n
        self.n_out = output_branches or n
        self.num_blocks = num_blocks
        for j in range(n):
            for b in range(num_blocks):
                self.add_module(f"branch{j}_block{b}",
                                BasicBlock(channels[j], channels[j],
                                           dtype=dtype))
        for i in range(self.n_out):
            for j in range(n):
                if i < j:
                    self.add_module(f"fuse{i}_{j}_conv", Conv2d(
                        channels[j], channels[i], 1, bias=False,
                        dtype=dtype))
                    self.add_module(f"fuse{i}_{j}_bn", BatchNorm(channels[i]))
                elif i > j:
                    for k in range(i - j):
                        last = k == i - j - 1
                        self.add_module(f"fuse{i}_{j}_down{k}", ConvBNRelu(
                            channels[j], channels[i] if last else channels[j],
                            stride=2, relu=not last, dtype=dtype))

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        xs = list(xs)
        for j in range(self.n):
            for b in range(self.num_blocks):
                xs[j] = getattr(self, f"branch{j}_block{b}")(xs[j])
        fused = []
        for i in range(self.n_out):
            with tracing.span("backbone.fuse"):
                acc = None
                for j in range(self.n):
                    if i == j:
                        y = xs[j]
                    elif i < j:
                        y = getattr(self, f"fuse{i}_{j}_bn")(
                            getattr(self, f"fuse{i}_{j}_conv")(xs[j]))
                        y = resize_nearest(y, *xs[i].shape[-2:])
                    else:
                        y = xs[j]
                        for k in range(i - j):
                            y = getattr(self, f"fuse{i}_{j}_down{k}")(y)
                    acc = y if acc is None else acc + y
                fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """The shared stem and stages (the flax `_HRNetBase`): two 3x3/2
    convs to stride 4, `layer1` of four Bottlenecks (64 planes, msra
    init), the transitions, and stages 2-4 of `stage_modules` exchange
    modules on branches of (c, 2c, 4c, 8c) channels. Returns `[x0]`, or
    with `last_multi_scale` the four branches at stride 4 (branches 1-3
    upsampled bilinearly with aligned corners). `out_channels` holds the
    widths of the maps it returns."""

    def __init__(self, base_channels: int = 48,
                 stage_modules: Tuple[int, int, int] = (1, 4, 3),
                 last_multi_scale: bool = False, norm_eval: bool = False,
                 in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        c = base_channels
        widths = (c, 2 * c, 4 * c, 8 * c)
        self.stage_modules = tuple(stage_modules)
        self.last_multi_scale = last_multi_scale
        self.norm_eval = norm_eval
        self.out_channels = widths if last_multi_scale else widths[:1]
        self.stem1 = ConvBNRelu(in_channels, 64, stride=2, dtype=dtype)
        self.stem2 = ConvBNRelu(64, 64, stride=2, dtype=dtype)
        for b in range(4):
            self.add_module(f"layer1_{b}", Bottleneck(64 if b == 0 else 256,
                                                      64, dtype=dtype))
        self.trans1_0 = ConvBNRelu(256, widths[0], dtype=dtype)
        self.trans1_1 = ConvBNRelu(256, widths[1], stride=2, dtype=dtype)
        n2, n3, n4 = self.stage_modules
        for m in range(n2):
            self.add_module(f"stage2_{m}", StageModule(widths[:2],
                                                       dtype=dtype))
        self.trans2_2 = ConvBNRelu(widths[1], widths[2], stride=2,
                                   dtype=dtype)
        for m in range(n3):
            self.add_module(f"stage3_{m}", StageModule(widths[:3],
                                                       dtype=dtype))
        self.trans3_3 = ConvBNRelu(widths[2], widths[3], stride=2,
                                   dtype=dtype)
        for m in range(n4):
            last = m == n4 - 1
            self.add_module(f"stage4_{m}", StageModule(
                widths, output_branches=(
                    None if (last_multi_scale or not last) else 1),
                dtype=dtype))

    def train(self, mode: bool = True):
        """With `norm_eval`, the backbone stays in eval mode."""
        return super().train(mode and not self.norm_eval)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem2(self.stem1(x))
        for b in range(4):
            x = getattr(self, f"layer1_{b}")(x)
        xs = [self.trans1_0(x), self.trans1_1(x)]
        n2, n3, n4 = self.stage_modules
        for m in range(n2):
            xs = getattr(self, f"stage2_{m}")(xs)
        xs = xs + [self.trans2_2(xs[-1])]
        for m in range(n3):
            xs = getattr(self, f"stage3_{m}")(xs)
        xs = xs + [self.trans3_3(xs[-1])]
        for m in range(n4):
            xs = getattr(self, f"stage4_{m}")(xs)
        if not self.last_multi_scale:
            return [xs[0]]
        oh, ow = xs[0].shape[-2:]
        return [xs[0]] + [resize_bilinear_align_corners(xs[i], oh, ow)
                          for i in range(1, 4)]


def HRNetW48(dtype=torch.float32, **kw) -> HRNet:
    return HRNet(base_channels=48, dtype=dtype, **kw)


def HRNetW32(dtype=torch.float32, **kw) -> HRNet:
    return HRNet(base_channels=32, dtype=dtype, **kw)
