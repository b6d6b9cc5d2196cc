"""Detection heads (port of `rrnet_tpu/models/heads.py:28-151`).

Heads take NCHW features. The stage-1 heads return NHWC maps, the JAX
package's public layout; `RetinaNetHead` returns NCHW, which the detector
flattens. Per-stack heads hold one parameter set per stack
under the flax scope names (`conv{stack}`, `out{stack}`, `hconv{stack}`,
`wconv{stack}`).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from rrnet_torch.models.layers import (Bottleneck, Conv2d, Linear, conv2d,
                                       torch_conv_init_)


def per_stack(in_channels: Union[int, Sequence[int]],
              num_stacks: int) -> Tuple[int, ...]:
    """One input width per stack: an int is every stack's width."""
    if isinstance(in_channels, int):
        return (in_channels,) * num_stacks
    widths = tuple(in_channels)
    if len(widths) != num_stacks:
        raise ValueError(f"{len(widths)} input widths for {num_stacks} "
                         "stacks")
    return widths


class ConvParam(nn.Module):
    """An OIHW conv weight and bias that a head applies in its own form
    (flax `_ConvParam`)."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int,
                 bias_value: float = 0.0):
        super().__init__()
        self.bias_value = bias_value
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        cout, cin, kh, kw = self.weight.shape
        torch_conv_init_(self.weight, cin * kh * kw, generator)
        nn.init.constant_(self.bias, self.bias_value)


class CenterNetHead(nn.Module):
    """Per stack: 3x3 conv (bias, no BN) + relu, then the 1x1 out conv as
    a matmul. Heatmap heads start their bias at -2.19. `in_channels`:
    one width, or one per stack (flax infers each from its map)."""

    def __init__(self, planes: int, num_stacks: int = 2,
                 is_heatmap: bool = False, mid_channels: int = 256,
                 in_channels: Union[int, Sequence[int]] = 256,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, cin in enumerate(per_stack(in_channels, num_stacks)):
            self.add_module(f"conv{i}", Conv2d(cin, mid_channels, 3,
                                               1, 1, dtype=dtype,
                                               quantizable=False))
            self.add_module(f"out{i}", ConvParam(
                mid_channels, planes, 1, 1,
                bias_value=-2.19 if is_heatmap else 0.0))

    def forward(self, x, stack: int):
        """x (B, C, H, W) -> (B, H, W, planes)."""
        x = getattr(self, f"conv{stack}")(x, relu=True)
        out = getattr(self, f"out{stack}")
        w = out.weight[:, :, 0, 0].to(self.dtype)
        # on the eval path's channels-last maps the permute is a view of
        # contiguous (B*H*W, C) rows, so the product reads them in place
        return x.permute(0, 2, 3, 1) @ w.t() + out.bias.to(self.dtype)


class CenterNetWHHead(nn.Module):
    """Shared 3x3 conv + relu, then a (k,1) column conv predicting H and
    a (1,k) row conv predicting W, interleaved W then H per plane
    (reference detectors/centernet_detector.py:47-55: channel 0 is W).
    The JAX package's matmul-plus-shifted-sum form is a TPU layout
    choice; the asymmetric convs compute the same sums. `in_channels` as
    `CenterNetHead`'s."""

    def __init__(self, planes: int = 1, num_stacks: int = 2,
                 kernel: int = 17, mid_channels: int = 256,
                 in_channels: Union[int, Sequence[int]] = 256,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pad = (kernel - 1) // 2
        for i, cin in enumerate(per_stack(in_channels, num_stacks)):
            self.add_module(f"conv{i}", Conv2d(cin, mid_channels, 3,
                                               1, 1, dtype=dtype,
                                               quantizable=False))
            self.add_module(f"hconv{i}", ConvParam(mid_channels, planes,
                                                   kernel, 1))
            self.add_module(f"wconv{i}", ConvParam(mid_channels, planes,
                                                   1, kernel))

    def forward(self, x, stack: int):
        """x (B, C, H, W) -> (B, H, W, 2 * planes) [W0, H0, W1, H1, ...]."""
        conv = getattr(self, f"conv{stack}")(x, relu=True)
        hp = getattr(self, f"hconv{stack}")
        wp = getattr(self, f"wconv{stack}")
        h = conv2d(conv, hp.weight.to(self.dtype), hp.bias.to(self.dtype),
                   padding=(self.pad, 0))
        w = conv2d(conv, wp.weight.to(self.dtype), wp.bias.to(self.dtype),
                   padding=(0, self.pad))
        out = torch.stack([w, h], dim=-1)           # (B, p, H, W, 2)
        bsz, p, hh, ww, _ = out.shape
        return out.permute(0, 2, 3, 1, 4).reshape(bsz, hh, ww, 2 * p)


class FasterRCNNHead(nn.Module):
    """RRNet stage 2: Bottleneck(64) on the 3x3 ROI feature, mean over the
    3x3, then Dense(4). `in_channels`: the width of the map the ROIs are
    aligned on (the backbone's last)."""

    def __init__(self, in_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.top = Bottleneck(in_channels, 64, dtype=dtype)
        self.regressor = Linear(256, 4, dtype=dtype)

    def forward(self, roi_feat):
        """roi_feat (N, C, 3, 3) -> (N, 4) deltas."""
        x = self.top(roi_feat)
        return self.regressor(x.mean(dim=(-2, -1)))


class RetinaNetHead(nn.Module):
    """Shared conv tower: 4 x (3x3 conv-256 + relu), then a 3x3 out conv
    to `planes` channels. The JAX package uses flax `nn.Conv` here (not
    its `Conv2d`): the same kernel/bias leaves, torch's default kernel
    init and a zero bias, which `Conv2d` also gives; so never int8
    (`quantizable=False`). Scopes `conv0..3`, `out`."""

    def __init__(self, planes: int, in_channels: int = 256,
                 mid_channels: int = 256, dtype=torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", Conv2d(
                in_channels if i == 0 else mid_channels, mid_channels, 3, 1,
                1, dtype=dtype, quantizable=False))
        self.out = Conv2d(mid_channels, planes, 3, 1, 1, dtype=dtype,
                          quantizable=False)

    def forward(self, x):
        """x (B, C, H, W) -> (B, planes, H, W)."""
        for i in range(4):
            x = getattr(self, f"conv{i}")(x, relu=True)
        return self.out(x)
