"""Stacked hourglass (port of `rrnet_tpu/models/backbones/hourglass.py:
31-219`), NCHW: the plain variant, `dense=True` (each stack's output
also adds the stem feature and every earlier stack's output) and
`se=True, pool_stem=True` (squeeze-excitation in every residual block,
a stride-1 stem residual then a 2x2 max-pool, and the stack's out conv
keeping its ReLU).

Module names follow the flax scopes (`pre_conv`, `hg0.up1_0.conv1`,
`hg0.up1_0.se.fc1`, ...) so that `utils.from_flax` maps the JAX
package's parameter tree by name.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rrnet_torch.models.layers import (BatchNorm, ConvBN, Linear,
                                       ResidualBlock, max_pool, stem_conv)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """`jax.image.resize(method="nearest")`'s source index for each
    output position, floor((i + 0.5) * n_in / n_out) in f32 as JAX
    computes it. (`F.interpolate` picks other pixels at ratios that are
    not 2: its 'nearest' floors i * n_in / n_out, and 'nearest-exact'
    rounds its scale differently.)"""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
    return torch.floor(pos * n_in / n_out).long()


def resize_nearest(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, oh, ow) by `jax.image.resize(method=
    "nearest")`'s rule. At exactly 2x (every hourglass level of the
    768x1408 bucket) it is duplication."""
    h, w = x.shape[-2:]
    if (oh, ow) == (2 * h, 2 * w):
        return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return (x.index_select(-2, _nearest_index(h, oh, x.device))
            .index_select(-1, _nearest_index(w, ow, x.device)))


def upsample2x_nearest_add(low3: torch.Tensor, up1: torch.Tensor) -> torch.Tensor:
    """up1 + nearest upsample of low3 to up1's size (reference
    hourglass.py:110-124)."""
    return up1 + resize_nearest(low3, *up1.shape[-2:])


class SELayer(nn.Module):
    """Squeeze-excitation (reference se_hourglass.py:12-27): the channel
    mean, Dense(c/16) + ReLU, Dense(c) + sigmoid, a channel scale. The
    flax Dense layers have no bias and flax's lecun-normal init."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(channels, channels // reduction, bias=False,
                          init="lecun", dtype=dtype)
        self.fc2 = Linear(channels // reduction, channels, bias=False,
                          init="lecun", dtype=dtype)

    def forward(self, x):
        y = F.relu(self.fc1(x.mean(dim=(-2, -1))))
        y = torch.sigmoid(self.fc2(y))
        return x * y[:, :, None, None]


class HGResidual(ResidualBlock):
    """`layers.ResidualBlock`, with an `SELayer` after its second BN
    where `se` (reference hourglass.py:12-40, se_hourglass.py:30-60)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 se: bool = False, dtype=torch.float32):
        super().__init__(cin, features, stride, dtype=dtype,
                         se=SELayer(features, dtype=dtype) if se else None)


class Hourglass(nn.Module):
    """One recursive hourglass: stride-2 residual down path (no pooling),
    nearest x2 up path (reference hourglass.py:64-124)."""

    def __init__(self, n: int, inplanes: Sequence[int],
                 layer_nums: Sequence[int], cin: int, se: bool = False,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(se=se, dtype=dtype)
        cur, nxt = inplanes[0], inplanes[1]
        cur_num, nxt_num = layer_nums[0], layer_nums[1]
        self.n = n
        self.cur_num = cur_num
        self.nxt_num = nxt_num
        for i in range(cur_num):
            self.add_module(f"up1_{i}", HGResidual(cin if i == 0 else cur,
                                                   cur, **kw))
        self.add_module("low1_0", HGResidual(cin, nxt, stride=2, **kw))
        for i in range(1, cur_num):
            self.add_module(f"low1_{i}", HGResidual(nxt, nxt, **kw))
        if n > 1:
            self.low2 = Hourglass(n - 1, inplanes[1:], layer_nums[1:], nxt,
                                  **kw)
        else:
            for i in range(nxt_num):
                self.add_module(f"low2_{i}", HGResidual(nxt, nxt, **kw))
        for i in range(cur_num - 1):
            self.add_module(f"low3_{i}", HGResidual(nxt, nxt, **kw))
        self.add_module(f"low3_{cur_num - 1}", HGResidual(nxt, cur, **kw))

    def forward(self, x):
        up1 = x
        for i in range(self.cur_num):
            up1 = getattr(self, f"up1_{i}")(up1)
        low1 = self.low1_0(x)
        for i in range(1, self.cur_num):
            low1 = getattr(self, f"low1_{i}")(low1)
        if self.n > 1:
            low2 = self.low2(low1)
        else:
            low2 = low1
            for i in range(self.nxt_num):
                low2 = getattr(self, f"low2_{i}")(low2)
        low3 = low2
        for i in range(self.cur_num):
            low3 = getattr(self, f"low3_{i}")(low3)
        return upsample2x_nearest_add(low3, up1)


class HourglassNet(nn.Module):
    """Stacked hourglass (reference hourglass.py:127-199, and the dense
    and SE variants). Returns one `num_feats`-channel stride-4 NCHW map
    per stack; `out_channels` holds their widths."""

    def __init__(self, num_stacks: int = 2, depth: int = 5,
                 inplanes: Sequence[int] = (256, 256, 384, 384, 384, 512),
                 layer_nums: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 num_feats: int = 256, in_channels: int = 3,
                 dense: bool = False, se: bool = False,
                 pool_stem: bool = False, dtype=torch.float32):
        super().__init__()
        if dense and num_feats != 256:
            # the stem's 256-channel feature is added to each stack's
            # output (the JAX model fails there on a broadcast)
            raise ValueError(f"dense hourglass needs num_feats 256, not "
                             f"{num_feats}")
        self.num_stacks = num_stacks
        self.num_feats = num_feats
        self.out_channels = (num_feats,) * num_stacks
        self.dense = dense
        self.se = se
        self.pool_stem = pool_stem
        self.pre_conv = stem_conv(in_channels, 128, dtype=dtype)
        self.pre_bn = BatchNorm(128)
        self.pre_res = HGResidual(128, 256, stride=1 if pool_stem else 2,
                                  se=se, dtype=dtype)
        c0 = inplanes[0]
        cin = 256               # pre_res, then inter_res{i} (c0) feed a stack
        for i in range(num_stacks):
            self.add_module(f"hg{i}", Hourglass(depth, inplanes, layer_nums,
                                                cin, se=se, dtype=dtype))
            self.add_module(f"out_conv{i}",
                            ConvBN(c0, num_feats, 3, with_relu=se,
                                   dtype=dtype))
            if i < num_stacks - 1:
                self.add_module(f"inter{i}", ConvBN(cin, c0, 1,
                                                    with_relu=False,
                                                    dtype=dtype))
                self.add_module(f"fuse{i}", ConvBN(num_feats, c0, 1,
                                                   with_relu=False,
                                                   dtype=dtype))
                self.add_module(f"inter_res{i}", HGResidual(c0, c0, se=se,
                                                            dtype=dtype))
                cin = c0

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.pre_bn(self.pre_conv(x)))
        pre_feat = self.pre_res(x)
        if self.pool_stem:
            pre_feat = max_pool(pre_feat, 2, 2, 0)
        outs = []
        skips = [pre_feat]
        for i in range(self.num_stacks):
            feat = getattr(self, f"hg{i}")(pre_feat)
            feat = getattr(self, f"out_conv{i}")(feat)
            if self.dense:
                for sf in skips:
                    feat = feat + sf
                skips.append(feat)
            outs.append(feat)
            feat = F.relu(feat)
            if i < self.num_stacks - 1:
                a = getattr(self, f"inter{i}")(pre_feat)
                b = getattr(self, f"fuse{i}")(feat)
                pre_feat = getattr(self, f"inter_res{i}")(F.relu(a + b))
        return outs
