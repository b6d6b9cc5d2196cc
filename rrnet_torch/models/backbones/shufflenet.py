"""ShuffleNetV2 (port of `rrnet_tpu/models/backbones/shufflenet.py:28-110`),
NCHW.

Widths 0.5x-2.0x; InvertedResidual units with a channel shuffle (two
groups); a 3x3/2 stem conv and a 3/2/1 max-pool; stages of (4, 8, 4)
units; returns the (os8, os16, os32) maps, the 1x1 `conv_last` applied
to os32. Module names follow the flax scopes (`conv1`, `stage0_0.b1_dw`,
`conv_last`, ...).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from rrnet_torch.models.layers import ConvBN, max_pool

STAGE_CHANNELS = {
    "0.5x": (24, 48, 96, 192, 1024),
    "1.0x": (24, 116, 232, 464, 1024),
    "1.5x": (24, 176, 352, 704, 1024),
    "2.0x": (24, 224, 488, 976, 2048),
}
STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """NCHW channel shuffle (reference shufflenet.py:31-45)."""
    b, c, h, w = x.shape
    return (x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class InvertedResidual(nn.Module):
    """A ShuffleNetV2 unit (reference shufflenet.py:48-113): stride 1
    splits the channels and transforms one half; stride 2 runs both
    branches on the whole input."""

    def __init__(self, cin: int, out_channels: int, stride: int,
                 dtype=torch.float32):
        super().__init__()
        half = out_channels // 2
        self.stride = stride
        kw = dict(dtype=dtype)
        if stride == 1:
            b_in = cin // 2
        else:
            b_in = cin
            self.b1_dw = ConvBN(cin, cin, 3, 2, groups=cin, with_relu=False,
                                **kw)
            self.b1_pwl = ConvBN(cin, half, 1, **kw)
        self.b2_pw = ConvBN(b_in, half, 1, **kw)
        self.b2_dw = ConvBN(half, half, 3, stride, groups=half,
                            with_relu=False, **kw)
        self.b2_pwl = ConvBN(half, half, 1, **kw)

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.b2_pwl(self.b2_dw(self.b2_pw(x2)))], 1)
        else:
            a = self.b1_pwl(self.b1_dw(x))
            b = self.b2_pwl(self.b2_dw(self.b2_pw(x)))
            out = torch.cat([a, b], 1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """Returns (os8, os16, os32); `out_channels` holds their widths."""

    def __init__(self, width: str = "1.0x", in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        if width not in STAGE_CHANNELS:
            raise ValueError(f"shufflenet width {width!r} is not one of "
                             f"{sorted(STAGE_CHANNELS)}")
        chans = STAGE_CHANNELS[width]
        self.conv1 = ConvBN(in_channels, chans[0], 3, 2, dtype=dtype)
        cin = chans[0]
        for stage, repeats in enumerate(STAGE_REPEATS):
            out_c = chans[stage + 1]
            for i in range(repeats):
                self.add_module(f"stage{stage}_{i}", InvertedResidual(
                    cin, out_c, 2 if i == 0 else 1, dtype=dtype))
                cin = out_c
        self.conv_last = ConvBN(cin, chans[-1], 1, dtype=dtype)
        self.out_channels = chans[1:3] + chans[-1:]

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = max_pool(self.conv1(x), 3, 2, 1)
        outs = []
        for stage, repeats in enumerate(STAGE_REPEATS):
            for i in range(repeats):
                x = getattr(self, f"stage{stage}_{i}")(x)
            outs.append(x)
        outs[-1] = self.conv_last(outs[-1])
        return tuple(outs)
