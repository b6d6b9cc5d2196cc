"""Shared model modules, NCHW (port of `rrnet_tpu/models/modules.py:30-52`):
the 3-level FPN and the bilinear resize that it and the Evaluator use.

The JAX package's windowed `SelfAttentionModule` is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rrnet_torch.models.layers import Conv2d


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *size) as `jax.image.resize(...,
    "bilinear")`: half-pixel centres, edges clamped, and a widened
    (antialiased) kernel only where an axis shrinks."""
    size = tuple(size)
    if size == tuple(x.shape[-2:]):
        return x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrinks)


class FPN(nn.Module):
    """3-level feature pyramid (reference modules/fpn.py:5-51): 1x1
    laterals with bias (512/1024/2048 -> channels), the coarser level
    resized to the finer one's size and added, 3x3 smoothing of p4 and
    p3. Module names are the flax scopes (`lat5`, `lat4`, `top4`,
    `lat3`, `top3`)."""

    def __init__(self, in_channels: Tuple[int, int, int] = (512, 1024, 2048),
                 channels: int = 256, dtype=torch.float32):
        super().__init__()
        c3, c4, c5 = in_channels
        self.lat5 = Conv2d(c5, channels, 1, dtype=dtype)
        self.lat4 = Conv2d(c4, channels, 1, dtype=dtype)
        self.top4 = Conv2d(channels, channels, 3, 1, 1, dtype=dtype)
        self.lat3 = Conv2d(c3, channels, 1, dtype=dtype)
        self.top3 = Conv2d(channels, channels, 3, 1, 1, dtype=dtype)

    def forward(self, c3, c4, c5):
        p5 = self.lat5(c5)
        p4 = self.top4(resize_bilinear(p5, c4.shape[-2:]) + self.lat4(c4))
        p3 = self.top3(resize_bilinear(p4, c3.shape[-2:]) + self.lat3(c3))
        return p3, p4, p5
