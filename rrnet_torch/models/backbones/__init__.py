"""Backbone registry (port of `rrnet_tpu/models/backbones/__init__.py:22-44`).

Each backbone returns a list of NCHW feature maps, one stride-4 map per
stack. Only the hourglass family's plain variant is ported yet.
"""

from __future__ import annotations

import torch

from rrnet_torch.models.backbones.hourglass import HourglassNet


def get_backbone(name: str, num_stacks: int = 2, dtype=torch.float32):
    """Build a backbone by name: 'hourglass' (hourglass-104) or
    'tiny_hourglass' (depth 2, inplanes (64, 64, 96), one layer per level,
    64 features; the tests' size)."""
    if name == "hourglass":
        return HourglassNet(num_stacks=num_stacks, dtype=dtype)
    if name == "tiny_hourglass":
        return HourglassNet(num_stacks=num_stacks, depth=2,
                            inplanes=(64, 64, 96), layer_nums=(1, 1, 1),
                            num_feats=64, dtype=dtype)
    raise NotImplementedError(f"backbone {name!r} is not ported yet")
