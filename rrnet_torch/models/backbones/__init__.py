"""Backbone registry (port of `rrnet_tpu/models/backbones/__init__.py:22-66`).

Every backbone returns a list or tuple of NCHW feature maps and holds
their widths in `out_channels`: the hourglass family one stride-4 map per
stack; the ResNet and trident families their pyramid (l1, l2, l3, l4);
HRNet (w48, w32) one stride-4 map, HRNetV2 four; ShuffleNetV2 (os8,
os16, os32). The JAX registry falls back to resnet50 for a name it does
not know; this one raises, so a misspelt backbone is never trained as
another.
"""

from __future__ import annotations

import torch
from torch import nn

from rrnet_torch.models.backbones.hourglass import HourglassNet
from rrnet_torch.models.backbones.hrnet import HRNetW32, HRNetW48
from rrnet_torch.models.backbones.hrnetv2 import HRNetV2
from rrnet_torch.models.backbones.resnet import resnet10, resnet50, resnet101
from rrnet_torch.models.backbones.shufflenet import (STAGE_CHANNELS,
                                                     ShuffleNetV2)
from rrnet_torch.models.backbones.trident import TridentResNet


def get_backbone(name: str, num_stacks: int = 2, dtype=torch.float32):
    """Build a backbone by name: 'resnet10', 'resnet50', 'resnet101',
    'hourglass' (hourglass-104), 'dense_hourglass', 'se_hourglass',
    'tiny_hourglass' (depth 2, inplanes (64, 64, 96), one layer per level,
    64 features; the tests' size), 'hrnet' (w48), 'hrnet32', 'hrnetv2'
    (w40, four maps, frozen BN statistics), 'shufflenet' or
    'shufflenet_<mult>' with <mult> one of 0.5x, 1.0x, 1.5x, 2.0x
    ('shufflenet' alone is 1.0x), or a name starting with 'trires'
    (matched as the JAX registry does: depth 101 if the name holds '101',
    else 50; deformable if it holds 'deform'; so 'trires50', 'trires101',
    'trires50deform', 'trires101deform')."""
    resnets = {"resnet10": resnet10, "resnet50": resnet50,
               "resnet101": resnet101}
    hourglasses = {"hourglass": {}, "dense_hourglass": {"dense": True},
                   "se_hourglass": {"se": True, "pool_stem": True},
                   "tiny_hourglass": {"depth": 2, "inplanes": (64, 64, 96),
                                      "layer_nums": (1, 1, 1),
                                      "num_feats": 64}}
    hrnets = {"hrnet": HRNetW48, "hrnet32": HRNetW32, "hrnetv2": HRNetV2}
    if name in resnets:
        return resnets[name](dtype=dtype)
    if name in hourglasses:
        return HourglassNet(num_stacks=num_stacks, dtype=dtype,
                            **hourglasses[name])
    if name in hrnets:
        return hrnets[name](dtype=dtype)
    if name.startswith("shufflenet"):
        width = name.split("_")[1] if "_" in name else "1.0x"
        if name not in ("shufflenet", f"shufflenet_{width}") or (
                width not in STAGE_CHANNELS):
            raise NotImplementedError(f"backbone {name!r} is not known")
        return ShuffleNetV2(width=width, dtype=dtype)
    if name.startswith("trires"):
        return TridentResNet(depth=101 if "101" in name else 50,
                             deform="deform" in name, dtype=dtype)
    raise NotImplementedError(f"backbone {name!r} is not known")


def stack_widths(backbone: nn.Module, num_stacks: int, name: str):
    """The widths of the backbone's first `num_stacks` maps, which a
    detector's per-stack heads read; raises ValueError where the backbone
    returns fewer maps (the JAX model fails there with an IndexError)."""
    widths = tuple(backbone.out_channels)
    if num_stacks > len(widths):
        raise ValueError(f"{num_stacks} stacks asked of backbone {name!r}, "
                         f"which returns {len(widths)} map(s)")
    return widths[:num_stacks]
