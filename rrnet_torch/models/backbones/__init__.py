"""Backbone registry (port of `rrnet_tpu/models/backbones/__init__.py:22-66`).

The hourglass family returns a list of NCHW feature maps, one stride-4
map per stack; the ResNet and trident families return their NCHW pyramid
(l1, l2, l3, l4). The plain hourglass, resnet10/50/101 and the trident
family are ported. The JAX registry falls back to resnet50 for a name it
does not know; this one raises, so a misspelt or unported backbone is
never trained as another.
"""

from __future__ import annotations

import torch

from rrnet_torch.models.backbones.hourglass import HourglassNet
from rrnet_torch.models.backbones.resnet import resnet10, resnet50, resnet101
from rrnet_torch.models.backbones.trident import TridentResNet


def get_backbone(name: str, num_stacks: int = 2, dtype=torch.float32):
    """Build a backbone by name: 'resnet10', 'resnet50', 'resnet101',
    'hourglass' (hourglass-104),
    'tiny_hourglass' (depth 2, inplanes (64, 64, 96), one layer per level,
    64 features; the tests' size), or a name starting with 'trires'
    (matched as the JAX registry does: depth 101 if the name holds '101',
    else 50; deformable if it holds 'deform'; so 'trires50', 'trires101',
    'trires50deform', 'trires101deform')."""
    resnets = {"resnet10": resnet10, "resnet50": resnet50,
               "resnet101": resnet101}
    if name in resnets:
        return resnets[name](dtype=dtype)
    if name == "hourglass":
        return HourglassNet(num_stacks=num_stacks, dtype=dtype)
    if name == "tiny_hourglass":
        return HourglassNet(num_stacks=num_stacks, depth=2,
                            inplanes=(64, 64, 96), layer_nums=(1, 1, 1),
                            num_feats=64, dtype=dtype)
    if name.startswith("trires"):
        return TridentResNet(depth=101 if "101" in name else 50,
                             deform="deform" in name, dtype=dtype)
    raise NotImplementedError(f"backbone {name!r} is not ported yet")
