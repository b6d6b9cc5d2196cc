"""CenterNet detector (port of `rrnet_tpu/models/centernet.py:18-44`,
reference models/centernet.py:8-33).

Backbone (its first `num_stacks` maps, each head at its map's width) ->
per stack relu -> heatmap (num_classes channels),
wh (the asymmetric 17x1 / 1x17 head, 2 channels) and offset (2 channels)
heads. Returns per-stack tuples of NHWC maps; the decode lives in
`ops.heatmap` and the evaluator. Module names follow the flax scopes
(`backbone`, `hm`, `wh`, `reg`), so `utils.from_flax` carries the JAX
package's weights across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rrnet_torch.models.backbones import get_backbone, stack_widths
from rrnet_torch.models.heads import CenterNetHead, CenterNetWHHead


class CenterNet(nn.Module):
    def __init__(self, num_classes: int = 10, num_stacks: int = 2,
                 backbone: str = "hourglass", wh_kernel: int = 17,
                 dtype=torch.float32):
        super().__init__()
        self.num_stacks = num_stacks
        self.backbone = get_backbone(backbone, num_stacks, dtype=dtype)
        widths = stack_widths(self.backbone, num_stacks, backbone)
        self.hm = CenterNetHead(num_classes, num_stacks, is_heatmap=True,
                                in_channels=widths, dtype=dtype)
        self.wh = CenterNetWHHead(1, num_stacks, kernel=wh_kernel,
                                  in_channels=widths, dtype=dtype)
        self.reg = CenterNetHead(2, num_stacks, in_channels=widths,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x (B, 3, H, W) -> (hms, whs, regs), per-stack tuples of
        (B, H/4, W/4, C) maps."""
        feats = self.backbone(x)
        hms, whs, regs = [], [], []
        for i in range(self.num_stacks):
            f = F.relu(feats[i])
            hms.append(self.hm(f, i))
            whs.append(self.wh(f, i))
            regs.append(self.reg(f, i))
        return tuple(hms), tuple(whs), tuple(regs)
