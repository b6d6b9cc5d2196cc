"""HRNetV2-w40 (port of `rrnet_tpu/models/backbones/hrnetv2.py:17-27`).

The shared HRNet at base width 40, stage counts (1, 4, 3), the last
exchange module keeping all four branches, which are upsampled to stride
4: four stride-4 maps of (40, 80, 160, 320) channels. `norm_eval=True`
keeps the backbone's BN on its running statistics in training, as the
reference's frozen-BN trick (hrnetv2.py:520-527).
"""

from __future__ import annotations

import torch

from rrnet_torch.models.backbones.hrnet import HRNet


def HRNetV2(norm_eval: bool = True, dtype=torch.float32, **kw) -> HRNet:
    kw = {"base_channels": 40, "stage_modules": (1, 4, 3), **kw}
    return HRNet(last_multi_scale=True, norm_eval=norm_eval, dtype=dtype,
                 **kw)
