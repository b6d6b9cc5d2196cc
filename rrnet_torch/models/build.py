"""Config -> model (port of `rrnet_tpu/models/build.py:16-46`: RRNet,
CenterNet and RetinaNet), and name -> backbone for the backbones no
ported detector runs."""

from __future__ import annotations

from typing import Optional, Union

import torch

from rrnet_torch.config import Config
from rrnet_torch.models.backbones import get_backbone
from rrnet_torch.models.centernet import CenterNet
from rrnet_torch.models.layers import dtype_of, init_weights, set_sync_group
from rrnet_torch.models.retinanet import RetinaNet
from rrnet_torch.models.rrnet import RRNet
from rrnet_torch.utils.device import resolve_device


def build_model(cfg: Config, device: Union[str, torch.device] = "cuda",
                generator: Optional[torch.Generator] = None, group=None):
    """The configured detector in eval mode on `device`, its weights drawn
    on the CPU from `generator` (default: seeded with cfg.seed), so one
    seed gives the same weights on every machine. Load trained weights
    with `load_state_dict` (see utils.from_flax). 'rrnet' (with the
    self-attention where `model.with_self_attention` is set),
    'centernet' and 'retinanet' are ported. `group` (a
    `parallel.DataGroup`) makes its batch norms SyncBN over the group
    where `model.sync_bn` is set, as the JAX package's `bn_axis` does."""
    dev = resolve_device(device)
    m = cfg.model
    if m.name == "centernet":
        model = CenterNet(num_classes=cfg.num_classes,
                          num_stacks=m.num_stacks, backbone=m.backbone,
                          wh_kernel=m.wh_kernel, dtype=dtype_of(m.dtype))
    elif m.name == "retinanet":
        n_anchors = len(m.anchor_ratios) * len(m.anchor_scales)
        model = RetinaNet(num_classes=cfg.num_classes, num_anchors=n_anchors,
                          backbone=m.backbone, fpn_channels=m.fpn_channels,
                          dtype=dtype_of(m.dtype))
    elif m.name != "rrnet":
        raise NotImplementedError(f"model {m.name!r} is not ported yet")
    else:
        model = RRNet(
            num_classes=cfg.num_classes, num_stacks=m.num_stacks,
            backbone=m.backbone, wh_kernel=m.wh_kernel, topk=m.topk,
            stage2_rois=m.stage2_rois, nms_type=m.nms_type_for_stage1,
            nms_per_class=m.nms_per_class_for_stage1,
            nms_iou=m.stage1_nms_iou, soft_nms_sigma=m.soft_nms.sigma,
            soft_nms_score_threshold=m.soft_nms.score_threshold,
            with_attention=m.with_self_attention, dtype=dtype_of(m.dtype))
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    if m.sync_bn:
        set_sync_group(model, group)
    return model.to(dev).eval()


def build_backbone(name: str, device: Union[str, torch.device] = "cuda",
                   generator: Optional[torch.Generator] = None,
                   dtype: torch.dtype = torch.float32):
    """The backbone `name` (see `models.backbones.get_backbone`) in eval
    mode on `device`, its weights drawn on the CPU from `generator`
    (default: seeded with 0) with the JAX package's initialisers; call
    `.train()` for batch statistics. This is the entry point of the
    trident backbones, which no ported detector runs: the JAX package's
    detectors cannot take their 3x batch (see ROADMAP C)."""
    dev = resolve_device(device)
    model = get_backbone(name, dtype=dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(dev).eval()
