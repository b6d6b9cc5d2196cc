"""Loss criterions of the CenterNet family (port of
`rrnet_tpu/train/criterions.py:29-78`), vectorised over the batch.

  * `centernet_targets`: the batch's targets rendered on the device;
  * `centernet_criterion`: per stack focal-hm + L1(wh) + L1(offset), each
    stack's terms divided by the number of stacks;
  * `rrnet_stage2_criterion`: RRNet's stage 2, smooth-L1 on the
    Faster-RCNN deltas of the ROIs whose best GT IoU is above 0.5, the
    encoded target held constant, averaged per image over its positives
    and then over the batch.

`retinanet_criterion` waits for the RetinaNet model.
"""

from __future__ import annotations

from typing import Dict

import torch

from rrnet_torch import losses
from rrnet_torch.ops import box as boxops
from rrnet_torch.ops.targets import CenterNetTargets, render_batch


def centernet_targets(annos, valid, feat_shape, scale_factor,
                      num_classes) -> CenterNetTargets:
    return render_batch(annos, valid, feat_shape=feat_shape,
                        scale_factor=scale_factor, num_classes=num_classes)


def centernet_criterion(hms, whs, offsets,
                        targets: CenterNetTargets) -> Dict[str, torch.Tensor]:
    """hms, whs, offsets: per-stack (B, H, W, C) maps (NHWC)."""
    num_stacks = len(hms)
    hm_loss = wh_loss = off_loss = 0.0
    for s in range(num_stacks):
        pred_hm = losses.clamped_sigmoid(hms[s].float())
        hm_loss = hm_loss + losses.focal_loss_hm(pred_hm,
                                                 targets.hm) / num_stacks
        wh_loss = wh_loss + losses.reg_l1_loss(
            whs[s].float(), targets.reg_mask, targets.ind,
            targets.wh) / num_stacks
        off_loss = off_loss + losses.reg_l1_loss(
            offsets[s].float(), targets.reg_mask, targets.ind,
            targets.offset) / num_stacks
    return {"hm": hm_loss, "wh": wh_loss, "off": off_loss}


def rrnet_stage2_criterion(outs, annos, valid,
                           scale_factor: int) -> torch.Tensor:
    """outs: `models.rrnet.RRNetOutputs`; annos (B, N, >=4) xywh input
    pixels; valid (B, N) bool."""
    rois_in = outs.rois * scale_factor                       # (B, R, 4)
    gt_xyxy = boxops.xywh_to_xyxy(annos[..., :4].float())    # (B, N, 4)

    iou = boxops.pairwise_iou(rois_in, gt_xyxy)              # (B, R, N)
    iou = torch.where(valid[:, None, :], iou, 0.0)
    max_iou, max_idx = iou.max(dim=-1)                       # (B, R)
    pos = (max_iou > 0.5) & outs.roi_valid

    matched = torch.gather(gt_xyxy, 1, max_idx[..., None].expand(-1, -1, 4))
    target = boxops.encode_boxes(rois_in, matched).detach()

    elem = losses.smooth_l1_loss(outs.stage2_reg.float(), target,
                                 reduction="none")           # (B, R, 4)
    per_img_sum = torch.sum(elem * pos[..., None], dim=(1, 2))
    n_pos = torch.sum(pos, dim=1)
    per_img = torch.where(n_pos > 0,
                          per_img_sum / (n_pos * 4).clamp(min=1), 0.0)
    return per_img.mean()
