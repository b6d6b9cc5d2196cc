"""Loss criterions (port of `rrnet_tpu/train/criterions.py:29-132`),
vectorised over the batch.

  * `centernet_targets`: the batch's targets rendered on the device;
  * `centernet_criterion`: per stack focal-hm + L1(wh) + L1(offset), each
    stack's terms divided by the number of stacks;
  * `rrnet_stage2_criterion`: RRNet's stage 2, smooth-L1 on the
    Faster-RCNN deltas of the ROIs whose best GT IoU is above 0.5, the
    encoded target held constant, averaged per image over its positives
    and then over the batch;
  * `retinanet_criterion`: anchor assignment by IoU, focal loss over the
    anchors that are positive or negative, smooth-L1 (beta 1/9) on the
    standardised deltas of the positives, each per image, then the
    batch mean.
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


def retinanet_criterion(loc_preds, cls_preds, annos, valid, anchors,
                        pos_iou: float = 0.5, neg_iou: float = 0.4,
                        alpha: float = 0.75, gamma: float = 2.0
                        ) -> Dict[str, torch.Tensor]:
    """loc_preds (B, A, 4), cls_preds (B, A, C) logits, annos (B, N, >=6)
    xywh input pixels with the 1-based class at column 5, valid (B, N)
    bool, anchors (A, 4) xyxy (reference retinanet_operator.py:47-113).
    An anchor is positive at best IoU >= pos_iou, negative below neg_iou,
    ignored between; ties of the best IoU go to the first GT, and invalid
    GTs have IoU 0. The targets are constants of the graph."""
    gt = boxops.xywh_to_xyxy(annos[..., :4].float())         # (B, N, 4)
    num_classes = cls_preds.shape[-1]
    iou = boxops.pairwise_iou(gt, anchors)                   # (B, N, A)
    iou = torch.where(valid[:, :, None], iou, 0.0)
    max_iou, max_idx = iou.max(dim=1)                        # (B, A)
    del iou
    pos = max_iou >= pos_iou
    sel = pos | (max_iou < neg_iou)

    gt_cls = torch.gather(annos[..., 5], 1, max_idx)
    a_cls = (gt_cls.to(torch.int32) - 1).clamp(0, num_classes - 1)
    cls_t = (torch.nn.functional.one_hot(a_cls.long(), num_classes).float()
             * pos[..., None])
    cls_elem = losses.focal_loss(cls_preds.float(), cls_t, gamma=gamma,
                                 alpha=alpha, reduction="none")
    n_pos = pos.sum(dim=1).float()                           # (B,)
    cls_loss = ((cls_elem * sel[..., None]).sum(dim=(1, 2))
                / n_pos.clamp(min=1.0))

    # regression targets: standardised deltas, GT w/h clamped >= 1
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    g = torch.gather(gt, 1, max_idx[..., None].expand(-1, -1, 4))
    gw = (g[..., 2] - g[..., 0]).clamp(min=1.0)
    gh = (g[..., 3] - g[..., 1]).clamp(min=1.0)
    gcx = g[..., 0] + 0.5 * (g[..., 2] - g[..., 0])
    gcy = g[..., 1] + 0.5 * (g[..., 3] - g[..., 1])
    t = torch.stack([(gcx - acx) / aw / 0.1, (gcy - acy) / ah / 0.1,
                     torch.log(gw / aw) / 0.2, torch.log(gh / ah) / 0.2],
                    dim=-1)
    diff = torch.abs(t.detach() - loc_preds.float())
    elem = torch.where(diff <= 1.0 / 9.0, 0.5 * 9.0 * diff * diff,
                       diff - 0.5 / 9.0)
    reg_loss = torch.where(
        n_pos > 0,
        (elem * pos[..., None]).sum(dim=(1, 2)) / (n_pos * 4).clamp(min=1.0),
        0.0)
    return {"cls": cls_loss.mean(), "reg": reg_loss.mean()}
