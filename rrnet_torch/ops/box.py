"""Box geometry (port of `rrnet_tpu/ops/box.py:20-175`).

Functions broadcast over leading dims; pairwise ones take (M,4) x (N,4)
-> (M,N). The legacy +1 extents of the reference's Cython NMS are kept
behind `plus_one`, and `decode_boxes` bumps ROI w/h by +1 as the
reference's `generate_bbox` does.
"""

from __future__ import annotations

import torch


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x, y, w, h] -> [x1, y1, x2, y2]."""
    xy = boxes[..., :2]
    return torch.cat([xy, xy + boxes[..., 2:4]], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1, y1, x2, y2] -> [x, y, w, h]."""
    xy1 = boxes[..., :2]
    return torch.cat([xy1, boxes[..., 2:4] - xy1], dim=-1)


def box_area(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes; `plus_one` uses (x2-x1+1)*(y2-y1+1)."""
    off = 1.0 if plus_one else 0.0
    return ((boxes[..., 2] - boxes[..., 0] + off)
            * (boxes[..., 3] - boxes[..., 1] + off))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor,
                 plus_one: bool = False) -> torch.Tensor:
    """IoU of (..., M, 4) and (..., N, 4) xyxy boxes -> (..., M, N), union
    clamped to >= 1e-8 (reference utils/metrics/metrics.py:10-48)."""
    off = 1.0 if plus_one else 0.0
    a = a.float()
    b = b.float()
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + off)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + off)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    union = (box_area(a, plus_one)[..., :, None]
             + box_area(b, plus_one)[..., None, :] - inter)
    return inter / union.clamp(min=1e-8)


def pairwise_iou_xywh(a: torch.Tensor, b: torch.Tensor,
                      plus_one: bool = False) -> torch.Tensor:
    """`pairwise_iou` of xywh boxes (the reference's bbox_iou with
    x1y1x2y2=False)."""
    return pairwise_iou(xywh_to_xyxy(a), xywh_to_xyxy(b), plus_one=plus_one)


def encode_boxes(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Faster-RCNN regression targets from xyxy example ROIs to xyxy GT
    boxes with the legacy +1 extents -> (..., 4) [dx, dy, dw, dh]."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h
    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h
    return torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                        torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)],
                       dim=-1)


def decode_boxes(rois_xywh: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply stage-2 deltas to xywh ROIs (ROI w/h bumped by +1 first, as
    reference operators/rrnet_operator.py:200-208). Returns xywh."""
    w = rois_xywh[..., 2] + 1.0
    h = rois_xywh[..., 3] + 1.0
    ctr_x = deltas[..., 0] * w + rois_xywh[..., 0] + w / 2.0
    ctr_y = deltas[..., 1] * h + rois_xywh[..., 1] + h / 2.0
    out_w = torch.exp(deltas[..., 2]) * w
    out_h = torch.exp(deltas[..., 3]) * h
    return torch.stack([ctr_x - out_w / 2.0, ctr_y - out_h / 2.0,
                        out_w, out_h], dim=-1)


def giou(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of (..., 4) xyxy boxes (the reference's
    `_giou_loss` before its (1 - giou).mean(); an inverted output box is
    clamped to zero extent first). Returns (...,)."""
    x1, y1, x2, y2 = output.unbind(-1)
    x1g, y1g, x2g, y2g = target.unbind(-1)
    x2 = torch.maximum(x1, x2)
    y2 = torch.maximum(y1, y2)
    xi1, yi1 = torch.maximum(x1, x1g), torch.maximum(y1, y1g)
    xi2, yi2 = torch.minimum(x2, x2g), torch.minimum(y2, y2g)
    xc1, yc1 = torch.minimum(x1, x1g), torch.minimum(y1, y1g)
    xc2, yc2 = torch.maximum(x2, x2g), torch.maximum(y2, y2g)
    inter = torch.where((yi2 > yi1) & (xi2 > xi1),
                        (xi2 - xi1) * (yi2 - yi1), 0.0)
    union = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - inter + 1e-7
    iou = inter / union
    area_c = (xc2 - xc1) * (yc2 - yc1) + 1e-7
    return iou - (area_c - union) / area_c


def giou_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean (1 - GIoU) (the reference's modules/loss/functional.py:158)."""
    return torch.mean(1.0 - giou(output, target))


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    c = boxes[..., :2]
    half = boxes[..., 2:4] / 2.0
    return torch.cat([c - half, c + half], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1, y1, x2, y2] -> [cx, cy, w, h]."""
    c = (boxes[..., :2] + boxes[..., 2:4]) / 2.0
    return torch.cat([c, boxes[..., 2:4] - boxes[..., :2]], dim=-1)


def scale_coords(img1_shape, coords: torch.Tensor,
                 img0_shape) -> torch.Tensor:
    """xyxy coords in a letterboxed `img1_shape` (h, w) mapped back to
    `img0_shape`, clamped at 0 (the reference's utils/functional.py:
    29-36)."""
    gain = max(img1_shape) / max(img0_shape)
    pad_x = (img1_shape[1] - img0_shape[1] * gain) / 2
    pad_y = (img1_shape[0] - img0_shape[0] * gain) / 2
    out = torch.stack([coords[..., 0] - pad_x, coords[..., 1] - pad_y,
                       coords[..., 2] - pad_x, coords[..., 3] - pad_y], -1)
    return (out / gain).clamp(min=0.0)
