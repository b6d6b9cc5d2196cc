"""The yardstick's arithmetic: model FLOPs, the hard-NMS work bound, the
card's peaks, and the guard that no share of a peak passes 100%.

FLOPs are counted by `FlopCounterMode` over the benchmark's frozen
reference on meta tensors (a multiply-add counts two), so the count does
not change with whatever implements a layer in the port: the backbone,
attention, stage-1 heads and the stage-2 head (decode, NMS and ROI-align
do no matrix work). `hard_nms_work` is a copy of `chip_smoke.py`'s
count of what hard NMS needs on its inputs.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# adds, mins and compares outside the tensor cores: 67e12 FMA-counted
# float32 operations a second, an FMA counting two
NON_FMA_OPS_PER_S = 33.5e12
HARD_NMS_SCREEN_OPS = 4     # class compare, rank compare, validity, select
HARD_NMS_IOU_OPS = 14       # the IoU test of one pair
HARD_NMS_AREA_OPS = 3       # one box's area


class ShareOverPeak(ValueError):
    """A share of a roofline or of a peak read above 100%: the work is
    counted too high or the time leaves out part of it."""


def share(value_pct: float, name: str) -> float:
    """`value_pct`, refused above 100."""
    if not math.isfinite(value_pct) or value_pct > 100.0:
        raise ShareOverPeak(f"{name} reads {value_pct}% of its peak")
    return value_pct


def _stage1_and_2(model, x, rois: int):
    feats, hms, whs, offs = model.stage1(x)
    c = feats[-1].shape[1]
    roi_feat = torch.empty(x.shape[0] * rois, c, 3, 3, device="meta",
                           requires_grad=x.requires_grad)
    s2 = model.head_detector(roi_feat)
    return [*hms, *whs, *offs, s2]


def forward_flops(model, shape: Tuple[int, int, int, int]) -> float:
    """FLOPs of one forward of the reference `model` (on meta) at input
    shape (B, 3, H, W), stage 2 on its R ROIs an image."""
    x = torch.empty(shape, device="meta")
    with FlopCounterMode(display=False) as fc:
        _stage1_and_2(model, x, model.stage2_rois)
    return float(fc.get_total_flops())


def meta_model(build):
    """The reference model of `build()` on meta tensors."""
    with torch.device("meta"):
        return build()


def hard_nms_work(boxes, iou_threshold: float, valid=None, class_ids=None,
                  plus_one: bool = False) -> dict:
    """What hard NMS on these inputs needs at the least: the pairs of
    valid boxes, of them those of one class, of those the ones that take
    the IoU test (iw > 0 and ih > 0), the operations that makes, the
    bytes of the inputs and the keep mask (boxes, scores, valid, class
    ids read once, keep written once), and the bound in ms they give."""
    bsz, k = boxes.shape[:2]
    off = 1.0 if plus_one else 0.0
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    n_valid = valid_pairs = same = tested = 0
    for i in range(bsz):
        b = boxes[i]
        pair = upper
        if valid is not None:
            pair = pair & valid[i][:, None] & valid[i][None, :]
            n_valid += int(valid[i].sum())
        else:
            n_valid += k
        one = pair
        if class_ids is not None:
            one = pair & (class_ids[i][:, None] == class_ids[i][None, :])
        if iou_threshold >= 0:
            iw = (torch.minimum(b[:, None, 2], b[None, :, 2])
                  - torch.maximum(b[:, None, 0], b[None, :, 0]) + off)
            ih = (torch.minimum(b[:, None, 3], b[None, :, 3])
                  - torch.maximum(b[:, None, 1], b[None, :, 1]) + off)
            test = one & (iw > 0) & (ih > 0)
        else:
            test = one
        valid_pairs += int(pair.sum())
        same += int(one.sum())
        tested += int(test.sum())
    extra = 2 if plus_one else 0
    ops = ((valid_pairs if class_ids is not None else 0)
           + HARD_NMS_SCREEN_OPS * same
           + (HARD_NMS_IOU_OPS + extra) * tested
           + (HARD_NMS_AREA_OPS + extra) * n_valid
           + bsz * k * math.log2(max(k, 2)))
    nbytes = bsz * k * (16 + 4 + (1 if valid is not None else 0)
                        + (4 if class_ids is not None else 0) + 1)
    bound_ops = ops / NON_FMA_OPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"valid_pairs": valid_pairs, "same_class_pairs": same,
            "iou_tested_pairs": tested, "ops": ops, "bytes": nbytes,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def batch_bound_ms(per_image: Sequence[dict]) -> float:
    """The bound of one launch over these images' candidates: their
    operations and bytes add."""
    ops = sum(w["ops"] for w in per_image)
    nbytes = sum(w["bytes"] for w in per_image)
    return max(ops / NON_FMA_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
