"""RetinaNet, the anchor-based detector (port of
`rrnet_tpu/models/retinanet.py:19-48`, reference models/retinanet.py:8-38),
and its eval decode (`rrnet_tpu/evallib/infer.py:345-394`, reference
operators/retinanet_operator.py:179-258).

ResNet (l2, l3, l4) -> 3-level FPN -> the shared cls and loc conv towers
on every level, flattened to (B, sum(H*W*A), C): anchor-major within a
cell, cell-major within a level, level-major overall, the order of
`models.anchors.anchors_for_shape`. That is the JAX package's NHWC
reshape; from NCHW it is `permute(0, 2, 3, 1)` first. Module names follow
the flax scopes (`backbone`, `fpn`, `cls`, `loc`), so `utils.from_flax`
carries the JAX package's variables across.

The decode: sigmoid in f32, each anchor's best class, anchors whose
centre lies outside the image's valid extent scored 0, the top K per
image (the lower index first among equal scores, as `lax.top_k`), the
standardised deltas (0.1, 0.1, 0.2, 0.2) applied, valid = score > 0.1,
then class-agnostic hard NMS at 0.3 with the legacy +1 extents: the CUDA
kernel of `ops/hard_nms.py` on the card, one launch a forward, with no
host sync.

Spans (`utils.tracing`): `retinanet.backbone`, `retinanet.fpn` and
`retinanet.heads` in the forward, `retinanet.decode` (the candidates)
and `retinanet.nms` (NMS and the packed rows) in `decode`; the counter
`retinanet.anchors` adds the anchors a forward scores (B * N, from the
shapes, with no sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from rrnet_torch.models.backbones import get_backbone
from rrnet_torch.models.heads import RetinaNetHead
from rrnet_torch.models.modules import FPN
from rrnet_torch.ops.hard_nms import hard_nms
from rrnet_torch.ops.heatmap import topk_desc
from rrnet_torch.utils import tracing

SCORE_THRESHOLD = 0.1     # retinanet_operator.py: anchors scoring above
NMS_IOU = 0.3             # class-agnostic gpu_nms threshold
DELTA_STD = (0.1, 0.1, 0.2, 0.2)


def _flatten(x: torch.Tensor, c: int) -> torch.Tensor:
    """(B, A*c, H, W) -> (B, H*W*A, c) in the NHWC reshape order: a view
    where the map is channels-last (the eval path), a copy from NCHW."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, c)


class RetinaNet(nn.Module):
    def __init__(self, num_classes: int = 10, num_anchors: int = 9,
                 backbone: str = "resnet50", fpn_channels: int = 256,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = get_backbone(backbone, dtype=dtype)
        self.fpn = FPN(channels=fpn_channels, dtype=dtype)
        self.cls = RetinaNetHead(num_anchors * num_classes, fpn_channels,
                                 dtype=dtype)
        self.loc = RetinaNetHead(num_anchors * 4, fpn_channels, dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x (B, 3, H, W) -> (loc (B, N, 4), cls logits (B, N,
        num_classes)) in the compute dtype, N = sum_l H_l * W_l * A."""
        with tracing.span("retinanet.backbone"):
            _, l2, l3, l4 = self.backbone(x)
        with tracing.span("retinanet.fpn"):
            fms = self.fpn(l2, l3, l4)
        with tracing.span("retinanet.heads"):
            loc = torch.cat([_flatten(self.loc(fm), 4) for fm in fms], 1)
            cls = torch.cat([_flatten(self.cls(fm), self.num_classes)
                             for fm in fms], 1)
            tracing.count("retinanet.anchors", cls.shape[0] * cls.shape[1])
        return loc, cls


class Candidates(NamedTuple):
    """The decode's top K anchors per image, before NMS."""
    boxes: torch.Tensor     # (B, K, 4) xyxy f32, input pixels
    scores: torch.Tensor    # (B, K) f32 best-class probability
    classes: torch.Tensor   # (B, K) int64, 0-based
    valid: torch.Tensor     # (B, K) bool, score > SCORE_THRESHOLD


def candidates(loc: torch.Tensor, cls: torch.Tensor, anchors: torch.Tensor,
               valid_hw: torch.Tensor, topk: int) -> Candidates:
    """loc (B, N, 4), cls (B, N, C) logits, anchors (N, 4) xyxy f32 on the
    same device, valid_hw (B, 2) int [h, w] of each image's content."""
    prob = torch.sigmoid(cls.float())
    best, best_idx = prob.max(-1)
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    inside = ((acx[None] < valid_hw[:, 1:2]) & (acy[None] < valid_hw[:, 0:1]))
    best = torch.where(inside, best, 0.0)
    score, sel = topk_desc(best, topk)
    a = anchors[sel]                                         # (B, K, 4)
    d = torch.gather(loc, 1, sel[..., None].expand(-1, -1, 4)).float()
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    cx = a[..., 0] + 0.5 * aw + d[..., 0] * DELTA_STD[0] * aw
    cy = a[..., 1] + 0.5 * ah + d[..., 1] * DELTA_STD[1] * ah
    w = torch.exp(d[..., 2] * DELTA_STD[2]) * aw
    h = torch.exp(d[..., 3] * DELTA_STD[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    score = score.contiguous()
    return Candidates(boxes, score, torch.gather(best_idx, 1, sel),
                      score > SCORE_THRESHOLD)


def nms(c: Candidates) -> torch.Tensor:
    """The (B, K) keep mask: class-agnostic hard NMS over the valid
    candidates."""
    return hard_nms(c.boxes, c.scores, NMS_IOU, valid=c.valid, plus_one=True)


def decode(loc: torch.Tensor, cls: torch.Tensor, anchors: torch.Tensor,
           valid_hw: torch.Tensor, topk: int) -> torch.Tensor:
    """Candidates, NMS and the packed (B, K, 6) rows [x, y, w, h, score,
    cls + 1]; rows NMS dropped or scoring <= 0.1 get score -1."""
    with tracing.span("retinanet.decode"):
        c = candidates(loc, cls, anchors, valid_hw, topk)
    with tracing.span("retinanet.nms"):
        keep = nms(c) & c.valid
        b = c.boxes
        xywh = torch.cat([b[..., :2], b[..., 2:4] - b[..., :2]], -1)
        score = torch.where(keep, c.scores, -1.0)
        return torch.cat([xywh, score[..., None],
                          c.classes.float()[..., None] + 1.0], dim=-1)
