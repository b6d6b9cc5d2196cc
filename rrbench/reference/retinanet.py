"""The plain float32 reference of RetinaNet (Lin et al., "Focal Loss for
Dense Object Detection", ICCV 2017) as the RRNet repository builds it for
VisDrone (https://github.com/ouc-ocean-group/RRNet: configs/
retinanet_config.py, models/retinanet.py, detectors/retinanet_detector.py,
backbones/resnet.py, modules/fpn.py, modules/anchor.py, and the eval
decode of operators/retinanet_operator.py:179-258). NCHW, no kernel, the
building blocks of `reference/layers.py` (TF32 off under
`f32_numerics`).

  * ResNet: 7x7/2 stem, BN, ReLU, 3x3/2 max pool, bottleneck stages of
    64/128/256/512 planes (expansion 4; ResNet-50 is [3, 4, 6, 3]), the
    stride on each stage's first 3x3; the stages at strides 8, 16 and 32
    (512, 1024 and 2048 channels) feed the pyramid.
  * FPN: 1x1 laterals with bias onto 256 channels; the coarser level
    resized (bilinear, half-pixel) to the finer one's size and added; a
    3x3 smoothing conv on p4 and p3; p5 is its lateral.
  * Heads: two towers shared over the levels, 4 x (3x3 conv-256, ReLU)
    and a 3x3 out conv, one to A * C class logits and one to A * 4
    deltas; each level flattened channels-last, (B, H*W*A, C), levels
    concatenated from the finest.
  * Anchors: levels 3-5 (strides 8, 16, 32), sizes (16, 64, 128) (the
    operator's VisDrone override), 3 ratios x 3 scales a cell, ratio
    major, centred at (i + 0.5) * stride, level shapes by ceil division.
  * Decode: sigmoid, each anchor's best class, anchors whose centre lies
    outside the image's content scored 0, the top K by score, the deltas
    on them with std (0.1, 0.1, 0.2, 0.2) and mean 0, valid = score >
    0.1, then class-agnostic hard NMS at IoU 0.3 with the legacy +1
    extents (gpu_nms's arithmetic), greedy in score order.

Departures from those modules, each named:

  * Parameter and buffer names are the port's (`backbone.layer{s}_{b}`,
    `fpn.lat5`, `cls.conv0`, ...), so that one state dict loads into both.
  * The anchors' base boxes are rounded to float32 before the shifts are
    added, as the port and the JAX package round them; the upstream
    module adds in float64 and rounds once. At a 1152x1920 input the two
    differ in 36,960 of 1,632,960 coordinates, by at most one float32
    ulp of the larger of the coordinate and its base offset (1.2e-4 px
    at most). The reference takes the port's rounding so that its decode
    of the port's outputs can be held to the port's bit for bit.
  * The top K is a stable descending sort cut to K: among equal scores
    the lower anchor index comes first (the JAX package's `lax.top_k`).
  * The image's content extent (`valid_hw`) masks anchors, since the
    frames are padded to a shape bucket.
  * The NMS keeps a fixed K with a validity mask: invalid slots neither
    keep nor suppress.
  * The max pool pads with -inf (torch's `max_pool2d`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rrbench.reference.layers import (BatchNorm, Bottleneck, Conv2d,
                                      resize_bilinear)

RESNET_LAYERS = {"resnet10": (1, 1, 1, 1), "resnet50": (3, 4, 6, 3)}
SCORE_THRESHOLD = 0.1
NMS_IOU = 0.3
DELTA_STD = (0.1, 0.1, 0.2, 0.2)


class ResNet(nn.Module):
    def __init__(self, layers: Tuple[int, int, int, int]):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin, self.stages = 64, []
        for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 layers)):
            names = []
            for b in range(blocks):
                stride = 2 if s > 0 and b == 0 else 1
                self.add_module(f"layer{s + 1}_{b}",
                                Bottleneck(cin, planes, stride))
                cin = planes * 4
                names.append(f"layer{s + 1}_{b}")
            self.stages.append(names)

    def forward(self, x):
        """x -> the stride-8, 16 and 32 stages' outputs."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs[1:]


class FPN(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), channels: int = 256):
        super().__init__()
        c3, c4, c5 = in_channels
        self.lat5 = Conv2d(c5, channels, 1)
        self.lat4 = Conv2d(c4, channels, 1)
        self.top4 = Conv2d(channels, channels, 3, 1, 1)
        self.lat3 = Conv2d(c3, channels, 1)
        self.top3 = Conv2d(channels, channels, 3, 1, 1)

    def forward(self, c3, c4, c5):
        p5 = self.lat5(c5)
        p4 = self.top4(resize_bilinear(p5, c4.shape[-2:]) + self.lat4(c4))
        p3 = self.top3(resize_bilinear(p4, c3.shape[-2:]) + self.lat3(c3))
        return p3, p4, p5


class Tower(nn.Module):
    def __init__(self, planes: int, channels: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", Conv2d(channels, channels, 3, 1, 1))
        self.out = Conv2d(channels, planes, 3, 1, 1)

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.out(x)


def _flatten(x: torch.Tensor, c: int) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, c)


class RetinaNet(nn.Module):
    """`forward(x)` -> (loc (B, N, 4), cls logits (B, N, C)), float32."""

    def __init__(self, num_classes: int = 10, num_anchors: int = 9,
                 backbone: str = "resnet50", channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet(RESNET_LAYERS[backbone])
        self.fpn = FPN(channels=channels)
        self.cls = Tower(num_anchors * num_classes, channels)
        self.loc = Tower(num_anchors * 4, channels)

    def forward(self, x):
        fms = self.fpn(*self.backbone(x))
        loc = torch.cat([_flatten(self.loc(f), 4) for f in fms], 1)
        cls = torch.cat([_flatten(self.cls(f), self.num_classes)
                         for f in fms], 1)
        return loc, cls


# ------------------------------------------------------------- anchors

def base_anchors(size: float, ratios: Sequence[float],
                 scales: Sequence[float]) -> np.ndarray:
    """(A, 4) xyxy boxes centred at the origin, ratio-major: each of
    area (size * scale)^2 with h / w = ratio; rounded to float32 (the
    module docstring)."""
    ratios, scales = np.asarray(ratios, np.float64), np.asarray(scales,
                                                               np.float64)
    side = size * np.tile(scales, len(ratios))
    ratio = np.repeat(ratios, len(scales))
    w = np.sqrt(side * side / ratio)
    h = w * ratio
    return np.stack([-0.5 * w, -0.5 * h, w - 0.5 * w, h - 0.5 * h],
                    1).astype(np.float32)


def anchors(shape: Tuple[int, int], levels=(3, 4, 5), sizes=(16, 64, 128),
            ratios=(0.5, 1.0, 2.0),
            scales=(1.0, 2 ** (1 / 3), 2 ** (2 / 3))) -> np.ndarray:
    """(sum_l H_l * W_l * A, 4) xyxy float32 anchors of an input shape:
    level-major, then row-major cells, then the cell's A anchors."""
    out = []
    for level, size in zip(levels, sizes):
        stride = 2 ** level
        fh, fw = -(-shape[0] // stride), -(-shape[1] // stride)
        cx = (np.arange(fw) + 0.5) * stride
        cy = (np.arange(fh) + 0.5) * stride
        cx, cy = np.meshgrid(cx, cy)
        shift = np.stack([cx.ravel(), cy.ravel(), cx.ravel(), cy.ravel()], 1)
        base = base_anchors(size, ratios, scales).astype(np.float64)
        out.append((shift[:, None, :] + base[None]).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


# -------------------------------------------------------------- decode

class Candidates(NamedTuple):
    boxes: torch.Tensor     # (B, K, 4) xyxy float32, input pixels
    scores: torch.Tensor    # (B, K) best-class probability
    classes: torch.Tensor   # (B, K) int64, 0-based
    valid: torch.Tensor     # (B, K) bool, score > 0.1


def candidates(loc: torch.Tensor, cls: torch.Tensor, anchor: torch.Tensor,
               valid_hw: torch.Tensor, k: int) -> Candidates:
    """Each image's top k: loc (B, N, 4) deltas, cls (B, N, C) logits,
    anchor (N, 4) on their device, valid_hw (B, 2) each content's
    [h, w]. A batch at once, so that every elementwise operation runs
    over tensors of the shapes the port's decode has (on the CPU,
    vectorised loops round transcendental functions differently at a
    tensor's tail)."""
    prob = torch.sigmoid(cls.float())
    best, label = prob.max(-1)
    ctr_x = (anchor[:, 0] + anchor[:, 2]) / 2
    ctr_y = (anchor[:, 1] + anchor[:, 3]) / 2
    inside = ((ctr_x[None] < valid_hw[:, 1:2])
              & (ctr_y[None] < valid_hw[:, 0:1]))
    best = torch.where(inside, best, 0.0)
    score, idx = torch.sort(best, dim=-1, descending=True, stable=True)
    score, idx = score[:, :k].contiguous(), idx[:, :k]
    a = anchor[idx]
    d = torch.gather(loc, 1, idx[..., None].expand(-1, -1, 4)).float()
    widths = a[..., 2] - a[..., 0]
    heights = a[..., 3] - a[..., 1]
    ctr_x = a[..., 0] + 0.5 * widths
    ctr_y = a[..., 1] + 0.5 * heights
    pred_x = ctr_x + d[..., 0] * DELTA_STD[0] * widths
    pred_y = ctr_y + d[..., 1] * DELTA_STD[1] * heights
    pred_w = torch.exp(d[..., 2] * DELTA_STD[2]) * widths
    pred_h = torch.exp(d[..., 3] * DELTA_STD[3]) * heights
    boxes = torch.stack([pred_x - 0.5 * pred_w, pred_y - 0.5 * pred_h,
                         pred_x + 0.5 * pred_w, pred_y + 0.5 * pred_h], -1)
    return Candidates(boxes, score, torch.gather(label, 1, idx),
                      score > SCORE_THRESHOLD)


def nms(boxes: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float = NMS_IOU) -> torch.Tensor:
    """Greedy class-agnostic hard NMS over boxes (K, 4) already in
    descending score order: a valid box is kept unless a kept box before
    it overlaps it with IoU > thr (+1 extents). Returns the (K,) keep
    mask on the boxes' device."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    w = (torch.minimum(x2[:, None], x2[None]) -
         torch.maximum(x1[:, None], x1[None]) + 1.0).clamp(min=0.0)
    h = (torch.minimum(y2[:, None], y2[None]) -
         torch.maximum(y1[:, None], y1[None]) + 1.0).clamp(min=0.0)
    inter = w * h
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    over = (inter / (area[:, None] + area[None] - inter)
            > iou_threshold).cpu().numpy()
    ok = valid.cpu().numpy()
    keep = np.zeros(len(ok), bool)
    gone = np.zeros(len(ok), bool)
    for i in range(len(ok)):
        if ok[i] and not gone[i]:
            keep[i] = True
            gone |= over[i]
    return torch.from_numpy(keep).to(boxes.device)


def packed(c: Candidates, keep: torch.Tensor) -> torch.Tensor:
    """(B, K, 6) [x, y, w, h, score, class + 1] of every slot, score -1
    where the slot was not kept."""
    b = c.boxes
    xywh = torch.cat([b[..., :2], b[..., 2:] - b[..., :2]], -1)
    score = torch.where(keep, c.scores, -1.0)
    return torch.cat([xywh, score[..., None],
                      c.classes.float()[..., None] + 1.0], -1)


def rows(slots: torch.Tensor, scale_hw: Tuple[float, float] = (1.0, 1.0)
         ) -> np.ndarray:
    """An image's rows from its (K, 6) slots: the kept ones, in original
    pixels (x and w over the width's scale, y and h over the height's),
    by descending score, ties in slot order."""
    r = slots.cpu().numpy().astype(np.float64)
    r = r[r[:, 4] >= 0.0]
    r[:, [0, 2]] /= scale_hw[1]
    r[:, [1, 3]] /= scale_hw[0]
    return r[np.argsort(-r[:, 4], kind="stable")]


@torch.no_grad()
def decode(loc, cls, anchor, valid_hw, k: int):
    """A batch's candidates and each image's NMS keep mask (B, K)."""
    c = candidates(loc, cls, anchor, valid_hw, k)
    keep = torch.stack([nms(c.boxes[i], c.valid[i])
                        for i in range(c.boxes.shape[0])])
    return c, keep
