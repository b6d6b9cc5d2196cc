"""Plain operations of the reference: decode, hard NMS, ROI-align, box
coding, the YUV 4:2:0 transport, target rendering and the losses.

A frozen copy of the port's plain versions (its `ops.heatmap`,
`ops.nms`, `ops.roi_align`, `ops.box`, `data.yuv420`, `ops.targets`,
`losses`), float32, with no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


# ------------------------------------------------------------- decode

class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) xyxy, stride-4 feature coords
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int32, 0-based


def topk_desc(x: torch.Tensor, k: int):
    """Top-k along the last dim, the lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def mask_heatmap_extent(hm: torch.Tensor, valid_hw: torch.Tensor,
                        scale_factor: int = 4) -> torch.Tensor:
    """(B, H, W, C) logits outside each image's valid stride-s extent set
    to -1e9."""
    _, h, w, _ = hm.shape
    fy = torch.ceil(valid_hw[:, 0].float() / scale_factor)[:, None, None]
    fx = torch.ceil(valid_hw[:, 1].float() / scale_factor)[:, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=hm.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=hm.device)[None, None, :]
    return torch.where(((ys < fy) & (xs < fx))[..., None], hm, -1e9)


def topk_decode(hm, wh, offset, k: int) -> Detections:
    """Global top-k over class x location of sigmoid(hm) (flat index
    (y * W + x) * C + cls), the centre refined by the offset, wh clamped
    at 0, boxes [cx - w/2, cy - h/2, cx + w/2, cy + h/2]."""
    b, h, w, c = hm.shape
    probs = torch.sigmoid(hm.float()).reshape(b, h * w * c)
    scores, idx = topk_desc(probs, k)
    cls = (idx % c).to(torch.int32)
    loc = idx // c

    def at(m):
        m = m.float().reshape(b, h * w, 2)
        return torch.gather(m, 1, loc[..., None].expand(-1, -1, 2))

    off = at(offset)
    xs = (loc % w).float() + off[..., 0]
    ys = (loc // w).float() + off[..., 1]
    size = at(wh).clamp(min=0.0)
    hw_, hh = size[..., 0] / 2.0, size[..., 1] / 2.0
    boxes = torch.stack([xs - hw_, ys - hh, xs + hw_, ys + hh], dim=-1)
    return Detections(boxes, scores, cls)


# ---------------------------------------------------------------- boxes

def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., M, 4) and (..., N, 4) xyxy boxes, union >= 1e-8."""
    a, b = a.float(), b.float()
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]))
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]))
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-8)


def decode_boxes(rois_xywh: torch.Tensor, deltas: torch.Tensor):
    """Stage-2 deltas on xywh ROIs (their w/h bumped by +1); xywh out."""
    w = rois_xywh[..., 2] + 1.0
    h = rois_xywh[..., 3] + 1.0
    cx = deltas[..., 0] * w + rois_xywh[..., 0] + w / 2.0
    cy = deltas[..., 1] * h + rois_xywh[..., 1] + h / 2.0
    ow = torch.exp(deltas[..., 2]) * w
    oh = torch.exp(deltas[..., 3]) * h
    return torch.stack([cx - ow / 2.0, cy - oh / 2.0, ow, oh], dim=-1)


# ------------------------------------------------------------------ NMS

def score_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descending score order, ties to the lower index, -0.0 equal to
    +0.0, invalid boxes as -inf, NaN last."""
    masked = torch.where(valid, scores.float(), -torch.inf)
    masked = torch.where(masked == 0.0, 0.0, masked)
    bits = masked.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    key = torch.where(torch.isnan(masked), -(2 ** 31) + 1, key)
    return torch.sort(key, dim=1, descending=True, stable=True).indices


def hard_nms(boxes, scores, iou_threshold: float,
             valid: Optional[torch.Tensor] = None,
             class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy hard NMS (suppress at IoU > thr, within a class when
    class_ids is given) as a fixpoint: keep <- valid & no higher-ranked
    kept box overlaps. Returns the (B, K) keep mask."""
    _, k = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    order = score_order(scores, valid)
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    vs = torch.gather(valid, 1, order)
    iou = pairwise_iou(bs, bs)
    if class_ids is not None:
        cs = torch.gather(class_ids, 1, order)
        iou = torch.where(cs[:, :, None] == cs[:, None, :], iou, 0.0)
    idx = torch.arange(k, device=scores.device)
    can = ((iou > iou_threshold) & (idx[:, None] < idx[None, :])
           & vs[:, :, None]).float()
    keep = vs
    for _ in range(k):
        nxt = vs & ~(torch.bmm(keep.float()[:, None, :], can)[:, 0] > 0.0)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    return torch.zeros_like(keep).scatter(1, order, keep)


# ------------------------------------------------------------ ROI-align

def roi_align(feat: torch.Tensor, rois: torch.Tensor,
              output_size: Tuple[int, int] = (3, 3),
              sampling_ratio: int = 2) -> torch.Tensor:
    """Legacy (aligned=False) ROI-align on a fixed 2x2 grid a bin: feat
    (B, H, W, C), rois (B, R, 4) xyxy -> (B, R, oh, ow, C)."""
    bsz, h, w, c = feat.shape
    r = rois.shape[1]
    oh, ow = output_size
    s = sampling_ratio
    dev = rois.device
    x1, y1, x2, y2 = rois.unbind(-1)
    bin_w = (x2 - x1).clamp(min=1.0) / ow
    bin_h = (y2 - y1).clamp(min=1.0) / oh
    sub = (torch.arange(s, device=dev, dtype=torch.float32) + 0.5) / s
    iy = torch.arange(oh, device=dev)[:, None] + sub[None, :]
    ix = torch.arange(ow, device=dev)[:, None] + sub[None, :]
    ys = y1[..., None, None] + iy * bin_h[..., None, None]
    xs = x1[..., None, None] + ix * bin_w[..., None, None]
    grid = (bsz, r, oh, s, ow, s)
    ys = ys[:, :, :, :, None, None].expand(grid).reshape(bsz, -1)
    xs = xs[:, :, None, None, :, :].expand(grid).reshape(bsz, -1)
    oob = (ys < -1.0) | (ys > h) | (xs < -1.0) | (xs > w)
    ys = ys.clamp(0.0, h - 1)
    xs = xs.clamp(0.0, w - 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    y0i = torch.nan_to_num(y0, nan=0.0).long()
    x0i = torch.nan_to_num(x0, nan=0.0).long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    ly, lx = ys - y0, xs - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(bsz, h * w, c)
    bidx = torch.arange(bsz, device=dev)[:, None]

    def at(yi, xi):
        return flat[bidx, yi * w + xi].float()

    val = (at(y0i, x0i) * (hy * hx)[..., None]
           + at(y0i, x1i) * (hy * lx)[..., None]
           + at(y1i, x0i) * (ly * hx)[..., None]
           + at(y1i, x1i) * (ly * lx)[..., None])
    val = torch.where(oob[..., None], 0.0, val)
    return val.reshape(*grid, c).mean(dim=(3, 5))


# ------------------------------------------------------ YUV 4:2:0 wire

def pack_yuv420(rgb: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB -> (B, 1.5*H*W) uint8 planar I420 (BT.601
    studio swing, chroma point-sampled at each 2x2's top left)."""
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    rs, gs, bs = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    cb = 128.0 - 0.148 * rs - 0.291 * gs + 0.439 * bs
    cr = 128.0 + 0.439 * rs - 0.368 * gs - 0.071 * bs
    n = rgb.shape[0]
    parts = [np.clip(p + 0.5, 0, 255).astype(np.uint8).reshape(n, -1)
             for p in (y, cb, cr)]
    return np.concatenate(parts, axis=1)


def _cosited_up2x(c: torch.Tensor, dim: int) -> torch.Tensor:
    n = c.shape[dim]
    nxt = torch.cat([c.narrow(dim, 1, n - 1), c.narrow(dim, n - 1, 1)], dim)
    pair = torch.stack([c, (c + nxt) * 0.5], dim=dim + 1)
    shape = list(c.shape)
    shape[dim] *= 2
    return pair.reshape(shape)


def unpack_yuv420(flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 1.5*h*w) uint8 I420 -> (B, h, w, 3) float RGB in [0, 255]."""
    n, q = flat.shape[0], h * w // 4
    y = (flat[:, :h * w].reshape(n, h, w).float() - 16.0) * (255.0 / 219.0)
    uv = torch.stack([flat[:, h * w:h * w + q].reshape(n, h // 2, w // 2),
                      flat[:, h * w + q:].reshape(n, h // 2, w // 2)],
                     dim=-1).float()
    uv = _cosited_up2x(_cosited_up2x(uv, 1), 2)
    cb, cr = uv[..., 0] - 128.0, uv[..., 1] - 128.0
    rgb = torch.stack([y + 1.59602 * cr, y - 0.39176 * cb - 0.81297 * cr,
                       y + 2.01723 * cb], dim=-1)
    return rgb.clamp(0.0, 255.0)
