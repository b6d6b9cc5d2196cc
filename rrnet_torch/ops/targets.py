"""CenterNet target rendering on the device (port of
`rrnet_tpu/ops/targets.py:35-176`).

The whole batch's (B, H, W, C) gaussian heatmaps are rendered as a masked
max over objects, in chunks of `chunk` objects so that memory stays
bounded (the JAX package's `scan` over chunks is a loop here). Parity
with the reference's CPU splat loop, as in the JAX package: CornerNet's
`gaussian_radius` with its `/2` convention, floored integer centres with
the sub-pixel residual as the offset target, the window |dx|, |dy| <= r,
`ind = cy * W + cx` clipped into the map, and `class_agnostic` for the
two-stage single-class map. Maps are NHWC, as the model's head outputs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet gaussian radius, the least of the three roots, with the
    reference's (b + sqrt(disc)) / 2 (not / (2a)) convention."""
    h = height.float()
    w = width.float()

    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt((b1 * b1 - 4 * c1).clamp(min=0.0))
    r1 = (b1 + sq1) / 2.0

    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    sq2 = torch.sqrt((b2 * b2 - 16 * c2).clamp(min=0.0))
    r2 = (b2 + sq2) / 2.0

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    sq3 = torch.sqrt((b3 * b3 - 4 * a3 * c3).clamp(min=0.0))
    r3 = (b3 + sq3) / 2.0

    return torch.minimum(torch.minimum(r1, r2), r3)


class CenterNetTargets(NamedTuple):
    hm: torch.Tensor        # (B, H, W, C) gaussian heatmap in [0, 1]
    wh: torch.Tensor        # (B, N, 2) box width/height at feature scale
    ind: torch.Tensor       # (B, N) int64 flat centre index y*W + x
    offset: torch.Tensor    # (B, N, 2) sub-pixel centre offset
    reg_mask: torch.Tensor  # (B, N) f32 validity of each slot


def render_batch(annos: torch.Tensor, valid: torch.Tensor,
                 feat_shape: Tuple[int, int], scale_factor: int = 4,
                 num_classes: int = 10, chunk: int = 32,
                 class_agnostic: bool = False) -> CenterNetTargets:
    """Targets of a batch: annos (B, N, >=6) [x, y, w, h, score, cls, ...]
    in input pixels with cls in 1..num_classes, valid (B, N) bool,
    feat_shape (H, W) of the stride-`scale_factor` map."""
    fh, fw = feat_shape
    bsz, n = annos.shape[:2]
    dev = annos.device
    s = float(scale_factor)
    annos = annos.float()

    x1 = annos[..., 0] / s
    y1 = annos[..., 1] / s
    x2 = (annos[..., 0] + annos[..., 2]) / s
    y2 = (annos[..., 1] + annos[..., 3]) / s
    bw = x2 - x1
    bh = y2 - y1

    wh = torch.stack([bw, bh], dim=-1)
    cx = (x1 + x2) / 2.0
    cy = (y1 + y2) / 2.0
    cx_int = torch.floor(cx)
    cy_int = torch.floor(cy)
    offset = torch.stack([cx - cx_int, cy - cy_int], dim=-1)
    reg_mask = (bh > 0) & (bw > 0) & valid
    ind = (cy_int * fw + cx_int).to(torch.int64).clamp(0, fh * fw - 1)

    radius = gaussian_radius(torch.ceil(bh), torch.ceil(bw))
    radius = torch.floor(radius).clamp(min=0.0)

    if class_agnostic:
        cls_idx = torch.zeros((bsz, n), dtype=torch.int64, device=dev)
        c_out = 1
    else:
        cls_idx = (annos[..., 5].to(torch.int32) - 1).clamp(
            0, num_classes - 1).long()
        c_out = num_classes

    px = torch.arange(fw, dtype=torch.float32, device=dev)[None, None, None, :]
    py = torch.arange(fh, dtype=torch.float32, device=dev)[None, None, :, None]
    hm = torch.zeros((bsz, fh, fw, c_out), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        ccx = cx_int[:, sl, None, None]              # (B, chunk, 1, 1)
        ccy = cy_int[:, sl, None, None]
        cr = radius[:, sl, None, None]
        dx = px - ccx
        dy = py - ccy
        diameter = 2.0 * cr + 1.0
        sigma = diameter / 6.0
        g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
        window = (dx.abs() <= cr) & (dy.abs() <= cr)
        g = torch.where(window & reg_mask[:, sl, None, None], g, 0.0)
        onehot = torch.nn.functional.one_hot(cls_idx[:, sl], c_out).float()
        contrib = (g[..., None] * onehot[:, :, None, None, :]).amax(dim=1)
        hm = torch.maximum(hm, contrib)

    return CenterNetTargets(hm=hm, wh=wh, ind=ind, offset=offset,
                            reg_mask=reg_mask.float())


def render_centernet_targets(annos: torch.Tensor, valid: torch.Tensor,
                             feat_shape: Tuple[int, int],
                             scale_factor: int = 4, num_classes: int = 10,
                             chunk: int = 32, class_agnostic: bool = False
                             ) -> CenterNetTargets:
    """The targets of one image (the JAX package's per-image function,
    which `render_batch` vmaps): annos (N, >=6), valid (N,); the fields
    without the batch axis, hm (H, W, C)."""
    t = render_batch(annos[None], valid[None], feat_shape, scale_factor,
                     num_classes, chunk, class_agnostic)
    return CenterNetTargets(*(f[0] for f in t))
