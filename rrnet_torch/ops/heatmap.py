"""CenterNet heatmap decode (port of `rrnet_tpu/ops/heatmap.py`).

Maps are NHWC at this interface, as in the JAX package: heatmaps
(B, H, W, C), wh/offset maps (B, H, W, 2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def peak_nms(hm: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only the local maxima of a (..., H, W, C) heatmap: a kxk
    max-pool with stride 1 and -inf padding, non-peak pixels set to 0
    (the reference's `_ctnet_nms`, operators/centernet_operator.py:
    204-210). The pool runs on the channels-first view."""
    *lead, h, w, c = hm.shape
    x = hm.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    hmax = F.max_pool2d(x, kernel, stride=1, padding=(kernel - 1) // 2)
    hmax = hmax.permute(0, 2, 3, 1).reshape(hm.shape)
    return torch.where(hmax == hm, hm, 0.0)


class Detections(NamedTuple):
    """Fixed-K decoded detections; boxes are xyxy in feature-map
    (stride-4) coordinates unless scaled by `scale_factor`."""
    boxes: torch.Tensor    # (B, K, 4) xyxy
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int32, 0-based class index
    xs: torch.Tensor       # (B, K) refined center x
    ys: torch.Tensor       # (B, K) refined center y


def topk_desc(x: torch.Tensor, k: int):
    """Top-k along the last dim with `jax.lax.top_k`'s tie rule: among
    equal values the lower index comes first. `torch.topk` promises no
    order among ties, and ties are real here (masked heatmap logits all
    sigmoid to exactly 0, NMS-dropped scores are all -inf), so this is a
    stable descending sort cut to k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_decode(hm: torch.Tensor, wh: torch.Tensor,
                offset: Optional[torch.Tensor], k: int = 1500,
                scale_factor: float = 1.0) -> Detections:
    """Global top-k over class x location of sigmoid(hm), center refined by
    the gathered offset (+0.5 without one), wh clamped to >= 0, boxes
    [cx - w/2, cy - h/2, cx + w/2, cy + h/2] * scale_factor.

    The flat index is (y * W + x) * C + cls over the NHWC map."""
    b, h, w, c = hm.shape
    probs = torch.sigmoid(hm).reshape(b, h * w * c)
    top_scores, top_idx = topk_desc(probs, k)
    cls = (top_idx % c).to(torch.int32)
    loc = top_idx // c                                   # y * W + x
    ys = (loc // w).float()
    xs = (loc % w).float()

    def gather_map(m):  # (B, H, W, 2) -> (B, K, 2)
        m = m.reshape(b, h * w, 2)
        return torch.gather(m, 1, loc[..., None].expand(-1, -1, 2))

    if offset is not None:
        off = gather_map(offset)
        xs = xs + off[..., 0]
        ys = ys + off[..., 1]
    else:
        xs = xs + 0.5
        ys = ys + 0.5
    wh_k = gather_map(wh).clamp(min=0.0)
    half_w = wh_k[..., 0] / 2.0
    half_h = wh_k[..., 1] / 2.0
    boxes = torch.stack([xs - half_w, ys - half_h, xs + half_w, ys + half_h],
                        dim=-1) * scale_factor
    return Detections(boxes=boxes, scores=top_scores, classes=cls,
                      xs=xs * scale_factor, ys=ys * scale_factor)


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Gather (B, L, C) features at (B, N) flat indices -> (B, N, C)
    (the reference's `_gather_feat`, models/rrnet.py:82-91)."""
    ind = ind.long()[..., None].expand(-1, -1, feat.shape[-1])
    return torch.gather(feat, 1, ind)


def gather_map_at(feat_map: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Gather an NHWC map (B, H, W, C) at (B, N) flat y*W+x indices ->
    (B, N, C) (the reference's `_transpose_and_gather_feat`,
    models/rrnet.py:111-115)."""
    b, h, w, c = feat_map.shape
    return gather_feat(feat_map.reshape(b, h * w, c), ind)
