"""Fixed-shape NMS (port of `rrnet_tpu/ops/nms.py:46-229`).

Every function takes a batch of fixed-K box sets with optional validity
masks and class ids, and returns fixed-K results, as the JAX package's
functions do under `vmap`. Per-class behaviour gates suppression and
decay to boxes of the same class.

`soft_nms` here is the plain sequential version: the semantic reference
of the CUDA kernel in `ops/soft_nms.py`, which runs the same loop.
`batched_nms` runs `ops.hard_nms.hard_nms`: the plain version here on
the CPU, the CUDA kernel on the card (no fallback).
"""

from __future__ import annotations

from typing import Optional

import torch

from rrnet_torch.ops.box import pairwise_iou
from rrnet_torch.ops.heatmap import topk_desc

_METHODS = {"linear": 1, "gaussian": 2, "hard": 0}
NEG = -1e30   # score of invalid slots (pallas_nms.py `_NEG`)


def hard_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None,
             class_ids: Optional[torch.Tensor] = None,
             plus_one: bool = False) -> torch.Tensor:
    """Greedy hard NMS (suppress on iou > thr) in the fixpoint form of
    `rrnet_tpu/ops/nms.py:89-104`: iterate
        keep <- valid & ~any_higher_scored_kept_overlap(keep)
    until it stops changing; the greedy keep set is its unique fixpoint.

    boxes (B, K, 4) xyxy, scores (B, K), valid/class_ids (B, K) or None.
    Returns the (B, K) bool keep mask."""
    bsz, k = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    # score-descending order, lower index first among ties (jnp.argsort)
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    iou = pairwise_iou(boxes_s, boxes_s, plus_one=plus_one)
    if class_ids is not None:
        cls_s = torch.gather(class_ids, 1, order)
        iou = torch.where(cls_s[:, :, None] == cls_s[:, None, :], iou, 0.0)
    idx = torch.arange(k, device=scores.device)
    # can[b, i, j]: a kept i would suppress the lower-ranked j
    can = ((iou > iou_threshold) & (idx[:, None] < idx[None, :])
           & valid_s[:, :, None]).float()

    keep = valid_s
    for _ in range(k):
        supp = torch.bmm(keep.float()[:, None, :], can)[:, 0] > 0.0
        nxt = valid_s & ~supp
        if torch.equal(nxt, keep):
            break
        keep = nxt
    return torch.zeros_like(keep).scatter(1, order, keep)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             class_ids: Optional[torch.Tensor] = None, *,
             sigma: float = 0.5, iou_threshold: float = 0.3,
             score_threshold: float = 0.001, method: str = "gaussian",
             max_out: Optional[int] = None, return_work: bool = False):
    """Bodla soft-NMS over a batch of fixed-K box sets, step by step with
    the arithmetic of the serial Pallas kernel
    (`rrnet_tpu/ops/pallas_nms.py:50-153`).

    Each of min(max_out, K) steps picks the first index holding the max
    among active unselected slots (stopping when none is left), marks it
    selected with rank = step, decays every other active unselected slot
    by w(IoU) (legacy +1 extents; gated to the same class when
    class_ids is given), and deactivates a slot only when it overlaps
    the pick and its decayed score fell below score_threshold.

    boxes (B, K, 4) xyxy f32, scores (B, K) f32, valid (B, K) bool or
    None, class_ids (B, K) int or None. Returns (new_scores f32 with NEG
    for invalid slots, keep bool, rank int32 with K where unranked).
    With return_work, also a (B, 2) int64 count summed over the steps:
    the candidate slots (active, unselected), which each step's argmax
    and overlap test touch, and of those the slots that overlap the pick
    (same class when gated), which take the decay's arithmetic."""
    bsz, k = scores.shape
    dev = scores.device
    method_id = _METHODS[method]
    steps = k if max_out is None else min(max_out, k)
    if valid is None:
        valid = torch.ones((bsz, k), dtype=torch.bool, device=dev)
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    cur = torch.where(valid, scores.float(), torch.full_like(x1, NEG))
    active = valid.clone()
    selected = torch.zeros_like(valid)
    rank = torch.full((bsz, k), k, dtype=torch.int32, device=dev)
    idx = torch.arange(k, device=dev)
    work = torch.zeros((bsz, 2), dtype=torch.int64, device=dev)

    def pick(v, m):
        return torch.gather(v, 1, m)              # (B, 1)

    for step in range(steps):
        open_ = active & ~selected
        if return_work:
            work[:, 0] += open_.sum(1)
        cand = torch.where(open_, cur, torch.full_like(cur, NEG))
        maxval = cand.max(dim=1, keepdim=True).values
        any_left = maxval > NEG                    # (B, 1)
        first = torch.where(cand >= maxval, idx, k).min(dim=1,
                                                        keepdim=True).values
        is_m = (idx == first) & any_left
        selected = selected | is_m
        rank = torch.where(is_m, torch.full_like(rank, step), rank)

        m = first.clamp(max=k - 1)
        bx1, by1, bx2, by2 = pick(x1, m), pick(y1, m), pick(x2, m), pick(y2, m)
        barea = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
        iw = torch.minimum(bx2, x2) - torch.maximum(bx1, x1) + 1.0
        ih = torch.minimum(by2, y2) - torch.maximum(by1, y1) + 1.0
        overlap_pos = (iw > 0.0) & (ih > 0.0)
        inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
        ov = inter / (barea + area - inter).clamp(min=1e-12)
        ov = torch.where(overlap_pos, ov, 0.0)
        if class_ids is not None:
            same = class_ids == pick(class_ids, m)
            ov = torch.where(same, ov, 0.0)
            overlap_pos = overlap_pos & same
        if method_id == 1:
            wgt = torch.where(ov > iou_threshold, 1.0 - ov, 1.0)
        elif method_id == 2:
            wgt = torch.exp(-(ov * ov) / sigma)
        else:
            wgt = torch.where(ov > iou_threshold, 0.0, 1.0)

        decay = active & ~selected & any_left
        if return_work:
            work[:, 1] += (decay & overlap_pos).sum(1)
        cur = torch.where(decay, cur * wgt, cur)
        active = active & ~(decay & overlap_pos & (cur < score_threshold))
    if return_work:
        return cur, selected, rank, work
    return cur, selected, rank


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                class_ids: torch.Tensor, iou_threshold: float,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-class hard NMS by the class-offset trick: each image's boxes
    are translated by class id times a span beyond their coordinate
    extent, so one class-agnostic pass never suppresses across classes.
    boxes (B, K, 4) xyxy, scores (B, K), class_ids (B, K), valid (B, K)
    or None; returns the (B, K) keep mask."""
    from rrnet_torch.ops.hard_nms import hard_nms as nms
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    # the span exceeds each image's full extent (decoded boxes may have
    # negative coordinates), so class blocks never touch
    span = 2.0 * torch.where(valid[..., None], boxes.abs(),
                             0.0).amax(dim=(1, 2)) + 1.0
    shifted = boxes + class_ids.to(boxes.dtype)[..., None] * span[:, None,
                                                                  None]
    return nms(shifted.contiguous(), scores, iou_threshold, valid=valid)


def topk_after_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   keep: torch.Tensor, k: int):
    """The k highest-scoring kept boxes of each image as a dense block:
    (boxes (B, k, 4), scores (B, k), valid (B, k), indices (B, k)), ties
    broken toward the lower index as `lax.top_k` does."""
    top, idx = topk_desc(torch.where(keep, scores, -torch.inf), k)
    out = torch.gather(boxes, 1, idx[..., None].expand(-1, -1,
                                                       boxes.shape[-1]))
    return out, top, top > -torch.inf, idx
