"""Detection losses (port of `rrnet_tpu/losses.py:24-127`), NHWC maps.

  * `clamped_sigmoid`: sigmoid clamped to [eps, 1 - eps] before the
    heatmap focal loss;
  * `focal_loss_hm`: CornerNet/CenterNet heatmap focal loss, normalised
    by the positive count, or the raw negative sum when there is none
    (`focal_loss_hm_from_logits` on logits);
  * `reg_l1_loss`: masked L1 at the GT centre indices, divided by the
    mask broadcast over channels (positives x C) + 1e-4;
  * `focal_loss`: RetinaNet's sigmoid focal loss on logits;
  * `smooth_l1_loss`: torch's smooth-L1;
  * `kl_feature_loss`: the reference's unused heteroscedastic
    feature-distillation loss;
  * `giou_loss`, from `ops.box`.

Integer powers are written as products, in the order XLA's
`integer_pow` multiplies.
"""

from __future__ import annotations

import torch

from rrnet_torch.ops.box import giou_loss  # noqa: F401  (re-export)


def clamped_sigmoid(logits: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return torch.sigmoid(logits).clamp(eps, 1.0 - eps)


def focal_loss_hm(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred (B, H, W, C) probabilities (sigmoided and clamped), gt the
    gaussian target; positives are gt == 1, negatives weighted (1-gt)^4."""
    pos = (gt == 1.0).to(pred.dtype)
    neg = 1.0 - pos
    one_m_gt = 1.0 - gt
    sq = one_m_gt * one_m_gt
    neg_weights = sq * sq
    one_m_p = 1.0 - pred

    pos_loss = torch.sum(torch.log(pred) * (one_m_p * one_m_p) * pos)
    neg_loss = torch.sum(torch.log(1.0 - pred) * (pred * pred) * neg_weights
                         * neg)
    num_pos = torch.sum(pos)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def focal_loss_hm_from_logits(logits: torch.Tensor,
                              gt: torch.Tensor) -> torch.Tensor:
    return focal_loss_hm(clamped_sigmoid(logits), gt)


def reg_l1_loss(pred_map: torch.Tensor, mask: torch.Tensor,
                ind: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred_map (B, H, W, C), mask (B, N) or (B, N, 1), ind (B, N) flat
    y*W+x, target (B, N, C)."""
    b, h, w, c = pred_map.shape
    pred = torch.gather(pred_map.reshape(b, h * w, c), 1,
                        ind.long()[..., None].expand(-1, -1, c))
    if mask.dim() == 2:
        mask = mask[..., None]
    m = mask.to(pred.dtype).expand_as(pred)
    loss = torch.sum(torch.abs(pred * m - target * m))
    return loss / (torch.sum(m) + 1e-4)


def focal_loss(cls_logits: torch.Tensor, cls_targets: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.75,
               reduction: str = "sum") -> torch.Tensor:
    """Sigmoid focal loss (reference modules/loss/functional.py:6-22):
    cls_logits (..., C), cls_targets the same shape in {1 (pos), 0 (neg)};
    probabilities clamped to [1e-7, 1 - 1e-7]. Ignored anchors are the
    caller's to mask in the elementwise ('none') output."""
    p = torch.sigmoid(cls_logits).clamp(1e-7, 1.0 - 1e-7)
    is_pos = cls_targets == 1.0
    alpha_factor = torch.where(is_pos, alpha, 1.0 - alpha)
    focal_weight = torch.where(is_pos, 1.0 - p, p)
    focal_weight = alpha_factor * torch.pow(focal_weight, gamma)
    bce = -(cls_targets * torch.log(p)
            + (1.0 - cls_targets) * torch.log(1.0 - p))
    out = focal_weight * bce
    return out.sum() if reduction == "sum" else out


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0, reduction: str = "mean") -> torch.Tensor:
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def kl_feature_loss(small_alpha: torch.Tensor, large_alpha: torch.Tensor,
                    small_feats: torch.Tensor,
                    large_feats: torch.Tensor) -> torch.Tensor:
    """The reference's heteroscedastic feature-distillation loss core
    (modules/loss/functional.py:106-108), an unused experiment there;
    the caller detaches the `large_*` inputs."""
    sl1 = smooth_l1_loss(small_feats, large_feats, reduction="none")
    loss = 0.5 * (small_alpha - large_alpha) + \
        (torch.exp(large_alpha) + sl1) / (2.0 * torch.exp(small_alpha))
    return torch.mean(loss)
