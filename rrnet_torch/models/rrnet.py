"""RRNet, the hybrid two-stage detector (port of
`rrnet_tpu/models/rrnet.py:30-184`), eval and train forward.

Stage 1: CenterNet heads on each stack's map (the backbone's first
`num_stacks` maps, each head at its map's width), optionally with a
windowed self-attention added residually to each (`with_attention`, the
`rrnet_hrnetv2_attention` preset); the last stack is decoded to top-k
candidates, NMS'd per image on the device (hard NMS by the CUDA kernel of
`ops/hard_nms.py`, or soft-NMS by the CUDA kernels of `ops/soft_nms.py`
through `soft_nms_auto`), and cut to a static budget of R ROIs. Stage 2:
3x3 ROI-align over relu(the backbone's last map) and a bottleneck
regressor; for HRNetV2 that is its fourth map (320 channels), not stack
1's. Decode, NMS and ROI-align run in f32 whatever the compute dtype; in
train mode the last map is cast to f32 before ROI-align, so that its
backward scatter-adds in f32. Gradients reach the wh and offset heads
through the ROI coordinates, as in the JAX package; the NMS and the top-R
choice run on detached tensors. The forward's stages are timed as the
spans `rrnet.backbone`, `.attention`, `.heads`, `.decode`, `.nms`,
`.roi_align` and `.stage2` (`utils.tracing`; off unless tracing is on).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from rrnet_torch.models.backbones import get_backbone, stack_widths
from rrnet_torch.models.heads import CenterNetHead, CenterNetWHHead, FasterRCNNHead
from rrnet_torch.models.modules import SelfAttentionModule
from rrnet_torch.ops.heatmap import topk_decode, topk_desc
from rrnet_torch.ops.hard_nms import hard_nms
from rrnet_torch.ops.roi_align import roi_align
from rrnet_torch.ops.soft_nms import soft_nms_auto
from rrnet_torch.utils import tracing


def mask_heatmap_extent(hm: torch.Tensor, valid_hw: torch.Tensor,
                        scale_factor: int = 4) -> torch.Tensor:
    """Set (B, H, W, C) heatmap logits outside each image's valid
    stride-s extent to -1e9; valid_hw (B, 2) int image-pixel [h, w]."""
    b, h, w, _ = hm.shape
    fy = torch.ceil(valid_hw[:, 0].float() / scale_factor)[:, None, None]
    fx = torch.ceil(valid_hw[:, 1].float() / scale_factor)[:, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=hm.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=hm.device)[None, None, :]
    ok = (ys < fy) & (xs < fx)
    return torch.where(ok[..., None], hm, -1e9)


class RRNetOutputs(NamedTuple):
    hms: tuple                 # per-stack (B, H, W, C) heatmap logits
    whs: tuple                 # per-stack (B, H, W, 2)
    offsets: tuple             # per-stack (B, H, W, 2)
    stage2_reg: torch.Tensor   # (B, R, 4) regression deltas
    rois: torch.Tensor         # (B, R, 4) xyxy in stride-4 feature coords
    roi_scores: torch.Tensor   # (B, R) stage-1 scores (post NMS decay)
    roi_classes: torch.Tensor  # (B, R) int32 0-based classes
    roi_valid: torch.Tensor    # (B, R) bool


class RRNet(nn.Module):
    def __init__(self, num_classes: int = 10, num_stacks: int = 2,
                 backbone: str = "hourglass", wh_kernel: int = 17,
                 topk: int = 1500, stage2_rois: int = 512,
                 nms_type: str = "nms", nms_per_class: bool = True,
                 nms_iou: float = 0.7, soft_nms_sigma: float = 0.5,
                 soft_nms_score_threshold: float = 0.1,
                 with_attention: bool = False, attention_kernel: int = 5,
                 attention_dilation: int = 6, dtype=torch.float32):
        super().__init__()
        if nms_type not in ("nms", "soft_nms"):
            raise ValueError(f"unknown stage-1 nms_type {nms_type!r}")
        self.num_classes = num_classes
        self.num_stacks = num_stacks
        self.topk = topk
        self.stage2_rois = stage2_rois
        self.nms_type = nms_type
        self.nms_per_class = nms_per_class
        self.nms_iou = nms_iou
        self.soft_nms_sigma = soft_nms_sigma
        self.soft_nms_score_threshold = soft_nms_score_threshold
        self.with_attention = with_attention
        self.backbone = get_backbone(backbone, num_stacks, dtype=dtype)
        widths = stack_widths(self.backbone, num_stacks, backbone)
        if with_attention:
            pad = attention_dilation * (attention_kernel // 2)
            for i, c in enumerate(widths):
                self.add_module(f"attention{i}", SelfAttentionModule(
                    c, key_channels=64, value_channels=64,
                    kernel_size=attention_kernel,
                    dilation=attention_dilation, padding=pad, dtype=dtype))
        self.hm = CenterNetHead(num_classes, num_stacks, is_heatmap=True,
                                in_channels=widths, dtype=dtype)
        self.wh = CenterNetWHHead(1, num_stacks, kernel=wh_kernel,
                                  in_channels=widths, dtype=dtype)
        self.offset = CenterNetHead(2, num_stacks, in_channels=widths,
                                    dtype=dtype)
        self.head_detector = FasterRCNNHead(
            self.backbone.out_channels[-1], dtype=dtype)

    def select_rois(self, boxes, scores, classes):
        """Per image: stage-1 NMS, then the R best kept candidates (lower
        index first among equal scores). Returns (rois, roi_scores with 0
        where invalid, roi_classes, roi_valid). The choice runs on
        detached tensors; the ROIs are gathered from `boxes` itself, so
        gradients flow into them. Per-class soft-NMS takes the
        class-parallel kernel (`soft_nms_auto(class_parallel=True)`) where
        the JAX model takes the serial one, which was faster on the TPU
        (`rrnet_tpu/models/rrnet.py:135-138`); the two select the same
        boxes with the same kept scores, bit for bit, so the ROIs are equal.
        Class-agnostic soft-NMS takes the serial kernel."""
        cls_ids = classes if self.nms_per_class else None
        b_nd, s_nd = boxes.detach(), scores.detach()
        if self.nms_type == "soft_nms":
            new_scores, keep, _ = soft_nms_auto(
                b_nd, s_nd, class_ids=cls_ids, num_classes=self.num_classes,
                class_parallel=True, sigma=self.soft_nms_sigma,
                iou_threshold=self.nms_iou,
                score_threshold=self.soft_nms_score_threshold,
                method="gaussian", max_out=self.stage2_rois)
            masked = torch.where(keep, new_scores, -torch.inf)
        else:
            keep = hard_nms(b_nd, s_nd, self.nms_iou, class_ids=cls_ids)
            masked = torch.where(keep, s_nd, -torch.inf)
        top, idx = topk_desc(masked, self.stage2_rois)
        valid = top > -torch.inf
        rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        return (rois, torch.where(valid, top, 0.0),
                torch.gather(classes, 1, idx), valid)

    def forward(self, x: torch.Tensor,
                valid_hw: Optional[torch.Tensor] = None,
                roi_jitter: Optional[torch.Tensor] = None) -> RRNetOutputs:
        """x (B, 3, H, W); valid_hw optional (B, 2) int [h, w] image
        extents inside a padded bucket (logits outside are masked).
        roi_jitter: optional (B, R, 4) offsets in feature coordinates,
        added (in the ROIs' dtype) to the selected ROIs before ROI-align:
        the coarse-ROI ablation (`scripts/stage2_ablation.py`), for eval
        only. The returned `rois` carry the jitter."""
        with tracing.span("rrnet.backbone"):
            feats = self.backbone(x)
        hms, whs, offsets = [], [], []
        for i in range(self.num_stacks):
            f = F.relu(feats[i])
            if self.with_attention:
                with tracing.span("rrnet.attention"):
                    f = f + getattr(self, f"attention{i}")(f)
            with tracing.span("rrnet.heads"):
                hms.append(self.hm(f, i))
                whs.append(self.wh(f, i))
                offsets.append(self.offset(f, i))

        with tracing.span("rrnet.decode"):
            hm_last = hms[-1].float()
            if valid_hw is not None:
                hm_last = mask_heatmap_extent(hm_last, valid_hw,
                                              scale_factor=4)
            dets = topk_decode(hm_last, whs[-1].float(),
                               offsets[-1].float(), k=self.topk)
        with tracing.span("rrnet.nms"):
            rois, roi_scores, roi_classes, roi_valid = self.select_rois(
                dets.boxes.contiguous(), dets.scores.contiguous(),
                dets.classes.contiguous())
        if roi_jitter is not None:
            rois = rois + roi_jitter.to(rois.dtype)

        with tracing.span("rrnet.roi_align"):
            last = F.relu(feats[-1])
            if self.training:
                last = last.float()
            last = last.permute(0, 2, 3, 1).contiguous()
            # (B, R, 3, 3, C)
            roi_feat = roi_align(last, rois, output_size=(3, 3))
        with tracing.span("rrnet.stage2"):
            b, r, _, _, c = roi_feat.shape
            s2 = self.head_detector(
                roi_feat.reshape(b * r, 3, 3, c).permute(0, 3, 1, 2))
        return RRNetOutputs(
            hms=tuple(hms), whs=tuple(whs), offsets=tuple(offsets),
            stage2_reg=s2.reshape(b, r, 4), rois=rois, roi_scores=roi_scores,
            roi_classes=roi_classes, roi_valid=roi_valid)
