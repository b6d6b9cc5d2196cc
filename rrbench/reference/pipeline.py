"""The reference's entry point: the judgement of detections stage by
stage.

Detections: `normalized` and `scaled_input` redo what the port's
`Evaluator` derives from a frame (the host pad to the wire shape, the
I420 pack and unpack, the edge pad to the bucket, the normalisation,
each scale's bilinear resize and valid extent). `judge_forward` holds
one forward of another side (the port, or the control) against the
reference: its maps against the reference's on the same input, its
discrete choices against what the reference's decode and NMS make of its
own maps, its stage-2 deltas against the reference's on its own ROIs.
`rows_of` makes an image's rows from a forward as the Evaluator does, so
that the rows the side returned can be held to its own forwards.

"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from rrbench.reference import ops
from rrbench.reference.layers import f32_numerics, resize_bilinear


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class Forward(NamedTuple):
    """What one forward of the detector produced for a batch: the last
    stack's maps (B, H, W, C|2), the valid extents (B, 2), the ROIs
    (B, R, 4) in feature pixels, their scores, classes and validity, and
    the stage-2 deltas (B, R, 4); `hw` is the input's (H, W)."""
    hm: torch.Tensor
    wh: torch.Tensor
    off: torch.Tensor
    vhw: torch.Tensor
    rois: torch.Tensor
    roi_scores: torch.Tensor
    roi_classes: torch.Tensor
    roi_valid: torch.Tensor
    stage2_reg: torch.Tensor
    hw: Tuple[int, int]


def forward_of(out, x: torch.Tensor, vhw: torch.Tensor) -> Forward:
    """A `Forward` of a detector's outputs (the port's `RRNetOutputs` or
    the reference's `Outputs`) on input `x` with extents `vhw`."""
    return Forward(out.hms[-1], out.whs[-1], out.offsets[-1], vhw, out.rois,
                   out.roi_scores, out.roi_classes, out.roi_valid,
                   out.stage2_reg, tuple(x.shape[-2:]))


def _wire(image: np.ndarray, bucket_multiple: int):
    """The frame padded on the host as the port ships it alone: to its
    16-rounded shape by repeating the last row and column."""
    h, w = image.shape[:2]
    bh, bw = _round_up(h, bucket_multiple), _round_up(w, bucket_multiple)
    th, tw = min(_round_up(h, 16), bh), min(_round_up(w, 16), bw)
    padded = np.empty((th, tw, 3), np.uint8)
    padded[:h, :w] = image
    padded[h:, :w] = image[h - 1]
    padded[:, w:] = padded[:, w - 1:w]
    return padded, (bh, bw)


def normalized(image: np.ndarray, mean, std, device, transport="yuv420",
               bucket_multiple: int = 128):
    """(1, 3, bh, bw) float32 input at the frame's bucket."""
    padded, (bh, bw) = _wire(image, bucket_multiple)
    th, tw = padded.shape[:2]
    if transport == "yuv420":
        flat = torch.from_numpy(ops.pack_yuv420(padded[None])).to(device)
        x = ops.unpack_yuv420(flat, th, tw) / 255.0
    else:
        x = torch.from_numpy(padded[None]).to(device).float() / 255.0
    x = x.permute(0, 3, 1, 2)
    x = torch.nn.functional.pad(x, (0, bw - tw, 0, bh - th),
                                mode="replicate")
    m = torch.tensor(mean, device=device)[:, None, None]
    s = torch.tensor(std, device=device)[:, None, None]
    return (x - m) / s, (bh, bw)


def scaled_shape(bucket: Tuple[int, int], scale: float,
                 bucket_multiple: int = 128) -> Tuple[int, int]:
    return (_round_up(int(bucket[0] * scale), bucket_multiple),
            _round_up(int(bucket[1] * scale), bucket_multiple))


def scaled_input(base: torch.Tensor, bucket, hw, scale: float,
                 bucket_multiple: int = 128):
    """The input of one scale and its valid extent: (x, vhw)."""
    sh, sw = scaled_shape(bucket, scale, bucket_multiple)
    x = resize_bilinear(base, (sh, sw))
    v = torch.tensor([hw], dtype=torch.float32, device=base.device)
    vhw = torch.stack([torch.ceil(v[:, 0] * (sh / bucket[0])),
                       torch.ceil(v[:, 1] * (sw / bucket[1]))], 1).int()
    return x, vhw


def rows_of(f: Forward, slot: int, bucket, scale_factor: int = 4
            ) -> np.ndarray:
    """One image's rows of one forward in original pixels, as the port's
    Evaluator makes them: the stage-2 deltas on the ROIs, invalid ROIs
    dropped, the scale undone."""
    roi = f.rois[slot:slot + 1] * scale_factor
    xywh = torch.cat([roi[..., :2], roi[..., 2:4] - roi[..., :2]], -1)
    box = ops.decode_boxes(xywh, f.stage2_reg[slot:slot + 1].float())
    score = torch.where(f.roi_valid[slot:slot + 1],
                        f.roi_scores[slot:slot + 1], -1.0)
    cls = f.roi_classes[slot:slot + 1].float() + 1.0
    rows = torch.cat([box, score[..., None], cls[..., None]], -1)
    rows = rows[0].cpu().numpy().astype(np.float64)
    rows = rows[rows[:, 4] >= 0.0]
    rows[:, [0, 2]] /= f.hw[1] / bucket[1]
    rows[:, [1, 3]] /= f.hw[0] / bucket[0]
    return rows


@torch.no_grad()
def forwards(model, image: np.ndarray, scales: Sequence[float], mean, std,
             transport: str = "yuv420", bucket_multiple: int = 128):
    """The frame through the protocol on `model` (the reference, or the
    control): its normalised bucket, the bucket, and a `Forward` a
    scale."""
    dev = next(model.parameters()).device
    with f32_numerics():
        base, bucket = normalized(image, mean, std, dev, transport,
                                  bucket_multiple)
        out = []
        for scale in scales:
            x, vhw = scaled_input(base, bucket, image.shape[:2], scale,
                                  bucket_multiple)
            out.append(forward_of(model(x, valid_hw=vhw), x, vhw))
    return base, bucket, out


def sort_rows(parts: Sequence[np.ndarray]) -> np.ndarray:
    rows = np.concatenate(parts, axis=0)
    return rows[np.argsort(-rows[:, 4], kind="stable")]


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """rms(a - b) over the spread of b."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).pow(2).mean().sqrt() / b.std().clamp(min=1e-12))


@torch.no_grad()
def judge_forward(model, base: torch.Tensor, f: Forward, slot: int):
    """One image of a forward that another side produced, judged stage by
    stage by the float32 reference `model` (`base`: that image's
    normalised bucket, (1, 3, bh, bw)):

      * `map_gap`: the last stack's heatmap logits, sizes and offsets
        against the reference's own on the same input, each as
        rms(difference) over the reference's spread, the widest;
      * `roi_mismatch`: the share of ROI slots whose choice differs from
        what the reference's decode, hard NMS and top-R choice make of the
        side's own maps (the discrete steps, followed from its state);
      * `stage2_gap`: the side's stage-2 deltas against the reference's on
        the side's own ROIs, over the valid ones;

    and the candidates the decode gave (what the side's NMS took in)."""
    with f32_numerics():
        x = resize_bilinear(base, f.hw)
        feats, hms, whs, offs = model.stage1(x)
        maps = max(gap(f.hm[slot], hms[-1][0]), gap(f.wh[slot], whs[-1][0]),
                   gap(f.off[slot], offs[-1][0]))
        s = slice(slot, slot + 1)
        hm = ops.mask_heatmap_extent(f.hm[s].float(), f.vhw[s], 4)
        dets = ops.topk_decode(hm, f.wh[s], f.off[s], k=model.topk)
        rois, scores, classes, valid = model.select_rois(
            dets.boxes, dets.scores, dets.classes)
        same = ((valid == f.roi_valid[s])
                & (~valid | ((classes == f.roi_classes[s])
                             & ((scores - f.roi_scores[s]).abs() <= 1e-6)
                             & ((rois - f.rois[s]).abs() <= 1e-4).all(-1))))
        last = torch.relu(feats[-1]).permute(0, 2, 3, 1).contiguous()
        roi_feat = ops.roi_align(last, f.rois[s].float(), (3, 3))
        _, r, _, _, c = roi_feat.shape
        s2 = model.head_detector(
            roi_feat.reshape(r, 3, 3, c).permute(0, 3, 1, 2))
        ok = f.roi_valid[slot]
        stage2 = (gap(f.stage2_reg[slot][ok], s2[ok]) if bool(ok.any())
                  else 0.0)
    return {"map_gap": maps,
            "roi_mismatch": float(1.0 - same.float().mean()),
            "stage2_gap": stage2}, dets

