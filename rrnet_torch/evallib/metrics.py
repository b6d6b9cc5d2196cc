"""VisDrone AP@[.5:.95] evaluator (numpy, host-side; port of
`rrnet_tpu/evallib/metrics.py`).

This is THE parity metric — a faithful rebuild of the reference's
from-scratch evaluator (`utils/metrics/metrics.py:51-324`) including its
idiosyncrasies, because the headline numbers are defined by it:

  * VisDrone ignore-region protocol: GT boxes overlapping an
    ignore-region (cls 0) box by > 0.5 of their own area are dropped,
    then predictions overlapping the remaining ignore boxes by > 0.5 are
    dropped (metrics.py:72-87).
  * Greedy per-class TP matching across the 10 IoU thresholds
    .5:.05:.95 simultaneously, in prediction-confidence order; a matched
    GT column is consumed per threshold (metrics.py:89-130).
  * AP per class = interpolated PR AUC counted only where recall
    strictly increases, WEIGHTED by the number of images containing the
    class, normalized by the total class-in-image count
    (metrics.py:133-174) — not the usual unweighted class mean.
  * File mode: predicted xywh boxes are int-truncated via the
    xyxy round-trip (metrics.py:233-235), max 500 detections per image.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, List

import numpy as np

from rrnet_torch.evallib.host_nms import per_class_soft_nms_xywh
from rrnet_torch.evallib.writer import load_result

THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def _iou_overlap_xywh(a: np.ndarray, b: np.ndarray):
    """IoU and intersection/area(a) for xywh boxes (metrics.py:10-48)."""
    a = a.astype(np.float64).copy()
    b = b.astype(np.float64).copy()
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.minimum(ax2[:, None], bx2[None, :]) - np.maximum(a[:, None, 0], b[None, :, 0])
    ih = np.minimum(ay2[:, None], by2[None, :]) - np.maximum(a[:, None, 1], b[None, :, 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-8, None)
    return inter / union, inter / np.clip(area_a[:, None], 1e-8, None)


class APAccumulator:
    """Streaming accumulator over images (replaces the cls_tp_* lists
    threaded through reference get_tp)."""

    def __init__(self, cls_num: int = 11,
                 thresholds: np.ndarray = THRESHOLDS):
        self.cls_num = cls_num
        self.thresholds = thresholds
        k = len(thresholds)
        self.tp_flags: List[List[np.ndarray]] = [[] for _ in range(cls_num - 1)]
        self.tp_confs: List[List[np.ndarray]] = [[] for _ in range(cls_num - 1)]
        self.target_count = np.zeros(cls_num - 1)
        self.in_img_count = np.zeros(cls_num - 1)
        self._k = k

    # ------------------------------------------------------------------
    def add_image(self, pred: np.ndarray, target: np.ndarray):
        """pred: (M, 6) [x, y, w, h, score, cls]; target: (N, >=6)
        VisDrone rows. Mirrors reference get_tp (metrics.py:51-130)."""
        k = self._k
        pred = np.asarray(pred, np.float64)
        target = np.asarray(target, np.float64)
        if pred.ndim != 2:
            pred = pred.reshape(-1, 6)

        order = np.argsort(-pred[:, 4], kind="stable")
        pred = pred[order]

        # Drop GT inside ignore regions.
        if len(target):
            ignore = target[:, 5] == 0
            if ignore.sum() != 0:
                _, gt_ov = _iou_overlap_xywh(target[:, :4], target[:, :4])
                ign_ov = gt_ov[:, ignore].max(axis=1)
                keep = (ign_ov < 0.5) | ignore
                target = target[keep]

        # Drop predictions inside (remaining) ignore regions.
        ignore = target[:, 5] == 0 if len(target) else np.zeros(0, bool)
        if len(pred) and len(target):
            iou, ov = _iou_overlap_xywh(pred[:, :4], target[:, :4])
            if ignore.sum() != 0:
                ign_ov = ov[:, ignore].max(axis=1)
                keep = ign_ov < 0.5
                pred = pred[keep]
                iou = iou[keep]
        else:
            iou = np.zeros((len(pred), len(target)))

        pred_cls = pred[:, 5].astype(np.int64) if len(pred) else np.zeros(0, np.int64)
        tgt_cls = target[:, 5].astype(np.int64) if len(target) else np.zeros(0, np.int64)

        # tp_iou[p, t, k] = iou if same class and iou >= threshold_k
        if len(pred) and len(target):
            same = pred_cls[:, None] == tgt_cls[None, :]
            iou_flag = iou[:, :, None] >= self.thresholds[None, None, :]
            tp_iou = iou[:, :, None] * (same[:, :, None] & iou_flag)
        else:
            tp_iou = np.zeros((len(pred), len(target), k))

        for cls in range(1, self.cls_num):
            p_sel = pred_cls == cls
            t_sel = tgt_cls == cls
            cls_tp_iou = tp_iou[np.ix_(p_sel, t_sel)] if len(pred) and len(target) \
                else np.zeros((int(p_sel.sum()), int(t_sel.sum()), k))
            self.target_count[cls - 1] += int(t_sel.sum())
            self.in_img_count[cls - 1] += 1 if t_sel.sum() != 0 else 0
            if cls_tp_iou.shape[0] == 0 or cls_tp_iou.shape[1] == 0:
                continue

            cls_tp_iou = cls_tp_iou.copy()
            flags = np.zeros((cls_tp_iou.shape[0], k))
            for di in range(cls_tp_iou.shape[0]):
                dt_iou = cls_tp_iou[di]                  # (T, K)
                max_iou = dt_iou.max(axis=0)
                max_idx = dt_iou.argmax(axis=0)
                hit = np.nonzero(max_iou)[0]
                if len(hit):
                    t_idx = max_idx[hit]
                    cls_tp_iou[:, t_idx, hit] = 0        # consume GT per threshold
                    flags[di, hit] = 1
            self.tp_flags[cls - 1].append(flags)
            self.tp_confs[cls - 1].append(pred[p_sel, 4])

    # ------------------------------------------------------------------
    def compute(self) -> Dict[str, float]:
        """AP/AR aggregation (metrics.py:133-174)."""
        k = self._k
        total_ap = np.zeros(k)
        total_rc = np.zeros(k)
        for cls in range(self.cls_num - 1):
            if self.target_count[cls] == 0:
                continue
            if self.tp_flags[cls]:
                flags = np.concatenate(self.tp_flags[cls], axis=0)
                confs = np.concatenate(self.tp_confs[cls], axis=0)
            else:
                flags = np.zeros((0, k))
                confs = np.zeros((0,))

            order = np.argsort(-confs, kind="stable")
            flags = flags[order]
            cum = flags.cumsum(axis=0)
            denom = np.arange(1, cum.shape[0] + 1)[:, None]
            prec = cum / denom if len(cum) else np.zeros((0, k))
            rec = cum / max(self.target_count[cls], 1)

            mrec = np.concatenate([np.zeros((1, k)), rec, np.ones((1, k))])
            mpre = np.concatenate([np.zeros((1, k)), prec, np.zeros((1, k))])
            for i in range(mpre.shape[0] - 1, 0, -1):
                mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
            inc = ((mrec[1:] - mrec[:-1]) > 0).astype(np.float64)
            total_ap += ((mrec[1:] * inc - mrec[:-1] * inc) * mpre[1:] * inc
                         ).sum(axis=0) * self.in_img_count[cls]
            total_rc += mrec[:-1].max(axis=0) * self.in_img_count[cls]

        denom = max(self.in_img_count.sum(), 1e-8)
        ap = total_ap / denom
        rc = (total_rc / denom).mean()
        return {
            "ap": float(ap.mean()),
            "ap50": float(ap[0]),
            "ap75": float(ap[5]),
            "ar": float(rc),
            "ap_per_threshold": ap,
        }


def evaluate_once(pred: np.ndarray, target: np.ndarray,
                  cls_num: int = 11, max_det_num: int = 500) -> Dict:
    """One image (metrics.py:177-206)."""
    acc = APAccumulator(cls_num)
    acc.add_image(np.asarray(pred)[:max_det_num], np.asarray(target))
    return acc.compute()


def _int_truncate_xywh(pred: np.ndarray) -> np.ndarray:
    """The file-mode coordinate treatment (metrics.py:233-235): convert
    to xyxy, truncate to int, back to xywh."""
    pred = pred.copy()
    pred[:, 2:4] += pred[:, 0:2]
    pred[:, :4] = pred[:, :4].astype(np.int64).astype(np.float64)
    pred[:, 2:4] -= pred[:, 0:2]
    return pred


def evaluate_results(pred_dir: str, target_dir: str, cls_num: int = 11,
                     max_det_num: int = 500, verbose: bool = True) -> Dict:
    """Score a directory of VisDrone prediction txts against GT txts
    (metrics.py:209-251)."""
    st = time.time()
    names = [os.path.splitext(os.path.basename(p))[0]
             for p in glob.glob(os.path.join(pred_dir, "*.txt"))]
    acc = APAccumulator(cls_num)
    for name in sorted(names):
        pred = load_result(os.path.join(pred_dir, f"{name}.txt"))
        target = load_result(os.path.join(target_dir, f"{name}.txt"))
        pred = _int_truncate_xywh(pred)[:max_det_num]
        target = target[:max_det_num]
        acc.add_image(pred, target)
    out = acc.compute()
    if verbose:
        print(f"Average Precision  (AP) @[ IoU=0.50:0.95] = {out['ap']:.4}.")
        print(f"Average Precision  (AP) @[ IoU=0.50     ] = {out['ap50']:.4}.")
        print(f"Average Precision  (AP) @[ IoU=0.75     ] = {out['ap75']:.4}.")
        print(f"Average Recall     (AR) @[ IoU=0.50:0.95] = {out['ar']:.4}.")
        print(f"Cost Time: {time.time() - st}s")
    return out


def auto_evaluate_results(pred_dir: str, target_dir: str,
                          score_threshold: float,
                          softnms_threshold: float,
                          cls_num: int = 11, max_det_num: int = 500,
                          verbose: bool = True) -> Dict:
    """Post-hoc score-threshold x soft-NMS grid point (metrics.py:254-305):
    filter raw predictions by score, per-class gaussian soft-NMS
    (Nt=0.7) on the host library, then score as usual."""
    names = [os.path.splitext(os.path.basename(p))[0]
             for p in glob.glob(os.path.join(pred_dir, "*.txt"))]
    acc = APAccumulator(cls_num)
    for name in sorted(names):
        pred = load_result(os.path.join(pred_dir, f"{name}.txt"))
        target = load_result(os.path.join(target_dir, f"{name}.txt"))
        pred = pred[pred[:, 4] > score_threshold]
        pred = pred[np.argsort(-pred[:, 4], kind="stable")]
        pred = per_class_soft_nms_xywh(pred, Nt=0.7,
                                       threshold=softnms_threshold)
        pred = _int_truncate_xywh(pred)
        pred = pred[np.argsort(-pred[:, 4], kind="stable")][:max_det_num]
        acc.add_image(pred, target[:max_det_num])
    out = acc.compute()
    if verbose:
        print(f"[auto] thr={score_threshold} nms={softnms_threshold} "
              f"AP={out['ap']:.4f} AP50={out['ap50']:.4f}")
    return out
