"""What a detection driver needs beside its traffic: the capture of the port's
forwards on the checked batch, and its judgement by the reference."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from rrbench import compare, counts
from rrbench.reference import pipeline


class Capture:
    """A forward hook on the port's detector that keeps, while `armed`,
    what each forward produced (`pipeline.Forward`), in call order."""

    def __init__(self, model):
        self.armed = False
        self.forwards: List[pipeline.Forward] = []
        self.handle = model.register_forward_hook(self._hook,
                                                  with_kwargs=True)

    def _hook(self, module, args, kwargs, out):
        if self.armed:
            self.forwards.append(pipeline.forward_of(
                out, args[0], kwargs["valid_hw"]))

    def close(self):
        self.handle.remove()


def judge(ref, cfg, frames_in_slots, forwards, returned, bucket_multiple):
    """The compared numbers of one checked batch: `frames_in_slots` the
    frame of each slot, `forwards` the port's forwards of the batch (one
    a scale), `returned[j]` the rows the port gave for slot j (None where
    the answer never came). Also each scale's candidates per slot."""
    val = cfg.val
    judged, rows, cands = [], [], []
    for j, frame in enumerate(frames_in_slots):
        base, bucket = pipeline.normalized(
            frame, val.mean, val.std, next(ref.parameters()).device,
            val.transport, bucket_multiple)
        parts, per_scale = [], []
        for f in forwards:
            numbers, dets = pipeline.judge_forward(ref, base, f, j)
            judged.append(numbers)
            per_scale.append(dets)
            parts.append(pipeline.rows_of(f, j, bucket,
                                          cfg.train.scale_factor))
        rows.append((returned[j], pipeline.sort_rows(parts)))
        cands.append(per_scale)
    return compare.detection_numbers(judged, rows), cands


def hard_nms_bound_ms(cands, iou: float) -> float:
    """The mean over the scales of the least time of one hard-NMS launch
    over the batch's candidates at that scale."""
    calls = []
    for s in range(len(cands[0])):
        calls.append(counts.batch_bound_ms([
            counts.hard_nms_work(c[s].boxes, iou, class_ids=c[s].classes)
            for c in cands]))
    return float(np.mean(calls))


def missing() -> Dict[str, float]:
    """The numbers of a check that found nothing to compare."""
    return {k: compare.MISSING
            for k in ("map_gap", "roi_mismatch", "stage2_gap", "rows_gap")}
