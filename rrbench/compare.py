"""The numbers that decide `correct`.

Detections. A detector made of random weights
puts its best candidates in a few dense clusters, where the order of two
near-equal scores decides which boxes hard NMS keeps; bfloat16 rounding
already reorders them, so whole rows compared with the float32 reference
differ about as much under bfloat16 as under float8 and tell neither
apart. The check therefore follows the timed path stage by stage, on the
forwards the benchmark captured from the window (the port's own outputs)
for the checked frames (`reference.pipeline.judge_forward`):

  * `map_gap`: its heatmap logits, sizes and offsets against the
    reference's own on the same frame, as rms(difference) over the
    reference's spread: the preprocessing, backbone, attention and
    stage-1 heads;
  * `roi_mismatch`: the share of ROI slots that differ from what the
    reference's decode, hard NMS and top-R choice make of the port's own
    maps: the discrete steps, followed from the port's state;
  * `stage2_gap`: its stage-2 deltas against the reference's on its own
    ROIs: ROI-align and the stage-2 head;
  * `rows_gap`: the widest difference between the rows the port returned
    for a frame and the rows made from its own forwards of that frame as
    the Evaluator makes them (the deltas applied, the scale undone, the
    scales merged and sorted): the mapping back to original pixels, and
    every answer holding its own frame's rows.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

MISSING = 1e9       # the gap of rows that cannot be compared at all


def rows_gap(returned: np.ndarray, rebuilt: np.ndarray) -> float:
    if returned is None or returned.shape != rebuilt.shape:
        return MISSING
    if not len(rebuilt):
        return 0.0
    return float(np.abs(returned - rebuilt).max())


def detection_numbers(judged: Sequence[Dict[str, float]],
                      rows: Sequence[Tuple[np.ndarray, np.ndarray]]
                      ) -> Dict[str, float]:
    """The widest of each number over the judged forwards and the
    compared (returned, rebuilt) rows."""
    out = {k: max(j[k] for j in judged)
           for k in ("map_gap", "roi_mismatch", "stage2_gap")}
    out["rows_gap"] = max(rows_gap(a, b) for a, b in rows)
    return out

