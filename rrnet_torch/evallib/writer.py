"""VisDrone result txt IO (port of `rrnet_tpu/evallib/writer.py`).

Two writer formats, matching the reference byte-for-byte:
  * RRNet: float coords `'%f,%f,%f,%f,%.4f,%d,-1,-1'`
    (operators/rrnet_operator.py:234-244, clamped to >= 0),
  * CenterNet: rounded-int coords `'%d,%d,%d,%d,%.4f,%d,-1,-1'` via the
    round-then-xyxy-difference dance (operators/centernet_operator.py:238-249).
"""

from __future__ import annotations

import numpy as np


def save_result(file_path: str, pred_xywh: np.ndarray,
                style: str = "rrnet") -> None:
    """pred_xywh: (N, >=6) [x, y, w, h, score, cls] rows."""
    pred = np.clip(np.asarray(pred_xywh, np.float64), 0.0, None)
    lines = []
    if style == "centernet":
        for row in pred:
            b = row.copy()
            # the reference rounds the xyxy coords then differences
            x1, y1, x2, y2 = np.round([b[0], b[1], b[0] + b[2], b[1] + b[3]])
            lines.append("%d,%d,%d,%d,%.4f,%d,-1,-1\n" % (
                int(x1), int(y1), int(x2) - int(x1), int(y2) - int(y1),
                float(b[4]), int(b[5])))
    else:
        for row in pred:
            lines.append("%f,%f,%f,%f,%.4f,%d,-1,-1\n" % (
                float(row[0]), float(row[1]), float(row[2]), float(row[3]),
                float(row[4]), int(row[5])))
    with open(file_path, "w") as f:
        f.writelines(lines)


def load_result(file_path: str) -> np.ndarray:
    """Read a VisDrone 6/8-column csv (predictions or GT) -> (N, C)."""
    rows = []
    with open(file_path) as f:
        for line in f:
            line = line.strip().strip(",")
            if not line:
                continue
            rows.append([float(v) for v in line.split(",")])
    if not rows:
        return np.zeros((0, 8), np.float64)
    width = max(len(r) for r in rows)
    out = np.zeros((len(rows), width), np.float64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out
