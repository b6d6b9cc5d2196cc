"""Host soft-NMS and hard NMS (port of `rrnet_tpu/evallib/host_nms.py`):
a ctypes binding of `csrc/host_nms.cpp`, built by the host's C++
compiler into `build/rrnet_torch/` at first use
(`utils.native.load("host_nms")`).

Replaces the reference's `ext/nms/nms_wrapper.py` surface:
  * soft_nms(dets_xyxy_score, sigma, Nt, threshold, method) -> kept rows
    in selection order with decayed scores (== cpu_soft_nms,
    ext/nms/nms/cpu_nms.pyx:17-120),
  * hard_nms_indices(...) (== cpu_nms / torchvision.ops.nms),
  * per_class_soft_nms_xywh — the operators' `_ext_nms` helper
    (operators/centernet_operator.py:222-236), the evaluator's host merge.

A failed build raises: unlike the JAX module, there is no silent numpy
fallback. `_soft_nms_numpy` is the plain version of the soft-NMS, which
the tests and `chip_smoke.py` hold the library to.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rrnet_torch.utils import native

_METHODS = {"linear": 1, "gaussian": 2, "hard": 0}
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)


def _lib() -> ctypes.CDLL:
    lib = native.load("host_nms")
    lib.soft_nms.restype = ctypes.c_int
    lib.soft_nms.argtypes = [_F32P, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_float, ctypes.c_int,
                             _I32P]
    lib.hard_nms.restype = ctypes.c_int
    lib.hard_nms.argtypes = [_F32P, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_int, _I32P]
    return lib


def _method_id(method) -> int:
    return _METHODS[method] if isinstance(method, str) else int(method)


def soft_nms(dets: np.ndarray, sigma: float = 0.5, Nt: float = 0.3,
             threshold: float = 0.001, method="gaussian") -> np.ndarray:
    """dets: (N, >=5) [x1, y1, x2, y2, score, ...]. Returns the kept rows
    (extra columns preserved) in selection order, scores decayed —
    matching the reference wrapper's return (nms_wrapper.py:13-19)."""
    dets = np.asarray(dets, np.float32)
    n = len(dets)
    if n == 0:
        return dets
    buf = np.ascontiguousarray(dets[:, :5], np.float32).copy()
    order = np.zeros(n, np.int32)
    kept = _lib().soft_nms(buf.ctypes.data_as(_F32P), n,
                           ctypes.c_float(sigma), ctypes.c_float(Nt),
                           ctypes.c_float(threshold), _method_id(method),
                           order.ctypes.data_as(_I32P))
    idx = order[:kept]
    out = dets[idx].copy()
    out[:, 4] = buf[idx, 4]
    return out


def _soft_nms_numpy(dets, sigma=0.5, Nt=0.3, threshold=0.001,
                    method="gaussian") -> np.ndarray:
    """The plain version of `soft_nms` (the JAX module's numpy fallback),
    same contract: f32 scores, decayed with f32 casts where the C++
    rounds."""
    dets = np.asarray(dets, np.float32)
    method_id = _method_id(method)
    n = len(dets)
    if n == 0:
        return dets
    cur = dets[:, 4].astype(np.float32).copy()
    active = np.ones(n, bool)
    selected = np.zeros(n, bool)
    order = []
    while True:
        cand = np.where(active & ~selected, cur, -np.inf)
        m = int(np.argmax(cand))
        if cand[m] == -np.inf:
            break
        selected[m] = True
        order.append(m)
        bm = dets[m]
        iw = (np.minimum(bm[2], dets[:, 2]) - np.maximum(bm[0], dets[:, 0]) + 1)
        ih = (np.minimum(bm[3], dets[:, 3]) - np.maximum(bm[1], dets[:, 1]) + 1)
        overlap = (iw > 0) & (ih > 0) & active & ~selected
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        area = (dets[:, 2] - dets[:, 0] + 1) * (dets[:, 3] - dets[:, 1] + 1)
        am = (bm[2] - bm[0] + 1) * (bm[3] - bm[1] + 1)
        ov = inter / np.clip(am + area - inter, 1e-12, None)
        if method_id == 1:
            w = np.where(ov > Nt, 1 - ov, 1.0)
        elif method_id == 2:
            w = np.exp(-(ov * ov) / sigma)
        else:
            w = np.where(ov > Nt, 0.0, 1.0)
        cur = np.where(overlap, (cur * w).astype(np.float32), cur)
        active &= ~(overlap & (cur < threshold))
    idx = np.asarray(order, np.int64)
    out = dets[idx].copy()
    out[:, 4] = cur[idx]
    return out


def hard_nms_indices(dets: np.ndarray, thresh: float, plus_one=False,
                     suppress_equal=False) -> np.ndarray:
    """Greedy hard NMS over (N, >=5) [x1, y1, x2, y2, score] rows (a
    stable sort by score); returns the kept row indices, best first."""
    dets = np.ascontiguousarray(np.asarray(dets, np.float32)[:, :5])
    n = len(dets)
    if n == 0:
        return np.zeros(0, np.int64)
    keep = np.zeros(n, np.int32)
    kept = _lib().hard_nms(dets.ctypes.data_as(_F32P), n,
                           ctypes.c_float(thresh), int(plus_one),
                           int(suppress_equal), keep.ctypes.data_as(_I32P))
    return keep[:kept].astype(np.int64)


def per_class_soft_nms_xywh(pred: np.ndarray, Nt: float = 0.7,
                            threshold: float = 0.1,
                            method: str = "gaussian",
                            soft_nms_fn=soft_nms) -> np.ndarray:
    """The operators' `_ext_nms`: per-class gaussian soft-NMS on
    (N, >=6) [x, y, w, h, score, cls] rows; returns xywh rows (f32).
    `soft_nms_fn` is the library (default) or `_soft_nms_numpy`."""
    pred = np.asarray(pred, np.float64)
    if len(pred) == 0:
        return pred
    outs = []
    for cls in np.unique(pred[:, 5]):
        rows = pred[pred[:, 5] == cls].copy()
        rows[:, 2] += rows[:, 0]
        rows[:, 3] += rows[:, 1]
        outs.append(soft_nms_fn(rows, sigma=0.5, Nt=Nt, threshold=threshold,
                                method=method))
    out = np.concatenate(outs, axis=0)
    out[:, 2] -= out[:, 0]
    out[:, 3] -= out[:, 1]
    return out
