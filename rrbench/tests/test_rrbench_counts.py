"""The yardstick's counts: FLOPs against a hand count, the hard-NMS work
against a pair-by-pair count, and no share of a peak above 100%."""

import numpy as np
import pytest
import torch

from rrbench import counts, harness
from rrbench.reference.layers import Conv2d


def test_conv_flops_by_hand():
    conv = counts.meta_model(lambda: Conv2d(16, 32, 3, 1, 1))
    x = torch.empty(2, 16, 20, 24, device="meta")
    with counts.FlopCounterMode(display=False) as fc:
        conv(x)
    assert fc.get_total_flops() == 2 * 2 * 32 * 20 * 24 * 16 * 3 * 3


def _pairs_by_hand(boxes, valid, cls, thr):
    """valid pairs, same-class pairs and IoU-tested pairs, one by one."""
    n = len(boxes)
    vp = same = tested = 0
    for i in range(n):
        for j in range(i + 1, n):
            if not (valid[i] and valid[j]):
                continue
            vp += 1
            if cls is not None and cls[i] != cls[j]:
                continue
            same += 1
            iw = min(boxes[i, 2], boxes[j, 2]) - max(boxes[i, 0], boxes[j, 0])
            ih = min(boxes[i, 3], boxes[j, 3]) - max(boxes[i, 1], boxes[j, 1])
            if thr < 0 or (iw > 0 and ih > 0):
                tested += 1
    return vp, same, tested


@pytest.mark.parametrize("k,classes,thr", [(40, True, 0.7), (33, False, 0.5),
                                           (25, True, -1.0)])
def test_hard_nms_work_by_hand(k, classes, thr):
    rng = np.random.default_rng(k)
    xy = rng.uniform(0, 30, (1, k, 2)).astype(np.float32)
    wh = rng.uniform(1, 12, (1, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    valid = rng.random((1, k)) < 0.8
    cls = rng.integers(0, 3, (1, k)).astype(np.int32) if classes else None
    w = counts.hard_nms_work(
        torch.from_numpy(boxes), thr, valid=torch.from_numpy(valid),
        class_ids=None if cls is None else torch.from_numpy(cls))
    vp, same, tested = _pairs_by_hand(boxes[0], valid[0],
                                      None if cls is None else cls[0], thr)
    assert (w["valid_pairs"], w["same_class_pairs"],
            w["iou_tested_pairs"]) == (vp, same, tested)
    ops = ((vp if classes else 0) + 4 * same + 14 * tested
           + 3 * int(valid.sum()) + k * np.log2(k))
    assert w["ops"] == pytest.approx(ops)
    assert w["bound_ms"] > 0


def test_shares_over_100_are_refused():
    assert counts.share(99.5, "x") == 99.5
    with pytest.raises(counts.ShareOverPeak):
        counts.share(100.01, "x")
    with pytest.raises(counts.ShareOverPeak):
        counts.share(float("nan"), "x")
    rec = {"window_s": 1.0,
           "work": {"images": 1000, "flops_per_image": 1e12},
           "hard_nms": {"bound_ms": 1.0, "device_s": [1e-4]}}
    for name in ("mfu.eval", "hard_nms_roofline"):
        with pytest.raises(counts.ShareOverPeak):
            harness.reader(name)(rec)
