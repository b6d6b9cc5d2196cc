"""The measuring side of `csrc/hard_nms.cu`, on the CPU.

`profile_hard_nms.py` (at the repo root) builds copies of the kernel's
source with stage cuts and clock64 stamps patched in, so the shipped
source carries no switches of its own: its edits must each fit the
shipped source exactly once. `chip_smoke.hard_nms_work` counts what hard
NMS on given inputs needs at the least (the bound in the kernels line):
held here to a count pair by pair in numpy, in float32 as the kernel
computes iw and ih. The counts are compared exactly, the operations and
the bound they give to float rounding (rel 1e-12).
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "rrnet_torch" / "csrc" / "hard_nms.cu"


@pytest.fixture(scope="module")
def root_modules():
    sys.path.insert(0, str(REPO))
    try:
        yield (importlib.import_module("chip_smoke"),
               importlib.import_module("profile_hard_nms"))
    finally:
        sys.path.remove(str(REPO))


def test_shipped_source_has_no_compile_time_switches():
    text = SOURCE.read_text()
    for word in ("#if", "#define", "clock64()", "g_stamps", "STAMP("):
        assert word not in text, word


@pytest.mark.parametrize("variant", ["rank", "mask", "stamps"])
def test_profile_edits_fit_the_shipped_source(root_modules, variant):
    _, prof = root_modules
    stage, stamps = prof.VARIANTS[variant]
    out = prof.patched_source(SOURCE.read_text(), stage, stamps)
    assert f"constexpr int kStage = {stage};" in out
    assert out.count("kStage >= ") == 1 + len(prof.CUT_SCAN)
    n_stamps = len(prof.PHASES) + 1 + 1         # phase edges, the steps
    assert out.count("  STAMP(") == (n_stamps if stamps else 0)
    assert ("rrnet_hard_nms_stamps" in out) == stamps


def test_profile_edits_refuse_a_source_they_no_longer_fit(root_modules):
    _, prof = root_modules
    text = SOURCE.read_text()
    old, _ = prof.STAMPS[-1]
    with pytest.raises(ValueError, match="copies"):
        prof.patched_source(text.replace(old, "", 1), 3, True)
    with pytest.raises(ValueError, match="copies"):
        prof.patched_source(text + text, 1, False)


def pair_counts(boxes, thr, valid, cls, plus_one):
    """(valid pairs, of one class, of those taking the IoU test), pair by
    pair."""
    off = np.float32(1.0 if plus_one else 0.0)
    n = [0, 0, 0]
    for b in range(boxes.shape[0]):
        for i in range(boxes.shape[1]):
            for j in range(i + 1, boxes.shape[1]):
                if valid is not None and not (valid[b, i] and valid[b, j]):
                    continue
                n[0] += 1
                if cls is not None and cls[b, i] != cls[b, j]:
                    continue
                n[1] += 1
                p, q = boxes[b, i], boxes[b, j]
                iw = np.minimum(p[2], q[2]) - np.maximum(p[0], q[0]) + off
                ih = np.minimum(p[3], q[3]) - np.maximum(p[1], q[1]) + off
                n[2] += bool(thr < 0 or (iw > 0 and ih > 0))
    return n


@pytest.mark.parametrize("thr,masked,per_class,plus_one", [
    (0.7, False, True, False), (0.5, True, False, False),
    (0.3, True, False, True), (-0.1, True, True, False)])
def test_hard_nms_work_counts_each_pair(root_modules, thr, masked, per_class,
                                        plus_one):
    smoke, _ = root_modules
    rng = np.random.RandomState(3)
    bsz, k = 2, 40
    # integer corners on a small grid: many boxes touch (iw == 0 exactly),
    # and with +1 the touching ones intersect
    xy = rng.randint(0, 30, (bsz, k, 2))
    wh = rng.randint(0, 8, (bsz, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 5] = np.nan
    valid = rng.rand(bsz, k) > 0.25 if masked else None
    cls = rng.randint(0, 3, (bsz, k)).astype(np.int32) if per_class else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    work = smoke.hard_nms_work(torch, t(boxes), thr, t(valid), t(cls),
                               plus_one)
    pairs, same, tested = pair_counts(boxes, thr, valid, cls, plus_one)
    assert (work["valid_pairs"], work["same_class_pairs"],
            work["iou_tested_pairs"]) == (pairs, same, tested)
    extra = 2 if plus_one else 0
    n_valid = bsz * k if valid is None else int(valid.sum())
    ops = ((pairs if per_class else 0) + smoke.HARD_NMS_SCREEN_OPS * same
           + (smoke.HARD_NMS_IOU_OPS + extra) * tested
           + (smoke.HARD_NMS_AREA_OPS + extra) * n_valid
           + bsz * k * np.log2(k))
    assert work["ops"] == pytest.approx(ops, rel=1e-12)
    assert work["bound_ms"] == pytest.approx(max(
        ops / smoke.NON_FMA_OPS_PER_S, work["bytes"]
        / smoke.HBM_BYTES_PER_S) * 1e3, rel=1e-12)
