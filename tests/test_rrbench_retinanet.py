"""RetinaNet against the benchmark's plain reference
(`rrbench/reference/retinanet.py`) and the cell that runs it
(`rrbench/drivers/anchor_eval.py`), on the CPU:

  * the port at ResNet-50 widths, 2x3x128x192, float32, against the
    reference: outputs, candidates, keep mask and rows;
  * the anchors: equal to the port's bit for bit, and within one ulp of
    the single rounding of the upstream module (the documented
    departure);
  * the driver end to end through `harness.Cell` at a tiny size, sound
    and with a fault planted in the port (class logits perturbed; one
    keep bit flipped), and its float8 control;
  * a port without RetinaNet's spans stopped in the driver's set-up;
  * the weights recipe's count of valid candidates an image;
  * the port's RetinaNet spans and counters under `tracing.enable()`;
  * a run loads no JAX (a process of its own).
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rrbench import harness
from rrbench.drivers import anchor_eval
from rrbench.frames import frames
from rrbench.reference import retinanet as R
from rrbench.reference.layers import f32_numerics
from rrnet_torch import config as tcfg
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.models import build_model
from rrnet_torch.models import retinanet as PR
from rrnet_torch.models.anchors import anchors_for_shape
from rrnet_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "retinanet-eval1080"
# the CPU's tiny cell: the resnet10 backbone, 120x200 frames, 60 of the
# 1000 candidates an image valid in the weights' calibration, the port
# in float32
TINY = {"model": {"backbone": "resnet10"},
        "weights": {"calibration_frames": 4, "calibration_hw": [120, 200],
                    "valid_per_image": 60}}
TINY_TRAFFIC = {"frame_hw": [120, 200], "pool": 4, "batch": 2,
                "check_batch_max": 1}


def tiny_cell(seed=5, seconds=0.5):
    cell = harness.Cell(WORKLOAD, seed, seconds, False, "cpu",
                        overrides=TINY, traffic=TINY_TRAFFIC,
                        check_params=False)
    cell.config["dtype"] = "float32"
    return cell


def _correct(cell):
    rec = cell.driver().run(cell)
    judged = harness.judge(rec["numbers"], cell.limits)
    return (rec["failed"] == 0 and all(j["ok"] for j in judged.values()),
            rec["numbers"])


@pytest.fixture(scope="module")
def resnet50_pair():
    """The port's RetinaNet at published widths in float32 (its own
    seeded init) and the reference with the same state dict, on one
    2x3x128x192 input; each side's (loc, cls)."""
    cfg = tcfg.set_by_path(tcfg.PRESETS["retinanet"](), "model.dtype",
                           "float32")
    port = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    ref = R.RetinaNet()
    ref.load_state_dict(port.state_dict(), strict=True)
    ref.eval()
    x = torch.randn(2, 3, 128, 192, generator=torch.Generator().manual_seed(4))
    with torch.no_grad(), f32_numerics():
        return cfg, port(x), ref(x)


def test_port_outputs_match_the_reference(resnet50_pair):
    """Both sides compute in float32; the port folds each BN into its
    conv's weights (one rounding) and sums in another order, so the
    outputs agree to about 1e-5 of their spread, not bit for bit; 1e-4
    leaves room above that and lies far below bfloat16's ~1e-2."""
    _, (ploc, pcls), (rloc, rcls) = resnet50_pair
    assert ploc.shape == rloc.shape == (2, 4536, 4)
    assert pcls.shape == rcls.shape == (2, 4536, 10)
    for p, r in ((ploc, rloc), (pcls, rcls)):
        rel = float((p - r).pow(2).mean().sqrt() / r.std())
        assert rel < 1e-4, rel


def test_port_decode_matches_the_reference(resnet50_pair):
    """The decode of one set of outputs: the same elementwise operations
    on tensors of the same shapes, so candidates, keep mask and rows are
    equal bit for bit (no tolerance). The class logits are moved onto
    the focal-loss prior, mean -log(99) and spread 1, so that some of
    the 1000 candidates score above 0.1 and some below."""
    cfg, (loc, cls), _ = resnet50_pair
    cls = (cls - cls.mean()) / cls.std() - float(np.log(99.0))
    vhw = torch.tensor([[128, 192], [101, 150]], dtype=torch.int32)
    a = torch.from_numpy(anchors_for_shape((128, 192)).copy())
    got = PR.candidates(loc, cls, a, vhw, 1000)
    want, keep = R.decode(loc, cls, a, vhw, 1000)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int(want.valid.sum()) < 2000
    pkeep = PR.nms(got) & got.valid
    assert torch.equal(pkeep, keep) and 0 < int(keep.sum()) < int(
        want.valid.sum())
    slots = PR.decode(loc, cls, a, vhw, 1000)
    assert torch.equal(slots, R.packed(want, keep))
    ev = Evaluator(cfg, build_model(cfg, device="cpu"), device="cpu")
    handle = ([(slots, None, False, 1.0, 1.0)], [(128, 192), (101, 150)])
    for j, rows in enumerate(ev.gather(handle)):
        np.testing.assert_array_equal(rows, R.rows(slots[j]))


@pytest.mark.parametrize("shape", [(1152, 2048), (128, 192), (72, 100)])
def test_anchors_follow_the_ports_rounding(shape):
    """Equal to the port's anchors; within one float32 ulp of the larger
    of the coordinate and its base offset of the upstream module's single
    rounding (the departure the reference's docstring names)."""
    got = R.anchors(shape)
    np.testing.assert_array_equal(got, anchors_for_shape(shape))
    base = [np.array([[-0.5 * w, -0.5 * w * r, w - 0.5 * w,
                       w * r - 0.5 * w * r]
                      for r in (0.5, 1.0, 2.0)
                      for s in (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
                      for w in [np.sqrt((size * s) ** 2 / r)]])
            for size in (16, 64, 128)]
    once, offset = [], []
    for level, b in zip((3, 4, 5), base):
        st = 2 ** level
        cx, cy = np.meshgrid((np.arange(-(-shape[1] // st)) + 0.5) * st,
                             (np.arange(-(-shape[0] // st)) + 0.5) * st)
        shift = np.stack([cx.ravel(), cy.ravel()] * 2, 1)
        once.append((shift[:, None] + b[None]).reshape(-1, 4))
        offset.append(np.broadcast_to(b[None], (len(shift), *b.shape))
                      .reshape(-1, 4))
    once = np.concatenate(once).astype(np.float32)
    # the base offset's rounding, and the result's
    mag = np.maximum(np.abs(once), np.abs(np.concatenate(offset)))
    ulp = np.spacing(mag.astype(np.float32))
    assert np.all(np.abs(got - once) <= ulp)


def test_sound_run_is_correct():
    ok, numbers = _correct(tiny_cell())
    assert ok, numbers


def test_weights_recipe_sets_the_valid_candidates():
    """The reference's decode of the calibration frames with the cell's
    weights leaves `valid_per_image` candidates an image on average: the
    threshold is bisected on the same float32 outputs, so the mean may
    fall short of the target by the last frame's step (one candidate
    over four frames) and by a score rounded across 0.1, not more."""
    cell = tiny_cell()
    with torch.device("meta"):
        shapes = R.RetinaNet(**anchor_eval.arch(cell))
    ref = anchor_eval.reference(cell, anchor_eval.weights_for(cell, shapes))
    w = cell.config["weights"]
    images = frames(cell.seed, w["calibration_frames"],
                    tuple(w["calibration_hw"]))
    x, bucket, vhw = anchor_eval._inputs(cell, images)
    with torch.no_grad(), f32_numerics():
        c, _ = R.decode(*ref(x), anchor_eval.anchors(cell, bucket), vhw,
                        cell.config["decode"]["topk"])
    mean = float(c.valid.sum(1).float().mean())
    assert w["valid_per_image"] - 1.0 <= mean <= w["valid_per_image"], mean


def _perturbed_cls(monkeypatch):
    inner = PR.RetinaNet.forward

    def forward(self, x):
        loc, cls = inner(self, x)
        g = torch.Generator(device=cls.device).manual_seed(0)
        return loc, cls + 0.5 * torch.randn(cls.shape, generator=g,
                                            device=cls.device)

    monkeypatch.setattr(PR.RetinaNet, "forward", forward)


def _flipped_keep_bit(monkeypatch):
    inner = PR.nms

    def nms(c):
        keep = inner(c).clone()
        keep[:, 0] = ~keep[:, 0]     # slot 0 is the best valid anchor
        return keep

    monkeypatch.setattr(PR, "nms", nms)


@pytest.mark.parametrize("fault", [_perturbed_cls, _flipped_keep_bit])
def test_a_fault_in_the_port_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    ok, numbers = _correct(tiny_cell())
    assert not ok, numbers


class _Untraced:
    """`utils.tracing` as a port without RetinaNet's spans sees it."""

    @staticmethod
    def span(name, **attrs):
        return contextlib.nullcontext()

    @staticmethod
    def count(name, n=1):
        pass


def test_a_port_without_retinanet_spans_stops_in_set_up(monkeypatch):
    monkeypatch.setattr(PR, "tracing", _Untraced)
    with pytest.raises(RuntimeError, match="cannot run this cell"):
        anchor_eval.run(tiny_cell(seconds=60.0))


def test_fp8_control_fails():
    got = anchor_eval.controls(tiny_cell(seed=21), frames_checked=2)
    judged = harness.judge(got["fp8"], tiny_cell().limits)
    assert not judged["out_gap"]["ok"], got
    assert got["fp8"]["candidate_mismatch"] == got["fp8"]["rows_gap"] == 0


def test_spans_once_a_forward_and_anchors_built_once_a_shape():
    cfg = tcfg.set_by_path(tcfg.PRESETS["retinanet"](), "model.backbone",
                           "resnet10")
    ev = Evaluator(cfg, build_model(cfg, device="cpu"), device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (100, 140, 3), np.uint8)
    names = ("retinanet.backbone", "retinanet.fpn", "retinanet.heads",
             "retinanet.decode", "retinanet.nms")
    tracing.clear()
    tracing.enable()
    try:
        seen = []
        for _ in range(2):
            ev.predict_batch([img, img])
            recs = tracing.records()
            tracing.clear()
            counts = {}
            for r in recs:
                for k, n in r["counts"].items():
                    counts[k] = counts.get(k, 0) + n
            seen.append(([r["name"] for r in recs], counts))
    finally:
        tracing.disable()
        tracing.clear()
    n = len(anchors_for_shape((128, 256)))
    for i, (spans, counts) in enumerate(seen):
        assert all(spans.count(s) == 1 for s in names), spans
        assert counts["retinanet.anchors"] == 2 * n
        assert counts.get("retinanet.anchor_builds", 0) == (1 - i)


def test_retina_span_readers_on_a_hand_built_record(monkeypatch):
    """Batches 1 and 2 dispatched inside the quiet pass ([0, 100] ms of
    device work), batch 7 after it: host ms a batch in the body's and
    the tail's spans of batches 1 and 2 alone."""
    from rrbench import trace as btrace
    t0 = 1_700_000_000 * 10 ** 9

    def rec(name, batch, a, b):
        return {"id": 0, "name": name, "attrs": {}, "thread": 1,
                "parent": None, "batch": batch, "counts": {},
                "start_ns": t0 + int(a * 1e6), "end_ns": t0 + int(b * 1e6)}

    def s(ms):
        return (t0 + int(ms * 1e6)) * 1e-9

    quiet = btrace.Pass([("k", s(0), s(100))], [], (s(10), s(90)))
    recs = [rec("eval.dispatch", 1, 5, 25),
            rec("retinanet.backbone", 1, 6, 16), rec("retinanet.fpn", 1,
                                                     16, 18),
            rec("retinanet.heads", 1, 18, 22), rec("retinanet.decode", 1,
                                                   22, 23),
            rec("retinanet.nms", 1, 23, 25),
            rec("eval.dispatch", 2, 40, 60),
            rec("retinanet.backbone", 2, 41, 49), rec("retinanet.fpn", 2,
                                                      49, 50),
            rec("retinanet.heads", 2, 50, 54), rec("retinanet.decode", 2,
                                                   54, 56),
            rec("retinanet.nms", 2, 56, 57),
            rec("eval.dispatch", 7, 200, 220),
            rec("retinanet.backbone", 7, 201, 219)]
    run = {"trace": btrace.Trace(quiet, quiet)}
    monkeypatch.setattr(tracing, "records", lambda: recs)
    body = harness.reader("retina_body_issue_ms.eval")
    tail = harness.reader("retina_tail_issue_ms.eval")
    assert body(run) == pytest.approx((16 + 13) / 2, abs=1e-3)
    assert tail(run) == pytest.approx((3 + 3) / 2, abs=1e-3)
    assert body({"trace": None}) is None
    monkeypatch.setattr(tracing, "records", lambda: recs[:1])
    assert body(run) is None and tail(run) is None


RUN = """
import json, sys
sys.path.insert(0, "tests")
from test_rrbench_retinanet import tiny_cell
cell = tiny_cell(seconds=0.3)
cell.driver().run(cell)
from rrbench import harness
print(json.dumps({"bad": harness.forbidden_modules(),
                  "tops": sorted({m.partition(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert {"rrnet_torch", "rrbench", "torch"} <= set(got["tops"])
