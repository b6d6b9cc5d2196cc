"""The port's spans and counters (rrnet_torch.utils.tracing), on the CPU:
off by default and then free of any profiler record function; on under
`enable()`
or any torch.profiler session, with nesting, threads, batch ids and
counters; on the clock of the profiler's own events (within 250 us); the
span tree of a tiny-RRNet `evaluate_split`, whose result files tracing
does not change; and the benchmark's six readers of the spans
(`rrbench/metrics/`), on a hand-built run record.
"""

import collections
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rrbench import harness
from rrbench import trace as btrace
from rrnet_torch import config as tcfg
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.models import build_model
from rrnet_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r["name"]].append(r)
    return out


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record function {name!r} entered")

    monkeypatch.setattr(tracing, "_RecordFunction", refuse)
    monkeypatch.setattr(tracing._autograd_profiler, "record_function", refuse)
    with tracing.span("a", k=1) as s:
        tracing.count("c", 3)
        with tracing.span("b"):
            pass
    assert s is None and tracing.span("x") is tracing.span("y")
    assert tracing.records() == []


def test_enabled_spans_nest_carry_threads_batches_and_counts():
    tracing.enable()
    main = threading.get_ident()
    with tracing.batch(7):
        with tracing.span("outer", scale=1.5):
            tracing.count("n")
            with tracing.span("inner"):
                tracing.count("n", 2)
                tracing.count("m")
            tracing.count("n")

    def work():
        with tracing.span("worker"):
            tracing.count("w")
        return threading.get_ident()

    def in_batch(k):
        with tracing.batch(k):
            return work()

    with ThreadPoolExecutor(1) as pool:
        other = pool.submit(in_batch, 8).result()
        pool.submit(work).result()
    with tracing.span("after"):
        pass
    got = _by_name(tracing.records())
    outer, inner = got["outer"][0], got["inner"][0]
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["attrs"] == {"scale": 1.5} and inner["attrs"] == {}
    assert outer["counts"] == {"n": 2} and inner["counts"] == {"n": 2, "m": 1}
    assert outer["thread"] == inner["thread"] == main != other
    assert outer["batch"] == inner["batch"] == 7
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]
    w8, w_none = got["worker"]
    assert w8["thread"] == w_none["thread"] == other
    assert (w8["batch"], w_none["batch"], got["after"][0]["batch"]) == \
        (8, None, None)
    assert w8["parent"] is None and w8["counts"] == {"w": 1}
    tracing.disable()
    with tracing.span("off"):
        tracing.count("n")
    assert "off" not in _by_name(tracing.records())


def test_the_store_is_bounded_and_drops_the_oldest(monkeypatch, tmp_path):
    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=4))
    tracing.enable()
    for i in range(6):
        with tracing.span(f"s{i}"):
            pass
    assert [r["name"] for r in tracing.records()] == ["s2", "s3", "s4", "s5"]
    path = tracing.write(str(tmp_path / "spans.jsonl"))
    lines = [json.loads(ln) for ln in open(path)]
    assert lines == tracing.records()
    tracing.clear()
    assert tracing.records() == []


def test_a_profiler_session_turns_spans_on_on_its_own_clock(tmp_path):
    x = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("probe.outer"):
            for _ in range(3):
                with tracing.span("probe.inner"):
                    x = x @ x.T / 64
    with tracing.span("probe.after"):      # the session is over: off
        pass
    ours = _by_name(tracing.records())
    assert set(ours) == {"probe.outer", "probe.inner"}
    assert len(ours["probe.outer"]) == 1 and len(ours["probe.inner"]) == 3
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("probe."):
            events[e.name()].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    for name, recs in ours.items():
        kineto = sorted(events[name])
        assert len(kineto) == len(recs), name
        for rec, (s, e) in zip(sorted(recs, key=lambda r: r["start_ns"]),
                               kineto):
            assert abs(rec["start_ns"] - s) <= 250_000, name
            assert abs(rec["end_ns"] - e) <= 250_000, name
    # operators of the function scope, not user annotations (which Kineto
    # mirrors onto the device's timeline under CUDA activity)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        cats = {e["cat"] for e in json.load(f)["traceEvents"]
                if e.get("name", "").startswith("probe.")}
    assert cats == {"cpu_op"}


class _Split:
    """Five small uint8 images in one 64x128 bucket."""

    def __init__(self):
        rng = np.random.RandomState(3)
        self.items = [{"name": f"im{i}",
                       "image": (rng.rand(h, w, 3) * 255).astype(np.uint8)}
                      for i, (h, w) in enumerate([(60, 100), (56, 128),
                                                  (64, 90), (48, 70),
                                                  (64, 128)])]

    def __iter__(self):
        return iter(self.items)


@pytest.mark.parametrize("attention,auto_test", [(False, True),
                                                 (True, False)])
def test_evaluate_split_span_tree_and_equal_files(tmp_path, attention,
                                                  auto_test):
    scales = (1.0, 1.5)
    cfg = tcfg.rrnet_config(**{
        "model.backbone": "tiny_hourglass", "model.topk": 32,
        "model.stage2_rois": 8, "model.dtype": "float32",
        "model.with_self_attention": attention, "val.scales": scales,
        "val.auto_test": auto_test, "val.score_threshold": 0.0})
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    split = _Split()
    off = Evaluator(cfg, model, device="cpu", bucket_multiple=64)
    off.evaluate_split(split, str(tmp_path / "off"), batch_size=2,
                       verbose=False)
    assert tracing.records() == []
    tracing.enable()
    ev = Evaluator(cfg, model, device="cpu", bucket_multiple=64)
    ev.evaluate_split(split, str(tmp_path / "on"), batch_size=2,
                      verbose=False)
    names = sorted(os.listdir(tmp_path / "off"))
    assert names == sorted(os.listdir(tmp_path / "on")) and len(names) == 5
    for n in names:
        assert (tmp_path / "off" / n).read_bytes() == \
            (tmp_path / "on" / n).read_bytes()

    recs = tracing.records()
    ids = {r["id"]: r for r in recs}
    main = threading.get_ident()
    for b in range(3):          # two full batches, one padded
        mine = [r for r in recs if r["batch"] == b]
        got = _by_name(mine)
        # the last batch's second read is the one that finds the end
        assert len(got["eval.read"]) == 2
        (disp,) = got["eval.dispatch"]
        assert disp["thread"] == main and disp["parent"] is None
        assert disp["counts"] == ({"eval.new_shapes": len(scales)} if b == 0
                                  else {})
        progs = got["eval.program"]
        assert [p["attrs"]["scale"] for p in progs] == list(scales)
        assert all(p["parent"] == disp["id"] for p in progs)
        for p in progs:
            kids = [r["name"] for r in mine if r["parent"] == p["id"]]
            want = ["rrnet.backbone"]
            want += (["rrnet.attention", "rrnet.heads"] if attention
                     else ["rrnet.heads"]) * cfg.model.num_stacks
            want += ["rrnet.decode", "rrnet.nms", "rrnet.roi_align",
                     "rrnet.stage2"]
            assert kids == want
            (body,) = [r for r in mine if r["parent"] == p["id"]
                       and r["name"] == "rrnet.backbone"]
            assert {r["name"] for r in mine if r["parent"] == body["id"]} \
                == {"backbone.block"}
        (stage,) = got["eval.stage"]
        assert stage["thread"] != main and stage["parent"] is None
        assert [r["name"] for r in mine if r["parent"] == stage["id"]] == \
            ["eval.stage.pad", "eval.stage.pack", "eval.stage.copy"]
        (wait,) = got["eval.wait_upload"]
        (coll,) = got["eval.collect"]
        (write,) = got["eval.write"]
        assert wait["thread"] == coll["thread"] == write["thread"] == main
        assert wait["end_ns"] <= disp["start_ns"]
        assert coll["end_ns"] <= write["start_ns"]
        kids = [r for r in mine if r["parent"] == coll["id"]]
        assert [r["name"] for r in kids] == \
            ["eval.copy"] * len(scales) + ["eval.rows"] + \
            ([] if auto_test else ["eval.merge"])
        assert all(r["counts"] == {"eval.d2h_syncs": 1} for r in kids
                   if r["name"] == "eval.copy")
        for r in mine:
            if r["parent"] is not None:
                assert ids[r["parent"]]["batch"] == b
    assert {r["batch"] for r in recs} == {0, 1, 2}


# -- the benchmark's readers on a hand-built run record ------------------
T0 = 1_700_000_000 * 10 ** 9      # a time.time_ns() of the epoch's clock
MAIN, UPLOAD = 11, 22


def _rec(name, batch, start_ms, end_ms, thread=MAIN):
    return {"id": 0, "name": name, "attrs": {}, "thread": thread,
            "parent": None, "batch": batch, "counts": {},
            "start_ns": T0 + int(start_ms * 1e6),
            "end_ns": T0 + int(end_ms * 1e6)}


def _s(ms):
    return (T0 + int(ms * 1e6)) * 1e-9


def _hand_built():
    """A quiet pass with device operations at [0, 10], [30, 60] and
    [80, 100] ms (steady window [10, 90] ms: idle [10, 30] and [60, 80],
    50%), batches 1 and 2 dispatched inside it, one batch of a later pass
    and a span of the upload thread that must not count."""
    dev = [("k", _s(a), _s(b)) for a, b in ((0, 10), (30, 60), (80, 100))]
    quiet = btrace.Pass(dev, [], (_s(10), _s(90)))
    recs = [
        _rec("eval.dispatch", 1, 5, 25),
        _rec("rrnet.backbone", 1, 6, 20), _rec("rrnet.attention", 1, 20, 22),
        _rec("rrnet.heads", 1, 22, 24),
        _rec("eval.stage", 2, 12, 28, thread=UPLOAD),
        _rec("eval.wait_upload", 2, 35, 40),
        _rec("eval.dispatch", 2, 40, 62),
        _rec("rrnet.backbone", 2, 41, 55), _rec("rrnet.heads", 2, 55, 57),
        _rec("rrnet.decode", 2, 57, 58), _rec("rrnet.nms", 2, 58, 60),
        _rec("rrnet.roi_align", 2, 60, 61), _rec("rrnet.stage2", 2, 61, 62),
        _rec("eval.collect", 1, 62, 75), _rec("eval.copy", 1, 63, 70),
        _rec("eval.write", 1, 75, 77),
        _rec("eval.collect", 2, 95, 105), _rec("eval.copy", 2, 95, 104),
        _rec("eval.write", 2, 105, 106),
        _rec("eval.dispatch", 7, 200, 220),
        _rec("rrnet.backbone", 7, 201, 219),
    ]
    return {"trace": btrace.Trace(quiet, quiet)}, recs


READERS = {"body_issue_ms.eval": (14 + 2 + 14) / 2,
           "tail_issue_ms.eval": (2 + 2 + 1 + 2 + 1 + 1) / 2,
           "result_wait_ms.eval": (7 + 9) / 2,
           "drain_ms.eval": (13 + 2 + 10 + 1 - 7 - 9) / 2,
           "idle_issue.eval": 100 * (15 + 2) / 80,
           "idle_between.eval": 100 * (13 + 2) / 80}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers_on_a_hand_built_record(monkeypatch, metric):
    rec, recs = _hand_built()
    monkeypatch.setattr(tracing, "records", lambda: recs)
    assert harness.reader(metric)(rec) == pytest.approx(READERS[metric],
                                                        abs=1e-3)
    assert harness.reader(metric)({"trace": None}) is None
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert harness.reader(metric)(rec) is None


def test_span_readers_split_the_idle_time(monkeypatch):
    rec, recs = _hand_built()
    monkeypatch.setattr(tracing, "records", lambda: recs)
    idle = harness.reader("device_idle.eval")(rec)
    issue = harness.reader("idle_issue.eval")(rec)
    between = harness.reader("idle_between.eval")(rec)
    assert idle == pytest.approx(50.0, abs=1e-3)
    assert issue + between <= idle
    man = harness.manifest()
    for name in READERS:
        (entry,) = [m for m in man["per_layer"] if m["name"] == name]
        assert entry["moves"] == "eval_images_per_s"
        want = ["rrnet-eval6", "hrnet_attn-eval6"]
        if not name.startswith(("body_", "tail_")):
            # the readers of the Evaluator's own spans read every cell
            want.append("retinanet-eval1080")
        assert entry["workloads"] == want
