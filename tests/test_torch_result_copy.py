"""Result copies of the eval path (`Evaluator._dispatch` / `gather`).

On the CPU a dispatched handle holds each program's packed (B, K, 6) rows
themselves, with no event, and each `eval.copy` span counts one
`eval.d2h_syncs` and nothing else; `evaluate_split` writes one result
file per image, equal byte for byte to `predict_batch`'s rows written by
`save_result`, over two buckets with padded leftovers, on one replica or
two. The card's route is checked on the host with stand-in events: the
rows are the same, each copy waits on its own event and counts
`eval.results_ready` or `eval.results_waited`.

The `cuda` cases run on the card, with

    python -m pytest --noconftest -m cuda tests/test_torch_result_copy.py

and hold the real route to its promise: batches k and k+1 are collected
while the stream still sleeps behind them, and their rows equal those of
a blocking copy of the same device tensors, bit for bit.
"""

import os
import time

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.evallib.writer import load_result, save_result
from rrnet_torch.models import build_model
from rrnet_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401


def tiny_rrnet(**over):
    cfg = tcfg.rrnet_config(**{
        "model.backbone": "tiny_hourglass", "model.topk": 32,
        "model.stage2_rois": 8, "model.dtype": "float32",
        "val.scales": (1.0, 1.5), "val.flip_tta": False,
        "val.score_threshold": 0.0, **over})
    torch.manual_seed(0)
    return cfg, build_model(cfg, device="cpu")


def images(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in sizes]


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def copy_counts():
    return [r["counts"] for r in tracing.records() if r["name"] == "eval.copy"]


def same_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("flip", [False, True])
def test_cpu_handle_holds_the_packed_rows_and_counts_one_sync(flip):
    cfg, model = tiny_rrnet(**{"val.flip_tta": flip})
    ev = Evaluator(cfg, model, device="cpu", bucket_multiple=64)
    imgs = images([(60, 70), (50, 64)])
    tracing.enable()
    pending, hws = handle = ev.dispatch_batch(imgs)
    assert hws == [(60, 70), (50, 64)]
    assert len(pending) == len(cfg.val.scales)
    for packed, landed, f, ry, rx in pending:
        assert isinstance(packed, torch.Tensor) and landed is None
        assert packed.device.type == "cpu"
        assert packed.shape == (2 * len(imgs) if flip else len(imgs),
                                cfg.model.stage2_rois, 6)
        assert f == ("both" if flip else False) and ry >= 1 and rx >= 1
    rows = ev.collect(handle)
    assert copy_counts() == [{"eval.d2h_syncs": 1}] * len(pending)
    tracing.disable()
    same_rows(rows, ev.predict_batch(imgs))


class StandIn:
    """The host side of a `torch.cuda.Event`: `query` answers `ready`,
    `synchronize` is logged."""

    def __init__(self, ready, log):
        self.ready, self.log = ready, log

    def query(self):
        self.log.append(("query", self))
        return self.ready

    def synchronize(self):
        self.log.append(("synchronize", self))


@pytest.mark.parametrize("ready", [(True, True), (False, True),
                                   (False, False)])
def test_events_are_waited_on_one_by_one_and_counted(ready):
    cfg, model = tiny_rrnet()
    ev = Evaluator(cfg, model, device="cpu", bucket_multiple=64)
    imgs = images([(60, 70), (64, 100)], seed=1)
    pending, hws = ev.dispatch_batch(imgs)
    plain = ev.gather((pending, hws))
    log = []
    events = [StandIn(r, log) for r in ready]
    evented = [(p.clone(), e, f, ry, rx)
               for (p, _, f, ry, rx), e in zip(pending, events)]
    tracing.enable()
    got = ev.gather((evented, hws))
    same_rows(got, plain)
    assert log == [(k, e) for e in events for k in ("query", "synchronize")]
    assert copy_counts() == [
        {"eval.d2h_syncs": 1,
         ("eval.results_ready" if r else "eval.results_waited"): 1}
        for r in ready]


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_evaluate_split_writes_one_file_an_image_as_predict_batch(
        tmp_path, devices):
    cfg, model = tiny_rrnet(**{"val.scales": (1.0,)})
    ev = Evaluator(cfg, model, device="cpu", bucket_multiple=64,
                   devices=devices)
    # two buckets at batch 2: 5 images of 60x70 (2 full batches and a
    # padded one) and 3 of 100x120 (1 full and a padded one)
    sizes = [(60, 70)] * 5 + [(100, 120)] * 3
    imgs = images(sizes, seed=2)
    split = [{"name": f"img{i:03d}", "image": im}
             for i, im in enumerate(imgs)]
    out = ev.evaluate_split(split, result_dir=str(tmp_path / "split"),
                            batch_size=2, verbose=False)
    files = sorted(os.listdir(out))
    assert files == [f"img{i:03d}.txt" for i in range(8)]
    groups = [[0, 1], [2, 3], [4, 4], [5, 6], [7, 7]]
    direct = {}
    for g in groups:
        for i, pred in zip(g, ev.predict_batch([imgs[i] for i in g])):
            direct.setdefault(i, pred)
    for i, f in enumerate(files):
        assert load_result(os.path.join(out, f)).shape[1] >= 6
        save_result(str(tmp_path / "direct.txt"), direct[i])
        assert (tmp_path / "direct.txt").read_bytes() == \
            open(os.path.join(out, f), "rb").read()
    few = ev.evaluate_split(split, result_dir=str(tmp_path / "few"),
                            batch_size=4, max_images=3, verbose=False)
    assert sorted(os.listdir(few)) == [f"img{i:03d}.txt" for i in range(3)]


# -- on the card ---------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("flip", [False, True])
def test_cuda_collect_waits_only_for_its_own_batch(cuda_device, flip,
                                                   monkeypatch):
    """Batches k and k+1 dispatched, then a ~0.5 s sleep queued behind
    them: both are collected while the stream still sleeps, which a
    blocking copy (queued behind the sleep) could not do. The sleep goes
    last because the launch queue holds only so many launches: a whole
    dispatch behind a long kernel blocks in `cudaLaunchKernel` until the
    kernel ends."""
    cfg, model = tiny_rrnet(**{"val.flip_tta": flip,
                               "val.scales": (1.0, 1.25, 1.5)})
    ev = Evaluator(cfg, model, device=cuda_device, bucket_multiple=64)
    imgs = images([(60, 70), (64, 128), (40, 90)], seed=4)
    # builds the kernels, plans cuDNN and leaves two batches' pinned
    # blocks free in the host cache
    warm = [ev.dispatch_batch(imgs) for _ in range(2)]
    for handle in warm:
        ev.collect(handle)
    del warm, handle
    kept = []
    forward = ev._forward

    def keep(x, vhw):
        out = forward(x, vhw)
        kept.append(out)
        return out

    monkeypatch.setattr(ev, "_forward", keep)
    programs = len(cfg.val.scales)
    tracing.enable()
    first = ev.dispatch_batch(imgs)
    torch.cuda.synchronize()              # batch k's copies have landed
    second = ev.dispatch_batch(imgs)
    torch.cuda._sleep(1_000_000_000)      # ~0.5 s at the H100's clock
    t0 = time.perf_counter()
    rows = ev.gather(first)
    rows_next = ev.gather(second)
    t1 = time.perf_counter()
    assert not torch.cuda.current_stream().query(), f"gather {t1 - t0:.3f} s"
    counts = copy_counts()
    assert counts[:programs] == [
        {"eval.d2h_syncs": 1, "eval.results_ready": 1}] * programs
    assert all(c["eval.d2h_syncs"] == 1 and len(c) == 2 and
               c.keys() <= {"eval.d2h_syncs", "eval.results_ready",
                            "eval.results_waited"} for c in counts)
    assert len(counts) == 2 * programs
    tracing.disable()
    torch.cuda.synchronize()
    for handle, got, packed in ((first, rows, kept[:programs]),
                                (second, rows_next, kept[programs:])):
        pending, hws = handle
        assert all(h.is_pinned() and h.device.type == "cpu"
                   for h, _, _, _, _ in pending)
        blocking = [(p.cpu(), None, f, ry, rx)
                    for p, (_, _, f, ry, rx) in zip(packed, pending)]
        same_rows(got, ev.gather((blocking, hws)))
        assert sum(len(r) for r in got) > 0
