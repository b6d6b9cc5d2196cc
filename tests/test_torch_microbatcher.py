"""The port's `MicroBatcher` (rrnet_torch/serving.py; port of
rrnet_tpu/serving.py:190-353), on the CPU.

The JAX package's batcher tests (tests/test_serving.py:64-176) run here
against a stub predictor with no model, whose rows for an image are a
function of that image alone ([h, w, pixel mean, ...]), so that a
future's rows show whether it got its own request's result; a short
sleep in `dispatch` stands in for the device. One more test serves a
small real `Predictor` (the tiny RRNet, f32, seeded weights) and holds
every future bit-equal to `predict_batch` of the group it was batched in.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from rrnet_torch.evallib.infer import _round_up
from rrnet_torch.models import build_model
from rrnet_torch.models.layers import init_weights
from rrnet_torch.serving import MicroBatcher, Predictor


class StubPredictor:
    """The surface MicroBatcher uses, with no model. `staged` records each
    group's images; `in_flight_max` the most groups dispatched and not
    yet collected."""

    def __init__(self, delay_s=0.0, fail_on=None):
        self.delay_s = delay_s
        self.fail_on = fail_on        # (phase, image height) that raises
        self.staged = []
        self.in_flight = self.in_flight_max = 0
        self.lock = threading.Lock()

    def bucket_of(self, image):
        return (_round_up(image.shape[0], 64), _round_up(image.shape[1], 64))

    def _maybe_fail(self, phase, images):
        if self.fail_on is not None and self.fail_on[0] == phase and any(
                im.shape[0] == self.fail_on[1] for im in images):
            raise ValueError(f"{phase} failed")

    def stage(self, images):
        self._maybe_fail("stage", images)
        self.staged.append(list(images))
        return list(images)

    def dispatch(self, staged):
        self._maybe_fail("dispatch", staged)
        with self.lock:
            self.in_flight += 1
            self.in_flight_max = max(self.in_flight_max, self.in_flight)
        return staged

    def collect(self, handle):
        time.sleep(self.delay_s)
        with self.lock:
            self.in_flight -= 1
        self._maybe_fail("collect", handle)
        return [self.predict(im) for im in handle]

    def predict(self, image):
        return np.array([[image.shape[0], image.shape[1], image.mean(), 1.0,
                          0.5, 1.0]])


def _img(rng, h=100, w=150):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def test_defaults_and_argument_checks():
    mb = MicroBatcher(StubPredictor())
    assert (mb.max_batch, mb.max_delay, mb.pipeline_depth) == (8, 0.004, 2)
    mb.close()
    with pytest.raises(ValueError):
        MicroBatcher(StubPredictor(), max_batch=0)
    with pytest.raises(ValueError):
        MicroBatcher(StubPredictor(), pipeline_depth=0)


def test_microbatcher_results_match_individual():
    """A burst batches, and every future resolves to its request's rows."""
    pred = StubPredictor(delay_s=0.01)
    rng = np.random.RandomState(2)
    imgs = [_img(rng) for _ in range(6)]
    with MicroBatcher(pred, max_batch=4, max_delay_ms=50.0) as mb:
        futs = [mb.submit(im) for im in imgs]
        outs = [f.result(timeout=30) for f in futs]
    for im, got in zip(imgs, outs):
        np.testing.assert_array_equal(got, pred.predict(im))
    assert max(mb.batch_sizes) > 1 and sum(mb.batch_sizes) == 6
    assert max(mb.batch_sizes) <= 4


def test_microbatcher_routes_results_to_their_requests():
    """Two same-bucket images of different extents batched together: each
    future gets its own image's rows."""
    pred = StubPredictor()
    rng = np.random.RandomState(5)
    big, small = _img(rng, 120, 190), _img(rng, 70, 130)
    assert pred.bucket_of(big) == pred.bucket_of(small)
    with MicroBatcher(pred, max_batch=4, max_delay_ms=100.0) as mb:
        f_big, f_small = mb.submit(big), mb.submit(small)
        p_big, p_small = f_big.result(timeout=30), f_small.result(timeout=30)
    assert mb.batch_sizes[-1] == 2
    assert tuple(p_big[0, :2]) == (120, 190)
    assert tuple(p_small[0, :2]) == (70, 130)


def test_microbatcher_groups_by_bucket():
    pred = StubPredictor()
    rng = np.random.RandomState(3)
    small = [_img(rng, 60, 60) for _ in range(2)]   # 64x64 bucket
    big = [_img(rng, 100, 150) for _ in range(2)]   # 128x192 bucket
    with MicroBatcher(pred, max_batch=8, max_delay_ms=100.0) as mb:
        futs = [mb.submit(im) for im in small + big]
        outs = [f.result(timeout=30) for f in futs]
    assert all(o.shape == (1, 6) for o in outs)
    assert sorted(mb.batch_sizes[-2:]) == [2, 2]
    assert all(len({pred.bucket_of(im) for im in g}) == 1
               for g in pred.staged)


def test_microbatcher_close_rejects_and_drains():
    """close() serves everything submitted before it, then refuses."""
    pred = StubPredictor(delay_s=0.02)
    rng = np.random.RandomState(4)
    imgs = [_img(rng) for _ in range(7)]
    mb = MicroBatcher(pred, max_batch=2, max_delay_ms=1.0)
    futs = [mb.submit(im) for im in imgs]
    mb.close()
    for im, f in zip(imgs, futs):
        np.testing.assert_array_equal(f.result(timeout=30), pred.predict(im))
    assert not mb._worker.is_alive()
    with pytest.raises(RuntimeError):
        mb.submit(imgs[0])


def test_microbatcher_surfaces_errors_and_survives():
    """A malformed request fails its own future at once; the worker lives
    on and serves the next request."""
    rng = np.random.RandomState(6)
    with MicroBatcher(StubPredictor(), max_batch=2, max_delay_ms=1.0) as mb:
        fut = mb.submit("not an image")
        with pytest.raises(Exception) as ei:
            fut.result(timeout=10)
        assert not isinstance(ei.value, TimeoutError)
        assert mb._worker.is_alive()
        assert mb.submit(_img(rng)).result(timeout=30).shape == (1, 6)


@pytest.mark.parametrize("phase", ["stage", "dispatch", "collect"])
def test_a_failing_group_fails_only_its_futures(phase):
    """A stage, dispatch or collect that raises fails the futures of its
    group, and only those."""
    pred = StubPredictor(fail_on=(phase, 60))
    rng = np.random.RandomState(9)
    bad, good = _img(rng, 60, 60), _img(rng, 100, 150)
    with MicroBatcher(pred, max_batch=8, max_delay_ms=100.0) as mb:
        f_bad, f_good = mb.submit(bad), mb.submit(good)
        with pytest.raises(ValueError, match=f"{phase} failed"):
            f_bad.result(timeout=30)
        np.testing.assert_array_equal(f_good.result(timeout=30),
                                      pred.predict(good))
        assert mb.submit(good).result(timeout=30).shape == (1, 6)


def test_microbatcher_cancelled_future_does_not_abort_drain():
    rng = np.random.RandomState(7)
    with MicroBatcher(StubPredictor(delay_s=0.01), max_batch=4,
                      max_delay_ms=50.0) as mb:
        f1 = mb.submit(_img(rng))
        f1.cancel()
        f2 = mb.submit(_img(rng))
        assert f2.result(timeout=30).shape == (1, 6)
        assert mb._worker.is_alive()
    assert f1.cancelled() or f1.done()


def test_microbatcher_pipelined_stream_matches_sequential():
    """An open-loop stream at batch 1 with pipeline_depth 2 keeps two
    batches in flight and resolves each future to its own rows, in
    order."""
    pred = StubPredictor(delay_s=0.02)
    rng = np.random.RandomState(8)
    imgs = [_img(rng) for _ in range(5)]
    with MicroBatcher(pred, max_batch=1, max_delay_ms=0.0,
                      pipeline_depth=2) as mb:
        futs = [mb.submit(im) for im in imgs]
        got = [f.result(timeout=30) for f in futs]
    for im, g in zip(imgs, got):
        np.testing.assert_array_equal(g, pred.predict(im))
    assert mb.batch_sizes == [1] * 5
    assert pred.in_flight_max == 2


def test_many_clients_each_get_their_own_rows():
    """16 client threads (more than the cores) submit 12 requests each
    with the interpreter switching threads every microsecond: every
    future resolves to its own image's rows and the batch sizes add up."""
    pred = StubPredictor()
    rng = np.random.RandomState(11)
    imgs = [_img(rng, 60 + (i % 50), 64 + (i % 7)) for i in range(192)]
    got = [None] * len(imgs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with MicroBatcher(pred, max_batch=8, max_delay_ms=1.0) as mb:
            def client(t):
                futs = [(i, mb.submit(imgs[i]))
                        for i in range(t, len(imgs), 16)]
                for i, f in futs:
                    got[i] = f.result(timeout=60)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    for im, rows in zip(imgs, got):
        np.testing.assert_array_equal(rows, pred.predict(im))
    assert sum(mb.batch_sizes) == len(imgs) and max(mb.batch_sizes) <= 8


@pytest.fixture(scope="module")
def small_predictor():
    cfg = tcfg.rrnet_config(**{"model.backbone": "tiny_hourglass",
                               "model.topk": 64, "model.stage2_rois": 16,
                               "model.dtype": "float32"})
    model = init_weights(build_model(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    return Predictor(cfg, model, device="cpu", bucket_multiple=64,
                     image_shapes=((100, 150),))


def test_real_predictor_futures_equal_predict_batch_of_their_groups(
        small_predictor):
    """The tiny RRNet behind a MicroBatcher: every future bit-equal to its
    image's rows in predict_batch of the group it was batched in; a new
    state dict resets warmed_up."""
    pred = small_predictor
    pred.warmup()
    rng = np.random.RandomState(10)
    imgs = [_img(rng, 100 - 3 * i, 150 - 5 * i) for i in range(5)]
    groups = []
    stage = pred.stage
    pred.stage = lambda images: (groups.append(list(images)),
                                 stage(images))[1]
    try:
        with MicroBatcher(pred, max_batch=4, max_delay_ms=200.0) as mb:
            futs = [mb.submit(im) for im in imgs]
            got = [f.result(timeout=120) for f in futs]
    finally:
        del pred.stage
    assert sorted(mb.batch_sizes) == [1, 4]
    seen = 0
    for group in groups:
        want = pred.predict_batch(group)
        for im, rows in zip(group, want):
            i = next(j for j, x in enumerate(imgs) if x is im)
            np.testing.assert_array_equal(got[i], rows)
            assert rows.shape[1] == 6
            seen += 1
    assert seen == 5
    pred.update_variables(pred._ev.model.state_dict())
    assert not pred.warmed_up
