"""The port's int8 Evaluator and Predictor (`Evaluator(quantize="int8")`,
`calibrate`, `update_variables`, `Predictor.warmup`'s refusal) against
the JAX package's, on the CPU, with the tiny RRNet of
tests/test_torch_rrnet.py (tiny_hourglass, widths 64-96, f32) and its
converted weights.

Calibration: both sides calibrate on the same wire rows; the JAX scope
paths map onto the port's module names through `quant_scales_from_flax`
(the same key set), and the values agree within 1e-6 relative (a conv's
input comes from f32 convolutions that sum in another order in the two
frameworks). Detections: the port runs with the JAX scales, so every
quantizer has the same step on both sides. The float parts between the
quantized convs (the stem, each BN's folded affine, the stage-1 heads)
still differ by an ulp or so, and a value on a rounding boundary lands
one int8 step apart (1/127 of the absmax); over the 48 quantized convs
this moves the head outputs by ~1% of their range. Each image has the
same number of rows on both sides, and at least 85% of them (14 of 16)
match one to one within 0.1 px and 1e-3 in score (same class): the rest
are other ROIs picked among scores tied within ~1e-3 on the saturated
heatmap (tests/test_torch_rrnet.py scales its logits up). The int8
arithmetic itself is held bit-equal in tests/test_torch_int8.py.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu.evallib.infer import Evaluator as JEvaluator
from rrnet_tpu.evallib.infer import StagedBatch as JStagedBatch
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.models import layers as tlayers
from rrnet_torch.serving import Predictor as TPredictor
from rrnet_torch.utils.from_flax import (quant_scales_from_flax,
                                         quant_scales_to_flax)
from tests.test_torch_eval_protocol import frames
from tests.test_torch_rrnet import configs, tiny_pair
from torch_threads import one_torch_thread  # noqa: F401


def matched(got, want, box_tol, score_tol):
    """Rows of `got` matched one to one by a row of `want` of the same
    class within the tolerances."""
    used = np.zeros(len(want), bool)
    for row in got:
        ok = (~used & (want[:, 5] == row[5])
              & (np.abs(want[:, 4] - row[4]) <= score_tol)
              & (np.abs(want[:, :4] - row[:4]).max(1) <= box_tol))
        if ok.any():
            used[np.argmax(ok)] = True
    return int(used.sum())


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def port_ev(tm, scales=(1.0,), **kw):
    _, tc = configs(**{"val.scales": scales})
    return TEvaluator(tc, tm, device="cpu", bucket_multiple=32,
                      quantize="int8", **kw)


def test_int8_evaluator_matches_jax(pair):
    jm, v, tm = pair
    jc, _ = configs(**{"val.scales": (1.0,)})
    je = JEvaluator(jc, v, model=jm, bucket_multiple=32, quantize="int8")
    te = port_ev(copy.deepcopy(tm))
    imgs = frames(0)
    tst = te._upload(imgs)
    jst = JStagedBatch((jnp.asarray(tst.payload.numpy()),), tst.bucket,
                       tst.hws, tst.tight)
    want = je.calibrate(jst)
    got = te.calibrate(tst)
    mapped = quant_scales_from_flax(want)
    assert set(mapped) == set(got) and len(got) == 48
    assert quant_scales_to_flax(got).keys() == want.keys()
    names = {n for n, m in te.model.named_modules()
             if isinstance(m, tlayers.Conv2d)}
    assert set(got) <= names
    for k in got:
        np.testing.assert_allclose(got[k], mapped[k], rtol=1e-6, atol=0)
    te._quant_scales = mapped
    rows_j = je.collect(je.dispatch_batch(jst))
    rows_t = te.collect(te.dispatch_batch(tst))
    for g, w in zip(rows_t, rows_j):
        assert g.shape == w.shape and len(w) == 16
        assert matched(g, w, box_tol=0.1, score_tol=1e-3) >= 0.85 * len(w)
    # the int8 path really ran: the rows differ from the float path's
    float_rows = TEvaluator(configs(**{"val.scales": (1.0,)})[1],
                            te.model, device="cpu",
                            bucket_multiple=32).predict_batch(imgs)
    assert any(not np.array_equal(a, b) for a, b in zip(rows_t, float_rows))


def test_calibration_runs_each_distinct_scale_and_keeps_the_max(pair):
    tm = copy.deepcopy(pair[2])
    calls = []
    tm.register_forward_hook(lambda m, a, out: calls.append(a[0].shape))
    imgs = frames(1)
    both = port_ev(tm, (1.0, 1.5, 1.0)).calibrate(imgs)
    assert [s[-2:] for s in calls] == [(96, 128), (160, 192)]
    one = port_ev(tm, (1.0,)).calibrate(imgs)
    big = port_ev(tm, (1.5,)).calibrate(imgs)
    assert both.keys() == one.keys() == big.keys()
    assert both == {k: max(one[k], big[k]) for k in one}
    assert any(big[k] > one[k] for k in one)


def test_lazy_calibration_on_the_first_batch(pair):
    tm = copy.deepcopy(pair[2])
    imgs = frames(2)
    lazy = port_ev(tm)
    assert lazy._quant_scales is None
    got = lazy.predict_batch(imgs)
    explicit = port_ev(tm)
    assert lazy._quant_scales == explicit.calibrate(imgs)
    for a, b in zip(got, explicit.predict_batch(imgs)):
        np.testing.assert_array_equal(a, b)


def test_update_variables_drops_scales_and_packed_weights(pair):
    tm = copy.deepcopy(pair[2])
    imgs = frames(3)
    ev = port_ev(tm)
    first = ev.predict_batch(imgs)
    convs = [m for m in tm.modules() if isinstance(m, tlayers.Conv2d)]
    assert sum(m._int8 is not None for m in convs) == 48
    state = {k: t.clone() for k, t in tm.state_dict().items()}
    ev.update_variables(state)
    assert ev._quant_scales is None
    assert all(m._int8 is None for m in convs)
    again = ev.predict_batch(imgs)        # recalibrates lazily
    assert ev._quant_scales is not None
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_predictor_refuses_uncalibrated_int8_warmup(pair):
    tm = copy.deepcopy(pair[2])
    _, tc = configs()
    pred = TPredictor(tc, tm, device="cpu", bucket_multiple=32,
                      image_shapes=((90, 100),), quantize="int8")
    with pytest.raises(RuntimeError, match="calibrate"):
        pred.warmup()
    scales = pred.calibrate(frames(4))
    assert len(scales) == 48
    assert pred.warmup() == 1 and pred.warmed_up
    assert pred.bucket_of(np.zeros((90, 100, 3), np.uint8)) == (96, 128)
    pred.update_variables(tm.state_dict())
    assert not pred.warmed_up and pred._ev._quant_scales is None


def test_quantize_argument_and_no_eligible_conv(pair):
    _, tc = configs()
    tm = copy.deepcopy(pair[2])
    with pytest.raises(ValueError, match="quantize"):
        TEvaluator(tc, tm, device="cpu", quantize="fp8")
    for m in tm.modules():
        if isinstance(m, tlayers.Conv2d):
            m.quantizable = False
    with pytest.raises(RuntimeError, match="no conv ranges"):
        port_ev(tm).calibrate(frames(5))
