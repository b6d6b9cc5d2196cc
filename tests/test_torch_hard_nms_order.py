"""The score order of the port's hard NMS against the JAX package's (C.13).

`rrnet_tpu/ops/nms.py::hard_nms` ranks boxes by
`jnp.argsort(-jnp.where(valid, scores, -inf))`: XLA's sort puts NaN after
+inf, so a valid NaN-scored box ranks after every other box, and -0.0
equals +0.0. `rrnet_torch/ops/nms.py::score_order` gives that order on the
CPU and the card (one stable sort of `score_key`), and the plain
`hard_nms` ranks by it. Before it, the plain version sorted
`where(valid, s, -inf)` descending with torch, which ranks NaN first.

Every comparison here is exact: the orders as integer arrays, the keep
masks as booleans (the boxes keep every pair's IoU away from the
threshold, so no rounding decides a bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu.ops import nms as jnms
from rrnet_torch.ops import nms as tnms
from torch_threads import one_torch_thread  # noqa: F401


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def jax_order(scores, valid):
    return np.asarray(jax.vmap(
        lambda s, v: jnp.argsort(-jnp.where(v, s, -jnp.inf)))(
            jnp.asarray(scores), jnp.asarray(valid)))


def odd_scores(rng, b, k):
    """Scores drawn from a few values, with NaN, +-inf and +-0 among them,
    so most keys tie with others."""
    pool = np.array([0.9, 0.5, 0.5, 0.25, 0.0, -0.0, np.nan, np.inf,
                     -np.inf, 1e-30, -1e-30, 0.7], np.float32)
    return pool[rng.randint(0, len(pool), (b, k))]


@pytest.mark.parametrize("seed", range(6))
def test_score_order_equals_jax_argsort(seed):
    rng = np.random.RandomState(seed)
    b, k = 3, [1, 7, 64, 129, 300, 1000][seed]
    scores = odd_scores(rng, b, k)
    valid = rng.rand(b, k) < [0.0, 1.0, 0.8, 0.5, 0.9, 0.7][seed]
    got = tnms.score_order(t(scores), t(valid)).numpy()
    np.testing.assert_array_equal(got, jax_order(scores, valid))


def test_score_order_without_a_valid_mask():
    rng = np.random.RandomState(11)
    scores = odd_scores(rng, 2, 200)
    got = tnms.score_order(t(scores)).numpy()
    np.testing.assert_array_equal(got,
                                  jax_order(scores, np.ones((2, 200), bool)))


def test_score_key_orders_nan_last_and_zeros_equal():
    s = np.array([[np.nan, -np.inf, -0.0, 0.0, 1e-38, np.inf, -np.nan]],
                 np.float32)
    key = tnms.score_key(t(s), torch.ones(1, 7, dtype=torch.bool))[0]
    assert key.dtype == torch.int32
    assert key[0] == key[6] == -(2 ** 31) + 1      # every NaN, below -inf
    assert key[0] < key[1] < key[2] == key[3] < key[4] < key[5]
    invalid = tnms.score_key(t(s), torch.zeros(1, 7, dtype=torch.bool))[0]
    assert (invalid == key[1]).all()               # invalid scores -inf


def test_nan_score_ranks_last_as_in_jax():
    """The case that showed C.13: the NaN-scored box 1 overlaps box 0
    (IoU 0.82) and box 2 (box 0's twin). JAX ranks it last, so box 0 is
    kept and suppresses both; ranking it first kept box 1 alone."""
    boxes = np.array([[[0, 0, 10, 10], [1, 0, 11, 10], [0, 0, 10, 10]]],
                     np.float32)
    scores = np.array([[0.9, np.nan, 0.5]], np.float32)
    got = tnms.hard_nms(t(boxes), t(scores), 0.5).numpy()
    assert got.tolist() == [[True, False, False]]
    want = np.asarray(jnms.hard_nms(jnp.asarray(boxes[0]),
                                    jnp.asarray(scores[0]), 0.5))
    assert got[0].tolist() == want.tolist()


def cluster_boxes(rng, b, k, n_obj=6, span=60.0):
    """k boxes jittered around n_obj centres, widths 8-16, on a 0.25 px
    grid, so boxes of one object overlap far above 0.5 and pairs of
    different objects barely or not at all."""
    centre = rng.rand(b, n_obj, 2) * span
    which = rng.randint(0, n_obj, (b, k))
    c = np.take_along_axis(centre, which[..., None], 1)
    c = c + rng.randint(-4, 5, (b, k, 2)) * 0.25
    wh = 8.0 + rng.randint(0, 33, (b, k, 2)) * 0.25
    return np.round(np.concatenate([c - wh / 2, c + wh / 2], -1) * 4) / 4


def order_cases():
    """(name, boxes, scores, valid, cls)."""
    rng = np.random.RandomState(5)
    b, k = 2, 60
    boxes = cluster_boxes(rng, b, k).astype(np.float32)
    cls = rng.randint(0, 3, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) < 0.8
    nan = rng.rand(b, k).astype(np.float32)
    nan[:, ::4] = np.nan
    inf = rng.rand(b, k).astype(np.float32)
    inf[:, ::5] = np.inf
    inf[:, 1::5] = -np.inf
    zeros = np.where(rng.rand(b, k) < 0.5, 0.0, -0.0).astype(np.float32)
    ties = rng.randint(0, 3, (b, k)).astype(np.float32) / 2
    return [
        ("nan", boxes, nan, valid, cls),
        ("nan_no_mask", boxes, nan, None, None),
        ("inf", boxes, inf, valid, cls),
        ("signed_zeros", boxes, zeros, valid, None),
        ("ties", boxes, ties, valid, cls),
        ("odd", boxes, odd_scores(rng, b, k), valid, cls),
        ("all_invalid", boxes, nan, np.zeros((b, k), bool), cls),
    ]


ORDER_NAMES = [c[0] for c in order_cases()]


def jax_keep(boxes, scores, valid, cls, thr, method):
    if valid is None:
        valid = np.ones(scores.shape, bool)

    def one(b, s, v, c):
        return jnms.hard_nms(b, s, thr, valid=v, class_ids=c, method=method)

    if cls is None:
        return np.asarray(jax.vmap(lambda b, s, v: one(b, s, v, None))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)))
    return np.asarray(jax.vmap(one)(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), jnp.asarray(cls)))


@pytest.mark.parametrize("per_class", [True, False])
@pytest.mark.parametrize("method", ["fixpoint", "sequential"])
@pytest.mark.parametrize("name", ORDER_NAMES)
def test_plain_hard_nms_equals_jax_on_odd_scores(name, method, per_class):
    _, boxes, scores, valid, cls = next(c for c in order_cases()
                                        if c[0] == name)
    cls = cls if per_class else None
    got = tnms.hard_nms(t(boxes), t(scores), 0.5, t(valid), t(cls)).numpy()
    want = jax_keep(boxes, scores, valid, cls, 0.5, method)
    np.testing.assert_array_equal(got, want)
