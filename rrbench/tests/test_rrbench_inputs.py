"""The inputs are the seed's alone: the same seed gives the same frames
and weights, another seed other ones."""

import numpy as np
import pytest
import torch

from rrbench.frames import frames
from rrbench.weights import make_weights

BIG = 2 ** 31 + 12345


def test_frames_follow_the_seed():
    a, b, c = (frames(s, 2, (120, 200)) for s in (BIG, BIG, BIG + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])
    assert a[0].shape == (120, 200, 3) and a[0].dtype == np.uint8


@pytest.mark.parametrize("seed", [0, BIG])
def test_weights_follow_the_seed(seed):
    shapes = [("a.weight", (8, 4, 3, 3)), ("bn.weight", (8,)),
              ("bn.bias", (8,)), ("bn.running_mean", (8,)),
              ("bn.running_var", (8,)), ("hm.out0.bias", (10,))]
    w1, w2 = (make_weights(shapes, seed, "cpu") for _ in range(2))
    w3 = make_weights(shapes, seed + 1, "cpu")
    for k in w1:
        assert torch.equal(w1[k], w2[k])
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert w1["a.weight"].abs().max() <= 1 / 6
    assert (w1["hm.out0.bias"] == -2.19).all()
    assert ((w1["bn.running_var"] >= 0.9) & (w1["bn.running_var"] <= 1.1)).all()
