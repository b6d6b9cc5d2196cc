"""`layers.ResidualBlock` and `RRNet.forward(roi_jitter=)` against the
JAX package.

ResidualBlock: the flax module's weights (BN statistics drawn at random)
carried across by `from_flax`, eval form, f32, within atol/rtol 1e-5.
roi_jitter: the tiny RRNet of tests/test_torch_rrnet.py with a numpy
jitter of 1.5 feature px, at that file's parity tolerances (maps and
deltas 1e-4, ROIs 1e-3 px, classes, validity and order equal); the
port's returned ROIs are its unjittered ROIs plus the jitter exactly, and
a zero jitter changes no bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu.models import layers as jlayers
from rrnet_torch.models import layers as tlayers
from rrnet_torch.utils.from_flax import load_flax_variables
from tests.test_torch_layers import flax_apply, flax_init, from_nchw, nhwc, to_nchw
from tests.test_torch_rrnet import TOL, images, tiny_pair
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("cin,features,stride", [(8, 8, 1), (8, 8, 2),
                                                 (6, 8, 1), (6, 8, 2)])
def test_residual_block_matches_flax(cin, features, stride):
    x = nhwc(3, 2, 10, 9, cin)
    jm = jlayers.ResidualBlock(features, stride=stride)
    v = flax_init(jm, jnp.asarray(x))
    tm = load_flax_variables(
        tlayers.ResidualBlock(cin, features, stride), v).eval()
    assert (tm.skip_conv is None) == (stride == 1 and cin == features)
    with torch.no_grad():
        got = from_nchw(tm(to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(flax_apply(jm, v,
                                                          jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


def test_rrnet_roi_jitter_matches_jax():
    jm, v, tm = tiny_pair()
    x = images()
    jit = (np.random.RandomState(7).randn(2, 16, 4) * 1.5).astype(np.float32)
    want = jax.jit(lambda v, x, j: jm.apply(v, x, train=False,
                                            roi_jitter=j))(
        v, jnp.asarray(x), jnp.asarray(jit))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = tm(xt, roi_jitter=torch.from_numpy(jit))
        plain = tm(xt)
        zero = tm(xt, roi_jitter=torch.zeros(2, 16, 4))
    np.testing.assert_array_equal(got.roi_valid.numpy(),
                                  np.asarray(want.roi_valid))
    np.testing.assert_array_equal(got.roi_classes.numpy(),
                                  np.asarray(want.roi_classes))
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.stage2_reg.numpy(),
                               np.asarray(want.stage2_reg), **TOL)
    assert torch.equal(got.rois, plain.rois + torch.from_numpy(jit))
    assert not torch.equal(got.stage2_reg, plain.stage2_reg)
    for a, b in zip(zero, plain):
        for ta, tb in zip(a if isinstance(a, tuple) else (a,),
                          b if isinstance(b, tuple) else (b,)):
            assert torch.equal(ta, tb)
    assert got.roi_valid.any()
