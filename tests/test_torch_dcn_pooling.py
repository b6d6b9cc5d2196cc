"""`ops.dcn.deform_psroi_pooling` and `models.modules.DCNPooling` against
the JAX package's, f32 on the CPU.

The JAX pooling takes one image's map and ignores the ROIs' batch index;
the port pools each ROI on its own image, so the JAX side is run on every
image and each ROI's own row picked, as its `DCNPooling` does. ROIs lie
inside, partly outside, are degenerate or reversed, and sit on images 0
and 1 (one with a fractional index). Tolerances: outputs within 1e-5
(atol and rtol); the gradient of the output's sum with respect to the
fc1-fc3 weights within 1e-5 as well, with `fc3` drawn nonzero so
that the offset pass moves its samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu.models import modules as jmodules
from rrnet_tpu.ops import dcn as jdcn
from rrnet_torch.models.modules import DCNPooling
from rrnet_torch.ops.dcn import deform_psroi_pooling
from rrnet_torch.utils.from_flax import load_flax_variables
from torch_threads import one_torch_thread  # noqa: F401

ROIS = np.array([[0, 1, 2, 30, 40], [1, -10, -5, 8, 9], [1, 5, 5, 5, 5],
                 [0, 40, 40, 20, 10], [1.7, 3.4, 2.5, 50.5, 20],
                 [1, 6, 3, 9, 12]], np.float32)
B, H, W = 2, 12, 14


def jax_per_own_image(feat, rois, trans, **kw):
    """JAX pooling of each ROI on its own image: (R, p, p, C)."""
    per = [np.asarray(jdcn.deform_psroi_pooling(
        jnp.asarray(feat[i]), jnp.asarray(rois),
        None if trans is None else jnp.asarray(trans), **kw))
        for i in range(feat.shape[0])]
    idx = np.clip(rois[:, 0].astype(np.int32), 0, feat.shape[0] - 1)
    return np.stack(per)[idx, np.arange(len(rois))]


@pytest.mark.parametrize("group_size", [1, 3])
@pytest.mark.parametrize("with_trans", [False, True])
def test_deform_psroi_pooling_matches_jax(group_size, with_trans):
    rng = np.random.RandomState(group_size)
    od = 4
    feat = rng.randn(B, H, W, od * group_size ** 2).astype(np.float32)
    trans = (rng.randn(len(ROIS), 2, 3, 3).astype(np.float32)
             if with_trans else None)
    kw = dict(spatial_scale=0.5, pooled_size=3, output_dim=od,
              group_size=group_size, sample_per_part=2, trans_std=0.3)
    want = jax_per_own_image(feat, ROIS, trans, **kw)
    got = deform_psroi_pooling(
        torch.from_numpy(feat.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(ROIS), None if trans is None
        else torch.from_numpy(trans), **kw)
    assert got.shape == (len(ROIS), od, 3, 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-5, rtol=1e-5)
    if with_trans:      # the offsets moved the samples
        plain = jax_per_own_image(feat, ROIS, None, **kw)
        assert np.abs(plain - want).max() > 1e-2


def dcn_pooling_pair(seed=0):
    """(flax module, variables with fc3 drawn nonzero, port module,
    NHWC feature)."""
    kw = dict(spatial_scale=0.5, pooled_size=3, output_dim=4,
              sample_per_part=2, trans_std=0.1, deform_fc_dim=16)
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, H, W, 4).astype(np.float32)
    jm = jmodules.DCNPooling(**kw)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(feat),
                jnp.asarray(ROIS))
    v = jax.tree.map(np.asarray, v)
    fc3 = v["params"]["fc3"]
    assert not fc3["kernel"].any()          # zero init, as the reference
    fc3["kernel"] = (rng.randn(*fc3["kernel"].shape) * 0.5).astype(np.float32)
    fc3["bias"] = (rng.randn(*fc3["bias"].shape) * 0.5).astype(np.float32)
    tm = load_flax_variables(DCNPooling(**kw), v)
    return jm, v, tm, feat


def test_dcn_pooling_forward_and_fc_gradients_match_jax():
    jm, v, tm, feat = dcn_pooling_pair()
    rois_j = jnp.asarray(ROIS)

    def loss(params, feat):
        return jnp.sum(jm.apply({"params": params}, feat, rois_j))

    want = jm.apply(v, jnp.asarray(feat), rois_j)
    jgrads = jax.grad(loss)(v["params"], jnp.asarray(feat))
    xt = torch.from_numpy(feat.transpose(0, 3, 1, 2).copy())
    got = tm(xt, torch.from_numpy(ROIS))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    got.sum().backward()
    for name in ("fc1", "fc2", "fc3"):
        np.testing.assert_allclose(
            getattr(tm, name).weight.grad.numpy(),
            np.asarray(jgrads[name]["kernel"]).T, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            getattr(tm, name).bias.grad.numpy(),
            np.asarray(jgrads[name]["bias"]), atol=1e-5, rtol=1e-5)
    assert tm.fc1.weight.grad.abs().max() > 0


def test_dcn_pooling_fresh_module_is_the_plain_pass_at_half_mask():
    """fc3 starts at zero: no offsets, and a mask of sigmoid(0) = 0.5;
    `no_trans` is the plain pass alone, with no trunk."""
    from rrnet_torch.models.layers import init_weights
    kw = dict(spatial_scale=0.5, pooled_size=3, output_dim=4,
              sample_per_part=2)
    feat = torch.from_numpy(np.random.RandomState(1).randn(
        B, 4, H, W).astype(np.float32))
    rois = torch.from_numpy(ROIS)
    m = init_weights(DCNPooling(deform_fc_dim=16, **kw),
                     torch.Generator().manual_seed(0))
    plain = deform_psroi_pooling(feat, rois, None, **kw)
    with torch.no_grad():
        assert torch.equal(m(feat, rois), plain * 0.5)
        bare = DCNPooling(no_trans=True, **kw)
        assert not list(bare.parameters())
        assert torch.equal(bare(feat, rois), plain)
