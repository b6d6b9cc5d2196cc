"""The port's layers, backbone and heads against the flax modules of the
JAX package: same numpy inputs, flax weights (with randomised BN
statistics) carried across by rrnet_torch.utils.from_flax. The flax
modules run with train=False, so the port's run in eval mode.

Tolerance: atol/rtol 1e-4 in f32 on feature maps and head outputs, for
convolutions that sum in another order in the two frameworks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from rrnet_tpu.models import heads as jheads
from rrnet_tpu.models import layers as jlayers
from rrnet_tpu.models.backbones import get_backbone as j_get_backbone
from rrnet_tpu.models.backbones.hourglass import HGResidual as JHGResidual
from rrnet_torch.models import heads as theads
from rrnet_torch.models import layers as tlayers
from rrnet_torch.models.backbones import get_backbone as t_get_backbone
from rrnet_torch.models.backbones.hourglass import HGResidual as THGResidual
from rrnet_torch.utils.from_flax import load_flax_variables

TOL = dict(atol=1e-4, rtol=1e-4)


def randomize_bn(variables, seed=0):
    """Numpy copy of flax variables with BN scale/bias/mean/var drawn at
    random, so the folded BN affine is really exercised."""
    rng = np.random.RandomState(seed)

    def walk(tree, in_bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_bn or k == "BatchNorm_0")
                continue
            v = np.asarray(v, np.float32)
            if in_bn and k in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif in_bn and k in ("bias", "mean"):
                v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            out[k] = v
        return out

    return walk(jax.tree.map(np.asarray, dict(variables)), False)


def flax_init(module, *args, seed=0, **kw):
    v = jax.jit(lambda *a: module.init(jax.random.PRNGKey(seed), *a, **kw))(
        *args)
    return randomize_bn(v, seed)


def flax_apply(module, v, *args, **kw):
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(v, *args)


def nhwc(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def from_nchw(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_conv_bn_relu_matches():
    x = nhwc(0, 2, 9, 11, 6)
    jm = jlayers.ConvBN(8, kernel=3, stride=2)
    v = flax_init(jm, jnp.asarray(x))
    tm = load_flax_variables(tlayers.ConvBN(6, 8, 3, 2), v).eval()
    np.testing.assert_allclose(from_nchw(tm(to_nchw(x))),
                               np.asarray(flax_apply(jm, v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("hw", [(64, 96), (63, 95)])
def test_stem_conv_matches_s2d(hw):
    x = nhwc(1, 1, *hw, 3)
    jm = jlayers._StemConv(16)
    v = flax_init(jm, jnp.asarray(x))
    tm = tlayers.stem_conv(3, 16)
    tm.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        v["params"]["kernel"].transpose(3, 2, 0, 1)))})
    np.testing.assert_allclose(from_nchw(tm(to_nchw(x))),
                               np.asarray(flax_apply(jm, v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("cin,feat,stride", [(8, 8, 1), (8, 12, 2)])
def test_hg_residual_matches(cin, feat, stride):
    x = nhwc(2, 2, 10, 10, cin)
    jm = JHGResidual(feat, stride=stride)
    v = flax_init(jm, jnp.asarray(x))
    tm = load_flax_variables(THGResidual(cin, feat, stride), v).eval()
    np.testing.assert_allclose(from_nchw(tm(to_nchw(x))),
                               np.asarray(flax_apply(jm, v, jnp.asarray(x))), **TOL)


def test_bottleneck_matches():
    x = nhwc(3, 4, 3, 3, 16)
    jm = jlayers.Bottleneck(planes=8)
    v = flax_init(jm, jnp.asarray(x))
    tm = load_flax_variables(tlayers.Bottleneck(16, 8), v).eval()
    np.testing.assert_allclose(from_nchw(tm(to_nchw(x))),
                               np.asarray(flax_apply(jm, v, jnp.asarray(x))), **TOL)


# 64x64 halves exactly at every level; 72x72 reaches an odd level (9 ->
# 5), where the upsample follows jax.image.resize's nearest rule
@pytest.mark.parametrize("hw", [(64, 64), (72, 72)])
def test_tiny_hourglass_matches(hw):
    x = nhwc(4, 2, *hw, 3)
    jm = j_get_backbone("tiny_hourglass", 2)
    v = flax_init(jm, jnp.asarray(x), train=False)
    tm = load_flax_variables(t_get_backbone("tiny_hourglass", 2),
                             v).eval()
    want = flax_apply(jm, v, jnp.asarray(x), train=False)
    got = tm(to_nchw(x))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(from_nchw(g), np.asarray(w), **TOL)


class _Stacks(fnn.Module):
    """Calls a per-stack flax head for both stacks, so init makes both
    parameter sets."""
    head: fnn.Module

    @fnn.compact
    def __call__(self, x):
        return [self.head(x, i) for i in range(2)]


def _head_case(jhead, thead, x):
    jm = _Stacks(jhead)
    v = flax_init(jm, jnp.asarray(x))
    inner = {c: t["head"] for c, t in v.items()}
    thead = load_flax_variables(thead, inner).eval()
    want = flax_apply(jm, v, jnp.asarray(x))
    for i in range(2):
        np.testing.assert_allclose(thead(to_nchw(x), i).detach().numpy(),
                                   np.asarray(want[i]), **TOL)
    return inner


def test_centernet_head_matches():
    x = nhwc(5, 2, 6, 7, 16)
    v = _head_case(jheads.CenterNetHead(10, is_heatmap=True, mid_channels=24),
                   theads.CenterNetHead(10, is_heatmap=True, mid_channels=24,
                                        in_channels=16), x)
    assert np.allclose(v["params"]["out0"]["bias"], -2.19)


def test_wh_head_matches_with_w_then_h():
    x = nhwc(6, 2, 19, 21, 16)
    jh = jheads.CenterNetWHHead(1, kernel=17, mid_channels=24)
    th = theads.CenterNetWHHead(1, kernel=17, mid_channels=24, in_channels=16)
    v = _head_case(jh, th, x)
    # channel 0 is the row (1 x k) conv's W, channel 1 the column conv's H
    th.wconv0.weight.data.zero_()
    th.wconv0.bias.data.fill_(3.0)
    out = th(to_nchw(x), 0).detach().numpy()
    assert np.all(out[..., 0] == 3.0) and not np.all(out[..., 1] == 3.0)
    assert v["params"]["hconv0"]["kernel"].shape == (17, 1, 24, 1)


def test_fasterrcnn_head_matches():
    x = nhwc(7, 5, 3, 3, 32)
    jm = jheads.FasterRCNNHead()
    v = flax_init(jm, jnp.asarray(x))
    tm = load_flax_variables(theads.FasterRCNNHead(32), v).eval()
    np.testing.assert_allclose(tm(to_nchw(x)).detach().numpy(),
                               np.asarray(flax_apply(jm, v, jnp.asarray(x))), **TOL)


def test_init_weights_is_seeded():
    def make(seed):
        m = t_get_backbone("tiny_hourglass", 1)
        return tlayers.init_weights(m, torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["pre_conv.weight"], sc["pre_conv.weight"])
    w = sa["pre_conv.weight"]           # U(+-1/sqrt(fan_in)), fan_in 7*7*3
    assert w.abs().max() <= 1 / np.sqrt(147) and w.std() > 0.03
