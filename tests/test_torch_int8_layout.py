"""The int8 convolution's layouts, schedule and contract, on the CPU.

The kernel (`rrnet_torch/csrc/int8_conv.cu`) cannot run here; what the
wrapper computes in Python for it can. Every distinct conv geometry that
the `rrnet`, `centernet` and `retinanet` presets calibrate (162 / 159 / 57
convs at full width, built on the meta device) is checked:

* `pack_weight`'s rows equal the JAX package's quantized weight
  (`rrnet_tpu/models/layers.py:162-166`: s_w = max(absmax, 1e-12) / 127
  per output channel, rint(w / s_w) clamped to [-127, 127]) in (ky, kx,
  c) order over the channels padded to 16, with a zero tail to K_ALIGN;
* `conv_schedule` covers each output tile's K steps exactly once, splits K
  only where the tiles leave more than half of the SMs idle and keeps a
  split's units within one wave, at the 768x1408 bucket's map sizes and
  stage 2's ROI maps;
* `conv_geometry` refuses what lies outside the kernel's contract.
"""

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from rrnet_torch.models import build_model as t_build
from rrnet_torch.models import layers as tlayers
from rrnet_torch.ops import int8_conv as ic
from torch_threads import one_torch_thread  # noqa: F401

SMS = 132                       # an H100 SXM's SMs
PRESETS = ["rrnet", "centernet", "retinanet"]
CALIBRATED = {"rrnet": 162, "centernet": 159, "retinanet": 57}
# output pixels a batch of the 768x1408 bucket puts at each stride, and
# stage 2's 3x3 ROI maps at 512 and 2048 ROIs
BUCKET_M = sorted({n * (768 // s) * (1408 // s)
                   for n in (1, 4) for s in (2, 4, 8, 16, 32, 64, 128)}
                  | {9 * 512, 9 * 2048, 1, 66})


def preset_geometries(family):
    """{(cout, cin, kh, kw, stride, pad4)} of the preset's calibrated
    convs (the JAX package's eligibility: quantizable, groups 1, at least
    32 input channels)."""
    with torch.device("meta"):
        model = t_build(tcfg.PRESETS[family](), device="meta")
    convs = [m for m in model.modules()
             if isinstance(m, tlayers.Conv2d) and m.quantizable
             and m.groups == 1 and m.weight.shape[1] >= 32]
    assert len(convs) == CALIBRATED[family]
    return sorted({(*m.weight.shape, ic._pair(m.stride), m.pad4())
                   for m in convs})


@pytest.fixture(scope="module")
def geometries():
    return {f: preset_geometries(f) for f in PRESETS}


@pytest.mark.parametrize("family", PRESETS)
def test_packed_rows_equal_jax_quantized_weight(family, geometries):
    import jax.numpy as jnp
    shapes = sorted({g[:4] for g in geometries[family]})
    rng = np.random.RandomState(len(shapes))
    for cout, cin, kh, kw in shapes:
        kernel = (rng.randn(kh, kw, cin, cout) * 0.1).astype(np.float32)
        kernel[..., cout // 2] = 0.0           # the 1e-12 floor
        wf = jnp.asarray(kernel)
        s_w = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12) / 127.0
        wq = np.asarray(jnp.clip(jnp.round(wf / s_w), -127, 127)
                        .astype(jnp.int8))
        pw = ic.pack_weight(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
        cp = ic.padded_channels(cin)
        k = kh * kw * cp
        kp = -(-k // ic.K_ALIGN) * ic.K_ALIGN
        assert tuple(pw.rows.shape) == (cout, kp) and pw.rows.dtype == \
            torch.int8 and pw.rows.is_contiguous()
        rows = pw.rows.numpy()
        assert not rows[:, k:].any()
        taps = rows[:, :k].reshape(cout, kh, kw, cp)
        np.testing.assert_array_equal(taps[..., :cin].transpose(1, 2, 3, 0),
                                      wq)
        assert not taps[..., cin:].any()
        np.testing.assert_array_equal(pw.s_w.numpy(), np.asarray(s_w))
        np.testing.assert_array_equal(pw.wq.numpy().transpose(2, 3, 1, 0), wq)


def walk(plan):
    """{tile: [K steps]} of every unit in the order the kernel's blocks
    take them (`unit_of` in int8_conv.cu), and the units each block takes."""
    steps, blocks = {}, [0] * plan.grid
    for u in range(plan.units):
        split, tile = u % plan.splits, u // plan.splits
        first = split * plan.split_steps
        nk = min(plan.steps - first, plan.split_steps)
        assert nk >= 1
        steps.setdefault(tile, []).extend(range(first, first + nk))
        blocks[u % plan.grid] += 1
    return steps, blocks


@pytest.mark.parametrize("family", PRESETS)
def test_schedule_covers_each_tile_once(family, geometries):
    for cout, cin, kh, kw, _, _ in geometries[family]:
        kp = -(-kh * kw * ic.padded_channels(cin) // ic.K_ALIGN) * ic.K_ALIGN
        for m in BUCKET_M:
            plan = ic.conv_schedule(m, cout, kp, SMS)
            tiles = plan.tiles_m * plan.tiles_n
            assert plan.tiles_m == -(-m // ic.TILE_M)
            assert plan.tiles_n == -(-cout // ic.TILE_N)
            assert plan.steps == -(-kp // ic.STEP_K)
            assert plan.units == tiles * plan.splits
            steps, blocks = walk(plan)
            assert sorted(steps) == list(range(tiles))
            assert all(s == list(range(plan.steps)) for s in steps.values())
            assert plan.grid == min(plan.units, SMS) and min(blocks) >= 1
            if plan.splits > 1:
                # only where the tiles fill at most half of the SMs, and
                # then into one wave of units of at least two steps
                assert 2 * tiles <= SMS and plan.units <= SMS
                assert plan.split_steps >= ic.MIN_SPLIT_STEPS
            else:
                assert plan.split_steps == plan.steps


@pytest.mark.parametrize("family", PRESETS)
def test_geometry_accepts_the_presets_convs(family, geometries):
    """conv_geometry takes every calibrated conv of the preset at a map of
    the 768x1408 bucket and gives the plain convolution's output size."""
    for cout, cin, kh, kw, stride, pad4 in geometries[family]:
        w = torch.zeros(cout, cin, kh, kw)
        pw = ic.pack_weight(w)
        for h, wd in ((12, 22), (6, 11), (3, 3)):
            if h + pad4[0] + pad4[1] < kh or wd + pad4[2] + pad4[3] < kw:
                continue
            xq = torch.zeros(1, h, wd, ic.padded_channels(cin),
                             dtype=torch.int8)
            sh, sw, ho, wo = ic.conv_geometry(xq, pw, stride, pad4)
            want = ic.int8_conv2d_plain(xq, pw.wq, pw.s_w, 1.0, None, stride,
                                        pad4, torch.int32)
            assert (sh, sw) == stride and (1, cout, ho, wo) == tuple(
                want.shape)


def test_geometry_refuses_outside_the_contract():
    pw = ic.pack_weight(torch.ones(24, 40, 3, 3))       # Cp 48, Kp 448
    xq = torch.zeros(2, 9, 11, 48, dtype=torch.int8)
    assert ic.conv_geometry(xq, pw, 2, (0, 1, 0, 1)) == (2, 2, 4, 5)
    refusals = [
        (xq.to(torch.uint8), pw, 1, "int8"),
        (xq.transpose(1, 2), pw, 1, "contiguous"),
        (torch.zeros(2, 9, 11, 32, dtype=torch.int8), pw, 1, "channels"),
        (xq[None], pw, 1, "int8"),
        (xq, pw._replace(rows=pw.rows[:, :384].contiguous()), 1, "rows"),
        (xq, pw._replace(rows=torch.zeros(24, 480, dtype=torch.int8)), 1,
         "rows"),
        (xq, pw._replace(rows=pw.rows.to(torch.int32)), 1, "rows"),
        (xq, pw._replace(rows=pw.rows[:12]), 1, "rows"),
        (xq, pw._replace(rows=torch.zeros(24, 449, dtype=torch.int8)
                         [:, 1:]), 1, "rows"),
        (xq, pw, 0, "empty output"),
        (xq, pw, (1, -1), "empty output"),
        (torch.zeros(2, 1, 11, 48, dtype=torch.int8), pw, 1, "empty output"),
    ]
    for x, w, stride, match in refusals:
        with pytest.raises(ValueError, match=match):
            ic.conv_geometry(x, w, stride, (0, 0, 0, 0))
    # the rows must be 16-byte aligned for the weights' tensor map
    buf = torch.zeros(24 * 448 + 8, dtype=torch.int8)
    off = (-buf.data_ptr()) % 16 + 8
    odd = pw._replace(rows=buf[off:off + 24 * 448].view(24, 448))
    with pytest.raises(ValueError, match="rows"):
        ic.conv_geometry(xq, odd, 1, (1, 1, 1, 1))
    # 32-bit pixel indices
    big = torch.empty(2, 32768, 32768, 48, dtype=torch.int8, device="meta")
    meta_pw = pw._replace(rows=pw.rows.to("meta"))
    with pytest.raises(ValueError, match="2\\^31"):
        ic.conv_geometry(big, meta_pw, 1, (1, 1, 1, 1))


def test_int8_conv2d_refuses_before_any_device():
    """The refusals that hold on every device, before the CPU's plain
    version: grouped, dilated, another output dtype, pads."""
    xq = torch.zeros(1, 4, 4, 32, dtype=torch.int8)
    pw = ic.pack_weight(torch.ones(8, 32, 3, 3))
    for kw, err in (({"groups": 2}, ValueError), ({"dilation": 2}, ValueError),
                    ({"dilation": (1, 2)}, ValueError),
                    ({"out_dtype": torch.float16}, TypeError),
                    ({"pad4": (1, 1, 1)}, ValueError),
                    ({"pad4": (1, -1, 1, 1)}, ValueError)):
        with pytest.raises(err):
            ic.int8_conv2d(xq, pw, 1.0, **kw)
