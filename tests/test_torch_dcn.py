"""The port's DCNv2 (rrnet_torch.ops.dcn, the plain version, and
rrnet_torch.ops.deform_conv, the CUDA kernels' autograd Function) against
the JAX package.

The oracle is rrnet_tpu/ops/dcn.py::deform_conv2d and its jax.vjp, the
function both Pallas kernels are tested against (tests/test_pallas_dcn.py).
Inputs come from a numpy seed and cross between the packages as numpy
arrays (NHWC/HWIO on the JAX side, NCHW/OIHW in the port). Tolerance
rtol 1e-5 with atol 1e-5 x the largest magnitude of the reference: the
same f32 operations, summed in another order.

The CUDA kernels against the plain version run only where a card is;
the machine with the card has no JAX, so JAX is imported inside the
tests that use it, and there the CUDA cases run with

    python -m pytest --noconftest -m cuda tests/test_torch_dcn.py
"""

import numpy as np
import pytest
import torch

from rrnet_torch.ops import dcn as tdcn
from rrnet_torch.ops import deform_conv as tdc

K = 3


def make_case(b=2, h=7, w=9, cin=8, cout=6, g=4, stride=1, dilation=1,
              offsets="fractional", masked=True, seed=0, off_scale=1.5):
    """Numpy inputs in the JAX package's layouts: x NHWC, weight HWIO,
    offset / mask (B, Ho, Wo, C), cotangent (B, Ho, Wo, Cout)."""
    rng = np.random.RandomState(seed)
    pad = dilation
    ho, wo = tdcn.out_size(h, w, K, K, stride, pad, dilation)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(K, K, cin, cout) / np.sqrt(K * K * cin)).astype(np.float32)
    shape = (b, ho, wo, 2 * g * K * K)
    if offsets == "zero":
        off = np.zeros(shape, np.float32)
    elif offsets == "integer":
        off = rng.randint(-3, 4, shape).astype(np.float32)
    else:
        off = (rng.randn(*shape) * off_scale).astype(np.float32)
    mask = (rng.rand(b, ho, wo, g * K * K).astype(np.float32)
            if masked else None)
    ct = rng.randn(b, ho, wo, cout).astype(np.float32)
    kw = dict(stride=stride, padding=pad, dilation=dilation,
              deformable_groups=g)
    return (x, wt, off, mask, ct), kw


def to_port(x, wt, off, mask, ct):
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))))
    return (t(x), torch.from_numpy(np.ascontiguousarray(
        wt.transpose(3, 2, 0, 1))), t(off), t(mask), t(ct))


def from_nchw(a):
    return None if a is None else a.detach().permute(0, 2, 3, 1).numpy()


def port_grads(fn, x, wt, off, mask, ct, kw):
    """Output and (grad x, weight, offset, mask) in the JAX layouts."""
    leaves = [a.clone().requires_grad_() for a in (x, wt, off)]
    m = None if mask is None else mask.clone().requires_grad_()
    out = fn(*leaves, m, None, **kw)
    out.backward(ct)
    gw = leaves[1].grad.permute(2, 3, 1, 0).numpy()
    return (from_nchw(out), from_nchw(leaves[0].grad), gw,
            from_nchw(leaves[2].grad), None if m is None else from_nchw(m.grad))


def jax_grads(x, wt, off, mask, ct, kw):
    import jax
    import jax.numpy as jnp
    from rrnet_tpu.ops.dcn import deform_conv2d
    args = [jnp.asarray(a) for a in (x, wt, off)]
    if mask is None:
        out, vjp = jax.vjp(lambda a, b_, c: deform_conv2d(a, b_, c, None,
                                                          **kw), *args)
        return (out,) + tuple(vjp(jnp.asarray(ct))) + (None,)
    out, vjp = jax.vjp(lambda a, b_, c, d: deform_conv2d(a, b_, c, d, **kw),
                       *args, jnp.asarray(mask))
    return (out,) + tuple(vjp(jnp.asarray(ct)))


def assert_close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * scale)


NAMES = ("out", "grad_x", "grad_weight", "grad_offset", "grad_mask")

CASES = {
    "zero_g4": dict(offsets="zero"),
    "integer_g4_d2": dict(offsets="integer", dilation=2),
    "fractional_g4_d3": dict(dilation=3),
    "fractional_g1": dict(g=1),
    "integer_g1_stride2": dict(g=1, offsets="integer", stride=2),
    "fractional_g4_stride2_d2": dict(stride=2, dilation=2),
    "outside_g4": dict(off_scale=6.0),
    "zero_g1_d3_no_mask": dict(g=1, offsets="zero", dilation=3,
                               masked=False),
    "fractional_g4_no_mask": dict(masked=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_vjp(case):
    arrays, kw = make_case(**CASES[case])
    if case.startswith("outside"):   # samples really leave the image
        h, w = arrays[0].shape[1:3]
        off = arrays[2]
        assert (np.abs(off) > max(h, w)).any()
    got = port_grads(tdcn.deform_conv2d, *to_port(*arrays), kw)
    ref = jax_grads(*arrays, kw)
    for name, g, r in zip(NAMES, got, ref):
        if r is None:
            assert g is None, name
            continue
        assert_close(g, r)


def test_plain_matches_pallas_at_fractional_offsets():
    """Forward against the Pallas forward and the four gradients against
    the Pallas backward, both in interpret mode: away from the integer
    grid the tent derivative and the floor-lerp one agree."""
    import jax.numpy as jnp
    from rrnet_tpu.ops.pallas_dcn import (deform_conv2d_pallas,
                                          deform_conv2d_pallas_bwd)
    arrays, kw = make_case(h=8, w=8, cin=16, cout=8, dilation=2, seed=3)
    x, wt, off, mask, ct = arrays
    assert (off != np.round(off)).all()
    got = port_grads(tdcn.deform_conv2d, *to_port(*arrays), kw)
    j = [jnp.asarray(a) for a in arrays]
    out = deform_conv2d_pallas(*j[:4], None, interpret=True, **kw)
    grads = deform_conv2d_pallas_bwd(*j, interpret=True, **kw)
    # the Pallas kernels sum through their tent matmuls: 2e-5
    for name, g, r in zip(NAMES, got, (out,) + tuple(grads)):
        assert_close(g, r, rel=2e-5)


def test_zero_offset_grad_offset_follows_xla_vjp_not_pallas_tent():
    """On the integer grid the port's grad offset is the floor-lerp
    derivative of the ops/dcn.py VJP; the Pallas backward's tent
    derivative -sign(d) gives 0 there, a fault of the JAX reference."""
    import jax.numpy as jnp
    from rrnet_tpu.ops.pallas_dcn import deform_conv2d_pallas_bwd
    arrays, kw = make_case(g=2, h=8, w=8, cin=16, cout=16, offsets="zero",
                           seed=5)
    got = port_grads(tdcn.deform_conv2d, *to_port(*arrays), kw)
    ref = jax_grads(*arrays, kw)
    tent = deform_conv2d_pallas_bwd(*[jnp.asarray(a) for a in arrays],
                                    interpret=True, **kw)
    assert_close(got[3], ref[3])
    assert np.abs(np.asarray(tent[2])).max() == 0.0
    assert np.abs(got[3]).max() > 1.0
    # the other gradients agree with the Pallas backward here too
    for g, r in ((got[1], tent[0]), (got[2], tent[1]), (got[4], tent[3])):
        assert_close(g, r, rel=2e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_autograd_function_on_cpu_equals_plain(masked):
    arrays, kw = make_case(masked=masked, seed=7)
    x, wt, off, mask, ct = to_port(*arrays)
    bias = torch.from_numpy(np.linspace(-1, 1, 6).astype(np.float32))
    outs = []
    for fn in (tdc.deform_conv2d, tdcn.deform_conv2d):
        leaves = [a.clone().requires_grad_() for a in (x, wt, off, bias)]
        m = None if mask is None else mask.clone().requires_grad_()
        out = fn(leaves[0], leaves[1], leaves[2], m, leaves[3], **kw)
        out.backward(ct)
        outs.append([out.detach()] + [a.grad for a in leaves]
                    + ([] if m is None else [m.grad]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    torch.testing.assert_close(outs[0][4], ct.sum((0, 2, 3)))


def test_backward_reference_equals_autograd_of_plain():
    arrays, kw = make_case(seed=8)
    x, wt, off, mask, ct = to_port(*arrays)
    ref = tdc.deform_conv2d_backward_reference(x, wt, off, mask, ct, **kw)
    got = port_grads(tdcn.deform_conv2d, x, wt, off, mask, ct, kw)
    for g, r, to in zip(got[1:], ref, ("x", "w", "o", "m")):
        r = r.permute(2, 3, 1, 0) if to == "w" else from_nchw(r)
        np.testing.assert_array_equal(g, np.asarray(r))


def _port_case(**kw):
    arrays, geo = make_case(**kw)
    return to_port(*arrays), geo


@pytest.mark.parametrize("bad", ["bf16", "non_contiguous_offset",
                                 "offset_shape", "mask_shape", "groups",
                                 "weight_channels", "device"])
def test_kernel_checks_reject_what_the_kernels_do_not_take(bad):
    (x, wt, off, mask, _), kw = _port_case()
    g = kw["deformable_groups"]
    args = dict(x=x, weight=wt, offset=off, mask=mask, bias=None)
    if bad == "bf16":
        args["x"] = x.bfloat16()
        err = TypeError
    elif bad == "non_contiguous_offset":
        args["offset"] = off.transpose(2, 3).contiguous().transpose(2, 3)
        err = ValueError
    elif bad == "offset_shape":
        args["offset"] = off[:, :-2].contiguous()
        err = ValueError
    elif bad == "mask_shape":
        args["mask"] = mask[:, :, :-1].contiguous()
        err = ValueError
    elif bad == "groups":
        g = 3
        err = ValueError
    elif bad == "weight_channels":
        args["weight"] = wt[:, :-1].contiguous()
        err = ValueError
    else:
        args["mask"] = mask.to("meta")
        err = ValueError
    with pytest.raises(err):
        tdc._geometry(*args.values(), kw["stride"], kw["padding"],
                      kw["dilation"], g)


def test_geometry_of_a_valid_call():
    (x, wt, off, mask, _), kw = _port_case(stride=2, dilation=2)
    assert tdc._geometry(x, wt, off, mask, None, 2, 2, 2, 4) == (
        2, 7, 9, 8, 6, 3, 3, 4, 5, 2, 2, 2, 4)


def test_wrapper_rejects_non_cuda_devices():
    (x, wt, off, mask, ct), kw = _port_case()
    meta = [a.to("meta") for a in (x, wt, off, mask)]
    with pytest.raises(ValueError):
        tdc.deform_conv2d(*meta, **kw)
    with pytest.raises(ValueError):
        tdc.deform_conv2d_backward(x, wt, off, mask, ct, **kw)


# ---------------------------------------------------------------------------
# numerics of the kernels' tensor-core route, emulated on the CPU
# ---------------------------------------------------------------------------

def tf32(a: torch.Tensor) -> torch.Tensor:
    """`a` rounded to TF32 as `cvt.rna.tf32.f32` rounds: to 10 mantissa
    bits, to nearest, ties away from zero (the float's bits are sign and
    magnitude, so adding half of the dropped 13 bits rounds the magnitude
    half up)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_emulation():
    one = 1.0 + 2.0 ** -10                    # the TF32 neighbour of 1.0
    a = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0, 0.0,
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    want = [one, -one, 1.0, 3.0, 0.0, 1.0 + 2 * 2.0 ** -10]
    assert tf32(a).tolist() == want
    r = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    t = tf32(r)
    assert ((t.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((t - r).abs() <= r.abs() * 2.0 ** -11).all()


def test_3xtf32_split_keeps_the_kernel_tolerance_and_one_pass_does_not():
    """The forward GEMM of the CUDA kernel at the train d2 shape (4 x 256 x
    32 x 32, G = 4, 3x3, dilation 2), its products emulated exactly (in
    f64) from TF32 operands: with the 3xTF32 split (hi = tf32(a), lo =
    tf32(a - hi); lo*hi + hi*lo + hi*hi) it stays within the kernel's
    2e-5 of the largest magnitude of the f32 plain version; one TF32
    pass (hi*hi) does not."""
    arrays, kw = make_case(b=4, h=32, w=32, cin=256, cout=256, g=4,
                           dilation=2, seed=21)
    x, wt, off, mask, _ = to_port(*arrays)
    g = kw["deformable_groups"]
    wmat = wt.reshape(256, g, 256 // g, K * K)
    w_hi = tf32(wmat)
    w_lo = tf32(wmat - w_hi)
    err3 = err1 = scale = 0.0
    for i in range(x.shape[0]):              # one image at a time
        one = [a[i:i + 1] for a in (x, off, mask)]
        ref = tdcn.deform_conv2d(one[0], wt, one[1], one[2], **kw)
        s = tdcn.sampled_columns(one[0], one[1], one[2], K, K,
                                 kw["stride"], kw["padding"],
                                 kw["dilation"], g)
        s_hi = tf32(s)
        s_lo = tf32(s - s_hi)

        def gemm(a, b_):
            return torch.einsum("bgctp,ogct->bop", a.double(), b_.double())

        hi_hi = gemm(s_hi, w_hi)
        three = gemm(s_lo, w_hi) + gemm(s_hi, w_lo) + hi_hi
        ref = ref.reshape(hi_hi.shape).double()
        err3 = max(err3, float((three - ref).abs().max()))
        err1 = max(err1, float((hi_hi - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
    assert err3 <= 2e-5 * scale, err3 / scale
    assert err1 > 2e-5 * scale, err1 / scale


# ---------------------------------------------------------------------------
# on the card: kernels B.3 / B.4 against the plain version
# ---------------------------------------------------------------------------

def path_case(name):
    """Inputs at the trident path's shapes (Cin = Cout = 256, g = 4) and
    the edge cases, NCHW on the CPU: (x, weight, offset, mask, ct, kw)."""
    serve = dict(b=1, h=48, w=88, cin=256, cout=256)
    train = dict(b=4, h=32, w=32, cin=256, cout=256)
    cases = {
        "serve_d1": dict(serve, dilation=1), "serve_d2": dict(serve, dilation=2),
        "serve_d3": dict(serve, dilation=3), "train_d2": dict(train, dilation=2),
        "zero_offsets": dict(train, offsets="zero"),
        "integer_offsets": dict(train, offsets="integer", dilation=3),
        "outside": dict(b=2, h=12, w=20, cin=64, cout=64, off_scale=8.0),
        "g1_stride2": dict(b=2, h=15, w=17, cin=24, cout=40, g=1, stride=2),
        "no_mask_odd_channels": dict(b=3, h=9, w=11, cin=40, cout=70, g=2,
                                     masked=False),
        # tiles cut raggedly: positions not a multiple of the 32 of a
        # tile, Cout not a multiple of 8 (nor of 4: the weight copies'
        # 4-byte path), cpg not a multiple of 8 or of 4 (the scalar
        # gather and grad x scatter), Cout across two forward blocks
        "ragged_cout36_cpg32": dict(b=2, h=11, w=13, cin=64, cout=36, g=2),
        "cpg12_cout12": dict(b=1, h=10, w=9, cin=36, cout=12, g=3,
                             dilation=2),
        "cpg6_cout20": dict(b=2, h=7, w=13, cin=18, cout=20, g=3),
        "cpg5_cout9_no_mask": dict(b=2, h=6, w=7, cin=10, cout=9, g=2,
                                   masked=False),
        "cout300_stride2": dict(b=1, h=9, w=10, cin=16, cout=300, g=2,
                                stride=2),
        # grad weight summed over 32768 positions: each block of the
        # weight kernel takes a run of ~140 units (64 positions each)
        "long_runs_b32": dict(b=32, h=32, w=32, cin=256, cout=256),
    }
    arrays, kw = make_case(seed=11, **cases[name])
    return to_port(*arrays), kw


PATH_CASES = ["serve_d1", "serve_d2", "serve_d3", "train_d2", "zero_offsets",
              "integer_offsets", "outside", "g1_stride2",
              "no_mask_odd_channels", "ragged_cout36_cpg32", "cpg12_cout12",
              "cpg6_cout20", "cpg5_cout9_no_mask", "cout300_stride2",
              "long_runs_b32"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close_cuda(got, ref, rel):
    err = float((got - ref).abs().max())
    assert err <= rel * max(float(ref.abs().max()), 1e-30), err


@pytest.mark.cuda
@pytest.mark.parametrize("case", PATH_CASES)
def test_cuda_forward_matches_plain(cuda_device, case):
    (x, wt, off, mask, _), kw = path_case(case)
    x, wt, off = (a.to(cuda_device) for a in (x, wt, off))
    mask = None if mask is None else mask.to(cuda_device)
    bias = torch.linspace(-1, 1, wt.shape[0], device=cuda_device)
    before = tdc.fwd_launches
    got = tdc.deform_conv2d(x, wt, off, mask, bias, **kw)
    torch.cuda.synchronize()
    assert tdc.fwd_launches == before + 1
    ref = tdcn.deform_conv2d(x, wt, off, mask, bias, **kw)
    # f32 sums of up to 2304 products in another order
    _close_cuda(got, ref, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PATH_CASES)
def test_cuda_backward_matches_autograd_of_plain(cuda_device, case):
    (x, wt, off, mask, ct), kw = path_case(case)
    dev = cuda_device
    x, wt, off, ct = (a.to(dev) for a in (x, wt, off, ct))
    mask = None if mask is None else mask.to(dev)
    before = tdc.bwd_launches
    got = tdc.deform_conv2d_backward(x, wt, off, mask, ct, **kw)
    torch.cuda.synchronize()
    assert tdc.bwd_launches == before + 1
    ref = tdc.deform_conv2d_backward_reference(x, wt, off, mask, ct, **kw)
    # atomics sum grad x and grad weight in a run-dependent order
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            _close_cuda(g, r, 5e-5)


@pytest.mark.cuda
def test_cuda_backward_at_the_cout_limit_and_above(cuda_device):
    """The backward kernel keeps a block's cotangent (32 positions x Cout)
    in shared memory: Cout up to `max_cout()` runs and matches the plain
    version, one more raises before any launch."""
    limit = tdc.max_cout()
    assert limit >= 512
    for cout in (limit, limit + 1):
        (x, wt, off, mask, ct), kw = _port_case(b=1, h=5, w=6, cin=8,
                                                cout=cout, g=2, seed=13)
        x, wt, off, mask, ct = (a.to(cuda_device)
                                for a in (x, wt, off, mask, ct))
        before = tdc.bwd_launches
        if cout > limit:
            with pytest.raises(ValueError):
                tdc.deform_conv2d_backward(x, wt, off, mask, ct, **kw)
            assert tdc.bwd_launches == before
            continue
        got = tdc.deform_conv2d_backward(x, wt, off, mask, ct, **kw)
        torch.cuda.synchronize()
        ref = tdc.deform_conv2d_backward_reference(x, wt, off, mask, ct,
                                                   **kw)
        for g, r in zip(got, ref):
            _close_cuda(g, r, 5e-5)


@pytest.mark.cuda
def test_cuda_autograd_function_matches_plain(cuda_device):
    (x, wt, off, mask, ct), kw = path_case("g1_stride2")
    leaves = []
    for fn in (tdc.deform_conv2d, tdcn.deform_conv2d):
        ts = [a.to(cuda_device).requires_grad_() for a in (x, wt, off, mask)]
        b = torch.zeros(wt.shape[0], device=cuda_device, requires_grad=True)
        fn(*ts, b, **kw).backward(ct.to(cuda_device))
        leaves.append([t.grad for t in ts + [b]])
    for g, r in zip(*leaves):
        _close_cuda(g, r, 5e-5)


@pytest.mark.cuda
def test_cuda_tensors_of_the_wrong_dtype_or_layout_raise(cuda_device):
    (x, wt, off, mask, _), kw = path_case("outside")
    x, wt, off, mask = (a.to(cuda_device) for a in (x, wt, off, mask))
    before = tdc.fwd_launches
    with pytest.raises(TypeError):
        tdc.deform_conv2d(x.double(), wt.double(), off.double(),
                          mask.double(), **kw)
    with pytest.raises(ValueError):
        tdc.deform_conv2d(x.contiguous(memory_format=torch.channels_last),
                          wt, off, mask, **kw)
    with pytest.raises(ValueError):
        tdc.deform_conv2d(x, wt, off.transpose(2, 3).contiguous()
                          .transpose(2, 3), mask, **kw)
    assert tdc.fwd_launches == before
