"""DCNv2 with its forward and backward as CUDA kernels: the wrappers of
`csrc/dcn_fwd.cu` (port of `rrnet_tpu/ops/pallas_dcn.py::_dcn_kernel`)
and `csrc/dcn_bwd.cu` (port of `_dcn_bwd_kernel`), bound as one
`torch.autograd.Function`, the counterpart of the JAX package's
`deform_conv2d_fused` custom VJP.

`deform_conv2d` takes the layouts of `ops.dcn.deform_conv2d`, the plain
version, and runs that plain version for tensors on the CPU. For tensors
on a CUDA device it checks dtype (f32), contiguity, shapes and the
kernels' limits, then launches the kernels or raises; it never falls
back. The forward makes x channels-last once per call (the kernels read
corners coalesced over channels) and keeps that copy for the backward,
which recomputes the samples. `fwd_launches` / `bwd_launches` count the
kernel launches of this process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from rrnet_torch.ops import dcn
from rrnet_torch.utils import native

__all__ = ["deform_conv2d", "deform_conv2d_backward",
           "deform_conv2d_backward_reference", "fwd_launches",
           "bwd_launches", "max_cout"]

fwd_launches = 0
bwd_launches = 0

_fns = {}
_GEOM = [ctypes.c_int] * 13


def _kernel(name: str):
    """The C entry of library `name` (built at first use)."""
    fn = _fns.get(name)
    if fn is None:
        lib = native.load(name)
        if name == "dcn_fwd":
            fn = lib.rrnet_dcn_fwd
            fn.argtypes = [ctypes.c_void_p] * 6 + _GEOM + [ctypes.c_void_p]
        else:
            fn = lib.rrnet_dcn_bwd
            fn.argtypes = [ctypes.c_void_p] * 9 + _GEOM + [ctypes.c_void_p]
            fn.max_cout = lib.rrnet_dcn_bwd_max_cout()
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def max_cout() -> int:
    """The largest Cout the backward kernel takes (its shared memory
    holds the cotangent of a block's positions); builds it at first use."""
    return _kernel("dcn_bwd").max_cout


def _geometry(x, weight, offset, mask, bias, stride, padding, dilation,
              groups):
    """Check a CUDA call and return its 13 ints (B, H, W, Cin, Cout, kh,
    kw, Ho, Wo, stride, pad, dil, G); raises on anything the kernels do
    not take."""
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError("x must be (B, Cin, H, W) and weight (Cout, Cin, "
                         "kh, kw)")
    b, cin, h, w = x.shape
    cout, wcin, kh, kw = weight.shape
    if wcin != cin:
        raise ValueError(f"weight takes {wcin} input channels, x has {cin}")
    if groups < 1 or cin % groups:
        raise ValueError(f"{cin} channels do not split into {groups} groups")
    if stride < 1 or dilation < 1 or padding < 0:
        raise ValueError("stride and dilation must be >= 1, padding >= 0")
    ho, wo = dcn.out_size(h, w, kh, kw, stride, padding, dilation)
    if min(b, ho, wo, cout) < 1 or b > 65535:
        raise ValueError(f"no output for x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} (or batch above 65535)")
    kk = kh * kw
    want = {"x": (x, (b, cin, h, w)), "weight": (weight, (cout, cin, kh, kw)),
            "offset": (offset, (b, 2 * groups * kk, ho, wo))}
    if mask is not None:
        want["mask"] = (mask, (b, groups * kk, ho, wo))
    if bias is not None:
        want["bias"] = (bias, (cout,))
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the DCN kernels take float32; {name} is "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} has 2**31 elements or more")
    if b * cout * ho * wo >= 2 ** 31:
        raise ValueError("the output has 2**31 elements or more")
    return (b, h, w, cin, cout, kh, kw, ho, wo, stride, padding, dilation,
            groups)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, args, geom, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*args, *geom, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _forward(x_nhwc, weight, offset, mask, bias, geom) -> torch.Tensor:
    b, _, _, _, cout, kh, kw, ho, wo = geom[:9]
    wt = weight.permute(2, 3, 1, 0).contiguous()          # (kh, kw, Cin, Cout)
    out = torch.empty((b, cout, ho, wo), dtype=torch.float32,
                      device=x_nhwc.device)
    _launch("dcn_fwd", (x_nhwc.data_ptr(), wt.data_ptr(), offset.data_ptr(),
                        _ptr(mask), _ptr(bias), out.data_ptr()),
            geom, x_nhwc.device)
    global fwd_launches
    fwd_launches += 1
    return out


def _backward(x_nhwc, weight, offset, mask, ct, geom):
    b, h, w, cin, cout, kh, kw = geom[:7]
    if cout > _kernel("dcn_bwd").max_cout:
        raise ValueError(f"the DCN backward kernel takes Cout <= "
                         f"{_kernel('dcn_bwd').max_cout}, got {cout}")
    dev = x_nhwc.device
    wtb = weight.permute(2, 3, 0, 1).contiguous()         # (kh, kw, Cout, Cin)
    gx = torch.empty((b, h, w, cin), dtype=torch.float32, device=dev)
    gw = torch.empty((kh, kw, cin, cout), dtype=torch.float32, device=dev)
    goff = torch.empty_like(offset)
    gmask = None if mask is None else torch.empty_like(mask)
    _launch("dcn_bwd", (x_nhwc.data_ptr(), wtb.data_ptr(), offset.data_ptr(),
                        _ptr(mask), ct.data_ptr(), gx.data_ptr(),
                        gw.data_ptr(), goff.data_ptr(), _ptr(gmask)),
            geom, dev)
    global bwd_launches
    bwd_launches += 1
    return (gx.permute(0, 3, 1, 2).contiguous(),
            gw.permute(3, 2, 0, 1).contiguous(), goff, gmask)


class _DeformConv2d(torch.autograd.Function):
    """Forward: kernel B.3 (`dcn_fwd`). Backward: kernel B.4 (`dcn_bwd`)
    for x, weight, offset and mask; the bias gradient is a sum over the
    cotangent."""

    @staticmethod
    def forward(ctx, x, weight, offset, mask, bias, stride, padding,
                dilation, groups):
        geom = _geometry(x, weight, offset, mask, bias, stride, padding,
                         dilation, groups)
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()
        out = _forward(x_nhwc, weight, offset, mask, bias, geom)
        ctx.save_for_backward(x_nhwc, weight, offset, mask)
        ctx.geom = geom
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x_nhwc, weight, offset, mask = ctx.saved_tensors
        gx, gw, goff, gmask = _backward(x_nhwc, weight, offset, mask,
                                        grad_out.contiguous(), ctx.geom)
        gb = grad_out.sum((0, 2, 3)) if ctx.has_bias else None
        return gx, gw, goff, gmask, gb, None, None, None, None


def deform_conv2d(x: torch.Tensor, weight: torch.Tensor,
                  offset: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  deformable_groups: int = 1) -> torch.Tensor:
    """Modulated deformable conv (DCNv2), differentiable in x, weight,
    offset, mask and bias; layouts as `ops.dcn.deform_conv2d`."""
    if x.device.type == "cpu":
        return dcn.deform_conv2d(x, weight, offset, mask, bias, stride,
                                 padding, dilation, deformable_groups)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d runs on cpu or cuda, not "
                         f"{x.device}")
    return _DeformConv2d.apply(x, weight, offset, mask, bias, stride,
                               padding, dilation, deformable_groups)


def deform_conv2d_backward(x, weight, offset, mask, grad_out, stride=1,
                           padding=1, dilation=1, deformable_groups=1):
    """Kernel B.4 alone, for CUDA tensors: (grad_x, grad_weight,
    grad_offset, grad_mask) of `deform_conv2d` for the cotangent
    grad_out (B, Cout, Ho, Wo); grad_mask is None when mask is None."""
    if x.device.type != "cuda":
        raise ValueError("deform_conv2d_backward launches the CUDA kernel; "
                         "use deform_conv2d_backward_reference elsewhere")
    geom = _geometry(x, weight, offset, mask, None, stride, padding,
                     dilation, deformable_groups)
    b, _, _, _, cout, _, _, ho, wo = geom[:9]
    if (grad_out.dtype != torch.float32 or grad_out.device != x.device
            or tuple(grad_out.shape) != (b, cout, ho, wo)
            or not grad_out.is_contiguous()):
        raise ValueError(f"grad_out must be a contiguous float32 "
                         f"{(b, cout, ho, wo)} tensor on {x.device}")
    return _backward(x.permute(0, 2, 3, 1).contiguous(), weight, offset,
                     mask, grad_out, geom)


def deform_conv2d_backward_reference(x, weight, offset, mask, grad_out,
                                     stride=1, padding=1, dilation=1,
                                     deformable_groups=1):
    """The same four gradients by autograd through the plain version."""
    leaves = [t.detach().requires_grad_() for t in (x, weight, offset)]
    m = None if mask is None else mask.detach().requires_grad_()
    with torch.enable_grad():
        out = dcn.deform_conv2d(*leaves, m, None, stride, padding, dilation,
                                deformable_groups)
        grads = torch.autograd.grad(out, leaves + ([] if m is None else [m]),
                                    grad_out)
    return tuple(grads) + ((None,) if m is None else ())
