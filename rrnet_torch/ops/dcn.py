"""Modulated deformable convolution v2, the plain PyTorch version (port
of `rrnet_tpu/ops/dcn.py:35-148`, `_bilinear_sample_hw` and
`deform_conv2d`).

Torch gathers and lerps; autograd gives its backward, which is the
floor-lerp derivative of the JAX package's VJP and of the reference CUDA
`dmcn_get_coordinate_weight`. It is the reference the CUDA kernels of
`ops.deform_conv` are held to, and what that module runs on the CPU.

Layout is the port's NCHW, with the JAX package's channel order:
  * x (B, Cin, H, W); weight (Cout, Cin, kh, kw);
  * offset (B, 2*G*kh*kw, Ho, Wo): first the G*kh*kw y-offsets, then the
    G*kh*kw x-offsets, each ordered (group, tap);
  * mask (B, G*kh*kw, Ho, Wo), post-sigmoid, or None (all ones);
  * a sample is valid iff -1 < y < H and -1 < x < W; out-of-image corners
    contribute 0; lerp weights come from floor(y), floor(x).
"""

from __future__ import annotations

from typing import Optional

import torch


def out_size(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
             dilation: int):
    """(Ho, Wo) of a conv with these settings."""
    ho = (h + 2 * padding - (dilation * (kh - 1) + 1)) // stride + 1
    wo = (w + 2 * padding - (dilation * (kw - 1) + 1)) // stride + 1
    return ho, wo


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Sample img (N, C, H, W) at float coords ys/xs (N, S) -> (N, C, S);
    zero outside (-1, H) x (-1, W), as the CUDA sampler."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0

    def at(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        v = torch.gather(flat, 2, idx[:, None, :].expand(n, c, -1))
        return torch.where(ok[:, None, :], v, 0.0)

    out = (at(y0, x0) * ((1 - ly) * (1 - lx))[:, None]
           + at(y0, x0 + 1) * ((1 - ly) * lx)[:, None]
           + at(y0 + 1, x0) * (ly * (1 - lx))[:, None]
           + at(y0 + 1, x0 + 1) * (ly * lx)[:, None])
    return torch.where(valid[:, None, :], out, 0.0)


def sampled_columns(x: torch.Tensor, offset: torch.Tensor,
                    mask: Optional[torch.Tensor], kh: int, kw: int,
                    stride: int = 1, padding: int = 1, dilation: int = 1,
                    deformable_groups: int = 1) -> torch.Tensor:
    """The sampled, mask-multiplied columns (B, G, cpg, kh*kw, Ho*Wo):
    the operand that `deform_conv2d` contracts with the weight."""
    b, cin, h, w = x.shape
    g = deformable_groups
    kk = kh * kw
    cpg = cin // g
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    f32 = dict(device=x.device, dtype=torch.float32)

    # base sampling grid per tap and output position, as (kk, Ho, Wo)
    py = torch.arange(ho, **f32) * stride - padding
    px = torch.arange(wo, **f32) * stride - padding
    ky = torch.arange(kh, **f32).repeat_interleave(kw) * dilation
    kx = torch.arange(kw, **f32).repeat(kh) * dilation
    base_y = py[None, :, None] + ky[:, None, None]
    base_x = px[None, None, :] + kx[:, None, None]

    off = offset.reshape(b, 2, g, kk, ho, wo)
    ys = (base_y + off[:, 0]).reshape(b * g, kk * ho * wo)
    xs = (base_x + off[:, 1]).reshape(b * g, kk * ho * wo)
    # each group's channel slice is sampled at that group's coordinates
    s = _bilinear_sample(x.reshape(b * g, cpg, h, w), ys, xs)
    if mask is not None:
        s = s * mask.reshape(b * g, 1, kk * ho * wo)
    return s.reshape(b, g, cpg, kk, ho * wo)


def deform_conv2d(x: torch.Tensor, weight: torch.Tensor,
                  offset: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  deformable_groups: int = 1) -> torch.Tensor:
    """Modulated deformable conv (DCNv2), (B, Cout, Ho, Wo); see the
    module docstring for the layouts."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    g = deformable_groups
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    s = sampled_columns(x, offset, mask, kh, kw, stride, padding, dilation,
                        g)
    wmat = weight.reshape(cout, g, cin // g, kh * kw)
    out = torch.einsum("bgctp,ogct->bop", s, wmat).reshape(b, cout, ho, wo)
    if bias is not None:
        out = out + bias[:, None, None]
    return out
