"""Modulated deformable convolution v2, the plain PyTorch version, and
deformable position-sensitive ROI pooling (port of
`rrnet_tpu/ops/dcn.py:35-237`: `_bilinear_sample_hw`, `deform_conv2d`,
`deform_psroi_pooling`).

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


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     index: Optional[torch.Tensor] = None):
    """Sample img (N, C, H, W) at float coords ys/xs (N, S) -> (N, C, S);
    zero outside (-1, H) x (-1, W), as the CUDA sampler. With `index`
    (M,) of image numbers, row m of ys/xs (M, S) samples image
    index[m] -> (M, C, S)."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)
    m = ys.shape[0]
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0

    def at(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        if index is None:
            v = torch.gather(flat, 2, idx[:, None, :].expand(n, c, -1))
        else:                   # (M, S, C) rows of each ROI's image
            v = flat[index[:, None], :, idx].transpose(1, 2)
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


def deform_psroi_pooling(feat: torch.Tensor, rois: torch.Tensor,
                         trans: Optional[torch.Tensor] = None,
                         spatial_scale: float = 1.0, pooled_size: int = 7,
                         output_dim: int = 256, group_size: int = 1,
                         part_size: Optional[int] = None,
                         sample_per_part: int = 4, trans_std: float = 0.0,
                         no_trans: bool = False) -> torch.Tensor:
    """Deformable position-sensitive ROI pooling (reference
    ext/dcn/src/cuda/dcn_v2_psroi_pooling_cuda.cu:59-148; the JAX
    package's `deform_psroi_pooling`), plain PyTorch.

    feat (B, C, H, W) with C = output_dim * group_size^2; rois (R, 5)
    [batch index, x1, y1, x2, y2] in image pixels, each pooled on its own
    image (the index truncated and clipped to [0, B - 1]); trans
    (R, 2, part, part) per-part (x, y) offsets, or None. The ROI extents
    are rounded with the legacy +1 and scaled; each of the p x p bins
    (p = pooled_size) averages sample_per_part^2 bilinear samples clamped
    into the map, moved by trans x trans_std x the ROI extent; with
    group_size > 1, output channel c of bin (i, j) reads channel
    (c * gs + gi) * gs + gj of its bin group (gi, gj). Returns
    (R, output_dim, p, p) in f32 (the samples' dtype promoted)."""
    b, _, h, w = feat.shape
    p, sp = pooled_size, sample_per_part
    part = part_size or pooled_size
    f32 = dict(device=feat.device, dtype=torch.float32)
    bi = rois[:, 0].to(torch.int32).clamp(0, b - 1).long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    bin_w = (x2 - x1).clamp_min(0.1) / p
    bin_h = (y2 - y1).clamp_min(0.1) / p
    sub_w, sub_h = bin_w / sp, bin_h / sp

    pw = torch.arange(p, **f32)
    start_x = x1[:, None, None] + bin_w[:, None, None] * pw[None, None, :]
    start_y = y1[:, None, None] + bin_h[:, None, None] * pw[None, :, None]
    if trans is not None and not no_trans:
        part_i = torch.floor(pw / p * part).long()
        off_x = trans[:, 0][:, part_i[:, None], part_i[None, :]] * trans_std
        off_y = trans[:, 1][:, part_i[:, None], part_i[None, :]] * trans_std
        # the CUDA kernel's wstart = pw * bin_w + roi_start_w + trans_x * roi_w
        start_x = start_x + off_x * (bin_w * p)[:, None, None]
        start_y = start_y + off_y * (bin_h * p)[:, None, None]
    s = (torch.arange(sp, **f32) + 0.5)
    ys = (start_y[:, :, :, None, None]
          + (s[None, :] * sub_h[:, None])[:, None, None, :, None])
    xs = (start_x[:, :, :, None, None]
          + (s[None, :] * sub_w[:, None])[:, None, None, None, :])
    ys = ys.clamp(0.0, h - 1.0).expand(-1, p, p, sp, sp)
    xs = xs.clamp(0.0, w - 1.0).expand(-1, p, p, sp, sp)
    r = rois.shape[0]
    vals = _bilinear_sample(feat, ys.reshape(r, -1), xs.reshape(r, -1),
                            index=bi)                   # (R, C, p*p*sp*sp)
    pooled = vals.reshape(r, -1, p, p, sp * sp).mean(-1)  # (R, C, p, p)
    gs = group_size
    if gs == 1:
        return pooled[:, :output_dim]
    g = ((torch.arange(p, device=feat.device) * gs) // p).clamp(0, gs - 1)
    cidx = ((torch.arange(output_dim, device=feat.device)[:, None, None] * gs
             + g[None, :, None]) * gs + g[None, None, :])   # (out, p, p)
    return torch.gather(pooled, 1, cidx.expand(r, -1, -1, -1))
