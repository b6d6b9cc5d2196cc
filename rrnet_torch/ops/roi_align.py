"""ROI-align (port of `rrnet_tpu/ops/roi_align.py:25-106`).

The legacy (aligned=False) torchvision op the reference ran: no
half-pixel shift, ROI extent clamped to >= 1, bilinear samples on a
FIXED sampling_ratio x sampling_ratio grid per bin (not torchvision's
adaptive grid, which is data-dependent), averaged. A sample outside
[-1, H] x [-1, W] is 0; coordinates are clamped to [0, H-1] / [0, W-1]
before the floor. Corners are gathered in the feature's own dtype and
converted to f32 after, so bf16 features give the same values as
converting first at half the gather traffic.
"""

from __future__ import annotations

from typing import Tuple

import torch


def roi_align(feat: torch.Tensor, rois: torch.Tensor,
              output_size: Tuple[int, int] = (3, 3),
              spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """feat (B, H, W, C) NHWC; rois (B, R, 4) xyxy in image coords.
    Returns (B, R, out_h, out_w, C) f32."""
    bsz, h, w, c = feat.shape
    r = rois.shape[1]
    out_h, out_w = output_size
    s = sampling_ratio
    dev = rois.device

    x1 = rois[..., 0] * spatial_scale
    y1 = rois[..., 1] * spatial_scale
    x2 = rois[..., 2] * spatial_scale
    y2 = rois[..., 3] * spatial_scale
    bin_w = (x2 - x1).clamp(min=1.0) / out_w
    bin_h = (y2 - y1).clamp(min=1.0) / out_h

    sub = (torch.arange(s, device=dev, dtype=torch.float32) + 0.5) / s
    iy = torch.arange(out_h, device=dev)[:, None] + sub[None, :]   # (out_h, s)
    ix = torch.arange(out_w, device=dev)[:, None] + sub[None, :]
    ys = y1[..., None, None] + iy * bin_h[..., None, None]          # (B, R, out_h, s)
    xs = x1[..., None, None] + ix * bin_w[..., None, None]          # (B, R, out_w, s)
    grid = (bsz, r, out_h, s, out_w, s)
    ys = ys[:, :, :, :, None, None].expand(grid).reshape(bsz, -1)
    xs = xs[:, :, None, None, :, :].expand(grid).reshape(bsz, -1)

    oob = (ys < -1.0) | (ys > h) | (xs < -1.0) | (xs > w)
    ys = ys.clamp(0.0, h - 1)
    xs = xs.clamp(0.0, w - 1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    # a NaN coordinate reads corner 0, as XLA converts NaN to the integer
    # 0 (and clamps its gathers); its NaN weights keep the sample NaN
    y0i = torch.nan_to_num(y0, nan=0.0).long()
    x0i = torch.nan_to_num(x0, nan=0.0).long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    ly = ys - y0
    lx = xs - x0
    hy = 1.0 - ly
    hx = 1.0 - lx

    flat = feat.reshape(bsz, h * w, c)
    bidx = torch.arange(bsz, device=dev)[:, None]

    def at(yi, xi):
        return flat[bidx, yi * w + xi].float()     # (B, N, C)

    val = (at(y0i, x0i) * (hy * hx)[..., None]
           + at(y0i, x1i) * (hy * lx)[..., None]
           + at(y1i, x0i) * (ly * hx)[..., None]
           + at(y1i, x1i) * (ly * lx)[..., None])
    val = torch.where(oob[..., None], 0.0, val)
    return val.reshape(*grid, c).mean(dim=(3, 5))


def batched_roi_align(feats: torch.Tensor, rois: torch.Tensor, **kw
                      ) -> torch.Tensor:
    """The JAX package's vmap of its one-image `roi_align` over the batch:
    feats (B, H, W, C), rois (B, R, 4) -> (B, R, out_h, out_w, C). The
    port's `roi_align` is batched already."""
    return roi_align(feats, rois, **kw)
