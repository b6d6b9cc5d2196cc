// Shared by the DCNv2 forward (dcn_fwd.cu) and backward (dcn_bwd.cu)
// kernels: the geometry of one call and the sampling rule of
// rrnet_torch/ops/dcn.py (the plain version; the JAX package's
// rrnet_tpu/ops/dcn.py::_bilinear_sample_hw).
//
// Layouts, as the wrappers in rrnet_torch/ops/deform_conv.py hand them:
//   x       (B, H, W, Cin)  channels last, so that the corner reads of
//                            neighbouring threads (neighbouring channels)
//                            are one coalesced row segment
//   offset  (B, 2*G*kk, Ho, Wo)  [G*kk y | G*kk x], each (group, tap)
//   mask    (B, G*kk, Ho, Wo)    post-sigmoid, or null (all ones)
//   cotangent / output (B, Cout, Ho, Wo)
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct DcnGeom {
  int B, H, W, Cin, Cout, kh, kw, Ho, Wo, stride, pad, dil, G, cpg;
};

// One sample (group gi, tap t, output position p of image b): its four
// corners (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1) as pixel indices
// y*W+x, -1 where the corner lies outside the image or the sample is
// not valid (valid iff -1 < y < H and -1 < x < W), and their floor-lerp
// weights. ly, lx are the fractional parts of y and x.
struct DcnSample {
  int idx[4];
  float wt[4];
  float ly, lx;
};

__device__ __forceinline__ DcnSample dcn_sample(const DcnGeom& g,
                                                const float* __restrict__ off,
                                                int b, int gi, int t, int p) {
  const int kk = g.kh * g.kw;
  const int P = g.Ho * g.Wo;
  const int oy = p / g.Wo;
  const int ox = p - oy * g.Wo;
  const size_t ob = (size_t)b * 2 * g.G * kk;
  const float dy = off[(ob + gi * kk + t) * P + p];
  const float dx = off[(ob + (size_t)g.G * kk + gi * kk + t) * P + p];
  // the base grid is integral, so this is the plain version's
  // (py + ky) + offset exactly
  const float ys = (float)(oy * g.stride - g.pad + (t / g.kw) * g.dil) + dy;
  const float xs = (float)(ox * g.stride - g.pad + (t % g.kw) * g.dil) + dx;
  DcnSample s;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.idx[k] = -1;
    s.wt[k] = 0.f;
  }
  s.ly = 0.f;
  s.lx = 0.f;
  if (ys > -1.f && ys < (float)g.H && xs > -1.f && xs < (float)g.W) {
    const float y0f = floorf(ys);
    const float x0f = floorf(xs);
    const float ly = ys - y0f;
    const float lx = xs - x0f;
    const int y0 = (int)y0f;
    const int x0 = (int)x0f;
    s.wt[0] = (1.f - ly) * (1.f - lx);
    s.wt[1] = (1.f - ly) * lx;
    s.wt[2] = ly * (1.f - lx);
    s.wt[3] = ly * lx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yi = y0 + (k >> 1);
      const int xi = x0 + (k & 1);
      if (yi >= 0 && yi < g.H && xi >= 0 && xi < g.W) s.idx[k] = yi * g.W + xi;
    }
    s.ly = ly;
    s.lx = lx;
  }
  return s;
}

__device__ __forceinline__ float dcn_mask(const DcnGeom& g,
                                          const float* __restrict__ mask,
                                          int b, int gi, int t, int p) {
  if (mask == nullptr) return 1.f;
  const int kk = g.kh * g.kw;
  return mask[((size_t)b * g.G * kk + gi * kk + t) * (g.Ho * g.Wo) + p];
}
