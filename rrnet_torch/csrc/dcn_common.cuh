// Shared by the DCNv2 forward (dcn_fwd.cu) and backward (dcn_bwd.cu)
// kernels: the geometry of one call, the sampling rule of
// rrnet_torch/ops/dcn.py (the plain version; the JAX package's
// rrnet_tpu/ops/dcn.py::_bilinear_sample_hw), and the tensor-core and
// copy primitives both use.
//
// Layouts, as the wrappers in rrnet_torch/ops/deform_conv.py hand them:
//   x       (B, H, W, Cin)  channels last, so that the corner reads of
//                            neighbouring threads (neighbouring channels)
//                            are one coalesced row segment
//   offset  (B, 2*G*kk, Ho, Wo)  [G*kk y | G*kk x], each (group, tap)
//   mask    (B, G*kk, Ho, Wo)    post-sigmoid, or null (all ones)
//   cotangent / output (B, Cout, Ho, Wo)
//
// Products run on the tensor cores as 3xTF32 (mma.sync m16n8k8): each f32
// operand is split into hi = tf32(a) and lo = tf32(a - hi), and
// a*b ~= lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, the two small products first,
// into an f32 accumulator. The dropped lo_a*lo_b and the rounding of lo
// leave ~2^-21 of each product: f32-like sums, where one TF32 pass keeps
// ~3 decimal digits (tests/test_torch_dcn.py pins both).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// The y and x offsets of (group gi, tap t) at position p of image b.
__device__ __forceinline__ void dcn_offset(const DcnGeom& g,
                                           const float* __restrict__ off,
                                           int b, int gi, int t, int p,
                                           float& dy, float& dx) {
  const int kk = g.kh * g.kw;
  const int P = g.Ho * g.Wo;
  const size_t ob = (size_t)b * 2 * g.G * kk;
  dy = __ldg(off + (ob + gi * kk + t) * P + p);
  dx = __ldg(off + (ob + (size_t)g.G * kk + gi * kk + t) * P + p);
}

// The sample of tap t at position p from its offsets dy, dx.
__device__ __forceinline__ DcnSample dcn_sample_at(const DcnGeom& g, int t,
                                                   int p, float dy,
                                                   float dx) {
  const int oy = p / g.Wo;
  const int ox = p - oy * g.Wo;
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

__device__ __forceinline__ DcnSample dcn_sample(const DcnGeom& g,
                                                const float* __restrict__ off,
                                                int b, int gi, int t, int p) {
  float dy, dx;
  dcn_offset(g, off, b, gi, t, p, dy, dx);
  return dcn_sample_at(g, t, p, dy, dx);
}

// The sample of a position past the end of the tile: no corner.
__device__ __forceinline__ DcnSample dcn_no_sample() {
  DcnSample s;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.idx[k] = -1;
    s.wt[k] = 0.f;
  }
  s.ly = s.lx = 0.f;
  return s;
}

__device__ __forceinline__ float dcn_mask(const DcnGeom& g,
                                          const float* __restrict__ mask,
                                          int b, int gi, int t, int p) {
  if (mask == nullptr) return 1.f;
  const int kk = g.kh * g.kw;
  return mask[((size_t)b * g.G * kk + gi * kk + t) * (g.Ho * g.Wo) + p];
}

// 4 channels at `src` (16-byte aligned when `vec`), 0 past `n_valid`.
__device__ __forceinline__ float4 dcn_load4(const float* __restrict__ src,
                                           bool vec, int n_valid) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n_valid ? __ldg(src + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// ---- tensor cores: 3xTF32 ------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 TF32 product. Fragments (g = lane / 4,
// t = lane % 4): a0 (row g, col t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); b0 (row t, col g), b1 (t+4, g); d0, d1 (row g, cols
// 2t, 2t+1), d2, d3 (row g+8, the same cols). Not volatile: the compiler
// may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, one tile: the two small products, then the
// large one.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// d[m][n] += a[m] * b[n] in 3xTF32 for an MT x NT block of tiles: the
// two small products, then the large one, each pass over every tile, so
// that neighbouring products write different accumulators (a product
// that waits for the one before it stalls for the tensor core's latency).
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[MT][NT][4],
                                           const uint32_t (&ah)[MT][4],
                                           const uint32_t (&al)[MT][4],
                                           const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(d[m][n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(d[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(d[m][n], ah[m], bh[n][0], bh[n][1]);
}

// The A fragment at `a` (row g, col t) of a tile stored transposed
// (a[c * ld + r] = A[r][c]), split into hi and lo.
__device__ __forceinline__ void load_a_colmajor(const float* a, int ld,
                                                uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[8], hi[1], lo[1]);
  split_tf32(a[4 * ld], hi[2], lo[2]);
  split_tf32(a[4 * ld + 8], hi[3], lo[3]);
}

// (hi, lo) of a and of b in one float4, for a tile of pre-split pairs.
__device__ __forceinline__ float4 split_pair(float a, float b) {
  uint32_t ha, la, hb, lb;
  split_tf32(a, ha, la);
  split_tf32(b, hb, lb);
  return make_float4(__uint_as_float(ha), __uint_as_float(la),
                     __uint_as_float(hb), __uint_as_float(lb));
}

// Stores 4 consecutive values of a tile of (hi, lo) pairs, split once
// here rather than by every warp that reads them.
__device__ __forceinline__ void store_split4(float2* dst, const float4& v) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = split_pair(v.x, v.y);
  d[1] = split_pair(v.z, v.w);
}

// The A fragment (row g, col t at `a`) of a tile of pre-split (hi, lo)
// pairs with a row stride of `ld` pairs: one 64-bit load per element.
// A row stride of 4 (mod 16) pairs keeps each half-warp's loads in
// distinct banks.
__device__ __forceinline__ void load_a2_rowmajor(const float2* a, int ld,
                                                 uint32_t (&hi)[4],
                                                 uint32_t (&lo)[4]) {
  const float2 v[4] = {a[0], a[8 * ld], a[4], a[8 * ld + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = __float_as_uint(v[i].x);
    lo[i] = __float_as_uint(v[i].y);
  }
}

// The B fragment at `b` (row t, col g) of a tile whose rows lie
// `row_step` floats apart (the row stride, or 1 for a tile stored
// transposed), split into hi and lo: b1 sits 4 rows below b0.
__device__ __forceinline__ void load_b(const float* b, int row_step,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(b[0], hi[0], lo[0]);
  split_tf32(b[4 * row_step], hi[1], lo[1]);
}

// ---- asynchronous copies -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`, or 16 zero bytes when
// `!full` (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's committed copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The device's SM count (host side).
static inline int dcn_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}
