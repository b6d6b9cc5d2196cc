// Modulated deformable convolution v2, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel rrnet_tpu/ops/pallas_dcn.py::_dcn_kernel
// (driven by deform_conv2d_pallas, pallas_dcn.py:196). It computes what
// rrnet_torch/ops/dcn.py::deform_conv2d computes:
//   out[b, o, p] = bias[o] + sum_{t, g, c} W[o, g*cpg+c, t]
//                  * m[b, g, t, p] * bilinear(x[b, g*cpg+c], y, x)
// with the sample of (g, t) at p placed at its base grid point plus the
// offsets, as dcn_common.cuh defines it.
//
// What bounds it on the card. By the roofline, operations: the GEMM is
// 2*B*P*kk*Cin*Cout flop (5 GFLOP per launch at the serve shape) against
// ~13 MB of inputs and outputs; 0.076 ms in f32 on the CUDA cores, 0.030
// ms as 3xTF32 on the tensor cores. In this design two things bind
// together, neither near that line (chip_smoke.py's timings, PERF.md):
// the stream of weight slices from L2, since every block reads all of W
// (2.4 MB; 311 MB a launch at the serve shape; the kernel with its
// products removed still takes 0.12 ms of its 0.20), and the issue of the
// mma.sync path (three HMMA, the operand splits and the fragment loads
// per product; without the weight stream it takes 0.19 ms). A larger M
// tile per weight read (a cluster sharing each slice by TMA multicast)
// and wgmma, which reads both operands from shared memory, are the next
// steps.
//
// Design: an implicit GEMM, M = the block's 32 output positions of one
// image, N = all of Cout (256 a block; more in further blocks), K =
// (tap, group, channel) in steps of 32 channels. The A operand, the
// sampled and mask-multiplied im2col tile, exists only in shared memory,
// the fusion the TPU kernel makes in VMEM; each sample is gathered once,
// for every output channel. The products run on the tensor cores through
// mma.sync m16n8k8 .tf32 in 3xTF32 (dcn_common.cuh): mma.sync, not
// wgmma, because A is written by the block's own gather a step at a time
// into a layout of (hi, lo) pairs, and the register fragments need no
// matrix descriptors or swizzled layouts; that was the simpler kernel to
// get right first. Eight warps split N, each holding 2 x 4 accumulator
// tiles (32 positions x 32 outputs). The gathering thread splits its
// blended A values into TF32 (hi, lo) once, so the eight warps that read
// them load pairs (one 64-bit load each) instead of splitting again; each
// weight value is read, and split, by one warp. A two-stage pipeline keeps
// one step in flight while the tensor cores work on the last: the weight
// slice (32 channels x 256 outputs) comes in by cp.async, and each thread
// issues its four corner reads (float4 over 4 channels of the
// channels-last x) for the next step into registers before the products
// of this one. Row strides of 36 pairs and 264 floats make every fragment
// load conflict-free. Channels past cpg and outputs past Cout are
// zero-filled by the copies; warps whose outputs all lie past Cout skip
// the products. Each step's products are summed apart and added to the
// running sum in f32 (see `part`).

#include "dcn_common.cuh"

namespace {

constexpr int kThreads = 256;       // 8 warps, each 32 positions x 32 outputs
constexpr int kBM = 32;             // output positions per block
constexpr int kBN = 256;            // output channels per block
constexpr int kKC = 32;             // input channels per step
constexpr int kSA = kKC + 4;        // A row stride in (hi, lo) pairs: 4 mod 16
constexpr int kSB = kBN + 8;        // B row stride: row r in banks 8r..8r+7
constexpr int kSmem = 2 * kBM * kSA * (int)sizeof(float2) +
                      2 * kKC * kSB * (int)sizeof(float);
static_assert(kBM * kKC / 4 == kThreads, "4 channels of A per thread");

__global__ void __launch_bounds__(kThreads, 1)
dcn_fwd_kernel(const float* __restrict__ x,     // (B, H, W, Cin)
               const float* __restrict__ wt,    // (kk, Cin, Cout)
               const float* __restrict__ off,   // (B, 2*G*kk, Ho, Wo)
               const float* __restrict__ mask,  // (B, G*kk, Ho, Wo) or null
               const float* __restrict__ bias,  // (Cout) or null
               float* __restrict__ out,         // (B, Cout, Ho, Wo)
               DcnGeom g) {
  extern __shared__ float4 smem4[];
  float2* sA = reinterpret_cast<float2*>(smem4);       // [2][kBM][kSA]: A[p][c] split
  float* sB = reinterpret_cast<float*>(sA + 2 * kBM * kSA);  // [2][kKC][kSB]: W[c][o]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int P = g.Ho * g.Wo;
  const int kk = g.kh * g.kw;
  const int nck = (g.cpg + kKC - 1) / kKC;  // steps per (tap, group)
  const int steps = kk * g.G * nck;
  const float* xb = x + (size_t)b * g.H * g.W * g.Cin;
  // gather role: position gp of the tile, channels 4*gq .. 4*gq+3 of a step
  const int gp = tid >> 3;
  const int gq = tid & 7;
  const int p_own = p0 + gp;
  const bool in_tile = p_own < P;
  const bool xvec = (g.cpg & 3) == 0;  // then Cin = G * cpg is too
  const bool wvec = (g.Cout & 3) == 0;
  const bool warp_on = n0 + warp * 32 < g.Cout;

  int idx[4];       // the current (tap, group)'s corners of p_own
  float cw[4];      // and their weights, mask folded in
  float4 cv[4];     // the corner values of the step in flight
  float ndy = 0.f, ndx = 0.f, nm = 0.f;  // offsets and mask of the next (tap, group)
  if (in_tile) {
    dcn_offset(g, off, b, 0, 0, p_own, ndy, ndx);
    nm = dcn_mask(g, mask, b, 0, 0, p_own);
  }

  // Step s: its weight slice by cp.async into stage s & 1, its corners
  // into cv. The first step of a (tap, group) forms the sample from the
  // prefetched offsets, then prefetches the next (tap, group)'s.
  auto fetch = [&](int s) {
    const int ck = s % nck;
    const int tg = s / nck;
    const int gi = tg % g.G;
    const int t = tg / g.G;
    const int c0 = ck * kKC;
    float* dst = sB + (s & 1) * kKC * kSB;
    const float* wrow = wt + ((size_t)t * g.Cin + gi * g.cpg + c0) * g.Cout + n0;
    if (wvec) {
#pragma unroll
      for (int e = tid; e < kKC * kBN / 4; e += kThreads) {
        const int r = e / (kBN / 4);
        const int c = (e % (kBN / 4)) * 4;
        const bool ok = c0 + r < g.cpg && n0 + c < g.Cout;
        cp_async16(dst + r * kSB + c, ok ? wrow + (size_t)r * g.Cout + c : wt, ok);
      }
    } else {
      for (int e = tid; e < kKC * kBN; e += kThreads) {
        const int r = e / kBN;
        const int c = e % kBN;
        const bool ok = c0 + r < g.cpg && n0 + c < g.Cout;
        cp_async4(dst + r * kSB + c, ok ? wrow + (size_t)r * g.Cout + c : wt, ok);
      }
    }
    cp_async_commit();
    if (ck == 0) {
      const DcnSample sm = in_tile ? dcn_sample_at(g, t, p_own, ndy, ndx)
                                   : dcn_no_sample();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        idx[k] = sm.idx[k];
        cw[k] = sm.wt[k] * nm;
      }
      const int ngi = gi + 1 < g.G ? gi + 1 : 0;
      const int nt = gi + 1 < g.G ? t : t + 1;
      if (in_tile && nt < kk) {
        dcn_offset(g, off, b, ngi, nt, p_own, ndy, ndx);
        nm = dcn_mask(g, mask, b, ngi, nt, p_own);
      }
    }
    const int ch = c0 + 4 * gq;
    const float* src = xb + gi * g.cpg + ch;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cv[k] = (idx[k] >= 0 && ch < g.cpg)
                  ? dcn_load4(src + (size_t)idx[k] * g.Cin, xvec, g.cpg - ch)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // acc holds the sum over finished steps; each step's 3xTF32 products
  // go into part first, added to acc in f32 once the step is done: the
  // tensor cores' accumulation drifts over long chains (1.7e-5 of the
  // largest output after the 864 products of a 2304-deep sum in one
  // accumulator, 1.2e-6 with the sum split per step)
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  fetch(0);
  for (int s = 0; s < steps; ++s) {
    float2* a_s = sA + (s & 1) * kBM * kSA;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) fma4(v, cw[k], cv[k]);
    store_split4(a_s + gp * kSA + 4 * gq, v);
    cp_async_wait_all();
    __syncthreads();  // step s's A and W are in; step s-1's products are done
    if (s + 1 < steps) fetch(s + 1);
    if (warp_on) {
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) part[i][j][k] = 0.f;
      const float2* a_base = a_s + gid * kSA + tig;
      const float* b_base = sB + (s & 1) * kKC * kSB + tig * kSB + warp * 32 + gid;
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          load_a2_rowmajor(a_base + mt * 16 * kSA + ks * 8, kSA, ah[mt], al[mt]);
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          load_b(b_base + ks * 8 * kSB + nt * 8, kSB, bh[nt], bl[nt]);
        mma_3xtf32(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] += part[i][j][k];
    }
  }

  if (!warp_on) return;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + warp * 32 + nt * 8 + 2 * tig + j;
      if (o >= g.Cout) continue;
      const float bv = bias == nullptr ? 0.f : __ldg(bias + o);
      float* row = out + ((size_t)b * g.Cout + o) * P;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + mt * 16 + h * 8 + gid;
          if (p < P) row[p] = acc[mt][nt][2 * h + j] + bv;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). `mask` and
// `bias` may be null. The wrapper has checked shapes and limits.
int rrnet_dcn_fwd(const float* x, const float* wt, const float* off,
                  const float* mask, const float* bias, float* out, int B,
                  int H, int W, int Cin, int Cout, int kh, int kw, int Ho,
                  int Wo, int stride, int pad, int dil, int G, void* stream) {
  if (B < 1 || B > 65535 || G < 1 || Cin % G != 0 || Ho < 1 || Wo < 1 ||
      Cout < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const DcnGeom g{B, H, W, Cin, Cout, kh, kw, Ho, Wo, stride, pad, dil, G,
                  Cin / G};
  cudaError_t err = cudaFuncSetAttribute(
      dcn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Ho * Wo + kBM - 1) / kBM, (Cout + kBN - 1) / kBN, B);
  dcn_fwd_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      x, wt, off, mask, bias, out, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
