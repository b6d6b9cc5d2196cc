// Modulated deformable convolution v2, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel rrnet_tpu/ops/pallas_dcn.py::_dcn_bwd_kernel
// (driven by deform_conv2d_pallas_bwd, pallas_dcn.py:508). For the
// cotangent ct of rrnet_torch/ops/dcn.py::deform_conv2d it computes
// the gradients autograd derives through that plain version:
//   g_sm[p, c]   = sum_o ct[o, p] * W[o, c, t]        (per group, tap)
//   grad mask    = sum_c g_sm * s                     (s: the unmasked sample)
//   g_s          = g_sm * m
//   grad x       += g_s * corner weight, scattered to the four corners
//   grad offset  = sum_c g_s * ds/dy, sum_c g_s * ds/dx
//   grad weight  = sum_p sm[p, c] * ct[o, p]          (sm = s * m)
// The coordinate derivative is the floor-lerp one of the plain version
// (and of the reference CUDA dmcn_get_coordinate_weight):
//   ds/dy = (1-lx)(v10-v00) + lx(v11-v01),  ds/dx = (1-ly)(v01-v00) + ly(v11-v10)
// with out-of-image corners at 0. The TPU kernel uses the tent
// derivative -sign(d) instead, which is 0 where a sample lies on the
// integer grid; that differs from its own oracle and is not carried
// over. Nothing is saved by the forward: the samples are recomputed.
//
// What bounds it on the card: operations, two GEMMs of the forward's
// size (g_sm and grad weight) plus the per-sample coordinate terms.
//
// Design: two kernels on one stream, one call.
//  * dcn_bwd_data_kernel: one block per 32 output positions of one image
//    holds their whole cotangent column block (Cout x 32) in shared
//    memory. For each (tap, group) and chunk of 64 channels it loads the
//    (Cout x 64) weight slice, each thread forms g_sm for one channel and
//    8 positions, recomputes the samples (coalesced over channels), adds
//    grad x into the channels-last f32 buffer with atomicAdd, and reduces
//    grad mask and grad offset over the channels (warp shuffles, then
//    shared-memory atomics). Each position's (tap, group) sums are
//    finished inside the block, so grad offset and grad mask are written
//    once, without global atomics.
//  * dcn_bwd_weight_kernel: an implicit GEMM over all B*P positions for a
//    tile of 64 input channels (of one group) x 64 output channels of one
//    tap, the sampled tile recomputed in shared memory. The positions are
//    split across a few blocks so that the grid fills the card; their
//    partial sums meet in the zeroed grad weight through atomicAdd.
// Atomics make grad x and grad weight order-dependent at the last bits.

#include "dcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBP = 32;  // data kernel: output positions per block
constexpr int kBC = 64;  // data kernel: channels per chunk (one per thread column)
constexpr int kWC = 64;  // weight kernel: input channels per block
constexpr int kWO = 64;  // weight kernel: output channels per block
constexpr int kWK = 32;  // weight kernel: positions per step
constexpr int kMaxSmem = 232448;      // opt-in shared memory of one H100 block
constexpr int kDataStaticSmem = 4096; // upper bound of the data kernel's static part

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
dcn_bwd_data_kernel(const float* __restrict__ x,     // (B, H, W, Cin)
                    const float* __restrict__ wtb,   // (kk, Cout, Cin)
                    const float* __restrict__ off,   // (B, 2*G*kk, Ho, Wo)
                    const float* __restrict__ mask,  // (B, G*kk, Ho, Wo) or null
                    const float* __restrict__ ct,    // (B, Cout, Ho, Wo)
                    float* __restrict__ gx,          // (B, H, W, Cin), zeroed
                    float* __restrict__ goff,        // (B, 2*G*kk, Ho, Wo)
                    float* __restrict__ gmask,       // (B, G*kk, Ho, Wo) or null
                    DcnGeom g) {
  extern __shared__ float4 smem4[];
  float* s_ct = reinterpret_cast<float*>(smem4);  // [Cout][kBP]
  float* s_w = s_ct + (size_t)g.Cout * kBP;       // [Cout][kBC]
  __shared__ int s_idx[4][kBP];
  __shared__ float s_bw[4][kBP];
  __shared__ float s_ly[kBP], s_lx[kBP], s_m[kBP];
  __shared__ float s_red[3][kBP];  // grad mask, grad offset y, grad offset x

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cl = tid % kBC;  // this thread's channel within a chunk
  const int pg = tid / kBC;  // its 8 positions: pg*8 .. pg*8+7
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kBP;
  const int P = g.Ho * g.Wo;
  const int kk = g.kh * g.kw;
  const size_t img = (size_t)b * g.H * g.W * g.Cin;

  for (int e = tid; e < g.Cout * kBP; e += kThreads) {
    const int o = e / kBP;
    const int p = p0 + e % kBP;
    s_ct[e] = p < P ? ct[((size_t)b * g.Cout + o) * P + p] : 0.f;
  }

  for (int t = 0; t < kk; ++t) {
    for (int gi = 0; gi < g.G; ++gi) {
      __syncthreads();  // the last (tap, group) is written out
      if (tid < kBP) {
        const int p = p0 + tid;
        DcnSample s;
        float m = 0.f;
        if (p < P) {
          s = dcn_sample(g, off, b, gi, t, p);
          m = dcn_mask(g, mask, b, gi, t, p);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s.idx[k] = -1;
            s.wt[k] = 0.f;
          }
          s.ly = s.lx = 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = s.idx[k];
          s_bw[k][tid] = s.wt[k];
        }
        s_ly[tid] = s.ly;
        s_lx[tid] = s.lx;
        s_m[tid] = m;
        s_red[0][tid] = s_red[1][tid] = s_red[2][tid] = 0.f;
      }
      for (int c0 = 0; c0 < g.cpg; c0 += kBC) {
        __syncthreads();  // samples ready; the last chunk is done with s_w
        for (int e = tid; e < g.Cout * kBC; e += kThreads) {
          const int o = e / kBC;
          const int ch = c0 + e % kBC;
          s_w[e] = ch < g.cpg
                       ? __ldg(wtb + ((size_t)t * g.Cout + o) * g.Cin + gi * g.cpg + ch)
                       : 0.f;
        }
        __syncthreads();

        float gsm[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) gsm[i] = 0.f;
        const float* ctp = s_ct + pg * 8;
        for (int o = 0; o < g.Cout; ++o) {
          const float wv = s_w[o * kBC + cl];
          const float4 a0 = *reinterpret_cast<const float4*>(ctp + o * kBP);
          const float4 a1 = *reinterpret_cast<const float4*>(ctp + o * kBP + 4);
          gsm[0] = fmaf(a0.x, wv, gsm[0]);
          gsm[1] = fmaf(a0.y, wv, gsm[1]);
          gsm[2] = fmaf(a0.z, wv, gsm[2]);
          gsm[3] = fmaf(a0.w, wv, gsm[3]);
          gsm[4] = fmaf(a1.x, wv, gsm[4]);
          gsm[5] = fmaf(a1.y, wv, gsm[5]);
          gsm[6] = fmaf(a1.z, wv, gsm[6]);
          gsm[7] = fmaf(a1.w, wv, gsm[7]);
        }

        const int ch = c0 + cl;
        const bool active = ch < g.cpg;
        const float* xc = x + img + gi * g.cpg + ch;
        float* gxc = gx + img + gi * g.cpg + ch;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = pg * 8 + i;
          float rm = 0.f, ry = 0.f, rx = 0.f;
          if (active) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int id = s_idx[k][p];
              v[k] = id >= 0 ? __ldg(xc + (size_t)id * g.Cin) : 0.f;
            }
            const float s = v[0] * s_bw[0][p] + v[1] * s_bw[1][p] +
                            v[2] * s_bw[2][p] + v[3] * s_bw[3][p];
            const float gs = gsm[i] * s_m[p];
            const float ly = s_ly[p];
            const float lx = s_lx[p];
            rm = gsm[i] * s;
            ry = gs * ((1.f - lx) * (v[2] - v[0]) + lx * (v[3] - v[1]));
            rx = gs * ((1.f - ly) * (v[1] - v[0]) + ly * (v[3] - v[2]));
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int id = s_idx[k][p];
              if (id >= 0) atomicAdd(gxc + (size_t)id * g.Cin, gs * s_bw[k][p]);
            }
          }
          rm = warp_sum(rm);
          ry = warp_sum(ry);
          rx = warp_sum(rx);
          if (lane == 0) {
            atomicAdd(&s_red[0][p], rm);
            atomicAdd(&s_red[1][p], ry);
            atomicAdd(&s_red[2][p], rx);
          }
        }
      }
      __syncthreads();
      if (tid < kBP && p0 + tid < P) {
        const size_t ob = (size_t)b * 2 * g.G * kk;
        const int p = p0 + tid;
        goff[(ob + gi * kk + t) * P + p] = s_red[1][tid];
        goff[(ob + (size_t)g.G * kk + gi * kk + t) * P + p] = s_red[2][tid];
        if (gmask != nullptr)
          gmask[((size_t)b * g.G * kk + gi * kk + t) * P + p] = s_red[0][tid];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dcn_bwd_weight_kernel(const float* __restrict__ x,     // (B, H, W, Cin)
                      const float* __restrict__ off,   // (B, 2*G*kk, Ho, Wo)
                      const float* __restrict__ mask,  // (B, G*kk, Ho, Wo) or null
                      const float* __restrict__ ct,    // (B, Cout, Ho, Wo)
                      float* __restrict__ gw,          // (kk, Cin, Cout), zeroed
                      DcnGeom g, int q_per_split) {
  __shared__ __align__(16) float s_a[kWK][kWC + 4];  // sm[q][c]
  __shared__ __align__(16) float s_b[kWK][kWO + 4];  // ct[q][o]
  __shared__ int s_idx[4][kWK];                       // corner rows of (B*H*W)
  __shared__ float s_cw[4][kWK];                      // corner weight x mask
  __shared__ int s_ct[kWK];                           // b*Cout*P + p, or -1

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // input channels ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3 of the tile
  const int kk = g.kh * g.kw;
  const int P = g.Ho * g.Wo;
  const int nct = (g.cpg + kWC - 1) / kWC;
  const int gi = blockIdx.x / nct;
  const int c0 = (blockIdx.x % nct) * kWC;
  const int o0 = blockIdx.y * kWO;
  const int t = blockIdx.z % kk;
  const int q_begin = (blockIdx.z / kk) * q_per_split;
  const int q_end = min(g.B * P, q_begin + q_per_split);
  const float* xg = x + gi * g.cpg;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += kWK) {
    __syncthreads();  // the last step is done with every shared array
    if (tid < kWK) {
      const int q = q0 + tid;
      if (q < q_end) {
        const int b = q / P;
        const int p = q - b * P;
        const DcnSample s = dcn_sample(g, off, b, gi, t, p);
        const float m = dcn_mask(g, mask, b, gi, t, p);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = s.idx[k] < 0 ? -1 : b * g.H * g.W + s.idx[k];
          s_cw[k][tid] = s.wt[k] * m;
        }
        s_ct[tid] = b * g.Cout * P + p;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = -1;
          s_cw[k][tid] = 0.f;
        }
        s_ct[tid] = -1;
      }
    }
    __syncthreads();
    for (int e = tid; e < kWK * kWC; e += kThreads) {
      const int c = e % kWC;
      const int k = e / kWC;
      const int ch = c0 + c;
      float v = 0.f;
      if (ch < g.cpg) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int id = s_idx[n][k];
          if (id >= 0) v = fmaf(s_cw[n][k], __ldg(xg + (size_t)id * g.Cin + ch), v);
        }
      }
      s_a[k][c] = v;
    }
    for (int e = tid; e < kWK * kWO; e += kThreads) {
      const int k = e % kWK;
      const int o = e / kWK;
      const int oc = o0 + o;
      const int r = s_ct[k];
      s_b[k][o] = (r >= 0 && oc < g.Cout) ? __ldg(ct + (size_t)r + (size_t)oc * P) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kWK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[k][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&s_b[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c0 + ty * 4 + i;
    if (ci >= g.cpg) continue;
    float* row = gw + ((size_t)t * g.Cin + gi * g.cpg + ci) * g.Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oc = o0 + tx * 4 + j;
      if (oc < g.Cout) atomicAdd(row + oc, acc[i][j]);
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Largest Cout the data kernel's shared memory holds.
int rrnet_dcn_bwd_max_cout() {
  return (kMaxSmem - kDataStaticSmem) / ((kBP + kBC) * (int)sizeof(float));
}

// Returns the first CUDA error of the call (0 = both kernels launched).
// Writes gx (B, H, W, Cin) channels last, gw (kk, Cin, Cout), goff and,
// unless `mask` is null, gmask. The wrapper has checked shapes and limits.
int rrnet_dcn_bwd(const float* x, const float* wtb, const float* off,
                  const float* mask, const float* ct, float* gx, float* gw,
                  float* goff, float* gmask, int B, int H, int W, int Cin,
                  int Cout, int kh, int kw, int Ho, int Wo, int stride,
                  int pad, int dil, int G, void* stream) {
  if (B < 1 || B > 65535 || G < 1 || Cin % G != 0 || Ho < 1 || Wo < 1 ||
      Cout < 1 || Cout > rrnet_dcn_bwd_max_cout()) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DcnGeom g{B, H, W, Cin, Cout, kh, kw, Ho, Wo, stride, pad, dil, G,
                  Cin / G};
  const int P = Ho * Wo;
  const int kk = kh * kw;
  cudaError_t err = cudaMemsetAsync(gx, 0, sizeof(float) * (size_t)B * H * W * Cin, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(gw, 0, sizeof(float) * (size_t)kk * Cin * Cout, s);
  if (err != cudaSuccess) return (int)err;

  const int smem = Cout * (kBP + kBC) * (int)sizeof(float);
  err = cudaFuncSetAttribute(dcn_bwd_data_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_d((P + kBP - 1) / kBP, B);
  dcn_bwd_data_kernel<<<grid_d, kThreads, smem, s>>>(x, wtb, off, mask, ct, gx,
                                                     goff, gmask, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // split the B*P positions so that about four blocks run per SM
  const int tiles = G * ((Cin / G + kWC - 1) / kWC) * ((Cout + kWO - 1) / kWO) * kk;
  const int q = B * P;
  const int max_splits = (q + 4 * kWK - 1) / (4 * kWK);
  int splits = (4 * num_sms() + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  int q_per_split = (q + splits - 1) / splits;
  q_per_split = (q_per_split + kWK - 1) / kWK * kWK;
  splits = (q + q_per_split - 1) / q_per_split;
  const dim3 grid_w(G * ((Cin / G + kWC - 1) / kWC), (Cout + kWO - 1) / kWO,
                    kk * splits);
  dcn_bwd_weight_kernel<<<grid_w, kThreads, 0, s>>>(x, off, mask, ct, gw, g,
                                                    q_per_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
