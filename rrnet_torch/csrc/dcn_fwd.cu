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
// What bounds it on the card: operations. The GEMM is 2*B*P*kk*Cin*Cout
// flop (5 GFLOP per launch at the serve shape) against ~13 MB of inputs
// and outputs, so the f32 rate sets the bound.
//
// Design: an implicit GEMM whose A operand (the sampled, mask-multiplied
// im2col tile) exists only in shared memory, the fusion the TPU kernel
// makes in VMEM. One block of 256 threads owns 64 output positions of
// one image x 64 output channels. For each (tap, group) the block finds
// the four corners and weights of its 64 samples once (mask folded into
// the weights), then walks the group's channels 32 at a time: it samples
// the 32 x 64 tile (consecutive threads read consecutive channels of the
// channels-last x, one coalesced row segment per corner), loads the
// matching 32 x 64 slice of the (kk, Cin, Cout) weight, and every thread
// adds the 4 x 4 outer products to its f32 accumulators. The sampling
// is redone for each of the Cout / 64 channel tiles. Plain FMAs on the
// CUDA cores: tensor cores, TMA and a pipelined ring are later work.

#include "dcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;  // output positions per block
constexpr int kTO = 64;  // output channels per block
constexpr int kKC = 32;  // input channels per step

__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const float* __restrict__ x,     // (B, H, W, Cin)
               const float* __restrict__ wt,    // (kk, Cin, Cout)
               const float* __restrict__ off,   // (B, 2*G*kk, Ho, Wo)
               const float* __restrict__ mask,  // (B, G*kk, Ho, Wo) or null
               const float* __restrict__ bias,  // (Cout) or null
               float* __restrict__ out,         // (B, Cout, Ho, Wo)
               DcnGeom g) {
  // +4: a row stride of 68 floats keeps the float4 reads aligned and
  // spreads the column writes of the sampling pass over 8 banks
  __shared__ __align__(16) float s_val[kKC][kTP + 4];
  __shared__ __align__(16) float s_w[kKC][kTO];
  __shared__ int s_idx[4][kTP];
  __shared__ float s_cw[4][kTP];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // positions ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3 of the tile
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kTP;
  const int o0 = blockIdx.y * kTO;
  const int P = g.Ho * g.Wo;
  const int kk = g.kh * g.kw;
  const float* xb = x + (size_t)b * g.H * g.W * g.Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kk; ++t) {
    for (int gi = 0; gi < g.G; ++gi) {
      __syncthreads();  // the last step is done with s_idx / s_cw
      if (tid < kTP) {
        const int p = p0 + tid;
        if (p < P) {
          const DcnSample s = dcn_sample(g, off, b, gi, t, p);
          const float m = dcn_mask(g, mask, b, gi, t, p);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s_idx[k][tid] = s.idx[k];
            s_cw[k][tid] = s.wt[k] * m;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s_idx[k][tid] = -1;
            s_cw[k][tid] = 0.f;
          }
        }
      }
      const float* xg = xb + gi * g.cpg;
      const float* wg = wt + ((size_t)t * g.Cin + gi * g.cpg) * g.Cout;
      for (int c0 = 0; c0 < g.cpg; c0 += kKC) {
        __syncthreads();  // corners ready; the last GEMM step is done
        for (int e = tid; e < kKC * kTP; e += kThreads) {
          const int c = e % kKC;
          const int p = e / kKC;
          const int ch = c0 + c;
          float v = 0.f;
          if (ch < g.cpg) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int i = s_idx[k][p];
              if (i >= 0) v = fmaf(s_cw[k][p], __ldg(xg + (size_t)i * g.Cin + ch), v);
            }
          }
          s_val[c][p] = v;
        }
        for (int e = tid; e < kKC * kTO; e += kThreads) {
          const int o = e % kTO;
          const int c = e / kTO;
          const int ch = c0 + c;
          const int oc = o0 + o;
          s_w[c][o] = (ch < g.cpg && oc < g.Cout)
                          ? __ldg(wg + (size_t)ch * g.Cout + oc) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < kKC; ++c) {
          const float4 a = *reinterpret_cast<const float4*>(&s_val[c][ty * 4]);
          const float4 w = *reinterpret_cast<const float4*>(&s_w[c][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
      }
    }
  }

  const int p = p0 + ty * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oc = o0 + tx * 4 + j;
    if (oc >= g.Cout) continue;
    const float bv = bias == nullptr ? 0.f : bias[oc];
    float* row = out + ((size_t)b * g.Cout + oc) * P;
    if ((P & 3) == 0 && p + 3 < P) {
      *reinterpret_cast<float4*>(row + p) =
          make_float4(acc[0][j] + bv, acc[1][j] + bv, acc[2][j] + bv, acc[3][j] + bv);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i < P) row[p + i] = acc[i][j] + bv;
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
  const dim3 grid((Ho * Wo + kTP - 1) / kTP, (Cout + kTO - 1) / kTO, B);
  dcn_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wt, off, mask, bias, out, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
