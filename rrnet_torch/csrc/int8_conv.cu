// int8 post-training-quantized convolution for Hopper (sm_90a): a
// quantize-and-pack pass over the activation and an implicit-GEMM
// convolution on the int8 tensor cores.
//
// Not the port of a TPU kernel: the JAX package runs its quantized body
// convolutions as XLA's int8 x int8 -> int32 `lax.conv_general_dilated`
// (rrnet_tpu/models/layers.py:166-169), after quantizing the input with
// fused XLA elementwise ops (:154-156) and before a dequantize multiply
// (:171-175). PyTorch has no int8 convolution on CUDA (`F.conv2d` refuses
// int8), so both halves are written here. The plain versions, which these
// kernels equal bit for bit, are in rrnet_torch/ops/int8_conv.py.
//
// 1. quantize_pack_kernel: x (N, C, H, W) f32 or bf16 -> int8
//    (N, H, W, Cp), Cp = C rounded up to 16, the pad channels 0. Each
//    value is rint(f32(x) * inv) (one IEEE multiply, round half to even,
//    as jnp.round and torch.round) clamped to [-127, 127]. A 256-thread
//    block quantizes a tile of 32 pixels x 64 channels: reads along the
//    pixels (coalesced in NCHW), transposes through shared memory, writes
//    4 channels a word along the channels (NHWC). Bound: bytes, one read
//    of x and one write of the int8 map.
// 2. int8_conv_kernel: out (N, cout, Ho, Wo) = dequant(xq (*) wq) as an
//    implicit GEMM, M = N*Ho*Wo output pixels, N = cout, K = kh*kw*Cp in
//    (ky, kx, c) order, so that each pixel's 16 channels of a tap are one
//    16-byte load of the NHWC map. The weights come packed once by the
//    wrapper: (cout, Kp) int8, Kp = K rounded up to 64, zero tail. A
//    256-thread block computes a 128 x 128 output tile over K in 64-byte
//    steps; a 3-stage ring of `cp.async` copies (zero-filled at the
//    padding, past K and past the edges) keeps two steps in flight while
//    eight warps, each a 64 x 32 sub-tile, run
//    mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the step that
//    has landed (fragment layout: the int8 sibling of the m16n8k8 TF32
//    tiles in dcn_common.cuh; a0 row g bytes 4t..4t+3, a1 row g+8, a2/a3
//    the same rows at bytes 16+4t; b0 column g bytes 4t..4t+3, b1 bytes
//    16+4t; d0/d1 row g columns 2t, 2t+1, d2/d3 row g+8). Rows of the
//    shared tiles are 80 bytes apart, so each fragment load of a warp hits
//    32 distinct banks. The int32 accumulators are exact; the epilogue is
//    the JAX order op by op: f32(acc) (round to nearest) times the
//    per-channel f32 scale s_w * f32(s_in), cast to the output type
//    (__float2bfloat16_rn, or f32), then + bias in that type, stored NCHW.
//    A third output mode stores the raw int32 accumulators (the check).
//    Padding is per side (top, bottom, left, right), so JAX's explicit
//    paddings and its SAME padding (asymmetric at stride 2) map exactly.
//    Where the output tiles alone would leave most of the 132 SMs idle
//    (the deep maps and stage 2's ROI convs, whose K is 9 x 384-512 long),
//    K is split over blockIdx.z: each block adds its partial int32 sums
//    into a zeroed int32 map with atomicAdd (integer sums are exact in any
//    order, so the result stays bit-equal), and dequant_kernel writes the
//    output from it.
//
// What bounds it on this card: 2 * M * cout * kh*kw*cin operations over
// the int8 tensor cores' 1,979e12 a second (dense), or, for the small
// deep maps (6x11 to 24x44 pixels at 384-512 channels) and the stage-2
// ROI convs, the bytes of the int8 input, the int8 weights and the output
// over 3.35e12 B/s. The hourglass's 192x352 3x3 convs at 256 channels are
// ~80 G operations a call: ~0.04 ms at the peak. This first design is
// mma.sync fed by a 3-stage cp.async ring, no wgmma, no TMA and no
// persistent schedule, and it reaches ~16-19% of the peak at those shapes
// (PERF.md). Measured on the card: the input's loads through L1 gained
// 7-14% there; a 4th or 5th stage, 64x64 warp tiles (4 warps, or 8 warps
// on 256x128 with ldmatrix) did not: the operand traffic from L2 and
// the mma.sync issue at this occupancy, not the pipeline depth, look like
// the limit (unverified without a profiler of the SM). The redesign (`wgmma` reading B from shared memory, TMA
// tiles, a persistent schedule, the quantization fused into the
// producer's epilogue) is queued in ROADMAP.md. Output stores go straight
// from the accumulator fragments (16-byte runs of NCHW rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;              // output pixels a block
constexpr int kBN = 128;              // output channels a block
constexpr int kBK = 64;               // K bytes a pipeline step
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;        // bytes between tile rows
constexpr int kRowWords = kRow / 4;
constexpr int kTile = kBM * kRow;     // bytes of one A (or B) tile
constexpr int kSmem = kStages * 2 * kTile;

constexpr int kQP = 32;               // quantize: pixels a tile
constexpr int kQC = 64;               // quantize: channels a tile

struct ConvGeom {
  int N, H, W, Cp;          // input (N, H, W, Cp) int8
  int cout, kh, kw, sh, sw, pt, pl;
  int Ho, Wo;
  int K;                    // kh * kw * Cp
  int Kp;                   // K rounded up to kBK: the packed weight row
  int split_steps;          // K steps a block of a split-K grid takes
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rint(v * inv) clamped to [-127, 127]
__device__ __forceinline__ int8_t quantize1(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <typename T>
__global__ void __launch_bounds__(256)
quantize_pack_kernel(const T* __restrict__ x, int8_t* __restrict__ out,
                     int C, int Cp, int HW, float inv) {
  __shared__ __align__(16) int8_t tile[kQP][kQC + 4];
  const int p0 = blockIdx.x * kQP;
  const int c0 = blockIdx.y * kQC;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int lp = tid & 31;
  const int p = p0 + lp;
#pragma unroll
  for (int i = 0; i < kQC / 8; ++i) {
    const int lc = (tid >> 5) + 8 * i;
    const int c = c0 + lc;
    int8_t q = 0;
    if (c < C && p < HW) q = quantize1(to_f32(x[((size_t)n * C + c) * HW + p]), inv);
    tile[lp][lc] = q;
  }
  __syncthreads();
  const int wp = tid >> 3;
  const int pw = p0 + wp;
  if (pw >= HW) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int w = (tid & 7) + 8 * j;
    const int c = c0 + 4 * w;
    if (c < Cp) {
      *reinterpret_cast<uint32_t*>(out + ((size_t)n * HW + pw) * Cp + c) =
          *reinterpret_cast<const uint32_t*>(&tile[wp][4 * w]);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`, or 16 zero bytes when
// `!full` (src is then not read): through L2 only (.cg), for the weights,
// which a block reads once; through L1 as well (.ca), for the input map,
// whose pixels a block reads again at each tap of a kernel row.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b, one m16n8k32 int8 product with an int32 accumulator.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kOutAdd: a split-K block adds its partial int32 sums (exact, in any
// order) into a zeroed int32 map; dequant_kernel then writes the output.
enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2, kOutAdd = 3 };

template <int OUT>
__device__ __forceinline__ void store_out(void* out, size_t o, int acc,
                                          float scale, const void* bias,
                                          int n) {
  if (OUT == kOutI32) {
    static_cast<int*>(out)[o] = acc;
  } else if (OUT == kOutAdd) {
    atomicAdd(static_cast<int*>(out) + o, acc);
  } else if (OUT == kOutF32) {
    float y = __fmul_rn(__int2float_rn(acc), scale);
    if (bias != nullptr) y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
    static_cast<float*>(out)[o] = y;
  } else {
    __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale));
    if (bias != nullptr) {
      const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
      y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
    }
    static_cast<__nv_bfloat16*>(out)[o] = y;
  }
}

template <int OUT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale,
                 const void* __restrict__ bias, void* __restrict__ out,
                 ConvGeom g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int HoWo = g.Ho * g.Wo;
  const int M = g.N * HoWo;
  const int bm = blockIdx.x * kBM;
  const int bn = blockIdx.y * kBN;

  // The copies: thread t fills 32 bytes (two 16-byte pieces) of row t/2
  // of the A tile (an output pixel) and of the B tile (an output channel).
  const int lr = tid >> 1;
  const int half = (tid & 1) * 32;
  const int m = bm + lr;
  const bool m_ok = m < M;
  int iy0 = 0, ix0 = 0;
  const int8_t* xbase = xq;
  if (m_ok) {
    const int img = m / HoWo;
    const int p = m - img * HoWo;
    const int oy = p / g.Wo;
    iy0 = oy * g.sh - g.pt;
    ix0 = (p - oy * g.Wo) * g.sw - g.pl;
    xbase = xq + (size_t)img * g.H * g.W * g.Cp;
  }
  const int nr = bn + lr;
  const bool n_ok = nr < g.cout;
  const int8_t* wrow = wq + (size_t)(n_ok ? nr : 0) * g.Kp + half;

  // With Cp a multiple of kBK a step lies inside one tap: one tap lookup
  // a step; else each 16-byte piece finds its own tap.
  const bool tap_steps = g.Cp % kBK == 0;
  auto load = [&](int stage, int kc) {
    uint8_t* as = smem + stage * 2 * kTile + lr * kRow + half;
    uint8_t* bs = as + kTile;
    int tap = 0, c0 = 0;
    if (tap_steps) {
      const int per_tap = g.Cp / kBK;
      tap = kc / per_tap;
      c0 = (kc - tap * per_tap) * kBK + half;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k0 = kc * kBK + half + 16 * j;
      const int8_t* src = xq;
      bool ok = m_ok && k0 < g.K;
      if (ok) {
        int t = tap, c = c0 + 16 * j;
        if (!tap_steps) {
          t = k0 / g.Cp;
          c = k0 - t * g.Cp;
        }
        const int ky = t / g.kw;
        const int iy = iy0 + ky;
        const int ix = ix0 + (t - ky * g.kw);
        ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        if (ok) src = xbase + ((size_t)iy * g.W + ix) * g.Cp + c;
      }
      cp_async16_ca(as + 16 * j, src, ok);
      cp_async16(bs + 16 * j, n_ok ? wrow + (size_t)kc * kBK + 16 * j : wq,
                 n_ok);
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 2) * 64;    // the warp's rows in the tile
  const int wn = (warp & 3) * 32;     // and its columns
  const int gq = lane >> 2;
  const int tq = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  // this block's K steps: all of them, or its share of a split-K grid
  const int k_first = blockIdx.z * g.split_steps;
  const int nK = min(g.Kp / kBK - k_first, g.split_steps);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nK) load(s, k_first + s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nK; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // refill the stage every warp finished with in the step before
    const int next = kc + kStages - 1;
    if (next < nK) load(next % kStages, k_first + next);
    cp_async_commit();
    const uint32_t* As =
        reinterpret_cast<const uint32_t*>(smem + (kc % kStages) * 2 * kTile);
    const uint32_t* Bs = As + kTile / 4;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int kw0 = ks * 8 + tq;    // word of bytes 4t..4t+3 of the k32 step
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = (wm + mt * 16 + gq) * kRowWords + kw0;
        a[mt][0] = As[r];
        a[mt][1] = As[r + 8 * kRowWords];
        a[mt][2] = As[r + 4];
        a[mt][3] = As[r + 8 * kRowWords + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = (wn + nt * 8 + gq) * kRowWords + kw0;
        b[nt][0] = Bs[r];
        b[nt][1] = Bs[r + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = bm + wm + mt * 16 + gq + 8 * h;
      if (mm >= M) continue;
      const int img = mm / HoWo;
      const int p = mm - img * HoWo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = bn + wn + nt * 8 + 2 * tq + j;
          if (n >= g.cout) continue;
          store_out<OUT>(out, ((size_t)img * g.cout + n) * HoWo + p,
                         acc[mt][nt][2 * h + j],
                         OUT >= kOutI32 ? 0.f : scale[n], bias, n);
        }
      }
    }
  }
}

// The split-K epilogue: the summed int32 map (N, cout, HoWo) dequantized
// into the output, as store_out does it.
template <int OUT>
__global__ void __launch_bounds__(256)
dequant_kernel(const int* __restrict__ acc, const float* __restrict__ scale,
               const void* __restrict__ bias, void* __restrict__ out,
               int cout, int HoWo, size_t total) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)((i / HoWo) % cout);
    store_out<OUT>(out, i, acc[i], scale[n], bias, n);
  }
}

// K steps a block takes: all of them, unless the output tiles alone leave
// most SMs idle (the deep 6x11 to 24x44 maps, the ROI convs) and K is
// long: then K is split over blockIdx.z so that ~2 blocks an SM run, each
// at least 4 steps.
int split_steps(int M, int cout, int Kp) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  const int steps = Kp / kBK;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((cout + kBN - 1) / kBN);
  int splits = (int)((2LL * sms + tiles - 1) / tiles);
  splits = min(splits, steps / 4);
  if (splits <= 1) return steps;
  return (steps + splits - 1) / splits;
}

template <int OUT>
cudaError_t launch_conv(const int8_t* xq, const int8_t* wq, const float* scale,
                        const void* bias, void* out, const ConvGeom& g,
                        cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_kernel<OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const int splits = (g.Kp / kBK + g.split_steps - 1) / g.split_steps;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (g.cout + kBN - 1) / kBN,
                  splits);
  int8_conv_kernel<OUT><<<grid, kThreads, kSmem, stream>>>(xq, wq, scale, bias,
                                                           out, g);
  return cudaGetLastError();
}

// A split-K launch: the partial sums into the zeroed int32 `acc` (the
// output itself for the int32 mode), then the epilogue.
template <int OUT>
cudaError_t launch_split(const int8_t* xq, const int8_t* wq,
                         const float* scale, const void* bias, void* out,
                         int* acc, const ConvGeom& g, cudaStream_t stream) {
  cudaError_t err = launch_conv<kOutAdd>(xq, wq, nullptr, nullptr,
                                         OUT == kOutI32 ? out : acc, g, stream);
  if (err != cudaSuccess || OUT == kOutI32) return err;
  const size_t total = (size_t)g.N * g.cout * g.Ho * g.Wo;
  const size_t want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  dequant_kernel<OUT><<<blocks, 256, 0, stream>>>(acc, scale, bias, out,
                                                  g.cout, g.Ho * g.Wo, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The multiples the wrapper pads to: the input's channels, the packed
// weight rows.
int rrnet_int8_channel_align() { return 16; }
int rrnet_int8_k_align() { return kBK; }

// x (N, C, HW) f32 (is_bf16 = 0) or bf16 -> out (N, HW, Cp) int8.
int rrnet_int8_quantize_pack(const void* x, int is_bf16, void* out, int N,
                             int C, int Cp, int HW, float inv, void* stream) {
  if (N <= 0 || HW <= 0 || C <= 0 || Cp < C || Cp % 16 != 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((HW + kQP - 1) / kQP, (Cp + kQC - 1) / kQC, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    quantize_pack_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(out), C,
        Cp, HW, inv);
  } else {
    quantize_pack_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(out), C, Cp, HW,
        inv);
  }
  return (int)cudaGetLastError();
}

// Whether a conv of this geometry splits K (1) or not (0): a split needs
// a zeroed int32 (N, cout, Ho, Wo) map from the caller (for out_kind 2 the
// zeroed output itself).
int rrnet_int8_conv_splits(int N, int Ho, int Wo, int cout, int Kp) {
  if (N <= 0 || Ho <= 0 || Wo <= 0 || cout <= 0 || Kp <= 0 || Kp % kBK)
    return 0;
  return split_steps(N * Ho * Wo, cout, Kp) < Kp / kBK ? 1 : 0;
}

// xq (N, H, W, Cp) int8, wq (cout, Kp) int8, scale (cout,) f32, bias
// (cout,) in the output type or null -> out (N, cout, Ho, Wo): out_kind 0
// f32, 1 bf16, 2 the int32 accumulators. `acc`: the zeroed int32 map when
// rrnet_int8_conv_splits says so (and out_kind is not 2), else null.
int rrnet_int8_conv(const void* xq, const void* wq, const void* scale,
                    const void* bias, void* out, void* acc, int out_kind,
                    int N, int H, int W, int Cp, int cout, int kh, int kw,
                    int sh, int sw, int pt, int pl, int Ho, int Wo, int Kp,
                    void* stream) {
  ConvGeom g{N, H, W, Cp, cout, kh, kw, sh, sw, pt, pl, Ho, Wo, kh * kw * Cp,
             Kp, 0};
  if (N <= 0 || Ho <= 0 || Wo <= 0 || cout <= 0 || Cp % 16 != 0 ||
      Kp % kBK != 0 || Kp < g.K || sh <= 0 || sw <= 0 ||
      (cout + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  g.split_steps = split_steps(N * Ho * Wo, cout, Kp);
  const bool split = g.split_steps < Kp / kBK;
  if (split && out_kind != kOutI32 && acc == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  int* a32 = static_cast<int*>(acc);
  switch (out_kind) {
    case kOutF32:
      return (int)(split ? launch_split<kOutF32>(x8, w8, sc, bias, out, a32, g, s)
                         : launch_conv<kOutF32>(x8, w8, sc, bias, out, g, s));
    case kOutBF16:
      return (int)(split ? launch_split<kOutBF16>(x8, w8, sc, bias, out, a32, g, s)
                         : launch_conv<kOutBF16>(x8, w8, sc, bias, out, g, s));
    case kOutI32:
      return (int)(split ? launch_split<kOutI32>(x8, w8, sc, bias, out, a32, g, s)
                         : launch_conv<kOutI32>(x8, w8, sc, bias, out, g, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
