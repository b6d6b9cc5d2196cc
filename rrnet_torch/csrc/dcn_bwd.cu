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
// What bounds it on the card. By the roofline, operations: two GEMMs of
// the forward's size (g_sm and grad weight) plus the per-sample
// coordinate terms, 0.149 ms in f32 on the CUDA cores and 0.059 ms with
// the GEMMs as 3xTF32 on the tensor cores, at the train shape. As built,
// each kernel is held, as the forward is, by the stream of its B operand
// from L2 into shared memory (the weight slices; the cotangent slices)
// together with the issue of the mma.sync path; in the data kernel the
// operand splits of the weight slices weigh most, the grad x scatter
// (red.global.add.v4.f32) almost nothing (PERF.md, PR 4).
//
// Design: two kernels on one stream, one call. Their products run on the
// tensor cores through mma.sync m16n8k8 .tf32 in 3xTF32 (dcn_common.cuh);
// mma.sync rather than wgmma for the reasons of dcn_fwd.cu.
//  * dcn_bwd_data_kernel: one block per 32 output positions of one image
//    and one group, so the grid has G blocks per position tile (about
//    four blocks per SM at both path shapes, two resident) and every
//    (tap, group, position) sum of grad offset and grad mask is finished
//    inside one block, written once without atomics. The block keeps the
//    cotangent of its positions (32 x Cout, the A operand), split once
//    into TF32 (hi, lo) pairs, in shared memory for the whole call; Cout
//    is limited by it (rrnet_dcn_bwd_max_cout). Per (tap, chunk of 64
//    channels) the weight slice streams in by cp.async, 64 output
//    channels a stage, double-buffered, and eight warps form g_sm
//    (32 x 64) on the tensor cores; it goes through shared memory to an
//    elementwise layout in which each thread owns 2 x 4 consecutive
//    channels of one position: it reads the four corners as float4, forms
//    the grad mask and coordinate terms, and scatters grad x to each
//    corner with one red.global.add.v4.f32 (channels last make the four
//    channels contiguous; a scalar atomicAdd path serves cpg % 4 != 0).
//    The 8 threads of a position reduce their sums with shuffles.
//  * dcn_bwd_weight_kernel: an implicit GEMM, M = 64 input channels of one
//    group, N = 256 output channels, K = positions, for each tap; the
//    forward's design transposed, sixteen warps of 32 x 32. The sampled
//    tile (64 positions x 64 channels) is gathered into registers while
//    the last step's products run, the cotangent slice (256 x 64) comes
//    in by cp.async. The blocks split the (tile, position step) sequence
//    evenly ("stream-K": one block per SM slot, each a contiguous run of
//    steps), and each run's partial sums meet in the zeroed grad weight
//    through atomicAdd, at the end of each tile and after every kWFlush
//    steps: the tensor cores' accumulation drifts over long chains (see
//    dcn_fwd.cu), and a run grows with B * Ho * Wo, so no accumulator
//    sums more than kWFlush * kWK = 512 positions whatever the shape.
// Atomics make grad x and grad weight order-dependent at the last bits.

#include "dcn_common.cuh"

namespace {

// data kernel
constexpr int kDThreads = 256;     // 8 warps: 2 on M x 4 on N
constexpr int kDP = 32;            // output positions per block (M)
constexpr int kDC = 64;            // channels per chunk (N)
constexpr int kDK = 64;            // output channels per weight stage (K)
constexpr int kDStages = 2;        // weight stages in the ring
constexpr int kDSW = kDC + 8;      // weight stage row stride
constexpr int kDSG = kDC + 4;      // g_sm row stride
constexpr int kDFixedSmem = (kDStages * kDK * kDSW + kDP * kDSG) * (int)sizeof(float);
constexpr int kMaxSmem = 232448;   // opt-in shared memory of one H100 block
// weight kernel
constexpr int kWThreads = 512;     // 16 warps: 2 on M x 8 on N
constexpr int kWM = 64;            // input channels per tile (M)
constexpr int kWN = 256;           // output channels per tile (N)
constexpr int kWK = 64;            // positions per step (K)
constexpr int kWSA = kWM + 8;      // sA[q][c] row stride
constexpr int kWSB = kWK + 4;      // sB[o][q] row stride
constexpr int kWFlush = 8;         // steps summed in one accumulator at most
constexpr int kWSmem = (2 * kWK * kWSA + 2 * kWN * kWSB) * (int)sizeof(float);

// The ct tile's row stride for Cout, in (hi, lo) pairs: K padded to
// whole weight stages, +4 so that fragment rows fall in distinct banks.
__host__ __device__ inline int data_ct_stride(int cout) {
  return (cout + kDK - 1) / kDK * kDK + 4;
}

inline int data_smem(int cout) {
  return kDFixedSmem + kDP * data_ct_stride(cout) * (int)sizeof(float2);
}

__device__ __forceinline__ void red_add4(float* dst, float a, float b, float c,
                                         float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"l"(dst),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__global__ void __launch_bounds__(kDThreads, 2)
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
  const int sc = data_ct_stride(g.Cout);
  float2* s_ct = reinterpret_cast<float2*>(smem4);      // [kDP][sc]: ct[p][o] split
  float* s_w = reinterpret_cast<float*>(s_ct + kDP * sc);  // [kDStages][kDK][kDSW]: W[o][c]
  float* s_g = s_w + kDStages * kDK * kDSW;       // [kDP][kDSG]: g_sm[p][c]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 2;  // positions wm*16 .. +15 of the g_sm tile
  const int wn = warp & 3;   // channels wn*16 .. +15
  const int gi = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kDP;
  const int P = g.Ho * g.Wo;
  const int kk = g.kh * g.kw;
  const int nch = (g.cpg + kDC - 1) / kDC;  // channel chunks
  const int nkc = (sc - 4) / kDK;           // weight stages per chunk
  const int stages = kk * nch * nkc;
  const size_t img = (size_t)b * g.H * g.W * g.Cin;
  // elementwise role: position ep, channels 4*eq.. and 32+4*eq.. of a chunk
  const int ep = tid >> 3;
  const int eq = tid & 7;
  const int p_own = p0 + ep;
  const bool in_tile = p_own < P;
  const bool vec = (g.cpg & 3) == 0;  // then Cin = G * cpg is too

  for (int e = tid; e < (sc - 4) * kDP; e += kDThreads) {
    const int o = e / kDP;
    const int p = e % kDP;
    uint32_t hi, lo;
    split_tf32((o < g.Cout && p0 + p < P)
                   ? __ldg(ct + ((size_t)b * g.Cout + o) * P + p0 + p) : 0.f,
               hi, lo);
    s_ct[p * sc + o] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }

  // weight stage s (output channels kc*kDK.. of chunk ck of tap t) into
  // ring slot s % kDStages
  auto fetch_w = [&](int s) {
    if (s < stages) {
      const int kc = s % nkc;
      const int u = s / nkc;
      const int ck = u % nch;
      const int t = u / nch;
      const int o0 = kc * kDK;
      const int c0 = ck * kDC;
      float* dst = s_w + (s % kDStages) * kDK * kDSW;
      const float* src = wtb + ((size_t)t * g.Cout + o0) * g.Cin + gi * g.cpg + c0;
      if (vec) {
#pragma unroll
        for (int e = tid; e < kDK * kDC / 4; e += kDThreads) {
          const int r = e / (kDC / 4);
          const int c = (e % (kDC / 4)) * 4;
          const bool ok = o0 + r < g.Cout && c0 + c < g.cpg;
          cp_async16(dst + r * kDSW + c, ok ? src + (size_t)r * g.Cin + c : wtb, ok);
        }
      } else {
        for (int e = tid; e < kDK * kDC; e += kDThreads) {
          const int r = e / kDC;
          const int c = e % kDC;
          const bool ok = o0 + r < g.Cout && c0 + c < g.cpg;
          cp_async4(dst + r * kDSW + c, ok ? src + (size_t)r * g.Cin + c : wtb, ok);
        }
      }
    }
    cp_async_commit();
  };

  fetch_w(0);
  int s = 0;
  for (int t = 0; t < kk; ++t) {
    const DcnSample sm = in_tile ? dcn_sample(g, off, b, gi, t, p_own)
                                 : dcn_no_sample();
    const float m = in_tile ? dcn_mask(g, mask, b, gi, t, p_own) : 0.f;
    float rm = 0.f, ry = 0.f, rx = 0.f;
    for (int ck = 0; ck < nch; ++ck) {
      float acc[1][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[0][i][j] = 0.f;
      for (int kc = 0; kc < nkc; ++kc, ++s) {
        cp_async_wait_all();
        __syncthreads();  // stage s is in; stage s-1's products (and the
                          // last chunk's elementwise pass) are done
        fetch_w(s + 1);
        const float2* a_base = s_ct + (wm * 16 + gid) * sc + kc * kDK + tig;
        const float* b_base = s_w + (s % kDStages) * kDK * kDSW + tig * kDSW + wn * 16 + gid;
#pragma unroll
        for (int ks = 0; ks < kDK / 8; ++ks) {
          uint32_t ah[1][4], al[1][4], bh[2][2], bl[2][2];
          load_a2_rowmajor(a_base + ks * 8, sc, ah[0], al[0]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            load_b(b_base + ks * 8 * kDSW + nt * 8, kDSW, bh[nt], bl[nt]);
          mma_3xtf32(acc, ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* row = s_g + (wm * 16 + gid) * kDSG + wn * 16 + nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(row) = make_float2(acc[0][nt][0], acc[0][nt][1]);
        *reinterpret_cast<float2*>(row + 8 * kDSG) = make_float2(acc[0][nt][2], acc[0][nt][3]);
      }
      __syncthreads();  // g_sm of the chunk is in shared memory

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = eq + 8 * half;
        const int ch = ck * kDC + 4 * j;
        if (!in_tile || ch >= g.cpg) continue;
        const int nv = g.cpg - ch;
        const float4 gs4 = *reinterpret_cast<const float4*>(s_g + ep * kDSG + 4 * j);
        const float gsm[4] = {gs4.x, gs4.y, gs4.z, gs4.w};
        const float* xs = x + img + gi * g.cpg + ch;
        float* gxs = gx + img + gi * g.cpg + ch;
        float v[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 c4 = sm.idx[k] >= 0
                                ? dcn_load4(xs + (size_t)sm.idx[k] * g.Cin, vec, nv)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          v[k][0] = c4.x;
          v[k][1] = c4.y;
          v[k][2] = c4.z;
          v[k][3] = c4.w;
        }
        float gs[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float sv = v[0][c] * sm.wt[0] + v[1][c] * sm.wt[1] +
                           v[2][c] * sm.wt[2] + v[3][c] * sm.wt[3];
          gs[c] = gsm[c] * m;
          rm = fmaf(gsm[c], sv, rm);
          ry = fmaf(gs[c], (1.f - sm.lx) * (v[2][c] - v[0][c]) + sm.lx * (v[3][c] - v[1][c]), ry);
          rx = fmaf(gs[c], (1.f - sm.ly) * (v[1][c] - v[0][c]) + sm.ly * (v[3][c] - v[2][c]), rx);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (sm.idx[k] < 0) continue;
          float* dst = gxs + (size_t)sm.idx[k] * g.Cin;
          const float w = sm.wt[k];
          if (vec) {
            red_add4(dst, gs[0] * w, gs[1] * w, gs[2] * w, gs[3] * w);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c < nv) atomicAdd(dst + c, gs[c] * w);
          }
        }
      }
    }
    // the 8 threads of a position are adjacent lanes
#pragma unroll
    for (int d = 4; d > 0; d >>= 1) {
      rm += __shfl_xor_sync(0xffffffffu, rm, d);
      ry += __shfl_xor_sync(0xffffffffu, ry, d);
      rx += __shfl_xor_sync(0xffffffffu, rx, d);
    }
    if (eq == 0 && in_tile) {
      const size_t ob = (size_t)b * 2 * g.G * kk;
      goff[(ob + gi * kk + t) * P + p_own] = ry;
      goff[(ob + (size_t)g.G * kk + gi * kk + t) * P + p_own] = rx;
      if (gmask != nullptr)
        gmask[((size_t)b * g.G * kk + gi * kk + t) * P + p_own] = rm;
    }
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
dcn_bwd_weight_kernel(const float* __restrict__ x,     // (B, H, W, Cin)
                      const float* __restrict__ off,   // (B, 2*G*kk, Ho, Wo)
                      const float* __restrict__ mask,  // (B, G*kk, Ho, Wo) or null
                      const float* __restrict__ ct,    // (B, Cout, Ho, Wo)
                      float* __restrict__ gw,          // (kk, Cin, Cout), zeroed
                      DcnGeom g) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // [2][kWK][kWSA]: sm[q][c]
  float* sB = sA + 2 * kWK * kWSA;              // [2][kWN][kWSB]: ct[o][q]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 3;  // input channels wm*32 .. +31 of the tile
  const int wn = warp & 7;   // output channels wn*32 .. +31
  const int P = g.Ho * g.Wo;
  const int kk = g.kh * g.kw;
  const int nct = (g.cpg + kWM - 1) / kWM;
  const int nnt = (g.Cout + kWN - 1) / kWN;
  const int pch = (P + kWK - 1) / kWK;  // position steps per image
  const int nchunk = g.B * pch;
  const long long units = (long long)kk * g.G * nct * nnt * nchunk;
  const long long u_begin = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  // gather role: position gq_ of a step, channels 4*gc.. and 32+4*gc..
  const int gq_ = tid >> 3;
  const int gc = tid & 7;
  const bool vec = (g.cpg & 3) == 0;
  const bool cvec = (P & 3) == 0;

  struct Unit {
    int t, gi, c0, n0, b, p0;
  };
  auto decode = [&](long long u) {
    Unit r;
    long long tile = u / nchunk;
    const int chunk = (int)(u % nchunk);
    r.n0 = (int)(tile % nnt) * kWN;
    tile /= nnt;
    r.c0 = (int)(tile % nct) * kWM;
    tile /= nct;
    r.gi = (int)(tile % g.G);
    r.t = (int)(tile / g.G);
    r.b = chunk / pch;
    r.p0 = (chunk % pch) * kWK;
    return r;
  };

  int idx[4];
  float cw[4];
  float4 cv[2][4];
  float ndy = 0.f, ndx = 0.f, nm = 0.f;  // offsets and mask of the next unit's sample
  auto prefetch_offsets = [&](long long u) {
    const Unit n = decode(u);
    const int p = n.p0 + gq_;
    if (p < P) {
      dcn_offset(g, off, n.b, n.gi, n.t, p, ndy, ndx);
      nm = dcn_mask(g, mask, n.b, n.gi, n.t, p);
    }
  };

  // unit u: its cotangent slice by cp.async into stage st, its corners into cv
  auto fetch = [&](long long u, int st) {
    const Unit n = decode(u);
    float* dst = sB + st * kWN * kWSB;
    const float* src = ct + ((size_t)n.b * g.Cout + n.n0) * P + n.p0;
    if (cvec) {
#pragma unroll
      for (int e = tid; e < kWN * kWK / 4; e += kWThreads) {
        const int r = e / (kWK / 4);
        const int k = (e % (kWK / 4)) * 4;
        const bool ok = n.n0 + r < g.Cout && n.p0 + k < P;
        cp_async16(dst + r * kWSB + k, ok ? src + (size_t)r * P + k : ct, ok);
      }
    } else {
      for (int e = tid; e < kWN * kWK; e += kWThreads) {
        const int r = e / kWK;
        const int k = e % kWK;
        const bool ok = n.n0 + r < g.Cout && n.p0 + k < P;
        cp_async4(dst + r * kWSB + k, ok ? src + (size_t)r * P + k : ct, ok);
      }
    }
    cp_async_commit();
    const int p = n.p0 + gq_;
    const DcnSample sm = p < P ? dcn_sample_at(g, n.t, p, ndy, ndx) : dcn_no_sample();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      idx[k] = sm.idx[k];
      cw[k] = sm.wt[k] * nm;
    }
    if (u + 1 < u_end) prefetch_offsets(u + 1);
    const float* xs = x + (size_t)n.b * g.H * g.W * g.Cin + n.gi * g.cpg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = n.c0 + 4 * (gc + 8 * h);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cv[h][k] = (idx[k] >= 0 && ch < g.cpg)
                       ? dcn_load4(xs + (size_t)idx[k] * g.Cin + ch, vec, g.cpg - ch)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  if (u_begin >= u_end) return;
  prefetch_offsets(u_begin);
  fetch(u_begin, 0);
  for (long long u = u_begin; u < u_end; ++u) {
    const int st = (int)((u - u_begin) & 1);
    const Unit cur = decode(u);
    float* a_s = sA + st * kWK * kWSA;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) fma4(v, cw[k], cv[h][k]);
      *reinterpret_cast<float4*>(a_s + gq_ * kWSA + 4 * (gc + 8 * h)) = v;
    }
    cp_async_wait_all();
    __syncthreads();  // unit u's operands are in; unit u-1's products are done
    if (u + 1 < u_end) fetch(u + 1, st ^ 1);
    const bool warp_on = cur.c0 + wm * 32 < g.cpg && cur.n0 + wn * 32 < g.Cout;
    if (warp_on) {
      const float* a_base = a_s + tig * kWSA + wm * 32 + gid;
      const float* b_base = sB + st * kWN * kWSB + (wn * 32 + gid) * kWSB + tig;
#pragma unroll
      for (int ks = 0; ks < kWK / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          load_a_colmajor(a_base + ks * 8 * kWSA + mt * 16, kWSA, ah[mt], al[mt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bh[2], bl[2];
          load_b(b_base + nt * 8 * kWSB + ks * 8, 1, bh, bl);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh, bl);
        }
      }
    }
    // the run's end, the tile's end, or kWFlush steps (counted from 0, so
    // that the blocks flush at different times)
    const bool last = u + 1 == u_end || (u + 1) % nchunk == 0 || (u + 1) % kWFlush == 0;
    if (last && warp_on) {
      // this run's partial sums of the tile since the last flush
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = cur.c0 + wm * 32 + mt * 16 + h * 8 + gid;
          if (c >= g.cpg) continue;
          float* row = gw + ((size_t)cur.t * g.Cin + cur.gi * g.cpg + c) * g.Cout;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int o = cur.n0 + wn * 32 + nt * 8 + 2 * tig + j;
              if (o < g.Cout) atomicAdd(row + o, acc[mt][nt][2 * h + j]);
            }
          }
        }
      }
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Largest Cout the data kernel's shared memory holds (its cotangent tile
// grows with Cout); the wrapper reads this limit.
int rrnet_dcn_bwd_max_cout() {
  return ((kMaxSmem - kDFixedSmem) / (kDP * (int)sizeof(float2)) - 4) / kDK * kDK;
}

// Returns the first CUDA error of the call (0 = both kernels launched).
// Writes gx (B, H, W, Cin) channels last, gw (kk, Cin, Cout), goff and,
// unless `mask` is null, gmask. The wrapper has checked shapes and limits.
int rrnet_dcn_bwd(const float* x, const float* wtb, const float* off,
                  const float* mask, const float* ct, float* gx, float* gw,
                  float* goff, float* gmask, int B, int H, int W, int Cin,
                  int Cout, int kh, int kw, int Ho, int Wo, int stride,
                  int pad, int dil, int G, void* stream) {
  if (B < 1 || B > 65535 || G < 1 || G > 65535 || Cin % G != 0 || Ho < 1 ||
      Wo < 1 || Cout < 1 || Cout > rrnet_dcn_bwd_max_cout()) {
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

  const int smem_d = data_smem(Cout);
  err = cudaFuncSetAttribute(dcn_bwd_data_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_d);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_d((P + kDP - 1) / kDP, G, B);
  dcn_bwd_data_kernel<<<grid_d, kDThreads, smem_d, s>>>(x, wtb, off, mask, ct,
                                                       gx, goff, gmask, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dcn_bwd_weight_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dcn_bwd_weight_kernel, kWThreads, kWSmem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)kk * G * ((Cin / G + kWM - 1) / kWM) *
                          ((Cout + kWN - 1) / kWN) * B * ((P + kWK - 1) / kWK);
  long long blocks = (long long)(per_sm < 1 ? 1 : per_sm) * dcn_sm_count();
  if (blocks > units) blocks = units;
  dcn_bwd_weight_kernel<<<(unsigned)blocks, kWThreads, kWSmem, s>>>(x, off, mask,
                                                                  ct, gw, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
