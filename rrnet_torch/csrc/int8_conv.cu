// int8 post-training-quantized convolution for Hopper (sm_90a): a
// quantize-and-pack pass over the activation and an implicit-GEMM
// convolution on the int8 tensor cores through `wgmma`.
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
// 2. int8_conv_wgmma_kernel: out (N, cout, Ho, Wo) = dequant(xq (*) wq)
//    as an implicit GEMM, M = N*Ho*Wo output pixels, N = cout, K =
//    kh*kw*Cp in (ky, kx, c) order, so that a pixel's channels of a tap
//    are contiguous in the NHWC map. The weights come packed once by the
//    wrapper: (cout, Kp) int8, Kp = K rounded up to 64, zero tail. Both
//    operands are K-major, the only order that 8-bit `wgmma` takes.
//
//    What bounds it on this card: 2 * M * cout * kh*kw*cin operations
//    over the int8 tensor cores' 1,979e12 a second (dense); for the deep
//    6x11 to 24x44 maps at 384-512 channels and stage 2's ROI convs, the
//    bytes of the int8 input, the weights and the output over 3.35e12
//    B/s. The hourglass's 192x352 3x3 convs at 256 channels are ~80 G
//    operations a call: ~0.04 ms at the peak. The first design
//    (mma.sync.m16n8k32 fed by 32-bit shared loads, a 64-byte K step and
//    one __syncthreads per two k32 rounds, every thread computing im2col
//    addresses and issuing cp.async beside its math) stopped at 16-19% of
//    that peak; ldmatrix, 64x64 warp tiles and deeper rings did not move
//    it. `wgmma` is the only way to the full tensor-core rate.
//
//    The design. A persistent grid, one 384-thread block an SM, walks the
//    work units (an output tile of 128 pixels x 128 channels, or a K share
//    of one: see split-K below) in a static round robin. Each block is
//    warp-specialised:
//    * two consumer warpgroups (threads 0-255, `setmaxnreg` raised to
//      208) each own 64 pixel rows of the tile and run
//      wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8, four a 128-byte
//      K step, with both operands read from shared memory through
//      128-byte-swizzle descriptors (the k32 slices advance the start
//      address by 32 bytes inside the swizzle atom); one wgmma group stays
//      in flight while the previous step's stage is released;
//    * one producer warpgroup (threads 256-383, `setmaxnreg` lowered to
//      80) fills a ring of 4 stages (A 16 KB + B 16 KB each), guarded by
//      full/empty `mbarrier` pairs. B, the weight rows, comes by TMA: a
//      2-D tiled tensor map over (cout, Kp) with 128-byte swizzle, a
//      128 x 128-byte box a step, issued by one thread; rows past cout and
//      bytes past Kp arrive as zeros. A, the activation, is gathered by
//      the warpgroup's 128 threads with 16-byte cp.async (.ca: a pixel is
//      read again at each tap of a kernel row) into the same swizzled
//      layout by hand (16-byte chunk j of row r at r*128 + ((j ^ r%8) *
//      16)), eight threads a pixel row so that a warp reads four 128-byte
//      runs. A thread keeps its eight rows' offsets and window corners in
//      registers for the unit and steps its chunk's tap and channel
//      without a division, so a step costs it eight bounds tests, eight
//      adds and eight copies; a chunk finds its own tap, so a step may span
//      taps and any Cp that is a multiple of 16 works; padding, rows past
//      M and bytes past K are zero-filled. Each thread's copies arrive on
//      the stage's full barrier when they land
//      (cp.async.mbarrier.arrive.noinc), beside the TMA's transaction
//      count, so the producer runs as far ahead as the ring allows; a
//      consumer fences the async proxy (fence.proxy.async.shared::cta)
//      after its wait, before wgmma reads what the generic-proxy copies
//      wrote.
//    What bounds it (measured on an H100, PERF.md): ~48% of the int8 peak
//    at the large maps. Per-thread lagged waits on the copies (each
//    producer thread waiting for its own copies before arriving) made
//    producer and consumers take turns, one stage at a time (26% of the
//    peak, the same with no copies at all); arrivals on landing lifted it
//    to 31%; the producer's rows in registers instead of reread from shared
//    memory each step (56 -> 80 registers) to 48%. A second producer
//    warpgroup, a fifth stage, .cg copies and the scales loaded before the
//    products each moved it by under 4%. With the epilogue replaced by a
//    read of the accumulators the kernel takes 88% of its time (55% of the
//    peak: the products and the ring's hand-offs); the epilogue, which the
//    consumers run between their tiles' products, takes the rest at the
//    large maps and ~77% at the 3x3 ROI maps, whose NCHW rows are 9 pixels
//    long. Unverified without a profiler of the SM.
//
//    The A route. TMA's im2col mode was the first choice. Its load brings
//    one tap's channel run of every pixel of the box, at most 128 bytes a
//    pixel under the 128-byte swizzle, so a 128-byte K step is one load
//    only where Cp is a multiple of 128. The `rrnet` preset's own stage-2
//    ROI head has a 3x3 conv at 64 channels (conv2), ResNet-50's first
//    stage has 64, and the tests' shapes 16-48: there a step spans two to
//    eight taps, each a load of a 64- to 16-byte run that the 128-byte
//    swizzle of the box cannot place beside the others, and would need a
//    second layout (a 64-byte step, or narrower). The gather by cp.async
//    covers every Cp that is a multiple of 16, the per-side padding and
//    the strides with one code path and one layout, so A takes it; B
//    stays on TMA.
//
//    Split-K. Where the output tiles alone leave most of the 132 SMs
//    idle (the deep maps and stage 2's ROI convs, whose K is 9 x 384-512
//    long) the wrapper splits K (`conv_schedule` in ops/int8_conv.py):
//    each unit adds its partial int32 sums into a zeroed int32 map with
//    atomicAdd (integer sums are exact in any order, so the result stays
//    bit-equal) and dequant_kernel writes the output from it.
//
//    Epilogue. The int32 accumulators are exact; the dequantize is the
//    JAX order op by op: f32(acc) (round to nearest) times the
//    per-channel f32 scale s_w * f32(s_in) (__fmul_rn), cast to the
//    output type (__float2bfloat16_rn, or f32), then + bias in that type.
//    A third output mode stores the raw int32 accumulators (the check).
//    The fragments hold pixels in rows and the output is NCHW, so the
//    consumers stage the dequantized tile through shared memory as
//    [channel][pixel], 256 bytes a pixel at a time (one pass for bf16,
//    two for f32 and int32), and store it along the pixels: in 16-byte
//    runs where Ho*Wo is a multiple of the run, so that no run crosses an
//    image; else a lane a pixel (the 6x11 maps, the 3x3 ROI maps). The
//    producer meanwhile loads the next unit's steps. Padding is per side (top, bottom, left, right), so
//    JAX's explicit paddings and its SAME padding (asymmetric at stride 2)
//    map exactly.

#include <cuda.h>             // CUtensorMap and its encoder's types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;              // output pixels a tile
constexpr int kBN = 128;              // output channels a tile
constexpr int kBK = 128;              // K bytes a pipeline step
constexpr int kKAlign = 64;           // the packed weight rows' multiple
constexpr int kStages = 4;
constexpr int kProducers = 128;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + kProducers;
// 80 * 128 + 208 * 256 <= 168 * 384, the registers a thread of the
// launch holds (__launch_bounds__(384, 1)): the producer keeps its eight
// rows' offsets in registers
constexpr int kProducerRegs = 80;
constexpr int kConsumerRegs = 208;
constexpr int kTileA = kBM * kBK;     // bytes
constexpr int kTileB = kBN * kBK;
constexpr int kStageBytes = kTileA + kTileB;
// the staged output: 256 bytes a pixel (64 f32 or int32 channels, 128
// bf16), [channel][pixel] with 16 bytes between channel rows
constexpr int kSmemOut = (256 / 2) * (kBM * 2 + 16);
constexpr int kSmemStages = kStages * kStageBytes;
constexpr int kSmemTable = 2 * kBM * 16;
constexpr int kSmemBars = 2 * kStages * 8;
// + 1024: the dynamic shared memory is aligned up to the swizzle atom
constexpr int kSmem = 1024 + kSmemStages + kSmemOut + kSmemTable + kSmemBars;

constexpr int kQP = 32;               // quantize: pixels a tile
constexpr int kQC = 64;               // quantize: channels a tile

struct ConvGeom {
  int N, H, W, Cp;          // input (N, H, W, Cp) int8
  int cout, kh, kw, sh, sw, pt, pl;
  int Ho, Wo;
  int K;                    // kh * kw * Cp
  int steps;                // K steps of kBK bytes: ceil(Kp / kBK)
  int split_steps;          // K steps a unit takes
  int splits;               // units a tile: ceil(steps / split_steps)
  int tiles_n;              // ceil(cout / kBN)
  int units;                // tiles * splits
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

// ---- Hopper primitives ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// a 2-D tile of the tensor map `map` at (x, y) into shared `dst`,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// 16 bytes from global `src` to shared `dst` through L1, or 16 zero bytes
// when `!full` (src is then not read)
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src,
                                              bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// an arrival on `bar` once every cp.async this thread issued before has
// landed (counted against the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// shared memory written through the generic proxy (the cp.async copies
// of A) ordered before this thread's reads through the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (8-row atoms of 1024 bytes: stride 1024; the leading offset is
// unused for this layout)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32 bytes) * B (128 x 32 bytes)^T, int8 in, int32 out;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the dequantize ---------------------------------------------------

// kOutAdd: a split-K unit adds its partial int32 sums (exact, in any
// order) into a zeroed int32 map; dequant_kernel then writes the output.
enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2, kOutAdd = 3 };

template <int OUT> struct OutT { using T = int; };
template <> struct OutT<kOutF32> { using T = float; };
template <> struct OutT<kOutBF16> { using T = __nv_bfloat16; };

// one accumulator in the output type: the JAX order, op by op
template <int OUT>
__device__ __forceinline__ typename OutT<OUT>::T dequant(int acc, float scale,
                                                         const void* bias,
                                                         int n) {
  if constexpr (OUT == kOutF32) {
    float y = __fmul_rn(__int2float_rn(acc), scale);
    if (bias != nullptr) y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
    return y;
  } else if constexpr (OUT == kOutBF16) {
    __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale));
    if (bias != nullptr) {
      const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
      y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
    }
    return y;
  } else {
    return acc;
  }
}

// ---- the convolution --------------------------------------------------

struct Unit {
  int tm, tn;               // the output tile
  int k_first, nk;          // its K steps
};

__device__ __forceinline__ Unit unit_of(int u, const ConvGeom& g) {
  const int split = u % g.splits;
  const int tile = u / g.splits;
  Unit w;
  w.tn = tile % g.tiles_n;
  w.tm = tile / g.tiles_n;
  w.k_first = split * g.split_steps;
  w.nk = min(g.steps - w.k_first, g.split_steps);
  return w;
}

// The consumers' epilogue of one unit: the accumulators of rows
// row0 (+8) and columns col0 + 8j (+1) of the tile.
template <int OUT>
__device__ __forceinline__ void epilogue(const int (&d)[64], uint8_t* staged,
                                         const Unit& w, int row0, int col0,
                                         int tid, const ConvGeom& g, int M,
                                         int HoWo, const float* scale,
                                         const void* bias, void* out) {
  const int m_base = w.tm * kBM;
  const int n_base = w.tn * kBN;
  if constexpr (OUT == kOutAdd) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + row0 + 8 * h;
      if (m >= M) continue;
      const int img = m / HoWo;
      int* o = static_cast<int*>(out) + (size_t)img * g.cout * HoWo +
               (m - img * HoWo);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_base + 8 * j + col0 + e;
          if (n < g.cout) atomicAdd(o + (size_t)n * HoWo, d[4 * j + 2 * h + e]);
        }
    }
  } else {
    using T = typename OutT<OUT>::T;
    constexpr int CH = 256 / sizeof(T);         // channels a pass
    constexpr int kRow = kBM * sizeof(T) + 16;  // bytes between them
    constexpr int E = 16 / sizeof(T);           // pixels a 16-byte run
    constexpr int kRuns = kBM / E;
    // with HoWo a multiple of E every run of E pixels from a multiple of
    // E lies in one image and is 16-byte aligned in the output
    const bool runs = HoWo % E == 0;
    T* o = static_cast<T*>(out);
#pragma unroll
    for (int c0 = 0; c0 < kBN; c0 += CH) {
      // every consumer has stored the staged values before these
      named_barrier(1, kConsumers);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (8 * j < c0 || 8 * j >= c0 + CH) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + col0 + e;
          const int n = n_base + col;
          const float sc = (OUT != kOutI32 && n < g.cout) ? scale[n] : 0.f;
          T* dst = reinterpret_cast<T*>(staged + (col - c0) * kRow);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            dst[row0 + 8 * h] = dequant<OUT>(d[4 * j + 2 * h + e], sc,
                                             n < g.cout ? bias : nullptr, n);
        }
      }
      named_barrier(1, kConsumers);
      if (runs) {
        // a thread keeps its run of E pixels, every 256 / kRuns-th channel
        const int ml = (tid % kRuns) * E;
        const int m0 = m_base + ml;
        const int img = m0 / HoWo;
        T* px = o + (size_t)img * g.cout * HoWo + (m0 - img * HoWo);
        for (int col = tid / kRuns; col < CH && m0 < M;
             col += kConsumers / kRuns) {
          const int n = n_base + c0 + col;
          if (n >= g.cout) break;
          *reinterpret_cast<int4*>(px + (size_t)n * HoWo) =
              *reinterpret_cast<const int4*>(staged + col * kRow +
                                             ml * sizeof(T));
        }
      } else if (m_base + (tid & (kBM - 1)) < M) {
        // a lane a pixel: a warp stores 32 neighbouring pixels of a
        // channel; a thread keeps its pixel, every other channel
        const int ml = tid & (kBM - 1);
        const int m = m_base + ml;
        const int img = m / HoWo;
        T* px = o + (size_t)img * g.cout * HoWo + (m - img * HoWo);
        for (int col = tid / kBM; col < CH; col += kConsumers / kBM) {
          const int n = n_base + c0 + col;
          if (n >= g.cout) break;
          px[(size_t)n * HoWo] = *reinterpret_cast<const T*>(
              staged + col * kRow + ml * sizeof(T));
        }
      }
    }
  }
}

template <int OUT>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_wgmma_kernel(const int8_t* __restrict__ xq,
                       const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ scale,
                       const void* __restrict__ bias, void* __restrict__ out,
                       const ConvGeom g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* stages = smem;                       // [stage] A | B
  uint8_t* staged = smem + kSmemStages;         // [channel][pixel] output
  int4* table = reinterpret_cast<int4*>(staged + kSmemOut);  // [2][kBM]
  uint64_t* full = reinterpret_cast<uint64_t*>(table + 2 * kBM);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int HoWo = g.Ho * g.Wo;
  const int M = g.N * HoWo;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducers + 1);      // + the TMA's expect_tx
      mbar_init(&empty[s], kConsumers / 32);    // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup --------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int chunk = pt & 7;           // this thread's 16 bytes of a row
    const int rsub = pt >> 3;           // its rows: rsub + 16 i
    const uint32_t stage0 = smem_addr(stages);
    int it = 0;                         // steps issued, over all units
    int local = 0;
    for (int u = blockIdx.x; u < g.units; u += gridDim.x, ++local) {
      const Unit w = unit_of(u, g);
      int4* tab = table + (local & 1) * kBM;
      {
        // row pt of the tile: its image's first pixel, its window's top
        // left corner; rows past M lie far outside every image
        const int m = w.tm * kBM + pt;
        int4 e = make_int4(0, -(1 << 29), -(1 << 29), 0);
        if (m < M) {
          const int img = m / HoWo;
          const int p = m - img * HoWo;
          const int oy = p / g.Wo;
          e = make_int4(img * g.H * g.W, oy * g.sh - g.pt,
                        (p - oy * g.Wo) * g.sw - g.pl, 0);
        }
        tab[pt] = e;
      }
      named_barrier(2, kProducers);
      // this thread's rows, held for the unit: the offset of the window's
      // top left corner in the map (outside it at the padding; never
      // read there) and its coordinates
      long long off[kBM / 16];
      int iy0[kBM / 16], ix0[kBM / 16];
#pragma unroll
      for (int i = 0; i < kBM / 16; ++i) {
        const int4 e = tab[rsub + 16 * i];
        iy0[i] = e.y;
        ix0[i] = e.z;
        off[i] = ((long long)e.x + (long long)e.y * g.W + e.z) * g.Cp;
      }
      // this thread's 16 bytes of K: tap (ky, kx), channel c; stepped
      // without a division
      int k0 = w.k_first * kBK + 16 * chunk;
      int tap = k0 / g.Cp;
      int c = k0 - tap * g.Cp;
      int ky = tap / g.kw;
      int kx = tap - ky * g.kw;
      for (int kk = 0; kk < w.nk; ++kk, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        if (pt == 0) {
          mbar_expect_tx(&full[s], kTileB);
          tma_load_2d(stages + s * kStageBytes + kTileA, &wmap, &full[s],
                      (w.k_first + kk) * kBK, w.tn * kBN);
        }
        const bool k_ok = k0 < g.K;
        const long long tap_off = ((long long)ky * g.W + kx) * g.Cp + c;
        const uint32_t a = stage0 + s * kStageBytes;
#pragma unroll
        for (int i = 0; i < kBM / 16; ++i) {
          const int r = rsub + 16 * i;
          const bool ok = k_ok && (unsigned)(iy0[i] + ky) < (unsigned)g.H &&
                          (unsigned)(ix0[i] + kx) < (unsigned)g.W;
          cp_async16_ca(a + r * kBK + ((chunk ^ (r & 7)) << 4),
                        ok ? xq + off[i] + tap_off : xq, ok);
        }
        cp_async_arrive(&full[s]);
        k0 += kBK;
        for (c += kBK; c >= g.Cp; c -= g.Cp) {
          if (++kx == g.kw) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
    cp_async_wait_all();
  } else {
    // ---- consumer warpgroups -------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = tid >> 7;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const uint32_t stage0 = smem_addr(stages);
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    int it = 0;                         // steps consumed, over all units
    for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
      const Unit w = unit_of(u, g);
      for (int kk = 0; kk < w.nk; ++kk, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        fence_proxy_async();
        const uint32_t a = stage0 + s * kStageBytes + wg * (64 * kBK);
        const uint32_t b = stage0 + s * kStageBytes + kTileA;
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 32; ++k)
          wgmma_s8(d, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k),
                   (kk > 0 || k > 0) ? 1 : 0);
        wgmma_commit();
        fence_acc(d);
        if (kk > 0) {
          // the previous step's products are done: its stage is free
          wgmma_wait<1>();
          fence_acc(d);
          if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      epilogue<OUT>(d, staged, w, row0, col0, tid, g, M, HoWo, scale, bias,
                    out);
    }
  }
}

// The split-K epilogue: the summed int32 map (N, cout, HoWo) dequantized
// into the output, as the kernel's epilogue does it.
template <int OUT>
__global__ void __launch_bounds__(256)
dequant_kernel(const int* __restrict__ acc, const float* __restrict__ scale,
               const void* __restrict__ bias, void* __restrict__ out,
               int cout, int HoWo, size_t total) {
  using T = typename OutT<OUT>::T;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)((i / HoWo) % cout);
    static_cast<T*>(out)[i] = dequant<OUT>(acc[i], scale[n], bias, n);
  }
}

// cuTensorMapEncodeTiled, a driver entry point reached through the
// runtime (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int OUT>
cudaError_t launch_conv(const int8_t* xq, const CUtensorMap& wmap,
                        const float* scale, const void* bias, void* out,
                        const ConvGeom& g, int grid, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_wgmma_kernel<OUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int8_conv_wgmma_kernel<OUT><<<grid, kThreads, kSmem, stream>>>(
      xq, wmap, scale, bias, out, g);
  return cudaGetLastError();
}

// A split-K launch: the partial sums into the zeroed int32 `acc` (the
// output itself for the int32 mode), then the epilogue.
template <int OUT>
cudaError_t launch_split(const int8_t* xq, const CUtensorMap& wmap,
                         const float* scale, const void* bias, void* out,
                         int* acc, const ConvGeom& g, int grid,
                         cudaStream_t stream) {
  cudaError_t err = launch_conv<kOutAdd>(xq, wmap, nullptr, nullptr,
                                         OUT == kOutI32 ? out : acc, g, grid,
                                         stream);
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
// weight rows; and the tile the wrapper's schedule counts in.
int rrnet_int8_channel_align() { return 16; }
int rrnet_int8_k_align() { return kKAlign; }
int rrnet_int8_tile_m() { return kBM; }
int rrnet_int8_tile_n() { return kBN; }
int rrnet_int8_step_k() { return kBK; }

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

// xq (N, H, W, Cp) int8, wq (cout, Kp) int8, scale (cout,) f32, bias
// (cout,) in the output type or null -> out (N, cout, Ho, Wo): out_kind 0
// f32, 1 bf16, 2 the int32 accumulators. The schedule (the wrapper's
// `conv_schedule`): `split_steps` K steps a unit, `grid` blocks. When
// split_steps < ceil(Kp / 128) the units add into `acc`, a zeroed int32
// (N, cout, Ho, Wo) map (for out_kind 2 the zeroed output itself, and acc
// null). Returns a cudaError_t, or 10000 + the driver's CUresult when the
// weight's tensor map cannot be encoded.
int rrnet_int8_conv(const void* xq, const void* wq, const void* scale,
                    const void* bias, void* out, void* acc, int out_kind,
                    int N, int H, int W, int Cp, int cout, int kh, int kw,
                    int sh, int sw, int pt, int pl, int Ho, int Wo, int Kp,
                    int split_steps, int grid, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || cout <= 0 ||
      kh <= 0 || kw <= 0 || Cp <= 0 || Cp % 16 != 0 || Kp % kKAlign != 0 ||
      (long long)kh * kw * Cp > Kp || sh <= 0 || sw <= 0 || pt < 0 ||
      pl < 0 || (long long)N * H * W >= (1LL << 31) ||
      (long long)N * Ho * Wo >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int steps = (Kp + kBK - 1) / kBK;
  if (split_steps < 1 || split_steps > steps) return (int)cudaErrorInvalidValue;
  const int splits = (steps + split_steps - 1) / split_steps;
  const long long tiles_m = ((long long)N * Ho * Wo + kBM - 1) / kBM;
  const int tiles_n = (cout + kBN - 1) / kBN;
  const long long units = tiles_m * tiles_n * splits;
  if (units >= (1LL << 31) || grid < 1 || grid > units)
    return (int)cudaErrorInvalidValue;
  ConvGeom g{N, H, W, Cp, cout, kh, kw, sh, sw, pt, pl, Ho, Wo, kh * kw * Cp,
             steps, split_steps, splits, tiles_n, (int)units};
  const bool split = splits > 1;
  if (split && out_kind != kOutI32 && acc == nullptr)
    return (int)cudaErrorInvalidValue;

  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBN};
  const cuuint32_t unit_strides[2] = {1, 1};
  const CUresult res = encode(
      &wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wq), dims,
      strides, box, unit_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* sc = static_cast<const float*>(scale);
  int* a32 = static_cast<int*>(acc);
  switch (out_kind) {
    case kOutF32:
      return (int)(split ? launch_split<kOutF32>(x8, wmap, sc, bias, out, a32, g, grid, s)
                         : launch_conv<kOutF32>(x8, wmap, sc, bias, out, g, grid, s));
    case kOutBF16:
      return (int)(split ? launch_split<kOutBF16>(x8, wmap, sc, bias, out, a32, g, grid, s)
                         : launch_conv<kOutBF16>(x8, wmap, sc, bias, out, g, grid, s));
    case kOutI32:
      return (int)(split ? launch_split<kOutI32>(x8, wmap, sc, bias, out, a32, g, grid, s)
                         : launch_conv<kOutI32>(x8, wmap, sc, bias, out, g, grid, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
