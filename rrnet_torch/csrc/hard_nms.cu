// Greedy hard NMS for Hopper (sm_90a): a bitmask pass over the box pairs
// and a scan per image, with no host round trip.
//
// Not the port of a TPU kernel: the JAX package runs hard NMS as an XLA
// fixpoint (rrnet_tpu/ops/nms.py::hard_nms, :46; the lax.while_loop at
// :89-104), iterating
//     keep <- valid & ~any(kept higher-ranked box overlaps it)
// to convergence. The greedy keep set is that loop's unique fixpoint, and
// this kernel computes it directly instead of iterating. Its plain
// version, ops/nms.py::hard_nms, iterates the fixpoint with one (K, K)
// product per iteration and a host check of convergence.
//
// The wrapper (ops/hard_nms.py) sorts each image's boxes by score,
// descending, the lower index first among ties and invalid boxes last, and
// passes that `order`; both kernels read the boxes through it, so rank r
// below is the r-th box in score order.
//
// 1. hard_nms_mask_kernel: one 64-thread block per (image, 64-row block,
//    64-column block) on or above the diagonal; thread t builds the word of
//    row i = 64*row_block + t: bit j is set when j > i (both in rank
//    order), row i is valid, the two share a class (when class ids are
//    given) and IoU > threshold. The IoU is ops/box.py::pairwise_iou's,
//    op by op: iw/ih = min - max + off, clamped at 0, inter = iw*ih, union
//    = (area_i + area_j) - inter clamped at 1e-8, IEEE division (built with
//    -fmad=false and no fast math, so the bits agree with the plain
//    version's). A pair of other classes has IoU 0, as the plain version's
//    where(). Words below the diagonal are never written nor read.
// 2. hard_nms_scan_kernel: one 256-thread block per image walks the rows in
//    rank order, a 64-row block at a time. The rows of the next block (the
//    words on and above the diagonal) are copied into shared memory by
//    `cp.async` while the current block is resolved. Warp 0 resolves a
//    block: its keep bits are the fixpoint of
//        keep = candidates & ~OR(diagonal words of the kept rows)
//    (candidates: valid and not removed by earlier blocks), reached by a
//    few rounds of two warp OR-reductions (one round more than the
//    longest suppression chain inside the block). Then all eight warps OR
//    the kept rows' later words into the `removed` words in shared memory.
//    A lone warp doing the copies and the ORs as well took ~10 us a block
//    on an H100 (its instructions are one dependent chain); spread over
//    eight warps, a block is three barriers and a few instructions a
//    thread. The keep bits are scattered to the input order at the end.
//
// What bounds it on the card: the work is K^2/2 pair tests per image
// (~18 f32 operations each), microseconds of arithmetic at K = 1500; the
// scan is a chain of ceil(K/64) dependent blocks. The mask is ceil(K/64)
// 64-bit words a row and a validity word a block (1.15 MB at B = 4,
// K = 1500), scratch allocated by the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 4096;          // ceil(K/64) <= 64 words
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

__device__ __forceinline__ float area_of(float4 b, float off) {
  return (b.z - b.x + off) * (b.w - b.y + off);
}

// torch's clamp(min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__global__ void __launch_bounds__(64)
hard_nms_mask_kernel(const float4* __restrict__ boxes,        // (B, K)
                     const long long* __restrict__ order,     // (B, K)
                     const unsigned char* __restrict__ valid, // (B, K) or null
                     const int* __restrict__ cls,             // (B, K) or null
                     u64* __restrict__ mask,                  // (B, K, W)
                     unsigned* __restrict__ vmask,            // (B, W, 2)
                     int K, int W, float thr, float off) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  if (cb < rb) return;
  const int t = threadIdx.x;
  const size_t base = (size_t)b * K;
  const long long* ord = order + base;

  __shared__ float4 cbox[64];
  __shared__ float carea[64];
  __shared__ int ccls[64];
  const int j0 = cb * 64;
  if (j0 + t < K) {
    const long long o = ord[j0 + t];
    const float4 c = boxes[base + o];
    cbox[t] = c;
    carea[t] = area_of(c, off);
    ccls[t] = cls ? cls[base + o] : 0;
  }
  __syncthreads();

  const int i = rb * 64 + t;
  const long long oi = i < K ? ord[i] : 0;
  const bool vi = i < K && (valid == nullptr || valid[base + oi] != 0);
  if (cb == rb) {    // the block's validity word, a 32-bit half a warp
    const unsigned half = __ballot_sync(kFull, vi);
    if ((t & 31) == 0) vmask[((size_t)b * W + rb) * 2 + (t >> 5)] = half;
  }
  if (i >= K) return;
  u64 bits = 0;
  if (vi) {
    const float4 a = boxes[base + oi];
    const float aa = area_of(a, off);
    const int ci = cls ? cls[base + oi] : 0;
    const int n = min(64, K - j0);
    for (int jj = cb == rb ? t + 1 : 0; jj < n; ++jj) {
      const float4 c = cbox[jj];
      const float iw = clamp_min(fminf(a.z, c.z) - fmaxf(a.x, c.x) + off,
                                 0.0f);
      const float ih = clamp_min(fminf(a.w, c.w) - fmaxf(a.y, c.y) + off,
                                 0.0f);
      const float inter = iw * ih;
      float iou = inter / clamp_min((aa + carea[jj]) - inter, 1e-8f);
      if (ci != ccls[jj]) iou = 0.0f;
      if (iou > thr) bits |= 1ull << jj;
    }
  }
  mask[(base + i) * W + cb] = bits;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows 64w .. 64w+63 of an image's mask, words w .. W-1, into `rows`
// (64 x W words), as one cp.async group: warp g copies rows g, g + 8, ...
__device__ __forceinline__ void stage_block(const u64* m, u64* rows, int w,
                                            int K, int W, int warp,
                                            int lane) {
  const int r0 = w * 64;
  const int n = min(64, K - r0);
  for (int t = warp; t < n; t += kScanWarps) {
    const u64* src = m + (size_t)(r0 + t) * W;
    for (int c = w + lane; c < W; c += 32) {
      cp_async8(rows + t * W + c, src + c);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kScanThreads)
hard_nms_scan_kernel(const u64* __restrict__ mask,              // (B, K, W)
                     const unsigned* __restrict__ vmask,        // (B, W, 2)
                     const long long* __restrict__ order,       // (B, K)
                     unsigned char* __restrict__ keep,          // (B, K)
                     int K, int W) {
  extern __shared__ u64 buf[];     // 2 x 64 x W mask words
  __shared__ u64 valid_words[kMaxK / 64];
  __shared__ u64 removed[kMaxK / 64];
  __shared__ u64 kept[kMaxK / 64];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)b * K;
  const u64* m = mask + base * W;

  stage_block(m, buf, 0, K, W, warp, lane);
  const unsigned* vm = vmask + (size_t)b * W * 2;
  for (int c = tid; c < W; c += kScanThreads) {
    valid_words[c] = (u64)vm[2 * c] | ((u64)vm[2 * c + 1] << 32);
    removed[c] = 0;
  }
  for (int w = 0; w < W; ++w) {
    const u64* rows = buf + (w & 1) * 64 * W;
    if (w + 1 < W) {
      stage_block(m, buf + ((w + 1) & 1) * 64 * W, w + 1, K, W, warp, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this block's rows, and `removed` up to this block
    if (warp == 0) {
      const u64 cand = valid_words[w] & ~removed[w];
      // the diagonal words of the candidate rows lane and lane + 32
      const u64 da = (cand >> lane) & 1ull ? rows[lane * W + w] : 0;
      const u64 db = (cand >> (lane + 32)) & 1ull ? rows[(lane + 32) * W + w]
                                                  : 0;
      u64 kb = cand;
      while (true) {
        const u64 sup = ((kb >> lane) & 1ull ? da : 0) |
                        ((kb >> (lane + 32)) & 1ull ? db : 0);
        const unsigned lo = __reduce_or_sync(kFull, (unsigned)sup);
        const unsigned hi = __reduce_or_sync(kFull, (unsigned)(sup >> 32));
        const u64 next = cand & ~(((u64)hi << 32) | lo);
        if (next == kb) break;
        kb = next;
      }
      if (lane == 0) kept[w] = kb;
    }
    __syncthreads();
    // every kept row of the block suppresses in the later words: warp g
    // ORs rows g, g + 8, ... of them
    const u64 kb = kept[w];
    for (int c = w + 1 + lane; c < W; c += 32) {
      u64 acc = 0;
      for (int t = warp; t < 64; t += kScanWarps) {
        if ((kb >> t) & 1ull) acc |= rows[t * W + c];
      }
      if (acc != 0) atomicOr(&removed[c], acc);
    }
    __syncthreads();   // done with `rows` before it is staged again
  }
  for (int i = tid; i < K; i += kScanThreads) {
    keep[base + order[base + i]] =
        (unsigned char)((kept[i >> 6] >> (i & 63)) & 1ull);
  }
}

}  // namespace

extern "C" {

// Largest K one launch takes.
int rrnet_hard_nms_max_k() { return kMaxK; }

// Launches the mask and the scan kernels on `stream`; returns the first
// CUDA error of the launches (0 = launched). boxes (B, K, 4) f32 in input
// order, order (B, K) int64 (the score order), valid (B, K) bool or null,
// cls (B, K) int32 or null (class-agnostic), scratch B * (K + 1) *
// ceil(K/64) 64-bit words (the mask, then the validity words), keep
// (B, K) bool out, in input order.
int rrnet_hard_nms(const float* boxes, const long long* order,
                   const unsigned char* valid, const int* cls, u64* scratch,
                   unsigned char* keep, int B, int K, float iou_thr,
                   int plus_one, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > kMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  const int W = (K + 63) / 64;
  u64* mask = scratch;
  unsigned* vmask = reinterpret_cast<unsigned*>(scratch + (size_t)B * K * W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hard_nms_mask_kernel<<<dim3(W, W, B), 64, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), order, valid, cls, mask, vmask,
      K, W, iou_thr, plus_one ? 1.0f : 0.0f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = 2 * 64 * W * (int)sizeof(u64);
  err = cudaFuncSetAttribute(hard_nms_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  hard_nms_scan_kernel<<<B, kScanThreads, smem, s>>>(mask, vmask, order, keep,
                                                     K, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
