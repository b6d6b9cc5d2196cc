// Serial Bodla soft-NMS, one thread block per image, for Hopper (sm_90a).
//
// Replaces the TPU kernel rrnet_tpu/ops/pallas_nms.py::_make_kernel
// (driven by soft_nms_pallas, pallas_nms.py:161; vmapped over images).
// It computes exactly what that kernel computes, with the same f32
// arithmetic, one operation at a time:
//   area = (x2-x1+1)*(y2-y1+1)
//   ov   = inter / max(barea+area-inter, 1e-12), 0 unless iw>0 && ih>0
//          (and, per class, unless the classes are equal)
//   w    = gaussian expf(-ov*ov/sigma) | linear ov>thr ? 1-ov : 1
//          | hard ov>thr ? 0 : 1
// Each step picks the FIRST index holding the max among active,
// unselected ("open") slots, marks it selected with rank = step, decays
// every other open slot, and deactivates a slot only where it overlaps
// the pick and its decayed score fell below score_threshold.
// Build with -fmad=false and without fast math, so that no multiply-add
// is contracted and expf is the accurate one: the results then round
// like the op-by-op PyTorch version (ops/nms.py::soft_nms) and keep/rank
// compare exactly.
//
// What bounds it on the card: neither bytes nor arithmetic. An image's
// whole state is ~42 KB (K=1500); each step tests every open slot for
// overlap with the pick (~11 operations) and decays only the slots that
// overlap (~12 more). What costs is the chain of up to max_out=512
// DEPENDENT steps (310-444 selections an image at K=1500), each a
// block-wide argmax and a decay, issued by every warp of the block. The
// design shortens each step:
//  * the block is sized to K: one warp per 64 boxes (two slots a lane)
//    up to kMaxWarps = 24, more slots a lane beyond (K <= 4096). At
//    K=1500 a cap of 24 warps beat 16 and 8 (chip_smoke.py builds the
//    kernel with RRNET_SOFT_NMS_MAX_WARPS set to each and times them);
//  * each thread keeps its slots' boxes, areas, classes and scores in
//    registers (the loops over them unroll) and their open and selected
//    flags as bit masks; the boxes are also in shared memory, where a
//    step reads the picked box back (never from global memory);
//  * index i lives in slot i / nt of thread (i % nt % nw) * 32 + i % nt
//    / nw: consecutive indices go to different warps, so the best few
//    candidates (decoded top-k candidates arrive sorted by score) are
//    spread over the warps;
//  * the argmax is one packed reduction: an order-preserving u32 of the
//    f32 score (-0 read as +0), maximised by `redux.sync`, then the lowest
//    index among the lanes that hold it, minimised the same way; one named
//    barrier a step joins the warps, whose partials are double-buffered
//    in shared memory;
//  * the decay first tests the overlap (iw > 0 && ih > 0, and the class
//    when gated) of each open slot; the division, expf and threshold run
//    only for slots that overlap the pick. For the others ov = 0, so the
//    weight is exactly 1 and nothing deactivates: skipping them is
//    bit-exact whenever a zero overlap weighs exactly 1 (gaussian with
//    sigma > 0, linear, hard with a threshold >= 0); otherwise (`skip` =
//    0) every open slot takes the full arithmetic.
// Exact multi-pick rounds (several non-overlapping picks a barrier) were
// measured bit-equal but no faster on an H100 (a round cost ~3.9 steps:
// the warps' reductions and every open slot's test are paid per pick),
// and were not kept; see PERF.md.
// The TPU kernel's (8, K/8) tiling, its K-to-1024 padding and its
// fixed-trip chunking (Mosaic could not compile a while loop) are TPU
// layout and are not carried over.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#ifndef RRNET_SOFT_NMS_MAX_WARPS
#define RRNET_SOFT_NMS_MAX_WARPS 24   // chosen by measurement at K=1500
#endif

namespace {

constexpr int kMaxWarps = RRNET_SOFT_NMS_MAX_WARPS;  // the block's largest
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxSlots = 6;               // K=4096 on 24 warps
constexpr int kBoxesPerWarp = 64;          // one more warp per 64 boxes
constexpr int kMaxK = 4096;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxWarps >= 1 && kMaxWarps <= 32, "1..32 warps a block");

// An unsigned key that orders as the f32 score does (-0 read as +0).
__device__ __forceinline__ unsigned score_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

struct Params {
  int K, steps, method;
  float sigma, iou_threshold, score_threshold;
  int skip, nw;
};

__device__ __forceinline__ float box_area(const float4& b) {
  return (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
}

// One image on the block's nw warps. Thread (warp, lane) owns the indices
// pos + j * nt, pos = lane * nw + warp, j < SLOTS.
template <int SLOTS>
__global__ void __launch_bounds__(kMaxThreads)
soft_nms_kernel(const float* __restrict__ boxes,          // (B, K, 4)
                const float* __restrict__ scores,         // (B, K)
                const unsigned char* __restrict__ valid,  // (B, K) or null
                const int* __restrict__ cls,              // (B, K) or null
                float* __restrict__ out_scores,           // (B, K)
                unsigned char* __restrict__ keep,         // (B, K)
                int* __restrict__ rank,                   // (B, K)
                Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);         // K boxes
  int* scls = reinterpret_cast<int*>(sbox + a.K);         // K, when gated
  __shared__ unsigned part_key[2][kMaxWarps];
  __shared__ unsigned part_idx[2][kMaxWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = a.nw * 32;
  const int pos = lane * a.nw + warp;
  const int K = a.K;
  const size_t base = (size_t)blockIdx.x * K;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + base;
  const bool gated = cls != nullptr;

  float x1[SLOTS], y1[SLOTS], x2[SLOTS], y2[SLOTS], area[SLOTS], cur[SLOTS];
  int c[SLOTS];
  unsigned open = 0u, sel = 0u;   // bit j: index pos + j * nt
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = pos + j * nt;
    x1[j] = y1[j] = x2[j] = y2[j] = area[j] = 0.0f;
    cur[j] = kNeg;
    c[j] = 0;
    if (i < K) {
      const float4 v = bx[i];
      sbox[i] = v;
      x1[j] = v.x;
      y1[j] = v.y;
      x2[j] = v.z;
      y2[j] = v.w;
      area[j] = box_area(v);
      if (gated) {
        c[j] = cls[base + i];
        scls[i] = c[j];
      }
      if (valid == nullptr || valid[base + i] != 0) {
        cur[j] = scores[base + i];
        open |= 1u << j;
      }
      rank[base + i] = K;
    }
  }
  __syncthreads();

  const unsigned neg_key = score_key(kNeg);  // only scores above count
  int parity = 0;
  for (int step = 0; step < a.steps; ++step) {
    // the warp's best open slot: max key, then the lowest index
    unsigned key = neg_key, idx = UINT_MAX;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const unsigned k = score_key(cur[j]);
      // indices rise with j, so a strict > keeps the first of equals
      if (((open >> j) & 1u) && k > key) {
        key = k;
        idx = pos + j * nt;
      }
    }
    unsigned best = __reduce_max_sync(kFull, key);
    unsigned pick = __reduce_min_sync(kFull, key == best ? idx : UINT_MAX);

    // the block's best over the warps' partials (one barrier a step)
    if (a.nw > 1) {
      if (lane == 0) {
        part_key[parity][warp] = best;
        part_idx[parity][warp] = pick;
      }
      named_barrier(1, nt);
      const bool in = lane < a.nw;
      key = in ? part_key[parity][lane] : neg_key;
      idx = in ? part_idx[parity][lane] : UINT_MAX;
      best = __reduce_max_sync(kFull, key);
      pick = __reduce_min_sync(kFull, key == best ? idx : UINT_MAX);
      parity ^= 1;
    }
    if (best == neg_key) break;      // nothing open above -1e30

#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (pick == (unsigned)(pos + j * nt)) {
        open &= ~(1u << j);
        sel |= 1u << j;
        rank[base + pick] = step;
      }
    }

    // the decay of the pick, on every open slot that overlaps it
    const float4 p = sbox[pick];
    const int pc = gated ? scls[pick] : 0;
    const float parea = box_area(p);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (!((open >> j) & 1u)) continue;
      const float iw = fminf(p.z, x2[j]) - fmaxf(p.x, x1[j]) + 1.0f;
      const float ih = fminf(p.w, y2[j]) - fmaxf(p.y, y1[j]) + 1.0f;
      bool pos_ov = iw > 0.0f && ih > 0.0f;
      if (gated && c[j] != pc) pos_ov = false;
      if (!pos_ov && a.skip) continue;   // weight exactly 1, stays open
      const float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
      float ov = inter / fmaxf(parea + area[j] - inter, 1e-12f);
      if (!pos_ov) ov = 0.0f;
      float w;
      if (a.method == 2) {
        w = expf(-(ov * ov) / a.sigma);
      } else if (a.method == 1) {
        w = ov > a.iou_threshold ? 1.0f - ov : 1.0f;
      } else {
        w = ov > a.iou_threshold ? 0.0f : 1.0f;
      }
      cur[j] = cur[j] * w;
      if (pos_ov && cur[j] < a.score_threshold) open &= ~(1u << j);
    }
  }

#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = pos + j * nt;
    if (i < K) {
      out_scores[base + i] = cur[j];
      keep[base + i] = (sel >> j) & 1u;
    }
  }
}

template <int SLOTS>
int launch(const float* boxes, const float* scores, const unsigned char* valid,
           const int* cls, float* out_scores, unsigned char* keep, int* rank,
           int B, const Params& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.K * (sizeof(float4) + (cls ? sizeof(int) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        soft_nms_kernel<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  soft_nms_kernel<SLOTS><<<B, a.nw * 32, smem, stream>>>(
      boxes, scores, valid, cls, out_scores, keep, rank, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest K one launch takes.
int rrnet_soft_nms_max_k() { return kMaxK; }

// Returns cudaGetLastError() after the launch (0 = launched). `valid`
// may be null (all valid); `cls` may be null (class-agnostic).
int rrnet_soft_nms(const float* boxes, const float* scores,
                   const unsigned char* valid, const int* cls,
                   float* out_scores, unsigned char* keep, int* rank, int B,
                   int K, int steps, int method, float sigma, float iou_thr,
                   float score_thr, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  Params a;
  a.K = K;
  a.steps = steps;
  a.method = method;
  a.sigma = sigma;
  a.iou_threshold = iou_thr;
  a.score_threshold = score_thr;
  // a zero overlap gives weight exactly 1 (and no deactivation) for these
  // settings: the decay may skip slots that do not overlap the pick
  a.skip = method == 2 ? sigma > 0.0f : method == 1 ? 1 : !(0.0f > iou_thr);
  a.nw = (K + kBoxesPerWarp - 1) / kBoxesPerWarp;
  if (a.nw > kMaxWarps) a.nw = kMaxWarps;
  const int slots = (K + a.nw * 32 - 1) / (a.nw * 32);
  if (slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots <= 2) {
    return launch<2>(boxes, scores, valid, cls, out_scores, keep, rank, B, a,
                     s);
  }
  if (slots <= 4) {
    return launch<4>(boxes, scores, valid, cls, out_scores, keep, rank, B, a,
                     s);
  }
  return launch<6>(boxes, scores, valid, cls, out_scores, keep, rank, B, a,
                   s);
}

}  // extern "C"
