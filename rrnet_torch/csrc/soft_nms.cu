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
// unselected slots, marks it selected with rank = step, decays every
// other active unselected slot, and deactivates a slot only where it
// overlaps the pick and its decayed score fell below score_threshold.
// Build with -fmad=false and without fast math, so that no multiply-add
// is contracted and expf is the accurate one: the results then round
// like the op-by-op PyTorch version (ops/nms.py::soft_nms) and keep/rank
// compare exactly.
//
// What bounds it on the card: neither bytes nor arithmetic. An image's
// whole state is ~42 KB (K=1500) and each step does ~20 flops per slot;
// what costs is the chain of up to max_out=512 DEPENDENT steps, each a
// block-wide argmax (warp shuffles, then one pass across warps through
// shared memory) and two __syncthreads. The design keeps that chain as
// short as it can be: all per-slot state (box, area, class, score) sits
// in registers of the owning thread for the whole loop, the flags are
// bits, the picked box is read back through L1 by every thread instead
// of a third barrier, and the loop leaves as soon as no candidate is
// left (a block-uniform break). Images run in parallel, one block each.
// The TPU kernel's (8, K/8) tiling, its K-to-1024 padding and its
// fixed-trip chunking (Mosaic could not compile a while loop) are TPU
// layout and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 8;  // register slots per thread
constexpr float kNeg = -1e30f;

// (value, index) max with the lower index winning ties.
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
soft_nms_kernel(const float* __restrict__ boxes,          // (B, K, 4)
                const float* __restrict__ scores,         // (B, K)
                const unsigned char* __restrict__ valid,  // (B, K) or null
                const int* __restrict__ cls,              // (B, K) or null
                float* __restrict__ out_scores,           // (B, K)
                unsigned char* __restrict__ keep,         // (B, K)
                int* __restrict__ rank,                   // (B, K)
                int K, int steps, int method, float sigma,
                float iou_threshold, float score_threshold) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float best_v;
  __shared__ int best_i;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bx = boxes + (size_t)b * K * 4;
  const int* bc = cls ? cls + (size_t)b * K : nullptr;

  float x1[SLOTS], y1[SLOTS], x2[SLOTS], y2[SLOTS], area[SLOTS], cur[SLOTS];
  int c[SLOTS];
  unsigned active = 0u, selected = 0u;  // bit j: slot tid + j*kThreads

#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = tid + j * kThreads;
    x1[j] = y1[j] = x2[j] = y2[j] = 0.0f;
    area[j] = 0.0f;
    cur[j] = kNeg;
    c[j] = 0;
    if (i < K) {
      x1[j] = bx[i * 4 + 0];
      y1[j] = bx[i * 4 + 1];
      x2[j] = bx[i * 4 + 2];
      y2[j] = bx[i * 4 + 3];
      area[j] = (x2[j] - x1[j] + 1.0f) * (y2[j] - y1[j] + 1.0f);
      if (bc) c[j] = bc[i];
      const bool ok = valid == nullptr || valid[(size_t)b * K + i] != 0;
      if (ok) {
        cur[j] = scores[(size_t)b * K + i];
        active |= 1u << j;
      }
      rank[(size_t)b * K + i] = K;
    }
  }

  for (int step = 0; step < steps; ++step) {
    // 1. block-wide first argmax over active, unselected slots
    float v = kNeg;
    int vi = K;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const bool cand = ((active & ~selected) >> j) & 1u;
      // slots of one thread come in increasing index order, so a
      // strict > keeps the first of equal values
      if (cand && cur[j] > v) {
        v = cur[j];
        vi = tid + j * kThreads;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
      better(v, vi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = vi;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? red_v[lane] : kNeg;
      vi = lane < kWarps ? red_i[lane] : K;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
        better(v, vi, ov, oi);
      }
      if (lane == 0) {
        best_v = v;
        best_i = vi;
      }
    }
    __syncthreads();
    const float mv = best_v;
    const int m = best_i;
    // 2. nothing left: every thread reads the same value, so all leave
    if (!(mv > kNeg)) break;

    // 3. mark the pick
    if (m % kThreads == tid) {
      selected |= 1u << (m / kThreads);
      rank[(size_t)b * K + m] = step;
    }

    // 4.-5. decay the others; drop overlapping ones below the threshold
    const float bx1 = bx[m * 4 + 0];
    const float by1 = bx[m * 4 + 1];
    const float bx2 = bx[m * 4 + 2];
    const float by2 = bx[m * 4 + 3];
    const int bcls = bc ? bc[m] : 0;
    const float barea = (bx2 - bx1 + 1.0f) * (by2 - by1 + 1.0f);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (!(((active & ~selected) >> j) & 1u)) continue;
      const float iw = fminf(bx2, x2[j]) - fmaxf(bx1, x1[j]) + 1.0f;
      const float ih = fminf(by2, y2[j]) - fmaxf(by1, y1[j]) + 1.0f;
      bool pos = iw > 0.0f && ih > 0.0f;
      const float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
      float ov = inter / fmaxf(barea + area[j] - inter, 1e-12f);
      if (!pos) ov = 0.0f;
      if (bc && c[j] != bcls) {
        ov = 0.0f;
        pos = false;
      }
      float w;
      if (method == 2) {
        w = expf(-(ov * ov) / sigma);
      } else if (method == 1) {
        w = ov > iou_threshold ? 1.0f - ov : 1.0f;
      } else {
        w = ov > iou_threshold ? 0.0f : 1.0f;
      }
      cur[j] = cur[j] * w;
      if (pos && cur[j] < score_threshold) active &= ~(1u << j);
    }
  }

#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = tid + j * kThreads;
    if (i < K) {
      out_scores[(size_t)b * K + i] = cur[j];
      keep[(size_t)b * K + i] = (selected >> j) & 1u;
    }
  }
}

template <int SLOTS>
void launch(const float* boxes, const float* scores, const unsigned char* valid,
            const int* cls, float* out_scores, unsigned char* keep, int* rank,
            int B, int K, int steps, int method, float sigma, float iou_thr,
            float score_thr, cudaStream_t stream) {
  soft_nms_kernel<SLOTS><<<B, kThreads, 0, stream>>>(
      boxes, scores, valid, cls, out_scores, keep, rank, K, steps, method,
      sigma, iou_thr, score_thr);
}

}  // namespace

extern "C" {

// Largest K one launch takes.
int rrnet_soft_nms_max_k() { return kMaxSlots * kThreads; }

// Returns cudaGetLastError() after the launch (0 = launched). `valid`
// may be null (all valid); `cls` may be null (class-agnostic).
int rrnet_soft_nms(const float* boxes, const float* scores,
                   const unsigned char* valid, const int* cls,
                   float* out_scores, unsigned char* keep, int* rank, int B,
                   int K, int steps, int method, float sigma, float iou_thr,
                   float score_thr, void* stream) {
  if (B < 1 || K < 1 || K > kMaxSlots * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxSlots == 8, "one case below per slot count");
  switch ((K + kThreads - 1) / kThreads) {
#define RRNET_CASE(n)                                                       \
  case n:                                                                   \
    launch<n>(boxes, scores, valid, cls, out_scores, keep, rank, B, K,      \
              steps, method, sigma, iou_thr, score_thr, s);                 \
    break;
    RRNET_CASE(1) RRNET_CASE(2) RRNET_CASE(3) RRNET_CASE(4)
    RRNET_CASE(5) RRNET_CASE(6) RRNET_CASE(7) RRNET_CASE(8)
#undef RRNET_CASE
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
