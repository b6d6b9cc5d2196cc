// Class-parallel Bodla soft-NMS, one thread block per image, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rrnet_tpu/ops/pallas_nms.py::_make_rows_kernel
// (driven by soft_nms_pallas_classes, pallas_nms.py:333). It computes the
// function of soft_nms_pallas_classes, not its TPU layout: per-class
// soft-NMS where every class runs to exhaustion on its own, then the rank
// rebuilt in (-score, index) order among the selected boxes and cut to
// max_out. A pick decays only boxes of its own class, and the serial
// kernel (soft_nms.cu) multiplies the other classes by exactly 1.0, so the
// keep set, the kept scores and the kept ranks equal the serial per-class
// result bit for bit; the scores of boxes that are not kept carry every
// decay of their class (the serial kernel stops at max_out).
//
// Per class and step, as the plain version (ops/soft_nms.py::
// soft_nms_classes_reference) computes it, one operation at a time:
//   pick the open (active, unselected) box with the largest score, the
//   lowest index among equal scores; mark it selected;
//   area = (x2-x1+1)*(y2-y1+1)
//   ov   = inter / max(barea+area-inter, 1e-12), 0 unless iw>0 && ih>0
//   w    = gaussian expf(-ov*ov/sigma) | linear ov>thr ? 1-ov : 1
//          | hard ov>thr ? 0 : 1
//   decay every other open box of the class by w; deactivate it where it
//   overlaps the pick and its new score fell below score_threshold.
// Build with -fmad=false and without fast math: no multiply-add is
// contracted and expf is the accurate one, so the scores round as the
// op-by-op PyTorch version's do and compare bit for bit.
//
// What bounds it on the card: neither bytes nor arithmetic (an image's
// state is ~44 KB at K=1500; a step does ~22 operations per open box of
// its class). It is the chain of dependent steps. The serial kernel
// advances one global pick a step behind two block-wide barriers; here
// the block counting-sorts the image's boxes by class into compact
// segments in shared memory (no row padding to K, invalid boxes take no
// slot), and each warp walks its class's segment with its own loop: a
// step is a pass over the warp's slots and a five-level shuffle argmax,
// with no block barrier inside the loop and no chunking. Classes run side
// by side, so the chain is as long as the busiest class, not the sum of
// all classes. A segment of any length up to K is walked from shared
// memory (ceil(n/32) slots a lane). After one barrier the rank of each
// selected box is counted against the compacted list of selected boxes.
// The TPU form's (C_pad, K) row padding, its fixed 64-step chunks behind a
// pl.when flag (Mosaic hangs on scf.while) and its rank rebuild by sorts
// outside the kernel are TPU workarounds and are not carried over.
//
// Class ids of valid boxes outside [0, num_classes) (the plain version
// raises on them) take no segment here: the kernel treats those boxes as
// invalid (score -1e30, not kept, rank K).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 4096;
constexpr int kMaxClasses = 1024;
constexpr float kNeg = -1e30f;
constexpr unsigned char kActive = 1;
constexpr unsigned char kSelected = 2;

// Dynamic shared memory: six f32 arrays of K (x1, y1, x2, y2, area, cur),
// the original index of each segment slot (K int32), the class segment
// bounds (num_classes + 1 int32), and a flag byte per slot.
size_t smem_bytes(int K, int C) {
  return (size_t)K * (6 * sizeof(float) + sizeof(int)) +
         (size_t)(C + 1) * sizeof(int) + (size_t)K;
}

// (value, original index, slot) max with the lower index winning ties.
__device__ __forceinline__ void better(float& v, int& o, int& p, float ov,
                                       int oo, int op) {
  if (ov > v || (ov == v && oo < o)) {
    v = ov;
    o = oo;
    p = op;
  }
}

__global__ void __launch_bounds__(kThreads)
soft_nms_classes_kernel(const float* __restrict__ boxes,          // (B, K, 4)
                        const float* __restrict__ scores,         // (B, K)
                        const unsigned char* __restrict__ valid,  // (B, K) or null
                        const int* __restrict__ cls,              // (B, K)
                        float* __restrict__ out_scores,           // (B, K)
                        unsigned char* __restrict__ keep,         // (B, K)
                        int* __restrict__ rank,                   // (B, K)
                        int K, int C, int steps, int method, float sigma,
                        float iou_threshold, float score_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx1 = reinterpret_cast<float*>(smem);
  float* sy1 = sx1 + K;
  float* sx2 = sy1 + K;
  float* sy2 = sx2 + K;
  float* sarea = sy2 + K;
  float* scur = sarea + K;
  int* sorig = reinterpret_cast<int*>(scur + K);
  int* sbound = sorig + K;  // class c's segment is [sbound[c], sbound[c+1])
  unsigned char* sflag = reinterpret_cast<unsigned char*>(sbound + C + 1);
  __shared__ int n_sel;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)b * K;
  const float* bs = scores + (size_t)b * K;
  const unsigned char* bv = valid ? valid + (size_t)b * K : nullptr;
  const int* bc = cls + (size_t)b * K;
  float* os = out_scores + (size_t)b * K;
  unsigned char* okeep = keep + (size_t)b * K;
  int* orank = rank + (size_t)b * K;

  // 1. count each class's boxes; a box in no segment gets its result now
  for (int c = tid; c <= C; c += kThreads) sbound[c] = 0;
  if (tid == 0) n_sel = 0;
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) {
    const int c = bc[i];
    if ((bv == nullptr || bv[i] != 0) && c >= 0 && c < C) {
      atomicAdd(&sbound[c + 1], 1);
    } else {
      os[i] = kNeg;
      okeep[i] = 0;
      orank[i] = K;
    }
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 1; c <= C; ++c) sbound[c] += sbound[c - 1];
  }
  __syncthreads();

  // 2. compact segments, each in index order: warp w fills classes
  //    w, w + kWarps, ... by ballots over the image's boxes
  for (int c = warp; c < C; c += kWarps) {
    int at = sbound[c];
    for (int base = 0; base < K; base += 32) {
      const int i = base + lane;
      const bool mine =
          i < K && bc[i] == c && (bv == nullptr || bv[i] != 0);
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (mine) {
        const int p = at + __popc(ballot & ((1u << lane) - 1u));
        const float4 box = bx[i];
        sx1[p] = box.x;
        sy1[p] = box.y;
        sx2[p] = box.z;
        sy2[p] = box.w;
        sarea[p] = (box.z - box.x + 1.0f) * (box.w - box.y + 1.0f);
        scur[p] = bs[i];
        sorig[p] = i;
        sflag[p] = kActive;
      }
      at += __popc(ballot);
    }
  }
  __syncthreads();

  // 3. every class to exhaustion, one warp per class, no block barrier
  for (int c = warp; c < C; c += kWarps) {
    const int s = sbound[c];
    const int e = sbound[c + 1];
    while (true) {
      float v = kNeg;
      int vo = INT_MAX;
      int vp = -1;
      // slots of one lane come in increasing index order, so a strict >
      // keeps the first of equal scores
      for (int p = s + lane; p < e; p += 32) {
        if (sflag[p] == kActive && scur[p] > v) {
          v = scur[p];
          vo = sorig[p];
          vp = p;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oo = __shfl_xor_sync(0xffffffffu, vo, off);
        const int op = __shfl_xor_sync(0xffffffffu, vp, off);
        better(v, vo, vp, ov, oo, op);
      }
      // nothing left in this class: every lane holds the same value
      if (!(v > kNeg)) break;
      if (((vp - s) & 31) == lane) sflag[vp] = kActive | kSelected;

      const float bx1 = sx1[vp];
      const float by1 = sy1[vp];
      const float bx2 = sx2[vp];
      const float by2 = sy2[vp];
      const float barea = (bx2 - bx1 + 1.0f) * (by2 - by1 + 1.0f);
      for (int p = s + lane; p < e; p += 32) {
        if (sflag[p] != kActive) continue;
        const float iw = fminf(bx2, sx2[p]) - fmaxf(bx1, sx1[p]) + 1.0f;
        const float ih = fminf(by2, sy2[p]) - fmaxf(by1, sy1[p]) + 1.0f;
        const bool pos = iw > 0.0f && ih > 0.0f;
        const float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
        float ov = inter / fmaxf(barea + sarea[p] - inter, 1e-12f);
        if (!pos) ov = 0.0f;
        float w;
        if (method == 2) {
          w = expf(-(ov * ov) / sigma);
        } else if (method == 1) {
          w = ov > iou_threshold ? 1.0f - ov : 1.0f;
        } else {
          w = ov > iou_threshold ? 0.0f : 1.0f;
        }
        const float nc = scur[p] * w;
        scur[p] = nc;
        if (pos && nc < score_threshold) sflag[p] = 0;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 4. the selected boxes, compacted (the box arrays are free now)
  const int total = sbound[C];
  float* sel_v = sx1;
  int* sel_o = reinterpret_cast<int*>(sy1);
  for (int p = tid; p < total; p += kThreads) {
    const int i = sorig[p];
    os[i] = scur[p];
    if (sflag[p] & kSelected) {
      const int j = atomicAdd(&n_sel, 1);
      sel_v[j] = scur[p];
      sel_o[j] = i;
    } else {
      okeep[i] = 0;
      orank[i] = K;
    }
  }
  __syncthreads();

  // 5. rank = selected boxes before it in (-score, index) order; cut
  const int ns = n_sel;
  for (int j = tid; j < ns; j += kThreads) {
    const float v = sel_v[j];
    const int i = sel_o[j];
    int before = 0;
    for (int q = 0; q < ns; ++q) {
      const float w = sel_v[q];
      before += (w > v) || (w == v && sel_o[q] < i);
    }
    const bool kept = before < steps;
    okeep[i] = kept;
    orank[i] = kept ? before : K;
  }
}

}  // namespace

extern "C" {

// Largest K and number of classes one launch takes.
int rrnet_soft_nms_classes_max_k() { return kMaxK; }
int rrnet_soft_nms_classes_max_classes() { return kMaxClasses; }

// Returns the first CUDA error of the launch (0 = launched). `valid` may
// be null (all valid); `cls` is required.
int rrnet_soft_nms_classes(const float* boxes, const float* scores,
                           const unsigned char* valid, const int* cls,
                           float* out_scores, unsigned char* keep, int* rank,
                           int B, int K, int C, int steps, int method,
                           float sigma, float iou_thr, float score_thr,
                           void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || C < 1 || C > kMaxClasses ||
      cls == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(K, C);
  cudaError_t err = cudaFuncSetAttribute(
      soft_nms_classes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_nms_classes_kernel<<<B, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, valid, cls, out_scores, keep, rank, K, C, steps, method,
      sigma, iou_thr, score_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
