// Class-parallel Bodla soft-NMS for Hopper (sm_90a): one thread block per
// (image, class), spread over the SMs, then one block per image for the
// rank.
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
// What bounds it on the card: neither bytes nor arithmetic (an image is
// ~44 KB at K = 1500; a step does ~22 operations per open box of its
// class). It is the chain of dependent steps of the busiest class. The
// design shortens each step and spreads the classes over the SMs:
//  * one block per (image, class): B*C blocks (40 at B = 4 and 10
//    classes), each on an SM of its own, instead of one block per image
//    with the classes' warps sharing one SM. The block compacts its
//    class's boxes from the image's K ids by a block-wide ballot scan, in
//    index order, into shared memory;
//  * the block is sized to the segment: one warp per 64 boxes (two slots a
//    lane) up to 8 warps (8 slots a lane up to 2048 boxes, 16 beyond),
//    with one named barrier a step for the warps' argmax. A step of a lone
//    warp is a chain of dependent instructions (~1.3 us a step on an H100
//    with one warp for the ~150 boxes of a class at the stage-1 shape); a
//    barrier among three warps costs less than the slots a lane it saves;
//  * each thread keeps the boxes and scores of the slots it owns in
//    registers (the loops over them unroll) and their open flags as a bit
//    mask, so a step reads shared memory only for the picked box;
//  * the argmax is one packed reduction: an order-preserving u32 of the
//    f32 score (-0 read as +0), maximised by `redux.sync`, then the lowest
//    slot among the lanes that hold it, minimised the same way;
//  * the decay first tests the overlap (iw > 0 && ih > 0) of each open
//    slot; the division, expf and threshold run only for slots that
//    overlap the pick. For the others ov = 0, so the weight is exactly 1
//    and nothing deactivates: skipping them is bit-exact whenever a zero
//    overlap gives weight 1 (gaussian with sigma > 0, linear, hard with a
//    threshold >= 0); otherwise (`skip` = 0) every open slot takes the
//    full arithmetic;
//  * the rank (position among the image's selected boxes in (-score,
//    index) order, cut to `steps`) needs every class of the image: a
//    second kernel, one block per image launched behind the first in the
//    same call, compacts the selected boxes and sorts their packed
//    (score, index) keys by a bitonic sort in shared memory.
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

constexpr int kThreads = 256;              // per (image, class) block
constexpr int kWarps = kThreads / 32;
constexpr int kBoxesPerWarp = 64;          // one more warp per 64 boxes
constexpr int kRankThreads = 256;
constexpr int kMaxK = 4096;                // <= 16 slots a thread at 8 warps
constexpr int kMaxClasses = 1024;
constexpr int kChunks = kMaxK / kThreads;  // ballot rounds of the compaction
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of the class block: six f32 arrays of K (x1, y1,
// x2, y2, area, cur) and the original index of each segment slot.
size_t class_smem_bytes(int K) {
  return (size_t)K * (6 * sizeof(float) + sizeof(int));
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// An unsigned key that orders as the f32 score does (-0 read as +0).
__device__ __forceinline__ unsigned score_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

struct ClassArgs {
  const float* sx1;
  const float* sy1;
  const float* sx2;
  const float* sy2;
  const float* sarea;
  const float* scur;
  const int* sorig;
  float* out_scores;        // this image's row
  unsigned char* selected;  // this image's row
  int n, nw, method;
  float sigma, iou_threshold, score_threshold;
  int skip;
};

// One class to exhaustion on the block's first nw warps. Thread tid owns
// the segment slots tid + j * nw * 32, j < kSlots, and keeps their boxes
// and scores in registers (the loops over j unroll); bit j of `open` is
// slot j's open flag. The picked box is read back from shared memory.
template <int kSlots>
__device__ __forceinline__ void run_class(const ClassArgs& a,
                                          unsigned (*part_key)[kWarps],
                                          unsigned (*part_slot)[kWarps]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = a.nw * 32;
  float x1[kSlots], y1[kSlots], x2[kSlots], y2[kSlots], area[kSlots],
      cur[kSlots];
  unsigned open = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int p = tid + j * nt;
    const bool in = p < a.n;
    x1[j] = in ? a.sx1[p] : 0.0f;
    y1[j] = in ? a.sy1[p] : 0.0f;
    x2[j] = in ? a.sx2[p] : 0.0f;
    y2[j] = in ? a.sy2[p] : 0.0f;
    area[j] = in ? a.sarea[p] : 0.0f;
    cur[j] = in ? a.scur[p] : kNeg;
    open |= (unsigned)in << j;
  }
  const unsigned all = open;
  unsigned sel = 0;
  const unsigned neg_key = score_key(kNeg);
  int parity = 0;
  while (true) {
    unsigned key = neg_key;           // only scores above -1e30 count
    unsigned slot = UINT_MAX;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const unsigned k = score_key(cur[j]);
      if (((open >> j) & 1u) && k > key) {   // slots rise in index with j
        key = k;
        slot = tid + j * nt;
      }
    }
    unsigned best = __reduce_max_sync(kFull, key);
    unsigned pick = __reduce_min_sync(kFull, key == best ? slot : UINT_MAX);
    if (a.nw > 1) {
      if (lane == 0) {
        part_key[parity][warp] = best;
        part_slot[parity][warp] = pick;
      }
      named_barrier(1, nt);
      best = neg_key;
      pick = UINT_MAX;
      for (int w = 0; w < a.nw; ++w) {
        const unsigned k = part_key[parity][w];
        const unsigned s = part_slot[parity][w];
        if (k > best || (k == best && s < pick)) {
          best = k;
          pick = s;
        }
      }
      parity ^= 1;
    }
    if (best == neg_key) break;       // nothing open above -1e30

    if ((int)(pick % nt) == tid) {
      const unsigned bit = 1u << (pick / nt);
      open &= ~bit;
      sel |= bit;
    }
    const float bx1 = a.sx1[pick];
    const float by1 = a.sy1[pick];
    const float bx2 = a.sx2[pick];
    const float by2 = a.sy2[pick];
    const float barea = a.sarea[pick];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (!((open >> j) & 1u)) continue;
      const float iw = fminf(bx2, x2[j]) - fmaxf(bx1, x1[j]) + 1.0f;
      const float ih = fminf(by2, y2[j]) - fmaxf(by1, y1[j]) + 1.0f;
      const bool pos = iw > 0.0f && ih > 0.0f;
      if (!pos && a.skip) continue;   // weight exactly 1, stays active
      const float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
      float ov = inter / fmaxf(barea + area[j] - inter, 1e-12f);
      if (!pos) ov = 0.0f;
      float w;
      if (a.method == 2) {
        w = expf(-(ov * ov) / a.sigma);
      } else if (a.method == 1) {
        w = ov > a.iou_threshold ? 1.0f - ov : 1.0f;
      } else {
        w = ov > a.iou_threshold ? 0.0f : 1.0f;
      }
      cur[j] = cur[j] * w;
      if (pos && cur[j] < a.score_threshold) open &= ~(1u << j);
    }
  }

  // 3. scores and the selection of the thread's slots
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if ((all >> j) & 1u) {
      const int i = a.sorig[tid + j * nt];
      a.out_scores[i] = cur[j];
      a.selected[i] = (sel >> j) & 1u;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
soft_nms_class_kernel(const float* __restrict__ boxes,          // (B, K, 4)
                      const float* __restrict__ scores,         // (B, K)
                      const unsigned char* __restrict__ valid,  // (B, K) or null
                      const int* __restrict__ cls,              // (B, K)
                      float* __restrict__ out_scores,           // (B, K)
                      unsigned char* __restrict__ selected,     // (B, K)
                      int K, int C, int method, float sigma,
                      float iou_threshold, float score_threshold, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx1 = reinterpret_cast<float*>(smem);
  float* sy1 = sx1 + K;
  float* sx2 = sy1 + K;
  float* sy2 = sx2 + K;
  float* sarea = sy2 + K;
  float* scur = sarea + K;
  int* sorig = reinterpret_cast<int*>(scur + K);
  __shared__ int warp_count[kWarps];
  __shared__ unsigned part_key[2][kWarps];
  __shared__ unsigned part_slot[2][kWarps];

  const int b = blockIdx.x / C;
  const int c = blockIdx.x - b * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)b * K;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + base;

  // 1. this class's boxes, in index order: membership of every id the
  //    thread looks at (loads in flight together), then one ballot scan a
  //    round of kThreads ids
  unsigned member = 0;
#pragma unroll
  for (int r = 0; r < kChunks; ++r) {
    const int i = r * kThreads + tid;
    if (i < K && cls[base + i] == c &&
        (valid == nullptr || valid[base + i] != 0)) {
      member |= 1u << r;
    }
  }
  int n = 0;
  for (int r = 0; r * kThreads < K; ++r) {
    const bool mine = (member >> r) & 1u;
    const unsigned ballot = __ballot_sync(kFull, mine);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = n;
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = warp_count[w];
      before += w < warp ? cnt : 0;
      n += cnt;
    }
    if (mine) {
      const int p = before + __popc(ballot & ((1u << lane) - 1u));
      const int i = r * kThreads + tid;
      const float4 box = bx[i];
      sx1[p] = box.x;
      sy1[p] = box.y;
      sx2[p] = box.z;
      sy2[p] = box.w;
      sarea[p] = (box.z - box.x + 1.0f) * (box.w - box.y + 1.0f);
      scur[p] = scores[base + i];
      sorig[p] = i;
    }
    __syncthreads();
  }
  if (n == 0) return;

  // 2. the class to exhaustion on nw warps, its state in registers
  const int nw = min(kWarps, (n + kBoxesPerWarp - 1) / kBoxesPerWarp);
  if (tid >= nw * 32) return;
  const ClassArgs args{sx1, sy1, sx2, sy2, sarea, scur, sorig, out_scores +
                       base, selected + base, n, nw, method, sigma,
                       iou_threshold, score_threshold, skip};
  if (n <= kWarps * kBoxesPerWarp) {              // <= 2 slots a thread
    run_class<kBoxesPerWarp / 32>(args, part_key, part_slot);
  } else if (n <= 8 * kThreads) {                  // <= 8
    run_class<8>(args, part_key, part_slot);
  } else {                                         // <= 16
    run_class<kMaxK / kThreads>(args, part_key, part_slot);
  }
}

// One block per image: boxes in no class segment get their result; the
// selected boxes are compacted and sorted by (-score, index); rank = the
// position, kept where it is below `steps`.
__global__ void __launch_bounds__(kRankThreads)
soft_nms_rank_kernel(const unsigned char* __restrict__ valid,  // (B, K) or null
                     const int* __restrict__ cls,              // (B, K)
                     float* __restrict__ out_scores,           // (B, K)
                     unsigned char* __restrict__ keep,         // (B, K): in, selected
                     int* __restrict__ rank,                   // (B, K)
                     int K, int C, int steps) {
  extern __shared__ unsigned long long keys[];  // pow2_at_least(K)
  __shared__ int n_sel;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * K;
  if (tid == 0) n_sel = 0;
  __syncthreads();
  for (int i = tid; i < K; i += kRankThreads) {
    const int c = cls[base + i];
    const bool in_class = (valid == nullptr || valid[base + i] != 0) &&
                          c >= 0 && c < C;
    if (!in_class) {
      out_scores[base + i] = kNeg;
      keep[base + i] = 0;
      rank[base + i] = K;
    } else if (keep[base + i]) {
      const int j = atomicAdd(&n_sel, 1);
      keys[j] = ((unsigned long long)~score_key(out_scores[base + i]) << 32) |
                (unsigned)i;
    } else {
      rank[base + i] = K;
    }
  }
  __syncthreads();
  const int ns = n_sel;
  int n2 = 1;
  while (n2 < ns) n2 <<= 1;
  for (int j = ns + tid; j < n2; j += kRankThreads) keys[j] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n2 / 2; t += kRankThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo];
        const unsigned long long h = keys[hi];
        if ((a > h) == ((lo & size) == 0)) {
          keys[lo] = h;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < ns; r += kRankThreads) {
    const int i = (int)(keys[r] & 0xffffffffu);
    const bool kept = r < steps;
    keep[base + i] = kept;
    rank[base + i] = kept ? r : K;
  }
}

}  // namespace

extern "C" {

// Largest K and number of classes one launch takes.
int rrnet_soft_nms_classes_max_k() { return kMaxK; }
int rrnet_soft_nms_classes_max_classes() { return kMaxClasses; }

// Launches the class kernel and the rank kernel on `stream`; returns the
// first CUDA error of the launches (0 = launched). `valid` may be null
// (all valid); `cls` is required.
int rrnet_soft_nms_classes(const float* boxes, const float* scores,
                           const unsigned char* valid, const int* cls,
                           float* out_scores, unsigned char* keep, int* rank,
                           int B, int K, int C, int steps, int method,
                           float sigma, float iou_thr, float score_thr,
                           void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || C < 1 || C > kMaxClasses ||
      cls == nullptr || (long long)B * C > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  // a zero overlap gives weight exactly 1 (and no deactivation) for these
  // settings, so the class kernel may skip non-overlapping slots
  const int skip = method == 2 ? sigma > 0.0f
                   : method == 1 ? 1 : !(0.0f > iou_thr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = class_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      soft_nms_class_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_nms_class_kernel<<<B * C, kThreads, smem, s>>>(
      boxes, scores, valid, cls, out_scores, keep, K, C, method, sigma,
      iou_thr, score_thr, skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  soft_nms_rank_kernel<<<B, kRankThreads,
                         pow2_at_least(K) * sizeof(unsigned long long), s>>>(
      valid, cls, out_scores, keep, rank, K, C, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
