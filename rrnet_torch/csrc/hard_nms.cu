// Greedy hard NMS for Hopper (sm_90a): one launch a call. The score order,
// the pair mask and the scan of each image run in one thread-block
// cluster, with no host round trip and no scratch in device memory.
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
// A cluster of C CTAs serves one image: 16 when K > 960 and the batch's
// clusters of 16 fit on the card at once (cudaOccupancyMaxActiveClusters,
// asked once a device), else 8 (1, 2 or 4 when K <= 448). The image's K
// positions in score order form W = ceil(K/64) blocks of 64; CTA c owns
// the column blocks w with owner_of(w) == c, a snake over the CTAs, so
// that each holds an equal share of the mask's upper triangle.
//
// 1. Rank. Every CTA turns the K scores into ops/nms.py::score_key's int32
//    key (where(valid, s, -inf), -0.0 as +0.0, the IEEE bits made
//    monotone, NaN below -inf) and sorts the positions by it, descending,
//    with a stable radix sort in shared memory (8 bits a pass; a pass
//    whose digit is the same for every key is skipped), so that ties keep
//    their index order. That is ops/nms.py::score_order, the JAX package's
//    argsort(-where(valid, s, -inf)); its time does not depend on how
//    many scores tie. Every CTA ranks every box itself and gathers the
//    boxes, classes and valid flags in that order from device memory.
// 2. Mask. The W(W+1)/2 64x64 blocks of the upper triangle are dealt to
//    the CTAs in turn, a warp a block, two rows a lane, and each is stored
//    in its column's owner. Bit jj of row r's word in column block w is
//    set when column j = 64w + jj > r, row r is valid, the two share a
//    class (when class ids are given) and IoU > threshold. The IoU is
//    ops/box.py::pairwise_iou's, op by op: iw/ih = min - max + off,
//    clamped at 0, inter = iw*ih, union = (area_i + area_j) - inter
//    clamped at 1e-8, IEEE division (built with -fmad=false and no fast
//    math; min and max propagate NaN as torch.minimum/maximum do). At
//    thr >= 0 the 64 columns are first screened, four compares a pair
//    (`screen`), and only the survivors take that test; at thr < 0 every
//    pair takes it. Beside each block a summary word of its nonzero rows.
//    The blocks on the diagonal and just above it are stored by column,
//    the others by row; a lane's two words lie side by side. The mask
//    never leaves the cluster's shared memory.
// 3. Scan. One warp of CTA 0 walks the blocks in rank order, reading each
//    column's diagonal block and the one above from its owner's memory
//    three columns ahead. For block w: candidates are the valid rows not
//    removed by earlier blocks; the block above comes from the keep bits
//    the scanner just found (a ballot a test), the rest from a sum
//    the column's owner sent; the keep bits are the fixpoint of
//        keep = candidates & ~OR(diagonal words of the kept rows)
//    (one round more than the longest suppression chain in the block, two
//    ballots a round), and go to every CTA (st.async on its mbarrier). In
//    every CTA one warp for each owned column ORs, as each block's keep
//    bits come, the kept rows' words of that column (only where the
//    summary says a row's word is nonzero) and sends the sum to the
//    scanner once the block two above the diagonal is in: that sum
//    is ready a step before the scanner needs it.
// 4. Each CTA writes keep[i] for its share of the positions, in input
//    order.
//
// What bounds it on the card (profile_hard_nms.py at the repo root, which
// builds copies with stage cuts and clock64 stamps patched in; one H100,
// B=4, K=1500 per class): latency. The rank's passes (four on f32 scores,
// two on bf16-valued ones), the mask (K^2/2 pairs, four compares each),
// then the scan, a chain of W steps of ~500 cycles (the scanner's
// ballots, its mbarrier wait, its st.async and its loads from the
// owners). B=1 takes the time of B=4: images run on clusters of their
// own. Up to K = 4096 the triangle (1.06 MB at K = 4096) fits in the 8
// CTAs' shared memory (226 KB a CTA at K = 4096 with class ids).

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxK = 4096;
constexpr int kMaxW = kMaxK / 64;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// CTAs an image: 8 (the portable maximum), or 16 (non-portable) when
// K > 960 and the batch's clusters of 16 fit on the card at once.
constexpr int kPortable = 8;
constexpr int kWide = 16;
constexpr int kMaxDevices = 64;
constexpr int kScreenGroup = 16;   // columns of the screen unrolled
constexpr int kMaxOwned = 8;       // ceil(W / C) for every (W, C) used
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNaNKey = -2147483647;   // INT32_MIN + 1: below every score
constexpr int kRadixBits = 8;          // of the rank's passes
constexpr int kRadix = 1 << kRadixBits;
constexpr int kPitch = kWarps + 1;     // of the rank's counts, by digit
constexpr int kRounds = kMaxK / kThreads;  // of 32 boxes a warp, at most

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "threads");
static_assert(kRadix <= kThreads && kRadix % 32 == 0, "a thread a digit");
static_assert(kMaxK % kThreads == 0, "kRounds rounds a warp");
static_assert(kMaxK <= 65536, "positions held as u16");
static_assert(kWarps > kMaxOwned, "a warp for each owned column and one");

// Cluster size for W blocks and B images: 16 when W >= 16 and B clusters
// of 16 fit at once (`wide` of them do on this card), else the largest of
// 1, 2, 4, 8 that is at most W.
inline int cluster_for(int W, int B, int wide) {
  if (W >= kWide && B <= wide) return kWide;
  int c = 1;
  while (c * 2 <= kPortable && c * 2 <= W) c *= 2;
  return c;
}

// Clusters of 16 that fit on each device at once (0: none, or not known).
int g_wide[kMaxDevices];

// The CTA that owns column block w: a snake over the C CTAs (0..C-1, then
// C-1..0, ...), so that the columns' triangle rows (w + 1 blocks each)
// spread evenly.
__host__ __device__ inline int owner_of(int w, int C) {
  const int r = w / C, p = w % C;
  return (r & 1) ? C - 1 - p : p;
}

// Column block of CTA c in round r (>= W when it owns none there).
__host__ __device__ inline int owned_column(int r, int c, int C) {
  return r * C + ((r & 1) ? C - 1 - c : c);
}

// Blocks of the triangle (rows blocks 0..w of each owned column w) that
// CTA c holds.
__host__ __device__ inline int owned_blocks(int c, int C, int W) {
  int n = 0;
  for (int r = 0; r * C < W; ++r) {
    const int w = owned_column(r, c, C);
    if (w < W) n += w + 1;
  }
  return n;
}

// Where owned column q of CTA o lies in o's mask region, in 64-bit words:
// its words (at) and its blocks' summaries (rat), which follow all of o's
// words.
__host__ __device__ inline void column_offsets(int o, int q, int C, int W,
                                               int& at, int& rat) {
  int words = 0, sums = 0;
  at = rat = 0;
  for (int r = 0; r * C < W; ++r) {
    const int w = owned_column(r, o, C);
    if (w >= W) break;
    if (r == q) {
      at = words;
      rat = sums;
    }
    words += 64 * (w + 1);
    sums += w + 1;
  }
  rat += words;
}

struct Layout {
  int box, cls, val, perm, kept, mbar, accv, accbar, vb, region, total;
};

// Dynamic shared memory of one CTA, in bytes from its start: boxes
// (float4), classes (int, when given) and valid flags (u8) in score order,
// the input index of each position (u16), the keep words of every block,
// one mbarrier a block, the valid words of the owned columns, then a
// region that holds the keys during the rank and, after it, the owned
// columns' mask words and summaries.
__host__ __device__ inline Layout layout_of(int K, int W, int C, bool cls) {
  Layout l;
  const int kp = 64 * W;
  int max_blocks = 0;
  for (int c = 0; c < C; ++c) {
    const int n = owned_blocks(c, C, W);
    max_blocks = n > max_blocks ? n : max_blocks;
  }
  l.box = 0;
  l.cls = l.box + 16 * kp;
  l.val = l.cls + (cls ? 4 * kp : 0);
  l.perm = l.val + kp;
  l.kept = l.perm + 2 * kp;
  l.mbar = l.kept + 8 * kMaxW;
  l.accv = l.mbar + 8 * kMaxW;
  l.accbar = l.accv + 8 * kMaxW;
  l.vb = l.accbar + 8 * kMaxW;
  l.region = l.vb + 8 * kMaxOwned;
  // the rank: two buffers of sort keys, one of positions, the counts of
  // each warp by digit and a reduction
  const int keys = 8 * kp + 2 * kp + 4 * kRadix * kPitch + 8 * kWarps;
  const int mask = max_blocks * (64 * 8 + 8);
  l.total = l.region + (keys > mask ? keys : mask);
  return l;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// torch's clamp(min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// ops/nms.py::score_key
__device__ __forceinline__ int score_key(float s, bool valid) {
  float m = valid ? s : -__int_as_float(0x7f800000);
  if (m == 0.0f) m = 0.0f;
  if (m != m) return kNaNKey;
  const int bits = __float_as_int(m);
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// bit j: some row of `rows` suppresses column j, of a 64x64 block held
// by column (t0: column lane, t1: column lane + 32)
__device__ __forceinline__ u64 by_columns(u64 rows, u64 t0, u64 t1) {
  const unsigned lo = __ballot_sync(kFull, (t0 & rows) != 0);
  const unsigned hi = __ballot_sync(kFull, (t1 & rows) != 0);
  return ((u64)hi << 32) | lo;
}

// the OR over the rows of `m` of their words (w0: row lane, w1: row
// lane + 32) of a block held by row
__device__ __forceinline__ u64 or_rows(u64 m, u64 w0, u64 w1, int lane) {
  const u64 x = ((m >> lane) & 1ull ? w0 : 0) |
                ((m >> (lane + 32)) & 1ull ? w1 : 0);
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)x);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(x >> 32));
  return ((u64)hi << 32) | lo;
}

// a[q] for a q known only at run time, without indexing the array (which
// would put it in local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxOwned], int q) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < kMaxOwned; ++k) {
    if (k == q) v = a[k];
  }
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_addr(unsigned local, int cta) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(cta));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned a, u64 v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" :: "r"(a), "l"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster2(unsigned a, u64 x, u64 y) {
  asm volatile("st.shared::cluster.v2.u64 [%0], {%1, %2};"
               :: "r"(a), "l"(x), "l"(y) : "memory");
}

__device__ __forceinline__ void ld_cluster2(unsigned a, u64& x, u64& y) {
  asm volatile("ld.shared::cluster.v2.u64 {%0, %1}, [%2];"
               : "=l"(x), "=l"(y) : "r"(a));
}

__device__ __forceinline__ u64 ld_cluster(unsigned a) {
  u64 v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The two halves of cluster_sync, apart: no CTA may touch another's
// shared memory before that one has started, which the wait ensures.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The 8 bytes `v` into the u64 at cluster address `a`, completing 8 bytes
// of the transaction count of the mbarrier at cluster address `bar` (both
// in the receiving CTA).
__device__ __forceinline__ void send_u64(unsigned a, u64 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 "
      "[%0], %1, [%2];" :: "r"(a), "l"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_parity0(unsigned bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT_%=;\n"
      "}" :: "r"(bar) : "memory");
}

// The exact test of pair (row a, column c), as the plain version computes
// it (ops/box.py::pairwise_iou, the class gate, iou > thr).
__device__ __forceinline__ bool suppresses(float4 a, float aa, int ca,
                                           float4 c, int cc, bool cls,
                                           float thr, float off) {
  const float iw = clamp_min(min_nan(a.z, c.z) - max_nan(a.x, c.x) + off,
                             0.0f);
  const float ih = clamp_min(min_nan(a.w, c.w) - max_nan(a.y, c.y) + off,
                             0.0f);
  const float inter = iw * ih;
  const float area_c = (c.z - c.x + off) * (c.w - c.y + off);
  float iou = inter / clamp_min((aa + area_c) - inter, 1e-8f);
  if (cls && ca != cc) iou = 0.0f;
  return iou > thr;
}

// Screens rows a0, a1 against the 64 columns of `col`, four compares a
// pair. At thr >= 0 a pair passes the full test only when iw > 0 and
// ih > 0. Without +1: iw = min(x2) - max(x1) > 0 holds exactly when
// min(x2) > max(x1), which needs x2_i > x1_j and x2_j > x1_i. With +1:
// fl(fl(m - M) + 1) > 0 needs m - M > -1, so fl(m + 1) >= M (rounding is
// monotone), which needs fl(x2_i + 1) >= x1_j and fl(x2_j + 1) >= x1_i.
// The same for y. A NaN coordinate fails the screen, and the full test
// too (its iou is NaN, or 0 for another class).
// The 64x64 bit block held as rows (lane: rows lane and lane + 32) as
// columns (lane: columns lane and lane + 32, bit r = row r).
__device__ __forceinline__ void transpose64(u64& r0, u64& r1, int lane) {
  u64 t0 = 0, t1 = 0;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const unsigned a = __ballot_sync(kFull, (r0 >> j) & 1ull);
    const unsigned b = __ballot_sync(kFull, (r1 >> j) & 1ull);
    const unsigned c = __ballot_sync(kFull, (r0 >> (j + 32)) & 1ull);
    const unsigned d = __ballot_sync(kFull, (r1 >> (j + 32)) & 1ull);
    if (lane == j) {
      t0 = ((u64)b << 32) | a;
      t1 = ((u64)d << 32) | c;
    }
  }
  r0 = t0;
  r1 = t1;
}

template <bool kPlusOne>
__device__ __forceinline__ void screen(const float4* col, float4 a0,
                                       float4 a1, u64& s0, u64& s1) {
  const float z0 = a0.z + 1.0f, w0 = a0.w + 1.0f;
  const float z1 = a1.z + 1.0f, w1 = a1.w + 1.0f;
  u64 m0 = 0, m1 = 0;
#pragma unroll 1
  for (int g = 0; g < 64; g += kScreenGroup) {
    unsigned b0 = 0, b1 = 0;
#pragma unroll
    for (int jj = 0; jj < kScreenGroup; ++jj) {
      const float4 c = col[g + jj];
      bool p0, p1;
      if (kPlusOne) {
        const float cz = c.z + 1.0f, cw = c.w + 1.0f;
        p0 = z0 >= c.x && cz >= a0.x && w0 >= c.y && cw >= a0.y;
        p1 = z1 >= c.x && cz >= a1.x && w1 >= c.y && cw >= a1.y;
      } else {
        p0 = a0.z > c.x && c.z > a0.x && a0.w > c.y && c.w > a0.y;
        p1 = a1.z > c.x && c.z > a1.x && a1.w > c.y && c.w > a1.y;
      }
      if (p0) b0 |= 1u << jj;
      if (p1) b1 |= 1u << jj;
    }
    m0 |= (u64)b0 << g;
    m1 |= (u64)b1 << g;
  }
  s0 = m0;
  s1 = m1;
}

template <bool kPlusOne>
__global__ void __launch_bounds__(kThreads, 1)
hard_nms_cluster_kernel(const float4* __restrict__ boxes,        // (B, K)
                        const float* __restrict__ scores,        // (B, K)
                        const unsigned char* __restrict__ valid, // or null
                        const int* __restrict__ cls,             // or null
                        unsigned char* __restrict__ keep,        // (B, K)
                        int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = gridDim.x;           // the cluster: gridDim.x CTAs
  const int me = blockIdx.x;
  const int b = blockIdx.y;
  const int W = (K + 63) / 64;
  const int kp = 64 * W;
  const bool has_cls = cls != nullptr;
  const Layout L = layout_of(K, W, C, has_cls);
  float4* sbox = reinterpret_cast<float4*>(smem + L.box);
  int* scls = reinterpret_cast<int*>(smem + L.cls);
  unsigned char* sval = smem + L.val;
  u64* kept = reinterpret_cast<u64*>(smem + L.kept);
  u64* mbar = reinterpret_cast<u64*>(smem + L.mbar);
  u64* vb = reinterpret_cast<u64*>(smem + L.vb);
  u64* accv = reinterpret_cast<u64*>(smem + L.accv);
  u64* accbar = reinterpret_cast<u64*>(smem + L.accbar);
  unsigned short* perm = reinterpret_cast<unsigned short*>(smem + L.perm);
  u64* words = reinterpret_cast<u64*>(smem + L.region);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)b * K;
  const float off = kPlusOne ? 1.0f : 0.0f;

  // the owned columns, ascending, and where their words and summaries lie
  // (register arrays: indexed by constants only, or through pick())
  int nq = 0;
  int col_w[kMaxOwned], col_off[kMaxOwned], col_roff[kMaxOwned];
  {
    int words_at = 0;
#pragma unroll
    for (int r = 0; r < kMaxOwned; ++r) {
      const int w = owned_column(r, me, C);   // ascending in r
      col_w[r] = w;
      col_off[r] = words_at;
      if (w < W) {
        words_at += 64 * (w + 1);
        nq = r + 1;
      }
    }
    int at = words_at;
#pragma unroll
    for (int q = 0; q < kMaxOwned; ++q) {
      col_roff[q] = at;
      if (q < nq) at += col_w[q] + 1;
    }
  }

  // 0. mbarriers for the blocks other CTAs resolve
  if (tid < W) {       // keep bits of block tid; in CTA 0 its far sum
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(mbar + tid)) : "memory");
    if (me == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(accbar + tid)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 8;"
                 :: "r"(smem_addr(mbar + tid)) : "memory");
    if (me == 0 && tid > 1) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 8;"
                   :: "r"(smem_addr(accbar + tid)) : "memory");
    }
  }
  cluster_arrive();   // waited for before the mask's first remote store
  // 1. the score order, in every CTA: a stable LSD radix sort of the
  // positions 0..K-1 by score_key, descending (by ~(key ^ INT32_MIN)
  // ascending), kRadixBits a pass, so ties keep their index order; a pass
  // whose digit is the same for every key is skipped (bf16 scores leave
  // the low 16 bits alike). Each warp owns a run of positions, in order.
  // A pass counts each warp's boxes by digit, a round of 32 at a time
  // (a box's peers, the boxes of its round with its digit, from one
  // ballot a digit bit), turns the counts into the first place of each
  // (digit, warp), digits in order and warps in order within a digit, and
  // scatters.
  unsigned* ksrc = reinterpret_cast<unsigned*>(smem + L.region);
  unsigned* kdst = ksrc + kp;
  unsigned short* spare = reinterpret_cast<unsigned short*>(kdst + kp);
  int* cnt = reinterpret_cast<int*>(spare + kp);     // kRadix x kPitch
  unsigned* red = reinterpret_cast<unsigned*>(cnt + kRadix * kPitch);
  unsigned any = 0, all = ~0u;
  for (int j = tid; j < K; j += kThreads) {
    const unsigned k = ~((unsigned)score_key(
        scores[base + j], valid == nullptr || valid[base + j] != 0) ^
        0x80000000u);
    ksrc[j] = k;
    any |= k;
    all &= k;
  }
  any = __reduce_or_sync(kFull, any);
  all = __reduce_and_sync(kFull, all);
  if (lane == 0) {
    red[warp] = any;
    red[kWarps + warp] = all;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    any |= red[v];
    all &= red[kWarps + v];
  }
  const unsigned vary = any ^ all;       // the bits that differ somewhere
  int passes = 0;
  for (int sh = 0; sh < 32; sh += kRadixBits) {
    passes += ((vary >> sh) & (kRadix - 1)) != 0;
  }
  // the positions' buffers, so that the last pass writes perm
  unsigned short* isrc = (passes & 1) ? spare : perm;
  unsigned short* idst = (passes & 1) ? perm : spare;
  for (int j = tid; j < K; j += kThreads) isrc[j] = (unsigned short)j;
  const int per = (K + kWarps - 1) / kWarps;
  const int first = warp * per, last = min(K, first + per);
  for (int sh = 0; sh < 32; sh += kRadixBits) {
    if (((vary >> sh) & (kRadix - 1)) == 0) continue;
    for (int d = lane; d < kRadix; d += 32) cnt[d * kPitch + warp] = 0;
    __syncwarp();
    // the warp's keys, and each lane's peers among the lanes in use
    unsigned key[kRounds], peers[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j0 = first + 32 * r;
      if (j0 < last) {
        const bool in = j0 + lane < last;
        key[r] = in ? ksrc[j0 + lane] : 0u;
        const unsigned d = (key[r] >> sh) & (kRadix - 1);
        unsigned p = last - j0 >= 32 ? kFull : (1u << (last - j0)) - 1;
#pragma unroll
        for (int bit = 0; bit < kRadixBits; ++bit) {
          const unsigned set = __ballot_sync(kFull, (d >> bit) & 1u);
          p &= ((d >> bit) & 1u) ? set : ~set;
        }
        peers[r] = p;
        if (in && lane == __ffs(p) - 1) cnt[d * kPitch + warp] += __popc(p);
        __syncwarp();
      }
    }
    __syncthreads();
    // thread d < kRadix: digit d's counts by warp into first places
    int total = 0;
    int c[kWarps];
    if (tid < kRadix) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v) c[v] = cnt[tid * kPitch + v];
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int n = c[v];
        c[v] = total;
        total += n;
      }
    }
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) red[warp] = incl;
    __syncthreads();
    if (tid < kRadix) {
      int start = incl - total;
      for (int v = 0; v < warp; ++v) start += red[v];
#pragma unroll
      for (int v = 0; v < kWarps; ++v) cnt[tid * kPitch + v] = c[v] + start;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j0 = first + 32 * r;
      if (j0 < last) {
        const bool in = j0 + lane < last;
        const unsigned d = (key[r] >> sh) & (kRadix - 1);
        if (in) {
          const int at = cnt[d * kPitch + warp] +
                         __popc(peers[r] & ((1u << lane) - 1));
          kdst[at] = key[r];
          idst[at] = isrc[j0 + lane];
        }
        __syncwarp();
        if (in && lane == __ffs(peers[r]) - 1) {
          cnt[d * kPitch + warp] += __popc(peers[r]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    unsigned* kt = ksrc;
    ksrc = kdst;
    kdst = kt;
    unsigned short* it = isrc;
    isrc = idst;
    idst = it;
  }
  __syncthreads();   // the order whole (perm); the keys are dead
  // the boxes, classes and valid flags in score order
#pragma unroll 4
  for (int r = tid; r < kp; r += kThreads) {
    if (r < K) {
      const int i = perm[r];
      sbox[r] = boxes[base + i];
      sval[r] = valid == nullptr || valid[base + i] != 0 ? 1 : 0;
      if (has_cls) scls[r] = cls[base + i];
    } else {
      sbox[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      sval[r] = 0;
      if (has_cls) scls[r] = 0;
    }
  }
  __syncthreads();
  cluster_wait();   // every CTA of the cluster has started: the mask's
                    // stores go to the columns' owners
  // 2. the mask: the W(W+1)/2 blocks of the triangle (block k: column
  // w, row block rb, k = w(w+1)/2 + rb) are dealt to the CTAs in turn, a
  // warp a block, and each is stored in its column's owner (distributed
  // shared memory): every CTA builds an equal share whatever it holds
  const int nblocks = W * (W + 1) / 2;
  for (int k = me + C * warp; k < nblocks; k += C * kWarps) {
    int w = (int)((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
    while (w * (w + 1) / 2 > k) --w;
    while ((w + 1) * (w + 2) / 2 <= k) ++w;
    const int rb = k - w * (w + 1) / 2;
    const int o = owner_of(w, C), q = w / C;
    int at, rat;
    column_offsets(o, q, C, W, at, rat);
    const int r0 = rb * 64 + lane;
    const int r1 = r0 + 32;
    const float4 a0 = sbox[r0];
    const float4 a1 = sbox[r1];
    const bool v0 = sval[r0] != 0;
    const bool v1 = sval[r1] != 0;
    const float4* col = sbox + 64 * w;
    u64 s0, s1;
    if (thr >= 0.0f) {
      screen<kPlusOne>(col, a0, a1, s0, s1);
    } else {
      s0 = s1 = ~0ull;       // iou 0 > thr: every pair takes the test
    }
    const int ncol = min(64, K - 64 * w);
    u64 keepcols = ncol == 64 ? ~0ull : (1ull << ncol) - 1;
    u64 m0 = keepcols, m1 = keepcols;
    if (rb == w) {                       // the diagonal: columns after
      m0 &= ~((2ull << lane) - 1);
      m1 &= ~((2ull << (lane + 32)) - 1);
    }
    s0 = v0 ? s0 & m0 : 0;
    s1 = v1 ? s1 & m1 : 0;
    u64 word0 = 0, word1 = 0;
    if (s0 | s1) {
      const float aa0 = (a0.z - a0.x + off) * (a0.w - a0.y + off);
      const float aa1 = (a1.z - a1.x + off) * (a1.w - a1.y + off);
      const int c0 = has_cls ? scls[r0] : 0;
      const int c1 = has_cls ? scls[r1] : 0;
      const int* ccol = scls + 64 * w;
      while (s0) {
        const int jj = __ffsll(s0) - 1;
        s0 &= s0 - 1;
        if (suppresses(a0, aa0, c0, col[jj], has_cls ? ccol[jj] : 0,
                       has_cls, thr, off)) {
          word0 |= 1ull << jj;
        }
      }
      while (s1) {
        const int jj = __ffsll(s1) - 1;
        s1 &= s1 - 1;
        if (suppresses(a1, aa1, c1, col[jj], has_cls ? ccol[jj] : 0,
                       has_cls, thr, off)) {
          word1 |= 1ull << jj;
        }
      }
    }
    const unsigned dst = cluster_addr(smem_addr(words), o);
    if (rb < w) {
      const unsigned lo = __ballot_sync(kFull, word0 != 0);
      const unsigned hi = __ballot_sync(kFull, word1 != 0);
      if (lane == 0) st_cluster(dst + 8 * (rat + rb), ((u64)hi << 32) | lo);
    } else {
      const unsigned lo = __ballot_sync(kFull, v0);
      const unsigned hi = __ballot_sync(kFull, v1);
      if (lane == 0) {
        st_cluster(cluster_addr(smem_addr(vb + q), o),
                   ((u64)hi << 32) | lo);
      }
    }
    // the scanner reads the diagonal and the block above it by column (a
    // ballot a test), the owners the other blocks by row
    if (rb + 1 >= w && __any_sync(kFull, (word0 | word1) != 0)) {
      transpose64(word0, word1, lane);
    }
    // lane's two words side by side: one 16-byte access for each reader
    st_cluster2(dst + 8 * (at + rb * 64) + 16 * lane, word0, word1);
  }
  __syncthreads();
  cluster_sync();   // every CTA's mask whole before the scanner reads it
  if (me == 0 && warp == 0) {
    // 3a. the scanner: warp 0 of CTA 0 resolves the blocks in order
    u64 prev = 0;               // keep bits of block w - 1
    // column w as the scanner reads it from its owner's shared memory:
    // the diagonal block (d0, d1), the block above it (t0, t1) and the
    // valid bits
    struct Column {
      u64 d0, d1, t0, t1, vbits;
    };
    // where column w's words and valid bits lie in its owner (cluster
    // addresses), for w = lane and lane + 32
    unsigned col_at[2], vb_at[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = min(lane + 32 * h, W - 1);
      const int o = owner_of(w, C), q = w / C;
      int at = 0;
      for (int r = 0; r < q; ++r) at += 64 * (owned_column(r, o, C) + 1);
      col_at[h] = cluster_addr(smem_addr(words + at), o);
      vb_at[h] = cluster_addr(smem_addr(vb + q), o);
    }
    // the keep words and their mbarriers in CTA lane
    const unsigned kept_at = cluster_addr(smem_addr(kept), lane % C);
    const unsigned mbar_at = cluster_addr(smem_addr(mbar), lane % C);
    auto fetch = [&](int w) {
      Column x;
      w = min(w, W - 1);
      const bool hi = w >= 32;
      const unsigned col = __shfl_sync(kFull, hi ? col_at[1] : col_at[0],
                                       w & 31);
      const unsigned vbw = __shfl_sync(kFull, hi ? vb_at[1] : vb_at[0],
                                       w & 31);
      ld_cluster2(col + 512 * w + 16 * lane, x.d0, x.d1);
      ld_cluster2(col + 512 * max(w - 1, 0) + 16 * lane, x.t0, x.t1);
      x.vbits = ld_cluster(vbw);
      return x;
    };
    // resolves block w from its column's blocks
    auto step = [&](int w, const Column& cur) {
      u64 removed = w > 0 ? by_columns(prev, cur.t0, cur.t1) : 0;
      if (w > 1) {            // blocks before w - 1, summed by the owner
        wait_parity0(smem_addr(accbar + w));
        removed |= *reinterpret_cast<volatile u64*>(accv + w);
      }
      const u64 cand = cur.vbits & ~removed;
      u64 kb = cand;
      while (true) {
        const u64 next = cand & ~by_columns(kb, cur.d0, cur.d1);
        if (next == kb) break;
        kb = next;
      }
      if (lane < C) send_u64(kept_at + 8 * w, kb, mbar_at + 8 * w);
      prev = kb;
    };
    // three columns in flight, in four buffers: step w first refills the
    // buffer of step w - 1 with column w + 3 (no register waits on a load
    // before it is needed, and the loads' issue fills the step's stalls);
    // no load is left unused (the owners may leave once the last block
    // is out)
    Column buf[4];
    buf[0] = fetch(0);
    if (W > 1) buf[1] = fetch(1);
    if (W > 2) buf[2] = fetch(2);
    auto turn = [&](int w, Column& cur, Column& spare) {
      if (w + 3 < W) spare = fetch(w + 3);
      step(w, cur);
    };
    for (int w = 0; w < W; w += 4) {
      turn(w, buf[0], buf[3]);
      if (w + 1 < W) turn(w + 1, buf[1], buf[0]);
      if (w + 2 < W) turn(w + 2, buf[2], buf[1]);
      if (w + 3 < W) turn(w + 3, buf[3], buf[2]);
    }
  }
  if (warp >= 1 && warp - 1 < nq) {
    // 3b. warp 1 + q of every CTA sums, for its owned column q, the
    // removals of the kept rows of the blocks more than one above the
    // column's diagonal block (by row words, as each block's keep bits
    // come), and sends the sum to the scanner
    const int q = warp - 1;
    const int w = pick(col_w, q);
    const int at = pick(col_off, q), rat = pick(col_roff, q);
    u64 acc = 0;
    for (int rb = 0; rb < w - 1; ++rb) {
      const u64 sum = words[rat + rb];            // read before the wait
      const ulonglong2 pair =
          reinterpret_cast<const ulonglong2*>(words + at + rb * 64)[lane];
      wait_parity0(smem_addr(mbar + rb));
      const u64 m = *reinterpret_cast<volatile u64*>(kept + rb) & sum;
      if (m != 0) acc |= or_rows(m, pair.x, pair.y, lane);
    }
    if (w > 1 && lane == 0) {
      send_u64(cluster_addr(smem_addr(accv + w), 0), acc,
               cluster_addr(smem_addr(accbar + w), 0));
    }
  }
  if (warp == 0) {
    // every block's keep bits are in before the CTA writes its share
    for (int rb = 0; rb < W; ++rb) wait_parity0(smem_addr(mbar + rb));
  }
  __syncthreads();
  // 4. keep, in input order, for the CTA's share of the positions
  const int share = (K + C - 1) / C;
  for (int r = me * share + tid; r < min(K, (me + 1) * share);
       r += kThreads) {
    keep[base + perm[r]] = (unsigned char)((kept[r >> 6] >> (r & 63)) & 1ull);
  }
  // No barrier before leaving: every remote access to this CTA is done by
  // now (the mask's stores before the cluster barrier above; the keep bits
  // and sums it waited for; the scanner's loads, each used before the last
  // block's keep bits went out).
}

template <bool kPlusOne>
cudaError_t launch(const float* boxes, const float* scores,
                   const unsigned char* valid, const int* cls,
                   unsigned char* keep, int B, int K, float thr,
                   cudaStream_t s) {
  const int W = (K + 63) / 64;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return cudaGetLastError();
  const int C = cluster_for(W, B, dev < kMaxDevices ? g_wide[dev] : 0);
  const Layout L = layout_of(K, W, C, cls != nullptr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, hard_nms_cluster_kernel<kPlusOne>,
                            reinterpret_cast<const float4*>(boxes), scores,
                            valid, cls, keep, K, thr);
}

// The kernel's shared memory limit (the largest layout: K = 4096 on 8
// CTAs, with class ids) and its leave to run clusters of 16; returns how
// many clusters of 16 fit at once (0 when the card refuses them).
template <bool kPlusOne>
cudaError_t configure(int& wide) {
  const Layout most = layout_of(kMaxK, kMaxW, kPortable, true);
  const cudaError_t err = cudaFuncSetAttribute(
      hard_nms_cluster_kernel<kPlusOne>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, most.total);
  wide = 0;
  if (err != cudaSuccess) return err;
  if (cudaFuncSetAttribute(hard_nms_cluster_kernel<kPlusOne>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kWide, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = layout_of(kMaxK, kMaxW, kWide, true).total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWide;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(
          &wide, (const void*)hard_nms_cluster_kernel<kPlusOne>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    wide = 0;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Largest K one launch takes.
int rrnet_hard_nms_max_k() { return kMaxK; }

// Shared memory and cluster attributes of the kernel, once for the
// current device before its first launch there; returns the CUDA error.
int rrnet_hard_nms_setup() {
  int dev = 0, wide0 = 0, wide1 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = configure<false>(wide0);
  if (err == cudaSuccess) err = configure<true>(wide1);
  if (err == cudaSuccess && dev < kMaxDevices) {
    g_wide[dev] = wide0 < wide1 ? wide0 : wide1;
  }
  return (int)err;
}

// Launches the kernel on `stream`; returns the CUDA error of the launch
// (0 = launched). boxes (B, K, 4) f32, scores (B, K) f32, valid (B, K)
// bool or null, cls (B, K) int32 or null (class-agnostic), keep (B, K)
// bool out; all in input order.
int rrnet_hard_nms(const float* boxes, const float* scores,
                   const unsigned char* valid, const int* cls,
                   unsigned char* keep, int B, int K, float iou_thr,
                   int plus_one, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > kMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      plus_one ? launch<true>(boxes, scores, valid, cls, keep, B, K, iou_thr,
                              s)
               : launch<false>(boxes, scores, valid, cls, keep, B, K,
                               iou_thr, s);
  return (int)err;
}

}  // extern "C"
