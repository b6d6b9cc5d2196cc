// The epilogue of an eval convolution for Hopper (sm_90a): one pass over
// the conv's raw output y that adds its bias, optionally a residual, and
// optionally takes the ReLU:
//
//     y = round_T(y + bias)                     (bias may be absent)
//     y = round_R(y + residual)                 (residual may be absent)
//     y = isnan(y) ? y : fmaxf(y, 0)            (relu)
//
// T is y's dtype, R the residual's (and the result's): both bf16, both
// f32, or a bf16 y with an f32 residual (stage 2 adds its f32 ROI
// features), which PyTorch's type promotion makes an f32 sum. `round` is
// the rounding to that dtype (bf16: to nearest even; f32: none), after
// each add, in f32 as PyTorch's elementwise adds compute. The ReLU is
// PyTorch's `clamp_min(y, 0)` on the card, a NaN passed through as it
// is. So the result equals, bit for bit, the eager chain it replaces:
// cuDNN's convolution writes y, PyTorch adds the bias as a separate add_
// of a (1, C, 1, 1) tensor, then `+ skip` and `F.relu`. Where T == R the
// pass writes y in place; else it writes a separate R output. Built with
// -fmad=false and no fast math.
//
// Not the port of a TPU kernel: on the TPU, XLA fused the BN affine, the
// residual add and the ReLU into its convolution. On the card the
// convolution is cuDNN's, and its epilogue was three eager passes over
// each conv output (the broadcasting bias add, which PyTorch sends to its
// generic non-vectorised kernel since the bias operand has stride 0, the
// residual add, the ReLU).
//
// What bounds it: bytes. It does a few flops a byte, far below the card's
// ridge, so its least time is its traffic at HBM's 3.35 TB/s: y read and
// written once, the residual read once;
// the biases are C values that stay in L1. The design meets that bound
// with wide, coalesced accesses and enough of them in flight:
// - The maps are channels-last, so C is the contiguous axis and element i
//   has channel i % C. Where T == R, C is a multiple of the 16-byte
//   vector (8 bf16 or 4 f32 values) and every pointer is 16-byte aligned,
//   each thread moves 16-byte vectors, neighbouring threads neighbouring
//   vectors, and takes the matching 16 bytes of each bias.
// - Each thread loads all of its kUnroll vectors (of y and of the
//   residual) before it computes and stores any, so a block keeps
//   kThreads * kUnroll * 16 bytes a tensor in flight.
// - Elsewhere (C = 1, 2, 10 of the heads' outputs, an unaligned view, the
//   mixed dtypes of stage 2's small maps) a scalar path does the same
//   element by element.
// The wrapper (ops/conv_epilogue.py) checks that C is innermost, the
// dtypes and the shapes, and raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// the value rounded to T, and back to f32 (exact)
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) {
  return v;
}

struct Args {
  void* y;
  void* out;      // y itself, or an R output where R != T
  const void* bias;
  const void* residual;
  int64_t n;      // elements
  int c;          // channels, the innermost axis
  int relu;
};

template <typename R>
__device__ __forceinline__ R from_float(float v);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// y as an R: itself where T == R
template <typename R, typename T>
__device__ __forceinline__ R keep(T y) {
  return from_float<R>(to_float(y));
}
template <>
__device__ __forceinline__ bf16 keep<bf16, bf16>(bf16 y) { return y; }
template <>
__device__ __forceinline__ float keep<float, float>(float y) { return y; }

// One element: the chain of the file's comment, y of type T, the
// residual and the result of type R. Where no add changes y (T == R
// then) and the ReLU keeps it, y is returned as it is, bits and all.
template <typename T, typename R>
__device__ __forceinline__ R finish(T y, bool has_b, T b, bool has_res,
                                    R r, bool relu) {
  float v = to_float(y);
  R out;
  if (has_b || has_res) {
    if (has_b) v = round_to(v + to_float(b), (const T*)nullptr);
    if (has_res) v = round_to(v + to_float(r), (const R*)nullptr);
    out = from_float<R>(v);
  } else {
    out = keep<R>(y);
  }
  if (relu && !isnan(v)) out = from_float<R>(fmaxf(v, 0.f));
  return out;
}

// 16 bytes of T, loaded and stored as one uint4
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T& operator[](int e) {
    return reinterpret_cast<T*>(&raw)[e];
  }
};

// Vector path: C % Vec<T>::kN == 0 and every pointer 16-byte aligned.
// Thread t of block b takes vectors (b * kUnroll + k) * kThreads + t.
template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
epilogue_vec(Args a) {
  typedef Vec<T> V;
  const Index nv = (Index)(a.n / V::kN);
  const Index cv = (Index)(a.c / V::kN);
  uint4* y = reinterpret_cast<uint4*>(a.y);
  const uint4* res = reinterpret_cast<const uint4*>(a.residual);
  const uint4* bias = reinterpret_cast<const uint4*>(a.bias);
  const bool has_b = bias != nullptr, has_res = res != nullptr;
  const Index base = (Index)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  V yv[kUnroll], rv[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Index i = base + (Index)k * kThreads;
    if (i < nv) {
      yv[k].raw = y[i];
      rv[k].raw = has_res ? res[i] : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Index i = base + (Index)k * kThreads;
    if (i >= nv) continue;
    const Index ch = i % cv;
    V bv;
    bv.raw = has_b ? __ldg(bias + ch) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < V::kN; ++e) {
      yv[k][e] = finish<T, T>(yv[k][e], has_b, bv[e], has_res, rv[k][e],
                              a.relu != 0);
    }
    y[i] = yv[k].raw;
  }
}

// Scalar path: any C, any alignment of the element types; out may be y.
template <typename T, typename R, typename Index>
__global__ void __launch_bounds__(kThreads)
epilogue_scalar(Args a) {
  const Index n = (Index)a.n;
  const Index c = (Index)a.c;
  const T* y = reinterpret_cast<const T*>(a.y);
  R* out = reinterpret_cast<R*>(a.out);
  const R* res = reinterpret_cast<const R*>(a.residual);
  const T* bias = reinterpret_cast<const T*>(a.bias);
  const bool has_b = bias != nullptr, has_res = res != nullptr;
  const Index base = (Index)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  T yv[kUnroll];
  R rv[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Index i = base + (Index)k * kThreads;
    if (i < n) {
      yv[k] = y[i];
      rv[k] = has_res ? res[i] : R();
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Index i = base + (Index)k * kThreads;
    if (i >= n) continue;
    const Index ch = i % c;
    out[i] = finish<T, R>(yv[k], has_b, has_b ? bias[ch] : T(), has_res,
                          rv[k], a.relu != 0);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int vec = 16 / (int)sizeof(T);
  const bool vector = sizeof(T) == sizeof(R) && a.out == a.y &&
                      a.c % vec == 0 && aligned16(a.y) &&
                      aligned16(a.bias) && aligned16(a.residual);
  const int64_t units = vector ? a.n / vec : a.n;
  const int64_t per_block = (int64_t)kThreads * kUnroll;
  const int64_t blocks = (units + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const bool narrow = units + per_block < ((int64_t)1 << 32);
  dim3 grid((unsigned)blocks), block(kThreads);
  if (vector && narrow) {
    epilogue_vec<T, uint32_t><<<grid, block, 0, stream>>>(a);
  } else if (vector) {
    epilogue_vec<T, uint64_t><<<grid, block, 0, stream>>>(a);
  } else if (narrow) {
    epilogue_scalar<T, R, uint32_t><<<grid, block, 0, stream>>>(a);
  } else {
    epilogue_scalar<T, R, uint64_t><<<grid, block, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs the epilogue on `stream`; returns the CUDA error of the launch
// (0 = launched). y: n elements of dtype (0 = bf16, 1 = f32),
// channels-last with c channels innermost; bias: c values of dtype, or
// null; residual: n values of out_dtype laid out as y, or null; out: n
// values of out_dtype laid out as y, y itself where out_dtype == dtype.
// out_dtype differs from dtype only as (bf16, f32).
int rrnet_conv_epilogue(void* y, const void* bias, const void* residual,
                        void* out, long long n, int c, int dtype,
                        int out_dtype, int relu, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || n % c != 0) return (int)cudaErrorInvalidValue;
  if ((dtype == out_dtype) != (out == y)) return (int)cudaErrorInvalidValue;
  Args a{y, out, bias, residual, (int64_t)n, c, relu};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0) return (int)launch<bf16, bf16>(a, s);
  if (dtype == 1 && out_dtype == 1) return (int)launch<float, float>(a, s);
  if (dtype == 0 && out_dtype == 1) return (int)launch<bf16, float>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
