// Batched IA3 scaling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ia3_apply.py:45
// (ia3_apply_batched, pallas_call at :55): per batch row b,
//
//     y[b, t, :] = x[b, t, :] * (1 + s[b, :])
//
// x / y [B, T, d] in bf16 or fp32; s [B, d] with a batch stride (a layer
// slice of the engine's [B, L, d] slot buffer has stride L*d) or shared
// [d] (stride 0), in bf16 or fp32 whatever x's dtype.
//
// Numerics: fp32 inside -- (1 + s) rounded once (__fadd_rn), x times it
// rounded once (__fmul_rn, never contracted into an FMA), then one
// round-to-nearest-even to x's dtype. That is the plain version's exact
// arithmetic, so the two agree bit for bit, and s == 0 gives x bitwise
// (1 + 0 is 1 exactly, x * 1 is x exactly, and the cast back is exact).
//
// Bound on the H100: bytes (one multiply per element moved): x read once,
// y written once, s read once per batch row. At the serving path's shapes
// (B = 4, d = 1024; T = 1 at decode, T <= 16 at prefill) that is 24-270
// KB, well under a microsecond at 3.35 TB/s, so the launch sets the time.
//
// Design: a flat grid over the B*T*d/VEC 16-byte vectors of x, not the
// TPU kernel's (B, T/block_t) grid of VMEM tiles. Each thread loads one
// 16-byte vector of x (8 bf16 or 4 fp32 values) and the matching VEC
// values of s for its batch row (re-read by the row's T tokens from L1/L2),
// and stores one 16-byte vector of y. d must be a whole number of vectors,
// so that no vector spans two rows, and x, y and every row of s 16-byte
// aligned; the wrapper checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VEC consecutive values of s widened to fp32, read from an address
// aligned to VEC * sizeof(S) bytes (8, 16 or 32).
template <typename S, int VEC>
__device__ __forceinline__ void load_s(const S* __restrict__ p, float* out) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(S));
  if constexpr (kBytes == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const S* v = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(v[i]);
  } else {
    constexpr int kPer = 16 / static_cast<int>(sizeof(S));
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const S* v = reinterpret_cast<const S*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_float(v[i]);
    }
  }
}

template <typename X, typename S>
__global__ void __launch_bounds__(kThreads)
    ia3_apply_kernel(const X* __restrict__ x, const S* __restrict__ s,
                     X* __restrict__ y, long long n_vec, int T, int d,
                     long long s_stride) {
  constexpr int VEC = 16 / sizeof(X);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const long long e0 = i * VEC;
  const long long row = e0 / d;  // b * T + t
  const int col = static_cast<int>(e0 - row * d);
  const long long b = row / T;

  float sv[VEC];
  load_s<S, VEC>(s + b * s_stride + col, sv);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + e0));
  const X* xv = reinterpret_cast<const X*>(&raw);
  uint4 packed;
  X* yv = reinterpret_cast<X*>(&packed);
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    store(yv + v, __fmul_rn(to_float(xv[v]), __fadd_rn(1.0f, sv[v])));
  *reinterpret_cast<uint4*>(y + e0) = packed;
}

template <typename X, typename S>
cudaError_t launch(const void* x, const void* s, void* y, long long rows,
                   int T, int d, long long s_stride, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(X);
  if (d % kVec) return cudaErrorInvalidValue;
  const long long n_vec = rows * d / kVec;
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ia3_apply_kernel<X, S>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const X*>(x), static_cast<const S*>(s),
          static_cast<X*>(y), n_vec, T, d, s_stride);
  return cudaGetLastError();
}

template <typename X>
cudaError_t launch_x(const void* x, const void* s, void* y, long long rows,
                     int T, int d, long long s_stride, int s_dtype,
                     cudaStream_t stream) {
  if (s_dtype == 1)
    return launch<X, __nv_bfloat16>(x, s, y, rows, T, d, s_stride, stream);
  if (s_dtype == 0)
    return launch<X, float>(x, s, y, rows, T, d, s_stride, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// rows = B * T (x and y are [rows, d], contiguous); s_stride is the batch
// stride of s in elements (0 for a shared s). x_dtype (of x and y) and
// s_dtype: 0 = fp32, 1 = bf16. Returns the launch's cudaError_t.
extern "C" int xpeft_ia3_apply_batched(const void* x, const void* s, void* y,
                                       long long rows, int T, int d,
                                       long long s_stride, int x_dtype,
                                       int s_dtype, void* stream) {
  if (rows < 1 || T < 1 || rows % T || d < 1 || s_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1)
    err = launch_x<__nv_bfloat16>(x, s, y, rows, T, d, s_stride, s_dtype,
                                  st);
  else if (x_dtype == 0)
    err = launch_x<float>(x, s, y, rows, T, d, s_stride, s_dtype, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
