// Batched k-sparse adapter-bank aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mask_aggregate.py:74
// (mask_aggregate_batched, pallas_call at :102), and at P = 1 the one-
// profile kernel src/repro/kernels/mask_aggregate.py:47 (mask_aggregate,
// pallas_call at :65):
//
//     out[p] = sum_{j<k} w[p, j] * bank[idx[p, j]]      (fp32, in j order)
//
// bank [N, row] in bf16 or fp32 (row = d*b for A-hat, b*d for B-hat; serve
// admission folds the layer axis into N), idx int32 / w fp32 [P, k],
// out fp32 [P, row].
//
// Bound on the H100: bytes. Each term is one multiply-add per bank value
// read, ~0.5 flop per byte in bf16, far under the ~295 flop/byte ridge, so
// the time floor is the selected rows of nonzero weight read once plus the
// fp32 output written once.
//
// What keeps it off that floor is latency, not bandwidth: a thread that
// loads one term, waits for it and folds it walks k memory latencies in a
// row, and by Little's law HBM needs about 2 MB in flight to run at rate.
// At one profile-row (P = 1, the one-profile entry point) or at short rows
// (the typed IA3 / prefix leaves) there are too few threads for one load
// each to get there. The design:
//
// - Terms of weight 0 are dropped, the rest kept in j order. The block
//   loads its own idx[p, :] / w[p, :] (the TPU kernel's scalar prefetch)
//   and compacts them into shared memory with one warp ballot per 32
//   terms. This changes no bit for finite bank values: the sum starts at
//   +0, a product with w = 0 is +-0, and adding +-0 to a sum that is never
//   -0 (round to nearest gives +0 for x + -x) leaves it as it is. An index
//   outside [0, N) is dropped too (nothing outside the bank is read).
// - Each thread owns VEC consecutive values of the row (one 16-byte load
//   per term: 8 bf16 or 4 fp32, neighbouring threads on neighbouring
//   addresses) and issues the loads of the next U terms before it folds
//   them, so U loads per thread are in flight, not one.
// - The block size and U come from the caller (the wrapper's planner,
//   chosen by measurement on the H100): 128 threads where that still gives
//   every SM a block (A-hat / B-hat and the prefix rows at P = 96), else
//   64; U = 32 where the grid holds fewer than 64 threads per SM (P = 1),
//   16 below 256 per SM (the IA3 rows), else 8. Staging 64 terms per
//   thread through shared memory with cp.async measured no faster than 32
//   in registers.
//
// Numerics: each kept term is a rounded multiply then a rounded add
// (__fmul_rn / __fadd_rn, never contracted into an FMA), in j order, which
// is exactly the plain PyTorch version's arithmetic: the two agree bit for
// bit. k is never split across threads and the sum never re-associated.
// Padded profile-rows (idx 0, w 0) come out as exact zeros. Rows must be a
// whole number of 16-byte vectors and the bank and output 16-byte aligned;
// the wrapper checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "terms.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxK = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc += w * vals, each a rounded multiply then a rounded add
template <typename T>
__device__ __forceinline__ void fold(float* acc, float wj, const uint4& raw) {
  constexpr int VEC = 16 / sizeof(T);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    acc[v] = __fadd_rn(acc[v], __fmul_rn(wj, to_float(vals[v])));
}

template <int VEC>
__device__ __forceinline__ void store_row(float* dst, const float* acc) {
#pragma unroll
  for (int v = 0; v < VEC; v += 4)
    *reinterpret_cast<float4*>(dst + v) =
        make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
}

// U loads in flight per thread, held in registers
template <typename T, int U>
__global__ void __launch_bounds__(kMaxThreads)
    mask_aggregate_kernel(const T* __restrict__ bank,
                          const int* __restrict__ idx,
                          const float* __restrict__ w,
                          float* __restrict__ out, long long row, int k,
                          long long n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ int s_idx[kMaxK];
  __shared__ float s_w[kMaxK];
  __shared__ int s_count[kMaxThreads / 32];
  const long long p = blockIdx.x;
  const int n =
      xpeft::compact_terms(idx, w, p, k, n_rows, s_idx, s_w, s_count);

  const long long e0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= row) return;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

  const T* col = bank + e0;
  for (int j = 0; j < n; j += U) {
    // issue the loads of the next U terms ...
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u < n)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            col + static_cast<long long>(s_idx[j + u]) * row));
    // ... then fold them in j order
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u < n) fold<T>(acc, s_w[j + u], raw[u]);
  }
  store_row<VEC>(out + p * row + e0, acc);
}

template <typename T, int U>
cudaError_t launch(const void* bank, const void* idx, const void* w,
                   void* out, long long row, int P, int k, long long n_rows,
                   int threads, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (row % kVec) return cudaErrorInvalidValue;
  const long long per_block = static_cast<long long>(threads) * kVec;
  const long long chunks = (row + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(chunks));
  mask_aggregate_kernel<T, U><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(bank), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), row, k,
      n_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_u(const void* bank, const void* idx, const void* w,
                     void* out, long long row, int P, int k, long long n_rows,
                     int threads, int unroll, cudaStream_t s) {
  switch (unroll) {
    case 8:
      return launch<T, 8>(bank, idx, w, out, row, P, k, n_rows, threads, s);
    case 16:
      return launch<T, 16>(bank, idx, w, out, row, P, k, n_rows, threads, s);
    case 32:
      return launch<T, 32>(bank, idx, w, out, row, P, k, n_rows, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bank_dtype: 0 = fp32, 1 = bf16. row must be a multiple of 16 / itemsize
// and the bank and output 16-byte aligned. threads (per block): 64 or 128;
// unroll (loads in flight per thread): 8, 16 or 32 -- the values the
// wrapper's planner chooses among.
// Returns the launch's cudaError_t.
extern "C" int xpeft_mask_aggregate_batched(const void* bank, const void* idx,
                                            const void* w, void* out,
                                            long long row, int P, int k,
                                            long long n_rows, int bank_dtype,
                                            int threads, int unroll,
                                            void* stream) {
  if (P < 1 || k < 0 || k > kMaxK || row < 1) return cudaErrorInvalidValue;
  if (threads != 64 && threads != 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bank_dtype == 1)
    err = launch_u<__nv_bfloat16>(bank, idx, w, out, row, P, k, n_rows,
                                  threads, unroll, s);
  else if (bank_dtype == 0)
    err = launch_u<float>(bank, idx, w, out, row, P, k, n_rows, threads,
                          unroll, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
