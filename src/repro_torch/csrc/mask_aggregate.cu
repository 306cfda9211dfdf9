// Batched k-sparse adapter-bank aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mask_aggregate.py:74
// (mask_aggregate_batched, pallas_call at :102):
//
//     out[p] = sum_{j<k} w[p, j] * bank[idx[p, j]]      (fp32, in j order)
//
// bank [N, row] in bf16 or fp32 (row = d*b for A-hat, b*d for B-hat; serve
// admission folds the layer axis into N), idx int32 / w fp32 [P, k],
// out fp32 [P, row].
//
// Bound on the H100: bytes. Each term is one multiply-add per bank value
// read, ~0.5 flop per byte in bf16, far under the ~295 flop/byte ridge, so
// the time floor is the k selected rows of every profile-row read once plus
// the fp32 output written once.
//
// Design: one block row (grid.x) per output profile-row p; the block first
// loads its own idx[p, :] / w[p, :] into shared memory (the TPU kernel's
// scalar prefetch). Each thread owns VEC consecutive values of the row --
// one 16-byte load per selected row (8 bf16 or 4 fp32), neighbouring
// threads on neighbouring addresses -- and loops over j in order,
// accumulating in registers. Only the k selected rows are ever read. Each
// term is a rounded multiply then a rounded add (__fmul_rn/__fadd_rn, never
// contracted to an FMA), which is exactly the plain PyTorch version's
// arithmetic, so the two agree bit for bit. Padded profile-rows (idx 0,
// w 0) come out as exact zeros. An index outside [0, N) contributes nothing
// (nothing outside the bank is read). Rows must be a whole number of
// 16-byte vectors and the bank and output 16-byte aligned; the wrapper
// checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mask_aggregate_kernel(const T* __restrict__ bank,
                          const int* __restrict__ idx,
                          const float* __restrict__ w,
                          float* __restrict__ out, long long row, int k,
                          long long n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ int s_idx[kMaxK];
  __shared__ float s_w[kMaxK];
  const long long p = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_idx[j] = idx[p * k + j];
    s_w[j] = w[p * k + j];
  }
  __syncthreads();

  const long long e0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= row) return;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

  for (int j = 0; j < k; ++j) {
    const int r = s_idx[j];
    if (r < 0 || r >= n_rows) continue;
    const float wj = s_w[j];
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        bank + static_cast<long long>(r) * row + e0));
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] = __fadd_rn(acc[v], __fmul_rn(wj, to_float(vals[v])));
  }

  float* dst = out + p * row + e0;
#pragma unroll
  for (int v = 0; v < VEC; v += 4)
    *reinterpret_cast<float4*>(dst + v) =
        make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
}

template <typename T>
cudaError_t launch(const void* bank, const void* idx, const void* w,
                   void* out, long long row, int P, int k, long long n_rows,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (row % kVec) return cudaErrorInvalidValue;
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  const long long chunks = (row + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(chunks));
  mask_aggregate_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(bank), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), row, k,
      n_rows);
  return cudaGetLastError();
}

}  // namespace

// bank_dtype: 0 = fp32, 1 = bf16. row must be a multiple of 16 / itemsize
// and the bank and output 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int xpeft_mask_aggregate_batched(const void* bank, const void* idx,
                                            const void* w, void* out,
                                            long long row, int P, int k,
                                            long long n_rows, int bank_dtype,
                                            void* stream) {
  if (P < 1 || k < 0 || k > kMaxK || row < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bank_dtype == 1)
    err = launch<__nv_bfloat16>(bank, idx, w, out, row, P, k, n_rows, s);
  else if (bank_dtype == 0)
    err = launch<float>(bank, idx, w, out, row, P, k, n_rows, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
