// Batched k-sparse aggregation over a QUANTIZED adapter bank, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mask_aggregate_quant.py:48
// (mask_aggregate_quant_batched, pallas_call at :80):
//
//     out[p] = sum_{j<k} w[p, j] * dequant(bank[idx[p, j]])  (fp32, j order)
//
// A bank row is a [d, n] matrix of d sub-rows of n values: int8 q [N, d, n]
// with one fp16 scale per sub-row [N, d], or planar int4 q [N, d, n/2] with
// fp16 group scales [N, d, n/g] (dequant.cuh has the layouts). Serve
// admission folds the layer axis into N and runs this once for the A_hat
// side (sub-rows of b = 64) and once for the B_hat side (sub-rows of
// d = 1024). idx int32 / w fp32 [P, k]; out fp32 [P, d, n].
//
// Bound on the H100: bytes. Each term is one multiply-add per value, ~1
// flop per int8 byte (2 per int4 byte), far under the ridge, so the floor
// is the selected quantized rows and their scales read once plus the fp32
// output written once -- the output is now the larger share (4 bytes per
// value against 1 or 0.5 read per term, k-fold).
//
// Design: #1's (mask_aggregate.cu) with a dequant prologue. One block row
// (grid.x) per output profile-row p; the block loads its own idx[p, :] /
// w[p, :] into shared memory (the TPU kernel's scalar prefetch). Each
// thread owns 16 consecutive bytes of the flattened quantized row -- one
// 16-byte load per selected row, neighbouring threads on neighbouring
// addresses -- which widen in registers to 16 values (int8) or 16
// low-half and 16 high-half columns (int4). Where each byte sits (sub-row,
// column, scale index) is worked out once per thread, before the k loop;
// any even n and any group dividing it work, as long as a whole bank row
// is a number of 16-byte vectors. Where all of a thread's low (and high)
// values share one scale -- every thread at the serving shapes, whose
// sub-rows are whole 16-byte vectors and groups 16 or more wide -- the k
// loop loads that scale once per selected row instead of once per byte.
// The sum is carried in registers across k, in order (the TPU carried it
// across a sequential grid axis). Each term is a rounded multiply then a rounded add (__fmul_rn/__fadd_rn,
// never an FMA) and the dequantized value is exact, so the result equals
// the plain version bit for bit. Padded profile-rows (idx 0, w 0) come out
// as zeros; an index outside [0, N) contributes nothing.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;
constexpr int kBytes = 16;  // one 16-byte load per thread per selected row

template <int INT4>
__global__ void __launch_bounds__(kThreads)
    mask_aggregate_quant_kernel(const uint8_t* __restrict__ q,
                                const __half* __restrict__ scale,
                                const int* __restrict__ idx,
                                const float* __restrict__ w,
                                float* __restrict__ out, int d, int n,
                                int ngroups, int k, long long n_rows) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_w[kMaxK];
  const long long p = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_idx[j] = idx[p * k + j];
    s_w[j] = w[p * k + j];
  }
  __syncthreads();

  const int pitch = INT4 ? n / 2 : n;  // bytes per sub-row
  const long long row_bytes = static_cast<long long>(d) * pitch;
  const long long e0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x) *
      kBytes;
  if (e0 >= row_bytes) return;
  const int g = n / ngroups;
  const long long scales_per_row = static_cast<long long>(d) * ngroups;
  const int sub0 = static_cast<int>(e0 / pitch);
  const int col0 = static_cast<int>(e0 % pitch);

  // Where all of the thread's low (and high) values share one scale --
  // its 16 bytes in one sub-row and one group -- the k loop loads that
  // scale once per selected row; otherwise it works out each byte's
  // scale index as it goes. No per-byte index arrays: they would double
  // the registers and halve the blocks in flight.
  const bool uniform =
      col0 + kBytes <= pitch && col0 / g == (col0 + kBytes - 1) / g &&
      (!INT4 || (col0 + pitch) / g == (col0 + pitch + kBytes - 1) / g);
  const int s_lo0 = sub0 * ngroups + col0 / g;
  const int s_hi0 = sub0 * ngroups + (col0 + pitch) / g;

  float lo[kBytes], hi[kBytes];
#pragma unroll
  for (int i = 0; i < kBytes; ++i) lo[i] = hi[i] = 0.0f;

  for (int t = 0; t < k; ++t) {
    const int r = s_idx[t];
    if (r < 0 || r >= n_rows) continue;
    const float wt = s_w[t];
    const uint4 raw =
        __ldg(reinterpret_cast<const uint4*>(q + r * row_bytes + e0));
    const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
    const __half* s = scale + r * scales_per_row;
    float sl = 0.0f, sh = 0.0f;
    if (uniform) {
      sl = __half2float(__ldg(s + s_lo0));
      if (INT4) sh = __half2float(__ldg(s + s_hi0));
    }
    int sub = sub0, c = col0;
#pragma unroll
    for (int i = 0; i < kBytes; ++i) {
      if (!uniform) {
        sl = __half2float(__ldg(s + sub * ngroups + c / g));
        if (INT4)
          sh = __half2float(__ldg(s + sub * ngroups + (c + pitch) / g));
        if (++c == pitch) c = 0, ++sub;
      }
      const unsigned byte = (word[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      if (INT4) {
        const float vl =
            xpeft::dequant(static_cast<int>(byte & 0xFu) - 8, sl);
        const float vh = xpeft::dequant(static_cast<int>(byte >> 4) - 8, sh);
        lo[i] = __fadd_rn(lo[i], __fmul_rn(wt, vl));
        hi[i] = __fadd_rn(hi[i], __fmul_rn(wt, vh));
      } else {
        const float v = xpeft::dequant(
            static_cast<int>(static_cast<int8_t>(byte)), sl);
        lo[i] = __fadd_rn(lo[i], __fmul_rn(wt, v));
      }
    }
  }

  float* o = out + p * static_cast<long long>(d) * n;
  int r = sub0, c = col0;
#pragma unroll
  for (int i = 0; i < kBytes; ++i) {
    const long long at = static_cast<long long>(r) * n + c;
    o[at] = lo[i];
    if (INT4) o[at + pitch] = hi[i];
    if (++c == pitch) c = 0, ++r;
  }
}

}  // namespace

// q: int8 [n_rows, d, n] (int4 = 0) or planar int4 [n_rows, d, n/2]
// (int4 = 1); scale: fp16 [n_rows, d, ngroups] (ngroups = 1 for int8);
// idx int32 / w fp32 [P, k]; out fp32 [P, d, n]. A bank row (d sub-rows of
// quantized bytes) must be a whole number of 16-byte vectors and q
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int xpeft_mask_aggregate_quant_batched(
    const void* q, const void* scale, const void* idx, const void* w,
    void* out, int d, int n, int ngroups, int P, int k, long long n_rows,
    int int4, void* stream) {
  if (P < 1 || k < 0 || k > kMaxK || d < 1 || n < 1 || ngroups < 1 ||
      n % ngroups || (int4 && n % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(d) * (int4 ? n / 2 : n);
  if (row_bytes % kBytes) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(kThreads) * kBytes;
  const long long chunks = (row_bytes + per_block - 1) / per_block;
  if (chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const __half* sp = static_cast<const __half*>(scale);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (int4)
    mask_aggregate_quant_kernel<1><<<grid, kThreads, 0, s>>>(
        qp, sp, ip, wp, op, d, n, ngroups, k, n_rows);
  else
    mask_aggregate_quant_kernel<0><<<grid, kThreads, 0, s>>>(
        qp, sp, ip, wp, op, d, n, ngroups, k, n_rows);
  return static_cast<int>(cudaGetLastError());
}
