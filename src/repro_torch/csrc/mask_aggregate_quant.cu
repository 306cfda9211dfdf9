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
// Bound on the H100: bytes. The floor is the selected quantized rows and
// their scales read once plus the fp32 output written once (at admission,
// P = 96 and k = 50: ~235 MB of int8 rows, ~120 MB of int4, 25 MB out).
//
// The first port (one load and fold per thread per term, in a loop of k)
// ran at 2.5x (int8) and 4.9x (int4) that floor: one 16-byte load in
// flight per thread at a time. Its integer-to-float conversions (I2F, 16
// per clock per SM) were not what held it: a copy with them replaced ran
// as fast (tools/agg_quant_probe.py --no-i2f). The design, #1's
// (mask_aggregate.cu) with the rows widened in registers:
//
// - Terms of weight 0 and indices outside [0, N) are dropped (terms.cuh:
//   bitwise neutral, every dequantized value is finite); the block compacts
//   its own idx[p, :] / w[p, :] into shared memory in j order.
// - Each thread owns 16 consecutive bytes of the flattened quantized row
//   (16 int8 values, or 16 low-half and 16 high-half int4 columns) and
//   issues the 16-byte row loads and the scale loads of the next U kept
//   terms before it folds them. Block size and U come from the wrapper's
//   planner (kernels/mask_aggregate_quant.py, chosen by measurement).
// - Values are widened without I2F (dequant.cuh's dequant_byte): one byte
//   permute and one FFMA per value give float(q) * s exactly, so the fold
//   __fadd_rn(acc, __fmul_rn(w, q * s)) in j order stays bitwise the plain
//   version's, at ~5 instructions a value.
// - Where a thread's 16 bytes lie in one sub-row and one scale group (rows
//   of whole 16-byte vectors, int4 groups of a multiple of 16 columns:
//   every shape serving runs), each term loads one scale (two for int4)
//   and the output leaves in 16-byte stores; otherwise each byte finds its
//   own sub-row and scale, and stores go out one value at a time.
//
// What holds it now, measured at admission's shapes on an NVIDIA H100
// 80GB HBM3 at 700 W: the memory side. A copy whose fold is one XOR a
// term (the same loads, tools/agg_quant_probe.py --loads-only) takes
// ~80% of the kernel's time, and 1 to 16 loads in flight per thread
// change it by a few percent. Each term reads its row again where
// profile-rows of one layer share it (~4800 rows read for ~3600 distinct
// at P = 96, k = 50).
//
// Padded profile-rows (idx 0, w 0) come out as +0.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"
#include "terms.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxK = 1024;
constexpr int kBytes = 16;  // one 16-byte load per thread per kept term

// acc += w * v, a rounded multiply then a rounded add
__device__ __forceinline__ void fold1(float& acc, float wt, float v) {
  acc = __fadd_rn(acc, __fmul_rn(wt, v));
}

// One kept term whose 16 bytes share one scale per half (lo: the int8
// values or the int4 low nibbles; hi: the int4 high nibbles)
template <int INT4>
__device__ __forceinline__ void fold_uniform(float* lo, float* hi, float wt,
                                             const uint4& raw, float sl,
                                             float sh) {
  const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
  if (INT4) {
    const xpeft::Dequant dl = xpeft::dequant_scale<8, 0>(sl);
    const xpeft::Dequant dh = xpeft::dequant_scale<8, 4>(sh);
#pragma unroll
    for (int i = 0; i < kBytes; ++i) {
      const uint32_t wd = word[i >> 2];
      fold1(lo[i], wt, xpeft::dequant_byte(wd & 0x0F0F0F0Fu, i & 3, dl));
      fold1(hi[i], wt, xpeft::dequant_byte(wd & 0xF0F0F0F0u, i & 3, dh));
    }
  } else {
    const xpeft::Dequant dq = xpeft::dequant_scale<128, 0>(sl);
#pragma unroll
    for (int i = 0; i < kBytes; ++i)
      fold1(lo[i], wt,
            xpeft::dequant_byte(word[i >> 2] ^ 0x80808080u, i & 3, dq));
  }
}

// One kept term whose bytes cross sub-rows or scale groups: byte i sits
// at sub-row sub, column c (of the bytes' pitch), each found as it goes
template <int INT4>
__device__ __forceinline__ void fold_general(float* lo, float* hi, float wt,
                                             const uint4& raw,
                                             const __half* __restrict__ s,
                                             int sub, int c, int pitch,
                                             int ngroups, int g) {
  const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < kBytes; ++i) {
    const uint32_t wd = word[i >> 2];
    const float sl = __half2float(__ldg(s + sub * ngroups + c / g));
    if (INT4) {
      const float sh =
          __half2float(__ldg(s + sub * ngroups + (c + pitch) / g));
      fold1(lo[i], wt, xpeft::dequant_byte(wd & 0x0F0F0F0Fu, i & 3,
                                           xpeft::dequant_scale<8, 0>(sl)));
      fold1(hi[i], wt, xpeft::dequant_byte(wd & 0xF0F0F0F0u, i & 3,
                                           xpeft::dequant_scale<8, 4>(sh)));
    } else {
      fold1(lo[i], wt, xpeft::dequant_byte(wd ^ 0x80808080u, i & 3,
                                           xpeft::dequant_scale<128, 0>(sl)));
    }
    if (++c == pitch) c = 0, ++sub;
  }
}

// The kept term at s_idx[t] / s_w[t]: its row's 16 bytes at this thread's
// offset and, where they share one, its scales
struct Term {
  uint4 raw;
  __half sl, sh;
};

template <int INT4, bool UNIFORM>
__device__ __forceinline__ Term load_term(const uint8_t* __restrict__ qb,
                                          const __half* __restrict__ sb,
                                          int hi_off, unsigned row_bytes,
                                          unsigned scales_per_row, int r) {
  Term t;
  t.raw = __ldg(reinterpret_cast<const uint4*>(
      qb + static_cast<size_t>(r) * row_bytes));
  if (UNIFORM) {
    const __half* s = sb + static_cast<size_t>(r) * scales_per_row;
    t.sl = __ldg(s);
    if (INT4) t.sh = __ldg(s + hi_off);
  }
  return t;
}

// U kept terms' loads in flight per thread, held in registers
template <int INT4, int U, bool UNIFORM>
__global__ void __launch_bounds__(kMaxThreads)
    mask_aggregate_quant_kernel(const uint8_t* __restrict__ q,
                                const __half* __restrict__ scale,
                                const int* __restrict__ idx,
                                const float* __restrict__ w,
                                float* __restrict__ out, int d, int n,
                                int ngroups, int k, long long n_rows) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_w[kMaxK];
  __shared__ int s_count[kMaxThreads / 32];
  const long long p = blockIdx.x;
  const int nk =
      xpeft::compact_terms(idx, w, p, k, n_rows, s_idx, s_w, s_count);

  const int pitch = INT4 ? n / 2 : n;  // bytes per sub-row
  const unsigned row_bytes = static_cast<unsigned>(d) * pitch;
  const unsigned e0 = (blockIdx.y * blockDim.x + threadIdx.x) * kBytes;
  if (e0 >= row_bytes) return;
  const int g = n / ngroups;
  const unsigned scales_per_row = static_cast<unsigned>(d) * ngroups;
  const int sub0 = static_cast<int>(e0 / pitch);
  const int col0 = static_cast<int>(e0 % pitch);
  const int s_lo0 = sub0 * ngroups + col0 / g;
  const int s_hi0 = sub0 * ngroups + (col0 + pitch) / g;
  const uint8_t* qb = q + e0;
  const __half* sb = scale + s_lo0;

  float lo[kBytes], hi[INT4 ? kBytes : 1];
#pragma unroll
  for (int i = 0; i < kBytes; ++i) lo[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (INT4 ? kBytes : 1); ++i) hi[i] = 0.0f;

  auto fold = [&](const Term& t, int j) {
    const float wt = s_w[j];
    if (UNIFORM)
      fold_uniform<INT4>(lo, hi, wt, t.raw, __half2float(t.sl),
                         INT4 ? __half2float(t.sh) : 0.0f);
    else
      fold_general<INT4>(lo, hi, wt, t.raw,
                         scale + static_cast<size_t>(s_idx[j]) *
                                     scales_per_row,
                         sub0, col0, pitch, ngroups, g);
  };
  int j = 0;
  for (; j + U <= nk; j += U) {
    // issue the row and scale loads of the next U kept terms ...
    Term t[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      t[u] = load_term<INT4, UNIFORM>(qb, sb, s_hi0 - s_lo0, row_bytes,
                                      scales_per_row, s_idx[j + u]);
    // ... then fold them in j order
#pragma unroll
    for (int u = 0; u < U; ++u) fold(t[u], j + u);
  }
  for (; j < nk; ++j)
    fold(load_term<INT4, UNIFORM>(qb, sb, s_hi0 - s_lo0, row_bytes,
                                  scales_per_row, s_idx[j]),
         j);

  float* o = out + p * static_cast<long long>(d) * n;
  if (UNIFORM) {
    // 16 consecutive values per half, 16-byte aligned: 16-byte stores
    float* dst = o + static_cast<long long>(sub0) * n + col0;
#pragma unroll
    for (int i = 0; i < kBytes; i += 4) {
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(lo[i], lo[i + 1], lo[i + 2], lo[i + 3]);
      if (INT4)
        *reinterpret_cast<float4*>(dst + pitch + i) =
            make_float4(hi[i], hi[i + 1], hi[i + 2], hi[i + 3]);
    }
    return;
  }
  int r = sub0, c = col0;
#pragma unroll
  for (int i = 0; i < kBytes; ++i) {
    const long long at = static_cast<long long>(r) * n + c;
    o[at] = lo[i];
    if (INT4) o[at + pitch] = hi[i];
    if (++c == pitch) c = 0, ++r;
  }
}

template <int INT4, int U>
cudaError_t launch(const void* q, const void* scale, const void* idx,
                   const void* w, void* out, int d, int n, int ngroups, int P,
                   int k, long long n_rows, bool uniform, dim3 grid,
                   int threads, cudaStream_t s) {
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const __half* sp = static_cast<const __half*>(scale);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (uniform)
    mask_aggregate_quant_kernel<INT4, U, true><<<grid, threads, 0, s>>>(
        qp, sp, ip, wp, op, d, n, ngroups, k, n_rows);
  else
    mask_aggregate_quant_kernel<INT4, U, false><<<grid, threads, 0, s>>>(
        qp, sp, ip, wp, op, d, n, ngroups, k, n_rows);
  return cudaGetLastError();
}

template <int INT4>
cudaError_t launch_u(const void* q, const void* scale, const void* idx,
                     const void* w, void* out, int d, int n, int ngroups,
                     int P, int k, long long n_rows, bool uniform, dim3 grid,
                     int threads, int unroll, cudaStream_t s) {
  switch (unroll) {
    case 1:
      return launch<INT4, 1>(q, scale, idx, w, out, d, n, ngroups, P, k,
                             n_rows, uniform, grid, threads, s);
    case 2:
      return launch<INT4, 2>(q, scale, idx, w, out, d, n, ngroups, P, k,
                             n_rows, uniform, grid, threads, s);
    case 8:
      return launch<INT4, 8>(q, scale, idx, w, out, d, n, ngroups, P, k,
                             n_rows, uniform, grid, threads, s);
    case 16:
      return launch<INT4, 16>(q, scale, idx, w, out, d, n, ngroups, P, k,
                              n_rows, uniform, grid, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: int8 [n_rows, d, n] (int4 = 0) or planar int4 [n_rows, d, n/2]
// (int4 = 1); scale: fp16 [n_rows, d, ngroups] (ngroups = 1 for int8);
// idx int32 / w fp32 [P, k]; out fp32 [P, d, n], 16-byte aligned. A bank
// row (d sub-rows of quantized bytes) must be a whole number of 16-byte
// vectors and q 16-byte aligned. threads (per block): 64 or 128; unroll
// (loads in flight per thread): 1, 2, 8 or 16 -- the values the wrapper's
// planner chooses among. Returns the launch's cudaError_t.
extern "C" int xpeft_mask_aggregate_quant_batched(
    const void* q, const void* scale, const void* idx, const void* w,
    void* out, int d, int n, int ngroups, int P, int k, long long n_rows,
    int int4, int threads, int unroll, void* stream) {
  if (P < 1 || k < 0 || k > kMaxK || d < 1 || n < 1 || ngroups < 1 ||
      n % ngroups || (int4 && n % 2) || (threads != 64 && threads != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pitch = int4 ? n / 2 : n;
  const long long row_bytes = static_cast<long long>(d) * pitch;
  if (row_bytes % kBytes || row_bytes > 0x7fffffffLL ||
      static_cast<long long>(d) * ngroups > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(threads) * kBytes;
  const long long chunks = (row_bytes + per_block - 1) / per_block;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // every thread's 16 bytes in one sub-row and one scale group per half
  const bool uniform = pitch % kBytes == 0 && (n / ngroups) % kBytes == 0;
  const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      int4 ? launch_u<1>(q, scale, idx, w, out, d, n, ngroups, P, k, n_rows,
                         uniform, grid, threads, unroll, s)
           : launch_u<0>(q, scale, idx, w, out, d, n, ngroups, P, k, n_rows,
                         uniform, grid, threads, unroll, s);
  return static_cast<int>(err);
}
