// Batched fused bottleneck adapter over QUANTIZED per-row records, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_adapter_quant.py:53
// (fused_adapter_quant_batched, pallas_call at :78): per batch row,
//
//     y = x + act(LN(x . dequant(A_q))) . dequant(B_q)
//
// x [B, T, d] bf16 or fp32; A_q int8 [B, d, b] with fp16 scales [B, d], or
// planar int4 [B, d, b/2] with [B, d, b/g]; B_q int8 [B, b, d] with [B, b],
// or int4 [B, b, d/2] with [B, b, d/g] (dequant.cuh has the layouts); LN
// affines [B, b] fp32. Each operand takes a batch stride, so one layer of
// the engine's [B, L, ...] slot buffers needs no copy. LN always runs:
// over b, population variance, eps 1e-6, then the fp32 affine; act is gelu
// in its tanh form or the identity.
//
// Numerics are kernels/ref.py's fused_adapter_quant_batched_ref (and the
// Pallas body's): the dequantized values are exact (dequant.cuh), every
// sum is fp32, h stays fp32, and x + y is rounded ONCE to x's dtype.
//
// Bound on the H100: bytes. At decode (T = 1) each slot is a GEMV pair
// that must read its quantized A_hat/B_hat records: 2 * d * b bytes plus
// scales in int8 (~128 KB per slot at d=1024, b=64), half that in int4,
// for 4 * d * b flops; at prefill a small grouped GEMM, still under the
// flop/byte ridge at these T.
//
// Design: fused_adapter.cu's (simple and right first; no wgmma, no TMA)
// with a dequant prologue on every weight read. One block per (T-tile of
// TT rows, batch row).
//   1. h = x . A, fp32: thread (s, c) sums d-slice s of column c for
//      every token of the tile, widening each A value from its quantized
//      byte or nibble in registers; the slices are reduced in shared
//      memory in a fixed order -> h [TT, b] in shared memory.
//   2. LN over b (two-pass mean / population variance) and the affine,
//      one warp per token row.
//   3. gelu (tanh form) or identity, in place.
//   4-5. y = h . B and the residual: each thread owns output columns e,
//      widening B values in registers, fp32 accumulation, one rounding.
// No dequantized A_hat/B_hat is ever written to memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 256;   // bottleneck widths up to the block size
constexpr int kTileT = 16;   // tokens per block at prefill

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float h) {
  const float kC = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * h * (1.0f + tanhf(kC * (h + 0.044715f * h * h * h)));
}

template <typename Scalar, int TT>
__global__ void __launch_bounds__(kThreads)
    fused_adapter_quant_kernel(const Scalar* __restrict__ x, xpeft::QMat a,
                               long long aq_bs, long long as_bs,
                               xpeft::QMat bm, long long bq_bs,
                               long long bs_bs, const float* __restrict__ ls,
                               const float* __restrict__ lb, long long ln_bs,
                               Scalar* __restrict__ out, int T, int d,
                               int act) {
  __shared__ float s_part[kThreads * TT];  // [S][TT][nb] partial sums
  __shared__ float s_h[TT * kMaxB];        // [TT][nb]

  const int nb = a.n;
  const long long row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int nt = min(TT, T - t0);
  const Scalar* xr = x + (row * T + t0) * static_cast<long long>(d);
  Scalar* outr = out + (row * T + t0) * static_cast<long long>(d);
  a.q += row * aq_bs;
  a.s += row * as_bs;
  bm.q += row * bq_bs;
  bm.s += row * bs_bs;
  const float* lsr = ls + row * ln_bs;
  const float* lbr = lb + row * ln_bs;
  const int tid = threadIdx.x;

  // 1. down-projection, d split into S slices per column
  const int S = kThreads / nb;
  if (tid < S * nb) {
    const int c = tid % nb;
    const int s = tid / nb;
    const int dper = (d + S - 1) / S;
    const int d0 = s * dper;
    const int d1 = min(d, d0 + dper);
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.0f;
    for (int i = d0; i < d1; ++i) {
      const float av = xpeft::qmat_at(a, i, c);
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (t < nt)
          acc[t] = fmaf(ld(xr + static_cast<long long>(t) * d + i), av,
                        acc[t]);
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) s_part[(s * TT + t) * nb + c] = acc[t];
  }
  __syncthreads();
  for (int o = tid; o < TT * nb; o += kThreads) {
    const int t = o / nb;
    const int c = o % nb;
    float h = 0.0f;
    for (int s = 0; s < S; ++s) h += s_part[(s * TT + t) * nb + c];
    s_h[o] = h;
  }
  __syncthreads();

  // 2-3. LN over b + affine, then the activation; one warp per token row
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int t = warp; t < nt; t += kThreads / 32) {
    float* hr = s_h + t * nb;
    float sum = 0.0f;
    for (int c = lane; c < nb; c += 32) sum += hr[c];
    const float mu = warp_sum(sum) / nb;
    float sq = 0.0f;
    for (int c = lane; c < nb; c += 32) {
      const float dl = hr[c] - mu;
      sq += dl * dl;
    }
    const float rs = rsqrtf(warp_sum(sq) / nb + 1e-6f);
    __syncwarp();
    for (int c = lane; c < nb; c += 32) {
      float v = (hr[c] - mu) * rs * lsr[c] + lbr[c];
      if (act == 1) v = gelu_tanh(v);
      hr[c] = v;
    }
  }
  __syncthreads();

  // 4-5. up-projection + residual, one rounding to x's dtype
  for (int e = tid; e < d; e += kThreads) {
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.0f;
    for (int c = 0; c < nb; ++c) {
      const float bv = xpeft::qmat_at(bm, c, e);
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = fmaf(s_h[t * nb + c], bv, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < TT; ++t)
      if (t < nt) {
        const long long o = static_cast<long long>(t) * d + e;
        st(outr + o, ld(xr + o) + acc[t]);
      }
  }
}

template <typename Scalar>
void launch(const void* x, const xpeft::QMat& a, long long aq_bs,
            long long as_bs, const xpeft::QMat& bm, long long bq_bs,
            long long bs_bs, const float* ls, const float* lb,
            long long ln_bs, void* out, int B, int T, int d, int act,
            cudaStream_t stream) {
  const Scalar* xp = static_cast<const Scalar*>(x);
  Scalar* op = static_cast<Scalar*>(out);
  if (T == 1) {
    dim3 grid(1, static_cast<unsigned>(B));
    fused_adapter_quant_kernel<Scalar, 1><<<grid, kThreads, 0, stream>>>(
        xp, a, aq_bs, as_bs, bm, bq_bs, bs_bs, ls, lb, ln_bs, op, T, d, act);
  } else {
    dim3 grid(static_cast<unsigned>((T + kTileT - 1) / kTileT),
              static_cast<unsigned>(B));
    fused_adapter_quant_kernel<Scalar, kTileT>
        <<<grid, kThreads, 0, stream>>>(xp, a, aq_bs, as_bs, bm, bq_bs,
                                        bs_bs, ls, lb, ln_bs, op, T, d, act);
  }
}

}  // namespace

// dtype (of x and out): 0 = fp32, 1 = bf16. int4: 0 = int8 records, 1 =
// planar int4. a_groups / b_groups: scales per A row (of nb values) / per
// B row (of d values); 1 for int8. Strides are in elements of each
// operand (bytes for q, halves for scales, floats for LN). act: 0 =
// identity, 1 = gelu (tanh form). Returns the launch's cudaError_t.
extern "C" int xpeft_fused_adapter_quant_batched(
    const void* x, const void* a_q, const void* a_s, const void* b_q,
    const void* b_s, const void* ls, const void* lb, void* out, int B, int T,
    int d, int nb, int a_groups, int b_groups, long long aq_bs,
    long long as_bs, long long bq_bs, long long bs_bs, long long ln_bs,
    int dtype, int int4, int act, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || d < 1 || nb < 1 || nb > kMaxB ||
      a_groups < 1 || b_groups < 1 || nb % a_groups || d % b_groups ||
      (int4 && (nb % 2 || d % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  xpeft::QMat a{static_cast<const uint8_t*>(a_q),
                static_cast<const __half*>(a_s), nb, a_groups,
                nb / a_groups, int4};
  xpeft::QMat bm{static_cast<const uint8_t*>(b_q),
                 static_cast<const __half*>(b_s), d, b_groups, d / b_groups,
                 int4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lsp = static_cast<const float*>(ls);
  const float* lbp = static_cast<const float*>(lb);
  if (dtype == 1)
    launch<__nv_bfloat16>(x, a, aq_bs, as_bs, bm, bq_bs, bs_bs, lsp, lbp,
                          ln_bs, out, B, T, d, act, s);
  else if (dtype == 0)
    launch<float>(x, a, aq_bs, as_bs, bm, bq_bs, bs_bs, lsp, lbp, ln_bs,
                  out, B, T, d, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
