// Batched fused bottleneck adapter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_adapter_batched.py:65
// (fused_adapter_batched, pallas_call at :89): per batch row,
//
//     y = x + act(LN(x . A_hat)) . B_hat
//
// x [B, T, d]; A_hat [B, d, b] or shared [d, b]; B_hat [B, b, d] or shared
// [b, d], all in one dtype (bf16 or fp32); LN affines [B, b] or [b] fp32.
// A shared operand takes a batch stride of 0. LN runs over b with the
// population variance and eps 1e-6; act is gelu in its tanh form or the
// identity; use_ln = 0 with the identity is the LoRA route.
//
// Numerics are kernels/ref.py's (the oracle the JAX package holds its
// kernels to, and the path JAX takes off the TPU): fp32 throughout and ONE
// rounding to x's dtype at the end. The Pallas body instead casts h to x's
// dtype before the up-projection and adds the residual in x's dtype -- a
// choice made for the TPU's matrix unit, not part of the function.
//
// Bound on the H100: bytes. At decode (T = 1) each slot is a GEMV pair that
// must read its 2*d*b A_hat/B_hat values (~256 KB per slot in bf16 at
// d=1024, b=64) for 4*d*b flops; at prefill it is a small grouped GEMM,
// still under the flop/byte ridge at these T.
//
// Design (simple and right first; no wgmma, no TMA): one block per
// (T-tile of TT rows, batch row).
//   1. h = x . A_hat, fp32: thread (s, c) sums d-slice s of column c for
//      every token of the tile (A_hat reads coalesced along c), the slices
//      are reduced in shared memory in a fixed order -> h [TT, b] in smem.
//   2. LN over b (two-pass mean / population variance) and the fp32
//      affine, one warp per token row (shuffle reductions).
//   3. gelu (tanh form) or identity, in place.
//   4-5. y = h . B_hat and the residual add: each thread owns output
//      columns e (B_hat, x and out coalesced along e), fp32 accumulation,
//      one rounding to x's dtype.
// The [TT, b] intermediate never leaves shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    fused_adapter_kernel(const Scalar* __restrict__ x,
                         const Scalar* __restrict__ a,
                         const Scalar* __restrict__ bm,
                         const float* __restrict__ ls,
                         const float* __restrict__ lb, Scalar* __restrict__ out,
                         int T, int d, int nb, long long a_bs, long long b_bs,
                         long long ln_bs, int use_ln, int act) {
  __shared__ float s_part[kThreads * TT];  // [S][TT][nb] partial sums
  __shared__ float s_h[TT * kMaxB];        // [TT][nb]

  const long long row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int nt = min(TT, T - t0);
  const Scalar* xr = x + (row * T + t0) * static_cast<long long>(d);
  Scalar* outr = out + (row * T + t0) * static_cast<long long>(d);
  const Scalar* ar = a + row * a_bs;
  const Scalar* br = bm + row * b_bs;
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
      const float av = ld(ar + static_cast<long long>(i) * nb + c);
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
    if (use_ln) {
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
      for (int c = lane; c < nb; c += 32)
        hr[c] = (hr[c] - mu) * rs * lsr[c] + lbr[c];
    }
    if (act == 1) {
      __syncwarp();
      for (int c = lane; c < nb; c += 32) hr[c] = gelu_tanh(hr[c]);
    }
  }
  __syncthreads();

  // 4-5. up-projection + residual, one rounding to x's dtype
  for (int e = tid; e < d; e += kThreads) {
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.0f;
    for (int c = 0; c < nb; ++c) {
      const float bv = ld(br + static_cast<long long>(c) * d + e);
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
cudaError_t launch(const void* x, const void* a, const void* b,
                   const float* ls, const float* lb, void* out, int B, int T,
                   int d, int nb, long long a_bs, long long b_bs,
                   long long ln_bs, int use_ln, int act,
                   cudaStream_t stream) {
  const Scalar* xp = static_cast<const Scalar*>(x);
  const Scalar* ap = static_cast<const Scalar*>(a);
  const Scalar* bp = static_cast<const Scalar*>(b);
  Scalar* op = static_cast<Scalar*>(out);
  if (T == 1) {
    dim3 grid(1, static_cast<unsigned>(B));
    fused_adapter_kernel<Scalar, 1><<<grid, kThreads, 0, stream>>>(
        xp, ap, bp, ls, lb, op, T, d, nb, a_bs, b_bs, ln_bs, use_ln, act);
  } else {
    dim3 grid(static_cast<unsigned>((T + kTileT - 1) / kTileT),
              static_cast<unsigned>(B));
    fused_adapter_kernel<Scalar, kTileT><<<grid, kThreads, 0, stream>>>(
        xp, ap, bp, ls, lb, op, T, d, nb, a_bs, b_bs, ln_bs, use_ln, act);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, A_hat, B_hat and out): 0 = fp32, 1 = bf16. Strides are in
// elements; 0 broadcasts a shared operand to every row.
// act: 0 = identity, 1 = gelu (tanh form). ls / lb are read only under
// use_ln, so the LoRA route (use_ln = 0) may pass null for both.
// Returns the launch's cudaError_t.
extern "C" int xpeft_fused_adapter_batched(
    const void* x, const void* a, const void* b, const void* ls,
    const void* lb, void* out, int B, int T, int d, int nb, long long a_bs,
    long long b_bs, long long ln_bs, int dtype, int use_ln, int act,
    void* stream) {
  if (B < 1 || B > 65535 || T < 1 || d < 1 || nb < 1 || nb > kMaxB)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lsp = static_cast<const float*>(ls);
  const float* lbp = static_cast<const float*>(lb);
  cudaError_t err;
  if (dtype == 1)
    err = launch<__nv_bfloat16>(x, a, b, lsp, lbp, out, B, T, d, nb, a_bs,
                                b_bs, ln_bs, use_ln, act, s);
  else if (dtype == 0)
    err = launch<float>(x, a, b, lsp, lbp, out, B, T, d, nb, a_bs, b_bs,
                        ln_bs, use_ln, act, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
