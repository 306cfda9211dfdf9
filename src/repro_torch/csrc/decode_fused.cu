// T=1 decode megakernel for Hopper (sm_90a): one whole decoder block and
// the X-PEFT adapter, for every slot, in ONE cooperative launch per layer.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_fused.py:219
// (decode_block_pallas, pallas_call at :274), whose math is
// decode_block_row (:73). Per slot b, at position pos[b]:
//
//   h = RMSNorm1(x);  q, k, v = h.Wq (+bq), h.Wk (+bk), h.Wv (+bv)
//   q, k = RoPE(q, k at pos);  the new K/V row substituted at s == pos
//   o = softmax(mask(softcap(q.K^T * scale)), k_pos <= pos) . V
//   x1 = x + o.Wo;  h = RMSNorm2(x1);  x2 = x1 + (silu(h.Wg) * h.Wu).Wd
//   adapter "bf16":  y = x2 + act(LN(x2.A_hat)).B_hat;  "none": y = x2
//   adapter "int8"/"int4":  the same with A_hat/B_hat dequantized from
//                           their quantized slot records (dequant.cuh)
//
// and returns y and the new K/V rows (the caller scatters them into the
// cache after the launch, so the cache read here is the old one). The
// variants qwen1.5-0.5b does not use (layernorm, a vanilla MLP, other
// activations, no RoPE, fp32) are refused by the wrapper.
//
// Numerics are decode_block_row's, the oracle the Pallas kernel is held
// to bitwise: fp32 sums, rounded to bf16 after each norm, after each
// projection (q, k, v, o.Wo, g, u, m.Wd), at the bias add (the bias itself
// cast to bf16 first), after RoPE (fp32, no FMA contraction), at the
// softmax weights before w.V, at w.V, at silu(g) and at silu(g)*u, at each
// residual add, and on route bf16 in the adapter at h (before B_hat) and
// at y. The adapter's LN and activation stay fp32. Routes int8/int4 keep
// the adapter fp32 end to end, as decode_block_row's quantized branch
// does: x2's bf16 value times the exact dequantized A, h NOT rounded
// before B, and ONE rounding of x2 + y (not rnd(x2 + rnd(y))). Route
// bf16 differs on purpose from the port's fused_adapter.cu, which follows
// kernels/ref.py's fused-adapter numerics (fp32 inside, one rounding): at
// bf16 the fused and composed decode paths differ by design, by about a
// bf16 step per rounding point.
// The RoPE frequency table 1/theta^(2i/hd) comes from the wrapper, made by
// the same PyTorch expression as the plain version.
//
// Bound on the H100: bytes. One layer-step must read the layer's weights
// once (4*d^2 + 3*d*ff bf16 = 25.7 MB at qwen1.5-0.5b), the slots' K/V
// rows (1 MB at B=4, S=128) and their A_hat/B_hat (1 MB in bf16, ~0.5 MB
// in int8, ~0.28 MB in int4): ~28 MB, ~8 us at 3.35 TB/s, against ~2
// flops per weight byte for B=4 slots.
//
// Design (simple and right first; no wgmma, no TMA). The TPU grid (B,) --
// one program per slot, each streaming all the weights -- would run 4
// blocks on 132 SMs and read the weights B times. Instead every block of
// a persistent cooperative grid (as many blocks as are co-resident) takes
// tasks from each phase in turn, phases separated by grid.sync():
//   1. RMSNorm1 of the B rows (recomputed by each block into shared
//      memory), then QKV in tiles of 16 output columns: each weight
//      element is read once and used for all B slots.
//   2. attention, one (slot, head) item per block: RoPE, the substituted
//      row, the scaled, capped and masked logits, the fp32 softmax, w.V;
//      the first head of each KV group writes the slot's K/V rows.
//   3. out-projection tiles + the residual.
//   4. RMSNorm2 (per block), gate and up tiles, silu(g)*u.
//   5. down-projection tiles + the residual (the output for route none).
//   6. adapter down x2.A_hat (per slot; tiles of 16 bottleneck columns).
//   7. LN over b (population variance, eps 1e-6), the affine, gelu (tanh
//      form) or identity, then .B_hat tiles + the residual.
// A GEMV tile runs 256 threads as 2 column vectors (16 bytes, 8 bf16) x
// 128 k-lanes; on routes int8/int4 the adapter's tiles read each 8-column
// vector as 8 bytes (int8) or 8 nibbles of one half of a planar int4 row
// and widen it in registers (gemv_tile_q); partial sums are reduced by
// warp shuffles and across warps in shared memory in a fixed order, so
// results do not vary between runs.
// Intermediates between phases live in an fp32 scratch buffer that the
// wrapper allocates (read with plain loads: it is written in this launch).
// grid.sync() builds without relocatable device code (-rdc) under CUDA 12.
// The C entry point launches only with cudaLaunchCooperativeKernel, on a
// grid no larger than the occupancy API allows: a grid barrier in a plain
// launch can hang.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;              // output columns per GEMV task
constexpr int kKLanes = kThreads / 2;  // two 8-column vectors per row
constexpr float kNegInf = -2.0e38f;
constexpr float kNormEps = 1e-6f;
enum Route { kNone = 0, kBf16 = 1, kInt8 = 2, kInt4 = 3 };

struct Args {
  const bf16* x;       // [B, d]
  const int* pos;      // [B]
  const float* n1;     // [d]
  const float* n2;     // [d]
  const bf16* wq;      // [d, H*hd]
  const bf16* wk;      // [d, KV*hd]
  const bf16* wv;      // [d, KV*hd]
  const bf16* wo;      // [H*hd, d]
  const float* bq;     // [H*hd] (unused without bias)
  const float* bk;     // [KV*hd]
  const float* bv;     // [KV*hd]
  const bf16* wg;      // [d, ff]
  const bf16* wu;      // [d, ff]
  const bf16* wd;      // [ff, d]
  const bf16* kc;      // [B, S, KV, hd]
  const bf16* vc;      // [B, S, KV, hd]
  const bf16* a_hat;   // [B, d, nb], batch stride a_bs
  const bf16* b_hat;   // [B, nb, d], batch stride b_bs
  const float* ln_s;   // [B, nb], batch stride ln_bs
  const float* ln_b;
  long long a_bs, b_bs, ln_bs;
  const uint8_t* a_q;  // routes int8/int4: [B, d, nb | nb/2], stride aq_bs
  const __half* a_s;   // [B, d, a_groups], stride as_bs
  const uint8_t* b_q;  // [B, nb, d | d/2], stride bq_bs
  const __half* b_s;   // [B, nb, b_groups], stride bs_bs
  long long aq_bs, as_bs, bq_bs, bs_bs;
  int a_groups, b_groups;
  const float* inv_freq;  // [hd/2]
  bf16* y;             // [B, d]
  bf16* k_row;         // [B, KV, hd]
  bf16* v_row;
  float* scratch;      // see the layout at the top of the kernel
  int B, d, H, KV, hd, ff, S, nb;
  int qkv_bias, adapter, gelu;
  float cap, scale;
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ldf(const bf16* p) { return bf(*p); }
__device__ __forceinline__ float ldf(const float* p) { return *p; }
// round to bf16 and back: the value a bf16 tensor would hold
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide sum / max; every thread gets the same value (fixed order).
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

__device__ __forceinline__ float gelu_tanh(float h) {
  const float kC = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * h * (1.0f + tanhf(kC * (h + 0.044715f * h * h * h)));
}

// out[b, :] = RMSNorm(x[b, :]) * (1 + scale), rounded to bf16, for b < B;
// rows B..NB-1 are zero. out is [NB, d] in shared memory.
template <int NB, typename In>
__device__ void rmsnorm_rows(const In* x, const float* scale, float* out,
                             int B, int d, float* red) {
  for (int b = 0; b < NB; ++b) {
    float* o = out + b * d;
    if (b >= B) {
      for (int i = threadIdx.x; i < d; i += kThreads) o[i] = 0.0f;
      continue;
    }
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = ldf(x + static_cast<long long>(b) * d + i);
      o[i] = v;
      ss += v * v;
    }
    const float var = __fdiv_rn(block_sum(ss, red), static_cast<float>(d));
    const float r = rsqrtf(var + kNormEps);
    for (int i = threadIdx.x; i < d; i += kThreads)
      o[i] = rnd(__fmul_rn(__fmul_rn(o[i], r), __fadd_rn(1.0f, scale[i])));
  }
  __syncthreads();
}

// out[b, :] = src[b, :] for b < B (a [B, K] fp32 scratch row block), zero
// for B <= b < NB.
template <int NB>
__device__ void load_rows(const float* src, int K, float* out, int B) {
  for (int i = threadIdx.x; i < NB * K; i += kThreads)
    out[i] = i < B * K ? src[i] : 0.0f;
  __syncthreads();
}

template <int R>
__device__ __forceinline__ void fma_row(float (&acc)[R][8], uint4 raw,
                                        const float* in, int K, int k) {
  const bf16* w = reinterpret_cast<const bf16*>(&raw);
  float wf[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wf[j] = bf(w[j]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float hr = in[r * K + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(hr, wf[j], acc[r][j]);
  }
}

// The reduction that ends every GEMV tile: the 16 k-lanes of each column
// vector in a warp by shuffles, then the warps in shared memory in a
// fixed order. acc: this thread's [R][8] partial sums of columns
// (tid & 1) * 8 .. +7 of the tile.
template <int R>
__device__ void tile_reduce(float (&acc)[R][8], float* part, float* out) {
  const int tid = threadIdx.x;
  const int vec = tid & 1;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[r][j];
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][j] = v;
    }
  if (lane < 2) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[(warp * R + r) * kTile + vec * 8 + j] = acc[r][j];
  }
  __syncthreads();
  for (int o = tid; o < R * kTile; o += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += part[w * R * kTile + o];
    out[o] = s;
  }
  __syncthreads();
}

// out[r, c] = sum_k in[r, k] * W[k, c0 + c] for r < R, c < kTile, in fp32.
// in: [R, K] in shared memory; W: [K, N] bf16 row-major, 16-byte aligned
// rows (N % 8 == 0), read once. part: [kWarps, R, kTile] and out: [R,
// kTile] in shared memory. Every thread of the block must call it.
template <int R>
__device__ void gemv_tile(const float* in, int K, const bf16* W, int N,
                          int c0, float* part, float* out) {
  const int tid = threadIdx.x;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;

  const bf16* wp = W + c0 + (tid & 1) * 8;
  int k = tid >> 1;
  for (; k + 3 * kKLanes < K; k += 4 * kKLanes) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      raw[u] = __ldg(reinterpret_cast<const uint4*>(
          wp + static_cast<long long>(k + u * kKLanes) * N));
#pragma unroll
    for (int u = 0; u < 4; ++u) fma_row<R>(acc, raw[u], in, K, k + u * kKLanes);
  }
  for (; k < K; k += kKLanes)
    fma_row<R>(acc,
               __ldg(reinterpret_cast<const uint4*>(
                   wp + static_cast<long long>(k) * N)),
               in, K, k);
  tile_reduce<R>(acc, part, out);
}

// gemv_tile over a quantized W (routes int8/int4): each thread's 8-column
// vector of row k is one 8-byte load, widened in registers to exact fp32
// values (dequant.cuh). W.n % 16 == 0 and 8-byte aligned rows; the
// wrapper checks.
template <int R>
__device__ void gemv_tile_q(const float* in, int K, const xpeft::QMat& W,
                            int c0, float* part, float* out) {
  const int tid = threadIdx.x;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;

  const int c = c0 + (tid & 1) * 8;
  int sidx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sidx[j] = (c + j) / W.g;
  for (int k = tid >> 1; k < K; k += kKLanes) {
    float wf[8];
    xpeft::qmat_load8(W, k, c, sidx, wf);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float hr = in[r * K + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(hr, wf[j], acc[r][j]);
    }
  }
  tile_reduce<R>(acc, part, out);
}

// The adapter's hidden row for one slot: LN over nb (population variance),
// the fp32 affine, gelu (tanh form) or identity -> out, rounded to bf16 on
// route bf16 (round_bf16) and left fp32 on the quantized routes.
__device__ void adapter_hidden(const float* hh, const float* ls,
                               const float* lb, int nb, int gelu,
                               int round_bf16, float* out, float* red) {
  const int tid = threadIdx.x;
  const float v = tid < nb ? hh[tid] : 0.0f;
  const float mu = __fdiv_rn(block_sum(v, red), static_cast<float>(nb));
  const float dv = tid < nb ? __fsub_rn(v, mu) : 0.0f;
  const float var =
      __fdiv_rn(block_sum(__fmul_rn(dv, dv), red), static_cast<float>(nb));
  const float r = rsqrtf(var + 1e-6f);
  if (tid < nb) {
    float t = __fadd_rn(__fmul_rn(__fmul_rn(dv, r), ls[tid]), lb[tid]);
    if (gelu) t = gelu_tanh(t);
    out[tid] = round_bf16 ? rnd(t) : t;
  }
  __syncthreads();
}

__host__ __device__ inline int vec_floats(int NB, int d, int nq, int ff,
                                          int hd, int S) {
  int kmax = d > nq ? d : nq;
  kmax = kmax > ff ? kmax : ff;
  const int attn = 3 * hd + S + kThreads;
  return NB * kmax > attn ? NB * kmax : attn;
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 2) decode_block_kernel(Args p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int B = p.B, d = p.d, hd = p.hd, S = p.S;
  const int nq = p.H * hd, nkv = p.KV * hd, nqkv = nq + 2 * nkv;

  float* s_vec = smem;  // GEMV input rows, or the attention item's buffers
  float* s_part = s_vec + vec_floats(NB, d, nq, p.ff, hd, S);
  float* s_out = s_part + kWarps * NB * kTile;  // [2, NB, kTile]
  float* s_red = s_out + 2 * NB * kTile;        // [kWarps]

  float* g_qkv = p.scratch;             // [B, nq + 2 nkv] q|k|v, bf16 values
  float* g_o = g_qkv + B * nqkv;        // [B, nq] attention output
  float* g_x1 = g_o + B * nq;           // [B, d] after the attention residual
  float* g_act = g_x1 + B * d;          // [B, ff] silu(g) * u
  float* g_x2 = g_act + B * p.ff;       // [B, d] after the MLP residual
  float* g_hh = g_x2 + B * d;           // [B, nb] adapter x2 . A_hat, fp32

  // 1. RMSNorm1 + QKV (+ bias)
  {
    const int tq = nq / kTile, tkv = nkv / kTile, ntask = tq + 2 * tkv;
    if (blockIdx.x < ntask) rmsnorm_rows<NB>(p.x, p.n1, s_vec, B, d, s_red);
    for (int t = blockIdx.x; t < ntask; t += gridDim.x) {
      const bf16* W = p.wq;
      const float* bias = p.bq;
      int N = nq, c0 = t * kTile, off = 0;
      if (t >= tq + tkv) {
        W = p.wv, bias = p.bv, N = nkv, c0 = (t - tq - tkv) * kTile;
        off = nq + nkv;
      } else if (t >= tq) {
        W = p.wk, bias = p.bk, N = nkv, c0 = (t - tq) * kTile, off = nq;
      }
      gemv_tile<NB>(s_vec, d, W, N, c0, s_part, s_out);
      for (int o = tid; o < B * kTile; o += kThreads) {
        const int b = o / kTile, c = c0 + o % kTile;
        float v = rnd(s_out[o]);
        if (p.qkv_bias) v = rnd(v + rnd(bias[c]));
        g_qkv[b * nqkv + off + c] = v;
      }
    }
  }
  grid.sync();

  // 2. attention, one (slot, head) item at a time
  {
    const int G = p.H / p.KV, half = hd / 2;
    const int ngrp = kThreads / hd;
    const long long srow = static_cast<long long>(p.KV) * hd;
    float* sq = s_vec;
    float* sk = sq + hd;
    float* sv = sk + hd;
    float* lg = sv + hd;     // [S] logits, then the softmax weights
    float* op = lg + S;      // [kThreads] w.V partials
    const int warp = tid >> 5, lane = tid & 31;
    for (int it = blockIdx.x; it < B * p.H; it += gridDim.x) {
      const int b = it / p.H, h = it % p.H, kvh = h / G;
      const int pos = p.pos[b];
      const float* qkv = g_qkv + b * nqkv;
      if (tid < hd) {
        const float* qh = qkv + h * hd;
        const float* kh = qkv + nq + kvh * hd;
        const int i = tid < half ? tid : tid - half;
        const float ang = __fmul_rn(static_cast<float>(pos), p.inv_freq[i]);
        const float cs = cosf(ang), sn = sinf(ang);
        float qr, kr;
        if (tid < half) {
          qr = __fsub_rn(__fmul_rn(qh[i], cs), __fmul_rn(qh[i + half], sn));
          kr = __fsub_rn(__fmul_rn(kh[i], cs), __fmul_rn(kh[i + half], sn));
        } else {
          qr = __fadd_rn(__fmul_rn(qh[i], sn), __fmul_rn(qh[i + half], cs));
          kr = __fadd_rn(__fmul_rn(kh[i], sn), __fmul_rn(kh[i + half], cs));
        }
        sq[tid] = rnd(qr);
        sk[tid] = rnd(kr);
        sv[tid] = qkv[nq + nkv + kvh * hd + tid];
        if (h % G == 0) {
          const long long r = (static_cast<long long>(b) * p.KV + kvh) * hd;
          p.k_row[r + tid] = __float2bfloat16_rn(sk[tid]);
          p.v_row[r + tid] = __float2bfloat16_rn(sv[tid]);
        }
      }
      __syncthreads();

      const bf16* kb = p.kc + (static_cast<long long>(b) * S * p.KV + kvh) * hd;
      const bf16* vb = p.vc + (static_cast<long long>(b) * S * p.KV + kvh) * hd;
      for (int s = warp; s < S; s += kWarps) {
        float acc = 0.0f;
        if (s == pos) {
          for (int j = lane; j < hd; j += 32) acc = fmaf(sq[j], sk[j], acc);
        } else {
          const bf16* kr = kb + s * srow;
          for (int j = lane; j < hd; j += 32)
            acc = fmaf(sq[j], bf(__ldg(kr + j)), acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) {
          float l = __fmul_rn(acc, p.scale);
          if (p.cap > 0.0f) l = __fmul_rn(tanhf(__fdiv_rn(l, p.cap)), p.cap);
          lg[s] = s <= pos ? l : kNegInf;
        }
      }
      __syncthreads();

      float m = kNegInf;
      for (int s = tid; s < S; s += kThreads) m = fmaxf(m, lg[s]);
      m = block_max(m, s_red);
      float sum = 0.0f;
      for (int s = tid; s < S; s += kThreads) {
        const float e = expf(__fsub_rn(lg[s], m));
        lg[s] = e;
        sum += e;
      }
      sum = block_sum(sum, s_red);
      for (int s = tid; s < S; s += kThreads) lg[s] = rnd(__fdiv_rn(lg[s], sum));
      __syncthreads();

      const int j = tid % hd, g = tid / hd;
      float acc = 0.0f;
      if (g < ngrp)
        for (int s = g; s < S; s += ngrp) {
          const float val = s == pos ? sv[j] : bf(__ldg(vb + s * srow + j));
          acc = fmaf(lg[s], val, acc);
        }
      op[tid] = acc;
      __syncthreads();
      if (tid < hd) {
        float o = 0.0f;
        for (int gg = 0; gg < ngrp; ++gg) o += op[gg * hd + tid];
        g_o[b * nq + h * hd + tid] = rnd(o);
      }
      __syncthreads();
    }
  }
  grid.sync();

  // 3. out-projection + residual
  {
    const int ntask = d / kTile;
    if (blockIdx.x < ntask) load_rows<NB>(g_o, nq, s_vec, B);
    for (int t = blockIdx.x; t < ntask; t += gridDim.x) {
      const int c0 = t * kTile;
      gemv_tile<NB>(s_vec, nq, p.wo, d, c0, s_part, s_out);
      for (int o = tid; o < B * kTile; o += kThreads) {
        const int b = o / kTile, c = c0 + o % kTile;
        g_x1[b * d + c] = rnd(bf(p.x[b * d + c]) + rnd(s_out[o]));
      }
    }
  }
  grid.sync();

  // 4. RMSNorm2 + gate/up + silu(g) * u
  {
    const int ntask = p.ff / kTile;
    if (blockIdx.x < ntask) rmsnorm_rows<NB>(g_x1, p.n2, s_vec, B, d, s_red);
    for (int t = blockIdx.x; t < ntask; t += gridDim.x) {
      const int c0 = t * kTile;
      gemv_tile<NB>(s_vec, d, p.wg, p.ff, c0, s_part, s_out);
      gemv_tile<NB>(s_vec, d, p.wu, p.ff, c0, s_part, s_out + NB * kTile);
      for (int o = tid; o < B * kTile; o += kThreads) {
        const int b = o / kTile, c = c0 + o % kTile;
        const float g = rnd(s_out[o]);
        const float u = rnd(s_out[NB * kTile + o]);
        const float a = rnd(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
        g_act[b * p.ff + c] = rnd(__fmul_rn(a, u));
      }
    }
  }
  grid.sync();

  // 5. down-projection + residual
  {
    const int ntask = d / kTile;
    if (blockIdx.x < ntask) load_rows<NB>(g_act, p.ff, s_vec, B);
    for (int t = blockIdx.x; t < ntask; t += gridDim.x) {
      const int c0 = t * kTile;
      gemv_tile<NB>(s_vec, p.ff, p.wd, d, c0, s_part, s_out);
      for (int o = tid; o < B * kTile; o += kThreads) {
        const int b = o / kTile, c = c0 + o % kTile;
        const float v = rnd(g_x1[b * d + c] + rnd(s_out[o]));
        if (p.adapter)
          g_x2[b * d + c] = v;
        else
          p.y[b * d + c] = __float2bfloat16_rn(v);
      }
    }
  }
  if (!p.adapter) return;  // uniform over the grid: no block is left waiting
  grid.sync();

  // the slots' quantized records (routes int8/int4): slot b's A is
  // [d, nb], its B [nb, d], at the batch strides
  const bool quant = p.adapter == kInt8 || p.adapter == kInt4;
  const int int4 = p.adapter == kInt4;
  auto qa = [&](int b) {
    return xpeft::QMat{p.a_q + b * p.aq_bs, p.a_s + b * p.as_bs, p.nb,
                       p.a_groups, p.nb / p.a_groups, int4};
  };
  auto qb = [&](int b) {
    return xpeft::QMat{p.b_q + b * p.bq_bs, p.b_s + b * p.bs_bs, d,
                       p.b_groups, d / p.b_groups, int4};
  };

  // 6. adapter down: hh[b] = x2[b] . A_hat[b], fp32
  {
    const int tpb = p.nb / kTile, ntask = B * tpb;
    for (int t = blockIdx.x; t < ntask; t += gridDim.x) {
      const int b = t / tpb, c0 = (t % tpb) * kTile;
      for (int i = tid; i < d; i += kThreads) s_vec[i] = g_x2[b * d + i];
      __syncthreads();
      if (quant)
        gemv_tile_q<1>(s_vec, d, qa(b), c0, s_part, s_out);
      else
        gemv_tile<1>(s_vec, d, p.a_hat + b * p.a_bs, p.nb, c0, s_part,
                     s_out);
      if (tid < kTile) g_hh[b * p.nb + c0 + tid] = s_out[tid];
    }
  }
  grid.sync();

  // 7. LN, activation, up-projection . B_hat + residual
  {
    const int tpb = d / kTile, ntask = B * tpb;
    int cur = -1;
    for (int t = blockIdx.x; t < ntask; t += gridDim.x) {
      const int b = t / tpb, c0 = (t % tpb) * kTile;
      if (b != cur) {
        adapter_hidden(g_hh + b * p.nb, p.ln_s + b * p.ln_bs,
                       p.ln_b + b * p.ln_bs, p.nb, p.gelu, !quant, s_vec,
                       s_red);
        cur = b;
      }
      if (quant)
        gemv_tile_q<1>(s_vec, p.nb, qb(b), c0, s_part, s_out);
      else
        gemv_tile<1>(s_vec, p.nb, p.b_hat + b * p.b_bs, d, c0, s_part,
                     s_out);
      if (tid < kTile) {
        const int c = c0 + tid;
        const float x2 = g_x2[b * d + c];
        p.y[b * d + c] = __float2bfloat16_rn(
            quant ? __fadd_rn(x2, s_out[tid]) : rnd(x2 + rnd(s_out[tid])));
      }
    }
  }
}

long long smem_bytes(int NB, int d, int nq, int ff, int hd, int S) {
  return 4LL * (vec_floats(NB, d, nq, ff, hd, S) + kWarps * NB * kTile +
                2 * NB * kTile + kWarps);
}

template <int NB>
cudaError_t config(long long smem, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(decode_block_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_block_kernel<NB>, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  return cudaSuccess;
}

template <int NB>
cudaError_t launch(Args& a, int grid, long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_block_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decode_block_kernel<NB>), dim3(grid),
      dim3(kThreads), args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation that holds B slots (rows past B are zero and never
// stored): the engine's default of 4 slots, or up to 8.
int slot_bucket(int B) { return B < 1 ? 0 : B <= 4 ? 4 : B <= 8 ? 8 : 0; }

}  // namespace

// The co-resident grid (blocks per SM x SMs) of the instantiation for B
// slots at these shapes, with the dynamic shared memory it needs. Returns
// a cudaError_t (cudaErrorNotSupported without cooperative launch).
extern "C" int xpeft_decode_block_config(int B, int d, int H, int KV, int hd,
                                         int ff, int S, int* grid) {
  const int nb = slot_bucket(B);
  if (!nb || hd < 2 || kThreads % hd) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(nb, d, H * hd, ff, hd, S);
  if (smem > 232448) return cudaErrorInvalidValue;
  return static_cast<int>(nb == 4 ? config<4>(smem, grid)
                                   : config<8>(smem, grid));
}

// One cooperative launch of the decode block for B slots on `grid` blocks
// (from xpeft_decode_block_config). adapter: 0 = none, 1 = bf16 (a_hat,
// b_hat, strides a_bs/b_bs), 2 = int8, 3 = int4 (a_q/a_s/b_q/b_s with
// their strides and a_groups/b_groups scales per A/B row; dequant.cuh has
// the layouts); ln_s/ln_b on routes 1-3. gelu: 0 = identity, 1 = gelu
// (tanh form); cap <= 0 turns the softcap off. Every bf16 matrix has
// 16-byte aligned rows, every quantized row 8-byte aligned; the wrapper
// checks shapes, strides and alignment. Returns the launch's cudaError_t.
extern "C" int xpeft_decode_block(
    const void* x, const void* pos, const void* n1, const void* n2,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const void* bq, const void* bk, const void* bv, const void* wg,
    const void* wu, const void* wd, const void* kc, const void* vc,
    const void* a_hat, const void* b_hat, const void* ln_s, const void* ln_b,
    long long a_bs, long long b_bs, long long ln_bs, const void* inv_freq,
    void* y, void* k_row, void* v_row, void* scratch, int B, int d, int H,
    int KV, int hd, int ff, int S, int nb, int qkv_bias, int adapter,
    int gelu, float cap, float scale, const void* a_q, const void* a_s,
    const void* b_q, const void* b_s, long long aq_bs, long long as_bs,
    long long bq_bs, long long bs_bs, int a_groups, int b_groups, int grid,
    void* stream) {
  const int bucket = slot_bucket(B);
  const bool quant = adapter == kInt8 || adapter == kInt4;
  if (!bucket || grid < 1 || H % KV || hd < 2 || kThreads % hd ||
      d % kTile || (H * hd) % kTile || (KV * hd) % kTile || ff % kTile ||
      adapter < kNone || adapter > kInt4 ||
      (adapter && (nb % kTile || nb > kThreads)) ||
      (quant && (a_groups < 1 || b_groups < 1 || nb % a_groups ||
                 d % b_groups)))
    return cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.pos = static_cast<const int*>(pos);
  a.n1 = static_cast<const float*>(n1);
  a.n2 = static_cast<const float*>(n2);
  a.wq = static_cast<const bf16*>(wq);
  a.wk = static_cast<const bf16*>(wk);
  a.wv = static_cast<const bf16*>(wv);
  a.wo = static_cast<const bf16*>(wo);
  a.bq = static_cast<const float*>(bq);
  a.bk = static_cast<const float*>(bk);
  a.bv = static_cast<const float*>(bv);
  a.wg = static_cast<const bf16*>(wg);
  a.wu = static_cast<const bf16*>(wu);
  a.wd = static_cast<const bf16*>(wd);
  a.kc = static_cast<const bf16*>(kc);
  a.vc = static_cast<const bf16*>(vc);
  a.a_hat = static_cast<const bf16*>(a_hat);
  a.b_hat = static_cast<const bf16*>(b_hat);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.a_bs = a_bs;
  a.b_bs = b_bs;
  a.ln_bs = ln_bs;
  a.a_q = static_cast<const uint8_t*>(a_q);
  a.a_s = static_cast<const __half*>(a_s);
  a.b_q = static_cast<const uint8_t*>(b_q);
  a.b_s = static_cast<const __half*>(b_s);
  a.aq_bs = aq_bs, a.as_bs = as_bs, a.bq_bs = bq_bs, a.bs_bs = bs_bs;
  a.a_groups = a_groups, a.b_groups = b_groups;
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.y = static_cast<bf16*>(y);
  a.k_row = static_cast<bf16*>(k_row);
  a.v_row = static_cast<bf16*>(v_row);
  a.scratch = static_cast<float*>(scratch);
  a.B = B, a.d = d, a.H = H, a.KV = KV, a.hd = hd, a.ff = ff, a.S = S;
  a.nb = nb;
  a.qkv_bias = qkv_bias, a.adapter = adapter, a.gelu = gelu;
  a.cap = cap, a.scale = scale;
  const long long smem = smem_bytes(bucket, d, H * hd, ff, hd, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bucket == 4 ? launch<4>(a, grid, smem, s)
                                       : launch<8>(a, grid, smem, s));
}
