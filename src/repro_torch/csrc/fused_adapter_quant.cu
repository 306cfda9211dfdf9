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
// Pallas body's): every dequantized value is exact (xpeft::dequant, one
// __fmul_rn of the integer and its fp16 scale), every sum is fp32, h stays
// fp32 into the up-projection, and x + y is rounded ONCE to x's dtype.
//
// Bound on the H100: bytes. At decode (T = 1) each slot is a GEMV pair
// that must read its quantized records: 2 * d * b bytes plus scales in
// int8 (~130 KB per slot at d = 1024, b = 64), about half that in int4,
// for 4 * d * b flops; at prefill a small grouped GEMM (T = 16, B = 4 is
// ~17 MFLOP), still far under the flop/byte ridge. The products stay on
// CUDA cores in fp32 at every T: a dequantized value is a 7-bit integer
// times an fp16 scale, up to 18 significant bits, exact neither in bf16
// nor in TF32, and a bf16 high/low split of h already pushed the served
// logits past chip_smoke.py's bound on fused_adapter.cu.
//
// Design: fused_adapter.cu's thread-block cluster, with the dequantization
// moved into the copy-in phase:
//
//   grid (CS, T-tiles, B), cluster (CS, 1, 1), 256 threads a block; block
//   r of a cluster owns ds = d / CS columns of x, y, A_hat's rows and
//   B_hat's columns.
//   0. It issues cp.async 16-byte copies of its x tile [TT, ds], its A_q
//      rows and their scales (first commit group), its B_q columns and
//      B_q's whole scale block [b, groups] (second group), all at once,
//      then loads the LN affines: one memory latency covers the block's
//      ~12-21 KB (d = 1024, b = 64, CS = 8). Each A value is dequantized
//      once, from shared memory, into an fp32 tile [ds, b]; the loops
//      walk the bytes in 4-byte words with no division per word (runtime
//      divisions cost ~2 us of a decode call). No dequantized A_hat/B_hat
//      reaches global memory.
//   1. Partial h_r = x[:, cols] . A_hat[cols, :] in fp32, thread (s, c)
//      summing sub-slice s of column c; the sub-slices added in order.
//   2. The block arrives at a cluster barrier, dequantizes its B values
//      into the same fp32 tile (A_hat's is no longer read) while its
//      peers catch up, waits, and sums the CS partials from distributed
//      shared memory IN RANK ORDER (no atomics: a run is deterministic)
//      into the full h [TT, b]; then applies LN and the activation
//      itself, one warp per token row.
//   3. y[:, cols] = h . B_hat[:, cols] in fp32, plus x, one rounding,
//      16-byte stores. At T = 1 the depth b is split over the block's
//      idle threads and the groups added in a fixed order.
//   4. A cluster barrier (arrive after step 2's remote reads, wait before
//      exit) so that no block leaves while a peer still reads its partial.
//
// Which columns a block owns. int8: the contiguous slice [r*ds, (r+1)*ds).
// Planar int4: byte i of a B_q row holds column i (low nibble) and column
// i + d/2 (high nibble), so block r owns the column pair-set
// [r*dh, (r+1)*dh) U [d/2 + r*dh, d/2 + (r+1)*dh), dh = ds / 2: bytes
// [r*dh, (r+1)*dh) of each B_q row hold exactly its columns, every byte
// is read by one block, and x, y and the A_q rows are two ranges per
// block. Contiguous int4 slices would have every B_q byte copied by two
// blocks of the cluster and half of each dropped; on an H100 the pair-set
// read 5% faster at T = 1 and the same at T = 16 (PERF.md). B_q's scale
// rows are copied whole (4 KB at d = 1024, b = 64, g = 32), so a slice
// need not be a whole number of scale groups.
//
// The wrapper's planner picks CS, 8 or else 16, so that each copied range
// is whole 16-byte vectors and the shared memory fits (the fp32 tile is
// the bulk: 32 KB at d = 1024, b = 64, CS = 8); it raises on a shape
// neither fits and never falls back to the plain version.
//
// Tile in two passes (NP = 2, int4 only). Where neither cluster fits
// whole -- gemma3-27b's d = 5376 in int4: at CS = 8 the fp32 tile alone
// is 168 KB and the block 244 KB (T = 1), at CS = 16 each pair-part is 168
// columns, 10.5 vectors of B_q bytes -- the planner takes CS = 8 with a
// tile of ONE pair-part [ds/2, b]: phase 1 dequantizes the rows of part 0,
// accumulates, then those of part 1, each thread carrying its sums across
// the parts in the same row order; phase 3 dequantizes B's low nibbles
// and writes the columns of part 0, then the high nibbles and part 1.
// Every product, sum and their order are those of the whole tile, so the
// outputs are bitwise those of NP = 1 wherever both fit; the cost is the
// second dequantization's barrier and half the threads idle in phase 3's
// decode loop. Every shape that fits whole keeps NP = 1 and its cluster.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 256;    // bottleneck widths up to the block size
constexpr int kTileT = 16;    // tokens per block at T > 1
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in maximum per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC values of one 16-byte vector widened to fp32
template <typename Scalar>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  constexpr int VEC = 16 / sizeof(Scalar);
  const Scalar* v = reinterpret_cast<const Scalar*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(v[i]);
}

// VEC fp32 values rounded once (nearest even) into one 16-byte vector
__device__ __forceinline__ uint4 pack(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16) {
  uint4 raw;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16_rn(v[i]);
  return raw;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// The 4 values of one 32-bit word of quantized bytes: int8 byte i, or the
// int4 nibble of byte i at `shift` (0 low, 4 high), times its scale sc[i];
// each exact in fp32 (xpeft::dequant).
__device__ __forceinline__ float4 dequant4(uint32_t word, int int4,
                                           int shift, const float* sc) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned byte = (word >> (8 * i)) & 0xFFu;
    const int q = int4 ? static_cast<int>((byte >> shift) & 0xFu) - 8
                       : static_cast<int>(static_cast<int8_t>(byte));
    v[i] = xpeft::dequant(q, sc[i]);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The scales of columns c .. c+3 (c % 4 == 0) of a row whose scales are s,
// one per g columns: one scale load when g is a multiple of 4.
__device__ __forceinline__ void scales4(const __half* s, int c, int g,
                                        float* sc) {
  if ((g & 3) == 0) {
    const float v = __half2float(s[c / g]);
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = v;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = __half2float(s[(c + i) / g]);
  }
}

// Walks the 4-byte words tid*4, tid*4 + kThreads*4, ... of a [rows, pitch]
// byte matrix (pitch % 4 == 0), keeping (row, byte in row) without a
// division per word.
struct WordWalk {
  int row, col, drow, dcol, pitch;
  __device__ __forceinline__ WordWalk(int tid, int pitch_) : pitch(pitch_) {
    row = tid * 4 / pitch;
    col = tid * 4 % pitch;
    drow = kThreads * 4 / pitch;
    dcol = kThreads * 4 % pitch;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= pitch) {
      col -= pitch;
      ++row;
    }
  }
};

__host__ __device__ inline int up16(int n) { return (n + 15) & ~15; }

// Shared-memory layout of one block, in bytes; the same formula lives in
// kernels/fused_adapter_quant.py's smem_bytes. ds columns a block, nb the
// bottleneck, tt tokens a tile, esz x's element size, a_groups / b_groups
// scales per A_q / B_q row, np the passes over the fp32 tile (it holds
// ds / np of the block's columns).
struct Layout {
  int x, aq, as, bq, bs, w, part, h, ln, red, total;
};

__host__ __device__ inline Layout layout(int ds, int nb, int tt, int esz,
                                         int int4, int a_groups,
                                         int b_groups, int np) {
  Layout l;
  l.x = 0;
  l.aq = up16(tt * ds * esz);
  l.as = l.aq + up16(ds * (int4 ? nb / 2 : nb));
  l.bq = l.as + up16(ds * a_groups * 2);
  l.bs = l.bq + up16(nb * (int4 ? ds / 2 : ds));
  l.w = l.bs + up16(nb * b_groups * 2);  // B_q's whole scale block
  l.part = l.w + ds / np * nb * 4;        // fp32 A_hat, then B_hat, tile
  l.h = l.part + tt * nb * 4;
  l.ln = l.h + tt * nb * 4;
  l.red = l.ln + 2 * nb * 4;
  // phase 1's sub-slice partials, then at T = 1 phase 3's bottleneck-group
  // partials (at most kThreads vectors)
  int red = (kThreads / nb) * tt * nb;
  if (tt == 1 && kThreads * (16 / esz) > red) red = kThreads * (16 / esz);
  l.total = l.red + 4 * red;
  return l;
}

// Whether every range that a block of a cluster of cs copies is whole
// 16-byte vectors. Its columns form one range (int8: the slice) or two
// (int4: the pair-set) of w = d / parts columns; w % 16 == 0 makes x's
// ranges, the A_q rows and scales over them and each B_q row's bytes whole
// vectors; nb % 8 == 0 makes B_q's scale block whole vectors and keeps each
// 4-byte word of quantized bytes in one row. The planner mirrors it.
inline bool ranges_whole(int d, int nb, int int4, int cs) {
  const int parts = int4 ? 2 * cs : cs;
  return d % parts == 0 && nb % 8 == 0 && (d / parts) % 16 == 0;
}

template <typename Scalar, int TT, int NP>
__global__ void __launch_bounds__(kThreads)
    fused_adapter_quant_kernel(const Scalar* __restrict__ x,
                               const uint8_t* __restrict__ aq,
                               const __half* __restrict__ as,
                               const uint8_t* __restrict__ bq,
                               const __half* __restrict__ bs,
                               const float* __restrict__ ls,
                               const float* __restrict__ lb,
                               Scalar* __restrict__ out, int T, int d, int nb,
                               int a_groups, int b_groups, long long aq_bs,
                               long long as_bs, long long bq_bs,
                               long long bs_bs, long long ln_bs, int int4,
                               int act) {
  constexpr int VEC = 16 / sizeof(Scalar);
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = gridDim.x;
  const int r = blockIdx.x;  // the block's rank in its cluster
  const int nr = int4 ? 2 : 1;           // column ranges per block
  const int w = d / (nr * cs);           // columns per range
  const int ds = nr * w;                 // columns per block
  const int c0 = r * w;                  // first column of range 0
  const int c1 = d / 2 + r * w;          // ... of range 1 (int4)
  // local column j -> its column of d
  auto col = [&](int j) { return j < w ? c0 + j : c1 + (j - w); };
  const int qa = int4 ? nb / 2 : nb;     // bytes per A_q row
  const int qb = int4 ? w : ds;          // bytes per B_q row, this block's
  const int ga = nb / a_groups;          // columns per A / B scale group
  const int gb = d / b_groups;
  const int tw = ds / NP;                // the tile's columns of the block
  const Layout L = layout(ds, nb, TT, sizeof(Scalar), int4, a_groups,
                          b_groups, NP);
  Scalar* s_x = reinterpret_cast<Scalar*>(smem + L.x);
  uint8_t* s_aq = smem + L.aq;
  __half* s_as = reinterpret_cast<__half*>(smem + L.as);
  uint8_t* s_bq = smem + L.bq;
  __half* s_bs = reinterpret_cast<__half*>(smem + L.bs);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  float* s_part = reinterpret_cast<float*>(smem + L.part);
  float* s_h = reinterpret_cast<float*>(smem + L.h);
  float* s_ln = reinterpret_cast<float*>(smem + L.ln);  // scale, then bias
  float* s_red = reinterpret_cast<float*>(smem + L.red);

  const long long row = blockIdx.z;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  const Scalar* xr = x + (row * T + t0) * static_cast<long long>(d);
  Scalar* outr = out + (row * T + t0) * static_cast<long long>(d);
  const uint8_t* aqr = aq + row * aq_bs;
  const __half* asr = as + row * as_bs;
  const uint8_t* bqr = bq + row * bq_bs;
  const __half* bsr = bs + row * bs_bs;
  const float* lsr = ls + row * ln_bs;
  const float* lbr = lb + row * ln_bs;
  const int tid = threadIdx.x;

  // 0. every copy of the block in flight at once
  const int xv = w / VEC;  // 16-byte vectors of x per range and token
  for (int v = tid; v < TT * nr * xv; v += kThreads) {
    const int t = v / (nr * xv), j = (v % (nr * xv)) * VEC;
    cp_async16(s_x + t * ds + j,
               xr + static_cast<long long>(t < nt ? t : 0) * d + col(j),
               t < nt);
  }
  const int av = w * qa / 16;  // A_q bytes of a range, in vectors
  for (int v = tid; v < nr * av; v += kThreads) {
    const int k = v / av, o = (v % av) * 16;
    cp_async16(s_aq + k * w * qa + o,
               aqr + static_cast<long long>(k ? c1 : c0) * qa + o, true);
  }
  const int sv = w * a_groups / 8;  // A scales of a range, in vectors
  for (int v = tid; v < nr * sv; v += kThreads) {
    const int k = v / sv, o = (v % sv) * 8;
    cp_async16(s_as + k * w * a_groups + o,
               asr + static_cast<long long>(k ? c1 : c0) * a_groups + o,
               true);
  }
  cp_async_commit();
  // B_q row c: bytes [c0, c0 + qb) of its d (int8) or d/2 (int4) bytes
  const int bv = qb / 16;
  const long long bpitch = int4 ? d / 2 : d;
  for (int v = tid; v < nb * bv; v += kThreads) {
    const int c = v / bv, o = (v % bv) * 16;
    cp_async16(s_bq + c * qb + o, bqr + c * bpitch + c0 + o, true);
  }
  for (int v = tid; v < nb * b_groups / 8; v += kThreads)
    cp_async16(s_bs + v * 8, bsr + v * 8, true);
  cp_async_commit();
  // the LN affines (fp32, any alignment), loaded while the copies fly
  for (int c = tid; c < nb; c += kThreads) {
    s_ln[c] = lsr[c];
    s_ln[nb + c] = lbr[c];
  }
  cp_async_wait<1>();
  __syncthreads();

  // A_hat rows [r0, r0 + n) of the block into the fp32 tile [n, nb], each
  // value dequantized once. int4: byte m of a row holds columns m and
  // m + nb/2.
  auto dequant_a = [&](int r0, int n) {
    for (WordWalk it(tid, qa); it.row < n; it.next()) {
      const int j = r0 + it.row, m = it.col;
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(s_aq + j * qa + m);
      const __half* sr = s_as + j * a_groups;
      float* wr = s_w + it.row * nb;
      float sc[4];
      if (int4) {
        scales4(sr, m, ga, sc);
        *reinterpret_cast<float4*>(wr + m) = dequant4(word, 1, 0, sc);
        scales4(sr, qa + m, ga, sc);
        *reinterpret_cast<float4*>(wr + qa + m) = dequant4(word, 1, 4, sc);
      } else {
        sc[0] = sc[1] = sc[2] = sc[3] = __half2float(sr[0]);
        *reinterpret_cast<float4*>(wr + m) = dequant4(word, 0, 0, sc);
      }
    }
  };

  // 1. partial h over this block's columns -> s_part [TT][nb]: thread
  // (s, c) sums sub-slice s of column c for every token of the tile, over
  // the tile's rows of each pass in row order; the S sub-slices are then
  // added in order
  const int S = kThreads / nb;
  const int c_ = tid % nb;
  const int s_ = tid / nb;
  const int per_ = (ds + S - 1) / S;
  const int i0 = s_ * per_;
  const int i1 = min(ds, i0 + per_);
  float hacc[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) hacc[t] = 0.0f;
  for (int p = 0; p < NP; ++p) {
    if (p) __syncthreads();  // every read of the previous part is done
    dequant_a(p * tw, tw);
    __syncthreads();
    if (tid < S * nb) {
      // NP = 1: the whole sub-slice, bounds known at compile time
      const int lo = p * tw;
      const int i_lo = NP == 1 ? i0 : max(i0, lo);
      const int i_hi = NP == 1 ? i1 : min(i1, lo + tw);
      for (int i = i_lo; i < i_hi; ++i) {
        const float a_ = s_w[(i - lo) * nb + c_];
#pragma unroll
        for (int t = 0; t < TT; ++t)
          hacc[t] = fmaf(to_float(s_x[t * ds + i]), a_, hacc[t]);
      }
    }
  }
  if (tid < S * nb) {
#pragma unroll
    for (int t = 0; t < TT; ++t) s_red[(s_ * TT + t) * nb + c_] = hacc[t];
  }
  __syncthreads();  // also: every read of the A_hat tile is done
  for (int o = tid; o < TT * nb; o += kThreads) {
    float h = 0.0f;
    for (int s = 0; s < S; ++s) h += s_red[s * TT * nb + o];
    s_part[o] = h;
  }

  // B_hat [nb, tw] of pass p into the tile: int8 the block's slice; int4
  // both nibbles of its bytes (NP = 1: local columns k and w + k), or
  // nibble p alone (NP = 2: the columns of pair-part p)
  auto dequant_b = [&](int p) {
    for (WordWalk it(tid, qb); it.row < nb; it.next()) {
      const int c = it.row, k = it.col;
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(s_bq + c * qb + k);
      const __half* sr = s_bs + c * b_groups;
      float* wr = s_w + c * tw;
      float sc[4];
      if (int4 && NP == 2) {
        scales4(sr, (p ? c1 : c0) + k, gb, sc);
        *reinterpret_cast<float4*>(wr + k) = dequant4(word, 1, 4 * p, sc);
      } else if (int4) {
        scales4(sr, c0 + k, gb, sc);
        *reinterpret_cast<float4*>(wr + k) = dequant4(word, 1, 0, sc);
        scales4(sr, c1 + k, gb, sc);
        *reinterpret_cast<float4*>(wr + w + k) = dequant4(word, 1, 4, sc);
      } else {
        sc[0] = sc[1] = sc[2] = sc[3] = __half2float(sr[0]);
        *reinterpret_cast<float4*>(wr + k) = dequant4(word, 0, 0, sc);
      }
    }
  };

  // 2. publish the partial; dequantize B_hat (pass 0's columns) into the
  // tile while the peers catch up; then sum the cluster's partials in rank
  // order
  cluster_arrive();
  cp_async_wait<0>();
  __syncthreads();
  dequant_b(0);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  // every remote load issued before the first add: one distributed-
  // shared-memory latency per entry, not one per rank
#pragma unroll 2
  for (int o = tid; o < nt * nb; o += kThreads) {
    float part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < cs) part[q] = cluster.map_shared_rank(s_part, q)[o];
    float h = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < cs) h += part[q];
    s_h[o] = h;
  }
  cluster_arrive();  // this block is done reading its peers
  __syncthreads();

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
      float v = (hr[c] - mu) * rs * s_ln[c] + s_ln[nb + c];
      if (act == 1) v = gelu_tanh(v);
      hr[c] = v;
    }
  }
  __syncthreads();

  // 3. up-projection of this block's columns + residual, one rounding to
  // x's dtype
  auto finish = [&](int t, int j, float* acc) {
    float xs[VEC];
    unpack<Scalar>(*reinterpret_cast<const uint4*>(s_x + t * ds + j), xs);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = xs[i] + acc[i];
    *reinterpret_cast<uint4*>(outr + static_cast<long long>(t) * d +
                              col(j)) = pack(acc, Scalar());
  };
  // local columns j..j+VEC (in pass p's part) of row t over bottleneck
  // rows [c_lo, c_hi)
  auto up = [&](int t, int j, int p, int c_lo, int c_hi, float* acc) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int c = c_lo; c < c_hi; ++c) {
      const float hc = s_h[t * nb + c];
      const float4* bw =
          reinterpret_cast<const float4*>(s_w + c * tw + j - p * tw);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 b4 = bw[q];
        acc[4 * q] = fmaf(hc, b4.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(hc, b4.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(hc, b4.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(hc, b4.w, acc[4 * q + 3]);
      }
    }
  };
  const int ov = ds / VEC;   // output vectors per token
  const int ovp = ov / NP;   // ... per pass
  // pass p > 0: every read of the tile done, then its B_hat columns
  auto next_part = [&](int p) {
    if (p) {
      __syncthreads();
      dequant_b(p);
      __syncthreads();
    }
  };
  if constexpr (TT == 1) {
    // decode: one thread per vector would leave most of the block idle
    // over a depth of b, so thread (g, v) sums group g of the bottleneck
    // rows for vector v, and the G groups are then added in order
    const int G = ov < kThreads ? kThreads / ov : 1;
    const int per = (nb + G - 1) / G;
    for (int p = 0; p < NP; ++p) {
      next_part(p);
      for (int it = tid; it < G * ovp; it += kThreads) {
        const int g = it / ovp, v = p * ovp + it % ovp, j = v * VEC;
        float acc[VEC];
        up(0, j, p, min(nb, g * per), min(nb, g * per + per), acc);
        if (G == 1) {
          finish(0, j, acc);
        } else {
          // entry (g, v) of the G x ov partials; it itself when NP = 1
          const int e = NP == 1 ? it : g * ov + v;
#pragma unroll
          for (int i = 0; i < VEC; ++i) s_red[e * VEC + i] = acc[i];
        }
      }
    }
    if (G > 1) {
      __syncthreads();
      for (int v = tid; v < ov; v += kThreads) {
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = s_red[v * VEC + i];
#pragma unroll 4
        for (int g = 1; g < G; ++g)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[i] += s_red[(g * ov + v) * VEC + i];
        finish(0, v * VEC, acc);
      }
    }
  } else {
    for (int p = 0; p < NP; ++p) {
      next_part(p);
      for (int v = tid; v < nt * ovp; v += kThreads) {
        const int t = v / ovp, j = (p * ovp + v % ovp) * VEC;
        float acc[VEC];
        up(t, j, p, 0, nb, acc);
        finish(t, j, acc);
      }
    }
  }

  // 4. no block leaves while a peer may still read its s_part
  cluster_wait();
}

template <typename Scalar, int TT, int NP>
cudaError_t launch_tile(const void* x, const uint8_t* aq, const __half* as,
                        const uint8_t* bq, const __half* bs, const float* ls,
                        const float* lb, void* out, int B, int T, int d,
                        int nb, int a_groups, int b_groups, long long aq_bs,
                        long long as_bs, long long bq_bs, long long bs_bs,
                        long long ln_bs, int int4, int act, int cs,
                        cudaStream_t stream) {
  auto kernel = fused_adapter_quant_kernel<Scalar, TT, NP>;
  const Layout l = layout(d / cs, nb, TT, sizeof(Scalar), int4, a_groups,
                          b_groups, NP);
  if (l.total > kMaxSmem) return cudaErrorInvalidValue;
  // set once per instantiation: the opt-ins to > 48 KB and to 16 blocks
  static int smem_set = 0;
  static bool wide_set = false;
  cudaError_t err;
  if (l.total > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.total);
    if (err != cudaSuccess) return err;
    smem_set = l.total;
  }
  if (cs > 8 && !wide_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs),
                     static_cast<unsigned>((T + TT - 1) / TT),
                     static_cast<unsigned>(B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(l.total);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Scalar*>(x), aq, as, bq, bs, ls, lb,
      static_cast<Scalar*>(out), T, d, nb, a_groups, b_groups, aq_bs, as_bs,
      bq_bs, bs_bs, ln_bs, int4, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Scalar, int TT>
cudaError_t launch_passes(const void* x, const uint8_t* aq, const __half* as,
                          const uint8_t* bq, const __half* bs,
                          const float* ls, const float* lb, void* out, int B,
                          int T, int d, int nb, int a_groups, int b_groups,
                          long long aq_bs, long long as_bs, long long bq_bs,
                          long long bs_bs, long long ln_bs, int int4, int act,
                          int cs, int passes, cudaStream_t stream) {
  if (passes == 2)
    return launch_tile<Scalar, TT, 2>(x, aq, as, bq, bs, ls, lb, out, B, T,
                                      d, nb, a_groups, b_groups, aq_bs,
                                      as_bs, bq_bs, bs_bs, ln_bs, int4, act,
                                      cs, stream);
  return launch_tile<Scalar, TT, 1>(x, aq, as, bq, bs, ls, lb, out, B, T, d,
                                    nb, a_groups, b_groups, aq_bs, as_bs,
                                    bq_bs, bs_bs, ln_bs, int4, act, cs,
                                    stream);
}

template <typename Scalar>
cudaError_t launch(const void* x, const uint8_t* aq, const __half* as,
                   const uint8_t* bq, const __half* bs, const float* ls,
                   const float* lb, void* out, int B, int T, int d, int nb,
                   int a_groups, int b_groups, long long aq_bs,
                   long long as_bs, long long bq_bs, long long bs_bs,
                   long long ln_bs, int int4, int act, int cs, int passes,
                   cudaStream_t stream) {
  if (!ranges_whole(d, nb, int4, cs))
    return cudaErrorInvalidValue;
  if (T == 1)
    return launch_passes<Scalar, 1>(x, aq, as, bq, bs, ls, lb, out, B, T, d,
                                    nb, a_groups, b_groups, aq_bs, as_bs,
                                    bq_bs, bs_bs, ln_bs, int4, act, cs,
                                    passes, stream);
  return launch_passes<Scalar, kTileT>(x, aq, as, bq, bs, ls, lb, out, B, T,
                                       d, nb, a_groups, b_groups, aq_bs,
                                       as_bs, bq_bs, bs_bs, ln_bs, int4, act,
                                       cs, passes, stream);
}

}  // namespace

// dtype (of x and out): 0 = fp32, 1 = bf16. int4: 0 = int8 records, 1 =
// planar int4. a_groups / b_groups: scales per A row (of nb values) / per
// B row (of d values); 1 for int8. Strides are in elements of each
// operand (bytes for q, halves for scales, floats for LN). act: 0 =
// identity, 1 = gelu (tanh form). cluster: blocks per batch row and
// T-tile (8 or 16, the sizes the wrapper's planner chooses between); each
// copied range must be whole 16-byte vectors (ranges_whole) and x, the
// quantized rows, their scales, out and the batch strides 16-byte aligned.
// passes: 1 (the fp32 tile holds the block's columns) or, int4 only, 2 (it
// holds one pair-part at a time). Returns the launch's cudaError_t.
extern "C" int xpeft_fused_adapter_quant_batched(
    const void* x, const void* a_q, const void* a_s, const void* b_q,
    const void* b_s, const void* ls, const void* lb, void* out, int B, int T,
    int d, int nb, int a_groups, int b_groups, long long aq_bs,
    long long as_bs, long long bq_bs, long long bs_bs, long long ln_bs,
    int dtype, int int4, int act, int cluster, int passes, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || d < 1 || nb < 1 || nb > kMaxB ||
      a_groups < 1 || b_groups < 1 || nb % a_groups || d % b_groups ||
      (cluster != 8 && cluster != kMaxCluster) ||
      (passes != 1 && !(passes == 2 && int4)) ||
      (T + kTileT - 1) / kTileT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* aq = static_cast<const uint8_t*>(a_q);
  const auto* as = static_cast<const __half*>(a_s);
  const auto* bq = static_cast<const uint8_t*>(b_q);
  const auto* bs = static_cast<const __half*>(b_s);
  const float* lsp = static_cast<const float*>(ls);
  const float* lbp = static_cast<const float*>(lb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch<__nv_bfloat16>(x, aq, as, bq, bs, lsp, lbp, out, B, T, d,
                                nb, a_groups, b_groups, aq_bs, as_bs, bq_bs,
                                bs_bs, ln_bs, int4, act, cluster, passes,
                                s);
  else if (dtype == 0)
    err = launch<float>(x, aq, as, bq, bs, lsp, lbp, out, B, T, d, nb,
                        a_groups, b_groups, aq_bs, as_bs, bq_bs, bs_bs,
                        ln_bs, int4, act, cluster, passes, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
