// Batched fused bottleneck adapter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_adapter_batched.py:65
// (fused_adapter_batched, pallas_call at :89), and at B = 1 the unbatched
// kernel src/repro/kernels/fused_adapter.py:46 (fused_adapter, pallas_call
// at :58): per batch row,
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
// kernels to, and the path JAX takes off the TPU): fp32 throughout, h kept
// in fp32 into the up-projection, and ONE rounding to x's dtype at the end.
// The Pallas body instead casts h to x's dtype before the up-projection and
// adds the residual in x's dtype -- a choice made for the TPU's matrix
// unit, not part of the function.
//
// Bound on the H100: bytes. At decode (T = 1) each batch row is a GEMV pair
// that must read its 2*d*b A_hat/B_hat values (~256 KB per row in bf16 at
// d = 1024, b = 64) for 4*d*b flops; at prefill it is a small grouped GEMM,
// still far under the flop/byte ridge at these T.
//
// What keeps it off that floor: one block per (T-tile, batch row) would run
// 4 blocks at decode, each pulling 256 KB through one SM. The design spreads
// each batch row over a thread-block cluster and keeps every byte a block
// needs in flight at once:
//
//   grid (CS, T-tiles, B), cluster (CS, 1, 1), 256 threads a block. Block r
//   of a cluster owns the d-slice [r*ds, (r+1)*ds), ds = d / CS.
//   0. It issues cp.async 16-byte copies of its x tile [TT, ds], its A_hat
//      rows [ds, b] and its B_hat columns [b, ds] into shared memory, all at
//      once (two commit groups: x and A_hat first, B_hat second), then
//      loads the LN affines, so one memory latency covers the block's
//      ~8-64 KB.
//   1. Partial h_r = x[:, slice] . A_hat[slice, :] in fp32, into its shared
//      memory: on CUDA cores at T = 1 and for fp32 (slices of the rows
//      summed in a fixed order), on tensor cores (mma.sync m16n8k16,
//      bf16 in, fp32 accumulate: no rounding added, the inputs are bf16)
//      for bf16 at T > 1, one 16-row tile per cluster.
//   2. cluster barrier; every block sums the CS partials from distributed
//      shared memory IN RANK ORDER (no atomics: a run is deterministic) into
//      the full h [TT, b], then applies LN and the activation itself (one
//      warp per token row) -- cheaper than another cluster barrier at b=64.
//   3. y[:, slice] = h . B_hat[:, slice] on CUDA cores in fp32 (h stays
//      fp32, a depth of b), plus x, one rounding, 16-byte stores. At T = 1
//      the depth is split over the block's idle threads and the groups
//      added in a fixed order. (h split into bf16 high and low parts on
//      the tensor cores was faster at T > 1 but holds h only to ~2^-17 of
//      |h|, coarse enough to flip many more bf16 roundings than fp32 sums
//      do: the served logits drifted past chip_smoke.py's bound.)
//   4. A cluster barrier (arrive after step 2's remote reads, wait before
//      exit) so that no block leaves while a peer still reads its partial.
//
// The wrapper's planner picks CS, 8 or else 16 (the non-portable cluster
// size, taken where 8 blocks' slices overflow shared memory: in bf16 at
// d = 7168, and at d = 6144 for T > 1), so that ds is a whole number of
// 16-byte vectors (and of 16 for the tensor-core tile) and the shared
// memory fits; it raises on a shape neither fits and never falls back to
// the plain version.
//
// The hetero-adapter launch (xpeft_hetero_adapter_batched) runs a
// heterogeneous bank's per-layer composition in JAX's order,
//
//     y1 = x + act(LN(x . A_hat)) . B_hat      (bottleneck)
//     y2 = y1 + (y1 . A_lora) . B_lora         (LoRA: no LN, identity)
//     y  = y2 * (1 + s)                        (IA3)
//
// any two or three of them (or one), in ONE grid of (CS, T-tiles, B)
// clusters on the device code above: block r copies in, at once, its x
// tile, both matmul stages' A_hat rows and B_hat columns and s's slice, in
// commit groups in stage order, so the LoRA tiles land while the bottleneck
// computes. Each matmul stage is steps 1-3 unchanged, its partial h in a
// buffer of its own (a peer may still read the previous stage's partial
// when a block writes the next one; one cluster barrier per stage then
// suffices); its result, rounded once to x's dtype, overwrites block r's x
// tile in shared memory (y1[:, slice r] is all that block needs for the
// next stage's partial). The IA3 scale is the last stage's epilogue:
// __fmul_rn(y2, __fadd_rn(1, s)) rounded once, as csrc/ia3_apply.cu does.
// The sum orders, the cluster size and the roundings are those of the
// separate launches (#2, #2's LoRA route, #7), so where the wrapper's
// planner picks the cluster size each stage's own plan picks, the fused
// output equals theirs bit for bit. It replaces the TPU kernel #7's launch
// (src/repro/kernels/ia3_apply.py:45) on the hetero path: #7 moves 24 KB
// at decode, and its own launch was its whole time.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 256;    // bottleneck widths up to the block size
constexpr int kTileT = 16;    // tokens per block at T > 1 (one mma M tile)
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

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D = A . B + D for one 16x8 tile over a depth of 16: A 16x16 row-major,
// B 16x8 column-major, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared-memory layout of one block, in bytes; the same formula lives in
// kernels/fused_adapter_batched.py's planner. Rows of x and A_hat carry 16
// bytes of padding (conflict-free tensor-core fragment reads).
struct Layout {
  int ldx, lda;                          // padded row lengths, in elements
  int x, a, b, part, h, ln, red, total;  // offsets and total, in bytes
};

// fp32 scratch of the CUDA-core paths: step 1's sub-slice partials, then
// at T = 1 step 3's bottleneck-group partials (at most kThreads vectors)
__host__ __device__ inline int red_floats(int nb, int tt, int vec,
                                          bool mma) {
  if (mma) return 0;
  const int red = (kThreads / nb) * tt * nb;
  return tt == 1 && kThreads * vec > red ? kThreads * vec : red;
}

__host__ __device__ inline Layout layout(int ds, int nb, int tt, int esz,
                                         bool mma) {
  const int vec = 16 / esz;
  Layout l;
  l.ldx = ds + vec;
  l.lda = nb + vec;
  l.x = 0;
  l.a = l.x + tt * l.ldx * esz;
  l.b = l.a + ds * l.lda * esz;
  l.part = l.b + nb * ds * esz;
  l.h = l.part + tt * nb * 4;
  l.ln = l.h + tt * nb * 4;
  l.red = l.ln + 2 * nb * 4;
  l.total = l.red + 4 * red_floats(nb, tt, vec, mma);
  return l;
}

// ---- steps 0-3 of one adapter stage, shared by both launches ----

// 0. the x tile [TT, ds] of the block's slice (rows past nt zero-filled),
// row pitch ldx
template <typename Scalar, int TT>
__device__ __forceinline__ void copy_x(Scalar* s_x, int ldx,
                                       const Scalar* xr, int d, int c0,
                                       int ds, int nt) {
  constexpr int VEC = 16 / sizeof(Scalar);
  const int xv = ds / VEC;  // 16-byte vectors per slice row
  for (int v = threadIdx.x; v < TT * xv; v += kThreads) {
    const int t = v / xv, e = (v % xv) * VEC;
    cp_async16(s_x + t * ldx + e,
               xr + static_cast<long long>(t < nt ? t : 0) * d + c0 + e,
               t < nt);
  }
}

// 0. the slice's A_hat rows [ds, nb], row pitch lda
template <typename Scalar>
__device__ __forceinline__ void copy_a(Scalar* s_a, int lda,
                                       const Scalar* ar, int ds, int nb) {
  constexpr int VEC = 16 / sizeof(Scalar);
  const int av = nb / VEC;
  for (int v = threadIdx.x; v < ds * av; v += kThreads) {
    const int i = v / av, c = (v % av) * VEC;
    cp_async16(s_a + i * lda + c, ar + static_cast<long long>(i) * nb + c,
               true);
  }
}

// 0. the slice's B_hat columns [nb, ds]
template <typename Scalar>
__device__ __forceinline__ void copy_b(Scalar* s_b, const Scalar* br, int d,
                                       int ds, int nb) {
  constexpr int VEC = 16 / sizeof(Scalar);
  const int xv = ds / VEC;
  for (int v = threadIdx.x; v < nb * xv; v += kThreads) {
    const int c = v / xv, e = (v % xv) * VEC;
    cp_async16(s_b + c * ds + e, br + static_cast<long long>(c) * d + e,
               true);
  }
}

// 0. the LN affines (fp32, any alignment), loaded while the copies fly
__device__ __forceinline__ void load_ln(float* s_ln, const float* lsr,
                                        const float* lbr, int nb) {
  for (int c = threadIdx.x; c < nb; c += kThreads) {
    s_ln[c] = lsr[c];
    s_ln[nb + c] = lbr[c];
  }
}

// 1. partial h over this slice -> s_part [TT][nb]
template <typename Scalar, int TT, bool MMA>
__device__ __forceinline__ void partial_h(const Scalar* s_x, int ldx,
                                          const Scalar* s_a, int lda, int ds,
                                          int nb, float* s_part,
                                          float* s_red) {
  const int tid = threadIdx.x;
  if constexpr (MMA) {
    // one 16-row M tile; warp w takes the 8-column N tiles w, w + 8, ...
    // over the whole slice depth. Fragment layouts: PTX ISA, mma.m16n8k16.
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = (lane & 3) * 2;
    for (int n0 = warp * 8; n0 < nb; n0 += (kThreads / 32) * 8) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < ds; k0 += 16) {
        const Scalar* xa = s_x + g * ldx + k0 + q;
        const Scalar* xb = xa + 8 * ldx;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xa);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xb);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xa + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xb + 8);
        const Scalar* bc = s_a + (k0 + q) * lda + n0 + g;
        const uint32_t b0 = pack_bf16x2(bc[0], bc[lda]);
        const uint32_t b1 = pack_bf16x2(bc[8 * lda], bc[9 * lda]);
        mma_bf16_16816(c, a0, a1, a2, a3, b0, b1);
      }
      s_part[g * nb + n0 + q] = c[0];
      s_part[g * nb + n0 + q + 1] = c[1];
      s_part[(g + 8) * nb + n0 + q] = c[2];
      s_part[(g + 8) * nb + n0 + q + 1] = c[3];
    }
  } else {
    // thread (s, c) sums sub-slice s of column c for every token of the
    // tile; the S sub-slices are then added in order
    const int S = kThreads / nb;
    if (tid < S * nb) {
      const int c = tid % nb;
      const int s = tid / nb;
      const int per = (ds + S - 1) / S;
      const int i0 = s * per;
      const int i1 = min(ds, i0 + per);
      float acc[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = 0.0f;
      for (int i = i0; i < i1; ++i) {
        const float av_ = to_float(s_a[i * lda + c]);
#pragma unroll
        for (int t = 0; t < TT; ++t)
          acc[t] = fmaf(to_float(s_x[t * ldx + i]), av_, acc[t]);
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) s_red[(s * TT + t) * nb + c] = acc[t];
    }
    __syncthreads();
    for (int o = tid; o < TT * nb; o += kThreads) {
      float h = 0.0f;
      for (int s = 0; s < S; ++s) h += s_red[s * TT * nb + o];
      s_part[o] = h;
    }
  }
}

// 2. the cluster's partials, summed in rank order into s_h [n]; every
// remote load issued before the first add: one distributed-shared-memory
// latency per entry, not one per rank
__device__ __forceinline__ void sum_partials(cg::cluster_group& cluster,
                                             float* s_part, float* s_h,
                                             int n, int cs) {
#pragma unroll 2
  for (int o = threadIdx.x; o < n; o += kThreads) {
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
}

// 2. LN and the activation on each token row of h, one warp per row
__device__ __forceinline__ void ln_act(float* s_h, const float* s_ln, int nt,
                                       int nb, int use_ln, int act) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
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
        hr[c] = (hr[c] - mu) * rs * s_ln[c] + s_ln[nb + c];
    }
    if (act == 1) {
      __syncwarp();
      for (int c = lane; c < nb; c += 32) hr[c] = gelu_tanh(hr[c]);
    }
  }
}

// 3. up-projection of this slice + the residual (the x tile), one rounding
// to x's dtype; store(t, e, v) takes the 16-byte vector v of row t,
// columns e..e+VEC of the slice. Each (t, e) is read from the x tile and
// stored by one thread, so store may overwrite the tile in place.
template <typename Scalar, int TT, typename Store>
__device__ __forceinline__ void up_project(const Scalar* s_b,
                                           const float* s_h,
                                           const Scalar* s_x, int ldx, int ds,
                                           int nb, int nt, float* s_red,
                                           Store store) {
  constexpr int VEC = 16 / sizeof(Scalar);
  const int tid = threadIdx.x;
  const int xv = ds / VEC;
  auto finish = [&](int t, int e, float* acc) {
    float xs[VEC];
    unpack<Scalar>(*reinterpret_cast<const uint4*>(s_x + t * ldx + e), xs);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = xs[i] + acc[i];
    store(t, e, pack(acc, Scalar()));
  };
  // columns e..e+VEC of row t over bottleneck rows [c_lo, c_hi)
  auto up = [&](int t, int e, int c_lo, int c_hi, float* acc) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int c = c_lo; c < c_hi; ++c) {
      float bv[VEC];
      unpack<Scalar>(*reinterpret_cast<const uint4*>(s_b + c * ds + e), bv);
      const float hc = s_h[t * nb + c];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(hc, bv[i], acc[i]);
    }
  };
  if constexpr (TT == 1) {
    // decode: one thread per vector would leave most of the block idle
    // over a depth of b, so thread (g, v) sums group g of the bottleneck
    // rows for vector v, and the G groups are then added in order
    const int G = xv < kThreads ? kThreads / xv : 1;
    const int per = (nb + G - 1) / G;
    for (int it = tid; it < G * xv; it += kThreads) {
      const int g = it / xv, e = (it % xv) * VEC;
      float acc[VEC];
      up(0, e, min(nb, g * per), min(nb, g * per + per), acc);
      if (G == 1) {
        finish(0, e, acc);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) s_red[it * VEC + i] = acc[i];
      }
    }
    if (G > 1) {
      __syncthreads();
      for (int v = tid; v < xv; v += kThreads) {
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = s_red[v * VEC + i];
#pragma unroll 4
        for (int g = 1; g < G; ++g)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[i] += s_red[(g * xv + v) * VEC + i];
        finish(0, v * VEC, acc);
      }
    }
  } else {
    for (int v = tid; v < nt * xv; v += kThreads) {
      const int t = v / xv, e = (v % xv) * VEC;
      float acc[VEC];
      up(t, e, 0, nb, acc);
      finish(t, e, acc);
    }
  }
}

template <typename Scalar, int TT, bool MMA>
__global__ void __launch_bounds__(kThreads)
    fused_adapter_kernel(const Scalar* __restrict__ x,
                         const Scalar* __restrict__ a,
                         const Scalar* __restrict__ bm,
                         const float* __restrict__ ls,
                         const float* __restrict__ lb, Scalar* __restrict__ out,
                         int T, int d, int nb, long long a_bs, long long b_bs,
                         long long ln_bs, int use_ln, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = gridDim.x;
  const int r = blockIdx.x;  // the block's rank in its cluster = its slice
  const int ds = d / cs;
  const Layout L = layout(ds, nb, TT, sizeof(Scalar), MMA);
  Scalar* s_x = reinterpret_cast<Scalar*>(smem + L.x);
  Scalar* s_a = reinterpret_cast<Scalar*>(smem + L.a);
  Scalar* s_b = reinterpret_cast<Scalar*>(smem + L.b);
  float* s_part = reinterpret_cast<float*>(smem + L.part);
  float* s_h = reinterpret_cast<float*>(smem + L.h);
  float* s_ln = reinterpret_cast<float*>(smem + L.ln);  // scale, then bias
  float* s_red = reinterpret_cast<float*>(smem + L.red);

  const long long row = blockIdx.z;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  const int c0 = r * ds;  // first column of the slice
  const Scalar* xr = x + (row * T + t0) * static_cast<long long>(d);
  Scalar* outr = out + (row * T + t0) * static_cast<long long>(d);

  // 0. every copy of the block in flight at once: x and A_hat, then B_hat
  copy_x<Scalar, TT>(s_x, L.ldx, xr, d, c0, ds, nt);
  copy_a(s_a, L.lda, a + row * a_bs + static_cast<long long>(c0) * nb, ds,
         nb);
  cp_async_commit();
  copy_b(s_b, bm + row * b_bs + c0, d, ds, nb);
  cp_async_commit();
  if (use_ln) load_ln(s_ln, ls + row * ln_bs, lb + row * ln_bs, nb);
  cp_async_wait<1>();
  __syncthreads();

  // 1. partial h over this slice
  partial_h<Scalar, TT, MMA>(s_x, L.ldx, s_a, L.lda, ds, nb, s_part, s_red);

  // 2. the cluster's partials, summed in rank order, then LN and act
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  sum_partials(cluster, s_part, s_h, nt * nb, cs);
  cluster_arrive();  // this block is done reading its peers
  __syncthreads();
  ln_act(s_h, s_ln, nt, nb, use_ln, act);
  cp_async_wait<0>();
  __syncthreads();

  // 3. up-projection of this slice + residual, 16-byte stores
  up_project<Scalar, TT>(
      s_b, s_h, s_x, L.ldx, ds, nb, nt, s_red,
      [&](int t, int e, const uint4& v) {
        *reinterpret_cast<uint4*>(outr + static_cast<long long>(t) * d +
                                  c0 + e) = v;
      });

  // 4. no block leaves while a peer may still read its s_part
  cluster_wait();
}

// ---- the hetero-adapter launch: bottleneck -> LoRA -> IA3 ----

// One matmul stage: the bottleneck (use_ln = 1, act) or LoRA (use_ln = 0,
// the identity); strides in elements, 0 for a shared operand
template <typename Scalar>
struct Stage {
  const Scalar* a;
  const Scalar* b;
  const float* ls;
  const float* lb;
  long long a_bs, b_bs, ln_bs;
  int nb, use_ln, act;
};

// Shared-memory layout of one block of the hetero launch, in bytes; the
// same formula lives in kernels/hetero_adapter.py's planner. The x tile
// and each stage's A_hat rows, B_hat columns and partial h as in Layout;
// one h, LN and scratch area sized for the wider stage; s's slice last.
struct HeteroLayout {
  int ldx, lda[2];                                 // in elements
  int x, a[2], b[2], part[2], h, ln, red, s, total;  // in bytes
};

__host__ __device__ inline HeteroLayout hetero_layout(int ds, int nb0,
                                                      int nb1, int tt,
                                                      int esz, bool mma,
                                                      int s_esz) {
  const int vec = 16 / esz;
  HeteroLayout l;
  l.ldx = ds + vec;
  l.x = 0;
  int at = tt * l.ldx * esz, nbmax = 0, red = 0;
  for (int i = 0; i < 2; ++i) {
    const int nb = i ? nb1 : nb0;  // 0: no such stage
    l.lda[i] = nb + vec;
    l.a[i] = at;
    at += nb ? ds * l.lda[i] * esz : 0;
    l.b[i] = at;
    at += nb * ds * esz;
    l.part[i] = at;
    at += tt * nb * 4;
    if (nb > nbmax) nbmax = nb;
    const int rf = nb ? red_floats(nb, tt, vec, mma) : 0;
    if (rf > red) red = rf;
  }
  l.h = at;
  at += tt * nbmax * 4;
  l.ln = at;
  at += 2 * nbmax * 4;
  l.red = at;
  at += 4 * red;
  l.s = at;
  l.total = at + ds * s_esz;
  return l;
}

// y = v * (1 + s) for the VEC values of v at slice columns e.., s in
// shared memory as fp32 (s_bf16 = 0) or bf16: csrc/ia3_apply.cu's exact
// arithmetic, one rounding to x's dtype
template <typename Scalar>
__device__ __forceinline__ uint4 ia3_scale(const uint4& v,
                                           const unsigned char* s_s, int e,
                                           int s_bf16) {
  constexpr int VEC = 16 / sizeof(Scalar);
  float y[VEC];
  unpack<Scalar>(v, y);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float s =
        s_bf16 ? __bfloat162float(
                     reinterpret_cast<const __nv_bfloat16*>(s_s)[e + i])
               : reinterpret_cast<const float*>(s_s)[e + i];
    y[i] = __fmul_rn(y[i], __fadd_rn(1.0f, s));
  }
  return pack(y, Scalar());
}

template <typename Scalar, int TT, bool MMA>
__global__ void __launch_bounds__(kThreads)
    hetero_adapter_kernel(const Scalar* __restrict__ x,
                          Scalar* __restrict__ out, Stage<Scalar> st0,
                          Stage<Scalar> st1, int nst,
                          const unsigned char* __restrict__ s,
                          long long s_bs, int s_esz, int T, int d) {
  constexpr int VEC = 16 / sizeof(Scalar);
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = gridDim.x;
  const int r = blockIdx.x;
  const int ds = d / cs;
  const HeteroLayout L =
      hetero_layout(ds, nst > 0 ? st0.nb : 0, nst > 1 ? st1.nb : 0, TT,
                    sizeof(Scalar), MMA, s_esz);
  Scalar* s_x = reinterpret_cast<Scalar*>(smem + L.x);
  float* s_h = reinterpret_cast<float*>(smem + L.h);
  float* s_ln = reinterpret_cast<float*>(smem + L.ln);
  float* s_red = reinterpret_cast<float*>(smem + L.red);
  unsigned char* s_s = smem + L.s;

  const long long row = blockIdx.z;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, T - t0);
  const int c0 = r * ds;
  const Scalar* xr = x + (row * T + t0) * static_cast<long long>(d);
  Scalar* outr = out + (row * T + t0) * static_cast<long long>(d);

  // 0. every stage's copies in flight at once, one commit group each in
  // stage order (a group with no copies completes at once): x with stage
  // 0's A_hat rows | its B_hat columns | stage 1's A_hat rows | its B_hat
  // columns | s's slice
  copy_x<Scalar, TT>(s_x, L.ldx, xr, d, c0, ds, nt);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const Stage<Scalar> st = i ? st1 : st0;
    if (i < nst)
      copy_a(reinterpret_cast<Scalar*>(smem + L.a[i]), L.lda[i],
             st.a + row * st.a_bs + static_cast<long long>(c0) * st.nb, ds,
             st.nb);
    cp_async_commit();
    if (i < nst)
      copy_b(reinterpret_cast<Scalar*>(smem + L.b[i]),
             st.b + row * st.b_bs + c0, d, ds, st.nb);
    cp_async_commit();
  }
  if (s_esz) {
    const unsigned char* sr = s + (row * s_bs + c0) * s_esz;
    for (int v = threadIdx.x; v < ds * s_esz / 16; v += kThreads)
      cp_async16(s_s + 16 * v, sr + 16 * v, true);
  }
  cp_async_commit();
  if (nst > 0 && st0.use_ln)
    load_ln(s_ln, st0.ls + row * st0.ln_bs, st0.lb + row * st0.ln_bs,
            st0.nb);

  // the last stage's output: IA3 in its epilogue, 16-byte stores
  auto store_out = [&](int t, int e, const uint4& v) {
    *reinterpret_cast<uint4*>(outr + static_cast<long long>(t) * d + c0 +
                              e) =
        s_esz ? ia3_scale<Scalar>(v, s_s, e, s_esz == 2) : v;
  };
  if (nst == 0) {  // IA3 alone
    cp_async_wait<0>();
    __syncthreads();
    for (int v = threadIdx.x; v < nt * (ds / VEC); v += kThreads) {
      const int t = v / (ds / VEC), e = (v % (ds / VEC)) * VEC;
      store_out(t, e, *reinterpret_cast<const uint4*>(s_x + t * L.ldx + e));
    }
    return;
  }

  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= nst) break;
    const Stage<Scalar> st = i ? st1 : st0;
    const bool last = i + 1 == nst;
    Scalar* s_a = reinterpret_cast<Scalar*>(smem + L.a[i]);
    Scalar* s_b = reinterpret_cast<Scalar*>(smem + L.b[i]);
    float* s_part = reinterpret_cast<float*>(smem + L.part[i]);
    // the stage's input (x, or the previous stage's y in the x tile) and
    // its A_hat rows
    if (i == 0)
      cp_async_wait<4>();
    else
      cp_async_wait<2>();
    __syncthreads();
    partial_h<Scalar, TT, MMA>(s_x, L.ldx, s_a, L.lda[i], ds, st.nb, s_part,
                               s_red);
    // also: every peer has read the previous stage's partials
    cluster.sync();
    sum_partials(cluster, s_part, s_h, nt * st.nb, cs);
    if (last) cluster_arrive();  // done reading the peers
    __syncthreads();
    ln_act(s_h, s_ln, nt, st.nb, st.use_ln, st.act);
    if (last)
      cp_async_wait<0>();  // its B_hat columns and s
    else
      cp_async_wait<3>();  // its B_hat columns
    __syncthreads();
    if (last)
      up_project<Scalar, TT>(s_b, s_h, s_x, L.ldx, ds, st.nb, nt, s_red,
                             store_out);
    else
      up_project<Scalar, TT>(
          s_b, s_h, s_x, L.ldx, ds, st.nb, nt, s_red,
          [&](int t, int e, const uint4& v) {
            *reinterpret_cast<uint4*>(s_x + t * L.ldx + e) = v;
          });
  }
  // no block leaves while a peer may still read its last partial
  cluster_wait();
}

// One cluster launch: grid (cs, T-tiles, B), cluster (cs, 1, 1), with the
// kernel's opt-ins (> 48 KB of shared memory, 16 blocks) set once per
// instantiation through smem_set / wide_set
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*kernel)(P...), int smem, int cs, int B,
                            int T, int tt, int& smem_set, bool& wide_set,
                            cudaStream_t stream, A... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (cs > 8 && !wide_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs),
                     static_cast<unsigned>((T + tt - 1) / tt),
                     static_cast<unsigned>(B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Scalar, int TT, bool MMA>
cudaError_t launch_tile(const void* x, const void* a, const void* b,
                        const float* ls, const float* lb, void* out, int B,
                        int T, int d, int nb, long long a_bs, long long b_bs,
                        long long ln_bs, int use_ln, int act, int cs,
                        cudaStream_t stream) {
  static int smem_set = 0;
  static bool wide_set = false;
  const Layout l = layout(d / cs, nb, TT, sizeof(Scalar), MMA);
  return launch_clusters(
      fused_adapter_kernel<Scalar, TT, MMA>, l.total, cs, B, T, TT, smem_set,
      wide_set, stream, static_cast<const Scalar*>(x),
      static_cast<const Scalar*>(a), static_cast<const Scalar*>(b), ls, lb,
      static_cast<Scalar*>(out), T, d, nb, a_bs, b_bs, ln_bs, use_ln, act);
}

template <typename Scalar, int TT, bool MMA>
cudaError_t launch_hetero(const void* x, void* out, const Stage<Scalar>& st0,
                          const Stage<Scalar>& st1, int nst, const void* s,
                          long long s_bs, int s_esz, int B, int T, int d,
                          int cs, cudaStream_t stream) {
  static int smem_set = 0;
  static bool wide_set = false;
  const HeteroLayout l =
      hetero_layout(d / cs, nst > 0 ? st0.nb : 0, nst > 1 ? st1.nb : 0, TT,
                    sizeof(Scalar), MMA, s_esz);
  return launch_clusters(
      hetero_adapter_kernel<Scalar, TT, MMA>, l.total, cs, B, T, TT,
      smem_set, wide_set, stream, static_cast<const Scalar*>(x),
      static_cast<Scalar*>(out), st0, st1, nst,
      static_cast<const unsigned char*>(s), s_bs, s_esz, T, d);
}

// The checks both entry points share: batch, tokens, cluster size
bool valid_grid(int B, int T, int d, int cluster) {
  return B >= 1 && B <= 65535 && T >= 1 && d >= 1 &&
         (cluster == 8 || cluster == kMaxCluster) && d % cluster == 0 &&
         (T + kTileT - 1) / kTileT <= 65535;
}

// The slice (d / cluster) and a bottleneck width nb as the kernel takes
// them in a dtype: whole 16-byte vectors (the slice a multiple of the
// tensor-core depth 16 in bf16)
bool valid_widths(int ds, int nb, int dtype) {
  if (nb < 1 || nb > kMaxB) return false;
  return dtype == 1 ? ds % 16 == 0 && nb % 8 == 0
                    : ds % 4 == 0 && nb % 4 == 0;
}

template <typename Scalar>
cudaError_t dispatch_hetero(const void* x, void* out, const Stage<Scalar>& st0,
                            const Stage<Scalar>& st1, int nst, const void* s,
                            long long s_bs, int s_esz, int B, int T, int d,
                            int cs, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(Scalar) == 2;
  if (T == 1)
    return launch_hetero<Scalar, 1, false>(x, out, st0, st1, nst, s, s_bs,
                                           s_esz, B, T, d, cs, st);
  return launch_hetero<Scalar, kTileT, kBf16>(x, out, st0, st1, nst, s,
                                              s_bs, s_esz, B, T, d, cs, st);
}

template <typename Scalar>
Stage<Scalar> make_stage(const void* a, const void* b, const void* ls,
                         const void* lb, long long a_bs, long long b_bs,
                         long long ln_bs, int nb, int use_ln, int act) {
  return Stage<Scalar>{static_cast<const Scalar*>(a),
                       static_cast<const Scalar*>(b),
                       static_cast<const float*>(ls),
                       static_cast<const float*>(lb),
                       a_bs, b_bs, ln_bs, nb, use_ln, act};
}

template <typename Scalar>
cudaError_t hetero(const void* x, const void* bn_a, const void* bn_b,
                   const void* ls, const void* lb, const void* lora_a,
                   const void* lora_b, const void* s, void* out, int B,
                   int T, int d, int nb, int nr, long long bn_a_bs,
                   long long bn_b_bs, long long ln_bs, long long lora_a_bs,
                   long long lora_b_bs, long long s_bs, int s_esz, int act,
                   int cs, cudaStream_t st) {
  const Stage<Scalar> bn = make_stage<Scalar>(bn_a, bn_b, ls, lb, bn_a_bs,
                                              bn_b_bs, ln_bs, nb, 1, act);
  const Stage<Scalar> lora = make_stage<Scalar>(
      lora_a, lora_b, nullptr, nullptr, lora_a_bs, lora_b_bs, 0, nr, 0, 0);
  const int nst = (bn_a != nullptr) + (lora_a != nullptr);
  return dispatch_hetero<Scalar>(x, out, bn_a ? bn : lora, lora, nst, s,
                                 s_bs, s_esz, B, T, d, cs, st);
}

}  // namespace

// dtype (of x, A_hat, B_hat and out): 0 = fp32, 1 = bf16. Strides are in
// elements; 0 broadcasts a shared operand to every row. act: 0 = identity,
// 1 = gelu (tanh form). ls / lb are read only under use_ln, so the LoRA
// route (use_ln = 0) may pass null for both. cluster: blocks per batch row
// and T-tile (8 or 16, the sizes the wrapper's planner chooses between),
// each taking d / cluster columns; d /
// cluster and nb must be whole 16-byte vectors (d / cluster a multiple of
// 16 in bf16), x, A_hat, B_hat, out and both batch strides 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int xpeft_fused_adapter_batched(
    const void* x, const void* a, const void* b, const void* ls,
    const void* lb, void* out, int B, int T, int d, int nb, long long a_bs,
    long long b_bs, long long ln_bs, int dtype, int use_ln, int act,
    int cluster, void* stream) {
  if (!valid_grid(B, T, d, cluster) || (dtype != 0 && dtype != 1) ||
      !valid_widths(d / cluster, nb, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lsp = static_cast<const float*>(ls);
  const float* lbp = static_cast<const float*>(lb);
  cudaError_t err;
  if (dtype == 1) {
    if (T == 1)
      err = launch_tile<__nv_bfloat16, 1, false>(
          x, a, b, lsp, lbp, out, B, T, d, nb, a_bs, b_bs, ln_bs, use_ln,
          act, cluster, s);
    else
      err = launch_tile<__nv_bfloat16, kTileT, true>(
          x, a, b, lsp, lbp, out, B, T, d, nb, a_bs, b_bs, ln_bs, use_ln,
          act, cluster, s);
  } else {
    if (T == 1)
      err = launch_tile<float, 1, false>(x, a, b, lsp, lbp, out, B, T, d,
                                         nb, a_bs, b_bs, ln_bs, use_ln, act,
                                         cluster, s);
    else
      err = launch_tile<float, kTileT, false>(
          x, a, b, lsp, lbp, out, B, T, d, nb, a_bs, b_bs, ln_bs, use_ln,
          act, cluster, s);
  }
  return static_cast<int>(err);
}

// The hetero-adapter launch: the bottleneck (bn_a / bn_b, [B, d, nb] /
// [B, nb, d] or shared, with fp32 LN affines ls / lb and act as above),
// LoRA (lora_a / lora_b, rank nr) and IA3 (s, [B, d] or shared [d], fp32
// (s_dtype 0) or bf16 (1)), each present where its pointer is non-null,
// at least one of them; applied in that order with #2's layout rules for
// each matmul stage (x, every A_hat / B_hat, out and s 16-byte aligned,
// batch strides whole 16-byte vectors) and s's slice a whole number of
// 16-byte vectors. dtype and cluster as above; the wrapper's planner picks
// the cluster for both stages together. Returns the launch's cudaError_t.
extern "C" int xpeft_hetero_adapter_batched(
    const void* x, const void* bn_a, const void* bn_b, const void* ls,
    const void* lb, const void* lora_a, const void* lora_b, const void* s,
    void* out, int B, int T, int d, int nb, int nr, long long bn_a_bs,
    long long bn_b_bs, long long ln_bs, long long lora_a_bs,
    long long lora_b_bs, long long s_bs, int dtype, int s_dtype, int act,
    int cluster, void* stream) {
  if (!valid_grid(B, T, d, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ds = d / cluster;
  const bool has_bn = bn_a != nullptr, has_lora = lora_a != nullptr;
  const int s_esz = s ? (s_dtype == 1 ? 2 : 4) : 0;
  if ((dtype != 0 && dtype != 1) ||
      (!has_bn && !has_lora && !s) || (bn_b != nullptr) != has_bn ||
      (lora_b != nullptr) != has_lora ||
      (has_bn && (!ls || !lb || !valid_widths(ds, nb, dtype))) ||
      (has_lora && !valid_widths(ds, nr, dtype)) ||
      (s && ((s_dtype != 0 && s_dtype != 1) || (ds * s_esz) % 16 ||
             (s_bs * s_esz) % 16)) ||
      ds % (dtype == 1 ? 16 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = hetero<__nv_bfloat16>(x, bn_a, bn_b, ls, lb, lora_a, lora_b, s,
                                out, B, T, d, nb, nr, bn_a_bs, bn_b_bs, ln_bs,
                                lora_a_bs, lora_b_bs, s_bs, s_esz, act,
                                cluster, st);
  else
    err = hetero<float>(x, bn_a, bn_b, ls, lb, lora_a, lora_b, s, out, B, T,
                        d, nb, nr, bn_a_bs, bn_b_bs, ln_bs, lora_a_bs,
                        lora_b_bs, s_bs, s_esz, act, cluster, st);
  return static_cast<int>(err);
}
