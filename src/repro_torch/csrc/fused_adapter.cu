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
  // on CUDA cores: phase 1's sub-slice partials, then at T = 1 phase 3's
  // bottleneck-group partials (at most kThreads vectors)
  const int red = (kThreads / nb) * tt * nb;
  l.total = l.red + (mma ? 0 : 4 * (tt == 1 && kThreads * vec > red
                                        ? kThreads * vec : red));
  return l;
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
  constexpr int VEC = 16 / sizeof(Scalar);
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
  const Scalar* ar = a + row * a_bs + static_cast<long long>(c0) * nb;
  const Scalar* br = bm + row * b_bs + c0;
  const float* lsr = ls + row * ln_bs;
  const float* lbr = lb + row * ln_bs;
  const int tid = threadIdx.x;

  // 0. every copy of the block in flight at once
  const int xv = ds / VEC;  // 16-byte vectors per slice row
  for (int v = tid; v < TT * xv; v += kThreads) {
    const int t = v / xv, e = (v % xv) * VEC;
    cp_async16(s_x + t * L.ldx + e,
               xr + static_cast<long long>(t < nt ? t : 0) * d + c0 + e,
               t < nt);
  }
  const int av = nb / VEC;
  for (int v = tid; v < ds * av; v += kThreads) {
    const int i = v / av, c = (v % av) * VEC;
    cp_async16(s_a + i * L.lda + c, ar + static_cast<long long>(i) * nb + c,
               true);
  }
  cp_async_commit();
  for (int v = tid; v < nb * xv; v += kThreads) {
    const int c = v / xv, e = (v % xv) * VEC;
    cp_async16(s_b + c * ds + e, br + static_cast<long long>(c) * d + e,
               true);
  }
  cp_async_commit();
  // the LN affines (fp32, any alignment), loaded while the copies fly
  if (use_ln)
    for (int c = tid; c < nb; c += kThreads) {
      s_ln[c] = lsr[c];
      s_ln[nb + c] = lbr[c];
    }
  cp_async_wait<1>();
  __syncthreads();

  // 1. partial h over this slice -> s_part [TT][nb]
  if constexpr (MMA) {
    // one 16-row M tile; warp w takes the 8-column N tiles w, w + 8, ...
    // over the whole slice depth. Fragment layouts: PTX ISA, mma.m16n8k16.
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = (lane & 3) * 2;
    for (int n0 = warp * 8; n0 < nb; n0 += (kThreads / 32) * 8) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < ds; k0 += 16) {
        const Scalar* xa = s_x + g * L.ldx + k0 + q;
        const Scalar* xb = xa + 8 * L.ldx;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xa);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xb);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xa + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xb + 8);
        const Scalar* bc = s_a + (k0 + q) * L.lda + n0 + g;
        const uint32_t b0 = pack_bf16x2(bc[0], bc[L.lda]);
        const uint32_t b1 = pack_bf16x2(bc[8 * L.lda], bc[9 * L.lda]);
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
        const float av_ = to_float(s_a[i * L.lda + c]);
#pragma unroll
        for (int t = 0; t < TT; ++t)
          acc[t] = fmaf(to_float(s_x[t * L.ldx + i]), av_, acc[t]);
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

  // 2. the cluster's partials, summed in rank order, then LN and act
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
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
  cp_async_wait<0>();
  __syncthreads();

  // 3. up-projection of this slice + residual, one rounding to x's dtype
  auto finish = [&](int t, int e, float* acc) {
    float xs[VEC];
    unpack<Scalar>(*reinterpret_cast<const uint4*>(s_x + t * L.ldx + e), xs);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = xs[i] + acc[i];
    *reinterpret_cast<uint4*>(outr + static_cast<long long>(t) * d + c0 +
                              e) = pack(acc, Scalar());
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

  // 4. no block leaves while a peer may still read its s_part
  cluster_wait();
}

template <typename Scalar, int TT, bool MMA>
cudaError_t launch_tile(const void* x, const void* a, const void* b,
                        const float* ls, const float* lb, void* out, int B,
                        int T, int d, int nb, long long a_bs, long long b_bs,
                        long long ln_bs, int use_ln, int act, int cs,
                        cudaStream_t stream) {
  auto kernel = fused_adapter_kernel<Scalar, TT, MMA>;
  const Layout l = layout(d / cs, nb, TT, sizeof(Scalar), MMA);
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
      &cfg, kernel, static_cast<const Scalar*>(x),
      static_cast<const Scalar*>(a), static_cast<const Scalar*>(b), ls, lb,
      static_cast<Scalar*>(out), T, d, nb, a_bs, b_bs, ln_bs, use_ln, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  if (B < 1 || B > 65535 || T < 1 || d < 1 || nb < 1 || nb > kMaxB)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cluster != 8 && cluster != kMaxCluster) || d % cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((T + kTileT - 1) / kTileT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ds = d / cluster;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lsp = static_cast<const float*>(ls);
  const float* lbp = static_cast<const float*>(lb);
  cudaError_t err;
  if (dtype == 1) {
    if (ds % 16 || nb % 8) return static_cast<int>(cudaErrorInvalidValue);
    if (T == 1)
      err = launch_tile<__nv_bfloat16, 1, false>(
          x, a, b, lsp, lbp, out, B, T, d, nb, a_bs, b_bs, ln_bs, use_ln,
          act, cluster, s);
    else
      err = launch_tile<__nv_bfloat16, kTileT, true>(
          x, a, b, lsp, lbp, out, B, T, d, nb, a_bs, b_bs, ln_bs, use_ln,
          act, cluster, s);
  } else if (dtype == 0) {
    if (ds % 4 || nb % 4) return static_cast<int>(cudaErrorInvalidValue);
    if (T == 1)
      err = launch_tile<float, 1, false>(x, a, b, lsp, lbp, out, B, T, d,
                                         nb, a_bs, b_bs, ln_bs, use_ln, act,
                                         cluster, s);
    else
      err = launch_tile<float, kTileT, false>(
          x, a, b, lsp, lbp, out, B, T, d, nb, a_bs, b_bs, ln_bs, use_ln,
          act, cluster, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
