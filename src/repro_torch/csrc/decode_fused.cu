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
//   x1 = x + o.Wo;  h = RMSNorm2(x1);  x2 = x1 + (act(h.Wg) * h.Wu).Wd
//   (act: silu, or gelu in its tanh form, jax.nn.gelu's default)
//   adapter "bf16":  y = x2 + act(LN(x2.A_hat)).B_hat;  "none": y = x2
//   adapter "int8"/"int4":  the same with A_hat/B_hat dequantized from
//                           their quantized slot records (dequant.cuh)
//
// and returns y and the new K/V rows (the caller scatters them into the
// cache after the launch, so the cache read here is the old one). The
// variants no served config uses (layernorm, a vanilla MLP, activations
// other than silu and gelu, no RoPE, fp16/fp32 activations) are refused
// by the wrapper.
//
// The cache holds bf16 or float8_e4m3fn values (JAX's cfg.cache_dtype; a
// uniform runtime flag, p.f8, so the instantiations stay eight). On
// float8 the new K/V rows are rounded from their bf16 values to e4m3 by
// JAX's cast rule (f8_of: nearest even, no saturation, NaN past 448, as
// ml_dtypes casts and utils/cache_cast.py), returned as bytes, and
// attention reads every cached row and the rounded new row at pos as
// their exact fp32 values: decode_block_row's k.astype(cache dtype) then
// .astype(activation dtype). The cache's TMA boxes then hold 1-byte
// values, half the bytes of a bf16 row, so a stage holds twice the rows.
//
// Numerics are decode_block_row's: fp32 sums, rounded to bf16 after each
// norm, after each projection (q, k, v, o.Wo, g, u, m.Wd), at the bias add
// (the bias itself cast to bf16 first), after RoPE (fp32, no FMA
// contraction), at the softmax weights before w.V, at w.V, at act(g) and
// at act(g)*u, at each residual add, and on route bf16 in the adapter at
// h (before B_hat) and at y. The adapter's LN and activation stay fp32.
// Routes int8/int4 keep the adapter fp32 end to end, as decode_block_row's
// quantized branch does: x2's bf16 value times the exact dequantized A, h
// NOT rounded before B, and ONE rounding of x2 + y. Route bf16 differs on
// purpose from the port's fused_adapter.cu, which follows kernels/ref.py's
// fused-adapter numerics (fp32 inside, one rounding). Cache rows past
// min(pos, S-1) get a softmax weight of exactly 0 there, so they are not
// read here: for finite cache rows the result is the same.
//
// Bound on the H100: bytes. One layer-step must read the layer's weights
// once (4*d^2 + 3*d*ff bf16 = 25.7 MB at qwen1.5-0.5b), the K/V rows the
// slots attend and the slots' A_hat/B_hat (~1 MB in bf16, ~0.5 MB in
// int8, ~0.28 MB in int4): ~27 MB, ~8 us at 3.35 TB/s, at ~2 flops per
// weight byte for 4 slots.
//
// Design. A persistent cooperative grid, one block per SM of 16 consumer
// warps and one producer warp, walks the phases below; grid.sync() (~0.85
// us on an H100) separates those that need every block's result:
//   0. QKV: tasks of 16 columns of Wq|Wk|Wv over the whole depth d; the
//      block's RMSNorm1 rows are made once, in shared memory.
//   1. attention: an item is (slot, head, split of S) and reads only the
//      cache rows s <= min(pos, S-1) of its split. Where one stage holds
//      the K and V rows of the whole cache (S <= 128 at hd 64) there is
//      one split and the item is done in one pass. Otherwise
//      (flash-decoding) pass 1 writes each split's logits and (max, sum
//      of exp) and counts it done; pass 2 waits for its (slot, head)'s
//      splits (a cooperative grid is co-resident and pass 1 never waits,
//      so this cannot hang), forms the global max and sum in split order,
//      rounds the normalised weights to bf16 and sums w.V over its rows;
//      the last split to finish adds the partial o in split order.
//                                                           -- grid.sync
//   2. out-projection + residual                            -- grid.sync
//   3. RMSNorm2 (once per block) + gate|up, act(g) * u      -- grid.sync
//   4. down-projection + residual (the output on route none); with an
//      adapter, each task also multiplies its 16 x2 columns by the same 16
//      rows of every slot's A_hat: its share of x2 . A_hat  -- grid.sync
//   5. the shares summed in tile order, LN over the bottleneck and the
//      activation, once per (block, slot); the up-projection . B_hat +
//      residual.
// A task owns its output columns over the whole depth, so it finishes
// them itself: no partial sums cross blocks. (A first version split the
// depth too, a task per block in every phase, the last task of a column
// adding the partials: each task then cost 4-7 us of dependent round
// trips and the kernel ran slower than the one it replaced.)
// The weights do not depend on the activations, so each block walks ONE
// sequence of tiles across all phases (its tasks of phase 0, then of
// phase 1, ...) through a ring of four 32 KB shared-memory stages, full
// and empty mbarriers between the producer warp and the consumers: the
// producer issues each tile as soon as its stage is free, the next
// phase's first tiles before it joins a barrier. Weight tiles and cache
// rows come by TMA (one box of 1024 rows x 16 columns a tile):
// per-thread cp.async of 32-byte rows stalled the issuing threads for
// ~1-2 us a tile, and a TMA issue from a consumer thread held its block
// ~0.5 us a tile (on an H100 the producer warp took a bf16 call from
// 0.068 ms to 0.059). Tasks are dealt round-robin from a start that
// moves on by each phase's task count, so the blocks' bytes over the
// layer even out. A
// phase's input rows (bf16 values on every route) are gathered once per
// block into shared memory, 8 loads in flight per thread and no division
// per element, where B rows of the widest GEMV depth fit beside the ring
// (kin = max(d, H*hd, ff): qwen1.5-0.5b at 1-8 slots). Wider rows
// (gemma-2b's d_ff 16,384 and llava-next-34b's 20,480 at any slot count,
// deepseek-7b's and musicgen-medium's at 5-8 slots) are read in windows of
// kin rows of the depth, kin then the widest whole number of 1024-row
// tiles that fits: a task gathers each window from the phase's input in
// global memory (x, or the scratch rows, which stay in L2) when its tiles
// reach it, and a norm phase whose rows do not fit takes each slot's RMS
// factor first, from the same bf16 values in the same order. The tiles,
// their order and every sum are those of whole rows: a window changes
// only where the inputs are read from. The main GEMVs run on tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate, the slots as rows of the
// A operand): the
// products are exact and the sums fp32 in a fixed order. The adapter's
// products stay on CUDA cores in fp32 (its h and, on routes int8/int4,
// its dequantized weights are not bf16 values); B_hat's tiles come by the
// producer's cp.async, quantized ones as raw bytes plus their scale
// words, dequantized once in shared memory into an fp32 tile (one scale
// per 8 columns). Operands an epilogue needs are loaded before the GEMV.
// grid.sync() builds without relocatable device code (-rdc) under CUDA 12.
// The C entry point launches only with cudaLaunchCooperativeKernel, on a
// grid no larger than the occupancy API allows.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace cg = cooperative_groups;

// The kernel's eight instantiations (4 or 8 slot rows; input rows in
// windows or whole; a GELU or SiLU gate) make this source the build's one
// long compile. Built as it is, it holds them all. kernels/_build.py
// builds it four times at once instead, with -DXPEFT_DEC_PART=p (p = 2 *
// windows + gelu): each part holds its (windows, gelu) pair behind
// xpeft_decode_kernel_part<p>, part 0 also the C entry points.
#ifdef XPEFT_DEC_PART
extern "C" const void* xpeft_decode_kernel_part0(int NB);
extern "C" const void* xpeft_decode_kernel_part1(int NB);
extern "C" const void* xpeft_decode_kernel_part2(int NB);
extern "C" const void* xpeft_decode_kernel_part3(int NB);
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 512;        // the 16 consumer warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = kThreads + 32;  // and one producer warp
constexpr int kNT = 16;             // output columns per task
constexpr int kStage = 32768;       // bytes per ring stage
constexpr int kStages = 4;
constexpr int kChunk = 1024;        // rows per weight tile
constexpr int kHalf = kChunk * 16;  // a weight tile: two [kChunk][8] halves
constexpr int kKVBox = 16;          // rows per cache TMA box
constexpr int kAChunk = 256;        // rows per adapter tile
constexpr int kPad = 8;             // bf16 padding of an input row
constexpr int kMisc = 64;           // floats of small per-block state
constexpr int kMaxSmem = 232448;
// an adapter tile in its stage: bf16 [rows][16] at 0; or, quantized, raw
// bytes [rows][2 vectors][8 B] at 0, each row's scale words (16 B) at
// kQScaleOff and the dequantized fp32 tile [rows][16] at kQDeqOff
constexpr int kQScaleOff = 8192, kQDeqOff = 16384;
constexpr float kNegInf = -2.0e38f;
constexpr float kNormEps = 1e-6f;
enum Route { kNone = 0, kBf16 = 1, kInt8 = 2, kInt4 = 3 };
enum Phase { kQKV, kAttnK, kAttnV, kWo, kGU, kDown, kAdUp, kPhases };

struct Args {
  const bf16* x;       // [B, d]
  const int* pos;      // [B]
  const float* n1;     // [d]
  const float* n2;     // [d]
  const float* bq;     // [H*hd] (unused without bias)
  const float* bk;     // [KV*hd]
  const float* bv;     // [KV*hd]
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
  // TMA descriptors of Wq, Wk, Wv, Wo, Wg, Wu, Wd ([K, N] bf16 seen as
  // [K / 16][16][N]) and of the K/V caches ([B*S, KV, hd])
  CUtensorMap tm_wq, tm_wk, tm_wv, tm_wo, tm_wg, tm_wu, tm_wd, tm_kc, tm_vc;
  bf16* y;             // [B, d]
  void* k_row;         // [B, KV, hd] in the cache's type
  void* v_row;
  int f8;              // the caches hold float8_e4m3fn bytes, else bf16
  int kvb;             // bytes of a cache value (1 or 2)
  float* scratch;      // Layout below
  int B, d, H, KV, hd, ff, S, nb;
  int qkv_bias, adapter, gelu;
  float cap, scale;
  int sc;              // cache rows per attention split (the plan)
  int kin;             // depth rows of an input row in shared memory
  // derived from the shapes (fill_layout)
  int nsplit, nitems, nct_q, nct_kv, nct_qkv;
  int ntask[kPhases], nchunk[kPhases], base[kPhases];
  long long o_qkv, o_lg, o_ml, o_op, o_o, o_x1, o_act, o_x2, o_phh, o_cnt;
  int c_k, c_v, ncnt;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Task counts, chunks per task, each phase's first block, and the scratch
// layout (fp32 words; the counters last). Returns the scratch size.
long long fill_layout(Args& p) {
  const int B = p.B, nq = p.H * p.hd, nkv = p.KV * p.hd;
  const int nqkv = nq + 2 * nkv;
  const bool ad = p.adapter != kNone;
  p.nsplit = cdiv(p.S, p.sc);
  p.nitems = B * p.H * p.nsplit;
  p.nct_q = cdiv(nq, kNT);
  p.nct_kv = cdiv(nkv, kNT);
  p.nct_qkv = p.nct_q + 2 * p.nct_kv;
  const int nct_d = cdiv(p.d, kNT);
  p.ntask[kQKV] = p.nct_qkv;
  p.ntask[kAttnK] = p.nitems;
  p.ntask[kAttnV] = p.nsplit > 1 ? p.nitems : 0;
  p.ntask[kWo] = nct_d;
  p.ntask[kGU] = cdiv(p.ff, kNT / 2);
  p.ntask[kDown] = nct_d;
  p.ntask[kAdUp] = ad ? B * nct_d : 0;
  p.nchunk[kQKV] = cdiv(p.d, kChunk);
  p.nchunk[kAttnK] = p.nchunk[kAttnV] = 1;
  p.nchunk[kWo] = cdiv(nq, kChunk);
  p.nchunk[kGU] = cdiv(p.d, kChunk);
  p.nchunk[kDown] = cdiv(p.ff, kChunk);
  p.nchunk[kAdUp] = cdiv(p.nb, kAChunk);
  int acc = 0;
  for (int ph = 0; ph < kPhases; ++ph) {
    p.base[ph] = acc;
    acc += p.ntask[ph];
  }
  long long o = 0;
  auto take = [&](long long n) {
    const long long at = o;
    o += (n + 3) / 4 * 4;  // 16-byte aligned regions
    return at;
  };
  p.o_qkv = take(1LL * B * nqkv);
  p.o_lg = take(p.nsplit > 1 ? 1LL * p.nitems * p.sc : 0);
  p.o_ml = take(p.nsplit > 1 ? 2LL * p.nitems : 0);
  p.o_op = take(p.nsplit > 1 ? 1LL * p.nitems * p.hd : 0);
  p.o_o = take(1LL * B * nq);
  p.o_x1 = take(1LL * B * p.d);
  p.o_act = take(1LL * B * p.ff);
  p.o_x2 = take(1LL * B * p.d);
  p.o_phh = take(1LL * nct_d * B * p.nb);
  p.c_k = 0;
  p.c_v = B * p.H;
  p.ncnt = 2 * B * p.H;
  p.o_cnt = take(p.ncnt);
  return o;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
// round to bf16 and back: the value a bf16 tensor would hold
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// fp32 -> float8_e4m3fn byte by JAX's cast rule (ml_dtypes; the
// arithmetic of PyTorch 2.11's c10::detail::fp8e4m3fn_from_fp32_value):
// round to nearest even, a magnitude that is 480 or more, or that rounds
// past 448, gives NaN (0x7f with the sign); subnormals by one fp32 add at
// the 2^-9 step. No saturation: CUDA's __NV_SATFINITE conversion would
// clamp to 448 instead.
__device__ __forceinline__ uint8_t f8_of(float f) {
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint32_t r;
  if (bits >= (1087u << 20)) {  // 480.0f, and inf / NaN
    r = 0x7fu;
  } else if (bits < (121u << 23)) {  // below 2^-6, e4m3's least normal
    const uint32_t denorm = 141u << 23;  // 2^14: its fp32 ulp is 2^-9
    r = __float_as_uint(__fadd_rn(__uint_as_float(bits),
                                  __uint_as_float(denorm))) - denorm;
  } else {
    const uint32_t odd = (bits >> 20) & 1u;  // ties to even
    bits += (static_cast<uint32_t>(7 - 127) << 23) + 0x7ffffu + odd;
    r = bits >> 20;
  }
  return static_cast<uint8_t>(r | (sign >> 24));
}
// a float8_e4m3fn byte's exact fp32 value (0x7f / 0xff: NaN)
__device__ __forceinline__ float f8_val(uint32_t v) {
  const uint32_t e = (v >> 3) & 0xfu, m = v & 7u;
  float mag;
  if (e == 15 && m == 7) mag = __uint_as_float(0x7fc00000u);
  else if (e) mag = __uint_as_float(((e + 120u) << 23) | (m << 20));
  else mag = static_cast<float>(m) * 0.001953125f;  // m * 2^-9
  return v & 0x80u ? -mag : mag;
}
// a new K/V value (a bf16 value) as the cache holds it, read back
__device__ __forceinline__ float kv_round(const Args& p, float v) {
  return p.f8 ? f8_val(f8_of(v)) : v;
}
// a word of scratch written by another block in this launch (L2, not L1)
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(N), "r"(n)
               : "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// an arrival on bar once this thread's earlier cp.async copies land (the
// barrier's pending count is raised by one until then)
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  for (long long n = 0; !done; ++n) {
    if (n > (1LL << 28)) __trap();  // a copy that never lands is a fault
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// Whether bar's phase of this parity has completed (does not wait).
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}
// One TMA box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* tm,
                                       int c, int h, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(tm), "r"(c), "r"(h), "r"(r), "r"(smem_addr(bar))
      : "memory");
}

// the consumer warps' barrier (the producer warp never waits on it)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
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
  csync();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  float t = 0.0f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  csync();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  float t = red[0];
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

__device__ __forceinline__ float gelu_tanh(float h) {
  const float kC = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * h * (1.0f + tanhf(kC * (h + 0.044715f * h * h * h)));
}

// After a task has written its partial sums: true in the one block that is
// the n-th to arrive at *cnt (uniform over the block). Its later reads of
// the other tasks' partials see their writes.
__device__ bool arrive_last(int* cnt, int n, int* flag) {
  __threadfence();
  csync();
  if (threadIdx.x == 0) *flag = atomicAdd(cnt, 1) == n - 1;
  csync();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// ---- copies into a ring stage (by the producer warp) ----------------------

// Rows k0 .. k0+rows-1, columns c0 .. c0+15 of a bf16 matrix W [K, N]
// (an adapter tile) into dst [rows][16], by the producer warp's cp.async;
// columns past N are zero-filled.
__device__ void copy_adapter(unsigned char* dst, const bf16* W, int N,
                             int c0, int k0, int rows) {
  for (int i = threadIdx.x & 31; i < rows * 2; i += 32) {
    const int r = i >> 1, c = c0 + (i & 1) * 8;
    const bool valid = c < N;
    cp_async16(dst + r * 32 + (i & 1) * 16,
               valid ? W + static_cast<long long>(k0 + r) * N + c : W,
               valid);
  }
}

// Rows k0 .. k0+rows-1, columns c0 .. c0+15 of a quantized matrix (q [K, N]
// int8 or planar int4 bytes, scales s [K, groups] fp16, dequant.cuh): 8
// bytes per 8-column vector (int4: the bytes whose low or high nibbles
// hold those columns), and each row's scales over those columns as whole
// aligned 4-byte words (a word that holds a wanted scale lies in mapped
// memory, whatever else it holds).
__device__ void copy_quant(unsigned char* dst, const uint8_t* q,
                           const __half* s, int groups, int N, int k0,
                           int c0, int rows, int int4) {
  const int g = N / groups;
  const long long pitch = int4 ? N / 2 : N;
  const int cend = min(c0 + kNT, N);
  for (int i = threadIdx.x & 31; i < rows * 4; i += 32) {
    const int r = i >> 2, w = i & 3, k = k0 + r;
    if (w < 2) {
      const int c = c0 + w * 8;
      const bool valid = c < N;
      const int byte = int4 && c >= N / 2 ? c - N / 2 : c;
      cp_async_small<8>(dst + r * 16 + w * 8, valid ? q + k * pitch + byte : q,
                        valid);
    }
    const uintptr_t a0 =
        reinterpret_cast<uintptr_t>(s + k * groups + c0 / g) & ~uintptr_t(3);
    const uintptr_t a1 =
        reinterpret_cast<uintptr_t>(s + k * groups + (cend - 1) / g + 1);
    if (a0 + 4 * w < a1)
      cp_async_small<4>(dst + kQScaleOff + r * 16 + 4 * w,
                        reinterpret_cast<const void*>(a0 + 4 * w), true);
  }
}

// The quantized tile of copy_quant, dequantized once into its fp32 tile
// [rows][16] at kQDeqOff: one scale per 8-column vector (g % 8 == 0, the
// wrapper checks), every value exact (xpeft::dequant). Columns past N are
// 0.
__device__ void dequant_tile(unsigned char* st, const __half* s, int groups,
                             int N, int k0, int c0, int rows, int int4) {
  const int g = N / groups;
  float* deq = reinterpret_cast<float*>(st + kQDeqOff);
  for (int i = threadIdx.x; i < rows * 2; i += kThreads) {
    const int r = i >> 1, k = k0 + r, c = c0 + (i & 1) * 8;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
    if (c < N) {
      const uint2 raw = *reinterpret_cast<const uint2*>(st + r * 16 +
                                                        (i & 1) * 8);
      const __half* first = s + k * groups + c0 / g;
      const int off = static_cast<int>(
          (reinterpret_cast<uintptr_t>(first) & 2) >> 1);
      const __half* row =
          reinterpret_cast<const __half*>(st + kQScaleOff + r * 16);
      const float sc = __half2float(row[off + c / g - c0 / g]);
      const int shift = int4 && c >= N / 2 ? 4 : 0;
      const uint32_t word[2] = {raw.x, raw.y};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned b = (word[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        const int qv = int4 ? static_cast<int>((b >> shift) & 0xFu) - 8
                            : static_cast<int>(static_cast<int8_t>(b));
        v[j] = xpeft::dequant(qv, sc);
      }
    }
    float4* o = reinterpret_cast<float4*>(deq + r * kNT + (i & 1) * 8);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ---- tensor-core GEMV over a bf16 weight tile ------------------------------

__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// c += A[16 x 16] . B[16 x 8], bf16 in, fp32 accumulate; A's rows 8-15
// are zero (a1 = a3 = 0).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// acc[n][.] += in[slot][k0 + k] . tile[k][8n + .] for the tile's `rows`
// rows (a multiple of 16): slots are the rows of mma's A operand (lane /
// 4; rows >= NB and 8-15 zero), the tile's column halves its two n-blocks.
// The tile is [kChunk][16] (32 B a row), or with `halves` two [kChunk][8]
// halves (gate|up).
// Warp w takes the 16-row steps w, w + kWarps, ... . in: bf16 [NB][pitch]
// in shared memory.
template <int NB>
__device__ __forceinline__ void mma_tile(const unsigned char* tile,
                                         bool halves, int rows,
                                         const bf16* in, int pitch, int k0,
                                         float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lh = lane >> 4;
  const bf16* a_row = in + g * pitch + k0 + 2 * t;
  for (int ks = warp; ks * 16 < rows; ks += kWarps) {
    const int r = ks * 16 + lr;
    uint32_t b[4];
    ldsm_x4_trans(
        halves ? tile + lh * kHalf + r * 16 : tile + r * 32 + lh * 16, b[0],
        b[1], b[2], b[3]);
    uint32_t a0 = 0, a2 = 0;
    if (g < NB) {
      a0 = *reinterpret_cast<const uint32_t*>(a_row + ks * 16);
      a2 = *reinterpret_cast<const uint32_t*>(a_row + ks * 16 + 8);
    }
    mma_bf16(acc[0], a0, a2, b[0], b[1]);
    mma_bf16(acc[1], a0, a2, b[2], b[3]);
  }
}

// The warps' accumulators of mma_tile summed in warp order: thread o <
// NB * 16 gets slot o / 16, column o % 16 (returned; 0 elsewhere). part:
// [kWarps][NB][16] shared scratch. Every thread calls it.
template <int NB>
__device__ float mma_finish(const float (&acc)[2][4], float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  if (g < NB)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      part[(warp * NB + g) * kNT + n * 8 + 2 * t] = acc[n][0];
      part[(warp * NB + g) * kNT + n * 8 + 2 * t + 1] = acc[n][1];
    }
  csync();
  float s = 0.0f;
  if (threadIdx.x < NB * kNT)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * NB * kNT + threadIdx.x];
  return s;
}

// ---- CUDA-core GEMV of one row over an adapter tile ------------------------

// acc[.] += in[k0 + r] * tile[r][8 v + .] for the tile's rows: thread (r =
// tid / 2, v = tid % 2), one row each (rows <= 256). The tile is bf16
// [rows][16] or the dequantized fp32 [rows][16].
template <typename T>
__device__ __forceinline__ void row_tile(const unsigned char* tile, int rows,
                                         const float* in, int k0,
                                         float (&acc)[8]) {
  const int r = threadIdx.x >> 1, v = threadIdx.x & 1;
  if (r >= rows) return;
  float w[8];
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(tile + r * 32 + v * 16);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = bf(h[j]);
  } else {
    const float4* q = reinterpret_cast<const float4*>(tile + r * 64 + v * 32);
    const float4 a = q[0], b = q[1];
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  }
  const float h = in[k0 + r];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = fmaf(h, w[j], acc[j]);
}

// row_tile's accumulators summed: the row lanes of a warp by shuffles,
// then the warps in order; thread o < 16 gets column o (0 elsewhere).
__device__ float row_finish(float (&acc)[8], float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v = acc[j];
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    acc[j] = v;
  }
  if (lane < 2)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[warp * kNT + lane * 8 + j] = acc[j];
  csync();
  float s = 0.0f;
  if (threadIdx.x < kNT)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * kNT + threadIdx.x];
  return s;
}

// The adapter's hidden row for one slot: LN over nb (population variance),
// the fp32 affine, gelu (tanh form) or identity -> out (global), rounded
// to bf16 on route bf16 (round_bf16) and left fp32 on the quantized
// routes. hh in shared memory; every thread calls it.
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
}

// dst(i, v) for i < n with v = src(i): 8 independent loads in flight per
// thread (an L2 round trip costs ~0.7 us, so a loop that waits for each
// load in turn costs that much per element).
template <typename F, typename G>
__device__ void gather_apply(int n, F src, G dst) {
  constexpr int kBatch = 8;
  for (int base = threadIdx.x; base < n; base += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < n ? src(i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < n) dst(i, v[u]);
    }
  }
}

// The phase's input rows into in [NB][K + kPad] as bf16 (every input of
// the main GEMVs is a bf16 value): in[b][k] = load(b, k) for b < B, 0 for
// the rows up to NB. With norm (RMSNorm1/2), each row is then replaced by
// rnd(v * rsqrt(mean(v^2) + eps) * (1 + norm[k])), warp b summing slot
// b's squares in a fixed order. Each thread keeps 8 columns' loads of
// every row in flight, with no division per element (a runtime integer
// division costs ~40 instructions, and this runs over ~10^4 elements).
// Every thread calls it; synced.
template <int NB, typename F>
__device__ void input_rows(bf16* in, int K, int B, F load, const float* norm,
                           float* s_r) {
  const int pitch = K + kPad, tid = threadIdx.x;
  constexpr int kU = 8;
  float sc0[kU];  // 1 + norm of the first columns, loaded with the rows
  for (int k0 = tid; k0 < K; k0 += kU * kThreads) {
    float v[NB][kU];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * kThreads;
        v[b][u] = b < B && k < K ? load(b, k) : 0.0f;
      }
    if (norm && k0 == tid)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * kThreads;
        sc0[u] = k < K ? __fadd_rn(1.0f, norm[k]) : 0.0f;
      }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * kThreads;
        if (k < K) in[b * pitch + k] = __float2bfloat16_rn(v[b][u]);
      }
  }
  csync();
  if (!norm) return;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < NB) {
    float ss = 0.0f;
    for (int i = lane; i < K; i += 32) {
      const float v = bf(in[warp * pitch + i]);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0)
      s_r[warp] = warp < B
          ? rsqrtf(__fdiv_rn(ss, static_cast<float>(K)) + kNormEps) : 0.0f;
  }
  csync();
  for (int k0 = tid; k0 < K; k0 += kU * kThreads) {
    float sc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = k0 + u * kThreads;
      sc[u] = k0 == tid ? sc0[u] : k < K ? __fadd_rn(1.0f, norm[k]) : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * kThreads;
        if (k < K) {
          bf16* e = in + b * pitch + k;
          *e = __float2bfloat16_rn(__fmul_rn(__fmul_rn(bf(*e), s_r[b]),
                                             sc[u]));
        }
      }
  }
  csync();
}

// Slot b's RMS factor rsqrt(mean(v^2) + eps) of row load(b, 0 .. K-1) into
// s_r[b] (0 for the rows up to NB), for rows too wide for shared memory:
// warp b sums the squares of the same bf16 values in input_rows' order,
// 8 loads in flight per lane. Every thread calls it; synced.
template <int NB, typename F>
__device__ void norm_factors(int K, int B, F load, float* s_r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kU = 8;
  if (warp < NB) {
    float ss = 0.0f;
    for (int i0 = lane; warp < B && i0 < K; i0 += kU * 32) {
      float v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * 32;
        v[u] = i < K ? rnd(load(warp, i)) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (i0 + u * 32 < K) ss = fmaf(v[u], v[u], ss);
    }
    ss = warp_sum(ss);
    if (lane == 0)
      s_r[warp] = warp < B
          ? rsqrtf(__fdiv_rn(ss, static_cast<float>(K)) + kNormEps) : 0.0f;
  }
  csync();
}

// A window of the phase's input rows, depth rows k0 .. k0+n-1, into in
// [NB][pitch] as bf16: in[b][k - k0] as input_rows makes it (with norm,
// from norm_factors' s_r). Every thread calls it; synced.
template <int NB, typename F>
__device__ void window_rows(bf16* in, int pitch, int k0, int n, int B,
                            F load, const float* norm, const float* s_r) {
  constexpr int kU = 8;
  for (int c0 = threadIdx.x; c0 < n; c0 += kU * kThreads) {
    float v[NB][kU], sc[kU];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * kThreads;
        v[b][u] = b < B && c < n ? load(b, k0 + c) : 0.0f;
      }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = c0 + u * kThreads;
      sc[u] = norm && c < n ? __fadd_rn(1.0f, norm[k0 + c]) : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * kThreads;
        if (c < n)
          in[b * pitch + c] = __float2bfloat16_rn(
              norm ? __fmul_rn(__fmul_rn(rnd(v[b][u]), s_r[b]), sc[u])
                   : v[b][u]);
      }
  }
  csync();
}

// ---- the block's tile sequence ------------------------------------------

// The first task of phase ph this block takes (tasks t0, t0 + G, ...; the
// phases' first blocks move on by each phase's task count).
__device__ __forceinline__ int first_task(const Args& p, int ph) {
  const int G = gridDim.x;
  return ((static_cast<int>(blockIdx.x) - p.base[ph]) % G + G) % G;
}
__device__ __forceinline__ int count_tasks(const Args& p, int ph) {
  const int t0 = first_task(p, ph), n = p.ntask[ph];
  return t0 < n ? (n - 1 - t0) / static_cast<int>(gridDim.x) + 1 : 0;
}

// An attention item: slot b, head h, split sp; its cache rows are
// s0 .. s0 + nrows - 1 (only the rows the slot attends).
struct Item {
  int b, h, sp, s0, nrows, bh;
};
__device__ __forceinline__ Item item_of(const Args& p, int t,
                                        const int* s_pos) {
  Item it;
  it.sp = t % p.nsplit;
  it.bh = t / p.nsplit;
  it.b = it.bh / p.H;
  it.h = it.bh % p.H;
  it.s0 = it.sp * p.sc;
  const int need = min(s_pos[it.b], p.S - 1) + 1;
  it.nrows = max(0, min(p.sc, need - it.s0));
  return it;
}

// Chunk ch of task t of phase ph into a stage, by the producer warp,
// completing on the stage's full barrier: the weights and cache rows by
// TMA (lane 0 arrives with the bytes to expect and issues the boxes), the
// adapter's tiles by the lanes' cp.async (each lane's copies hold the
// barrier's phase open until they land; lane 0 arrives).
__device__ void copy_task(const Args& p, int ph, int t, int ch,
                          unsigned char* dst, uint64_t* bar,
                          const int* s_pos) {
  const int d = p.d;
  if (ph == kAdUp) {
    const int b = t % p.B, c0 = t / p.B * kNT, a0 = ch * kAChunk;
    const int rows = min(kAChunk, p.nb - a0);
    if (p.adapter == kBf16)
      copy_adapter(dst, p.b_hat + b * p.b_bs, d, c0, a0, rows);
    else
      copy_quant(dst, p.b_q + b * p.bq_bs, p.b_s + b * p.bs_bs, p.b_groups,
                 d, a0, c0, rows, p.adapter == kInt4);
    mbar_arrive_cp_async(bar);
    __syncwarp();  // every lane's pending arrival is counted first
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
    return;
  }
  if (threadIdx.x & 31) return;
  // the stage was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (ph == kAttnK || ph == kAttnV) {
    const Item it = item_of(p, t, s_pos);
    const int boxes = (it.nrows + kKVBox - 1) / kKVBox;
    const int kvh = it.h / (p.H / p.KV), box_bytes = kKVBox * p.hd * p.kvb;
    const bool both = ph == kAttnK && p.nsplit == 1;
    mbar_arrive_tx(bar, boxes * box_bytes * (both ? 2 : 1));
    const int r0 = it.b * p.S + it.s0;
    for (int i = 0; i < boxes; ++i) {
      const int r = r0 + i * kKVBox;
      tma_3d(dst + i * box_bytes, ph == kAttnK ? &p.tm_kc : &p.tm_vc, 0, kvh,
             r, bar);
      if (both)
        tma_3d(dst + p.sc * p.hd * p.kvb + i * box_bytes, &p.tm_vc, 0, kvh,
               r, bar);
    }
    return;
  }
  // rows past K arrive as zeros; the box's bytes count all the same
  mbar_arrive_tx(bar, kStage);
  const int slab = ch * (kChunk / 16);
  if (ph == kGU) {  // g and u: two [kChunk][8] halves
    tma_3d(dst, &p.tm_wg, t * 8, 0, slab, bar);
    tma_3d(dst + kHalf, &p.tm_wu, t * 8, 0, slab, bar);
    return;
  }
  const CUtensorMap* m = ph == kWo ? &p.tm_wo : &p.tm_wd;
  int c0 = t * kNT;
  if (ph == kQKV) {
    m = &p.tm_wq;
    if (t >= p.nct_q + p.nct_kv) {
      m = &p.tm_wv, c0 = (t - p.nct_q - p.nct_kv) * kNT;
    } else if (t >= p.nct_q) {
      m = &p.tm_wk, c0 = (t - p.nct_q) * kNT;
    }
  }
  tma_3d(dst, m, c0, 0, slab, bar);  // one [kChunk][16] tile
}

// Issues tile i of the block's sequence (if there is one) into its stage
// (the producer warp). s_seq[ph] is the index of the block's first tile
// of phase ph.
__device__ void issue(const Args& p, int i, unsigned char* ring,
                      uint64_t* bars, const int* s_seq, const int* s_pos) {
  if (i >= s_seq[kPhases]) return;
  int ph = 0;
  while (i >= s_seq[ph + 1]) ++ph;
  const int m = i - s_seq[ph], nch = p.nchunk[ph];
  const int t = first_task(p, ph) + (m / nch) * gridDim.x;
  copy_task(p, ph, t, m % nch, ring + (i % kStages) * kStage,
            bars + i % kStages, s_pos);
}

// sq, sk: q and the new k of item `it` after RoPE (bf16 values); sv the
// new v; from the finished q|k|v rows, k and v read back through the
// cache's type (kv_round). Threads < hd; synced.
__device__ void item_qkv(const Args& p, const Item& it, int pos,
                         const float* g_qkv, float* sq, float* sk,
                         float* sv) {
  const int tid = threadIdx.x, hd = p.hd, half = hd / 2;
  const int nq = p.H * hd, nkv = p.KV * hd, kvh = it.h / (p.H / p.KV);
  if (tid < hd) {
    const int i = tid < half ? tid : tid - half;
    const float* qkv = g_qkv + static_cast<long long>(it.b) * (nq + 2 * nkv);
    const int qc = it.h * hd, kc = nq + kvh * hd;
    const float q1 = ldcg(qkv + qc + i), q2 = ldcg(qkv + qc + i + half);
    const float k1 = ldcg(qkv + kc + i), k2 = ldcg(qkv + kc + i + half);
    const float v = ldcg(qkv + nq + nkv + kvh * hd + tid);
    const float ang = __fmul_rn(static_cast<float>(pos), p.inv_freq[i]);
    const float cs = cosf(ang), sn = sinf(ang);
    float qr, kr;
    if (tid < half) {
      qr = __fsub_rn(__fmul_rn(q1, cs), __fmul_rn(q2, sn));
      kr = __fsub_rn(__fmul_rn(k1, cs), __fmul_rn(k2, sn));
    } else {
      qr = __fadd_rn(__fmul_rn(q1, sn), __fmul_rn(q2, cs));
      kr = __fadd_rn(__fmul_rn(k1, sn), __fmul_rn(k2, cs));
    }
    sq[tid] = rnd(qr);
    sk[tid] = kv_round(p, rnd(kr));
    sv[tid] = kv_round(p, v);
  }
  csync();
}

// Cache value i of a tile of rows as fp32: bf16, or float8_e4m3fn bytes
// (exact either way). The loops below take it as a template argument, so
// each cache type has its own loop and the bf16 one is what it was.
struct Bf16Vals {
  const bf16* t;
  __device__ __forceinline__ float operator()(int i) const { return bf(t[i]); }
};
struct F8Vals {
  const uint8_t* t;
  __device__ __forceinline__ float operator()(int i) const {
    return f8_val(t[i]);
  }
};

// The logits of item `it` against its K rows (k_tile, in the cache's type;
// the new row at pos), scaled and capped, into lg[r]; then m = their max
// and the sum of exp(lg - m). Every thread calls it.
template <typename V>
__device__ __forceinline__ void item_dots(const Args& p, const Item& it,
                                          int pos, V k_val, const float* sq,
                                          const float* sk, float* lg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, hd = p.hd;
  for (int r = warp; r < it.nrows; r += kWarps) {
    const bool at_pos = it.s0 + r == pos;
    float acc = 0.0f;
    for (int c = lane; c < hd; c += 32)
      acc = fmaf(sq[c], at_pos ? sk[c] : k_val(r * hd + c), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      float l = __fmul_rn(acc, p.scale);
      if (p.cap > 0.0f) l = __fmul_rn(tanhf(__fdiv_rn(l, p.cap)), p.cap);
      lg[r] = l;
    }
  }
}
__device__ void item_logits(const Args& p, const Item& it, int pos,
                            const unsigned char* k_tile, const float* sq,
                            const float* sk, float* lg, float* red,
                            float& m, float& sum) {
  if (p.f8)
    item_dots(p, it, pos, F8Vals{k_tile}, sq, sk, lg);
  else
    item_dots(p, it, pos, Bf16Vals{reinterpret_cast<const bf16*>(k_tile)},
              sq, sk, lg);
  csync();
  const int tid = threadIdx.x;
  m = block_max(tid < it.nrows ? lg[tid] : kNegInf, red);
  sum = block_sum(tid < it.nrows ? expf(__fsub_rn(lg[tid], m)) : 0.0f, red);
}

// sum over the item's rows of w[r] * V[r] (v_tile, in the cache's type;
// the new row at pos) for column tid % hd, the row groups added in order
// -> returned to threads < hd. Every thread calls it.
template <typename V>
__device__ __forceinline__ float item_wv_rows(const Args& p, const Item& it,
                                              int pos, V v_val,
                                              const float* sv,
                                              const float* w) {
  const int tid = threadIdx.x, hd = p.hd, groups = kThreads / hd;
  const int jd = tid % hd;
  float acc = 0.0f;
  for (int r = tid / hd; r < it.nrows; r += groups)
    acc = fmaf(w[r], it.s0 + r == pos ? sv[jd] : v_val(r * hd + jd), acc);
  return acc;
}
__device__ float item_wv(const Args& p, const Item& it, int pos,
                         const unsigned char* v_tile, const float* sv,
                         const float* w, float* ored) {
  const int tid = threadIdx.x, hd = p.hd, groups = kThreads / hd;
  const float acc =
      p.f8 ? item_wv_rows(p, it, pos, F8Vals{v_tile}, sv, w)
           : item_wv_rows(p, it, pos,
                          Bf16Vals{reinterpret_cast<const bf16*>(v_tile)}, sv,
                          w);
  ored[tid] = acc;
  csync();
  float s = 0.0f;
  if (tid < hd)
    for (int gg = 0; gg < groups; ++gg) s += ored[gg * hd + tid];
  return s;
}

// Columns 8v .. 8v+7 of row k of slot b's A_hat in fp32, from the route's
// storage: bf16, or int8 / planar int4 bytes times their scale (exact,
// xpeft::dequant; one scale per 8 columns, the wrapper checks).
__device__ void adapter_a8(const Args& p, int b, int k, int v,
                           float (&w)[8]) {
  const int nb = p.nb, c = 8 * v;
  if (p.adapter == kBf16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        p.a_hat + b * p.a_bs + static_cast<long long>(k) * nb + c));
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = bf(h[j]);
    return;
  }
  const int int4 = p.adapter == kInt4;
  const int byte = int4 && c >= nb / 2 ? c - nb / 2 : c;
  const int shift = int4 && c >= nb / 2 ? 4 : 0;
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
      p.a_q + b * p.aq_bs + static_cast<long long>(k) * (int4 ? nb / 2 : nb) +
      byte));
  const float sc = __half2float(__ldg(
      p.a_s + b * p.as_bs + static_cast<long long>(k) * p.a_groups +
      c / (nb / p.a_groups)));
  const uint32_t word[2] = {raw.x, raw.y};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned q = (word[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    const int qv = int4 ? static_cast<int>((q >> shift) & 0xFu) - 8
                        : static_cast<int>(static_cast<int8_t>(q));
    w[j] = xpeft::dequant(qv, sc);
  }
}

// The producer warp: issues the block's tiles in sequence, each once the
// consumers have freed its stage (the empty barriers, bars[kStages +
// s]), and meets the consumers at every grid.sync(). Before the barrier
// that ends group g (QKV | attention | Wo | gate|up | down | adapter up)
// it issues the next group's first tile (waiting for its stage) and
// further tiles only into stages already free: waiting for each would
// hold every block at the barrier for the TMA issue of the group's last
// tiles (~1 us), and the stages freed last hold later tiles anyway. The
// adapter's tiles (by cp.async, which would stall the consumers' loads)
// wait for their group.
__device__ void producer(const Args& p, unsigned char* ring, uint64_t* bars,
                         const int* s_seq, const int* s_pos,
                         cg::grid_group& grid) {
  const int total = s_seq[kPhases];
  const int ends[5] = {s_seq[kAttnK], s_seq[kWo], s_seq[kGU], s_seq[kDown],
                       s_seq[kAdUp]};
  int next = 0;
  for (int g = 0;; ++g) {
    const int limit = g < 5 ? min(min(ends[g] + kStages, s_seq[kAdUp]), total)
                            : total;
    for (; next < limit; ++next) {
      if (next >= kStages) {
        uint64_t* empty = bars + kStages + next % kStages;
        const int parity = (next / kStages - 1) & 1;
        if (g < 5 && next > ends[g]) {
          // ahead: only a free stage (lane 0 decides for the warp)
          if (!__shfl_sync(0xffffffffu, mbar_test(empty, parity), 0)) break;
        } else {
          mbar_wait(empty, parity);
        }
      }
      issue(p, next, ring, bars, s_seq, s_pos);
    }
    if (g == 5 || (g == 4 && !p.adapter)) return;
    grid.sync();
  }
}

// NB: the slot rows; WIN: input rows in windows (some GEMV depth past
// kin); GELU: the MLP's gate activation gelu (tanh form), else silu. Each
// a template parameter, so that an instantiation holds no code of the
// others: qwen1.5-0.5b's, <4 | 8, false, false>, hold neither windows nor
// the gelu gate (both cost it time on the card when compiled in).
template <int NB, bool WIN, bool GELU>
__global__ void __launch_bounds__(kBlock, 1)
    decode_block_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int B = p.B, d = p.d, hd = p.hd, ff = p.ff;
  const int nq = p.H * hd, nkv = p.KV * hd, nqkv = nq + 2 * nkv;
  const int G = gridDim.x;

  unsigned char* ring = smem;
  // the phase's input rows, bf16 [NB][K + kPad] (K <= kin) or a window of
  // them [NB][kin + kPad]; the attention and adapter phases' buffers in
  // the same space
  bf16* s_in = reinterpret_cast<bf16*>(smem + kStages * kStage);
  float* s_part = reinterpret_cast<float*>(s_in + NB * (p.kin + kPad));
  float* s_misc = s_part + kWarps * NB * kNT;
  float* s_r = s_misc;                      // [8] norm factors
  float* s_red = s_misc + 8;                // [kWarps]
  float* s_ml = s_misc + 24;                // attention max, sum
  int* s_flag = reinterpret_cast<int*>(s_misc + 26);
  int* s_pos = reinterpret_cast<int*>(s_misc + 28);   // [8]
  int* s_seq = reinterpret_cast<int*>(s_misc + 36);   // [kPhases + 1]
  // [kStages] full, then [kStages] empty barriers
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_misc + 48);
  float* s_f = reinterpret_cast<float*>(s_in);       // as fp32 scratch

  float* scr = p.scratch;
  float* g_qkv = scr + p.o_qkv;   // [B][nqkv] q|k|v, bf16 values
  float* g_lg = scr + p.o_lg;     // [nitems][sc] logits (split S)
  float* g_ml = scr + p.o_ml;     // [nitems][2] max, sum of exp
  float* g_op = scr + p.o_op;     // [nitems][hd] partial o
  float* g_o = scr + p.o_o;       // [B][nq] attention output
  float* g_x1 = scr + p.o_x1;     // [B][d]
  float* g_act = scr + p.o_act;   // [B][ff] act(g) * u
  float* g_x2 = scr + p.o_x2;     // [B][d]
  float* g_phh = scr + p.o_phh;   // [d / 16][B][nb] x2 . A_hat partials
  int* cnt = reinterpret_cast<int*>(scr + p.o_cnt);

  // the small vectors the phases read once each: into L2 now, ahead of
  // the weight stream, each block taking every G-th 128-byte line
  {
    const int nl = 8;
    const void* base[nl] = {p.x, p.n1, p.n2, p.bq, p.bk, p.bv, p.inv_freq,
                            p.pos};
    const int bytes[nl] = {B * d * 2, d * 4, d * 4,
                           p.qkv_bias ? nq * 4 : 0,
                           p.qkv_bias ? nkv * 4 : 0,
                           p.qkv_bias ? nkv * 4 : 0, hd * 2, B * 4};
    int total = 0;
    for (int v = 0; v < nl; ++v) total += (bytes[v] + 127) / 128;
    if (tid < 32)
      for (int l = static_cast<int>(blockIdx.x) + tid * G; l < total;
           l += 32 * G) {
        int v = 0, o = l;
        while (o >= (bytes[v] + 127) / 128) o -= (bytes[v++] + 127) / 128;
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            static_cast<const char*>(base[v]) + o * 128));
      }
  }
  if (tid < NB) s_pos[tid] = tid < B ? p.pos[tid] : 0;
  if (tid == 0) {
    // the TMA descriptors into the descriptor cache
    const CUtensorMap* maps[] = {&p.tm_wq, &p.tm_wk, &p.tm_wv,
                                 &p.tm_wo, &p.tm_wg, &p.tm_wu,
                                 &p.tm_wd, &p.tm_kc, &p.tm_vc};
    for (const CUtensorMap* m : maps)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(m) : "memory");
    int acc = 0;
    for (int ph = 0; ph < kPhases; ++ph) {
      s_seq[ph] = acc;
      acc += count_tasks(p, ph) * p.nchunk[ph];
    }
    s_seq[kPhases] = acc;
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the whole block, producer warp included
  if (warp == kWarps) {
    producer(p, ring, bars, s_seq, s_pos, grid);
    return;
  }
  // the phases' inputs: x, the attention output, x1, act(g) * u
  auto x_in = [&](int b, int k) { return bf(p.x[b * d + k]); };
  auto o_in = [&](int b, int k) { return ldcg(g_o + b * nq + k); };
  auto x1_in = [&](int b, int k) { return ldcg(g_x1 + b * d + k); };
  auto act_in = [&](int b, int k) { return ldcg(g_act + b * ff + k); };
  // a phase's input rows, whole where they fit (K <= kin); else only the
  // norm's factors here, the windows as the tasks reach them (mma_task)
  auto phase_rows = [&](int K, auto&& load, const float* norm) {
    if constexpr (WIN) {
      if (K > p.kin) {
        if (norm) norm_factors<NB>(K, B, load, s_r);
        return;
      }
    }
    input_rows<NB>(s_in, K, B, load, norm, s_r);
  };
  // phase 0's input rows before the weight stream, which would queue
  // ahead of them
  if (count_tasks(p, kQKV)) phase_rows(d, x_in, p.n1);
  // the counters start at 0; first used after the first grid.sync
  for (int i = blockIdx.x * kThreads + tid; i < p.ncnt; i += G * kThreads)
    cnt[i] = 0;

  int seq = 0;  // the block's next tile
  // the next tile, landed and visible to the consumers
  auto next_tile = [&]() -> unsigned char* {
    mbar_wait(bars + seq % kStages, (seq / kStages) & 1);
    return ring + (seq % kStages) * kStage;
  };
  // the tile's stage is free again once every consumer is done with it
  auto done_tile = [&]() {
    csync();
    if (tid == 0) mbar_arrive(bars + kStages + seq % kStages);
    ++seq;
  };
  // a main-phase task: its chunks through the tensor cores, then the
  // epilogue fn(slot, column in the task, sum) on thread slot * 16 + col;
  // rows wider than kin come in windows of kin depth rows (load, norm:
  // the phase's input, as phase_rows takes it)
  auto mma_task = [&](int ph, int K, auto&& load, const float* norm,
                      auto&& fn) {
    const bool whole = !WIN || K <= p.kin;
    const int pitch = (whole ? K : p.kin) + kPad;
    float acc[2][4] = {};
    for (int ch = 0; ch < p.nchunk[ph]; ++ch) {
      const int k0 = ch * kChunk, w0 = whole ? 0 : k0 / p.kin * p.kin;
      // the stage's last reader passed done_tile's barrier
      if constexpr (WIN)
        if (!whole && k0 == w0)
          window_rows<NB>(s_in, pitch, w0, min(p.kin, K - w0), B, load,
                          norm, s_r);
      const unsigned char* tile = next_tile();
      mma_tile<NB>(tile, ph == kGU, min(kChunk, K - k0), s_in, pitch,
                   k0 - w0, acc);
      if (ch + 1 < p.nchunk[ph]) done_tile();
    }
    const float s = mma_finish<NB>(acc, s_part);
    if (tid < B * kNT) fn(tid / kNT, tid % kNT, s);
    done_tile();
  };

  // 0. RMSNorm1 + QKV (+ bias)
  if (count_tasks(p, kQKV)) {
    for (int j = 0, t = first_task(p, kQKV); j < count_tasks(p, kQKV);
         ++j, t += G) {
      const float* bias = p.bq;
      int N = nq, c0 = t * kNT, off = 0;
      if (t >= p.nct_q + p.nct_kv) {
        bias = p.bv, N = nkv, c0 = (t - p.nct_q - p.nct_kv) * kNT;
        off = nq + nkv;
      } else if (t >= p.nct_q) {
        bias = p.bk, N = nkv, c0 = (t - p.nct_q) * kNT, off = nq;
      }
      // the epilogue's operands load before the GEMV, which hides their
      // latency (here and in the phases below)
      const int cc = c0 + tid % kNT;
      const float bv = p.qkv_bias && tid < B * kNT && cc < N ? bias[cc] : 0.0f;
      mma_task(kQKV, d, x_in, p.n1, [&](int b, int c, float s) {
        if (c0 + c >= N) return;
        float v = rnd(s);
        if (p.qkv_bias) v = rnd(v + rnd(bv));
        g_qkv[b * nqkv + off + c0 + c] = v;
      });
    }
  }
  grid.sync();

  // 1. attention over the rows each slot attends
  {
    const int sc = p.sc;
    float* sq = s_f;
    float* sk = sq + hd;
    float* sv = sk + hd;
    float* lg = sv + hd;       // [sc] logits, then weights
    float* ored = lg + sc;     // [kThreads] w.V partials, split sums
    for (int j = 0, t = first_task(p, kAttnK); j < count_tasks(p, kAttnK);
         ++j, t += G) {
      const Item it = item_of(p, t, s_pos);
      const int pos = s_pos[it.b];
      const unsigned char* tile = next_tile();
      item_qkv(p, it, pos, g_qkv, sq, sk, sv);
      if (it.sp == 0 && it.h % (p.H / p.KV) == 0 && tid < hd) {
        const long long r =
            (static_cast<long long>(it.b) * p.KV + it.h / (p.H / p.KV)) * hd;
        if (p.f8) {  // sk, sv hold e4m3 values: f8_of gives their bytes
          static_cast<uint8_t*>(p.k_row)[r + tid] = f8_of(sk[tid]);
          static_cast<uint8_t*>(p.v_row)[r + tid] = f8_of(sv[tid]);
        } else {
          static_cast<bf16*>(p.k_row)[r + tid] = __float2bfloat16_rn(sk[tid]);
          static_cast<bf16*>(p.v_row)[r + tid] = __float2bfloat16_rn(sv[tid]);
        }
      }
      float m, sum;
      item_logits(p, it, pos, tile, sq, sk, lg, s_red, m, sum);
      if (p.nsplit == 1) {
        // the whole row is here: weights, w.V, done
        if (tid < it.nrows)
          lg[tid] = rnd(__fdiv_rn(expf(__fsub_rn(lg[tid], m)), sum));
        csync();
        const float o =
            item_wv(p, it, pos, tile + sc * hd * p.kvb, sv, lg, ored);
        if (tid < hd) g_o[it.b * nq + it.h * hd + tid] = rnd(o);
      } else {
        if (tid < it.nrows)
          g_lg[static_cast<long long>(t) * sc + tid] = lg[tid];
        if (tid == 0) {
          g_ml[2 * t] = m;
          g_ml[2 * t + 1] = sum;
        }
        __threadfence();
        csync();
        if (tid == 0) atomicAdd(cnt + p.c_k + it.bh, 1);
      }
      done_tile();
    }
    for (int j = 0, t = first_task(p, kAttnV); j < count_tasks(p, kAttnV);
         ++j, t += G) {
      const Item it = item_of(p, t, s_pos);
      const int pos = s_pos[it.b];
      const unsigned char* tile = next_tile();
      if (warp == 0) {
        if (lane == 0) {
          // a peer that never arrives is a fault: trap (the launch then
          // fails) rather than spin for ever
          volatile int* c = cnt + p.c_k + it.bh;
          for (long long n = 0; *c < p.nsplit; ++n) {
            if (n > (1LL << 26)) __trap();
            __nanosleep(32);
          }
          __threadfence();
        }
        __syncwarp();
        // the splits' (max, sum of exp): the global max, then the sums of
        // exp rescaled to it, added in split order
        const float* ml = g_ml + 2LL * it.bh * p.nsplit;
        float M = kNegInf;
        for (int s = lane; s < p.nsplit; s += 32)
          M = fmaxf(M, ldcg(ml + 2 * s));
        M = warp_max(M);
        for (int s = lane; s < p.nsplit; s += 32) {
          const float l = ldcg(ml + 2 * s + 1);
          ored[s] = l > 0.0f
              ? __fmul_rn(l, expf(__fsub_rn(ldcg(ml + 2 * s), M))) : 0.0f;
        }
        __syncwarp();
        if (lane == 0) {
          float L = 0.0f;
          for (int s = 0; s < p.nsplit; ++s) L = __fadd_rn(L, ored[s]);
          s_ml[0] = M;
          s_ml[1] = L;
        }
      }
      if (tid < hd && pos >= it.s0 && pos < it.s0 + it.nrows)
        sv[tid] = kv_round(
            p, ldcg(g_qkv + static_cast<long long>(it.b) * nqkv + nq + nkv +
                    it.h / (p.H / p.KV) * hd + tid));
      csync();
      if (tid < it.nrows)
        lg[tid] = rnd(__fdiv_rn(
            expf(__fsub_rn(ldcg(g_lg + static_cast<long long>(t) * sc + tid),
                           s_ml[0])),
            s_ml[1]));
      csync();
      const float o = item_wv(p, it, pos, tile, sv, lg, ored);
      if (tid < hd) g_op[static_cast<long long>(t) * hd + tid] = o;
      if (arrive_last(cnt + p.c_v + it.bh, p.nsplit, s_flag) && tid < hd) {
        // the splits' partial o added in split order, 8 loads in flight
        const float* op = g_op + static_cast<long long>(it.bh) * p.nsplit * hd;
        float s = 0.0f;
        for (int s0 = 0; s0 < p.nsplit; s0 += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = s0 + u < p.nsplit ? ldcg(op + (s0 + u) * hd + tid) : 0.0f;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (s0 + u < p.nsplit) s += v[u];
        }
        g_o[it.b * nq + it.h * hd + tid] = rnd(s);
      }
      done_tile();
    }
  }
  grid.sync();

  // 2. out-projection + residual
  if (count_tasks(p, kWo)) {
    phase_rows(nq, o_in, nullptr);
    for (int j = 0, t = first_task(p, kWo); j < count_tasks(p, kWo);
         ++j, t += G) {
      const int c0 = t * kNT, cc = c0 + tid % kNT;
      const float xv = tid < B * kNT && cc < d
          ? bf(p.x[tid / kNT * d + cc]) : 0.0f;
      mma_task(kWo, nq, o_in, nullptr, [&](int b, int c, float s) {
        if (c0 + c < d) g_x1[b * d + c0 + c] = rnd(xv + rnd(s));
      });
    }
  }
  grid.sync();

  // 3. RMSNorm2 + gate|up + act(g) * u: columns 0-7 of a task's sums are
  // g, 8-15 u, of the same 8 columns of ff
  if (count_tasks(p, kGU)) {
    phase_rows(d, x1_in, p.n2);
    for (int j = 0, t = first_task(p, kGU); j < count_tasks(p, kGU);
         ++j, t += G) {
      const int c0 = t * 8;
      mma_task(kGU, d, x1_in, p.n2, [&](int b, int c, float s) {
        s_part[kWarps * NB * kNT - kNT * NB + b * kNT + c] = s;
      });
      // g and u meet in shared memory (the part buffer's last row block,
      // which mma_finish of the next task writes only after a barrier)
      csync();
      if (tid < B * 8) {
        const int b = tid / 8, c = tid % 8;
        const float* gu = s_part + kWarps * NB * kNT - kNT * NB + b * kNT;
        if (c0 + c < ff) {
          const float g = rnd(gu[c]), u = rnd(gu[8 + c]);
          const float a = rnd(GELU ? gelu_tanh(g)
                                   : __fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
          g_act[b * ff + c0 + c] = rnd(__fmul_rn(a, u));
        }
      }
      csync();
    }
  }
  grid.sync();

  // 4. down-projection + residual (the output on route none)
  if (count_tasks(p, kDown)) {
    phase_rows(ff, act_in, nullptr);
    // the task's x2 columns, kept for the adapter's down-projection
    float* s_x2 = s_part + (kWarps - 1) * NB * kNT;  // [NB][16]
    const int nbv = p.nb / 8, items = B * kNT * nbv;
    for (int j = 0, t = first_task(p, kDown); j < count_tasks(p, kDown);
         ++j, t += G) {
      const int c0 = t * kNT;
      // item i: slot b, column vector v of A_hat, row c0 + r (r = i % 16,
      // so a row's 16 items sit in 16 neighbouring lanes); the first
      // pass's A values load before the GEMV, which hides their latency
      float w[8] = {};
      auto load_a = [&](int i) {
        const int b = i / (kNT * nbv), v = i / kNT % nbv, k = c0 + i % kNT;
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = 0.0f;
        if (i < items && k < d) adapter_a8(p, b, k, v, w);
      };
      if (p.adapter) load_a(tid);
      const int cc = c0 + tid % kNT;
      const float x1v = tid < B * kNT && cc < d
          ? ldcg(g_x1 + tid / kNT * d + cc) : 0.0f;
      mma_task(kDown, ff, act_in, nullptr, [&](int b, int c, float s) {
        if (c0 + c >= d) return;
        const float v = rnd(x1v + rnd(s));
        if (p.adapter) {
          g_x2[b * d + c0 + c] = v;
          s_x2[b * kNT + c] = v;
        } else {
          p.y[b * d + c0 + c] = __float2bfloat16_rn(v);
        }
      });
      // the adapter's down-projection folded in: this tile's share of
      // x2[b] . A_hat[b], the 16 rows added by shuffles in a fixed order;
      // the up-projection adds the d / 16 shares in tile order
      for (int i0 = 0; p.adapter && i0 < items; i0 += kThreads) {
        const int i = i0 + tid;
        if (i0) load_a(i);
        const int b = i / (kNT * nbv), r = i % kNT;
        const float x = i < items && c0 + r < d ? s_x2[b * kNT + r] : 0.0f;
        float a[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          a[q] = x * w[q];
#pragma unroll
          for (int off = 1; off < kNT; off <<= 1)
            a[q] += __shfl_xor_sync(0xffffffffu, a[q], off);
        }
        if (r == 0 && i < items)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            g_phh[(static_cast<long long>(t) * B + b) * p.nb +
                  i / kNT % nbv * 8 + q] = a[q];
      }
      csync();
    }
  }
  if (!p.adapter) return;  // uniform over the grid: no block is left waiting
  grid.sync();

  const bool quant = p.adapter == kInt8 || p.adapter == kInt4;
  const int int4 = p.adapter == kInt4, nb = p.nb;
  // an adapter task: its chunks on CUDA cores in fp32 (in: fp32 [K] in
  // shared memory), dequantized first on routes int8/int4; thread c < 16
  // gets column c's sum
  auto row_task = [&](int ph, int K, const float* in, const __half* s,
                      int groups, int N, int c0) {
    float acc[8] = {};
    for (int ch = 0; ch < p.nchunk[ph]; ++ch) {
      unsigned char* tile = next_tile();
      const int a0 = ch * kAChunk, rows = min(kAChunk, K - a0);
      if (quant) {
        dequant_tile(tile, s, groups, N, a0, c0, rows, int4);
        csync();
        row_tile<float>(tile + kQDeqOff, rows, in, a0, acc);
      } else {
        row_tile<bf16>(tile, rows, in, a0, acc);
      }
      if (ch + 1 < p.nchunk[ph]) done_tile();
    }
    return row_finish(acc, s_part);
  };

  // 5. LN over the summed shares of x2 . A_hat and the activation (once
  // per block and slot), up-projection . B_hat + residual
  {
    const int nct = (d + kNT - 1) / kNT;
    float* s_h = s_part + 256;  // [nb]; row_finish uses s_part[0, 256)
    const int cap = NB * (p.kin + kPad) / 2;  // s_f's floats
    int cur = -1;
    for (int j = 0, t = first_task(p, kAdUp); j < count_tasks(p, kAdUp);
         ++j, t += G) {
      // slot-minor: a block's tasks t, t + G share a slot where B divides
      // G (4 slots on 132 SMs), so its LN runs once
      const int b = t % B, c0 = t / B * kNT;
      if (b != cur) {
        // hh[b] = the d / 16 shares summed in tile order: groups of
        // `span` tiles summed by kThreads / nb threads a column, then the
        // groups in order
        float* hh = s_part;  // [nb]
        const int groups = kThreads / nb, gi = tid / nb, col = tid % nb;
        float sum = 0.0f;
        const int per = max(1, cap / nb) / groups * groups;
        for (int q0 = 0; q0 < nct; q0 += per) {
          const int qn = min(per, nct - q0), span = (qn + groups - 1) / groups;
          gather_apply(qn * nb,
                       [&](int i) {
                         return ldcg(g_phh +
                                     (static_cast<long long>(q0 + i / nb) *
                                          B + b) * nb + i % nb);
                       },
                       [&](int i, float v) { s_f[i] = v; });
          csync();
          float part = 0.0f;
          if (gi < groups)
            for (int q = gi * span; q < min(qn, (gi + 1) * span); ++q)
              part += s_f[q * nb + col];
          csync();
          if (gi < groups) s_f[gi * nb + col] = part;
          csync();
          if (tid < nb)
            for (int g = 0; g < groups; ++g) sum += s_f[g * nb + tid];
          csync();
        }
        if (tid < nb) hh[tid] = sum;
        csync();
        adapter_hidden(hh, p.ln_s + b * p.ln_bs, p.ln_b + b * p.ln_bs, nb,
                       p.gelu, !quant, s_h, s_red);
        csync();
        cur = b;
      }
      const float x2 = tid < kNT && c0 + tid < d
          ? ldcg(g_x2 + b * d + c0 + tid) : 0.0f;
      const float s = row_task(kAdUp, nb, s_h, p.b_s + b * p.bs_bs,
                               p.b_groups, d, c0);
      if (tid < kNT && c0 + tid < d) {
        const int c = c0 + tid;
        p.y[b * d + c] = __float2bfloat16_rn(
            quant ? __fadd_rn(x2, s) : rnd(x2 + rnd(s)));
      }
      done_tile();
    }
  }
}

// Dynamic shared memory: the ring, the input rows (kin depth rows), the
// warps' partial sums and 64 words of per-block state.
long long smem_bytes(int NB, int kin) {
  return static_cast<long long>(kStages) * kStage +
         2LL * NB * (kin + kPad) + 4LL * (kWarps * NB * kNT + kMisc);
}

// The depth rows of an input row held in shared memory: all kmax where NB
// rows fit, else the widest whole number of weight tiles (windows).
int in_width(int NB, int kmax) {
  if (smem_bytes(NB, kmax) <= kMaxSmem) return kmax;
  const long long room = kMaxSmem - smem_bytes(NB, 0) + 2LL * NB * kPad;
  return static_cast<int>((room / (2 * NB) - kPad) / kChunk * kChunk);
}

// The (windows, gelu) pair's instantiation for NB slot rows.
template <bool WIN, bool GELU>
const void* pair_kernel(int NB) {
  return NB == 8
             ? reinterpret_cast<const void*>(decode_block_kernel<8, WIN, GELU>)
             : reinterpret_cast<const void*>(decode_block_kernel<4, WIN, GELU>);
}

// The instantiation for NB slot rows, windows or not, gelu or silu.
const void* kernel_of(int NB, bool win, bool gelu) {
#ifdef XPEFT_DEC_PART
  const void* (*const part[4])(int) = {
      xpeft_decode_kernel_part0, xpeft_decode_kernel_part1,
      xpeft_decode_kernel_part2, xpeft_decode_kernel_part3};
  return part[2 * win + gelu](NB);
#else
  if (win) return gelu ? pair_kernel<true, true>(NB)
                       : pair_kernel<true, false>(NB);
  return gelu ? pair_kernel<false, true>(NB) : pair_kernel<false, false>(NB);
#endif
}

cudaError_t config(const void* kernel, long long smem, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kBlock, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  return cudaSuccess;
}

cudaError_t launch(const void* kernel, Args& a, int grid, long long smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kBlock), args, static_cast<size_t>(smem),
      stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation that holds B slots (rows past B are zero and never
// stored): the engine's default of 4 slots, or up to 8.
int slot_bucket(int B) { return B < 1 ? 0 : B <= 4 ? 4 : B <= 8 ? 8 : 0; }

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

int kmax_of(const Args& a) {
  const int nq = a.H * a.hd;
  return a.d > nq ? (a.d > a.ff ? a.d : a.ff) : (nq > a.ff ? nq : a.ff);
}

int kin_of(const Args& a) { return in_width(slot_bucket(a.B), kmax_of(a)); }

// The shapes the kernel is built for (the wrapper's plan returns nothing
// else): widths multiples of 16, hd a power of two in [16, 256], the
// attention split's rows (sc) within one stage at the cache's bytes a
// value (its K and V rows when one split covers S), the per-block buffers
// within the input rows' space and
// the shared memory within the card's 227 KB (rows wider than that come
// in windows of kin depth rows).
bool valid(const Args& a) {
  const bool quant = a.adapter == kInt8 || a.adapter == kInt4;
  const int nb_slots = slot_bucket(a.B);
  if (!nb_slots || a.H < 1 || a.KV < 1 || a.H % a.KV || !is_pow2(a.hd) ||
      a.hd < 16 || a.hd > 256 || a.d % 16 || (a.H * a.hd) % 16 ||
      (a.KV * a.hd) % 16 || a.ff % 16 || a.S < 1 || a.adapter < kNone ||
      a.adapter > kInt4 || (a.f8 != 0 && a.f8 != 1))
    return false;
  const int splits = (a.S + a.sc - 1) / a.sc;
  if (a.sc < 16 || a.sc % 16 || a.sc > 256 ||
      (splits == 1 ? 2 : 1) * a.kvb * a.sc * a.hd > kStage)
    return false;
  if (a.adapter && (a.nb % 16 || a.nb > 256)) return false;
  if (quant && (a.a_groups < 1 || a.b_groups < 1 || a.nb % a.a_groups ||
                a.d % a.b_groups || (a.nb / a.a_groups) % 8 ||
                (a.d / a.b_groups) % 8))
    return false;
  const int kin = kin_of(a);
  const long long in_floats = 1LL * nb_slots * (kin + kPad) / 2;
  if (kin < kChunk || in_floats < 3 * a.hd + a.sc + kThreads ||
      in_floats < a.d || in_floats < a.nb ||
      smem_bytes(nb_slots, kin) > kMaxSmem)
    return false;
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda); null where the driver has none.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A bf16 (or, with bytes, 1-byte) tensor of `rank` dims (innermost first,
// byte strides of the outer ones) with the given box; out-of-bounds rows
// read as zeros.
bool encode(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box,
            bool bytes = false) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode_fn()(m, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                     const_cast<void*>(ptr), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A weight [K, N] seen as [K / 16][16][N], so that ONE box of 64 x 16
// rows x `cols` columns fetches a whole kChunk-row tile (a 2-D box holds
// at most 256 rows).
bool map_weight(CUtensorMap* m, const void* w, int K, int N, int cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), 16,
                              static_cast<cuuint64_t>(K / 16)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(N) * 32};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), 16,
                             kChunk / 16};
  return encode(m, w, 3, dims, strides, box);
}

// A cache [rows = B*S, KV, hd] of kvb-byte values (bf16, or float8 as
// bytes) in boxes of kKVBox rows of one head.
bool map_cache(CUtensorMap* m, const void* c, int rows, int KV, int hd,
               int kvb) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * kvb,
                                 static_cast<cuuint64_t>(KV) * hd * kvb};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(hd), 1, kKVBox};
  return encode(m, c, 3, dims, strides, box, kvb == 1);
}

Args shape_args(int B, int d, int H, int KV, int hd, int ff, int S, int nb,
                int adapter, int a_groups, int b_groups, int sc, int f8) {
  Args a = {};
  a.B = B, a.d = d, a.H = H, a.KV = KV, a.hd = hd, a.ff = ff, a.S = S;
  a.nb = nb, a.adapter = adapter, a.sc = sc;
  a.f8 = f8, a.kvb = f8 ? 1 : 2;
  a.a_groups = a_groups, a.b_groups = b_groups;
  if (slot_bucket(B)) a.kin = kin_of(a);
  return a;
}

}  // namespace

#ifdef XPEFT_DEC_PART
#define XPEFT_DEC_CAT(a, b) a##b
#define XPEFT_DEC_FN(p) XPEFT_DEC_CAT(xpeft_decode_kernel_part, p)
extern "C" const void* XPEFT_DEC_FN(XPEFT_DEC_PART)(int NB) {
  return pair_kernel<(XPEFT_DEC_PART & 2) != 0, (XPEFT_DEC_PART & 1) != 0>(
      NB);
}
#endif

#if !defined(XPEFT_DEC_PART) || XPEFT_DEC_PART == 0
// The co-resident grid (blocks per SM x SMs) of the instantiation for B
// slots at these widths (its shared memory depends on the slot bucket and
// the widest GEMV depth). Returns a cudaError_t (cudaErrorNotSupported
// without cooperative launch).
extern "C" int xpeft_decode_block_config(int B, int d, int H, int hd, int ff,
                                         int* grid) {
  Args a = shape_args(B, d, H, H, hd, ff, 1, 16, kNone, 0, 0, 16, 0);
  const int nb_slots = slot_bucket(B);
  if (!nb_slots) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(nb_slots, a.kin);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // one block per SM whatever the instantiation: the shared memory sets it
  return static_cast<int>(config(
      kernel_of(nb_slots, a.kin < kmax_of(a), false), smem, grid));
}

// The fp32 scratch words a launch at these shapes needs (<= 0 for a
// configuration the kernel refuses); sc: cache rows per attention split;
// f8: the caches hold float8_e4m3fn, else bf16.
extern "C" int xpeft_decode_block_scratch(int B, int d, int H, int KV, int hd,
                                          int ff, int S, int nb, int adapter,
                                          int a_groups, int b_groups, int sc,
                                          int f8) {
  Args a = shape_args(B, d, H, KV, hd, ff, S, nb, adapter, a_groups,
                      b_groups, sc, f8);
  if (!valid(a)) return -1;
  const long long words = fill_layout(a);
  return words > 0x7fffffff ? -1 : static_cast<int>(words);
}

// One cooperative launch of the decode block for B slots on `grid` blocks
// (from xpeft_decode_block_config), with sc cache rows per attention split
// and a scratch of xpeft_decode_block_scratch words. adapter: 0 = none,
// 1 = bf16 (a_hat, b_hat, strides a_bs/b_bs), 2 = int8, 3 = int4
// (a_q/a_s/b_q/b_s with their strides and a_groups/b_groups scales per A/B
// row; dequant.cuh has the layouts); ln_s/ln_b on routes 1-3. gelu: the
// adapter's activation, 0 = identity, 1 = gelu (tanh form); mlp_gelu: the
// MLP's gate activation, 0 = silu, 1 = gelu (tanh form); cap <= 0 turns
// the softcap off; f8: kc/vc and k_row/v_row hold float8_e4m3fn bytes,
// else bf16. Every
// bf16 matrix has 16-byte aligned rows, every quantized row 8-byte
// aligned; the wrapper checks shapes, strides and alignment. Returns the
// launch's cudaError_t.
extern "C" int xpeft_decode_block(
    const void* x, const void* pos, const void* n1, const void* n2,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const void* bq, const void* bk, const void* bv, const void* wg,
    const void* wu, const void* wd, const void* kc, const void* vc,
    const void* a_hat, const void* b_hat, const void* ln_s, const void* ln_b,
    long long a_bs, long long b_bs, long long ln_bs, const void* inv_freq,
    void* y, void* k_row, void* v_row, void* scratch, int B, int d, int H,
    int KV, int hd, int ff, int S, int nb, int qkv_bias, int adapter,
    int gelu, int mlp_gelu, float cap, float scale, const void* a_q,
    const void* a_s,
    const void* b_q, const void* b_s, long long aq_bs, long long as_bs,
    long long bq_bs, long long bs_bs, int a_groups, int b_groups, int sc,
    int f8, int grid, void* stream) {
  Args a = shape_args(B, d, H, KV, hd, ff, S, nb, adapter, a_groups,
                      b_groups, sc, f8);
  if (grid < 1 || !valid(a)) return cudaErrorInvalidValue;
  fill_layout(a);
  a.x = static_cast<const bf16*>(x);
  a.pos = static_cast<const int*>(pos);
  a.n1 = static_cast<const float*>(n1);
  a.n2 = static_cast<const float*>(n2);
  a.bq = static_cast<const float*>(bq);
  a.bk = static_cast<const float*>(bk);
  a.bv = static_cast<const float*>(bv);
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
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.y = static_cast<bf16*>(y);
  a.k_row = k_row;
  a.v_row = v_row;
  a.scratch = static_cast<float*>(scratch);
  a.qkv_bias = qkv_bias, a.gelu = gelu;
  a.cap = cap, a.scale = scale;
  if (!encode_fn()) return cudaErrorNotSupported;
  const int nq = H * hd, nkv = KV * hd;
  if (!map_weight(&a.tm_wq, wq, d, nq, kNT) ||
      !map_weight(&a.tm_wk, wk, d, nkv, kNT) ||
      !map_weight(&a.tm_wv, wv, d, nkv, kNT) ||
      !map_weight(&a.tm_wo, wo, nq, d, kNT) ||
      !map_weight(&a.tm_wg, wg, d, ff, kNT / 2) ||
      !map_weight(&a.tm_wu, wu, d, ff, kNT / 2) ||
      !map_weight(&a.tm_wd, wd, ff, d, kNT) ||
      !map_cache(&a.tm_kc, kc, B * S, KV, hd, a.kvb) ||
      !map_cache(&a.tm_vc, vc, B * S, KV, hd, a.kvb))
    return cudaErrorInvalidValue;
  const int nb_slots = slot_bucket(B);
  const long long smem = smem_bytes(nb_slots, a.kin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch(
      kernel_of(nb_slots, a.kin < kmax_of(a), mlp_gelu), a, grid, smem, s));
}
#endif
