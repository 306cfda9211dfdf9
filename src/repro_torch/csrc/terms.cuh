// The kept terms of a k-sparse aggregation, shared by the kernels that
// fold selected bank rows in k order: the unquantized aggregation
// (mask_aggregate.cu, #1/#4) and the quantized one (mask_aggregate_quant.cu,
// #5). A term of weight 0 (+0 or -0) or with an index outside [0, N) is
// dropped, which changes no bit of a sum that starts at +0 when every
// value is finite: a product with w = 0 is +-0, and adding +-0 to a sum
// that is never -0 (round to nearest gives +0 for x + -x) leaves it as it
// is.
#pragma once

namespace xpeft {

// Compacts the kept terms of profile-row p (nonzero weight, index inside
// the bank) into s_idx / s_w in j order, one warp ballot per 32 terms;
// returns their number. Every thread of the block must call it.
__device__ __forceinline__ int compact_terms(const int* __restrict__ idx,
                                             const float* __restrict__ w,
                                             long long p, int k,
                                             long long n_rows, int* s_idx,
                                             float* s_w, int* s_count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int n = 0;
  for (int j0 = 0; j0 < k; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    int r = 0;
    float wj = 0.0f;
    bool keep = false;
    if (j < k) {
      r = idx[p * k + j];
      wj = w[p * k + j];
      keep = wj != 0.0f && r >= 0 && r < n_rows;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = n;
    for (int v = 0; v < n_warps; ++v) {
      if (v == warp) pos += __popc(ballot & ((1u << lane) - 1u));
      const int c = s_count[v];
      if (v < warp) pos += c;
      n += c;
    }
    if (keep) {
      s_idx[pos] = r;
      s_w[pos] = wj;
    }
    __syncthreads();
  }
  return n;
}

}  // namespace xpeft
