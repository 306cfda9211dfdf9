// The device twin of dequant_block (src/repro_torch/quant/schemes.py;
// the reference's src/repro/quant/schemes.py:111), shared by the three
// kernels that read a quantized adapter bank or record: the k-sparse
// aggregation (mask_aggregate_quant.cu), the batched fused adapter
// (fused_adapter_quant.cu) and the decode megakernel's int8/int4 routes
// (decode_fused.cu).
//
// Layouts, per row of n values (the last axis):
//   int8  q: n bytes, value q[c];               scale: 1 fp16 per row
//   int4  q: n/2 bytes, PLANAR: byte i holds column i in its low nibble
//            and column i + n/2 in its high nibble, each biased by +8;
//                                               scale: n/g fp16 per row,
//                                               column c in group c / g
// Both schemes address a scale as s[row * ngroups + c / g], with
// ngroups = 1 and g = n for int8.
//
// The value is float(q) * float(s): a 7- or 4-bit integer times an fp16
// scale (11-bit significand) is exact in fp32, so every dequantized value
// equals the plain version's bit for bit. __fmul_rn keeps the product a
// product: the compiler may not contract it into a later add.
#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

namespace xpeft {

// A quantized matrix of `rows` rows of n values each (one bank row, one
// slot's A_hat or B_hat record).
struct QMat {
  const uint8_t* q;   // int8 bytes or packed int4, row pitch qpitch() bytes
  const __half* s;    // scales [rows, ngroups]
  int n;              // values per row
  int ngroups;        // scales per row (1 for int8)
  int g;              // values per scale group (n for int8)
  int int4;           // 0: int8, 1: planar int4

  __device__ __forceinline__ int qpitch() const { return int4 ? n / 2 : n; }
};

__device__ __forceinline__ float dequant(int qv, float s) {
  return __fmul_rn(static_cast<float>(qv), s);
}

// The signed integer stored for column c of a row whose first byte is
// `row` (int8: the byte; int4: the nibble minus 8).
__device__ __forceinline__ int qvalue(const uint8_t* row, int n, int c,
                                      int int4) {
  if (!int4) return static_cast<int8_t>(row[c]);
  const int half = n / 2;
  const unsigned byte = c < half ? row[c] : row[c - half] >> 4;
  return static_cast<int>(byte & 0xFu) - 8;
}

// m[r, c] in fp32, one element (plain loads; for the kernels' scalar
// paths).
__device__ __forceinline__ float qmat_at(const QMat& m, long long r, int c) {
  const uint8_t* row = m.q + r * m.qpitch();
  const float s = __half2float(m.s[r * m.ngroups + c / m.g]);
  return dequant(qvalue(row, m.n, c, m.int4), s);
}

// Columns c .. c+7 of row r of m, dequantized into v[8]. One 8-byte load:
// int8 reads bytes c..c+7; int4 the low nibbles of bytes c..c+7 when c is
// in the first half of the row, else the high nibbles of bytes
// c-n/2 .. c-n/2+7. Needs c % 8 == 0, the row's first byte 8-byte aligned
// and (int4) n/2 % 8 == 0, so the 8 columns never straddle the halves.
// sidx[j] is the offset of column c+j's scale within its row
// ((c + j) / g), computed once by the caller.
__device__ __forceinline__ void qmat_load8(const QMat& m, long long r, int c,
                                           const int (&sidx)[8],
                                           float (&v)[8]) {
  const uint8_t* row = m.q + r * m.qpitch();
  int shift = 0;
  if (m.int4 && c >= m.n / 2) {
    c -= m.n / 2;
    shift = 4;
  }
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + c));
  const uint32_t word[2] = {raw.x, raw.y};
  const __half* s = m.s + r * m.ngroups;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned byte = (word[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    const int qv = m.int4 ? static_cast<int>((byte >> shift) & 0xFu) - 8
                          : static_cast<int>(static_cast<int8_t>(byte));
    v[j] = dequant(qv, __half2float(__ldg(s + sidx[j])));
  }
}

}  // namespace xpeft
