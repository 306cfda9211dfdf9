// The device twin of dequant_block (src/repro_torch/quant/schemes.py;
// the reference's src/repro/quant/schemes.py:111), shared by the three
// kernels that read a quantized adapter bank or record: the k-sparse
// aggregation (mask_aggregate_quant.cu), the batched fused adapter
// (fused_adapter_quant.cu) and the decode megakernel's int8/int4 routes
// (decode_fused.cu). Each walks the bytes its own way; the adapter and the
// megakernel call dequant() once per value, the aggregation the exact
// I2F-free form below (dequant_scale / dequant_byte).
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

// One value: its stored integer (int8: the byte; int4: the nibble minus
// 8) times its row's or group's scale.
__device__ __forceinline__ float dequant(int qv, float s) {
  return __fmul_rn(static_cast<float>(qv), s);
}

// The same values without the integer-to-float conversion, which issues
// at 16 per clock per SM on sm_90 against 128 for an fp32 multiply or add
// (the k-sparse aggregation converts every value of every selected row).
// A byte v of a 32-bit word, moved by one byte permute into bits 8..15 of
// the float 2^23, reads 2^23 + v * 2^8 exactly. A value stored as v = (q +
// bias) * 2^shift (int8 after word ^ 0x80808080: bias 128, shift 0; an
// int4 nibble masked in place: bias 8, shift 0 for the low nibble, 4 for
// the high one) is then q * s = M * m + c in ONE fused multiply-add, with
// m = s * 2^-(8 + shift) and c = -(2^23 + bias * 2^(8 + shift)) * m: both
// exact (a power-of-two scaling of an fp16 scale, and s times an integer
// of at most 13 significant bits), and the exact value M * m + c = q * s
// is an fp32 number (a 7- or 4-bit integer times an fp16 scale), so the
// one rounding returns it: the same bits as dequant(q, s).
struct Dequant {
  float m, c;
};

template <int BIAS, int SHIFT>
__device__ __forceinline__ Dequant dequant_scale(float s) {
  const float m = __fmul_rn(s, 1.0f / static_cast<float>(256 << SHIFT));
  return {m, __fmul_rn(-(8388608.0f + BIAS * static_cast<float>(256 << SHIFT)),
                       m)};
}

// byte j (0..3, a constant after unrolling) of word, dequantized. The
// constant 2^23 is the permute's first operand (a register, set once) so
// that the selector is its immediate: the other way round costs a move a
// value.
__device__ __forceinline__ float dequant_byte(uint32_t word, int j,
                                              const Dequant& dq) {
  const float big =
      __uint_as_float(__byte_perm(0x4B000000u, word, 0x3000u | ((4 + j) << 4)));
  return __fmaf_rn(big, dq.m, dq.c);
}

}  // namespace xpeft
