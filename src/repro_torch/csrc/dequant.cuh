// The device twin of dequant_block (src/repro_torch/quant/schemes.py;
// the reference's src/repro/quant/schemes.py:111), shared by the three
// kernels that read a quantized adapter bank or record: the k-sparse
// aggregation (mask_aggregate_quant.cu), the batched fused adapter
// (fused_adapter_quant.cu) and the decode megakernel's int8/int4 routes
// (decode_fused.cu). Each walks the bytes its own way and calls dequant()
// once per value.
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

}  // namespace xpeft
