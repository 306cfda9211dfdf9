"""Quantized adapter-bank schemes (int8 / planar int4 with fp16 scales),
shared by the dequantizing kernels' plain versions, the serving engine and
the profile store. Select with ``XPeftConfig.bank_quant``."""
from repro_torch.quant.schemes import (  # noqa: F401
    SCHEMES, check_scheme, dequant_block, dequantize, group_for, pack_int4,
    quant_spec, quantize, quantize_bank, quantize_bank_hetero, quantize_int4,
    quantize_int8, unpack_int4)
