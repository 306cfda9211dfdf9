"""The port's quantization schemes against the JAX package's, on the CPU.

``repro_torch.quant.schemes`` is a transcription of ``repro.quant.schemes``
in plain PyTorch; for the same float32 input (made from a seed with numpy)
it must give the SAME bytes: q, the fp16 scales (compared as uint16), the
dequantized fp32 values, the buffer specs and the bank's leaf names.
Tolerance: none, byte-equal.
"""
import numpy as np
import pytest
import torch

from repro.quant import schemes as J
from repro_torch.quant import schemes as T

# (scheme, int4 group): int8, and int4 at the default group 32, at 8 and at
# 4 (the group the reduced smoke configs' b=4 rows get)
CASES = [("int8", 32), ("int4", 32), ("int4", 8), ("int4", 4)]


def _x(shape, seed=0, zero_row=True):
    x = (np.random.default_rng(seed).normal(size=shape) * 0.05).astype(
        np.float32)
    if zero_row:
        x.reshape(-1, shape[-1])[0] = 0.0
    return x


def _same_bytes(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    if j.dtype == np.float16:
        j, t = j.view(np.uint16), t.view(np.uint16)
    return j.tobytes() == t.tobytes()


@pytest.mark.parametrize("scheme,group", CASES)
@pytest.mark.parametrize("shape", [(64, 1024), (3, 5, 64), (7, 4)])
def test_quantize_byte_equal(scheme, group, shape):
    x = _x(shape)
    want = J.quantize(x, scheme, group=group)
    got = T.quantize(torch.from_numpy(x), scheme, group=group)
    assert _same_bytes(want["q"], got["q"])
    assert _same_bytes(want["scale"], got["scale"])
    # dequant_block: the same exact products
    assert _same_bytes(J.dequant_block(want["q"], want["scale"], scheme),
                       T.dequant_block(got["q"], got["scale"], scheme))
    assert _same_bytes(J.dequantize(want, scheme), T.dequantize(got, scheme))
    # the spec the engine sizes its slot buffers with
    jq, jdt, js = J.quant_spec(shape, scheme, group=group)
    tq, tdt, ts = T.quant_spec(shape, scheme, group=group)
    assert (tuple(jq), tuple(js)) == (tq, ts)
    assert str(np.dtype(jdt)) == str(tdt).replace("torch.", "")
    assert tuple(got["q"].shape) == tq and tuple(got["scale"].shape) == ts


@pytest.mark.parametrize("scheme,group", CASES)
def test_zero_rows_quantize_to_zero(scheme, group):
    x = np.zeros((3, 16), np.float32)
    got = T.quantize(torch.from_numpy(x), scheme, group=group)
    assert not got["scale"].float().abs().max()
    assert not T.dequant_block(got["q"], got["scale"], scheme).abs().max()


def test_pack_unpack_and_group_for():
    q = np.random.default_rng(1).integers(-8, 8, size=(5, 12)).astype(
        np.int32)
    packed = T.pack_int4(torch.from_numpy(q))
    assert _same_bytes(J.pack_int4(q), packed)
    assert _same_bytes(J.unpack_int4(J.pack_int4(q)), T.unpack_int4(packed))
    assert torch.equal(T.unpack_int4(packed), torch.from_numpy(q))
    # planar layout: byte i holds column i (low) and column i + n/2 (high)
    assert int(packed[0, 0]) == (q[0, 0] + 8) | ((q[0, 6] + 8) << 4)
    for n in (2, 4, 6, 12, 64, 96, 1024):
        for group in (4, 8, 16, 32):
            assert T.group_for(n, group) == J.group_for(n, group), (n, group)
    with pytest.raises(ValueError):
        T.group_for(5)
    with pytest.raises(ValueError):
        T.check_scheme("int2")


@pytest.mark.parametrize("scheme,group", CASES)
def test_quantize_bank_byte_equal(scheme, group):
    """Per-layer quantization into preallocated outputs gives the bytes
    of JAX's whole-bank quantization, under JAX's leaf names."""
    L, N, d, b = 3, 4, 16, 8
    bank = {"bank_a": _x((L, N, d, b), seed=2),
            "bank_b": _x((L, N, b, d), seed=3)}
    want = J.quantize_bank(bank, scheme, group=group)
    got = T.quantize_bank({k: torch.from_numpy(v) for k, v in bank.items()},
                          scheme, group=group)
    assert sorted(want) == sorted(got)
    for key in want:
        assert _same_bytes(want[key], got[key]), key
