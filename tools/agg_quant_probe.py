"""Times the quantized aggregation (#5) at admission's shapes on the card.

    python3 tools/agg_quant_probe.py [--tree DIR] [--no-i2f] [--loads-only]
                                     [--sweep]

Runs ``DIR``'s (default: this checkout's) ``mask_aggregate_quant_batched``
through its own wrapper on the layer-folded bank of qwen1.5-0.5b's A_hat
and B_hat sides, quantized int8 and int4 (group 32), P = 96 profile-rows of
k = 50 adapters (``chip_smoke.py``'s inputs), holds it to the plain version
bit for bit and prints its time as a cold CUDA-graph replay (the selected
rows, 100-300 MB a call, stream past the 50 MB L2) beside the byte bound.

``--no-i2f`` builds a copy of ``DIR``'s ``csrc/mask_aggregate_quant.cu``
into ``build/agg_quant_probe/`` with ``dequant()``'s integer-to-float
conversion replaced by an exact integer path (the integer added to the
bits of 1.5 * 2^23, then 1.5 * 2^23 subtracted: no I2F instruction, the
same bits) and times that too: what the conversion costs a kernel that
widens its values through ``dequant()`` (this checkout's does not).
``--loads-only`` builds a copy of this checkout's kernel whose fold of a
term (dequantize, weigh, add) is replaced by one XOR of its bytes into
the sum: the same loads, almost no arithmetic (its output is not the
function, so it is timed only): what the arithmetic costs the kernel.
``--sweep`` times every (threads, loads in flight) pair the C entry of
this checkout's kernel takes, the measurement its planner's choice rests
on.
"""
import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = (("int8", "A_hat"), ("int8", "B_hat"), ("int4", "A_hat"),
         ("int4", "B_hat"))
I2F = "return __fmul_rn(static_cast<float>(qv), s);"
NO_I2F = ("return __fmul_rn(__fsub_rn(__int_as_float(0x4B400000 + qv), "
          "12582912.0f), s);")


FOLD = "__device__ __forceinline__ void fold_uniform("
LOADS_ONLY = """{
  lo[0] = __uint_as_float(__float_as_uint(lo[0]) ^ raw.x ^ raw.y ^ raw.z ^
                          raw.w ^ __float_as_uint(wt + sl + sh));
}
"""


def build_copy(_build, name, patch):
    """The tree's #5 source with ``patch`` applied to (file name, text),
    built alone into build/agg_quant_probe/NAME."""
    out = HERE / "build" / "agg_quant_probe" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in (*_build.CSRC.glob("*.cuh"),
              _build.CSRC / "mask_aggregate_quant.cu"):
        (out / f.name).write_text(patch(f.name, f.read_text()))
    src = out / "mask_aggregate_quant.cu"
    so = out / "libagg_quant_probe.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    fn = lib.xpeft_mask_aggregate_quant_batched
    fn.argtypes = _build.SIGNATURES["xpeft_mask_aggregate_quant_batched"]
    fn.restype = ctypes.c_int
    return lib


def no_i2f(name, text):
    if name != "dequant.cuh":
        return text
    assert text.count(I2F) == 1, "dequant() is not the form this patches"
    return text.replace(I2F, NO_I2F)


def loads_only(name, text):
    if name != "mask_aggregate_quant.cu":
        return text
    at = text.index(FOLD)
    body = text.index("{\n", at)
    end = text.index("\n}\n", body) + 3
    return text[:body] + LOADS_ONLY + text[end:]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE),
                    help="checkout whose kernel and wrapper are timed")
    ap.add_argument("--no-i2f", action="store_true")
    ap.add_argument("--loads-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(HERE), str(tree / "src")]
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import _build, mask_aggregate_quant as KAQ, ref
    from repro_torch.quant import schemes as QS
    assert Path(KAQ.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        print("agg_quant_probe: needs a CUDA card", file=sys.stderr)
        return 2
    variants = [("as built", _build.load_library())]
    if args.no_i2f:
        variants.append(("no I2F", build_copy(_build, "no_i2f", no_i2f)))
    if args.loads_only:
        variants.append(("loads only", build_copy(_build, "loads_only",
                                                  loads_only)))
    print(f"tree {tree} | {CS.nvidia_smi()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for scheme, side in CASES:
        d, b = (1024, 64) if side == "A_hat" else (64, 1024)
        bank, idx, w = CS.agg_inputs(torch, gen, d, b)
        rec = QS.quantize(bank, scheme, group=32)
        q, sc = rec["q"], rec["scale"]
        del bank, rec
        want = ref.mask_aggregate_quant_batched_ref(q, sc, idx, w,
                                                    scheme=scheme)
        P, k = idx.shape
        uniq = int(torch.unique(idx).numel())
        row = q[0].numel() * q.element_size() \
            + sc[0].numel() * sc.element_size()
        nbytes = uniq * row + idx.numel() * 8 + P * d * b * 4
        bound_ms, _ = CS.bound(nbytes, 2 * P * k * d * b, "float32")
        label = f"{scheme} {side}"
        for name, lib in variants:
            KAQ.load_library = lambda lib=lib: lib
            got = KAQ.mask_aggregate_quant_batched(q, sc, idx, w,
                                                   scheme=scheme)
            torch.cuda.synchronize()
            assert name == "loads only" or torch.equal(got, want), (label,
                                                                  name)
            ms = CS.device_ms(torch, lambda: KAQ.mask_aggregate_quant_batched(
                q, sc, idx, w, scheme=scheme), calls=8)
            print(f"{label} ({name}): {ms:.5f} ms (cold graph replay"
                  f"{'' if name == 'loads only' else ', bitwise'}); bound "
                  f"{bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB)", flush=True)
        if args.sweep:
            lib = _build.load_library()
            n, groups = KAQ.check_rows(q, sc, scheme)
            out = torch.empty_like(want)

            def call(threads, unroll):
                # the current stream, which a graph capture replaces
                err = lib.xpeft_mask_aggregate_quant_batched(
                    q.data_ptr(), sc.data_ptr(), idx.data_ptr(),
                    w.data_ptr(), out.data_ptr(), d, n, groups, P, k,
                    q.shape[0], int(scheme == "int4"), threads, unroll,
                    torch.cuda.current_stream().cuda_stream)
                assert not err, err
            for threads in KAQ.THREADS:
                for unroll in KAQ.UNROLLS:
                    call(threads, unroll)
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (label, threads, unroll)
                    ms = CS.device_ms(torch, lambda: call(threads, unroll),
                                      calls=8)
                    mark = " <- plan" if (threads, unroll) == KAQ.plan(
                        P, q[0].numel(), scheme) else ""
                    print(f"  {threads} threads x {unroll} in flight: "
                          f"{ms:.5f} ms{mark}", flush=True)
        del q, sc, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
