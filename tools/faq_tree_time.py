"""Times #6 (``fused_adapter_quant_batched``) at the shapes whose plan
has one pass over the fp32 tile (d=1024 int8/int4 at T=1 and 16, d=7168
int8 T=1, d=6144 int4 T=16; B=4, b=64, bf16 x, layer slices as
``chip_smoke.fa_quant_inputs`` makes them), with the kernels of the
checkout at TREE (built into TREE/build):

    python3 tools/faq_tree_time.py TREE

Prints one JSON line: per shape three medians of cold CUDA-graph replays
(``chip_smoke.device_ms``) and a checksum of one output. To compare two
checkouts on one card, run parent, change, change, parent in one call.
"""
import json
import os
import sys

SHAPES = (("int8", 1024, 1, 64), ("int8", 1024, 16, 64),
          ("int4", 1024, 1, 64), ("int4", 1024, 16, 64),
          ("int8", 7168, 1, 16), ("int4", 6144, 16, 16))


def main():
    root = os.path.abspath(sys.argv[1])
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("faq_tree_time: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_adapter_quant as KFQ
    from repro_torch.quant import schemes as QS

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load_library()
    out = {}
    for scheme, d, T, n in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        sets = [cs.fa_quant_inputs(torch, gen, QS, scheme, 32, 4, T, d, 64,
                                   torch.bfloat16, L=3) for _ in range(n)]

        def fn(*a):
            return KFQ.fused_adapter_quant_batched(*a, scheme=scheme)
        y = fn(*sets[0])
        out[f"{scheme} d={d} T={T}"] = dict(
            ms=[cs.device_ms(torch, cs.rotating(fn, sets), calls=len(sets))
                for _ in range(3)],
            checksum=float(y.float().abs().sum().item()))
        del sets
    print(json.dumps({"tree": sys.argv[1], "device": cs.nvidia_smi(),
                      "faq": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
