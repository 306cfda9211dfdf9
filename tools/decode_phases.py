"""Where the decode megakernel's time goes, phase by phase, on the card.

    python3 tools/decode_phases.py [--tree DIR] [--plain]

Copies ``DIR/src/repro_torch/csrc`` (default: this checkout) into
``build/decode_phases/``, inserts ``%globaltimer`` stamps into the copy of
``decode_fused.cu`` (block 0 stamps the start and the moment it leaves
each ``grid.sync()``; every block records, by atomic max, when it arrives
at each barrier and when it ends), builds that file alone and runs it
through ``DIR``'s own wrapper at qwen1.5-0.5b's widths, B=4: routes bf16,
int4 and none at S=128 (chip_smoke.py's positions) and route bf16 at
S=2048. The kernel sources themselves carry no stamps. For each it prints
the cold CUDA-graph time per call (24 layers rotated, as chip_smoke.py
times it), and the median over 96 calls of each phase's work (block 0's
leave of the last barrier to the last block's arrival at the next), each
barrier (last arrival to block 0's leave) and the launch (the call's time
less block 0's start to the last block's end).

``--plain`` builds ``DIR``'s library as it is (into ``DIR/build``, no
stamps) and prints only each shape's time: to compare two checkouts, run
parent, change, change, parent in one call on one card.
"""
import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

STAMPS = r'''
__device__ unsigned long long g_stamp[32], g_arr[32];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[i] = gtime();
#define ARRIVE(i) if (threadIdx.x == 0) atomicMax(&g_arr[i], gtime());
'''
READERS = r'''
extern "C" int xpeft_stamps(unsigned long long* st, unsigned long long* ar) {
  cudaMemcpyFromSymbol(st, g_stamp, sizeof(g_stamp));
  return cudaMemcpyFromSymbol(ar, g_arr, sizeof(g_arr));
}
extern "C" int xpeft_stamps_reset() {
  unsigned long long z[32] = {0};
  cudaMemcpyToSymbol(g_stamp, z, sizeof(z));
  return cudaMemcpyToSymbol(g_arr, z, sizeof(z));
}
'''


def stamped(src: str):
    """The source with stamps, the number of barriers stamped and the
    number route none passes before it returns. Only the kernel's own
    grid.sync() calls are stamped; where the kernel has a producer warp,
    the block-level wait before a stamp is the consumers' barrier."""
    s = src.replace("namespace cg = cooperative_groups;",
                    "namespace cg = cooperative_groups;\n" + STAMPS, 1)
    s = s.replace("cg::grid_group grid = cg::this_grid();",
                  "cg::grid_group grid = cg::this_grid();\n  STAMP(0)", 1)
    start = s.index("__global__")
    end = s.index("\n}\n", start)  # the kernel's closing brace
    body = s[start:end]
    wait = "csync();" if "void csync()" in src else "__syncthreads();"
    n = [0]

    def barrier(_):
        n[0] += 1
        return f"{{ {wait} ARRIVE({n[0]}) grid.sync(); STAMP({n[0]}) }}"
    none_at = body.index("if (!p.adapter) return;")
    before_none = body[:none_at].count("grid.sync();")
    body = re.sub(r"grid\.sync\(\);", barrier, body)
    body = body.replace("if (!p.adapter) return;",
                        f"if (!p.adapter) {{ {wait} ARRIVE(31) return; }}")
    s = s[:start] + body + f"\n  {wait} ARRIVE(31)" + s[end:]
    return s + READERS, n[0], before_none


def stamped_library(_build, KD):
    """The checkout's decode_fused.cu with stamps, built alone and put
    behind its wrapper: (library, barriers stamped, barriers before route
    none returns), or (None, 0, 0) where nvcc fails."""
    out = HERE / "build" / "decode_phases"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    src, nbar, nbar_none = stamped(
        (_build.CSRC / "decode_fused.cu").read_text())
    (out / "decode_fused.cu").write_text(src)
    so = out / "libdecode_phases.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(out / "decode_fused.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout, r.stderr)
        return None, 0, 0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    KD.load_library = lambda: lib
    for fn in ("_grid", "_launch_plan"):
        if hasattr(KD, fn):
            getattr(KD, fn).cache_clear()

    return lib, nbar, nbar_none


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE),
                    help="checkout whose kernel and wrapper are timed")
    ap.add_argument("--plain", action="store_true",
                    help="the checkout's own build, times only")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(HERE), str(tree / "src")]
    import torch
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, decode_fused as KD, ref
    from repro_torch.quant import schemes as QS
    assert Path(KD.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        print("decode_phases: needs a CUDA card", file=sys.stderr)
        return 2

    if args.plain:
        _build.build()
        lib, nbar = _build.load_library(), 0
    else:
        lib, nbar, nbar_none = stamped_library(_build, KD)
        if lib is None:
            return 1
    print(f"tree {tree} | {CS.nvidia_smi()} | {nbar} barriers", flush=True)
    cfg = get_config("qwen1.5-0.5b")
    kw = dict(norm=cfg.norm, qkv_bias=cfg.qkv_bias, use_rope=True,
              theta=cfg.rope_theta, cap=cfg.logit_softcap,
              mlp_type=cfg.mlp_type, act_name=cfg.act,
              adapter_act=cfg.xpeft.adapter_activation)
    gen = torch.Generator(device="cuda").manual_seed(3)
    st = (ctypes.c_ulonglong * 32)()
    ar = (ctypes.c_ulonglong * 32)()
    for route, S, pos in (("bf16", 128, None), ("int4", 128, None),
                          ("none", 128, None),
                          ("bf16", 2048, CS.DEC_LONG_POS)):
        quant = (QS, route, cfg.xpeft.quant_group) \
            if route in ("int8", "int4") else None
        sets = CS.dec_inputs(torch, gen, cfg, cfg.num_kv_heads, S=S,
                             quant=quant)
        if pos is not None:
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            sets = [(a[0], p) + tuple(a[2:]) for a in sets]
        rkw = dict(kw, adapter=route)
        CS.check_dec(torch, KD, ref, sets[0], rkw, f"{route} S={S}")
        ms = CS.device_ms(torch, CS.rotating(
            lambda *a: KD.decode_block_fused(*a, **rkw), sets),
            calls=len(sets))
        if args.plain:
            print(f"== route={route} S={S}: {ms:.5f} ms a call (cold graph "
                  "replay)", flush=True)
            del sets
            continue
        rows = []
        for _ in range(4):
            for a in sets:
                lib.xpeft_stamps_reset()
                KD.decode_block_fused(*a, **rkw)
                torch.cuda.synchronize()
                lib.xpeft_stamps(st, ar)
                rows.append([(st[k] - st[0]) / 1e3 for k in range(nbar + 1)]
                            + [(ar[k] - st[0]) / 1e3
                               for k in range(1, nbar + 1)]
                            + [(ar[31] - st[0]) / 1e3])
        med = [statistics.median(c) for c in zip(*rows)]
        leave, arrive, end = med[:nbar + 1], med[nbar + 1:-1], med[-1]
        ran = nbar if route != "none" else nbar_none
        print(f"== route={route} S={S}: {ms:.5f} ms a call (cold graph "
              f"replay); start to last block's end {end:.2f} us; launch "
              f"{ms * 1e3 - end:.2f} us", flush=True)
        for k in range(ran):
            print(f"  phase {k + 1}: work {arrive[k] - leave[k]:.2f} us, "
                  f"barrier {leave[k + 1] - arrive[k]:.2f} us")
        print(f"  phase {ran + 1}: work {end - leave[ran]:.2f} us",
              flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
