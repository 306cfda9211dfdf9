"""``chip_smoke.py``'s phase 9 (continuous batching over paged KV and
pooled mask entries, preempt/resume, self-speculative decoding) alone, on
the card, with phase 3b's row of #2 at the verify shape.

    python3 tools/continuous_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does, checks and
times #2 at B=4, T=gamma+1, d=1024, b=64 on layer slices, then runs its
``phase_continuous`` with the same checks: runs (a)-(g) on qwen1.5-0.5b
at full width and all 24 layers ((g): 2 mask entries for 4 slots,
``max_wait_waves=2``), each held to its reference run token for token
(first flips explained), launches counted per drain, one step of each
profiled but (b)'s, (f)'s starved run's and (g)'s.
Prints one JSON line of its numbers last. Without a card it exits
non-zero.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("continuous_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_adapter_batched as KF
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"device: {smi} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    _build.build()
    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(2)
    verify = cs.fa_slice_rows(torch, KF, ref, gen, "verify", 1024, 64, 24,
                              ((4, cs.CB_GAMMA + 1, torch.bfloat16),))
    continuous = cs.phase_continuous(torch)
    cs.log(json.dumps({"verify_row": verify, "continuous": continuous,
                       "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
