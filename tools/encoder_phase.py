"""``chip_smoke.py``'s phase 8 (the paper's encoder, bert-base-xpeft) alone,
on the card.

    python3 tools/encoder_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does, then runs
its ``phase_encoder`` with the same checks: the card-vs-CPU step of each
mode, ten full-depth xpeft steps at B=64, T=128 (timed and profiled) and
three of each other mode with no hand-written kernel launched, held-out
accuracy, the store packed, saved and reloaded byte-equal, and the store
admitted through #1 and #2 against its kernel_impl="ref" run. Prints one
JSON line of its numbers last. Without a card it exits non-zero.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("encoder_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"device: {smi} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    _build.build()
    _build.load_library()
    encoder = cs.phase_encoder(torch)
    cs.log(json.dumps({"encoder": encoder, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
