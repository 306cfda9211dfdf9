"""``chip_smoke.py``'s phase 7 (training, pack and reload, serving the
trained profiles) alone, on the card.

    python3 tools/train_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does, then runs
its ``phase_train_step_vs_cpu``, ``phase_train_full``,
``phase_pack_reload`` and ``phase_serve_trained`` with the same checks,
and prints one JSON line of their numbers last (about two minutes on an
H100, against the whole smoke test's five). Without a card it exits
non-zero.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("train_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_fused as KD
    from repro_torch.kernels import fused_adapter_batched as KF
    from repro_torch.kernels import mask_aggregate as KA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"device: {cs.nvidia_smi()} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    _build.build()
    _build.load_library()
    step = cs.phase_train_step_vs_cpu(torch)
    trained, train = cs.phase_train_full(torch)
    stores = cs.phase_pack_reload(torch, trained)
    per_step, per_step_fused, soft = cs.phase_serve_trained(
        torch, KA, KF, KD, trained, stores)
    cs.log(json.dumps({"train": dict(train, step_vs_cpu=step),
                       "serve_per_step": per_step,
                       "serve_per_step_decode_fused": per_step_fused,
                       "serve_soft": soft}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
