"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so
``nvcc`` builds each in seconds; ``csrc/*.cuh`` holds device code they
share (``dequant.cuh``, ``terms.cuh``). All sources compile at once, one
``nvcc`` process per file (``decode_fused.cu``, whose eight kernel
instantiations would take the longest alone, as four: ``units``), and
link into ONE shared library in
``<repo>/build/`` (listed in .gitignore), loaded with ``ctypes``. The
library's name carries a hash of the sources, headers and flags: it is
built at first use and rebuilt when a source changes. Nothing here runs
at import; a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types: every pointer and the stream
# are c_void_p (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    "xpeft_mask_aggregate_batched":
        [_P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I, _I, _P],
    "xpeft_mask_aggregate_quant_batched":
        [_P] * 5 + [_I] * 5 + [_LL, _I, _I, _I, _P],
    "xpeft_fused_adapter_batched":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _I, _I, _I,
         _I, _P],
    "xpeft_hetero_adapter_batched":
        [_P] * 9 + [_I] * 5 + [_LL] * 6 + [_I] * 4 + [_P],
    "xpeft_fused_adapter_quant_batched":
        [_P] * 8 + [_I] * 6 + [_LL] * 5 + [_I] * 5 + [_P],
    "xpeft_ia3_apply_batched":
        [_P, _P, _P, _LL, _I, _I, _LL, _I, _I, _P],
    "xpeft_decode_block_config": [_I] * 5 + [ctypes.POINTER(_I)],
    "xpeft_decode_block_scratch": [_I] * 13,
    "xpeft_decode_block":
        [_P] * 20 + [_LL] * 3 + [_P] * 5 + [_I] * 12 + [_F, _F]
        + [_P] * 4 + [_LL] * 4 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def units():
    """(source, object stem, extra flags) for each nvcc process: every
    source once, but ``decode_fused.cu`` once per part of its kernel's
    instantiations (``-DXPEFT_DEC_PART``, see its head)."""
    out = []
    for src in sources():
        parts = 4 if src.name == "decode_fused.cu" else 0
        out += [(src, f"{src.stem}_{p}" if parts else src.stem,
                 [f"-DXPEFT_DEC_PART={p}"] if parts else [])
                for p in range(parts or 1)]
    return out


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and PATH); "
                           "the CUDA kernels build only on the GPU host")
    return found


def headers():
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr([(stem, flags) for _, stem, flags in units()]).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libxpeft_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the library, unless the
    library for these exact sources already exists. ``verbose`` adds
    ``-Xptxas=-v`` and prints what the compiler says (registers, shared
    memory, spills per kernel)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        cc = nvcc()
        extra = ["-Xptxas=-v"] if verbose else []
        objs = [tmp / (stem + ".o") for _, stem, _ in units()]
        outs = _run_all([[cc, *NVCC_FLAGS, *extra, *flags, "-c", str(src),
                          "-o", str(obj)]
                         for (src, _, flags), obj in zip(units(), objs)])
        if verbose:
            print("".join(outs), flush=True)
        part = tmp / so.name
        _run_all([[cc, *ARCH_FLAGS, "-shared", "-o", str(part),
                   *map(str, objs)]])
        os.replace(part, so)  # atomic: a concurrent build never half-loads
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load_library():
    """The loaded kernel library (built first if needed), with argtypes
    and restype set for every entry point."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
