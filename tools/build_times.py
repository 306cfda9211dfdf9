"""Each ``nvcc`` process's wall time when a checkout's kernels build.

    python3 tools/build_times.py [--tree DIR]

Starts ``DIR``'s ``kernels/_build.py`` units (one ``nvcc`` per source,
``decode_fused.cu`` as its parts) all at once, as ``_build.build`` does,
into a new directory under this checkout's ``build/build_times/``, then
links them, and prints each unit's seconds, the link's and the whole
build's, one JSON line last. Nothing is loaded. To compare two checkouts,
run parent, change, change, parent in one call on one host.
"""
import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_build(tree: Path):
    """``tree``'s ``kernels/_build.py`` as a module of its own (it imports
    nothing of the package)."""
    path = tree / "src" / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{id(tree)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed_build(B, out: Path) -> dict:
    """Compile every unit at once, then link; the seconds of each."""
    cc = B.nvcc()
    units = B.units()
    secs, fails = {}, []

    def run(src, stem, flags):
        t = time.perf_counter()
        r = subprocess.run([cc, *B.NVCC_FLAGS, *flags, "-c", str(src), "-o",
                            str(out / (stem + ".o"))], capture_output=True,
                           text=True)
        secs[stem] = time.perf_counter() - t
        if r.returncode:
            fails.append(f"{stem}: {r.stdout}{r.stderr}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=u) for u in units]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    compiled = time.perf_counter() - t0
    if fails:
        raise RuntimeError("\n".join(fails))
    t = time.perf_counter()
    subprocess.run([cc, *B.ARCH_FLAGS, "-shared", "-o", str(out / "lib.so"),
                    *(str(out / (stem + ".o")) for _, stem, _ in units)],
                   check=True, capture_output=True)
    link = time.perf_counter() - t
    return dict(units=secs, compile_s=compiled, link_s=link,
                total_s=compiled + link)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    tree = Path(ap.parse_args().tree).resolve()
    B = load_build(tree)
    root = HERE / "build" / "build_times"
    root.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=root))
    try:
        res = timed_build(B, out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    dec = {k: v for k, v in res["units"].items()
           if k.startswith("decode_fused")}
    print(f"build of {tree}: {res['total_s']:.2f}s (compile "
          f"{res['compile_s']:.2f}s, link {res['link_s']:.2f}s); "
          f"decode_fused.cu's parts "
          + ", ".join(f"{k} {v:.2f}s" for k, v in sorted(dec.items())),
          flush=True)
    print(json.dumps(dict(tree=str(tree), **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
