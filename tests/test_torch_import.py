"""The port stands alone: it imports neither jax nor ``repro``, and its
configs equal the JAX package's field by field."""
import ast
import dataclasses
import os
import subprocess
import sys

import pytest

from repro.configs import get_config, list_archs, reduce_for_smoke
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.configs import reduce_for_smoke as treduce

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 59, names
# the quantized-bank, heterogeneous-bank and training slices' modules are
# among them
for name in ("repro_torch.quant", "repro_torch.quant.schemes",
             "repro_torch.kernels.mask_aggregate_quant",
             "repro_torch.kernels.fused_adapter_quant",
             "repro_torch.kernels.ia3_apply",
             "repro_torch.data", "repro_torch.data.synthetic",
             "repro_torch.optim", "repro_torch.optim.adamw",
             "repro_torch.train", "repro_torch.train.steps",
             "repro_torch.launch.train", "repro_torch.utils.tree",
             "repro_torch.models.moe"):
    assert name in names and name in sys.modules, name
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_configs_equal_jax_field_by_field():
    assert tlist_archs() == list_archs()
    for name in list_archs():
        jcfg, tcfg = get_config(name), tget_config(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(treduce(tcfg)) == \
            dataclasses.asdict(reduce_for_smoke(jcfg)), name


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_chip_smoke_imports_no_jax_and_runs_only_as_main():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set(_imported_roots(tree))
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    # module level holds only the docstring, imports, definitions and
    # constants; the body runs under `if __name__ == "__main__"`
    mains = [n for n in tree.body if isinstance(n, ast.If)]
    assert len(mains) == 1 and "__main__" in ast.unparse(mains[0].test)
    for node in tree.body:
        assert isinstance(node, (ast.Expr, ast.Import, ast.ImportFrom,
                                 ast.FunctionDef, ast.Assign, ast.If)), \
            ast.unparse(node)[:80]
        if isinstance(node, ast.Expr):
            assert isinstance(node.value, ast.Constant)


@pytest.mark.parametrize("tool", sorted(
    f for f in os.listdir(os.path.join(ROOT, "tools")) if f.endswith(".py")))
def test_tools_import_no_jax(tool):
    """The on-card tools (chip_smoke's phases run alone, kernel probes)
    import the port and never jax or the JAX package."""
    with open(os.path.join(ROOT, "tools", tool)) as f:
        roots = set(_imported_roots(ast.parse(f.read())))
    assert not roots & {"jax", "jaxlib", "repro"}, (tool, roots)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_kernel_impls_accepted(impl):
    cfg = treduce(tget_config("qwen1.5-0.5b")).with_xpeft(kernel_impl=impl)
    assert cfg.xpeft.kernel_impl == impl
