"""The port's analytic cost accounting (``repro_torch.analysis``) against
the JAX package's (``repro.analysis``), on the CPU.

Every byte function returns JAX's integers at every config's widths and
every scheme; the byte math equals the true bytes of the port's own
quantized banks and store records (``tests/test_analysis_bytes.py``'s
five tests on the port's tensors); ``model_flops``, ``matmul_params`` and
``_attn_flops_per_seq`` equal JAX's exactly for every config x shape x
device count x workload; ``roofline_terms`` is JAX's formula with the
H100's constants (within 1e-12 relative); the engine's admission record
gives JAX's ``bank_bytes_per_request`` on the reduced qwen config.
"""
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import bytes as JAB
from repro.analysis import roofline as JRL
from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import analysis as TA
from repro_torch import bridge
from repro_torch.analysis import bytes as TAB
from repro_torch.analysis import roofline as TRL
from repro_torch.configs import LM_SHAPES, list_archs
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.configs.base import PAPER_SHAPE
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.quant import schemes as TQS
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
SCHEMES = ("none", "int8", "int4")


def test_exports_are_jax_exports():
    import repro.analysis as JA
    want = {n for n in dir(JA) if not n.startswith("_")
            and callable(getattr(JA, n))}
    got = {n for n in dir(TA) if not n.startswith("_")
           and callable(getattr(TA, n))}
    assert got == want


# ----------------------------------------------------------------------------
# bytes.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_byte_functions_equal_jax(arch):
    """Every function of bytes.py, as integers, at the config's widths,
    for each scheme, dense and sparse, at the config's dtype and 4."""
    jcfg, tcfg = get_config(arch), tget_config(arch)
    xp = tcfg.xpeft
    L, N, k, d, b = (tcfg.num_layers, xp.num_adapters, xp.k, tcfg.d_model,
                     xp.bottleneck)
    assert TAB.itemsize_for(tcfg.dtype) == JAB.itemsize_for(jcfg.dtype)
    for scheme in SCHEMES:
        for itemsize in (TAB.itemsize_for(tcfg.dtype), 4):
            kw = dict(scheme=scheme, itemsize=itemsize, group=xp.quant_group)
            for n in (b, d):
                got = TAB.row_bytes(n, **kw)
                assert type(got) is int and got == JAB.row_bytes(n, **kw)
            assert TAB.bank_slice_bytes(d, b, **kw) \
                == JAB.bank_slice_bytes(d, b, **kw)
            for dense in (False, True):
                assert TAB.admission_bank_bytes(L, N, k, d, b, dense=dense,
                                                **kw) \
                    == JAB.admission_bank_bytes(L, N, k, d, b, dense=dense,
                                                **kw)
        got = TAB.record_bytes(L, d, b, scheme=scheme, group=xp.quant_group)
        assert got == JAB.record_bytes(L, d, b, scheme=scheme,
                                       group=xp.quant_group)
    assert TAB.aggregation_bytes(tcfg) == JAB.aggregation_bytes(jcfg)


def test_tree_nbytes_equals_jax(engines_base):
    """The true bytes of a nested tree of mixed dtypes, and of the reduced
    qwen model's whole parameter tree, carried across by the bridge."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": {"c": rng.integers(0, 9, (7,)).astype(np.int8),
                  "d": rng.normal(size=(2, 2, 3)).astype(np.float16)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["b"]["e"] = jnp.zeros((4, 6), jnp.bfloat16)
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"]),
                   "d": torch.from_numpy(tree["b"]["d"]),
                   "e": torch.zeros((4, 6), dtype=torch.bfloat16)}}
    assert TAB.tree_nbytes(ttree) == JAB.tree_nbytes(jtree) \
        == 15 * 4 + 7 + 12 * 2 + 24 * 2
    for base in engines_base.values():
        assert TAB.tree_nbytes(base["tparams"]) \
            == JAB.tree_nbytes(base["params"]) > 0


def test_itemsize_for():
    assert TAB.itemsize_for("bfloat16") == 2
    assert TAB.itemsize_for("float32") == 4
    with pytest.raises(TypeError):
        TAB.itemsize_for("not_a_dtype")


# the five tests of tests/test_analysis_bytes.py on the port's tensors

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("L,N,d,b", [(2, 8, 64, 4), (3, 16, 128, 48)])
def test_bank_slice_bytes_matches_true_quantized_arrays(scheme, L, N, d, b):
    gen = torch.Generator().manual_seed(0)
    bank = {"bank_a": 0.1 * torch.randn((L, N, d, b), generator=gen),
            "bank_b": 0.1 * torch.randn((L, N, b, d), generator=gen)}
    if scheme == "none":
        true = TAB.tree_nbytes({k: v.to(torch.float16)
                                for k, v in bank.items()})
        analytic = L * N * TAB.bank_slice_bytes(d, b, itemsize=2)
    else:
        true = TAB.tree_nbytes(TQS.quantize_bank(bank, scheme, group=32))
        analytic = L * N * TAB.bank_slice_bytes(d, b, scheme=scheme,
                                                group=32)
    assert analytic == true, (analytic, true)


def test_record_bytes_matches_store_record():
    """record_bytes == the true bytes of the quantized Â/B̂ record the
    port's ProfileStore keeps for a profile added with ``agg=``."""
    L, N, d, b, k = 2, 8, 64, 4, 2
    gen = torch.Generator().manual_seed(1)
    a_hat = 0.1 * torch.randn((L, d, b), generator=gen)
    b_hat = 0.1 * torch.randn((L, b, d), generator=gen)
    for scheme in ("int8", "int4"):
        qa, qb = (TQS.quantize(t, scheme) for t in (a_hat, b_hat))
        true = TAB.tree_nbytes(qa) + TAB.tree_nbytes(qb)
        assert TAB.record_bytes(L, d, b, scheme=scheme) == true
        store = TStore(L, N, b, "hard", k, quant=scheme, quant_group=32)
        row = {"mA": np.zeros((L, N), np.float32),
               "mB": np.zeros((L, N), np.float32),
               "ln_scale": np.ones((L, b), np.float32),
               "ln_bias": np.zeros((L, b), np.float32)}
        store.add_profile(0, row, agg=(a_hat.numpy(), b_hat.numpy()))
        rec = store.quant_records([0])
        assert TAB.record_bytes(L, d, b, scheme=scheme) == sum(
            v[0].numel() * v.element_size() for v in rec.values())


def test_full_config_quant_reductions_meet_gates():
    agg = TAB.aggregation_bytes(tget_config("qwen1.5-0.5b"))
    assert agg["reduction"] >= 4.0
    assert agg["int8_vs_dense"] <= 0.30
    assert agg["int4_vs_dense"] <= 0.20
    assert agg["int8_vs_sparse"] <= 0.55
    assert agg["int4_vs_sparse"] <= 0.32
    assert agg["bytes_sparse_int4"] < agg["bytes_sparse_int8"] \
        < agg["bytes_sparse"]


def test_aggregation_bytes_smoke_config_matches_engine_units():
    cfg = treduce(tget_config("qwen1.5-0.5b"))
    xp = cfg.xpeft
    agg = TAB.aggregation_bytes(cfg)
    per_profile = TAB.admission_bank_bytes(
        cfg.num_layers, xp.num_adapters, xp.k, cfg.d_model, xp.bottleneck,
        itemsize=4)
    assert agg["bytes_sparse"] == per_profile
    assert agg["bytes_dense"] // agg["bytes_sparse"] \
        == xp.num_adapters // xp.k


# ----------------------------------------------------------------------------
# roofline.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", LM_SHAPES + (PAPER_SHAPE,),
                         ids=lambda s: s.name)
def test_model_flops_equal_jax(arch, shape):
    """matmul_params, _attn_flops_per_seq (prefill and decode context) and
    model_flops at num_devices 1/4/256/512 and both workloads: exactly
    JAX's numbers."""
    from repro.configs.base import get_shape as jget_shape
    jcfg, tcfg = get_config(arch), tget_config(arch)
    jshape = jget_shape(shape.name)
    assert TRL.matmul_params(tcfg) == JRL.matmul_params(jcfg)
    T = shape.seq_len
    assert TRL._attn_flops_per_seq(tcfg, T) \
        == JRL._attn_flops_per_seq(jcfg, T)
    assert TRL._attn_flops_per_seq(tcfg, 1, decode_ctx=T) \
        == JRL._attn_flops_per_seq(jcfg, 1, decode_ctx=T)
    for n in (1, 4, 256, 512):
        for workload in ("xpeft", "full"):
            got = TRL.model_flops(tcfg, shape, n, workload)
            assert got == JRL.model_flops(jcfg, jshape, n, workload), \
                (n, workload)


def test_h100_constants():
    """The H100 SXM5 80GB HBM3's data-sheet numbers; the collective term
    uses NVLink 4's one direction."""
    assert TRL.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert TRL.HBM_BW == 3.35e12
    assert TRL.NVLINK_BW == 450e9


def test_roofline_terms_follow_jax_formula(monkeypatch):
    """JAX's formula and keys with its constants set to the H100's: every
    number within 1e-12 relative, the dominant term and its ties equal."""
    monkeypatch.setattr(JRL, "PEAK_FLOPS", TRL.PEAK_FLOPS["bfloat16"])
    monkeypatch.setattr(JRL, "HBM_BW", TRL.HBM_BW)
    monkeypatch.setattr(JRL, "ICI_BW", TRL.NVLINK_BW)
    peak, hbm, link = (TRL.PEAK_FLOPS["bfloat16"], TRL.HBM_BW,
                       TRL.NVLINK_BW)
    cases = [(0.0, 0.0, 0.0), (1e15, 1e9, 1e6), (1e9, 1e12, 0.0),
             (0.0, 0.0, 4.5e9), (peak, hbm, link), (3.3e13, 7e10, 1e10)]
    for args in cases:
        got, want = TRL.roofline_terms(*args), JRL.roofline_terms(*args)
        assert set(got) == set(want)
        assert got["dominant"] == want["dominant"], args
        for key in got:
            if key != "dominant":
                assert got[key] == pytest.approx(want[key], rel=1e-12,
                                                 abs=0.0), (args, key)


def test_chip_smoke_bounds_read_the_roofline_constants():
    """chip_smoke.bound is the larger of bytes over HBM_BW and operations
    over the dtype's peak, from repro_torch.analysis.roofline; no v5e
    constant is left in the port, chip_smoke.py or tools/."""
    import chip_smoke as cs
    for nbytes, flops, dtype in ((3.35e9, 1.0, "bfloat16"),
                                 (1.0, 989e9, "bfloat16"),
                                 (1.0, 67e9, "float32")):
        ms, by = cs.bound(nbytes, flops, dtype)
        t_b, t_o = nbytes / TRL.HBM_BW, flops / TRL.PEAK_FLOPS[dtype]
        assert ms == max(t_b, t_o) * 1e3
        assert by == ("bytes" if t_b >= t_o else "operations")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in ("src/repro_torch", "tools"):
        for dirpath, _, names in os.walk(os.path.join(ROOT, top)):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    v5e = re.compile(r"\b(197e12|819e9|50e9)\b|\bv5e\b")
    for path in files:
        with open(path) as f:
            assert not v5e.search(f.read()), path


# ----------------------------------------------------------------------------
# the engine's admission bytes
# ----------------------------------------------------------------------------

SPEC = (("bottleneck", 4), ("lora", 4), ("ia3", 2), ("prefix", 2))
HETERO = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=SPEC, prefix_tokens=2)


@pytest.fixture(scope="module")
def engines_base():
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    key = jax.random.key(0)
    from repro.models import init_lm as jinit_lm
    out = {}
    for name, kw in (("plain", {}), ("hetero", HETERO)):
        c = cfg.with_xpeft(**kw)
        params = jax.jit(jinit_lm, static_argnums=1)(key, c)
        table = jax.tree.map(np.asarray, JXP.init_profile_table(key, c))
        out[name] = dict(
            cfg=c, tcfg=treduce(tget_config("qwen1.5-0.5b")).with_xpeft(
                **kw), params=params,
            tparams=bridge.to_torch(jax.tree.map(np.asarray, params)),
            rows=[{k: v[pid] for k, v in table.items()} for pid in range(4)])
    return out


@pytest.mark.parametrize("path", ["bf16", "int8", "int4", "hetero", "soft",
                                  "per_step"])
def test_engine_bank_bytes_per_request_equal_jax(engines_base, path):
    """One admission wave of 4 requests (profiles 0-3) through each
    engine's hydration: the port's ``last_admission`` (its path, hits,
    misses and ``bank_bytes_per_request``) equals JAX's engine's."""
    base = engines_base["hetero" if path == "hetero" else "plain"]
    scheme = path if path in ("int8", "int4") else "none"
    cfg, tcfg = (c.with_xpeft(bank_quant=scheme)
                 for c in (base["cfg"], base["tcfg"]))
    xp = cfg.xpeft
    mask_type = "soft" if path == "soft" else "hard"
    shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, mask_type,
             xp.k)
    skw = dict(quant=scheme, quant_group=xp.quant_group,
               bank_spec=xp.bank_spec)
    js, ts = JStore(*shape, **skw), TStore(*shape, **skw)
    for pid, row in enumerate(base["rows"]):
        js.add_profile(pid, row)
        ts.add_profile(pid, row)
    precompute = path != "per_step"
    jeng = JEngine(cfg, base["params"], js, max_slots=4, max_seq=32,
                   precompute=precompute)
    teng = TEngine(tcfg, base["tparams"], ts, max_slots=4, max_seq=32,
                   precompute=precompute)
    prompt = np.arange(5, dtype=np.int32)
    for eng, cls in ((jeng, JRequest), (teng, TRequest)):
        eng._hydrate_stacked([cls(uid=i, prompt=prompt, profile_id=i,
                                  max_new_tokens=2) for i in range(4)])
    got, want = teng.last_admission, jeng.last_admission
    for key in ("path", "cache_hits", "cache_misses",
                "bank_bytes_per_request"):
        assert got[key] == want[key], (key, got, want)
    if path in ("bf16", "int8", "int4", "hetero", "soft"):
        assert got["bank_bytes_per_request"] > 0
