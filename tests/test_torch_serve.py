"""The port's serving slice against the JAX package, on the CPU.

Workload: ``examples/serve_multiprofile.py``'s — reduced qwen1.5-0.5b
(float32), 4 hard-mask profiles, 6 requests of 6-10 prompt tokens and 8
new tokens on 3 slots, max_seq 64, admission-time aggregation — with
JAX's own weights and profile logits carried across by the bridge.

Tolerances: records and greedy tokens must be EQUAL; admission aggregates
rtol = atol = 1e-5 at float32 (the two frameworks sum in other orders).
Greedy tokens of a random-weight model flip on near-ties and then
cascade; at float32 the two frameworks agree to ~1e-6, so any differing
token must sit on a JAX top-2 logit gap below 1e-4 (checked, not
skipped).
"""
import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.models import forward as jforward
from repro.models import init_lm as jinit_lm
from repro.models import lm_logits as jlm_logits
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "qwen1.5-0.5b"
N_PROFILES = 4
TOL = dict(rtol=1e-5, atol=1e-5)
TIE_GAP = 1e-4


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=6 + i % 5)
            for i in range(6)]


def _requests(cls, prompts):
    return [cls(uid=i, prompt=p, profile_id=i % N_PROFILES,
                max_new_tokens=8) for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def served():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = treduce(tget_config(ARCH))
    key = jax.random.key(0)
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    xp = cfg.xpeft
    jstore = JStore(cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard",
                    xp.k)
    tstore = TStore(cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard",
                    xp.k)
    rows = [{k: v[pid] for k, v in table.items()}
            for pid in range(N_PROFILES)]
    for pid, row in enumerate(rows):
        jstore.add_profile(pid, row)
        tstore.add_profile(pid, row)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    prompts = _prompts(cfg)
    jeng = JEngine(cfg, params, jstore, max_slots=3, max_seq=64,
                   precompute=True)
    jreqs = _requests(JRequest, prompts)
    jeng.run_until_drained(list(jreqs))
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                jstore=jstore, tstore=tstore, prompts=prompts, jeng=jeng,
                jreqs=jreqs)


def _serve_port(s, sync_every=8):
    eng = TEngine(s["tcfg"], s["tparams"], s["tstore"], max_slots=3,
                  max_seq=64, sync_every=sync_every)
    reqs = _requests(TRequest, s["prompts"])
    eng.run_until_drained(list(reqs))
    return eng, reqs


def test_store_records_byte_equal(served):
    jstore, tstore = served["jstore"], served["tstore"]
    assert tstore.bytes_per_profile() == jstore.bytes_per_profile()
    for pid in range(N_PROFILES):
        jr, tr = jstore._rec[pid], tstore._rec[pid]
        assert sorted(jr) == sorted(tr)
        for key in jr:
            assert jr[key].dtype == tr[key].dtype, key
            assert jr[key].tobytes() == tr[key].tobytes(), key
        assert jstore._crc[pid] == tstore._crc[pid]
        for got, want in zip(tstore.sparse_indices(pid),
                             jstore.sparse_indices(pid)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tstore.ln_affines(range(N_PROFILES)),
                         jstore.ln_affines(range(N_PROFILES))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_admission_aggregates_match_jax_engine(served):
    eng, _ = _serve_port(served)
    for pid in range(N_PROFILES):
        want = served["jeng"].profile_cache.peek(pid)
        got = eng.profile_cache.peek(pid)
        assert want is not None and got is not None
        for key in ("a_hat", "b_hat", "ln_scale", "ln_bias"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), **TOL)
    assert eng.profile_cache.stats()["bytes"] == \
        served["jeng"].profile_cache.stats()["bytes"]


def _top2_gap(served, req, step):
    """JAX's top-2 logit gap at the step that produced token `step` of a
    request, recomputed uncached from the prompt + the tokens before it."""
    cfg, params = served["cfg"], served["params"]
    entry = served["jeng"].profile_cache.peek(req.profile_id)
    masks = jax.tree.map(lambda v: v[None], entry)
    seq = np.concatenate([req.prompt, req.generated[:step]])[None]
    h, _, _ = jforward(params, seq.astype(np.int32), cfg,
                       profile_masks=masks)
    top = np.sort(np.asarray(jlm_logits(params, h[:, -1:], cfg))[0, 0])
    return float(top[-1] - top[-2])


def test_engine_tokens_match_jax(served):
    eng, reqs = _serve_port(served)
    for treq, jreq in zip(reqs, served["jreqs"]):
        assert treq.done and len(treq.generated) == len(jreq.generated) == 8
        diff = [i for i, (a, b) in enumerate(zip(treq.generated,
                                                 jreq.generated)) if a != b]
        if diff:  # only a near-tie may flip a greedy token
            assert _top2_gap(served, jreq, diff[0]) < TIE_GAP, \
                (treq.uid, treq.generated, jreq.generated)
    st = eng.serve_stats()
    jst = served["jeng"].serve_stats()
    for key in ("decode_tokens", "prefill_batches", "prefill_occupancy",
                "host_syncs", "device_steps"):
        assert st[key] == jst[key], key
    assert st["profile_cache"]["hit_rate"] == jst["profile_cache"]["hit_rate"]


def test_tokens_invariant_to_sync_every(served):
    _, a = _serve_port(served, sync_every=1)
    eng8, b = _serve_port(served, sync_every=8)
    assert [r.generated for r in a] == [r.generated for r in b]
    assert eng8.serve_stats()["syncs_per_token"] < 1


def test_engine_options_outside_the_slice_raise(served, tmp_path):
    # precompute=False, continuous=True and mesh= are ported
    # (tests/test_torch_serve_perstep.py, tests/test_torch_serve_continuous.py,
    # tests/test_torch_mesh_serve.py): a world-1 mesh serves the one-device
    # tokens; a mesh the process group cannot fill raises
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 processes"):
            make_mesh((2, 2), ("data", "model"), "cpu")
        eng = TEngine(served["tcfg"], served["tparams"], served["tstore"],
                      max_slots=3, max_seq=64,
                      mesh=make_mesh((1, 1), ("data", "model"), "cpu"))
        reqs = _requests(TRequest, served["prompts"])
        eng.run_until_drained(list(reqs))
    finally:
        dist.destroy_process_group()
    assert [r.generated for r in reqs] == \
        [r.generated for r in _serve_port(served)[1]]
    assert eng.serve_stats()["devices"] == 1
    # continuous mode's own refusals are JAX's
    for kw, match in ((dict(max_seq=60), "multiple of page_size"),
                      (dict(max_seq=64, max_pages=3), "max-length")):
        with pytest.raises(ValueError, match=match):
            JEngine(served["cfg"], served["params"], served["jstore"],
                    continuous=True, **kw)
        with pytest.raises(ValueError, match=match):
            TEngine(served["tcfg"], served["tparams"], served["tstore"],
                    continuous=True, **kw)


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "6"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served 6 requests" in out.stdout
