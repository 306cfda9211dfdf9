"""The port's training roster, row optimizer and gang step against the JAX
package, on the CPU.

Configs: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` (2 layers, d=64,
vocab 512, N=8, b=4, k=2, float32; the LM objective) and JAX's onboarding
classification config, ``reduce_for_smoke(get_config("bert-base-xpeft"))``
with 4 labels, vocab 64, N=8, k=2 (per-slot heads). JAX's frozen weights,
roster state and fresh rows (``fold_in(base_key, pid)``) come across
through ``repro_torch.bridge``; JAX's Gumbel draws are injected as
``noise``.

Tolerances, stated before any run:
- the row optimizer and the row clip: the same fp32 operations in the same
  order -> rtol = atol = 1e-6; rows that are not active bitwise untouched.
- one gang step: each slot's loss, gradients (read from JAX's first Adam
  moment with clipping off, m = (1 - b1) g) and the new roster (params,
  moments, EMAs) within rtol = atol = 1e-5; the k-hot forward selection,
  the counters and the active mask bitwise.
- within the port (same ops, same shapes): slot isolation, parked and
  poisoned rows, and re-admission bitwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.data import MarkovLM as JMarkov
from repro.data import ProfileClassification as JCls
from repro.models import init_lm as jinit_lm
from repro.optim import adamw as JOPT
from repro.resilience.faults import FaultPlan as JPlan
from repro.train import roster as JR
from repro.train import steps as JST
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import xpeft as TXP
from repro_torch.data import ProfileClassification
from repro_torch.optim import adamw as TOPT
from repro_torch.resilience import FaultPlan
from repro_torch.train import roster as TR
from repro_torch.train import steps as TST
from repro_torch.train.steps import _rows_per_example
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

M_PER_SLOT, SEQ, LR = 4, 12, 5e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(kind):
    if kind == "lm":
        return (reduce_for_smoke(get_config("qwen1.5-0.5b")),
                treduce(tget_config("qwen1.5-0.5b")))
    return tuple(r(g("bert-base-xpeft")).with_(num_labels=4, vocab_size=64)
                 .with_xpeft(num_adapters=8, k=2)
                 for r, g in ((reduce_for_smoke, get_config),
                              (treduce, tget_config)))


def _source(kind, cfg):
    if kind == "lm":
        return JMarkov(cfg.vocab_size, 8, seed=1)
    return JCls(cfg.vocab_size, cfg.num_labels, num_profiles=8, seed=5)


def _batch(src, step, slot_pids, S):
    pids = np.repeat([0 if p is None else p for p in slot_pids], M_PER_SLOT)
    b = src.sample(step, S * M_PER_SLOT, SEQ, profile_ids=pids)
    return {k: np.asarray(v).reshape((S, M_PER_SLOT) + v.shape[1:])
            for k, v in b.items()}


def _noise(key, cfg, S):
    """JAX's Gumbel draws of a gang step's key, as the step takes them."""
    ka, kb = jax.random.split(key)
    shape = (S * M_PER_SLOT, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


def _close(got, want, rtol, atol, what):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _close_tree(got, want, rtol, atol, what=""):
    tp, jp = tree_paths(got), jtree_paths(want)
    assert sorted(tp) == sorted(jp)
    for path in jp:
        _close(tp[path], jp[path], rtol, atol, f"{what}{path}")


@pytest.fixture(scope="module", params=["lm", "cls"])
def setup(request):
    """(kind, cfg, tcfg, JAX frozen, port frozen, data source)."""
    kind = request.param
    cfg, tcfg = _cfgs(kind)
    frozen = jax.jit(jinit_lm, static_argnums=1)(jax.random.key(0), cfg)
    return (kind, cfg, tcfg, frozen, bridge.to_torch(_np(frozen)),
            _source(kind, cfg))


def _states(setup, S, pids):
    """JAX's and the port's {"frozen", "roster"} with ``pids[s]`` admitted
    into slot s: the port's roster is JAX's initial one through the bridge,
    and the port admits JAX's fresh rows."""
    kind, cfg, tcfg, frozen, tfrozen, _ = setup
    jroster = JR.Roster(cfg, jax.random.key(7), S)
    r0 = JR.init_roster_state(jax.random.key(1), cfg, S)
    troster = TR.Roster(tcfg, 7, S, device="cpu")
    tr = bridge.to_torch(_np(r0))
    jr = r0
    for slot, pid in enumerate(pids):
        if pid is None:
            continue
        jr = jroster.admit(jr, slot, pid)
        fresh = _np(jroster._fresh(jroster.profile_key(pid)))
        troster.admit(tr, slot, pid, fresh=bridge.to_torch(fresh))
    _close_tree(tr, _np(jr), 0, 0, "admit ")
    return ({"frozen": frozen, "roster": jr},
            {"frozen": tfrozen, "roster": tr}, troster)


# ----------------------------------------------------------------------------
# tree paths, row optimizer
# ----------------------------------------------------------------------------

def test_tree_paths_equal_jax():
    tree = {"b": {"y": np.zeros(2), "x": [np.ones(1), np.ones(3)]},
            "a": np.arange(3), "opt": {"m": {"t": np.zeros(1)}}}
    want = jtree_paths(tree)
    got = tree_paths(tree)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in want)


def _row_trees(seed, S=4):
    rng = np.random.default_rng(seed)
    params = {"table": {"mA": rng.normal(size=(S, 2, 8)).astype(np.float32),
                        "ln": rng.normal(size=(S, 2, 4)).astype(np.float32)},
              "head": rng.normal(size=(S, 5)).astype(np.float32)}
    grads = jax.tree.map(lambda p: (rng.normal(size=p.shape)
                                    * rng.uniform(0.1, 3.0, size=(S,) +
                                                  (1,) * (p.ndim - 1)))
                         .astype(np.float32), params)
    return params, grads


@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.01, 0.5)])
def test_row_optimizer_matches_jax(wd, clip):
    params, grads = _row_trees(3)
    active = np.array([True, False, True, True])
    jopt = JOPT.adamw_init_rows(params, 4)
    topt = TOPT.adamw_init_rows(bridge.to_torch(params), 4)
    jp, tp = params, bridge.to_torch(params)
    for i in range(3):
        g = jax.tree.map(lambda x: x * (1.0 + 0.5 * i), grads)
        jg, jn = JOPT.clip_by_row_norm(g, clip)
        tg, tn = TOPT.clip_by_row_norm(bridge.to_torch(g), clip)
        _close(tn, jn, 1e-6, 1e-6, "row norm")
        _close_tree(tg, _np(jg), 1e-6, 1e-6, "clipped ")
        act = active if i else np.array([True, True, False, True])
        jp, jopt = JOPT.adamw_update_rows(jg, jopt, jp, jnp.asarray(act),
                                          lr=1e-2, weight_decay=wd)
        tp_new, topt = TOPT.adamw_update_rows(tg, topt, tp,
                                              torch.from_numpy(act),
                                              lr=1e-2, weight_decay=wd)
        # rows that are not active: params and moments bitwise untouched
        for new, old in zip(tree_leaves(tp_new), tree_leaves(tp)):
            assert torch.equal(new[~torch.from_numpy(act)],
                               old[~torch.from_numpy(act)])
        tp = tp_new
        _close_tree(tp, _np(jp), 1e-6, 1e-6, f"step {i} params ")
        _close_tree(topt, _np(jopt), 1e-6, 1e-6, f"step {i} opt ")
    assert topt["step"].tolist() == [3, 1, 2, 3]


# ----------------------------------------------------------------------------
# the gang step against JAX's
# ----------------------------------------------------------------------------

def test_gang_step_matches_jax(setup):
    """Two slots active, one parked (slot 2): one gang step's k-hot
    selection, slot losses, gradients and new roster against JAX's."""
    kind, cfg, tcfg, _, _, src = setup
    S, pids = 3, [4, 1, None]
    key = jax.random.key(100)
    batch = _batch(src, 0, pids, S)
    jb = jax.tree.map(jnp.asarray, batch)
    noise = _noise(key, cfg, S)
    # the k-hot selection of the step's masks
    jstate, tstate, _ = _states(setup, S, pids)
    jrows = jax.tree.map(lambda t: jnp.repeat(t, M_PER_SLOT, axis=0),
                         jstate["roster"]["trainable"]["table"])
    jw = JXP.profile_mask_weights(jrows, cfg.xpeft, key=key)
    trows = {k: _rows_per_example(v, M_PER_SLOT)
             for k, v in tstate["roster"]["trainable"]["table"].items()}
    tw = TXP.profile_mask_weights(trows, tcfg.xpeft, noise=noise)
    half = 0.5 / cfg.xpeft.k
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy() > half, np.asarray(b) > half)
    # gradients: with clipping off JAX's first moment is (1 - b1) g
    loose = jax.jit(JST.make_gang_step(cfg, lr=LR, clip_norm=1e9))
    jnew, _ = loose(jstate, jb, key)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, slot_loss, slot_acc = TST.gang_loss_and_grads(
        tstate["frozen"], tstate["roster"], tb, tcfg, noise)
    jm = _np(jnew["roster"]["opt"]["m"])
    want = jax.tree.map(lambda m: m / np.float32(1 - 0.9), jm)
    _close_tree(grads, want, 1e-5, 1e-5, "grad ")
    assert all(g[2].abs().max() == 0 for g in tree_leaves(grads))
    assert all(g[:2].abs().max() > 0 for g in tree_leaves(grads))
    ema = np.asarray(jnew["roster"]["ema_loss"]) / np.float32(1 - 0.9)
    _close(slot_loss[:2], ema[:2], 1e-5, 1e-5, "slot loss")
    if kind == "cls":
        acc = np.asarray(jnew["roster"]["ema_acc"]) / np.float32(1 - 0.9)
        _close(slot_acc[:2], acc[:2], 1e-5, 1e-5, "slot accuracy")
    # the whole step, clip 1.0
    jstep = jax.jit(JST.make_gang_step(cfg, lr=LR))
    tstep = TST.make_gang_step(tcfg, lr=LR)
    jstate2, jmet = jstep(jstate, jb, key)
    tstate2, tmet = tstep(tstate, batch, noise)
    assert tstate2 is tstate
    _close_tree(tstate2["roster"], _np(jstate2["roster"]), 1e-5, 1e-5,
                "roster ")
    for k in jmet:
        _close(tmet[k], jmet[k], 1e-5, 1e-5, f"metric {k}")


def test_poisoned_slot_nonfinite_equal_jax(setup):
    """A fault plan poisoning slot 1: the ``nonfinite`` counters equal
    JAX's; the healthy slots are bitwise the port's run whose poison
    window never opens; the poisoned slot keeps its admission row and zero
    moments."""
    kind, cfg, tcfg, _, _, src = setup
    S, pids = 3, [0, 1, 2]
    batch = _batch(src, 0, pids, S)
    jstate, tstate, _ = _states(setup, S, pids)
    jstep = jax.jit(JST.make_gang_step(
        cfg, lr=LR, fault_plan=JPlan(poison_slots=(1,))))
    runs = {}
    for name, plan in (("clean", FaultPlan(poison_slots=(1,),
                                           poison_from_step=10 ** 9)),
                       ("faulty", FaultPlan(poison_slots=(1,)))):
        st = {"frozen": tstate["frozen"],
              "roster": tree_map(torch.clone, tstate["roster"])}
        step = TST.make_gang_step(tcfg, lr=LR, fault_plan=plan)
        for i in range(3):
            st, met = step(st, batch, _noise(jax.random.key(3), cfg, S))
        runs[name] = (st["roster"], met)
    for i in range(3):
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                             jax.random.key(3))
    faulty, met = runs["faulty"]
    clean, met0 = runs["clean"]
    assert faulty["nonfinite"].tolist() == \
        np.asarray(jstate["roster"]["nonfinite"]).tolist() == [0, 3, 0]
    assert faulty["slot_step"].tolist() == [3, 0, 3]
    assert float(met["nonfinite_slots"]) == 1 and \
        float(met0["nonfinite_slots"]) == 0
    assert np.isfinite(float(met["loss"]))
    for s in (0, 2):
        for a, b in zip(tree_leaves(clean), tree_leaves(faulty)):
            assert torch.equal(a[s], b[s])
    for a, b in zip(tree_leaves(tstate["roster"]["trainable"]),
                    tree_leaves(faulty["trainable"])):
        assert torch.equal(a[1], b[1])
    for t in tree_leaves(faulty["opt"]["m"]) + tree_leaves(faulty["opt"]["v"]):
        assert not t[1].any()
    assert int(faulty["opt"]["step"][1]) == 0


# ----------------------------------------------------------------------------
# the roster's lifecycle, within the port (JAX's test_roster.py)
# ----------------------------------------------------------------------------

S2 = 2


@pytest.fixture(scope="module")
def cls_setup():
    _, tcfg = _cfgs("cls")
    from repro_torch.models import init_lm
    frozen = init_lm(tcfg, seed=0, device="cpu")
    data = ProfileClassification(tcfg.vocab_size, tcfg.num_labels,
                                 num_profiles=8, seed=5)
    return tcfg, frozen, data


def _run(tcfg, frozen, data, schedule, n_steps):
    """Drive the gang step by hand with a fixed generator per step;
    ``schedule`` maps step -> [(op, slot, pid)] lifecycle actions."""
    roster = TR.Roster(tcfg, 7, S2, device="cpu")
    state = {"frozen": frozen,
             "roster": TR.init_roster_state(tcfg, S2, seed=1,
                                            device="cpu")}
    storage = {p: (t.data_ptr(), t.shape, t.dtype)
               for p, t in tree_paths(state["roster"]).items()}
    step = TST.make_gang_step(tcfg, lr=LR)
    slot_pids = [None] * S2
    for op, slot, pid in schedule.get(-1, []):
        roster.admit(state["roster"], slot, pid)
        slot_pids[slot] = pid
    for i in range(n_steps):
        state, _ = step(state, _batch(data, i, slot_pids, S2),
                        torch.Generator().manual_seed(i))
        for op, slot, pid in schedule.get(i, []):
            if op == "evict":
                roster.evict(state["roster"], slot)
                slot_pids[slot] = None
            else:
                roster.admit(state["roster"], slot, pid)
                slot_pids[slot] = pid
    return roster, state["roster"], storage


def _slot_leaves(rstate, slot):
    leaves = tree_leaves(rstate["trainable"]) \
        + tree_leaves(rstate["opt"]["m"]) + tree_leaves(rstate["opt"]["v"])
    rows = [t[slot] for t in leaves]
    return rows + [rstate[k][slot] for k in ("slot_step", "ema_loss",
                                             "ema_acc")] \
        + [rstate["opt"]["step"][slot]]


def test_slot_isolation_bitwise_under_evict_readmit(cls_setup):
    base = {-1: [("admit", 0, 0), ("admit", 1, 1)]}
    churn = {-1: [("admit", 0, 0), ("admit", 1, 1)],
             3: [("evict", 0, None)], 5: [("admit", 0, 2)]}
    _, r_base, _ = _run(*cls_setup, base, 10)
    _, r_churn, _ = _run(*cls_setup, churn, 10)
    for a, b in zip(_slot_leaves(r_base, 1), _slot_leaves(r_churn, 1)):
        assert torch.equal(a, b)


def test_roster_storage_fixed_across_admission_waves(cls_setup):
    """>= 3 admission/eviction waves: every roster tensor keeps its
    storage, shape and dtype (JAX's "the gang step traces once")."""
    schedule = {-1: [("admit", 0, 0), ("admit", 1, 1)],
                2: [("evict", 0, None)], 3: [("admit", 0, 2)],
                5: [("evict", 1, None), ("admit", 1, 3)],
                7: [("evict", 0, None), ("admit", 0, 4)]}
    _, rstate, storage = _run(*cls_setup, schedule, 10)
    assert {p: (t.data_ptr(), t.shape, t.dtype)
            for p, t in tree_paths(rstate).items()} == storage
    assert rstate["slot_step"].tolist() == [2, 4]


def test_inactive_slots_fully_untouched(cls_setup):
    tcfg = cls_setup[0]
    init = TR.init_roster_state(tcfg, S2, seed=1, device="cpu")
    _, rstate, _ = _run(*cls_setup, {-1: [("admit", 0, 0)]}, 6)
    for a, b in zip(_slot_leaves(init, 1), _slot_leaves(rstate, 1)):
        assert torch.equal(a, b)
    assert not bool(rstate["active"][1])


def test_readmission_resets_to_fresh_deterministic_init(cls_setup):
    roster, rstate, _ = _run(
        *cls_setup, {-1: [("admit", 0, 0), ("admit", 1, 1)],
                     4: [("evict", 0, None), ("admit", 0, 5)]}, 5)
    fresh = roster.fresh(5)
    for a, b in zip(tree_leaves(fresh), tree_leaves(rstate["trainable"])):
        assert torch.equal(a, b[0])
    # a second roster with the same base seed draws the same row
    again = TR.Roster(cls_setup[0], 7, S2, device="cpu").fresh(5)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(fresh), tree_leaves(again)))
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fresh), tree_leaves(roster.fresh(6))))
    for t in tree_leaves(rstate["opt"]["m"]):
        assert not t[0].any()
    assert int(rstate["opt"]["step"][0]) == 0
    assert int(rstate["slot_step"][0]) == 0


def test_per_slot_adam_step_advances_only_when_active(cls_setup):
    roster, rstate, _ = _run(*cls_setup, {-1: [("admit", 0, 0)]}, 4)
    assert rstate["opt"]["step"].tolist() == [4, 0]
    assert rstate["slot_step"].tolist() == [4, 0]
    assert rstate["ema_count"].tolist() == [4, 0]
    met = roster.metrics(rstate, 0.9)
    assert met["active"].tolist() == [True, False]
    assert met["slot_step"].tolist() == [4, 0]
    ema = rstate["ema_loss"][0].item() / (1 - 0.9 ** 4)
    assert met["ema_loss"][0] == pytest.approx(ema, rel=1e-6)
    row = roster.slot_params(rstate, 0)
    assert sorted(row) == ["head_b", "head_w", "ln_bias", "ln_scale", "mA",
                           "mB"]
    np.testing.assert_array_equal(row["mA"],
                                  rstate["trainable"]["table"]["mA"][0])
