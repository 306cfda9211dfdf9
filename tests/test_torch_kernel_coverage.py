"""The two shapes the port's kernels used to refuse on the card, held on
the CPU: #6 (``fused_adapter_quant``) plans a launch for every config the
port serves, and #8 (``decode_fused``) serves any slot count by launching
its instantiation once per group of at most ``MAX_SLOTS`` slots.

Neither kernel runs here (no card): the planner is a pure function, the
slot groups and their operand views are checked as the wrapper builds
them, and a 16-slot ``decode_fused`` engine runs the plain decode block,
whose tokens must equal the composed engine's. ``chip_smoke.py`` runs
both kernels on the card at these shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs, reduce_for_smoke
from repro_torch.core import xpeft as XP
from repro_torch.core.profiles import ProfileStore
from repro_torch.kernels import decode_fused as KD
from repro_torch.kernels import fused_adapter_quant as KFQ
from repro_torch.kernels.fused_adapter_batched import _row_stride
from repro_torch.models import init_lm
from repro_torch.quant import schemes as QS
from repro_torch.serve import Request, ServeEngine


def _plan_before(d, nb, T, itemsize, scheme, a_groups, b_groups):
    """The planner as it was before the two-pass tile: the first cluster
    of (8, 16) whose ranges are whole vectors and whose one-pass shared
    memory fits, else None (the wrapper raised)."""
    int4 = scheme == "int4"
    tt = 1 if T == 1 else KFQ.TILE_T
    for cs in (8, 16):
        if KFQ.ranges_whole(d, nb, int4, cs) and KFQ.smem_bytes(
                d // cs, nb, tt, itemsize, int4, a_groups, b_groups) \
                <= KFQ.MAX_SMEM:
            return cs
    return None


@pytest.mark.parametrize("arch", list_archs())
def test_fused_adapter_quant_plans_every_config(arch):
    """Every config's d and b, both schemes at its quant group, T = 1 and
    16, bf16 and fp32 x: ``plan`` returns a cluster; where a cluster
    planned before, the same one with one pass over the tile; elsewhere
    (gemma3-27b int4) 8 blocks and two passes, within shared memory."""
    cfg = get_config(arch)
    d, nb, g = cfg.d_model, cfg.xpeft.bottleneck, cfg.xpeft.quant_group
    for scheme in ("int8", "int4"):
        groups = (1, 1) if scheme == "int8" else \
            (nb // QS.group_for(nb, g), d // QS.group_for(d, g))
        for T in (1, 16):
            for itemsize in (2, 4):
                cs, passes = KFQ.launch_plan(d, nb, T, itemsize, scheme,
                                             *groups)
                assert KFQ.plan(d, nb, T, itemsize, scheme, *groups) == cs
                before = _plan_before(d, nb, T, itemsize, scheme, *groups)
                if before is not None:
                    assert (cs, passes) == (before, 1)
                else:
                    assert (cs, passes) == (8, 2) and scheme == "int4"
                    assert arch == "gemma3-27b"
                assert KFQ.ranges_whole(d, nb, scheme == "int4", cs)
                assert KFQ.smem_bytes(d // cs, nb, 1 if T == 1 else 16,
                                      itemsize, scheme == "int4", *groups,
                                      passes) <= KFQ.MAX_SMEM


def test_slot_groups_cover_every_slot_once():
    for B in range(1, 33):
        groups = KD.slot_groups(B)
        slots = [s for g in groups for s in range(g.start, g.stop)]
        assert slots == list(range(B)), B
        assert all(0 < g.stop - g.start <= KD.MAX_SLOTS for g in groups)
        assert len(groups) == -(-B // KD.MAX_SLOTS)
    with pytest.raises(ValueError):
        KD.slot_groups(0)


@pytest.mark.parametrize("route", ["bf16", "int8", "int4"])
def test_slot_group_operands_are_views_of_the_slot_buffers(route):
    """What each launch of a 16-slot call gets: the adapter operands of
    its slots, views of one layer of the [B, L, ...] slot buffers at the
    group's first slot with the buffers' own batch strides."""
    B, L, d, b = 16, 3, 64, 16
    gen = torch.Generator().manual_seed(4)
    a = 0.1 * torch.randn((B, L, d, b), generator=gen)
    bb = 0.1 * torch.randn((B, L, b, d), generator=gen)
    masks = {"ln_scale": torch.ones((B, L, b)),
             "ln_bias": torch.zeros((B, L, b))}
    if route == "bf16":
        masks.update(a_hat=a.to(torch.bfloat16),
                     b_hat=bb.to(torch.bfloat16))
    else:
        qa, qb = QS.quantize(a, route, group=8), QS.quantize(bb, route,
                                                               group=8)
        masks.update(a_q=qa["q"], a_scale=qa["scale"], b_q=qb["q"],
                     b_scale=qb["scale"])
    layer = {k: v[:, 1] for k, v in masks.items()}
    x = torch.zeros((B, 1, d), dtype=torch.bfloat16)
    whole = KD._adapter_operands(layer, route, x)
    for g in KD.slot_groups(B):
        part = KD._adapter_operands({k: v[g] for k, v in layer.items()},
                                    route, x[g])
        assert part["nb"] == whole["nb"] == b
        assert part["groups"] == whole["groups"]
        assert part["bf16_strides"] == whole["bf16_strides"]
        assert part["quant_strides"] == whole["quant_strides"]
        for key in ("bf16", "quant"):
            for p, w in zip(part[key], whole[key]):
                if w.data_ptr() == x.data_ptr():
                    continue  # an unused slot, given x
                stride = _row_stride(w, tuple(w.shape[1:]), key)
                assert p.data_ptr() == w.data_ptr() \
                    + g.start * stride * w.element_size()


def _engine(cfg, params, store, **kw):
    return ServeEngine(cfg, params, store, max_slots=16, max_seq=48,
                       sync_every=4, **kw)


def test_sixteen_slot_decode_fused_drain_equals_composed():
    """A 16-slot windowed ``decode_fused`` engine (reduced qwen1.5-0.5b,
    float32, 16 requests of 3-12 prompt tokens, 2-9 new) gives the
    composed engine's tokens; on the CPU each decode step runs the plain
    decode block once per layer over all 16 slots."""
    from repro_torch.kernels import ops
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    xp = cfg.xpeft
    params = init_lm(cfg, seed=0, device="cpu")
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=4), seed=0)
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k)
    for pid in range(4):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})
    rng = np.random.default_rng(5)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 13))),
              i % 4, 2 + i % 8) for i in range(16)]

    def drain(c):
        reqs = [Request(uid=i, prompt=p, profile_id=pid, max_new_tokens=n)
                for i, (p, pid, n) in enumerate(specs)]
        _engine(c, params, store).run_until_drained(list(reqs))
        return [r.generated for r in reqs]

    calls = []
    fused = ops.decode_block_fused

    def spy(x, *args, **kw):
        calls.append(x.shape[0])
        return fused(x, *args, **kw)
    ops.decode_block_fused = spy
    try:
        got = drain(cfg.with_(decode_fused=True))
    finally:
        ops.decode_block_fused = fused
    assert calls and set(calls) == {16}
    assert got == drain(cfg)
