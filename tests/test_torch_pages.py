"""The port's page allocator and paging helpers (``repro_torch.serve.pages``)
against the JAX package's ``repro.serve.pages``, on the CPU.

The allocator is pure Python in both: on the same seeded sequences of
alloc / free / free_owner / compact it must give the same pages, the same
OOMs and the same remaps, and keep its own audit after every op (with
hypothesis over arbitrary sequences as well). Every tensor helper is held
to JAX's on the same numpy inputs, bitwise, with sentinel table entries
and inactive slots: the port's pools carry one scratch page past the real
ones (JAX's pools have none), so the real pages are compared and the
scratch page is checked to be the only place a dropped write lands.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import pages as JPG
from repro_torch.serve import pages as TPG

N_PAGES, PAGE, LEAD, KV, HD = 6, 4, 2, 2, 3
MP = 3                       # table width: S = MP * PAGE = 12
S = MP * PAGE


# ------------------------------------------------------------- allocator
def _snapshot(alloc):
    return (dict(alloc._owner),
            {o: list(ps) for o, ps in alloc._pages_of.items()},
            [list(s) for s in alloc._free])


def _apply(alloc, op, a, b, n_pages, n_colors):
    """One coded op on an allocator -> its observable outcome."""
    if op == 0:
        try:
            return ("alloc", alloc.alloc(b % (n_pages + 2), a % 6,
                                         color=a % n_colors))
        except (JPG.PageOOM, TPG.PageOOM):
            return ("oom",)
    if op == 1:
        owner = a % 6
        pages = alloc.pages_of(owner)
        if not pages:
            return ("noop",)
        k = 1 + b % len(pages)
        alloc.free(pages[:k], owner)
        return ("free", pages[:k])
    if op == 2:
        return ("free_owner", alloc.free_owner(a % 6))
    return ("compact", alloc.compact())


def _run_both(ops, n_pages=16, n_colors=2):
    ja = JPG.PageAllocator(n_pages, n_colors=n_colors)
    ta = TPG.PageAllocator(n_pages, n_colors=n_colors)
    for op, a, b in ops:
        before = _snapshot(ta)
        got = _apply(ta, op % 4, a, b, n_pages, n_colors)
        want = _apply(ja, op % 4, a, b, n_pages, n_colors)
        assert got == want, (op, a, b)
        if got == ("oom",):
            assert _snapshot(ta) == before, "OOM mutated allocator state"
        ta.check()
        assert _snapshot(ta) == _snapshot(ja)
        assert ta.stats() == ja.stats()


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_jax_on_seeded_sequences(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 61))
        ops = rng.integers(0, 64, size=(n, 3))
        _run_both([tuple(map(int, row)) for row in ops])


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 63),
                          st.integers(0, 63)), max_size=60))
def test_allocator_properties_match_jax(ops):
    _run_both(ops)


def test_oom_raises_before_any_mutation():
    alloc = TPG.PageAllocator(4)
    alloc.alloc(3, "a")
    before = _snapshot(alloc)
    with pytest.raises(TPG.PageOOM):
        alloc.alloc(2, "b")
    assert _snapshot(alloc) == before
    assert alloc.stats()["oom_events"] == 1
    assert len(alloc.alloc(1, "b")) == 1
    alloc.check()


def test_foreign_and_double_free_raise():
    alloc = TPG.PageAllocator(4)
    pages = alloc.alloc(2, "a")
    with pytest.raises(ValueError):
        alloc.free(pages, "b")
    alloc.free(pages, "a")
    with pytest.raises(ValueError):
        alloc.free(pages, "a")
    alloc.check()


def test_color_affinity_and_compact():
    alloc = TPG.PageAllocator(8, n_colors=2)
    got = alloc.alloc(2, "a", color=1)
    assert all(alloc.color_of(p) == 1 for p in got)
    got2 = alloc.alloc(4, "b", color=1)
    assert any(alloc.color_of(p) == 0 for p in got2)
    alloc.free_owner("a")
    remap = alloc.compact()
    assert alloc.pages_of("b") == [remap[p] for p in got2]
    assert set(alloc.pages_of("b")) == set(range(4))
    alloc.check()


def test_pages_needed_and_leaf_paths():
    for n in (0, 1, 16, 17, 33):
        assert TPG.pages_needed(n, 16) == JPG.pages_needed(n, 16)
    for path in ("k", "v", "blocks/attn_k", "attn_v", "conv", "k/scale"):
        assert TPG.leaf_is_paged(path) == JPG.leaf_is_paged(path)


# ----------------------------------------------------------- tensor helpers
def _pool(rng):
    """A JAX pool [LEAD, N_PAGES, PAGE, KV, HD] and the port's copy with a
    scratch page (filled with a marker) appended."""
    j = rng.standard_normal((LEAD, N_PAGES, PAGE, KV, HD)).astype(np.float32)
    t = np.concatenate([j, np.full((LEAD, 1, PAGE, KV, HD), 7.0,
                                   np.float32)], axis=1)
    return j, torch.from_numpy(t)


def _tables():
    """Slot 0 owns pages [4, 1, -], slot 1 [2, -, -], slot 2 none
    (all sentinel), slot 3 [0, 5, 3]."""
    t = np.full((4, MP), N_PAGES, np.int32)
    t[0, :2] = (4, 1)
    t[1, 0] = 2
    t[3] = (0, 5, 3)
    return t


def _split(t_pool):
    """(real pages, scratch page) of a port pool."""
    return t_pool[:, :N_PAGES].numpy(), t_pool[:, N_PAGES].numpy()


def test_make_paged_cache_and_seq_len():
    tmpl_t = {"k": torch.empty((LEAD, 4, S, KV, HD), device="meta"),
              "v": torch.empty((LEAD, 4, S, KV, HD), device="meta")}
    tmpl_j = {k: jnp.zeros(v.shape) for k, v in tmpl_t.items()}
    assert TPG.paged_seq_len(tmpl_t) == JPG.paged_seq_len(tmpl_j) == S
    got = TPG.make_paged_cache(tmpl_t, N_PAGES, PAGE, 4, device="cpu")
    want = JPG.make_paged_cache(tmpl_j, N_PAGES, PAGE, 4)
    np.testing.assert_array_equal(got["table"].numpy(),
                                  np.asarray(want["table"]))
    for k in ("k", "v"):
        assert got["data"][k].shape == (LEAD, N_PAGES + 1, PAGE, KV, HD)
        assert not got["data"][k].any()


def test_dense_view_bitwise_with_sentinels():
    rng = np.random.default_rng(0)
    jp, tp = _pool(rng)
    table = _tables()
    want = JPG.dense_view({"k": jnp.asarray(jp)}, jnp.asarray(table),
                          PAGE)["k"]
    got = TPG.dense_view({"k": tp}, torch.from_numpy(table), PAGE)["k"]
    # sentinel entries read the last real page, as mode="clip" does,
    # never the scratch page
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lengths", [(5, 3, 0, 11), (7, 4, 2, 8)])
def test_writeback_bitwise_drops_to_scratch(lengths):
    rng = np.random.default_rng(1)
    jp, tp = _pool(rng)
    table = _tables()
    new = rng.standard_normal((LEAD, 4, S, KV, HD)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    active = np.asarray([True, True, False, False])
    want = JPG.writeback({"k": jnp.asarray(jp)}, {"k": jnp.asarray(new)},
                         jnp.asarray(table), jnp.asarray(lens),
                         jnp.asarray(active), PAGE)["k"]
    got = TPG.writeback({"k": tp}, {"k": torch.from_numpy(new)},
                        torch.from_numpy(table), torch.from_numpy(lens),
                        torch.from_numpy(active), PAGE)["k"]
    real, scratch = _split(got)
    np.testing.assert_array_equal(real, np.asarray(want))
    # the inactive slots' rows went to the scratch page, at their offsets
    for b in (2, 3):
        np.testing.assert_array_equal(scratch[:, lens[b] % PAGE],
                                      new[:, b, lens[b]])


@pytest.mark.parametrize("span", [1, 4])
def test_writeback_span_bitwise_past_the_table(span):
    rng = np.random.default_rng(2)
    jp, tp = _pool(rng)
    table = _tables()
    new = rng.standard_normal((LEAD, 4, S, KV, HD)).astype(np.float32)
    # slot 0 runs past its allocation (page 2 is sentinel), slot 3 past S
    lens = np.asarray([6, 1, 0, 10], np.int32)
    active = np.asarray([True, True, False, True])
    want = JPG.writeback_span({"k": jnp.asarray(jp)},
                              {"k": jnp.asarray(new)}, jnp.asarray(table),
                              jnp.asarray(lens), span, jnp.asarray(active),
                              PAGE)["k"]
    got = TPG.writeback_span({"k": tp}, {"k": torch.from_numpy(new)},
                             torch.from_numpy(table), torch.from_numpy(lens),
                             span, torch.from_numpy(active), PAGE)["k"]
    np.testing.assert_array_equal(_split(got)[0], np.asarray(want))


def test_insert_group_bitwise():
    rng = np.random.default_rng(3)
    jp, tp = _pool(rng)
    table = _tables()
    mini = rng.standard_normal((LEAD, 4, S, KV, HD)).astype(np.float32)
    slots = np.asarray([3, 0, 2], np.int32)   # Bp 4 > B 3: a pad row
    want = JPG.insert_group({"k": jnp.asarray(jp)}, {"k": jnp.asarray(mini)},
                            jnp.asarray(slots), jnp.asarray(table),
                            PAGE)["k"]
    got = TPG.insert_group({"k": tp}, {"k": torch.from_numpy(mini)},
                           torch.from_numpy(slots).long(),
                           torch.from_numpy(table), PAGE)["k"]
    np.testing.assert_array_equal(_split(got)[0], np.asarray(want))


def test_extract_restore_bitwise_round_trip():
    rng = np.random.default_rng(4)
    jp, tp = _pool(rng)
    table = _tables()
    for slot in range(4):
        want = JPG.extract_slot({"k": jnp.asarray(jp)},
                                jnp.asarray(table[slot]), slot)["k"]
        got = TPG.extract_slot({"k": tp}, torch.from_numpy(table[slot]),
                               slot)["k"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # resume slot 0's rows into other pages (2 and the sentinel)
    saved = TPG.extract_slot({"k": tp}, torch.from_numpy(table[0]), 0)
    row = np.asarray([5, 2, N_PAGES], np.int32)
    want = JPG.restore_slot({"k": jnp.asarray(jp)},
                            {"k": jnp.asarray(saved["k"].numpy())},
                            jnp.asarray(row), 0)["k"]
    got = TPG.restore_slot({"k": tp.clone()}, saved, torch.from_numpy(row),
                           0)["k"]
    np.testing.assert_array_equal(_split(got)[0], np.asarray(want))
    # the sentinel entry's rows (clamped junk) landed in the scratch page
    np.testing.assert_array_equal(_split(got)[1], saved["k"][:, 2].numpy())


def test_apply_remap_bitwise_and_view_unchanged():
    alloc = TPG.PageAllocator(N_PAGES)
    a = alloc.alloc(2, "a")
    b = alloc.alloc(3, "b")
    alloc.free_owner("a")
    rng = np.random.default_rng(5)
    jp, tp = _pool(rng)
    table_h = np.full((2, MP), N_PAGES, np.int32)
    table_h[0] = b
    before = TPG.dense_view({"k": tp}, torch.from_numpy(table_h), PAGE)["k"]
    remap = alloc.compact()
    assert sorted(remap) == sorted(b) and a
    jd, jt = JPG.apply_remap({"k": jnp.asarray(jp)}, table_h, remap, N_PAGES)
    td, tt = TPG.apply_remap({"k": tp}, table_h, remap, N_PAGES)
    np.testing.assert_array_equal(tt, jt)
    # the live pages moved as JAX moves them (what lands in the free pages
    # is junk: JAX's inverse permutation leaves those entries unset)
    live = len(remap)
    np.testing.assert_array_equal(_split(td["k"])[0][:, :live],
                                  np.asarray(jd["k"])[:, :live])
    after = TPG.dense_view(td, torch.from_numpy(tt), PAGE)["k"]
    np.testing.assert_array_equal(after[:, 0].numpy(), before[:, 0].numpy())
    assert (tt[1] == N_PAGES).all()
