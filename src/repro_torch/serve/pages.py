"""Block-paged memory pool for the continuous-batching serving engine.

The port of ``repro.serve.pages``. The windowed engine allocates its KV
cache as one dense ``[L, n_slots, S, KV, hd]`` block; the continuous
engine backs every sequence-axis cache leaf with a pool of fixed-size
PAGES (``[L, n_pages + 1, page_size, KV, hd]``) plus a per-slot page
table, and pools the per-request adapter records the same way (one
"entry" = one request's aggregated record). A request holds exactly
``ceil(len / page_size)`` pages, pages free the moment it retires, and
the engine preempts-to-host when the pool runs dry.

Two layers live here:

- ``PageAllocator`` — host bookkeeping, copied whole from the reference:
  per-color free lists, owner tracking that makes double-booking
  impossible, OOM raised BEFORE any state mutates, ``compact()`` remaps.
- tensor helpers — ``dense_view`` (page-table gather back to the dense
  layout ``models.forward`` takes), ``writeback`` / ``writeback_span``
  (scatter the written positions back to their pages), ``insert_group``
  (batched prefill insert), ``extract_slot`` / ``restore_slot``
  (preempt/resume swaps) and ``apply_remap``.

The sentinel index is ``n_pages``. PyTorch has neither JAX's
``mode="clip"`` gathers nor its ``mode="drop"`` scatters, and an index
out of range on the card is a device-side assert, so:

- every gather clamps its index explicitly: a sentinel table entry reads
  page ``n_pages - 1`` (as ``mode="clip"`` does), whose contents are
  finite junk at positions attention masks out (positions >= kv_valid
  carry weight exactly 0, and 0 times a finite value is 0);
- every dropped write lands in the pool's SCRATCH page, index
  ``n_pages``, which no table ever maps and no gather ever reads. A
  dropped write is never sent to a real page, not even as a rewrite of
  that page's own contents: in one ``index_put_`` such a write would race
  with a real write to the same element from another slot.

The pools start as zeros and only ever receive finite values, so junk is
always finite.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# cache leaves with a sequence axis (dim 2 of [lead, B, S, ...])
PAGED_LEAVES = ("k", "v", "attn_k", "attn_v")


def leaf_is_paged(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in PAGED_LEAVES


def _map(fn, tree, *rest, path=""):
    """``fn(path, leaf, *other_leaves)`` over a nested dict, the path
    joined with "/" as the reference's ``map_with_path`` joins it."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest),
                        path=f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree, *rest)


class PageOOM(RuntimeError):
    """The pool cannot satisfy an allocation. Raised BEFORE any allocator
    state mutates, so a failed alloc never leaks or double-books pages —
    the engine's response is preempt-to-pending (or deferring admission),
    never a corrupted table."""


class PageAllocator:
    """Host-side free-list allocator over ``n_pages`` fixed-size pages.

    ``n_colors`` partitions the pool into contiguous color classes (color
    of page p = ``p * n_colors // n_pages``). ``alloc(color=...)`` prefers
    pages of the caller's color and falls back to any free page
    (correctness never depends on affinity). Every page tracks its owner;
    freeing a page you don't own, double-freeing, or double-booking raises
    instead of corrupting.
    """

    def __init__(self, n_pages: int, *, n_colors: int = 1):
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        if not (1 <= n_colors <= n_pages):
            raise ValueError(f"n_colors {n_colors} not in [1, {n_pages}]")
        self.n_pages = n_pages
        self.n_colors = n_colors
        self._owner: Dict[int, object] = {}           # page -> owner
        self._pages_of: Dict[object, List[int]] = {}  # owner -> pages
        # LIFO free stacks per color: recently freed pages are re-used
        # first (their lines are warm)
        self._free: List[List[int]] = [[] for _ in range(n_colors)]
        for p in range(n_pages - 1, -1, -1):
            self._free[self.color_of(p)].append(p)
        self.allocs = 0
        self.frees = 0
        self.oom_events = 0
        self.high_water = 0

    # ------------------------------------------------------------------ query
    def color_of(self, page: int) -> int:
        return page * self.n_colors // self.n_pages

    def used(self) -> int:
        return len(self._owner)

    def free_count(self) -> int:
        return self.n_pages - len(self._owner)

    def owner_of(self, page: int):
        return self._owner.get(page)

    def pages_of(self, owner) -> List[int]:
        return list(self._pages_of.get(owner, ()))

    def owners(self) -> List:
        return list(self._pages_of)

    # ------------------------------------------------------------ alloc/free
    def alloc(self, n: int, owner, *, color: int = 0,
              strict: bool = False) -> List[int]:
        """Allocate ``n`` pages for ``owner`` (color-preferring; with
        ``strict`` only of ``color``: a serving mesh whose pages live on
        the shard of that color). Raises ``PageOOM`` — with the allocator
        untouched — if fewer than ``n`` such pages are free."""
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        free = len(self._free[color % self.n_colors]) if strict \
            else self.free_count()
        if n > free:
            self.oom_events += 1
            raise PageOOM(f"need {n} pages, {free} free of {self.n_pages}"
                          + (f" in color {color}" if strict else ""))
        got: List[int] = []
        order = [color % self.n_colors] + \
            [c for c in range(self.n_colors)
             if c != color % self.n_colors and not strict]
        for c in order:
            while self._free[c] and len(got) < n:
                got.append(self._free[c].pop())
            if len(got) == n:
                break
        assert len(got) == n, "free_count said yes but stacks were short"
        for p in got:
            assert p not in self._owner, f"double-booked page {p}"
            self._owner[p] = owner
        self._pages_of.setdefault(owner, []).extend(got)
        self.allocs += n
        self.high_water = max(self.high_water, self.used())
        return got

    def free(self, pages: List[int], owner) -> None:
        """Return ``pages`` to the pool; every page must belong to
        ``owner`` (ownership is validated BEFORE any page is freed)."""
        for p in pages:
            if self._owner.get(p) != owner:
                raise ValueError(
                    f"page {p} owned by {self._owner.get(p)!r}, "
                    f"not {owner!r} (double free / foreign free)")
        own = self._pages_of.get(owner, [])
        for p in pages:
            del self._owner[p]
            own.remove(p)
            self._free[self.color_of(p)].append(p)
        if owner in self._pages_of and not self._pages_of[owner]:
            del self._pages_of[owner]
        self.frees += len(pages)

    def free_owner(self, owner) -> List[int]:
        """Free every page ``owner`` holds; returns the freed list."""
        pages = self.pages_of(owner)
        if pages:
            self.free(pages, owner)
        return pages

    # -------------------------------------------------------------- compact
    def compact(self) -> Dict[int, int]:
        """Re-pack live pages onto the lowest indices (owner assignment and
        per-owner page ORDER preserved) and rebuild the free lists above
        them. Returns the ``{old_page: new_page}`` remap for the device
        side (`apply_remap`) and any page tables; an identity remap comes
        back when already packed."""
        live = sorted(self._owner)
        remap = {old: new for new, old in enumerate(live)}
        self._owner = {remap[p]: o for p, o in self._owner.items()}
        self._pages_of = {o: [remap[p] for p in ps]
                          for o, ps in self._pages_of.items()}
        self._free = [[] for _ in range(self.n_colors)]
        for p in range(self.n_pages - 1, len(live) - 1, -1):
            self._free[self.color_of(p)].append(p)
        return remap

    def check(self) -> None:
        """Invariant audit (tests): owned ∪ free is exactly the pool, with
        no page in both and no duplicates anywhere."""
        free_flat = [p for stack in self._free for p in stack]
        assert len(free_flat) == len(set(free_flat)), "duplicate free page"
        owned = set(self._owner)
        assert not (owned & set(free_flat)), "page both owned and free"
        assert owned | set(free_flat) == set(range(self.n_pages)), \
            "pages leaked from the pool"
        by_owner = [p for ps in self._pages_of.values() for p in ps]
        assert sorted(by_owner) == sorted(owned), "owner index out of sync"

    def reset_stats(self) -> None:
        """Zero the flow counters; ownership and free lists are untouched.
        `high_water` restarts from the CURRENT occupancy."""
        self.allocs = 0
        self.frees = 0
        self.oom_events = 0
        self.high_water = self.used()

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "used": self.used(),
                "free": self.free_count(), "high_water": self.high_water,
                "allocs": self.allocs, "frees": self.frees,
                "oom_events": self.oom_events}


# ----------------------------------------------------------------------------
# Tensor helpers. A pool leaf is [lead, n_pages + 1, page, ...]: n_pages
# real pages, then the scratch page (the sentinel's index) that absorbs
# dropped writes. Paged leaves are written IN PLACE and returned.
# ----------------------------------------------------------------------------

def pages_needed(upto_len: int, page_size: int) -> int:
    """Pages covering write positions 0..upto_len-1."""
    return -(-int(upto_len) // page_size)


def paged_seq_len(cache_template) -> int:
    """The (single) sequence length of the template's paged leaves, or 0
    when it has none."""
    found = set()
    _map(lambda p, x: found.add(x.shape[2]) if leaf_is_paged(p) else None,
         cache_template)
    assert len(found) <= 1, f"mixed sequence lengths {found}"
    return found.pop() if found else 0


def make_paged_cache(cache_template, n_pages: int, page_size: int,
                     n_slots: int, *, device) -> dict:
    """The paged cache for a dense-cache template (tensors, e.g. on the
    "meta" device): paged leaves ``[lead, B, S, ...]`` become ``[lead,
    n_pages + 1, page, ...]`` zero pools (the last page is the scratch
    page), resident leaves keep their dense shapes with B = n_slots, and
    the page table starts all sentinel. Returns ``{"data": tree, "table":
    [n_slots, S/page] int32}``."""
    S = paged_seq_len(cache_template)
    assert S % page_size == 0, (S, page_size)

    def one(path, leaf):
        shape = (leaf.shape[0], n_pages + 1, page_size) \
            + tuple(leaf.shape[3:]) if leaf_is_paged(path) else leaf.shape
        return torch.zeros(shape, dtype=leaf.dtype, device=device)

    mp = max(S // page_size, 1)
    table = torch.full((n_slots, mp), n_pages, dtype=torch.int32,
                       device=device)
    return {"data": _map(one, cache_template), "table": table}


def _real(pool) -> int:
    """Real pages of a pool leaf (the last page is scratch)."""
    return pool.shape[1] - 1


def dense_view(data, table, page_size: int):
    """Gather the paged leaves back to the dense ``[lead, B, S, ...]``
    layout through the page table (a sentinel entry clamps to the last
    real page: junk at positions attention masks out). Resident leaves
    pass through. The result is a new tensor the forward may write."""
    B, mp = table.shape

    def one(path, leaf):
        if not leaf_is_paged(path):
            return leaf
        idx = table.long().clamp(0, _real(leaf) - 1)
        v = leaf[:, idx]                      # [lead, B, mp, page, ...]
        return v.reshape((leaf.shape[0], B, mp * page_size)
                         + tuple(leaf.shape[3:]))

    return _map(one, data)


def writeback(data, dense_new, table, lengths, active, page_size: int):
    """Scatter the ONE decode-written position (``lengths[b]``) of every
    paged leaf back into its page, in place; resident leaves take the
    model's new value. Inactive slots write to the scratch page: their
    pad-compute row must never land in a page that may since belong to
    another slot."""
    B, mp = table.shape
    lengths = lengths.long()
    rows = torch.arange(B, device=table.device)
    pidx_owned = table[rows, (lengths // page_size).clamp(0, mp - 1)].long()
    off = lengths % page_size

    def one(path, pool, new):
        if not leaf_is_paged(path):
            return new
        pos = lengths.clamp(0, new.shape[2] - 1)
        row = new[:, rows, pos].to(pool.dtype)   # [lead, B, ...]
        pidx = torch.where(active, pidx_owned, _real(pool))
        pool[:, pidx, off] = row
        return pool

    return _map(one, data, dense_new)


def writeback_span(data, dense_new, table, lengths, span: int, active,
                   page_size: int):
    """Scatter ``span`` consecutive written positions per slot
    (``lengths[b] .. lengths[b]+span-1``) back into their pages, in place
    — the speculative round's writeback. Positions past the table (past
    S) or of inactive slots write to the scratch page; a position inside
    the table whose entry is the sentinel (past the slot's allocation)
    lands there too. Only positions the engine can later COMMIT are
    guaranteed page-backed, so a dropped overhang write only costs
    acceptance, never correctness."""
    B, mp = table.shape
    pos = lengths.long()[:, None] + torch.arange(span, device=table.device)
    page_of = pos // page_size
    in_range = active[:, None] & (page_of < mp)
    pidx_owned = torch.gather(table.long(), 1, page_of.clamp(0, mp - 1))
    off = pos % page_size
    rows = torch.arange(B, device=table.device)[:, None]

    def one(path, pool, new):
        if not leaf_is_paged(path):
            return new
        vals = new[:, rows, pos.clamp(0, new.shape[2] - 1)].to(pool.dtype)
        pidx = torch.where(in_range, pidx_owned, _real(pool))
        pool[:, pidx, off] = vals                # [lead, B, span, ...]
        return pool

    return _map(one, data, dense_new)


def insert_group(data, mini, slots, table, page_size: int):
    """Batched prefill insert for one length-bucket group, in place: the
    stacked mini-cache ``[lead, Bp, S, ...]`` chunks into pages and
    scatters through the group's table rows (chunks addressed by sentinel
    entries, past a request's allocation, go to the scratch page; decode
    fills those positions as the sequence grows). Resident leaves scatter
    by slot index."""
    B = slots.shape[0]
    pidx = table[slots].long()                            # [B, mp]
    mp = pidx.shape[1]

    def one(path, big, small):
        if not leaf_is_paged(path):
            big[:, slots] = small[:, :B].to(big.dtype)
            return big
        lead, rest = big.shape[0], tuple(big.shape[3:])
        rows = small[:, :B].reshape((lead, B, mp, page_size) + rest)
        big[:, pidx] = rows.to(big.dtype)
        return big

    return _map(one, data, mini)


def extract_slot(data, table_row, slot):
    """Gather ONE slot's cache for a preempt-to-host swap: paged leaves as
    ``[lead, mp, page, ...]`` page rows (sentinel entries clamp to junk the
    resume then sends to the scratch page), resident leaves as their
    ``[lead, ...]`` slice."""
    def one(path, leaf):
        if leaf_is_paged(path):
            return leaf[:, table_row.long().clamp(0, _real(leaf) - 1)]
        return leaf[:, slot]

    return _map(one, data)


def restore_slot(data, rows, table_row, slot):
    """Scatter a preempted slot's swapped cache back in, in place (the
    resume half of ``extract_slot``; sentinel table entries send their
    rows to the scratch page). The new table_row need not equal the one
    extracted from — pages are position-addressed through the table."""
    def one(path, big, saved):
        if leaf_is_paged(path):
            big[:, table_row.long()] = saved.to(big.device, big.dtype)
        else:
            big[:, slot] = saved.to(big.device, big.dtype)
        return big

    return _map(one, data, rows)


def apply_remap(data, table_h: np.ndarray, remap: Dict[int, int],
                n_pages: int):
    """Apply an allocator ``compact()`` remap to the pools (in place) and
    the HOST page-table mirror: page contents move to their new indices (a
    gather by the inverse permutation), table entries follow through a
    lookup table, sentinels stay sentinel. Returns (data, new_table_h).

    ``remap`` covers the live pages only; the free pages take the free
    targets in order, so the gather index is a whole permutation of the
    pool (the reference leaves those entries of its inverse unset, and
    what they gather is junk either way)."""
    perm = np.full(n_pages, -1)
    for old, new in remap.items():
        perm[old] = new
    perm[perm < 0] = sorted(set(range(n_pages)) - set(remap.values()))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pages)

    def one(path, leaf):
        if leaf_is_paged(path):
            idx = torch.from_numpy(inv).to(leaf.device)
            leaf[:, :n_pages] = leaf[:, idx]
        return leaf

    lut = np.concatenate([perm, [n_pages]]).astype(table_h.dtype)
    return _map(one, data), lut[table_h]
