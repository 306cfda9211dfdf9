"""The port's ProfileStore persistence against the JAX package's, on the CPU.

Records come from the same mask logits in both packages (reduced
qwen1.5-0.5b's shapes, L=2, N=8, b=4, k=2): hard and soft masks, an
optional per-profile head, and, for int8 and int4 stores, the aggregated
Â/B̂ quantized on write. A store ``.npz`` saved by either package must
load in the other with identical keys, dtypes, bytes, meta and
checksums; ``merge_from`` adopts records and checksums and never a
quarantined record; a record corrupted on disk is quarantined on load
(an ``agg_*`` payload alone is shed instead, as in JAX). Everything here
is compared exactly: records are bytes.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.profiles import ProfileStore as JStore
from repro.resilience.integrity import RecordIntegrityError as JError
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.resilience.integrity import RecordIntegrityError as TError

L, N, BN, K, D = 2, 8, 4, 2, 16
# (mask_type, quant): the unquantized (bf16-bank) store, hard and soft,
# and the int8 / int4 stores with aggregated records
KINDS = [("hard", "none"), ("soft", "none"), ("hard", "int8"),
         ("hard", "int4")]


def _rows(seed, n=3):
    rng = np.random.default_rng(seed)
    rows = []
    for pid in range(n):
        row = {"mA": rng.normal(size=(L, N)).astype(np.float32),
               "mB": rng.normal(size=(L, N)).astype(np.float32),
               "ln_scale": (1 + 0.1 * rng.normal(size=(L, BN))
                            ).astype(np.float32),
               "ln_bias": (0.1 * rng.normal(size=(L, BN))).astype(np.float32)}
        if pid == 1:   # an optional classifier head
            row["head_w"] = rng.normal(size=(D, 3)).astype(np.float32)
            row["head_b"] = rng.normal(size=(3,)).astype(np.float32)
        agg = (rng.normal(size=(L, D, BN)).astype(np.float32),
               rng.normal(size=(L, BN, D)).astype(np.float32))
        rows.append((row, agg))
    return rows


def _stores(mask_type, quant, seed=0):
    shape = (L, N, BN, mask_type, K)
    kw = dict(quant=quant, quant_group=8)
    js, ts = JStore(*shape, **kw), TStore(*shape, **kw)
    for pid, (row, agg) in enumerate(_rows(seed)):
        agg = agg if quant != "none" and pid != 2 else None
        js.add_profile(pid, row, agg=None if agg is None else
                       tuple(jnp.asarray(a) for a in agg))
        ts.add_profile(pid, row, agg=None if agg is None else
                       tuple(torch.from_numpy(a) for a in agg))
    return js, ts


def _same_records(a, b):
    assert a.profile_ids() == b.profile_ids()
    for pid in a.profile_ids():
        ra, rb = a._rec[pid], b._rec[pid]
        assert list(ra) == list(rb), pid
        for k in ra:
            assert np.asarray(ra[k]).dtype == np.asarray(rb[k]).dtype, k
            assert np.asarray(ra[k]).shape == np.asarray(rb[k]).shape, k
            assert np.asarray(ra[k]).tobytes() == \
                np.asarray(rb[k]).tobytes(), (pid, k)
        assert a._crc[pid] == b._crc[pid]


def _npz(path):
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mask_type,quant", KINDS)
def test_records_byte_equal(mask_type, quant):
    js, ts = _stores(mask_type, quant)
    _same_records(js, ts)
    for pid in js.profile_ids():
        assert ts.record_nbytes(pid) == js.record_nbytes(pid)
    assert ts.bytes_per_profile(True) == js.bytes_per_profile(True)


@pytest.mark.parametrize("mask_type", ["hard", "soft"])
def test_mask_weights_match_jax(mask_type):
    js, ts = _stores(mask_type, "none")
    for got, want in zip(ts.batch_mask_weights([0, 2, 1]),
                         js.batch_mask_weights([0, 2, 1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)
    if mask_type == "soft":
        with pytest.raises(ValueError):
            ts.sparse_indices(0)


@pytest.mark.parametrize("mask_type,quant", KINDS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_in_one_package_load_in_the_other(tmp_path, mask_type, quant,
                                               writer):
    js, ts = _stores(mask_type, quant)
    path = str(tmp_path / f"{writer}.npz")
    (js if writer == "jax" else ts).save(path)
    loaded_t, loaded_j = TStore.load(path), JStore.load(path)
    for store in (loaded_t, loaded_j):
        assert (store.L, store.N, store.b, store.mask_type, store.k,
                store.quant, store.quant_group) == \
            (L, N, BN, mask_type, K, quant, 8)
        assert store.quarantined_ids() == []
    _same_records(loaded_t, js)
    _same_records(loaded_j, ts)
    # the other package writes the same file: keys, dtypes, bytes, meta
    other = str(tmp_path / "other.npz")
    (ts if writer == "jax" else js).save(other)
    a, b = _npz(path), _npz(other)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"]))


def test_merge_from():
    _, base = _stores("hard", "int8", seed=0)
    _, new = _stores("hard", "int8", seed=1)
    heard = []
    base.subscribe(lambda pid: heard.append(pid))
    new._rec[2]["mA"] = new._rec[2]["mA"] ^ np.uint8(1)   # corrupt pid 2
    with pytest.raises(TError):
        new.check_record(2)
    assert new.quarantined_ids() == [2]
    want = {pid: dict(new._rec[pid]) for pid in (0, 1)}
    kept = dict(base._rec[2])
    base.merge_from(new)
    assert heard == [0, 1]
    for pid in (0, 1):
        assert base._rec[pid] is new._rec[pid]
        assert base._crc[pid] == new._crc[pid]
        assert list(base._rec[pid]) == list(want[pid])
    assert base._rec[2] is not new._rec[2] and base._rec[2].keys() == \
        kept.keys()
    for pid in base.profile_ids():
        base.check_record(pid)
    with pytest.raises(ValueError):
        base.merge_from(TStore(L, N, BN, "soft", K))


@pytest.mark.parametrize("field,quarantined", [("mB", True),
                                               ("agg_b_q", False)])
def test_corrupt_record_on_disk_is_quarantined_on_load(tmp_path, field,
                                                        quarantined):
    js, ts = _stores("hard", "int8")
    path = str(tmp_path / "s.npz")
    ts.save(path)
    z = _npz(path)
    key = f"1:{field}"
    flat = z[key].reshape(-1).copy()
    flat.view(np.uint8)[0] ^= 0x10
    z[key] = flat.reshape(z[key].shape)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **z)
    for cls in (TStore, JStore):
        store = cls.load(bad)
        stats = store.integrity_stats()
        assert stats["corrupt_detected"] == 1
        if quarantined:
            assert stats["quarantined"] == [1]
            with pytest.raises((TError, JError)):
                store.ln_affines([1])
        else:
            # a corrupt aggregated payload alone is shed: the masks serve
            assert stats["quarantined"] == [] and stats["agg_dropped"] == [1]
            assert not store.has_quant_record(1)
            store.check_record(1)
        store.check_record(0)
    # a store saved without the quarantined record drops it
    tstore = TStore.load(bad)
    out = str(tmp_path / "resaved.npz")
    tstore.save(out)
    assert (1 in TStore.load(out).profile_ids()) == (not quarantined)
