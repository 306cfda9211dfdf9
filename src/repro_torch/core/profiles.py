"""ProfileStore: byte-level persistence of per-profile X-PEFT state.

Host-side (numpy) records, byte-equal to ``repro.core.profiles``'s for the
same mask logits: hard masks bit-packed (or soft-mask logits in fp16), LN
affines and optional per-profile heads in fp16, a per-field crc32 sidecar
verified at every hydration. Serving hydrates through the vectorized
public API (``batch_sparse_indices``, ``batch_mask_weights``,
``ln_affines``, ``head``).

A heterogeneous bank's ``bank_spec`` is part of the store's identity; a
quantized store (``quant`` int8/int4) may carry each profile's aggregated
Â/B̂, quantized on write, so serving admits it with zero bank reads.
``save``/``load`` write and read the JAX package's ``.npz`` layout (keys
``"<pid>:<field>"`` and a JSON ``__meta__`` with the checksums): a file
written by either package loads in the other, and a record that fails its
checksums on load is quarantined, never served.
"""
from __future__ import annotations

import json
import os
import tempfile
import weakref
import zipfile
from typing import Dict, Iterable

import numpy as np
import torch

from repro_torch.core import masks as M
from repro_torch.quant import schemes as QS
from repro_torch.resilience.integrity import RecordIntegrityError, \
    array_crc, record_crc


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.array(a)


class ProfileStore:
    def __init__(self, num_layers: int, num_adapters: int, bottleneck: int,
                 mask_type: str = "hard", k: int = 50, quant: str = "none",
                 quant_group: int = 32, bank_spec=()):
        if mask_type not in ("hard", "soft"):
            raise ValueError(f"mask_type {mask_type!r}")
        self.L = num_layers
        self.N = num_adapters
        self.b = bottleneck
        self.mask_type = mask_type
        self.k = k
        # heterogeneous banks: the ((type, count), ...) segment layout of
        # the unified mask index space these records select over, part of
        # the store's identity (the same mask bits select other adapter
        # families under another layout)
        self.bank_spec = tuple((str(t), int(c)) for t, c in bank_spec)
        # quant != "none": graduation may attach the profile's aggregated
        # Â/B̂, persisted QUANTIZED with the store's scheme
        self.quant = QS.check_scheme(quant)
        self.quant_group = quant_group
        self._rec: Dict[int, dict] = {}
        # integrity sidecar, parallel to _rec and never inside it
        self._crc: Dict[int, Dict[str, int]] = {}
        self._quarantined: Dict[int, str] = {}
        self.corrupt_detected = 0
        self.agg_dropped: list = []  # pids whose corrupt agg payload was shed
        self._listeners: list = []

    # -------------------------------------------------------- invalidation
    def subscribe(self, fn) -> None:
        """Register ``fn(pid)``, called whenever a record is added or
        replaced. Bound methods are held weakly (a store outlives the
        engines serving from it); plain functions strongly."""
        if hasattr(fn, "__self__"):
            self._listeners.append(weakref.WeakMethod(fn))
        else:
            self._listeners.append(lambda _fn=fn: _fn)

    def _notify(self, pid: int) -> None:
        live = []
        for ref in self._listeners:
            fn = ref()
            if fn is not None:
                fn(pid)
                live.append(ref)
        self._listeners = live

    # ------------------------------------------------------------------ add
    def add_profile(self, pid: int, profile_params: dict, *,
                    agg=None) -> None:
        """Freeze a profile (mask logits mA/mB [L, N] + LN affines [L, b],
        and optionally a classifier head head_w/head_b; tensors or arrays)
        into its byte-level record: hard masks bit-packed from their top-k,
        soft masks as fp16 logits.

        ``agg`` (quantized stores only): the profile's aggregated
        ``(Â [L, d, b], B̂ [L, b, d])``, quantized on write with the
        store's scheme into ``agg_a_q``/``agg_a_scale``/``agg_b_q``/
        ``agg_b_scale``, so serving can admit the profile without reading
        the bank."""
        rec = {
            "ln_scale": _host(profile_params["ln_scale"]).astype(np.float16),
            "ln_bias": _host(profile_params["ln_bias"]).astype(np.float16),
        }
        for m in ("mA", "mB"):
            if self.mask_type == "hard":
                rec[m] = M.pack_mask(M.binarize(
                    torch.as_tensor(_host(profile_params[m])), self.k))
            else:
                rec[m] = _host(profile_params[m]).astype(np.float16)
        if "head_w" in profile_params:
            rec["head_w"] = _host(profile_params["head_w"]).astype(np.float16)
            rec["head_b"] = _host(profile_params["head_b"]).astype(np.float16)
        if agg is not None:
            if self.quant == "none":
                raise ValueError("aggregated records require a quantized "
                                 "store (quant='int8'|'int4')")
            for side, t in zip(("a", "b"), agg):
                t = t if torch.is_tensor(t) else torch.from_numpy(
                    np.array(t, np.float32))
                q = QS.quantize(t, self.quant, group=self.quant_group)
                rec[f"agg_{side}_q"] = _host(q["q"])
                rec[f"agg_{side}_scale"] = _host(q["scale"])
        self._rec[int(pid)] = rec
        self._crc[int(pid)] = record_crc(rec)
        self._quarantined.pop(int(pid), None)
        self._notify(int(pid))

    # ------------------------------------------------------------- integrity
    def check_record(self, pid: int) -> None:
        """Verify one record against its checksums. A mismatch in a core
        field (masks, LN affines, head) quarantines the record (never
        served until re-added) and raises ``RecordIntegrityError``. A
        mismatch confined to the aggregated ``agg_*`` payload is healed
        instead: those fields are shed (subscribers notified, dropping any
        cached copy) and the call returns; the intact masks re-hydrate the
        profile from the bank."""
        pid = int(pid)
        if pid in self._quarantined:
            raise RecordIntegrityError(pid, (), self._quarantined[pid])
        rec = self._rec[pid]
        want = self._crc.get(pid)
        if want is None:  # a record saved without checksums: bless it
            self._crc[pid] = record_crc(rec)
            return
        bad = [k for k in sorted(set(rec) | set(want))
               if k not in rec or k not in want
               or array_crc(np.asarray(rec[k])) != want[k]]
        if not bad:
            return
        self.corrupt_detected += 1
        if all(k.startswith("agg_") for k in bad):
            for k in [k for k in rec if k.startswith("agg_")]:
                rec.pop(k)
                want.pop(k, None)
            self.agg_dropped.append(pid)
            self._notify(pid)
            return
        self._quarantined[pid] = f"checksum mismatch ({', '.join(bad)})"
        self._notify(pid)
        raise RecordIntegrityError(pid, bad)

    def quarantined_ids(self):
        return sorted(self._quarantined)

    def integrity_stats(self) -> dict:
        return dict(corrupt_detected=self.corrupt_detected,
                    quarantined=self.quarantined_ids(),
                    agg_dropped=sorted(set(self.agg_dropped)))

    # ---------------------------------------------------------------- fetch
    def mask_weights(self, pid: int):
        """Float mask weights ([L, N], [L, N]) fp32 of one profile: k-hot
        (1/k at the set bits) or the softmax of the fp16 logits."""
        self.check_record(pid)
        rec = self._rec[int(pid)]
        if self.mask_type == "hard":
            return tuple(M.khot_weights_from_bits(
                M.unpack_mask(rec[m], self.N), self.k) for m in ("mA", "mB"))
        return tuple(M.soft_mask_weights(torch.from_numpy(
            rec[m].astype(np.float32))) for m in ("mA", "mB"))

    def batch_mask_weights(self, pids: Iterable[int]):
        """Stacked [B, L, N] weights x2 + [B, L, b] LN affines x2, fp32
        host tensors, for per-step serving and soft-mask admission."""
        pids = list(pids)
        ws = [self.mask_weights(pid) for pid in pids]
        ln_s, ln_b = self.ln_affines(pids)
        return (torch.stack([w[0] for w in ws]),
                torch.stack([w[1] for w in ws]), ln_s, ln_b)

    def sparse_indices(self, pid: int):
        """([L, k] int32 idx, [L, k] fp32 w) x2 for sparse aggregation."""
        if self.mask_type != "hard":
            raise ValueError("sparse indices need hard-mask records")
        self.check_record(pid)
        rec = self._rec[int(pid)]
        ia = M.mask_indices(M.unpack_mask(rec["mA"], self.N), self.k)
        ib = M.mask_indices(M.unpack_mask(rec["mB"], self.N), self.k)
        w = torch.full(tuple(ia.shape), 1.0 / self.k, dtype=torch.float32)
        return ia, w, ib, w

    def batch_sparse_indices(self, pids: Iterable[int]):
        """Stacked ([R, L, k] idx, [R, L, k] w) x2 (host tensors)."""
        parts = [self.sparse_indices(pid) for pid in pids]
        return tuple(torch.stack([p[i] for p in parts]) for i in range(4))

    def has_quant_record(self, pid: int) -> bool:
        """True when ``pid`` carries a quantized aggregated Â/B̂ record
        that passes its checksums; a record whose agg payload was just
        shed (or whose core fields are quarantined) answers False."""
        if "agg_a_q" not in self._rec.get(int(pid), {}):
            return False
        try:
            self.check_record(pid)
        except RecordIntegrityError:
            return False
        return "agg_a_q" in self._rec[int(pid)]

    def quant_records(self, pids: Iterable[int]):
        """Stacked quantized aggregated records of a batch of profiles:
        {"a_q" [R, L, d, b|b/2], "a_scale", "b_q", "b_scale"} as host
        tensors, the zero-bank-read admission hydration."""
        if self.quant == "none":
            raise ValueError("store has no quantized records")
        pids = list(pids)
        return {dst: torch.from_numpy(np.stack(
                    [self._rec[int(pid)][src] for pid in pids]))
                for src, dst in (("agg_a_q", "a_q"),
                                 ("agg_a_scale", "a_scale"),
                                 ("agg_b_q", "b_q"),
                                 ("agg_b_scale", "b_scale"))}

    def head(self, pid: int):
        """The profile's classifier head (stored fp16) as float32 host
        tensors (head_w [d, C], head_b [C]), or None for a record stored
        without one."""
        self.check_record(pid)
        rec = self._rec[int(pid)]
        if "head_w" not in rec:
            return None
        return (torch.from_numpy(rec["head_w"].astype(np.float32)),
                torch.from_numpy(rec["head_b"].astype(np.float32)))

    def ln_affines(self, pids: Iterable[int]):
        """Stacked adapter-LN affines ([R, L, b] scale, [R, L, b] bias) as
        float32 host tensors."""
        pids = list(pids)
        for pid in pids:
            self.check_record(pid)
        scales = np.stack([self._rec[int(pid)]["ln_scale"] for pid in pids])
        biases = np.stack([self._rec[int(pid)]["ln_bias"] for pid in pids])
        return (torch.from_numpy(scales.astype(np.float32)),
                torch.from_numpy(biases.astype(np.float32)))

    # ------------------------------------------------------------- accounting
    def profile_ids(self):
        return sorted(self._rec)

    def _identity(self):
        return (self.L, self.N, self.b, self.mask_type, self.k, self.quant,
                self.quant_group, self.bank_spec)

    def merge_from(self, other: "ProfileStore") -> None:
        """Adopt another store's records and checksums (never a record
        that store quarantined); each adopted pid is notified, so a
        serving engine drops its cached aggregate of a replaced record."""
        if self._identity() != other._identity():
            raise ValueError(f"store shape mismatch: {self._identity()} vs "
                             f"{other._identity()}")
        for pid, rec in other._rec.items():
            if int(pid) in other._quarantined:
                continue
            self._rec[int(pid)] = rec
            self._crc[int(pid)] = dict(
                other._crc.get(int(pid)) or record_crc(rec))
            self._quarantined.pop(int(pid), None)
            self._notify(int(pid))

    def bytes_per_profile(self, include_ln: bool = False) -> int:
        core = M.bytes_per_profile(self.N, self.L, self.mask_type)
        if include_ln:
            core += 2 * self.b * self.L * 2  # fp16 LN affine
        return core

    def total_bytes(self, include_ln: bool = False) -> int:
        return len(self._rec) * self.bytes_per_profile(include_ln)

    def record_nbytes(self, pid: int) -> int:
        """True byte size of one persisted record (masks, fp16 affines and
        heads, and a quantized store's aggregated payload)."""
        return sum(v.nbytes for v in self._rec[int(pid)].values())

    # ---------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        """Write every record not quarantined to ``path`` (``.npz``),
        atomically: a temporary file in the same directory, then a
        rename. The zip members carry a fixed timestamp, so the file's
        bytes are a function of the records alone: equal stores write
        byte-equal files."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        saved = [p for p in sorted(self._rec) if p not in self._quarantined]
        meta = dict(L=self.L, N=self.N, b=self.b, mask_type=self.mask_type,
                    k=self.k, quant=self.quant,
                    quant_group=self.quant_group,
                    bank_spec=[list(s) for s in self.bank_spec], pids=saved,
                    crc={str(pid): self._crc.get(pid)
                         or record_crc(self._rec[pid]) for pid in saved})
        members = [("__meta__", np.asarray(json.dumps(meta)))]
        members += [(f"{pid}:{k}", v) for pid in saved
                    for k, v in self._rec[pid].items()]
        fd, tmp = tempfile.mkstemp(suffix=".npz",
                                   dir=os.path.dirname(path) or ".")
        os.close(fd)
        # np.savez's layout (one .npy member per key, stored), with the
        # member timestamp fixed where np.savez stamps the current time
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
            for key, val in members:
                info = zipfile.ZipInfo(key + ".npy",
                                       date_time=(1980, 1, 1, 0, 0, 0))
                with zf.open(info, "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(val),
                                              allow_pickle=False)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ProfileStore":
        """Read a store written by ``save`` (either package's); every
        record is checked against its saved checksums here, and one that
        fails is quarantined (``integrity_stats``)."""
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["__meta__"]))
        store = cls(meta["L"], meta["N"], meta["b"], meta["mask_type"],
                    meta["k"], meta.get("quant", "none"),
                    meta.get("quant_group", 32),
                    bank_spec=meta.get("bank_spec", ()))
        crcs = meta.get("crc", {})
        for pid in meta["pids"]:
            # a variable field set (optional heads, agg payloads): adopt
            # every "<pid>:<field>" entry
            prefix = f"{pid}:"
            store._rec[int(pid)] = {key[len(prefix):]: z[key]
                                    for key in z.files
                                    if key.startswith(prefix)}
            want = crcs.get(str(pid))
            if want is not None:
                store._crc[int(pid)] = {k: int(v) for k, v in want.items()}
        for pid in list(store._rec):
            try:
                store.check_record(pid)
            except RecordIntegrityError:
                pass  # quarantined; surfaced through integrity_stats()
        return store
