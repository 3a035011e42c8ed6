"""SSTable — immutable sorted epoch-delta files.

A copy of ``risingwave_tpu/storage/sstable.py`` with its imports rewritten
(host only: the port imports nothing of the reference).

Reference: src/storage/src/hummock/sstable/ (block-based SST with
bloom/xor filters and min-max metadata; full key = user key ‖ epoch,
docs/state-store-overview.md).

TPU-native re-design: state rows are fixed-dtype COLUMNS, not byte
strings — so an SST here is a columnar blob (npz): key lanes + value
lanes sorted by memcomparable key order, a tombstone lane, and
metadata (table id, epoch, row count, min/max key, a split-block bloom
filter over key hashes). Sorting uses the same total-order bit tricks
as the reference's memcomparable encoding (ints offset to unsigned,
floats via the ordered-float transform — ops/agg order keys), so byte
comparison order == SQL ORDER BY order lane by lane.

Merge-on-read recovery: iterate SSTs newest-epoch-first per key,
first hit wins, tombstones drop the key (UserIterator + MergeIterator
semantics, src/storage/src/hummock/iterator/).
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BLOOM_BITS_PER_KEY = 10


def _order_key(col: np.ndarray) -> np.ndarray:
    """Map a lane to unsigned memcomparable order (reference:
    util/memcmp_encoding.rs semantics, vectorized)."""
    if col.dtype == np.bool_:
        return col.astype(np.uint8)
    if np.issubdtype(col.dtype, np.unsignedinteger):
        return col
    if np.issubdtype(col.dtype, np.integer):
        u = col.astype(np.uint64 if col.dtype.itemsize == 8 else np.uint32)
        sign = np.uint64(1) << np.uint64(63) if col.dtype.itemsize == 8 else np.uint32(1) << np.uint32(31)
        return u ^ sign
    if col.dtype == np.float64 or col.dtype == np.float32:
        u_t = np.uint64 if col.dtype == np.float64 else np.uint32
        bits = col.view(u_t)
        sign = u_t(1) << u_t(col.dtype.itemsize * 8 - 1)
        neg = (bits & sign) != 0
        return np.where(neg, ~bits, bits | sign)
    raise TypeError(f"unsupported key dtype {col.dtype}")


def sort_order(key_cols: Sequence[np.ndarray]) -> np.ndarray:
    """Row order by lexicographic memcomparable key (last lane minor)."""
    lanes = [_order_key(np.asarray(c)) for c in key_cols]
    return np.lexsort(tuple(reversed(lanes)))


def _bloom_build(hashes: np.ndarray, n_keys: int) -> np.ndarray:
    nbits = max(64, 1 << int(np.ceil(np.log2(max(1, n_keys) * BLOOM_BITS_PER_KEY))))
    bits = np.zeros(nbits // 8, np.uint8)
    for rot in (0, 21, 42):
        idx = ((hashes >> np.uint64(rot)) % np.uint64(nbits)).astype(np.int64)
        np.bitwise_or.at(bits, idx // 8, (1 << (idx % 8)).astype(np.uint8))
    return bits


def _bloom_may_contain(bits: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    nbits = np.uint64(len(bits) * 8)
    ok = np.ones(len(hashes), bool)
    for rot in (0, 21, 42):
        idx = ((hashes >> np.uint64(rot)) % nbits).astype(np.int64)
        ok &= (bits[idx // 8] & (1 << (idx % 8)).astype(np.uint8)) != 0
    return ok


def key_hashes(key_cols: Sequence[np.ndarray]) -> np.ndarray:
    """64-bit fnv-ish hash per row over all key lanes (host side)."""
    n = len(np.asarray(key_cols[0]))
    h = np.full(n, 0xCBF29CE484222325, np.uint64)
    for c in key_cols:
        u = _order_key(np.asarray(c)).astype(np.uint64)
        h = (h ^ u) * np.uint64(0x100000001B3)
        h ^= h >> np.uint64(29)
    return h


@dataclass
class SstMeta:
    table_id: str
    epoch: int
    n_rows: int
    key_names: Tuple[str, ...]
    value_names: Tuple[str, ...]


def build_sst(
    table_id: str,
    epoch: int,
    key_cols: Dict[str, np.ndarray],
    value_cols: Dict[str, np.ndarray],
    tombstone: np.ndarray,
    key_order: Sequence[str],
) -> bytes:
    """Serialize one epoch delta, sorted by key, with bloom + meta."""
    order = sort_order([key_cols[k] for k in key_order])
    payload = {f"k_{n}": np.asarray(c)[order] for n, c in key_cols.items()}
    payload.update({f"v_{n}": np.asarray(c)[order] for n, c in value_cols.items()})
    payload["tombstone"] = np.asarray(tombstone, bool)[order]
    payload["bloom"] = _bloom_build(
        key_hashes([key_cols[k] for k in key_order])[order], len(order)
    )
    meta = SstMeta(
        table_id=table_id,
        epoch=epoch,
        n_rows=int(len(order)),
        key_names=tuple(key_order),
        value_names=tuple(sorted(value_cols)),
    )
    payload["meta"] = np.frombuffer(
        json.dumps(meta.__dict__).encode(), dtype=np.uint8
    )
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    return buf.getvalue()


@dataclass
class Sst:
    meta: SstMeta
    keys: Dict[str, np.ndarray]
    values: Dict[str, np.ndarray]
    tombstone: np.ndarray
    bloom: np.ndarray
    _index: Optional[dict] = None  # lazy hash -> row indices

    def may_contain(self, key_cols: Sequence[np.ndarray]) -> np.ndarray:
        return _bloom_may_contain(self.bloom, key_hashes(key_cols))

    def lookup_rows(
        self, key_cols: Sequence[np.ndarray], mask: np.ndarray
    ) -> np.ndarray:
        """Point lookup (sstable block-index analogue): row index per
        query, -1 if absent. Only queries with ``mask`` are resolved.
        The lazy hash index plays the role of the reference's block
        index + binary search (sstable/block.rs) on columnar rows."""
        lanes = [np.asarray(self.keys[k]) for k in self.meta.key_names]
        if self._index is None:
            idx: dict = {}
            for i, h in enumerate(key_hashes(lanes)):
                idx.setdefault(int(h), []).append(i)
            self._index = idx
        qh = key_hashes(key_cols)
        out = np.full(len(mask), -1, np.int64)
        qlanes = [np.asarray(c) for c in key_cols]
        for i in np.flatnonzero(mask):
            for row in self._index.get(int(qh[i]), ()):
                if all(l[row] == q[i] for l, q in zip(lanes, qlanes)):
                    out[i] = row
                    break
        return out

    def prefix_mask(self, prefix_cols: Dict[str, object]) -> np.ndarray:
        """Vectorized equality mask over a key-lane prefix (range scan
        within the SST; prefix scans are what backfill/temporal joins
        issue, store.rs:298)."""
        ok = np.ones(self.meta.n_rows, bool)
        for name, v in prefix_cols.items():
            ok &= np.asarray(self.keys[name]) == v
        return ok


def read_sst(blob: bytes) -> Sst:
    z = np.load(io.BytesIO(blob))
    meta_d = json.loads(bytes(z["meta"]).decode())
    meta = SstMeta(
        table_id=meta_d["table_id"],
        epoch=meta_d["epoch"],
        n_rows=meta_d["n_rows"],
        key_names=tuple(meta_d["key_names"]),
        value_names=tuple(meta_d["value_names"]),
    )
    keys = {n: z[f"k_{n}"] for n in meta.key_names}
    values = {n: z[f"v_{n}"] for n in meta.value_names}
    return Sst(meta, keys, values, z["tombstone"], z["bloom"])


def merge_ssts(
    ssts: List[Sst], key_order: Sequence[str]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Merge-on-read: newest epoch wins per key; tombstones drop.

    Returns (key_cols, value_cols) of the surviving rows — the analogue
    of a full UserIterator scan at the max committed epoch.
    """
    if not ssts:
        return {}, {}
    ssts = sorted(ssts, key=lambda s: s.meta.epoch)
    key_names = list(key_order)
    value_names = list(ssts[-1].meta.value_names)

    keys = {n: np.concatenate([s.keys[n] for s in ssts]) for n in ssts[-1].keys}

    def _val_lane(s, n):
        # lane-set evolution: a lane absent from an OLDER sst reads as
        # zeros (bool lanes: False). Concretely: a table's NULL
        # companion lanes (materialize vn{j}) appear only once its
        # backend demotes to the nullable python path — rows written
        # before that are by construction non-NULL.
        if n in s.values:
            return s.values[n]
        ref = ssts[-1].values[n]
        return np.zeros(s.meta.n_rows, ref.dtype)

    vals = {
        n: np.concatenate([_val_lane(s, n) for s in ssts])
        for n in value_names
    }
    tomb = np.concatenate([s.tombstone for s in ssts])
    epochs = np.concatenate(
        [np.full(s.meta.n_rows, s.meta.epoch, np.int64) for s in ssts]
    )
    return newest_wins(keys, vals, tomb, epochs, key_names)


def newest_wins(
    keys: Dict[str, np.ndarray],
    vals: Dict[str, np.ndarray],
    tomb: np.ndarray,
    epochs: np.ndarray,
    key_names: Sequence[str],
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Resolve a multi-epoch row soup: keep each key's newest row,
    dropping tombstoned keys (UserIterator semantics)."""
    order = np.lexsort(
        tuple([epochs] + [_order_key(keys[k]) for k in reversed(list(key_names))])
    )
    k_sorted = {n: a[order] for n, a in keys.items()}
    is_last = np.ones(len(order), bool)
    if len(order) > 1:
        same = np.ones(len(order) - 1, bool)
        for n in key_names:
            same &= k_sorted[n][1:] == k_sorted[n][:-1]
        is_last[:-1] = ~same
    keep = is_last & ~tomb[order]
    sel = order[keep]
    return (
        {n: a[sel] for n, a in keys.items()},
        {n: a[sel] for n, a in vals.items()},
    )
