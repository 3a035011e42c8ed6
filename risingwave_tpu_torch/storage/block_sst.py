"""Block-granular SSTs — partial reads, range/backward iteration.

A copy of ``risingwave_tpu/storage/block_sst.py`` with its imports rewritten
(host only: the port imports nothing of the reference); its point read
searches the block bounds and matches the block rows for every query at
once, where the reference loops over the queries.

Reference: src/storage/src/hummock/sstable/builder.rs:95 (block-based
layout: data blocks + block index + bloom, read via ranged object GETs)
and iterator/ (forward/backward block iterators).

Layout (one immutable object):

    magic  b"RWBSST2\\0"                      (8 bytes)
    header_len  uint64 LE                     (8 bytes)
    header JSON                               (header_len bytes)
      {"meta": {table_id, epoch, n_rows, key_names, value_names},
       "blocks": [{"off", "len", "n",
                   "first": [order-key ints], "last": [...]}, ...],
       "bloom": {"off", "len"}}
    block 0 .. block B-1   (each an npz of its row slice)
    bloom bytes

Blocks are sorted by memcomparable key; ``first``/``last`` are the
block's boundary keys in the order-key (unsigned memcomparable) domain,
so readers prune blocks with pure integer tuple comparisons before any
data IO. Point reads touch the header + at most one block per query;
range scans touch only overlapping blocks; backward iteration walks
blocks (and rows) in reverse.
"""

from __future__ import annotations

import io
import json
import struct
from bisect import bisect_left, bisect_right
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.integrity import (
    crc32_bytes,
    raise_corruption,
)
from risingwave_tpu_torch.storage.sstable import (
    Sst,
    SstMeta,
    _bloom_build,
    _bloom_may_contain,
    _order_key,
    key_hashes,
    sort_order,
)

MAGIC = b"RWBSST2\0"
DEFAULT_BLOCK_ROWS = 4096
_BLOCK_CACHE_CAP = 16  # parsed blocks held per reader (LRU)


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def build_block_sst(
    table_id: str,
    epoch: int,
    key_cols: Dict[str, np.ndarray],
    value_cols: Dict[str, np.ndarray],
    tombstone: np.ndarray,
    key_order: Sequence[str],
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> bytes:
    """Serialize rows sorted by key into the block layout above."""
    order = sort_order([key_cols[k] for k in key_order])
    n = len(order)
    keys = {k: np.asarray(key_cols[k])[order] for k in key_cols}
    vals = {v: np.asarray(value_cols[v])[order] for v in value_cols}
    tomb = np.asarray(tombstone, bool)[order]
    okeys = [
        _order_key(keys[k]).astype(np.uint64) for k in key_order
    ]

    blocks_meta: List[dict] = []
    blobs: List[bytes] = []
    for at in range(0, max(n, 1), block_rows):
        hi = min(at + block_rows, n)
        if hi <= at and n > 0:
            break
        sl = slice(at, hi)
        payload = {f"k_{k}": a[sl] for k, a in keys.items()}
        payload.update({f"v_{v}": a[sl] for v, a in vals.items()})
        payload["tombstone"] = tomb[sl]
        blob = _npz_bytes(payload)
        blocks_meta.append(
            {
                "len": len(blob),
                "n": hi - at,
                "first": [int(a[at]) for a in okeys] if n else [],
                "last": [int(a[hi - 1]) for a in okeys] if n else [],
                # content checksum, verified on EVERY block read (the
                # reference's per-block xxhash footer, as crc32 here)
                "crc": crc32_bytes(blob),
            }
        )
        blobs.append(blob)
        if n == 0:
            break

    bloom = _bloom_build(
        key_hashes([keys[k] for k in key_order]), n
    ).tobytes()
    meta = {
        "table_id": table_id,
        "epoch": epoch,
        "n_rows": int(n),
        "key_names": list(key_order),
        "value_names": sorted(value_cols),
        # key-lane dtypes ride the header so readers can build order-
        # key bounds for pruning WITHOUT touching any data block
        "key_dtypes": [str(keys[k].dtype) for k in key_order],
    }

    # two passes: offsets depend on the header length, which depends on
    # the offsets' digits — fix by padding the header to its final size
    def render(header: dict) -> bytes:
        return json.dumps(header).encode()

    header = {"meta": meta, "blocks": blocks_meta, "bloom": {}}
    for _ in range(3):
        hl = len(render(header))
        off = 16 + hl
        for bm, blob in zip(blocks_meta, blobs):
            bm["off"] = off
            off += len(blob)
        header["bloom"] = {"off": off, "len": len(bloom), "crc": crc32_bytes(bloom)}
        if len(render(header)) == hl:
            break
    else:  # pad with spaces (valid JSON whitespace) to stabilize
        hl = len(render(header)) + 16
        raw = render(header)
        raw += b" " * (hl - len(raw))
        off = 16 + hl
        for bm, blob in zip(blocks_meta, blobs):
            bm["off"] = off
            off += len(blob)
        header["bloom"] = {"off": off, "len": len(bloom), "crc": crc32_bytes(bloom)}
        raw2 = render(header)
        assert len(raw2) <= hl
        out = [MAGIC, struct.pack("<Q", hl), raw2 + b" " * (hl - len(raw2))]
        out.extend(blobs)
        out.append(bloom)
        return b"".join(out)
    raw = render(header)
    out = [MAGIC, struct.pack("<Q", len(raw)), raw]
    out.extend(blobs)
    out.append(bloom)
    return b"".join(out)


def is_block_sst(head: bytes) -> bool:
    return head[:8] == MAGIC


def verify_block_blob(blob: bytes) -> List[str]:
    """Audit every checksum a block-SST blob carries (scrub / backup
    deep verification): returns a list of human-readable problems,
    empty when the whole artifact verifies."""
    problems: List[str] = []
    if not is_block_sst(blob[:8]):
        return ["not a block SST (bad magic)"]
    try:
        (hl,) = struct.unpack("<Q", blob[8:16])
        hdr = json.loads(blob[16 : 16 + hl].decode())
    except (struct.error, UnicodeDecodeError, ValueError) as e:
        return [f"torn header: {e}"]
    for i, bm in enumerate(hdr.get("blocks", [])):
        want = bm.get("crc")
        if want is None:
            continue
        got = crc32_bytes(blob[bm["off"] : bm["off"] + bm["len"]])
        if got != want:
            problems.append(
                f"block {i} crc mismatch (expected {want}, got {got})"
            )
    bl = hdr.get("bloom", {})
    want = bl.get("crc")
    if want is not None:
        got = crc32_bytes(blob[bl["off"] : bl["off"] + bl["len"]])
        if got != want:
            problems.append(
                f"bloom crc mismatch (expected {want}, got {got})"
            )
    return problems


def header_crc(blob: bytes) -> int:
    """crc32 of a built block-SST's header bytes. The header itself
    cannot carry its own checksum, so the manifest entry records it
    (``hdr_crc``) and readers verify at open — rooting the per-block
    crc chain in the manifest's own crc envelope."""
    (hl,) = struct.unpack("<Q", blob[8:16])
    return crc32_bytes(blob[16 : 16 + hl])


def order_tuple(values: Sequence[object], dtypes) -> Tuple[int, ...]:
    """One key's order-key tuple (for block pruning comparisons)."""
    return tuple(
        int(_order_key(np.asarray([v], dtype=dt))[0])
        for v, dt in zip(values, dtypes)
    )


def _tuple_less(a: Sequence[np.ndarray], b: Sequence[np.ndarray]) -> np.ndarray:
    """Row-wise ``tuple(a) < tuple(b)`` over equal-length lanes."""
    less = np.zeros(len(a[0]), bool)
    for x, y in zip(reversed(a), reversed(b)):
        less = (x < y) | ((x == y) & less)
    return less


def _count_below(sorted_lanes: Sequence[np.ndarray], q: Sequence[np.ndarray]) -> np.ndarray:
    """For each query tuple, how many of the sorted tuples are below it
    (``bisect_left``), all queries in one sort: a tuple equal to a query
    sorts after it."""
    n = len(sorted_lanes[0])
    kind = np.concatenate([np.ones(n, np.int8), np.zeros(len(q[0]), np.int8)])
    keys = [np.concatenate([s_, q_]) for s_, q_ in zip(sorted_lanes, q)]
    order = np.lexsort([kind] + keys[::-1])
    below = np.cumsum(kind[order]) - kind[order]
    out = np.empty(len(q[0]), np.int64)
    is_q = order >= n
    out[order[is_q] - n] = below[is_q]
    return out


def _canonical(lane: np.ndarray):
    """A lane as uint64 words equal exactly where ``==`` holds (-0.0 as
    0.0), and the rows that equal nothing (NaN)."""
    lane = np.asarray(lane)
    if lane.dtype.kind == "f":
        f = np.where(lane == 0, 0.0, lane).astype(np.float64)
        return f.view(np.uint64), np.isnan(f)
    return lane.astype(np.int64).view(np.uint64), None


def _first_equal(rows: Sequence[np.ndarray], q: Sequence[np.ndarray]) -> np.ndarray:
    """For each query, the first row whose every lane ``==`` the query's,
    or -1."""
    n, m = len(rows[0]), len(q[0])
    words, bad = [], np.zeros(n + m, bool)
    for r_, q_ in zip(rows, q):
        (wr, nr), (wq, nq_) = _canonical(r_), _canonical(q_)
        words.append(np.concatenate([wr, wq]))
        if nr is not None:
            bad |= np.concatenate([nr, nq_])
    kind = np.concatenate([np.zeros(n, np.int8), np.ones(m, np.int8)])
    idx = np.arange(n + m)
    # equal keys run together; within a run the rows come first, in order
    order = np.lexsort([idx, kind] + words[::-1])
    same = np.ones(n + m - 1, bool)
    for w in words:
        ws = w[order]
        same &= ws[1:] == ws[:-1]
    start = np.concatenate([[True], ~same])
    run_first = order[np.maximum.accumulate(np.where(start, idx, 0))]
    out = np.full(m, -1, np.int64)
    is_q = order >= n
    first = run_first[is_q]
    good = (first < n) & ~bad[order[is_q]] & ~bad[np.minimum(first, n + m - 1)]
    out[order[is_q][good] - n] = first[good]
    return out


class BlockSst:
    """Reader over the block layout: header-only open, lazy bloom,
    per-block LRU cache, point/range/backward reads."""

    def __init__(self, store, path: str, expected_hdr_crc: int = None):
        self.store = store
        self.path = path
        head = store.read_range(path, 0, 16)
        if not is_block_sst(head):
            raise ValueError(f"{path} is not a block SST")
        try:
            (hl,) = struct.unpack("<Q", head[8:16])
            raw_hdr = store.read_range(path, 16, hl)
            if (
                expected_hdr_crc is not None
                and crc32_bytes(raw_hdr) != expected_hdr_crc
            ):
                # a WRONG header (vs a torn one, below) is corruption:
                # its offsets/crcs can no longer be trusted to verify
                # anything else, so fail the whole artifact here
                raise_corruption(
                    store, path, "sst-header-crc",
                    expected=expected_hdr_crc,
                    actual=crc32_bytes(raw_hdr),
                )
            hdr = json.loads(raw_hdr.decode())
        except (struct.error, UnicodeDecodeError) as e:
            # a torn/partial header read (flaky ranged GET) must surface
            # in the ValueError domain the storage retry loops classify
            # as a transient decode race — not escape as struct.error
            raise ValueError(f"torn block-SST header at {path}") from e
        m = hdr["meta"]
        self.meta = SstMeta(
            table_id=m["table_id"],
            epoch=m["epoch"],
            n_rows=m["n_rows"],
            key_names=tuple(m["key_names"]),
            value_names=tuple(m["value_names"]),
        )
        self.blocks = hdr["blocks"]
        self.key_dtypes = [
            np.dtype(d) for d in m.get("key_dtypes", [])
        ]
        self._bloom_span = (hdr["bloom"]["off"], hdr["bloom"]["len"])
        self._bloom_crc = hdr["bloom"].get("crc")  # pre-crc files: None
        self._bloom: Optional[np.ndarray] = None
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._firsts = [tuple(b["first"]) for b in self.blocks]
        self._lasts = [tuple(b["last"]) for b in self.blocks]

    # -- pruning ---------------------------------------------------------
    def bloom_bits(self) -> np.ndarray:
        if self._bloom is None:
            off, ln = self._bloom_span
            raw = self.store.read_range(self.path, off, ln)
            want = self._bloom_crc
            if want is not None and crc32_bytes(raw) != want:
                raise_corruption(
                    self.store, self.path, "sst-bloom-crc",
                    expected=want, actual=crc32_bytes(raw),
                )
            self._bloom = np.frombuffer(raw, np.uint8)
        return self._bloom

    def may_contain(self, key_cols: Sequence[np.ndarray]) -> np.ndarray:
        return _bloom_may_contain(self.bloom_bits(), key_hashes(key_cols))

    def key_range(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(first, last) order-key tuples of the whole file."""
        if not self.blocks or self.meta.n_rows == 0:
            return ((), ())
        return self._firsts[0], self._lasts[-1]

    def _load_block(self, i: int) -> dict:
        blk = self._cache.get(i)
        if blk is not None:
            self._cache.move_to_end(i)
            return blk
        bm = self.blocks[i]
        raw = self.store.read_range(self.path, bm["off"], bm["len"])
        want = bm.get("crc")  # pre-crc files carry no block checksum
        if want is not None and crc32_bytes(raw) != want:
            raise_corruption(
                self.store, self.path, "sst-block-crc",
                detail=f"block {i}", expected=want,
                actual=crc32_bytes(raw),
            )
        z = np.load(io.BytesIO(raw))
        blk = {name: z[name] for name in z.files}
        self._cache[i] = blk
        if len(self._cache) > _BLOCK_CACHE_CAP:
            self._cache.popitem(last=False)
        return blk

    # -- point reads -----------------------------------------------------
    def point_read(
        self, key_cols: Sequence[np.ndarray], mask: np.ndarray
    ):
        """Per masked query: (hit, tomb, row values). Touches at most
        one block per query key (the block bounds searched for all the
        queries at once); within a block, a query takes the first row
        whose key lanes equal its own (``==`` of each lane)."""
        nq = len(mask)
        hit = np.zeros(nq, bool)
        tomb = np.zeros(nq, bool)
        vals: Dict[str, np.ndarray] = {}
        qi = np.flatnonzero(mask)
        if self.meta.n_rows == 0 or not len(qi):
            return hit, tomb, vals
        qlanes = [np.asarray(c)[qi] for c in key_cols]
        okq = [_order_key(q).astype(np.uint64) for q in qlanes]
        if not hasattr(self, "_bounds"):
            lanes = lambda ts: [np.array([t[j] for t in ts], np.uint64)
                                for j in range(len(ts[0]))]
            self._bounds = (lanes(self._firsts), lanes(self._lasts))
        firsts, lasts = self._bounds
        # bisect_left on the blocks' last keys: the lasts below each query
        bi = _count_below(lasts, okq)
        ok = bi < len(self.blocks)
        at = np.minimum(bi, len(self.blocks) - 1)
        ok &= ~_tuple_less(okq, [f[at] for f in firsts])
        for b in np.unique(bi[ok]):
            sel = np.flatnonzero(ok & (bi == b))
            blk = self._load_block(int(b))
            rows = _first_equal(
                [blk[f"k_{name}"] for name in self.meta.key_names],
                [q[sel] for q in qlanes],
            )
            found = rows >= 0
            if not found.any():
                continue
            dst, r = qi[sel[found]], rows[found]
            hit[dst] = True
            tomb[dst] = blk["tombstone"][r]
            for vn in self.meta.value_names:
                col = blk[f"v_{vn}"]
                if vn not in vals:
                    vals[vn] = np.zeros((nq,) + col.shape[1:], col.dtype)
                vals[vn][dst] = col[r]
        return hit, tomb, vals

    # -- range scans -----------------------------------------------------
    def scan_blocks(
        self,
        lo: Optional[Tuple[int, ...]] = None,
        hi: Optional[Tuple[int, ...]] = None,
        reverse: bool = False,
    ) -> Iterator[dict]:
        """Yield parsed blocks overlapping [lo, hi] (order-key tuple
        prefixes, inclusive), in key order (reverse = backward). A
        bound shorter than the key width compares as a prefix."""
        if self.meta.n_rows == 0:
            return
        b0, b1 = 0, len(self.blocks) - 1
        if lo is not None:
            # first block whose last >= lo
            b0 = bisect_left([t[: len(lo)] for t in self._lasts], lo)
        if hi is not None:
            b1 = (
                bisect_right([t[: len(hi)] for t in self._firsts], hi)
                - 1
            )
        rng = range(b0, b1 + 1)
        for i in reversed(rng) if reverse else rng:
            if 0 <= i < len(self.blocks):
                yield self._load_block(i)

    def materialize(self) -> Sst:
        """Full load (recovery path): equivalent classic Sst."""
        ks = {k: [] for k in self.meta.key_names}
        vs = {v: [] for v in self.meta.value_names}
        ts = []
        for blk in self.scan_blocks():
            for k in self.meta.key_names:
                ks[k].append(blk[f"k_{k}"])
            for v in self.meta.value_names:
                vs[v].append(blk[f"v_{v}"])
            ts.append(blk["tombstone"])
        cat = lambda xs: (
            np.concatenate(xs) if xs else np.zeros(0)
        )
        return Sst(
            self.meta,
            {k: cat(x) for k, x in ks.items()},
            {v: cat(x) for v, x in vs.items()},
            cat(ts) if ts else np.zeros(0, bool),
            self.bloom_bits(),
        )
