"""The port's storage layer (``risingwave_tpu_torch/storage``, the
checkpoint half of ``integrity.py``): mirrors of
``tests/test_checkpoint.py``'s SST, merge, local-store and compaction
cases and of ``tests/test_integrity.py``'s corruption, quarantine and
walk-back cases, run on the port, and cross-reading tests: an SST, a
manifest and a whole store written by one package read back equal in
the other.

Every comparison is exact (row images, digests and manifests are
compared bit for bit).
"""

import json

import numpy as np
import pytest

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.storage import CheckpointManager as RefManager
from risingwave_tpu.storage import MemObjectStore as RefMemStore
from risingwave_tpu.storage import StateDelta as RefDelta
from risingwave_tpu.storage.sstable import build_sst as ref_build_sst
from risingwave_tpu.storage.sstable import read_sst as ref_read_sst
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.event_log import EVENT_LOG
from risingwave_tpu_torch.integrity import (
    QUARANTINE_PREFIX,
    StateCorruption,
    decode_manifest,
    encode_manifest,
)
from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite
from risingwave_tpu_torch.storage import (
    Checkpointable,
    CheckpointManager,
    LocalFsObjectStore,
    MemObjectStore,
    StateDelta,
)
from risingwave_tpu_torch.storage.block_sst import BlockSst, build_block_sst
from risingwave_tpu_torch.storage.sstable import build_sst, merge_ssts, read_sst


# -- mirrors of tests/test_checkpoint.py:18-78 ---------------------------------
def test_sst_round_trip():
    keys = {"k0": np.array([3, 1, 2], np.int64)}
    vals = {"v": np.array([30, 10, 20], np.int64)}
    blob = build_sst("t", 7, keys, vals, np.array([False, True, False]), ("k0",))
    sst = read_sst(blob)
    assert sst.meta.table_id == "t" and sst.meta.epoch == 7
    assert sst.keys["k0"].tolist() == [1, 2, 3]
    assert sst.values["v"].tolist() == [10, 20, 30]
    assert sst.tombstone.tolist() == [True, False, False]
    assert sst.may_contain([np.array([1, 2, 3], np.int64)]).all()


def test_sst_negative_keys_sort_correctly():
    keys = {"k0": np.array([5, -3, 0, -7], np.int64)}
    vals = {"v": np.arange(4)}
    sst = read_sst(build_sst("t", 1, keys, vals, np.zeros(4, bool), ("k0",)))
    assert sst.keys["k0"].tolist() == [-7, -3, 0, 5]


def test_merge_newest_wins_and_tombstones():
    mk = lambda ep, ks, vs, tomb: read_sst(build_sst(
        "t", ep, {"k0": np.asarray(ks, np.int64)}, {"v": np.asarray(vs, np.int64)},
        np.asarray(tomb, bool), ("k0",),
    ))
    s1 = mk(1, [1, 2, 3], [10, 20, 30], [False] * 3)
    s2 = mk(2, [2, 4], [21, 40], [False, False])
    s3 = mk(3, [3, 1], [0, 11], [True, False])  # delete 3, update 1
    keys, vals = merge_ssts([s3, s1, s2], ("k0",))
    assert dict(zip(keys["k0"].tolist(), vals["v"].tolist())) == {1: 11, 2: 21, 4: 40}


def test_local_fs_object_store(tmp_path):
    store = LocalFsObjectStore(str(tmp_path))
    store.put("a/b/c.sst", b"hello")
    assert store.read("a/b/c.sst") == b"hello"
    assert store.list("a/") == ["a/b/c.sst"]
    store.put("a/b/c.sst", b"world")  # overwrite is atomic
    assert store.read("a/b/c.sst") == b"world"
    store.delete("a/b/c.sst")
    assert not store.exists("a/b/c.sst")
    with pytest.raises(ValueError):
        store.put("../escape", b"x")


def test_compaction_bounds_sst_count():
    """Mirror of ``test_checkpoint.py:154``: ten q5 commits stay within
    the leveled compaction's bound, and recovery after compaction is
    exact."""
    store = MemObjectStore()
    mgr = CheckpointManager(store)
    gen = NexmarkGenerator(NexmarkConfig())
    q5 = build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
    for _ in range(10):
        bid = gen.next_chunks(800, 2048, device="cpu")["bid"]
        q5.pipeline.push(bid.select(["auction", "date_time"]))
        q5.pipeline.barrier()
        mgr.commit_epoch(q5.pipeline.epoch, q5.pipeline.executors)
    for table_id, entries in mgr.version["tables"].items():
        assert len(entries) <= 8, table_id
    assert any(e.get("level") == 1 for es in mgr.version["tables"].values() for e in es)
    q5b = build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
    CheckpointManager(store).recover(q5b.pipeline.executors)
    assert q5b.mview.snapshot() == q5.mview.snapshot()


# -- mirrors of tests/test_integrity.py:139-263 --------------------------------
def _delta(ep, tid="t.x", n=5, cls=StateDelta):
    return cls(tid, {"k": np.arange(n, dtype=np.int64)}, {"v": np.arange(n, dtype=np.int64) * ep},
               np.zeros(n, bool), ("k",))


def _commit_fixture(store, epochs=(1,), tid="t.x", mgr_cls=CheckpointManager, cls=StateDelta):
    mgr = mgr_cls(store)
    for ep in epochs:
        mgr.commit_staged(ep << 16, [_delta(ep, tid, cls=cls)])
    return mgr


def test_corrupt_sst_read_quarantines_and_raises():
    store = MemObjectStore()
    _commit_fixture(store)
    (sst,) = store.list("hummock/sst/")
    blob = bytearray(store.read(sst))
    blob[len(blob) // 2] ^= 0x04
    store.put(sst, bytes(blob))
    n0 = integrity.corruption_count()
    with pytest.raises(StateCorruption) as ei:
        CheckpointManager(store).read_table("t.x")
    assert ei.value.artifact == sst
    assert integrity.corruption_count() > n0
    assert store.read(sst) == bytes(blob)  # the evidence stays in place
    qpath = f"{QUARANTINE_PREFIX}/{sst}"
    assert store.exists(qpath) and store.read(qpath) == bytes(blob)


def test_manifest_envelope_roundtrip_and_faults():
    version = {"max_committed_epoch": 3 << 16, "tables": {"t": []}}
    raw = encode_manifest(version)
    assert decode_manifest(raw) == version
    with pytest.raises(StateCorruption) as ei:
        decode_manifest(raw[: len(raw) // 2])
    assert ei.value.kind == "torn-manifest"
    doc = raw.replace(b'"max_committed_epoch": ' + b"196608", b'"max_committed_epoch": 196609')
    assert doc != raw
    with pytest.raises(StateCorruption) as ei:
        decode_manifest(doc)
    assert ei.value.kind == "manifest-crc"
    with pytest.raises(StateCorruption) as ei:
        decode_manifest(raw.replace(b'"format": 2', b'"format": 3'))
    assert ei.value.kind == "manifest-format"
    legacy = json.dumps(version).encode()
    assert decode_manifest(legacy) == version


def test_torn_manifest_write_walks_back_one_epoch():
    store = MemObjectStore()
    mgr = _commit_fixture(store, epochs=(1, 2))
    raw = store.read(mgr._manifest_path())
    store.put(mgr._manifest_path(), raw[: len(raw) - 7])
    store.delete(mgr._history_path(2 << 16))
    m2 = CheckpointManager(store)
    assert m2.max_committed_epoch == 1 << 16
    _k, v = m2.read_table("t.x")
    np.testing.assert_array_equal(np.sort(np.asarray(v["v"])), np.arange(5, dtype=np.int64))
    assert CheckpointManager(store).max_committed_epoch == 1 << 16  # the pointer healed


def test_corrupted_newest_checkpoint_verified_recovery(monkeypatch):
    monkeypatch.setenv("RW_STATE_DIGEST", "1")
    tw = CheckpointManager(MemObjectStore())
    for ep in (1, 2, 3):
        tw.commit_staged(ep << 16, [_delta(ep)])
    want_k, want_v = tw.read_table("t.x")

    store = MemObjectStore()
    _commit_fixture(store, epochs=(1, 2, 3))
    newest = max(store.list("hummock/sst/"))
    blob = bytearray(store.read(newest))
    blob[len(blob) // 2] ^= 0x10
    store.put(newest, bytes(blob))

    class _Sink(Checkpointable):
        table_id = "t.x"
        image = None

        def restore_state(self, table_id, keys, values):
            self.image = (keys, values)

    sink = _Sink()
    m2 = CheckpointManager(store)
    m2.recover([sink])
    assert m2.max_committed_epoch >> 16 == 2
    np.testing.assert_array_equal(np.sort(np.asarray(sink.image[1]["v"])),
                                  np.arange(5, dtype=np.int64) * 2)
    named = [e for e in EVENT_LOG.events(kind="state_corruption") if e.get("artifact") == newest]
    assert named and named[-1]["quarantined"] == f"{QUARANTINE_PREFIX}/{newest}"
    m2.commit_staged(3 << 16, [_delta(3)])
    got_k, got_v = m2.read_table("t.x")
    ow, og = np.argsort(np.asarray(want_k["k"])), np.argsort(np.asarray(got_k["k"]))
    np.testing.assert_array_equal(np.asarray(got_k["k"])[og], np.asarray(want_k["k"])[ow])
    np.testing.assert_array_equal(np.asarray(got_v["v"])[og], np.asarray(want_v["v"])[ow])


def test_scrub_reports_and_quarantines_a_corrupt_entry():
    store = MemObjectStore()
    _commit_fixture(store, epochs=(1, 2))
    newest = max(store.list("hummock/sst/"))
    blob = bytearray(store.read(newest))
    blob[len(blob) // 3] ^= 0x20
    store.put(newest, bytes(blob))
    rows = {r["artifact"]: r["status"] for r in CheckpointManager(store).scrub()}
    assert rows[newest] == "corrupt"
    assert rows["hummock/MANIFEST"] == "ok"
    assert store.exists(f"{QUARANTINE_PREFIX}/{newest}")


# -- cross-reading: each package reads what the other wrote -------------------
def _rows():
    rng = np.random.default_rng(7)
    n = 200
    keys = {"k0": rng.integers(-1000, 1000, n).astype(np.int64),
            "k1": rng.integers(0, 5, n).astype(np.int32)}
    vals = {"v": rng.normal(size=n), "u": rng.integers(0, 2**32, n).astype(np.uint32),
            "b": rng.random(n) < 0.5, "rv": rng.random((n, 4)) < 0.5,
            "deg": rng.integers(0, 9, (n, 4)).astype(np.int32)}
    return keys, vals, rng.random(n) < 0.1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sst_cross_read(writer):
    """An SST built by one package reads back equal in the other: keys,
    values (2-D lanes included), tombstones and dtypes, bit for bit."""
    keys, vals, tomb = _rows()
    build = build_sst if writer == "port" else ref_build_sst
    read = ref_read_sst if writer == "port" else read_sst
    a = read_sst(build("t", 5, keys, vals, tomb, ("k0", "k1")))
    b = read(build("t", 5, keys, vals, tomb, ("k0", "k1")))
    for part in ("keys", "values"):
        for k, x in getattr(a, part).items():
            y = getattr(b, part)[k]
            assert x.dtype == y.dtype and np.array_equal(x, y), (part, k)
    assert np.array_equal(a.tombstone, b.tombstone)


def test_block_sst_matches_reference_bytes():
    """A leveled (block-format) SST is the reference's byte for byte."""
    from risingwave_tpu.storage.block_sst import build_block_sst as ref_build

    keys, vals, _ = _rows()
    order = np.lexsort((keys["k1"], keys["k0"]))
    keys = {k: a[order] for k, a in keys.items()}
    vals = {k: a[order] for k, a in vals.items()}
    tomb = np.zeros(len(order), bool)
    blob = build_block_sst("t", 9, keys, vals, tomb, ("k0", "k1"))
    assert blob == ref_build("t", 9, keys, vals, tomb, ("k0", "k1"))
    store = MemObjectStore()
    store.put("x.sst", blob)
    got = BlockSst(store, "x.sst").materialize()
    for k, a in vals.items():
        assert np.array_equal(got.values[k], a)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manifest_cross_decode(writer):
    version = {"max_committed_epoch": 7 << 16, "tables": {"t": [{"path": "p", "epoch": 1}]},
               "digests": {"t": 12345}}
    enc = encode_manifest if writer == "port" else ref_integrity.encode_manifest
    dec = ref_integrity.decode_manifest if writer == "port" else decode_manifest
    raw = enc(version)
    assert raw == (ref_integrity.encode_manifest if writer == "port" else encode_manifest)(version)
    assert dec(raw) == version


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_cross_read(writer, monkeypatch):
    """A store committed by one package's manager (with table digests)
    reads back in the other's: the same row image, the same digest."""
    monkeypatch.setenv("RW_STATE_DIGEST", "1")
    store = MemObjectStore() if writer == "port" else RefMemStore()
    mgr_cls, other = ((CheckpointManager, RefManager) if writer == "port"
                      else (RefManager, CheckpointManager))
    cls = StateDelta if writer == "port" else RefDelta
    keys, vals, tomb = _rows()
    mgr = mgr_cls(store)
    for ep in range(1, 11):  # past COMPACT_AT: the read merges L1 and L0 files
        sub = slice((ep - 1) * 20, ep * 20)
        mgr.commit_staged(ep << 16, [cls("t", {k: a[sub] for k, a in keys.items()},
                                         {k: a[sub] for k, a in vals.items()}, tomb[sub],
                                         ("k0", "k1"))])
        mgr._maybe_compact(ep << 16)
    assert any(e.get("level") == 1 for e in mgr.version["tables"]["t"])
    want = mgr.read_table("t")
    got = other(store).read_table("t")
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k
    assert integrity.host_rows_digest(*got) == ref_integrity.host_rows_digest(*want)
    assert other(store).version["digests"]["t"] == integrity.host_rows_digest(*got)

