"""Kernels U, V, W and X and the TopN executors: the port's plain
PyTorch versions (``executors/top_n.py``, ``executors/top_n_plain.py``,
``ops/agg.topn_order_key``) against ``risingwave_tpu`` on JAX-CPU, on
the same seeded inputs, and the reference's own TopN tests
(``tests/test_top_n.py``, the TopN cases of
``tests/test_simple_agg_topn.py``) run on the port.

On the CPU the port's hash table places keys in the reference's slots,
so bands, row lanes, marks and masks compare slot for slot; emissions
compare exactly (the append-only step) or as a multiset per chunk with
the chunks' ops and capacities equal (the host diffs, whose row order
is the reference's dict order); digests and checkpoint deltas exactly.
Tolerance: none.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import top_n as rtn
from risingwave_tpu.executors import top_n_plain as rtp
from risingwave_tpu.executors.base import Barrier, Epoch
from risingwave_tpu.executors.base import Watermark as RefWatermark
from risingwave_tpu.ops import hash_table as rht
from risingwave_tpu.types import Op
from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import top_n as ptn
from risingwave_tpu_torch.executors import over_window as ow
from risingwave_tpu_torch.executors import top_n_plain as ptp
from risingwave_tpu_torch.executors.base import Watermark
from risingwave_tpu_torch.ops import hash_table as pht
from risingwave_tpu_torch.ops.agg import topn_order_key

I64, I32 = jnp.int64, jnp.int32
IMAX, IMIN = np.iinfo(np.int64).max, np.iinfo(np.int64).min


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(cols, cap, ops=None):
    ops = None if ops is None else np.asarray(ops, np.int32)
    return (RefChunk.from_numpy(cols, cap, ops=ops),
            StreamChunk.from_numpy(cols, cap, ops=ops, device="cpu"))


def _eq(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _multiset(outs) -> collections.Counter:
    c = collections.Counter()
    for o in outs:
        d = o.to_numpy(with_ops=True)
        names = sorted(k for k in d if k != "__op__")
        for i in range(len(d["__op__"])):
            c[(int(d["__op__"][i]),) + tuple(d[n][i].item() for n in names)] += 1
    return c


def _same_emission(ref_outs, port_outs) -> None:
    """One DELETE chunk then one INSERT chunk, each of the reference's
    capacity and equal to it as a multiset."""
    assert [o.capacity for o in port_outs] == [o.capacity for o in ref_outs]
    for r, p in zip(ref_outs, port_outs):
        assert _multiset([p]) == _multiset([r])
        assert set(p.to_numpy()["__op__"].tolist()) == set(r.to_numpy()["__op__"].tolist())


def _same_deltas(ref_deltas, port_deltas) -> None:
    assert len(port_deltas) == len(ref_deltas)
    for r, p in zip(ref_deltas, port_deltas):
        assert (p.table_id, p.key_order) == (r.table_id, r.key_order)
        assert p.key_cols.keys() == r.key_cols.keys() and p.value_cols.keys() == r.value_cols.keys()
        for k in r.key_cols:
            np.testing.assert_array_equal(p.key_cols[k], np.asarray(r.key_cols[k]))
        for k in r.value_cols:
            np.testing.assert_array_equal(p.value_cols[k], np.asarray(r.value_cols[k]))
        np.testing.assert_array_equal(p.tombstone, np.asarray(r.tombstone))


# -- the order key ---------------------------------------------------------------
_FLOATS = [-np.inf, -1e30, -1.5, -0.0, 0.0, 1e-30, 2.5, 1e30, np.inf, np.nan, -np.nan]
_INTS = [IMIN, IMIN + 1, -5, -1, 0, 1, 7, IMAX - 1, IMAX]


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32", "bool"])
def test_order_key_is_the_references_unsigned_key(dtype, desc):
    """Flipping bit 63 of the port's int64 key gives the reference's
    uint64 key bit for bit, so signed order is the reference's unsigned
    order: negative floats, signed zeros and NaN (one key, above
    everything), INT64_MIN/MAX, both directions. Normal floats only: XLA
    on the CPU flushes subnormals, PyTorch keeps them."""
    vals = {"float64": np.asarray(_FLOATS, np.float64),
            "float32": np.asarray(_FLOATS, np.float32),
            "int64": np.asarray(_INTS, np.int64),
            "int32": np.asarray([-2**31, -3, 0, 5, 2**31 - 1], np.int32),
            "bool": np.asarray([True, False, True])}[dtype]
    want = np.asarray(rtp._order_key_u64(jnp.asarray(vals), desc)).astype(np.uint64)
    got = topn_order_key(torch.from_numpy(vals), desc).numpy()
    np.testing.assert_array_equal(got.view(np.uint64) ^ np.uint64(1 << 63), want)
    np.testing.assert_array_equal(np.argsort(got, kind="stable"), np.argsort(want, kind="stable"))


# -- kernel U and the append-only GroupTopN ------------------------------------------
DT_R = {"g": I64, "v": I64, "p": I32}
DT_P = {"g": torch.int64, "v": torch.int64, "p": torch.int32}


def _band_stream(rng, steps, n_max=60, groups=40, vmax=50):
    for _ in range(steps):
        n = int(rng.integers(5, n_max))
        yield {"g": rng.integers(0, groups, n).astype(np.int64),
               "v": rng.integers(-vmax, vmax, n).astype(np.int64),
               "p": rng.integers(0, 1000, n).astype(np.int32)}


def _group_topn_pair(k, desc, cap=64, out_cap=128, **kw):
    return (rtn.GroupTopNExecutor(("g",), "v", k, DT_R, payload=("p",), desc=desc, capacity=cap,
                                  out_cap=out_cap, **kw),
            ptn.GroupTopNExecutor(("g",), "v", k, DT_P, payload=("p",), desc=desc, capacity=cap,
                                  out_cap=out_cap, device="cpu", **kw))


def _same_bands(r, p) -> None:
    assert p.table.capacity == r.table.capacity
    _eq(p.table.fp1.view(torch.int32), np.asarray(r.table.fp1).view(np.int32))
    _eq(p.table.keys[0], r.table.keys[0])
    _eq(p.table.live, r.table.live)
    assert p.state.keys() == r.state.keys()
    for name in r.state:
        _eq(p.state[name], r.state[name])


@pytest.mark.parametrize("k,desc", [(1, True), (3, True), (3, False), (10, True)])
def test_band_step_matches_reference(k, desc):
    """U's plain version through the executor, chunk by chunk from a
    64-slot table that grows (``_topn_rebuild``): the emission chunk
    lane for lane (DELETEs first, by leader row and band position, then
    INSERTs by row), every band lane (stale entries included), live,
    sdirty and the digest."""
    rng = np.random.default_rng(k * 10 + desc)
    r, p = _group_topn_pair(k, desc)
    for cols in _band_stream(rng, 14):
        rc, pc = _pair(cols, 64)
        (ro,), (po,) = r.apply(rc), p.apply(pc)
        _eq(po.valid, ro.valid)
        _eq(po.ops, ro.ops)
        assert po.columns.keys() == ro.columns.keys()
        for c in ro.columns:
            _eq(po.columns[c], ro.columns[c])
        _same_bands(r, p)
        r.on_barrier(Barrier(Epoch(0, 1)))
        p.on_barrier(None)
        assert p.state_digest() == r.state_digest()
    assert p.table.capacity > 64


def test_band_step_latches_match_reference():
    """A DELETE latches saw_delete, a full table dropped, a chunk
    emitting past out_cap overflow: each raises at the barrier, as the
    reference's."""
    for make, cols, ops, msg in [
        (dict(cap=64), {"g": [1, 2], "v": [3, 4], "p": [0, 0]}, [0, 1], "DELETE"),
        (dict(cap=64, out_cap=4), {"g": list(range(8)), "v": [1] * 8, "p": [0] * 8}, None,
         "out_cap"),
    ]:
        r, p = _group_topn_pair(2, True, **make)
        c = {k: np.asarray(v, np.int32 if k == "p" else np.int64) for k, v in cols.items()}
        rc, pc = _pair(c, 16, ops)
        r.apply(rc)
        p.apply(pc)
        with pytest.raises(RuntimeError, match=msg):
            r.on_barrier(Barrier(Epoch(0, 1)))
        with pytest.raises(RuntimeError, match=msg):
            p.on_barrier(None)


def test_topn_rebuild_matches_reference():
    rng = np.random.default_rng(4)
    r, p = _group_topn_pair(4, True, cap=256)
    for cols in _band_stream(rng, 3):
        rc, pc = _pair(cols, 64)
        r.apply(rc)
        p.apply(pc)
    for new_cap in (512, 256):
        rt, rs = rtn._topn_rebuild(r.table, r.state, new_cap)
        pt, ps = ptn.topn_rebuild(p.table, p.state, new_cap)
        _eq(pt.live, rt.live)
        _eq(pt.keys[0], rt.keys[0])
        for name in rs:
            _eq(ps[name], rs[name])


def test_group_topn_window_watermark_matches_reference():
    """``window_key``: a watermark expires the groups below it (dead,
    sdirty, bands cleared), slot for slot as the reference; later rows
    of a closed window start a fresh band."""
    rng = np.random.default_rng(6)
    r, p = _group_topn_pair(3, True, cap=128, window_key=("g", 5))
    for i, cols in enumerate(_band_stream(rng, 6)):
        rc, pc = _pair(cols, 64)
        (ro,), (po,) = r.apply(rc), p.apply(pc)
        for c in ro.columns:
            _eq(po.columns[c], ro.columns[c])
        r.on_watermark(RefWatermark("g", 10 + 4 * i))
        p.on_watermark(Watermark("g", 10 + 4 * i))
        _same_bands(r, p)
        _eq(p.state["sdirty"], r.state["sdirty"])
        assert p.state_digest() == r.state_digest()


def test_group_topn_checkpoint_delta_and_restore_match_reference():
    """Each barrier's delta (the changed groups' whole bands as 2-D rows,
    tombstones of expired groups) equals the reference's; a restore from
    the store equals the reference's restore slot for slot."""
    from risingwave_tpu.storage import CheckpointManager as RefManager
    from risingwave_tpu.storage import MemObjectStore as RefStore
    from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore

    rng = np.random.default_rng(8)
    r, p = _group_topn_pair(3, True, cap=128, window_key=("g", 5), table_id="gtn")
    rm, pm = RefManager(RefStore()), CheckpointManager(MemObjectStore())
    for i, cols in enumerate(_band_stream(rng, 5)):
        rc, pc = _pair(cols, 64)
        r.apply(rc)
        p.apply(pc)
        if i == 2:
            r.on_watermark(RefWatermark("g", 15))
            p.on_watermark(Watermark("g", 15))
        rd, pd = r.checkpoint_delta(), p.checkpoint_delta()
        _same_deltas(rd, pd)
        rm.commit_staged(i + 1, rd)
        pm.commit_staged(i + 1, pd)
    r2, p2 = _group_topn_pair(3, True, cap=128, window_key=("g", 5), table_id="gtn")
    rm.recover([r2])
    pm.recover([p2])
    _same_bands(r2, p2)
    assert p2.state_digest() == r2.state_digest() == r.state_digest()


# the reference's own GroupTopN tests (tests/test_top_n.py), on the port
def _replay(outs, snap, names=("g", "v", "p")):
    for out in outs:
        d = out.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            row = tuple(int(d[n][i]) for n in names)
            snap[row] = snap.get(row, 0) + (1 if d["__op__"][i] == Op.INSERT else -1)
            if snap[row] == 0:
                del snap[row]
    return snap


def _chunk(g, v, p, cap=64):
    cols = {"g": np.asarray(g, np.int64), "v": np.asarray(v, np.int64),
            "p": np.asarray(p, np.int64)}
    return StreamChunk.from_numpy(cols, cap, device="cpu")


def _topk_oracle(rows, k, desc=True):
    groups = collections.defaultdict(list)
    for i, (g, v, p) in enumerate(rows):
        groups[g].append((v, i, p))
    want = {}
    for g, items in groups.items():
        items.sort(key=lambda t: (-t[0], t[1]) if desc else (t[0], t[1]))
        for v, _, p in items[:k]:
            want[(g, v, p)] = want.get((g, v, p), 0) + 1
    return want


DT64 = {"g": torch.int64, "v": torch.int64, "p": torch.int64}


def test_topn_basic_and_eviction():
    ex = ptn.GroupTopNExecutor(("g",), "v", k=2, schema_dtypes=DT64, payload=("p",), desc=True,
                               capacity=1 << 8, out_cap=1 << 8, device="cpu")
    snap = {}
    _replay(ex.apply(_chunk([1, 1, 1], [10, 30, 20], [100, 101, 102])), snap)
    ex.on_barrier(None)
    assert snap == {(1, 30, 101): 1, (1, 20, 102): 1}
    _replay(ex.apply(_chunk([1], [25], [103])), snap)
    assert snap == {(1, 30, 101): 1, (1, 25, 103): 1}
    _replay(ex.apply(_chunk([1], [5], [104])), snap)
    assert snap == {(1, 30, 101): 1, (1, 25, 103): 1}


@pytest.mark.parametrize("desc,k,cap", [(True, 4, 1 << 6), (False, 3, 1 << 8)],
                         ids=["desc_regrow", "asc"])
def test_topn_random_vs_oracle(desc, k, cap):
    rng = np.random.default_rng(11 + k)
    ex = ptn.GroupTopNExecutor(("g",), "v", k=k, schema_dtypes=DT64, payload=("p",), desc=desc,
                               capacity=cap, out_cap=1 << 10, device="cpu")
    snap, rows = {}, []
    for _ in range(12):
        n = int(rng.integers(5, 60))
        g = rng.integers(0, 30, n)
        v = rng.integers(-5000, 10_000, n)
        p = rng.integers(0, 1000, n)
        rows += list(zip(g.tolist(), v.tolist(), p.tolist()))
        _replay(ex.apply(_chunk(g, v, p)), snap)
        ex.on_barrier(None)
    assert snap == _topk_oracle(rows, k, desc) and len(snap) > 50


def test_topn_checkpoint_recovery():
    from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore

    rng = np.random.default_rng(12)
    store = MemObjectStore()
    mgr = CheckpointManager(store)
    mk = lambda: ptn.GroupTopNExecutor(("g",), "v", k=3, schema_dtypes=DT64, payload=("p",),
                                       capacity=1 << 8, out_cap=1 << 10, table_id="topn",
                                       device="cpu")
    ex = mk()
    for epoch in range(4):
        ex.apply(_chunk(rng.integers(0, 20, 50), rng.integers(0, 100_000, 50),
                        rng.integers(0, 100, 50)))
        ex.on_barrier(None)
        mgr.commit_epoch(epoch + 1, [ex])
    ex2 = mk()
    CheckpointManager(store).recover([ex2])
    g, v, p = rng.integers(0, 20, 30), rng.integers(0, 100_000, 30), rng.integers(0, 100, 30)
    assert _replay(ex.apply(_chunk(g, v, p)), {}) == _replay(ex2.apply(_chunk(g, v, p)), {})
    order = lambda e: np.sort(e.state["order"][e.table.live].numpy(), axis=None)
    np.testing.assert_array_equal(order(ex), order(ex2))


# -- kernels V, W, X and the retractable executors ----------------------------------
DTR = {"g": I64, "id": I64, "v": I64}
DTP = {"g": torch.int64, "id": torch.int64, "v": torch.int64}


def _retract_stream(rng, epochs, groups=5, vmax=30, floats=False):
    """Per epoch a chunk of inserts, deletes and U-/U+ updates over a
    live relation (id -> (g, v))."""
    live, nid = {}, 0
    for _ in range(epochs):
        ops, gs, ids, vs = [], [], [], []
        for _ in range(int(rng.integers(3, 25))):
            if live and rng.random() < 0.4:
                id_ = int(rng.choice(sorted(live)))
                g, v = live[id_]
                if rng.random() < 0.5:
                    ops.append(int(Op.DELETE))
                    gs.append(g), ids.append(id_), vs.append(v)
                    del live[id_]
                else:
                    nv = int(rng.integers(0, vmax))
                    ops += [int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)]
                    gs += [g, g]
                    ids += [id_, id_]
                    vs += [v, nv]
                    live[id_] = (g, nv)
            else:
                g, v = int(rng.integers(0, groups)), int(rng.integers(0, vmax))
                ops.append(int(Op.INSERT))
                gs.append(g), ids.append(nid), vs.append(v)
                live[nid] = (g, v)
                nid += 1
        cols = {"g": np.asarray(gs, np.int64), "id": np.asarray(ids, np.int64),
                "v": np.asarray(vs, np.float64 if floats else np.int64)}
        yield cols, np.asarray(ops, np.int32), dict(live)


def _stores(kind, desc, cap=32, **kw):
    if kind == "plain":
        return (rtp.TopNExecutor("v", 5, ("id",), DTR, desc=desc, capacity=cap, table_id="t", **kw),
                ptp.TopNExecutor("v", 5, ("id",), DTP, desc=desc, capacity=cap, table_id="t",
                                 device="cpu", **kw))
    return (rtp.RetractableGroupTopNExecutor(("g",), "v", 3, ("id",), DTR, desc=desc,
                                             capacity=cap, table_id="t", **kw),
            ptp.RetractableGroupTopNExecutor(("g",), "v", 3, ("id",), DTP, desc=desc,
                                             capacity=cap, table_id="t", device="cpu", **kw))


def _same_store(r, p) -> None:
    assert p.table.capacity == r.table.capacity
    for a, b in zip(p.table.keys, r.table.keys):
        _eq(a, b)
    _eq(p.table.live, r.table.live)
    for n in r.rows:
        _eq(p.rows[n], r.rows[n])
    _eq(p.sdirty, r.sdirty)
    _eq(p.stored, r.stored)


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("kind", ["plain", "group"])
def test_retractable_topn_matches_reference(kind, desc):
    """Chunk after chunk of inserts, deletes and U-/U+ updates into a
    32-slot store that grows: every row lane, live and the marks slot for
    slot (kernel V's last-row rule), the barrier's DELETE and INSERT
    chunks as multisets with the reference's capacities (W or X, then
    the diff), digests and checkpoint deltas (tombstones with their
    lanes)."""
    rng = np.random.default_rng(21 + desc)
    r, p = _stores(kind, desc)
    for e, (cols, ops, _) in enumerate(_retract_stream(rng, 15)):
        rc, pc = _pair(cols, 64, ops)
        assert r.apply(rc) == [] and p.apply(pc) == []
        if kind == "group":
            _eq(p.epoch_dirty, r.epoch_dirty)
        _same_store(r, p)
        _same_emission(r.on_barrier(None), p.on_barrier(None))
        assert p.state_digest() == r.state_digest()
        if e % 3 == 2:
            _same_deltas(r.checkpoint_delta(), p.checkpoint_delta())
    assert p.table.capacity > 32


def _upsert_runs(with_ed, ids_range, steps=5, cap=64, seed=31):
    """Kernel V's plain version and the reference's step over the same
    chunks (duplicates of one pk in a chunk, every op): yields after
    each chunk (reference lanes, port lanes, reference dropped, port
    dropped)."""
    rng = np.random.default_rng(seed)
    names = ("g", "id", "v")
    rt = rht.HashTable.create(cap, (I64,))
    rrows = {n: jnp.zeros(cap, I64) for n in names}
    rsd, red = jnp.zeros(cap, bool), jnp.zeros(cap, bool)
    pt = pht.HashTable.create(cap, (torch.int64,), device="cpu")
    prows = {n: torch.zeros(cap, dtype=torch.int64) for n in names}
    psd, ped = torch.zeros(cap, dtype=torch.bool), torch.zeros(cap, dtype=torch.bool)
    dropped, r_drop = torch.zeros((), dtype=torch.bool), False
    scratch = ptp.last_scratch(cap, "cpu")
    for _ in range(steps):
        n = 40
        cols = {"g": rng.integers(0, 4, n), "id": rng.integers(0, ids_range, n),
                "v": rng.integers(-9, 9, n)}
        rc, pc = _pair(cols, 48, rng.integers(0, 4, n))
        if with_ed:
            rt, rrows, rsd, red, drop = rtp._upsert_step_ed(rt, rrows, rsd, red, rc, ("id",),
                                                            names)
        else:
            rt, rrows, rsd, drop = rtp._upsert_step(rt, rrows, rsd, rc, ("id",), names)
        r_drop |= bool(drop)
        pt = ptp.upsert_step(pt, prows, psd, pc, ("id",), names, scratch, dropped,
                             ped if with_ed else None)
        ref = {"live": rt.live, "sdirty": rsd, **{f"r_{n}": rrows[n] for n in names},
               "key": rt.keys[0], **({"ed": red} if with_ed else {})}
        port = {"live": pt.live, "sdirty": psd, **{f"r_{n}": prows[n] for n in names},
                "key": pt.keys[0], **({"ed": ped} if with_ed else {})}
        yield ({k: np.asarray(v) for k, v in ref.items()},
               {k: v.numpy().copy() for k, v in port.items()}, r_drop, bool(dropped))


@pytest.mark.parametrize("with_ed", [False, True], ids=["upsert", "upsert_ed"])
def test_upsert_step_matches_reference(with_ed):
    """Kernel V's plain version alone: the last row per pk writes every
    lane (deletes too), live by its sign, sdirty (and epoch_dirty), slot
    for slot."""
    for ref, port, r_drop, p_drop in _upsert_runs(with_ed, ids_range=50):
        assert ref.keys() == port.keys()
        for k in ref:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        assert not r_drop and not p_drop


@pytest.mark.parametrize("with_ed", [False, True], ids=["upsert", "upsert_ed"])
def test_upsert_dropped_row_writes_nothing(with_ed):
    """A row whose pk finds no slot (90 ids into 64 slots) latches
    dropped in both packages, and the barrier raises. The reference's
    scatter index for it is -1, which JAX wraps to the last slot: its
    lanes and marks land in slot 63, over that slot's own row. The port
    writes nothing for it (kernel D's rule), so every slot but the last
    equals the reference's and the last keeps its own row."""
    for ref, port, r_drop, p_drop in _upsert_runs(with_ed, ids_range=90):
        assert r_drop == p_drop
        for k in ref:
            np.testing.assert_array_equal(port[k][:-1], ref[k][:-1], err_msg=k)
    assert p_drop
    assert port["r_id"][-1] == port["key"][-1] and ref["r_id"][-1] != ref["key"][-1]


def _ranked_store(rng, cap=128, n=90, extremes=True):
    """A reference row store and its port twin after inserts and deletes,
    INT64 extremes among the order values of live and dead rows."""
    r, p = _stores("group", False, cap=cap)
    for e, (cols, ops, _) in enumerate(_retract_stream(rng, 6, groups=6, vmax=40)):
        if e:
            r.on_barrier(None)
            p.on_barrier(None)
        if extremes:
            cols["v"][::7] = IMAX
            cols["v"][3::11] = IMIN
        rc, pc = _pair(cols, 64, ops)
        r.apply(rc)
        p.apply(pc)
    return r, p


M64 = (1 << 64) - 1
W_CASES = ("ties_at_nth", "n_past_live", "all_dead", "float_nan_negzero", "float32_nan",
           "wide_pk", "pk_dtypes", "n_at_cap")


def _w_store(case, desc, rng, cap=256):
    """Kernel W's hard stores at a small size (``chip_smoke.w_hard_stores``
    holds the kernel itself on the same kinds): ``(live, order, pks, n)``
    per slot, dead slots with stale lanes (INT64 extremes among them)."""
    live = rng.random(cap) < 0.6
    order = rng.integers(-20, 20, cap).astype(np.int64)
    order[~live & (rng.random(cap) < 0.2)] = IMIN
    order[~live & (rng.random(cap) < 0.2)] = IMAX
    pks = [rng.permutation(cap).astype(np.int64) - 100]
    n = 40
    if case == "ties_at_nth":  # a run of ties across the n-th place
        order = np.where(rng.random(cap) < 0.5, 7, rng.integers(-30, 30, cap)).astype(np.int64)
        pks = [rng.integers(-3, 3, cap).astype(np.int64), rng.permutation(cap).astype(np.int64)]
        key = (-order if desc else order)[live]
        n = int((key < (-7 if desc else 7)).sum() + (key == (-7 if desc else 7)).sum() // 2)
    elif case == "n_past_live":
        n = int(live.sum()) + 37
    elif case == "all_dead":
        live[:] = False
        n = 50
    elif case in ("float_nan_negzero", "float32_nan"):
        vals = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5, 2.0, -np.nan])
        order = rng.choice(vals, cap).astype(np.float64 if case == "float_nan_negzero"
                                              else np.float32)
        n = 60
    elif case == "wide_pk":  # the packed key passes 64 bits
        order = rng.integers(0, 3, cap).astype(np.int64)
        pks = [rng.integers(IMIN, IMAX, cap, dtype=np.int64) // (1 + (rng.random(cap) < 0.5)),
               rng.integers(IMIN, IMAX, cap, dtype=np.int64)]
        pks[0][rng.random(cap) < 0.5] = pks[0][0]
        n = 120
    elif case == "pk_dtypes":
        order = rng.integers(0, 4, cap).astype(np.int64)
        pks = [rng.integers(-2**31, 2**31, cap).astype(np.int32) // 2**28,
               rng.random(cap) < 0.5, rng.permutation(cap).astype(np.int32) - 128]
        n = 90
    elif case == "n_at_cap":
        n = cap
    return live, order, pks, n


def _w_tables(live, pks):
    """The reference's and the port's table of these lanes (no keys hashed:
    W reads ``live`` and the key lanes alone)."""
    cap = len(live)
    z32 = np.zeros(cap, np.int32)
    ref = rht.HashTable(jnp.asarray(z32.view(np.uint32)), jnp.asarray(z32.view(np.uint32)),
                        tuple(jnp.asarray(k) for k in pks), jnp.asarray(live))
    port = pht.HashTable(torch.from_numpy(z32), torch.from_numpy(z32),
                         tuple(torch.from_numpy(np.array(k)) for k in pks),
                         torch.from_numpy(live.copy()), torch.from_numpy(z32),
                         torch.zeros((), dtype=torch.int64))
    return ref, port


@pytest.mark.parametrize(
    "case,desc", [(c, d) for c in ("store",) + W_CASES for d in (False, True)],
    ids=[f"{c}-{a}" if c != "store" else a for c in ("store",) + W_CASES for a in ("asc", "desc")])
def test_rank_top_matches_reference(case, desc):
    """Kernel W's plain version: the top-n slots and their liveness flags
    equal the reference's ``_rank_top``; no dead row (whatever its
    INT64-extreme order value) precedes a live one. On the executors'
    store (``store``) the live prefix is compared at three sizes of n; on
    the hard stores every slot: ties across the n-th place, n past the
    live count (dead rows by their stale lanes), an all-dead store, float
    order lanes with NaN and -0.0, pk lanes whose packed key passes 64
    bits, int32 and bool pk lanes, n equal to the capacity."""
    if case == "store":
        r, p = _ranked_store(np.random.default_rng(41))
        for n in (3, 20, 128):
            ridx, ralive = rtp._rank_top(r.table, r.rows["v"], n, desc)
            pidx, palive = ptp.rank_top(p.table, p.rows["v"], n, desc)
            ralive = np.asarray(ralive)
            _eq(palive, ralive)
            m = int(ralive.sum())
            assert ralive[:m].all() and not ralive[m:].any()
            np.testing.assert_array_equal(pidx.numpy()[:m], np.asarray(ridx)[:m])
        return
    live, order, pks, n = _w_store(case, desc, np.random.default_rng(60 + W_CASES.index(case)))
    rt, pt = _w_tables(live, pks)
    ridx, ralive = rtp._rank_top(rt, jnp.asarray(order), n, desc)
    pidx, palive = ptp.rank_top(pt, torch.from_numpy(order), n, desc)
    _eq(pidx, ridx)
    _eq(palive, ralive)
    m = int(live.sum())
    assert np.asarray(ralive)[:min(m, n)].all() and not np.asarray(ralive)[m:].any()


def _w_encode(live, order, pks, desc):
    """Each slot's key words as kernel W encodes them (csrc/topn_rank.cu
    tr_encode): live 0 and dead 1, the order key, the pk lanes."""
    okey = topn_order_key(torch.from_numpy(order), desc).numpy()
    lanes = [[0 if v else 1 for v in live], [(int(v) & M64) ^ (1 << 63) for v in okey]]
    for k in pks:
        if k.dtype == np.bool_:
            lanes.append([int(v) for v in k])
        elif k.dtype == np.int32:
            lanes.append([(int(v) & 0xFFFFFFFF) ^ 0x80000000 for v in k])
        else:
            lanes.append([(int(v) & M64) ^ (1 << 63) for v in k])
    return lanes


def _w_fold(vals):
    """OR, AND, MIN, MAX of unsigned words (the empty fold: 0, ~0, ~0, 0)."""
    o, a, lo, hi = 0, M64, M64, 0
    for v in vals:
        o, a, lo, hi = o | v, a & v, min(lo, v), max(hi, v)
    return o, a, lo, hi


def _w_select(plan, rows, field):
    """The select's rounds on ``rows`` of the selected class: the n-th
    row's field, as the round and pick kernels find it."""
    t, m = 0, plan.m
    for shift, bits in plan.rounds:
        hi = shift + bits
        hist = [0] * (1 << bits)
        for s in rows:
            f = field(s)
            if hi >= 64 or f >> hi == t:
                hist[(f >> shift) & ((1 << bits) - 1)] += 1
        below = 0
        for d, c in enumerate(hist):
            if below < m <= below + c:
                t, m = (t << bits) | d, m - below
                break
            below += c
    return t


def _w_emulate(live, order, pks, n, desc):
    """Kernel W's steps in plain Python: the fold, the select plan and its
    rounds, the candidates (slot order) and their fold, the packed key
    and the stable LSD byte passes over the bytes its plan marks, least
    significant word first; the first n slots."""
    cap = len(live)
    lanes = _w_encode(live, order, pks, desc)
    okey = lanes[1]
    plan = ptp.rank_select_plan(n, int(live.sum()), cap,
                                _w_fold(okey[s] for s in range(cap) if live[s]),
                                _w_fold(okey[s] for s in range(cap) if not live[s]))
    field = lambda s: ((okey[s] - plan.min) & M64) >> plan.lo
    t = _w_select(plan, [s for s in range(cap) if bool(live[s]) == (plan.cls == 1)], field)

    def candidate(s):
        if plan.take_live if live[s] else plan.take_dead:
            return True
        return plan.cls == (1 if live[s] else 0) and field(s) <= t

    cand = [s for s in range(cap) if candidate(s)]
    pack = ow.window_pack_plan([_w_fold(lane[s] for s in cand) for lane in lanes], 0, 0)
    words = {s: pack.split(pack.pack([lane[s] for lane in lanes])) for s in cand}
    for w in reversed(range(pack.words)):
        for b in range(8):
            if (pack.pass_masks[w] >> b) & 1:
                cand.sort(key=lambda s: (words[s][w] >> (8 * b)) & 0xFF)
    return cand[:n], plan, pack


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("case", W_CASES)
def test_rank_select_emulation_matches_reference(case, desc):
    """Kernel W's select and candidate sort, emulated on the CPU, give the
    reference's ``_rank_top`` slots on every hard store: ties across the
    n-th place sorted by their pk lanes, dead rows past the live count by
    their stale lanes, an all-dead store, NaN and -0.0, a packed key of
    more than one word."""
    live, order, pks, n = _w_store(case, desc, np.random.default_rng(60 + W_CASES.index(case)))
    rt, _ = _w_tables(live, pks)
    ridx, _ = rtp._rank_top(rt, jnp.asarray(order), n, desc)
    got, plan, pack = _w_emulate(live, order, pks, n, desc)
    assert got == np.asarray(ridx).tolist()
    if case in ("wide_pk", "n_past_live"):  # wide pks; INT64-extreme stale order keys
        assert pack.words > 1
    if case in ("n_past_live", "n_at_cap", "all_dead"):
        assert plan.cls in (-1, 0)
    if case == "ties_at_nth":
        assert plan.cls == 1 and plan.rounds


@pytest.mark.parametrize("seed", range(6))
def test_rank_select_plan_finds_the_nth_field(seed):
    """``rank_select_plan``'s rounds against a numpy sort: over keys of
    every width (one value, a few bits, a span across zero, INT64
    extremes), the digits found round by round spell the m-th smallest
    field; the rounds cover the field's bits from the top, none wider
    than ``SELECT_BITS``."""
    rng = np.random.default_rng(seed)
    spans = [(5, 6), (0, 40), (-3000, 3000), (IMIN, IMAX), (10**12, 10**12 + 2**33)]
    lo, hi = spans[seed % len(spans)]
    vals = rng.integers(lo, hi, 500, dtype=np.int64, endpoint=True)
    if seed == 5:
        vals = np.repeat(vals[:3], 200) << 3  # three values, low bits equal
    keys = [(int(v) & M64) ^ (1 << 63) for v in vals]
    for m in (1, 2, 250, len(keys) - 1):
        plan = ptp.rank_select_plan(m, len(keys), len(keys) + 8, _w_fold(keys), _w_fold([]))
        assert plan.cls == 1 and plan.m == m
        field = lambda k: ((k - plan.min) & M64) >> plan.lo
        width = sum(b for _, b in plan.rounds)
        assert all(b <= ptp.SELECT_BITS for _, b in plan.rounds)
        assert [s for s, _ in plan.rounds] == sorted((s for s, _ in plan.rounds), reverse=True)
        assert all(field(k) < 1 << width for k in keys) if width else len(set(keys)) == 1
        t = _w_select(plan, keys, field)
        assert t == sorted(field(k) for k in keys)[m - 1]


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("k", [1, 3])
def test_group_topk_mask_matches_reference(k, desc):
    """Kernel X's plain version: in_topk and gdirty slot for slot equal
    the reference's ``_group_topk_mask``, INT64 extremes and dead rows
    among the order values."""
    r, p = _ranked_store(np.random.default_rng(43 + k))
    rin, rg = rtp._group_topk_mask(r.table, r.rows, r.epoch_dirty, k, desc, ("g",), "v")
    pin, pg = ptp.group_topk_mask(p.table, p.rows, p.epoch_dirty, k, desc, ("g",), "v")
    _eq(pin, rin)
    _eq(pg, rg)
    assert pin.any() and pg.any()


def _hard_store(case, rng):
    """Kernel X's hard stores at a small size (``chip_smoke.x_hard_stores``
    holds the kernel itself on the same kinds): group lanes, order lane,
    an int64 pk and live, for rows at random slots of 256."""
    i_min, i_max = IMIN, IMAX
    if case == "ties_and_group_sizes":
        # g1 15 rows tied; g2 8 then 4 tied across the 10th place; g3
        # exactly 10 live and g4 11, under dead rows of better order; g5
        # dead rows only
        g = np.repeat(np.arange(1, 6), (15, 12, 14, 15, 6)).astype(np.int64)
        o = np.r_[np.full(15, 5), np.full(8, 1), np.full(4, 5), rng.integers(0, 4, 10),
                  np.full(4, i_min), rng.integers(0, 4, 11), np.full(4, i_min),
                  np.full(6, -3)].astype(np.int64)
        live = np.r_[np.ones(37, bool), np.zeros(4, bool), np.ones(11, bool), np.zeros(10, bool)]
        return (g,), o, rng.permutation(len(g)).astype(np.int64), live
    n = 120
    if case.startswith("floats"):
        vals = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5])
        return ((rng.integers(0, 5, n).astype(np.int64),),
                vals[rng.integers(0, 8, n)].astype(case.split("_")[1]),
                np.arange(n, dtype=np.int64)[::-1].copy(), rng.random(n) < 0.8)
    if case == "int64_extremes":
        ext = np.array([i_min, i_min + 1, -1, 0, 1, i_max - 1, i_max], np.int64)
        return ((ext[rng.integers(0, 7, n)],), ext[rng.integers(0, 7, n)],
                np.r_[ext, 100 + np.arange(n - 7)].astype(np.int64), rng.random(n) < 0.85)
    if case == "key_past_64":  # 40 group bits and a 64-bit order key: the key is cut
        big = rng.integers(1 << 39, 1 << 40, 4)
        ords = rng.integers(i_min, i_max, 25, dtype=np.int64)
        return ((big[rng.integers(0, 4, n)].astype(np.int64),), ords[rng.integers(0, 25, n)],
                np.arange(n, dtype=np.int64), rng.random(n) < 0.9)
    if case == "groups_share_run":  # 1 + 64 group bits: groups share a run of equal key
        return ((rng.integers(0, 2, n).astype(np.int64),
                 np.array([0, 1, 2, 3, -1], np.int64)[rng.integers(0, 5, n)]),
                rng.integers(0, 3, n).astype(np.int64), rng.permutation(n).astype(np.int64),
                rng.random(n) < 0.9)
    if case == "long_tie_run":  # one group of 200 rows of one order value, and small ones
        g = np.r_[np.zeros(200, np.int64), np.repeat(np.arange(1, 6), 8).astype(np.int64)]
        o = np.r_[np.full(200, 7), rng.integers(0, 9, 40)].astype(np.int64)
        return (g,), o, rng.permutation(240).astype(np.int64), rng.random(240) < 0.95
    if case == "ten_group_lanes":
        return (tuple(rng.integers(0, 2, n).astype(np.int64) for _ in range(10)),
                rng.integers(0, 4, n).astype(np.int64), rng.permutation(n).astype(np.int64),
                rng.random(n) < 0.9)
    assert case == "groups_past_64"  # two full-range group lanes
    ga = rng.integers(i_min, i_max, 3, dtype=np.int64)
    gb = rng.integers(i_min, i_max, 2, dtype=np.int64)
    return ((ga[rng.integers(0, 3, n)], gb[rng.integers(0, 2, n)]),
            rng.integers(0, 4, n).astype(np.int64), rng.permutation(n).astype(np.int64),
            rng.random(n) < 0.9)


_HARD = ("ties_and_group_sizes", "floats_float32", "floats_float64", "int64_extremes",
         "key_past_64", "groups_past_64", "groups_share_run", "long_tie_run", "ten_group_lanes")


@pytest.mark.parametrize("case", _HARD)
def test_group_topk_mask_hard_stores_match_reference(case):
    """Kernel X's plain version against the reference's
    ``_group_topk_mask`` on the stores kernel X's redesign must get
    right: ties in (group, order key) across the k-th place (broken by
    pk against slot order), groups of exactly k and k + 1 live rows under
    dead rows of better order, a group of dead rows only with an
    epoch-dirty slot, NaN, -0.0 and infinities in float order lanes,
    INT64 extremes in every lane, keys whose varying bits pass 64 (the
    order key's, and the group lanes' alone, once with several groups in
    one run of equal key), a tie run of 200 rows across the k-th place,
    ten group lanes; no slot, some slots
    and every slot epoch-dirty; k of 1, 3, 10 and 11, ASC and DESC."""
    rng = np.random.default_rng(71 + _HARD.index(case))
    groups, order, pk, live = _hard_store(case, rng)
    cap = 256
    at = rng.choice(cap, len(order), replace=False)

    def lane(vals):
        out = np.zeros(cap, np.asarray(vals).dtype)
        out[at] = vals
        return out

    glanes = [lane(g) for g in groups]
    names = tuple(f"g{i}" for i in range(len(glanes)))
    rows = dict(zip(names, glanes), o=lane(order))
    keys = glanes + [lane(pk)]
    lv = lane(live)
    ref = rht.HashTable(jnp.zeros(cap, jnp.uint32), jnp.zeros(cap, jnp.uint32),
                        tuple(jnp.asarray(k) for k in keys), jnp.asarray(lv))
    port = pht.HashTable.create(cap, tuple(torch.from_numpy(k).dtype for k in keys), device="cpu")
    for tk, k in zip(port.keys, keys):
        tk.copy_(torch.from_numpy(k))
    port.live.copy_(torch.from_numpy(lv))
    some = np.zeros(cap, bool)
    some[at[rng.random(len(at)) < 0.1]] = True
    some[at[-1]] = True
    for dirty in (np.zeros(cap, bool), some, np.ones(cap, bool)):
        for k in (1, 3, 10, 11):
            for desc in (False, True):
                rin, rg = rtp._group_topk_mask(ref, {n: jnp.asarray(v) for n, v in rows.items()},
                                               jnp.asarray(dirty), k, desc, names, "o")
                pin, pg = ptp.group_topk_mask(port, {n: torch.from_numpy(v) for n, v in
                                                     rows.items()}, torch.from_numpy(dirty), k,
                                              desc, names, "o")
                _eq(pin, rin)
                _eq(pg, rg)


_M64 = (1 << 64) - 1


@st.composite
def _fold_rows(draw):
    """Rows of 2-4 encoded key lanes (unsigned 64-bit words): per lane a
    constant with a random span of bits that vary, from one bit to all
    64."""
    n_lanes = draw(st.integers(2, 4))
    n_rows = draw(st.integers(1, 24))
    lanes = []
    for _ in range(n_lanes):
        lo = draw(st.integers(0, 63))
        hi = draw(st.integers(lo, 63))
        span = ((1 << (hi - lo + 1)) - 1) << lo
        base = draw(st.integers(0, _M64)) & ~span
        lanes.append([base | (draw(st.integers(0, _M64)) & span) for _ in range(n_rows)])
    return draw(st.integers(1, n_lanes - 1)), [tuple(r) for r in zip(*lanes)]


def _span(o: int, a: int) -> int:
    """Bits from a lane's lowest varying bit to its highest."""
    v = (o ^ a) & _M64
    return v.bit_length() - (v & -v).bit_length() + 1 if v else 0


_SPAN36 = (1 << 36) - 1


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_fold_rows())
# exactly 64 varying bits, rows apart only in the last bit (no cut)
@example((1, [(0, 0), (0, 1), ((1 << 32) - 1, 0), ((1 << 32) - 1, (1 << 32) - 1)]))
# two 36-bit group lanes: the group bits alone pass 64
@example((2, [(0, 0, 5), (_SPAN36, 0, 1), (0, _SPAN36, 2), (_SPAN36, _SPAN36, 1), (0, 1, 3)]))
# a 40-bit group lane and a 64-bit order key: the order key is cut
@example((1, [(0, _M64), (0, 0), ((1 << 40) - 1, 7), ((1 << 40) - 1, 8), (5, 1 << 63)]))
def test_pack_plan_orders_rows_as_their_lanes(case):
    """``topk_pack_plan``, kernel X's packing plan from the fold (the OR
    and AND of each lane over the rows): the packed key never orders two
    rows against their lanes' order (group lanes, then the order key, as
    unsigned words); without a cut it ties exactly the rows whose lanes
    tie; with exact groups its top bits tell the groups apart; every
    byte in which two packed keys differ gets a radix pass."""
    n_group, rows = case
    n_lanes = len(rows[0])
    ors = [0] * n_lanes
    ands = [_M64] * n_lanes
    for r in rows:
        for j, w in enumerate(r):
            ors[j] |= w
            ands[j] &= w
    plan = ptp.topk_pack_plan(ors, ands, n_group)
    assert plan.bits <= 64
    assert all(pos + w <= 64 and pos > -w for _, _, w, pos in plan.fields)
    packed = [plan.pack(r) for r in rows]
    assert all(0 <= p < (1 << max(plan.bits, 1)) for p in packed)
    cut = sum(_span(o, a) for o, a in zip(ors, ands)) > 64
    byte_mask = sum(0xFF << (8 * b) for b in range(8) if (plan.pass_mask >> b) & 1)
    group = (lambda p: 0 if plan.gshift >= 64 else p >> plan.gshift)
    for a, pa in zip(rows, packed):
        for b, pb in zip(rows, packed):
            if a < b:
                assert pa <= pb
            if not cut:
                assert (pa == pb) == (a == b)
            if plan.exact:
                assert (group(pa) == group(pb)) == (a[:n_group] == b[:n_group])
            assert (pa ^ pb) & ~byte_mask == 0


def test_float_order_and_float_key_lanes():
    """A float order lane ranks by the reference's total order (the
    store's W and X equal the reference's); a float pk or group lane is
    refused."""
    rng = np.random.default_rng(47)
    dtr, dtp = dict(DTR, v=jnp.float64), dict(DTP, v=torch.float64)
    r = rtp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",), dtr, capacity=64)
    p = ptp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",), dtp, capacity=64, device="cpu")
    for cols, ops, _ in _retract_stream(rng, 4, floats=True):
        cols["v"][::5] = np.nan
        cols["v"][1::7] = -0.0
        rc, pc = _pair(cols, 64, ops)
        r.apply(rc)
        p.apply(pc)
        _same_emission(r.on_barrier(None), p.on_barrier(None))
    for desc in (False, True):
        ridx, ralive = rtp._rank_top(r.table, r.rows["v"], 10, desc)
        pidx, palive = ptp.rank_top(p.table, p.rows["v"], 10, desc)
        m = int(np.asarray(ralive).sum())
        np.testing.assert_array_equal(pidx.numpy()[:m], np.asarray(ridx)[:m])
    t = pht.HashTable.create(8, (torch.float64,), device="cpu")
    with pytest.raises(TypeError, match="integer or bool"):
        ptp.rank_top(t, torch.zeros(8), 2, False)


# the reference's retractable GroupTopN tests (tests/test_top_n.py :162-383), on the port
def _replay_set(state, outs, names=("g", "id", "v")):
    for out in outs:
        d = out.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            row = tuple(d[n][i].item() for n in names)
            if d["__op__"][i] in (int(Op.DELETE), int(Op.UPDATE_DELETE)):
                state[row] = state.get(row, 0) - 1
            else:
                state[row] = state.get(row, 0) + 1
            if not state[row]:
                del state[row]


def test_retractable_group_topn_randomized_oracle():
    """Replaying the delta stream always equals each group's SQL top k
    (desc, ties to the lower id)."""
    K = 3
    ex = ptp.RetractableGroupTopNExecutor(("g",), "v", K, ("id",), DTP, desc=True,
                                          capacity=1 << 9, table_id="gtn", device="cpu")
    rng = np.random.default_rng(17)
    replay = {}
    for epoch, (cols, ops, live) in enumerate(_retract_stream(rng, 12, groups=4, vmax=100)):
        ex.apply(StreamChunk.from_numpy(cols, 64, ops=ops, device="cpu"))
        _replay_set(replay, ex.on_barrier(None))
        per_g = collections.defaultdict(list)
        for id_, (g, v) in live.items():
            per_g[g].append((v, -id_, id_))
        want = set()
        for g, rows in per_g.items():
            for v, _, id_ in sorted(rows, reverse=True)[:K]:
                want.add((g, id_, v))
        assert all(c == 1 for c in replay.values()) and set(replay) == want, epoch


def test_retractable_group_topn_checkpoint_restore():
    """Kill and recover mid-stream: the delta stream after the restore
    (its mirror rebuilt from the restored top k) matches an
    uninterrupted run, the restored store equals the reference's restore
    slot for slot and both recovered runs emit alike."""
    from risingwave_tpu.storage import CheckpointManager as RefManager
    from risingwave_tpu.storage import MemObjectStore as RefStore
    from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore

    rng = np.random.default_rng(5)
    epochs = [{"g": rng.integers(0, 3, n), "id": rng.integers(0, 40, n),
               "v": rng.integers(0, 100, n)} for n in rng.integers(4, 16, 6)]
    mk = lambda: _stores("group", True, cap=1 << 8)
    want, got = {}, {}
    oracle = mk()[1]
    for c in epochs:
        oracle.apply(StreamChunk.from_numpy(c, 32, device="cpu"))
        _replay_set(want, oracle.on_barrier(None))
    r1, p1 = mk()
    rm, pm = RefManager(RefStore()), CheckpointManager(MemObjectStore())
    for c in epochs[:3]:
        rc, pc = _pair(c, 32)
        r1.apply(rc)
        r1.on_barrier(None)
        p1.apply(pc)
        _replay_set(got, p1.on_barrier(None))
    rm.commit_staged(1, rm.stage([r1]))
    pm.commit_staged(1, pm.stage([p1]))
    r2, p2 = mk()
    rm.recover([r2])
    pm.recover([p2])
    _same_store(r2, p2)
    for c in epochs[3:]:
        rc, pc = _pair(c, 32)
        r2.apply(rc)
        p2.apply(pc)
        ro, po = r2.on_barrier(None), p2.on_barrier(None)
        _same_emission(ro, po)
        _replay_set(got, po)
    assert got == want and want


def test_retractable_group_topn_group_change_and_extreme_values():
    """A row moving groups (DELETE old + INSERT new) retracts from the
    old group; an INT64_MAX order value never loses to dead slots."""
    ex = ptp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",), DTP, desc=False,
                                          capacity=1 << 7, table_id="gtn3", device="cpu")
    state = {}
    ex.apply(StreamChunk.from_numpy({"g": np.asarray([0, 0, 1]), "id": np.asarray([1, 2, 3]),
                                     "v": np.asarray([5, IMAX, 9])}, 8, device="cpu"))
    _replay_set(state, ex.on_barrier(None))
    assert set(state) == {(0, 1, 5), (0, 2, IMAX), (1, 3, 9)}
    ex.apply(StreamChunk.from_numpy({"g": np.asarray([0, 1]), "id": np.asarray([2, 2]),
                                     "v": np.asarray([IMAX, 4])}, 8,
                                    ops=np.asarray([int(Op.DELETE), int(Op.INSERT)], np.int32),
                                    device="cpu"))
    _replay_set(state, ex.on_barrier(None))
    assert set(state) == {(0, 1, 5), (1, 2, 4), (1, 3, 9)}


def test_retractable_window_watermark_matches_reference():
    """``window_key`` on the group column: a watermark expires the closed
    groups' rows (dead, sdirty) and drops them from the mirror without
    retractions; later barriers emit as the reference's."""
    rng = np.random.default_rng(53)
    r = rtp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",), DTR, capacity=64,
                                         window_key=("g", 1))
    p = ptp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",), DTP, capacity=64,
                                         window_key=("g", 1), device="cpu")
    for e, (cols, ops, _) in enumerate(_retract_stream(rng, 8, groups=8)):
        cols["g"] = cols["g"] + e
        rc, pc = _pair(cols, 64, ops)
        r.apply(rc)
        p.apply(pc)
        _same_emission(r.on_barrier(None), p.on_barrier(None))
        assert r.on_watermark(RefWatermark("g", e + 2))[1] == []
        assert p.on_watermark(Watermark("g", e + 2))[1] == []
        _same_store(r, p)
        assert p.state_digest() == r.state_digest()
    emitted_groups = {g for g in r._emitted}
    got = set(p.table.keys[0][p.emitted].tolist())
    assert got <= {g for (g,) in emitted_groups}


# the reference's plain TopN tests (tests/test_simple_agg_topn.py :87, :116), on the port
DT_KV = {"k": torch.int64, "v": torch.int64}


def _kv_chunk(rows, cap=32):
    return StreamChunk.from_numpy({"k": np.asarray([r[0] for r in rows], np.int64),
                                   "v": np.asarray([r[1] for r in rows], np.int64)}, cap,
                                  ops=np.asarray([int(r[2]) for r in rows], np.int32),
                                  device="cpu")


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_topn_stream_matches_oracle(desc):
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    rng = np.random.default_rng(3)
    ex = ptp.TopNExecutor("v", 5, ("k",), DT_KV, desc=desc, capacity=256, device="cpu")
    mv = DeviceMaterializeExecutor(pk=("k",), columns=("v",), schema_dtypes=DT_KV,
                                   capacity=1 << 10, device="cpu")
    pipe = Pipeline([ex, mv])
    rows = {}
    for _ in range(20):
        batch = []
        for _ in range(int(rng.integers(1, 8))):
            if rows and rng.random() < 0.35:
                k = list(rows)[int(rng.integers(len(rows)))]
                batch.append((k, rows.pop(k), Op.DELETE))
            else:
                k, v = int(rng.integers(0, 1000)), int(rng.integers(0, 100))
                if k in rows:
                    batch += [(k, rows[k], Op.UPDATE_DELETE), (k, v, Op.UPDATE_INSERT)]
                else:
                    batch.append((k, v, Op.INSERT))
                rows[k] = v
        pipe.push(_kv_chunk(batch))
        pipe.barrier()
        live = sorted(rows.items(), key=lambda kv: (kv[1], kv[0]), reverse=desc)[:5]
        assert mv.snapshot() == {(k,): (v,) for k, v in live}


def test_topn_recovery():
    from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore

    store = MemObjectStore()
    ex = ptp.TopNExecutor("v", 3, ("k",), DT_KV, capacity=64, table_id="tn", device="cpu")
    ex.apply(_kv_chunk([(i, i * 10, Op.INSERT) for i in range(6)]))
    ex.on_barrier(None)
    CheckpointManager(store).commit_epoch(1 << 16, [ex])
    ex2 = ptp.TopNExecutor("v", 3, ("k",), DT_KV, capacity=64, table_id="tn", device="cpu")
    CheckpointManager(store).recover([ex2])
    assert ex2.apply(_kv_chunk([(0, 0, Op.DELETE)])) == []
    snap = {}
    for c in ex2.on_barrier(None):
        d = c.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            if d["__op__"][i] == Op.DELETE:
                snap.pop(int(d["k"][i]), None)
            else:
                snap[int(d["k"][i])] = int(d["v"][i])
    assert snap == {3: 30}  # 0 dropped out, 3 entered the top 3


@pytest.mark.parametrize("kind", ["plain", "group"])
def test_restore_matches_reference(kind):
    """A restore from the reference's delta rebuilds the store slot for
    slot as the reference's restore, and the next barrier emits as the
    reference's (the mirror recomputed from the restored top n / k)."""
    rng = np.random.default_rng(59)
    r, p = _stores(kind, True, cap=64)
    stream = list(_retract_stream(rng, 6))
    for cols, ops, _ in stream[:4]:
        rc, pc = _pair(cols, 64, ops)
        r.apply(rc)
        r.on_barrier(None)
        p.apply(pc)
        p.on_barrier(None)
    (d,) = r.checkpoint_delta()
    keep = ~np.asarray(d.tombstone)
    key_cols = {k: np.asarray(v)[keep] for k, v in d.key_cols.items()}
    value_cols = {k: np.asarray(v)[keep] for k, v in d.value_cols.items()}
    r2, p2 = _stores(kind, True, cap=64)
    r2.restore_state("t", key_cols, value_cols)
    p2.restore_state("t", key_cols, value_cols)
    _same_store(r2, p2)
    for cols, ops, _ in stream[4:]:
        rc, pc = _pair(cols, 64, ops)
        r2.apply(rc)
        p2.apply(pc)
        _same_emission(r2.on_barrier(None), p2.on_barrier(None))


# -- the card's wrappers ----------------------------------------------------------
def test_card_entry_points_refuse_cpu_tensors_and_absent_cuda():
    """With no card the executors raise instead of running on the CPU,
    and each CUDA wrapper refuses CPU tensors rather than fall back to
    its plain version."""
    assert not torch.cuda.is_available()
    for make in (lambda: ptp.TopNExecutor("v", 3, ("k",), DT_KV),
                 lambda: ptp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",), DTP),
                 lambda: ptn.GroupTopNExecutor(("g",), "v", 2, DT_P)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    before = dict(_kernels.LAUNCHES)
    p = ptp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",), DTP, capacity=64, device="cpu")
    chunk = StreamChunk.from_numpy({"g": np.zeros(4, np.int64), "id": np.arange(4),
                                    "v": np.arange(4)}, 8, device="cpu")
    slots = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ptp._topn_upsert_cuda(p.table, p.rows, p.sdirty, p.epoch_dirty, chunk, slots, p.names,
                              p.scratch, p._dropped)
    with pytest.raises(ValueError, match="CUDA"):
        ptp._rank_top_cuda(p.table, p.rows["v"], 2, False)
    with pytest.raises(ValueError, match="CUDA"):
        ptp._group_topk_mask_cuda(p.table, p.rows, p.epoch_dirty, 2, False, (p.rows["g"],), "v")
    g = ptn.GroupTopNExecutor(("g",), "v", 2, DT_P, payload=("p",), capacity=64, device="cpu")
    c = StreamChunk.from_numpy({"g": np.zeros(4, np.int64), "v": np.arange(4),
                                "p": np.zeros(4, np.int32)}, 8, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ptn._topn_band_cuda(g.table, g.state, c, slots, c.valid, ("g",), "v", True, 2, ("p",),
                            16, g.scratch, g._latches)
    assert dict(_kernels.LAUNCHES) == before  # nothing counted, nothing launched
