"""The lookup / delta join of the port (``executors/lookup.py``) against
the reference's on the CPU: ``IndexArrangement`` and
``DeltaJoinExecutor`` fed the same inserts, deletes and U-/U+ pairs
give the same rows, prefix maps and emissions, chunk by chunk; an
arrangement restored from its checkpoint delta rebuilds the same
prefix map; the planner's delta-join branch plans the same chain over
catalog indexes, and declines (float keys, no index, the switch off)
exactly where the reference declines. The session (``CREATE INDEX``,
``SET enable_delta_join``) is not ported: the tests register the
indexes on the catalog as the session does.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import lookup as ref_lookup
from risingwave_tpu.sql import Catalog as RefCatalog
from risingwave_tpu.sql import StreamPlanner as RefPlanner
from risingwave_tpu.types import DataType as RefDT
from risingwave_tpu.types import Schema as RefSchema
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import lookup
from risingwave_tpu_torch.sql import Catalog, StreamPlanner
from risingwave_tpu_torch.types import DataType, Schema


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chunk(cols, ops, port: bool, nulls=None):
    cap = max(2, 1 << (len(ops) - 1).bit_length())
    cols = {k: np.asarray(v, np.int64) for k, v in cols.items()}
    ops = np.asarray(ops, np.int32)
    if port:
        return StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu")
    return RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls)


def _rows(chunks):
    out = []
    for c in chunks:
        d = c.to_numpy(with_ops=True)
        names = sorted(k for k in d if k != "__op__")
        for i in range(len(d["__op__"])):
            out.append((int(d["__op__"][i]),) + tuple(
                None if d.get(n + "__null") is not None and d[n + "__null"][i]
                else d[n][i].item() for n in names if not n.endswith("__null")))
    return out


def _stream(seed=17, epochs=40):
    """Random side deltas: inserts, deletes and U-/U+ pairs, as
    (side, cols, ops) with ids unique per side."""
    rng = np.random.default_rng(seed)
    live = {"l": {}, "r": {}}
    ids = {"l": 0, "r": 0}
    out = []
    for _ in range(epochs):
        side = "l" if rng.random() < 0.5 else "r"
        val = "x" if side == "l" else "y"
        pk = "lid" if side == "l" else "rid"
        roll = rng.random()
        if roll < 0.3 and live[side]:
            key = int(rng.choice(list(live[side])))
            k, v = live[side].pop(key)
            out.append((side, {"k": [k], val: [v], pk: [key]}, [1]))
        elif roll < 0.5 and live[side]:
            key = int(rng.choice(list(live[side])))
            k, v = live[side][key]
            nk, nv = int(rng.integers(0, 6)), int(rng.integers(0, 100))
            live[side][key] = (nk, nv)
            out.append((side, {"k": [k, nk], val: [v, nv], pk: [key, key]}, [2, 3]))
        else:
            n = int(rng.integers(1, 4))
            rows = {"k": [], val: [], pk: []}
            for _ in range(n):
                k, v = int(rng.integers(0, 6)), int(rng.integers(0, 100))
                live[side][ids[side]] = (k, v)
                rows["k"].append(k)
                rows[val].append(v)
                rows[pk].append(ids[side])
                ids[side] += 1
            out.append((side, rows, [0] * n))
    return out


def _build(mod):
    la = mod.IndexArrangement(("k",), ("lid",), ("x",), "dja.l")
    ra = mod.IndexArrangement(("k",), ("rid",), ("y",), "dja.r")
    dj = mod.DeltaJoinExecutor(la, ra, ("k",), ("k",),
                               [("k", "k"), ("x", "x"), ("lid", "lid")],
                               [("y", "y"), ("rid", "rid")], out_cap=4)
    return la, ra, dj


def test_delta_join_emissions_match_reference():
    built = {True: _build(lookup), False: _build(ref_lookup)}
    n_emitted = 0
    for side, cols, ops in _stream():
        got = {}
        for port, (la, ra, dj) in built.items():
            c = _chunk(cols, ops, port)
            arr, feed = (la, dj.apply_left) if side == "l" else (ra, dj.apply_right)
            arr.apply(c)  # the base table's change reaches its index first
            got[port] = _rows(feed(c))
        assert got[True] == got[False]
        n_emitted += len(got[True])
    assert n_emitted > 20
    for i in (0, 1):
        port_arr, ref_arr = built[True][i], built[False][i]
        assert port_arr.rows == ref_arr.rows
        assert port_arr.by_prefix == ref_arr.by_prefix
        for k in range(6):
            key = lambda r: sorted(r.items())
            assert sorted(map(key, port_arr.lookup((k,)))) == sorted(
                map(key, ref_arr.lookup((k,))))


def test_index_arrangement_restore_rebuilds_prefix_map():
    port_la, _, _ = _build(lookup)
    ref_la, _, _ = _build(ref_lookup)
    for side, cols, ops in _stream(seed=3):
        if side == "l":
            port_la.apply(_chunk(cols, ops, True))
            ref_la.apply(_chunk(cols, ops, False))
    (pd,) = port_la.checkpoint_delta()
    (rd,) = ref_la.checkpoint_delta()
    live = lambda d, cols: {k: v[~d.tombstone] for k, v in cols.items()}  # noqa: E731
    fresh = lookup.IndexArrangement(("k",), ("lid",), ("x",), "dja.l")
    fresh.restore_state(pd.table_id, live(pd, pd.key_cols), live(pd, pd.value_cols))
    ref_fresh = ref_lookup.IndexArrangement(("k",), ("lid",), ("x",), "dja.l")
    ref_fresh.restore_state(rd.table_id, live(rd, rd.key_cols), live(rd, rd.value_cols))
    assert fresh.rows == ref_fresh.rows == ref_la.rows
    assert fresh.by_prefix == ref_fresh.by_prefix == ref_la.by_prefix


def test_null_join_key_never_matches():
    built = {True: _build(lookup), False: _build(ref_lookup)}
    for port, (la, ra, dj) in built.items():
        ra.apply(_chunk({"k": [0, 1], "y": [5, 6], "rid": [0, 1]}, [0, 0], port))
    got = {}
    for port, (la, ra, dj) in built.items():
        c = _chunk({"k": [0, 1], "x": [7, 8], "lid": [0, 1]}, [0, 0], port,
                   nulls={"k": np.array([True, False])})
        got[port] = _rows(dj.apply_left(c))
    assert got[True] == got[False] and len(got[True]) == 1


def _catalogs(key_type="int64"):
    """Tables a(k, x) and b(k, y) keyed by a hidden row id, with a
    CREATE INDEX on k of each, as the session registers them."""
    out = {}
    for port in (True, False):
        dt = DataType if port else RefDT
        sch = Schema if port else RefSchema
        kdt = dt.INT64 if key_type == "int64" else dt.FLOAT64
        cat = (Catalog if port else RefCatalog)({
            "a": sch([("k", kdt), ("x", dt.INT64)]),
            "b": sch([("k", kdt), ("y", dt.INT64)]),
        })
        mod = lookup if port else ref_lookup
        for name, base, rest in (("ia", "a", ("x",)), ("ib", "b", ("y",))):
            cat.indexes[name] = {
                "base": base, "cols": ("k",), "base_pk": ("_row_id",),
                "arrangement": mod.IndexArrangement(("k",), ("_row_id",), rest,
                                                    f"{name}.index"),
            }
        cat.enable_delta_join = True
        out[port] = cat
    return out


DJ_SQL = "CREATE MATERIALIZED VIEW dj AS SELECT a.k AS k, x, y FROM a JOIN b ON a.k = b.k"


def test_planner_delta_join_matches_reference():
    cats = _catalogs()
    plans = {True: StreamPlanner(cats[True], capacity=1 << 10, device="cpu").plan(DJ_SQL),
             False: RefPlanner(cats[False], capacity=1 << 10).plan(DJ_SQL)}
    for port, mv in plans.items():
        join = mv.pipeline.join
        assert type(join).__name__ == "DeltaJoinExecutor" and mv.delta_join
        assert join.left_arr is cats[port].indexes["ia"]["arrangement"]
        assert join.right_arr is cats[port].indexes["ib"]["arrangement"]
    p, r = plans[True], plans[False]
    assert [type(e).__name__ for e in p.pipeline.executors] == [
        type(e).__name__ for e in r.pipeline.executors]
    assert p.inputs == r.inputs == {"a": "left", "b": "right"}
    assert p.pipeline.join.left_out == r.pipeline.join.left_out
    assert p.pipeline.join.right_out == r.pipeline.join.right_out
    assert p.mview.pk == r.mview.pk and p.mview.columns == r.mview.columns
    assert {k: str(v).split(".")[-1] for k, v in p.schema.items()} == {
        k: str(v) for k, v in r.schema.items()}
    # drive both: each base delta reaches its index, then the join
    rng = np.random.default_rng(5)
    rid = {"a": 0, "b": 0}
    for _ in range(12):
        table = "a" if rng.random() < 0.5 else "b"
        n = int(rng.integers(1, 4))
        val = "x" if table == "a" else "y"
        cols = {"k": rng.integers(0, 4, n), val: rng.integers(0, 100, n),
                "_row_id": np.arange(rid[table], rid[table] + n)}
        rid[table] += n
        for port, mv in plans.items():
            c = _chunk(cols, [0] * n, port)
            cats[port].indexes["ia" if table == "a" else "ib"]["arrangement"].apply(c)
            (mv.pipeline.push_left if table == "a" else mv.pipeline.push_right)(c)
            mv.pipeline.barrier()
        assert p.mview.snapshot() == r.mview.snapshot()
    assert p.mview.snapshot()


def _declines_alike(cats, sql):
    with pytest.raises(Exception) as want:
        RefPlanner(cats[False], capacity=1 << 10).plan(sql)
    with pytest.raises(Exception) as got:
        StreamPlanner(cats[True], capacity=1 << 10, device="cpu").plan(sql)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    assert "subqueries" in str(got.value)  # fell through to the hash path


def test_delta_join_declines_float_keys_as_reference():
    _declines_alike(_catalogs(key_type="float64"), DJ_SQL)


def test_delta_join_declines_without_switch_or_index_as_reference():
    cats = _catalogs()
    for cat in cats.values():
        cat.enable_delta_join = False
    _declines_alike(cats, DJ_SQL)
    cats = _catalogs()
    _declines_alike(cats, "CREATE MATERIALIZED VIEW hj AS SELECT a.k AS k, x, y "
                          "FROM a JOIN b ON a.x = b.y")
