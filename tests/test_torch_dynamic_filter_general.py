"""The general dynamic filter (``DynamicFilterExecutor``, kernel Z's
plain versions on the CPU) against ``risingwave_tpu``'s on JAX-CPU.

Mirrors ``tests/test_dynamic_filter.py`` (the randomized oracle over all
four comparators, the checkpoint round trip, an insert and its delete
in one right chunk), each step also held against the reference
executor: the emissions as multisets and the state digest equal. Adds a
chunk of U-/U+ pairs with an insert-then-delete of one pk (the row
store held against the reference lane for lane: on the CPU both place
every key in the same slot), a NULL right value, a growth, and a
restore followed by moves both ways. Every comparison is exact.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors.dynamic_filter import DynamicFilterExecutor as RefFilter
from risingwave_tpu.storage.object_store import MemObjectStore as RefStore
from risingwave_tpu.storage.state_table import CheckpointManager as RefManager
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.dynamic_filter import DynamicFilterExecutor
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore
from risingwave_tpu_torch.types import Op

DT_REF = {"id": jnp.int64, "v": jnp.int64}
DT = {"id": torch.int64, "v": torch.int64}
CMP = {">": np.greater, ">=": np.greater_equal, "<": np.less, "<=": np.less_equal}


def _pair(op=">", cap=1 << 9, table_id="df", dt_ref=DT_REF, dt=DT, pk=("id",), value="v"):
    ref = RefFilter(value, op, pk, dt_ref, capacity=cap, table_id=table_id)
    port = DynamicFilterExecutor(value, op, pk, dt, capacity=cap, table_id=table_id,
                                 device="cpu")
    return ref, port


def _chunks(cols, cap, ops=None, nulls=None):
    ops = None if ops is None else np.asarray(ops, np.int32)
    return (RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls),
            StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu"))


def _rows(outs, names=("id", "v")) -> Counter:
    got = Counter()
    for c in outs:
        d = c.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            got[(int(d["__op__"][i]),) + tuple(int(d[n][i]) for n in names)] += 1
    return got


def _left(ref, port, cols, cap, ops=None):
    rc, pc = _chunks(cols, cap, ops)
    want, got = _rows(ref.apply_left(rc)), _rows(port.apply_left(pc))
    assert got == want
    return got


def _right(ref, port, val=None, delete=False):
    ops = [int(Op.DELETE)] if delete else None
    rc, pc = _chunks({"v": np.asarray([0 if delete else val], np.int64)}, 4, ops)
    assert ref.apply_right(rc) == port.apply_right(pc) == []


def _barrier(ref, port):
    want, got = _rows(ref.on_barrier(None)), _rows(port.on_barrier(None))
    assert got == want
    assert port.state_digest() == ref.state_digest()
    return got


def _replay(state, rows: Counter):
    for (op, *row), k in rows.items():
        assert k == 1
        row = tuple(row)
        if op in (int(Op.DELETE), int(Op.UPDATE_DELETE)):
            assert row in state, f"retract of unemitted {row}"
            state.discard(row)
        else:
            assert row not in state, f"duplicate emit {row}"
            state.add(row)


@pytest.mark.parametrize("op", [">", ">=", "<", "<="])
def test_dynamic_filter_randomized_oracle(op):
    """Random left inserts and deletes interleaved with right moves both
    ways (and a retraction of the right value): the emissions equal the
    reference's at every step, replaying them gives the SQL filter over
    the live relation, and the digests stay equal."""
    ref, port = _pair(op, table_id=f"df_{op}")
    rng = np.random.default_rng(23)
    live, state, rv, next_id = {}, set(), None, 0
    for _ in range(15):
        ids, vs, ops = [], [], []
        for _ in range(int(rng.integers(2, 12))):
            if live and rng.random() < 0.35:
                i = int(rng.choice(list(live)))
                ids.append(i)
                vs.append(live.pop(i))
                ops.append(int(Op.DELETE))
            else:
                v = int(rng.integers(0, 100))
                ids.append(next_id)
                vs.append(v)
                ops.append(int(Op.INSERT))
                live[next_id] = v
                next_id += 1
        cols = {"id": np.asarray(ids, np.int64), "v": np.asarray(vs, np.int64)}
        _replay(state, _left(ref, port, cols, 16, ops))
        r = rng.random()
        if r < 0.45:
            rv = int(rng.integers(0, 100))
            _right(ref, port, rv)
        elif r < 0.55 and rv is not None:
            rv = None
            _right(ref, port, delete=True)
        _replay(state, _barrier(ref, port))
        want = set() if rv is None else {(i, v) for i, v in live.items() if CMP[op](v, rv)}
        assert state == want


def _store_lanes_equal(ref, port):
    """Slot for slot: the key table, the row lanes and the marks."""
    assert port.table.capacity == ref.table.capacity
    for k, rk in zip(port.table.keys, ref.table.keys):
        assert np.array_equal(k.numpy(), np.asarray(rk))
    pairs = [(port.table.live, ref.table.live), (port.passing, ref.passing),
             (port.sdirty, ref.sdirty), (port.rv, ref.rv), (port.rv_valid, ref.rv_valid)]
    pairs += [(port.rows[n], ref.rows[n]) for n in port.names]
    for got, want in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_update_pairs_and_insert_then_delete_lane_for_lane():
    """U-/U+ pairs of one pk side by side, an insert then a delete of one
    pk, and a delete then an insert of another in one chunk: the last row
    per pk writes every lane (rows, live, pass, sdirty), in the reference
    and in the port alike, and a torn pair passes unrewritten."""
    ref, port = _pair(">=", cap=64, table_id="dfu")
    cols = {"id": np.arange(8, dtype=np.int64), "v": np.asarray([5, 10, 15, 20, 25, 30, 35, 40])}
    _left(ref, port, cols, 8)
    _right(ref, port, 20)
    _barrier(ref, port)
    U_, U, I, D = (int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT), int(Op.INSERT),
                   int(Op.DELETE))
    ids = [1, 1, 3, 3, 6, 6, 100, 100, 7, 7, 101, 5]
    vals = [10, 22, 20, 12, 35, 36, 50, 50, 40, 41, 60, 25]
    ops = [U_, U, U_, U, U_, U, I, D, D, I, I, D]
    got = _left(ref, port, {"id": np.asarray(ids, np.int64), "v": np.asarray(vals, np.int64)},
                16, ops)
    # id 1: its U- fails, its U+ (22 >= 20) passes alone; id 3 the other way
    assert (U, 1, 22) in got and (U_, 1, 10) not in got and (U_, 3, 20) in got
    _store_lanes_equal(ref, port)
    _right(ref, port, 11)
    _barrier(ref, port)
    _store_lanes_equal(ref, port)
    _right(ref, port, 40)
    _barrier(ref, port)
    _store_lanes_equal(ref, port)


def test_right_chunk_insert_then_delete_nets_to_invalid():
    """Rows apply in order: an INSERT followed by its own DELETE in one
    right chunk leaves no right value, and everything retracts."""
    ref, port = _pair(">", cap=1 << 6, table_id="dford")
    state = set()
    _replay(state, _left(ref, port, {"id": np.asarray([1, 2], np.int64),
                                     "v": np.asarray([60, 80], np.int64)}, 4))
    _right(ref, port, 50)
    _replay(state, _barrier(ref, port))
    assert state == {(1, 60), (2, 80)}
    rc, pc = _chunks({"v": np.asarray([10, 10], np.int64)}, 4,
                     [int(Op.INSERT), int(Op.DELETE)])
    ref.apply_right(rc)
    port.apply_right(pc)
    _replay(state, _barrier(ref, port))
    assert state == set()


def test_null_right_value_is_its_placeholder():
    """``apply_right`` does not read the NULL lane (the reference's
    ``dynamic_filter.py:537-560``): a NULL right row is its lane's
    placeholder value, and that value is valid. SQL would pass nothing
    (``v > NULL`` is NULL); both packages pass every row above the
    placeholder (ROADMAP Queue 3, limits of the reference plan)."""
    ref, port = _pair(">", cap=1 << 6, table_id="dfnull")
    _left(ref, port, {"id": np.asarray([1, 2, 3], np.int64),
                      "v": np.asarray([-5, 0, 7], np.int64)}, 4)
    rc, pc = _chunks({"v": np.asarray([0], np.int64)}, 4, nulls={"v": np.asarray([True])})
    ref.apply_right(rc)
    port.apply_right(pc)
    got = _barrier(ref, port)
    assert got == Counter({(int(Op.INSERT), 3, 7): 1})
    assert bool(port.rv_valid) and int(port.rv) == 0


def test_null_left_column_is_refused():
    _, port = _pair(">", cap=1 << 6)
    _, pc = _chunks({"id": np.asarray([1], np.int64), "v": np.asarray([1], np.int64)}, 2,
                    nulls={"v": np.asarray([True])})
    with pytest.raises(ValueError, match="cannot be NULL"):
        port.apply_left(pc)


def test_growth_keeps_rows_and_flags():
    """A 64-slot store grows past its load factor through A and I while
    rows pass, retract and come back; the emissions and digests equal
    the reference's at every barrier and the capacities agree."""
    ref, port = _pair(">", cap=64, table_id="dfg")
    rng = np.random.default_rng(7)
    next_id = 0
    for step in range(8):
        n = 24
        cols = {"id": np.arange(next_id, next_id + n, dtype=np.int64),
                "v": rng.integers(0, 100, n).astype(np.int64)}
        next_id += n
        _left(ref, port, cols, 32)
        _right(ref, port, int(rng.integers(0, 100)))
        _barrier(ref, port)
        assert port.table.capacity == ref.table.capacity
    assert port.table.capacity > 64
    assert int(port.table.live.sum()) == next_id


def test_checkpoint_restore_then_moves_both_ways():
    """Kill and recover keeps the row store, the pass flags and the right
    value: after the restore a move down promotes and a move up retracts
    exactly (``tests/test_dynamic_filter.py:118``); the port's deltas
    equal the reference's, and each package recovers from its own store
    into the same state."""
    ref, port = _pair(">", cap=1 << 8, table_id="dfc")
    state = set()
    _replay(state, _left(ref, port, {"id": np.arange(6, dtype=np.int64),
                                     "v": np.asarray([5, 20, 35, 50, 65, 80], np.int64)}, 8))
    _right(ref, port, 40)
    _replay(state, _barrier(ref, port))
    assert state == {(3, 50), (4, 65), (5, 80)}
    rmgr, pmgr = RefManager(RefStore()), CheckpointManager(MemObjectStore())
    rd, pd = rmgr.stage([ref]), pmgr.stage([port])
    assert [d.table_id for d in pd] == [d.table_id for d in rd] == ["dfc.rows", "dfc.rv"]
    for a, b in zip(pd, rd):
        order_a, order_b = np.argsort(a.key_cols["k0"]), np.argsort(b.key_cols["k0"])
        assert set(a.value_cols) == set(b.value_cols)
        for k in a.value_cols:
            assert np.array_equal(np.asarray(a.value_cols[k])[order_a],
                                  np.asarray(b.value_cols[k])[order_b]), k
        assert np.array_equal(a.tombstone[order_a], np.asarray(b.tombstone)[order_b])
    rmgr.commit_staged(1, rd)
    pmgr.commit_staged(1, pd)
    ref, port = _pair(">", cap=1 << 8, table_id="dfc")
    rmgr.recover([ref])
    pmgr.recover([port])
    assert port.state_digest() == ref.state_digest()
    assert bool(port.rv_valid) and int(port.rv) == 40
    _right(ref, port, 10)
    _replay(state, _barrier(ref, port))
    assert state == {(1, 20), (2, 35), (3, 50), (4, 65), (5, 80)}
    _right(ref, port, 70)
    _replay(state, _barrier(ref, port))
    assert state == {(5, 80)}


def test_restored_store_leaves_room_for_the_next_chunk():
    """The restore sizes the store by ``grow_pow2`` of the configured
    capacity and the next chunks grow it before they land, so the table
    stays under its load factor (kernel A's probe bound holds)."""
    port = DynamicFilterExecutor("v", ">", ("id",), DT, capacity=64, table_id="dfr",
                                 device="cpu")
    n = 200
    port.apply_left(StreamChunk.from_numpy({"id": np.arange(n, dtype=np.int64),
                                            "v": np.arange(n, dtype=np.int64)}, 256,
                                           device="cpu"))
    mgr = CheckpointManager(MemObjectStore())
    mgr.commit_staged(1, mgr.stage([port]))
    port = DynamicFilterExecutor("v", ">", ("id",), DT, capacity=64, table_id="dfr",
                                 device="cpu")
    mgr.recover([port])
    assert port.table.occupancy() <= port.table.capacity // 2
    for lo in range(n, n + 600, 200):
        port.apply_left(StreamChunk.from_numpy({"id": np.arange(lo, lo + 200, dtype=np.int64),
                                                "v": np.arange(200, dtype=np.int64)}, 256,
                                               device="cpu"))
        assert int(port.table.occupancy()) <= port.table.capacity // 2
    assert int(port.table.live.sum()) == n + 600
