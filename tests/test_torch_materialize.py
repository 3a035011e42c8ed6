"""Kernel D parity: the device MV (``mv_step_fn``, ``_mv_rebuild``,
``DeviceMaterializeExecutor``) against ``risingwave_tpu.executors.materialize``.

Same numpy-seeded chunks into both; the port runs its plain PyTorch
versions. Every comparison is exact (integer pk and value lanes, bool
null lanes), down to the slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import materialize as ref
from risingwave_tpu.ops.hash_table import HashTable as RefTable
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import materialize as port
from risingwave_tpu_torch.ops.hash_table import HashTable

PK = ("k", "w")
COLS = ("x", "y")
REF_DT = {"k": jnp.int64, "w": jnp.int32, "x": jnp.int64, "y": jnp.int32}
PORT_DT = {"k": torch.int64, "w": torch.int32, "x": torch.int64, "y": torch.int32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chunk_data(rng, n, n_keys):
    cols = {
        "k": rng.integers(0, n_keys, n).astype(np.int64),  # repeated pks
        "w": rng.integers(0, 3, n).astype(np.int32),
        "x": rng.integers(-(10**12), 10**12, n).astype(np.int64),
        "y": rng.integers(0, 100, n).astype(np.int32),
    }
    ops = rng.choice([0, 1, 2, 3], n, p=[0.55, 0.15, 0.1, 0.2]).astype(np.int32)
    nulls = {"y": rng.random(n) < 0.2}
    return cols, ops, nulls


def _chunks(cols, ops, nulls, cap):
    return (
        RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls),
        StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu"),
    )


def _assert_same(rt, rstate, pt, pstate):
    rt, rstate = jax.device_get((rt, rstate))
    np.testing.assert_array_equal(pt.fp1.numpy().view(np.uint32), rt.fp1)
    np.testing.assert_array_equal(pt.live.numpy(), rt.live)
    for a, b in zip(pt.keys, rt.keys):
        np.testing.assert_array_equal(a.numpy(), b)
    for c in COLS:
        np.testing.assert_array_equal(pstate.values[c].numpy(), rstate.values[c])
    np.testing.assert_array_equal(pstate.vnulls["y"].numpy(), rstate.vnulls["y"])
    np.testing.assert_array_equal(pstate.sdirty.numpy(), rstate.sdirty)
    assert bool(pstate.dropped) == bool(rstate.dropped)


def _snapshot(table, state):
    live = np.flatnonzero(np.asarray(table.live))
    return {
        (int(np.asarray(table.keys[0])[i]), int(np.asarray(table.keys[1])[i])): (
            int(np.asarray(state.values["x"])[i]),
            None if np.asarray(state.vnulls["y"])[i] else int(np.asarray(state.values["y"])[i]),
        )
        for i in live
    }


def _states(cap):
    rt = RefTable.create(cap, (jnp.dtype(jnp.int64), jnp.dtype(jnp.int32)))
    rstate = ref.MvDeviceState(
        values={c: jnp.zeros(cap, REF_DT[c]) for c in COLS},
        vnulls={"y": jnp.zeros(cap, jnp.bool_)},
        sdirty=jnp.zeros(cap, jnp.bool_),
        stored=jnp.zeros(cap, jnp.bool_),
        dropped=jnp.zeros((), jnp.bool_),
    )
    pt = HashTable.create(cap, (torch.int64, torch.int32), device="cpu")
    pstate = port.MvDeviceState.create(cap, PORT_DT, COLS, ("y",), "cpu")
    return rt, rstate, pt, pstate


def test_mv_step_last_write_wins_and_deletes():
    rng = np.random.default_rng(31)
    rt, rstate, pt, pstate = _states(1 << 9)
    for _ in range(4):
        cols, ops, nulls = _chunk_data(rng, 150, 40)
        rc, pc = _chunks(cols, ops, nulls, 160)
        rt, rstate = ref.mv_step_fn(rt, rstate, rc, PK, COLS)
        pt, pstate = port.mv_step_fn(pt, pstate, pc, PK, COLS)
        _assert_same(rt, rstate, pt, pstate)
        assert _snapshot(pt, pstate) == _snapshot(rt, rstate)
    assert (pstate.scratch == -1).all()


def test_mv_step_overflow_latches_dropped():
    rng = np.random.default_rng(3)
    rt, rstate, pt, pstate = _states(16)
    cols, ops, nulls = _chunk_data(rng, 64, 10_000)
    ops[:] = 0
    rc, pc = _chunks(cols, ops, nulls, 64)
    rt, rstate = ref.mv_step_fn(rt, rstate, rc, PK, COLS)
    pt, pstate = port.mv_step_fn(pt, pstate, pc, PK, COLS)
    _assert_same(rt, rstate, pt, pstate)
    assert bool(pstate.dropped)


def test_mv_rebuild_keeps_snapshot():
    rng = np.random.default_rng(12)
    rt, rstate, pt, pstate = _states(1 << 8)
    cols, ops, nulls = _chunk_data(rng, 100, 60)
    rc, pc = _chunks(cols, ops, nulls, 128)
    rt, rstate = ref.mv_step_fn(rt, rstate, rc, PK, COLS)
    pt, pstate = port.mv_step_fn(pt, pstate, pc, PK, COLS)
    rt, rstate = ref._mv_rebuild(rt, rstate, 1 << 10)
    pt, pstate = port._mv_rebuild(pt, pstate, 1 << 10)
    assert pt.capacity == 1 << 10
    _assert_same(rt, rstate, pt, pstate)
    assert _snapshot(pt, pstate) == _snapshot(rt, rstate)


def test_executor_snapshot_growth_and_reference_import():
    rng = np.random.default_rng(5)
    kw = dict(pk=PK, columns=COLS, capacity=1 << 6, nullable=("y",))
    r = ref.DeviceMaterializeExecutor(schema_dtypes=REF_DT, **kw)
    p = port.DeviceMaterializeExecutor(schema_dtypes=PORT_DT, device="cpu", **kw)
    for i in range(6):
        cols, ops, nulls = _chunk_data(rng, 100, 200)
        rc, pc = _chunks(cols, ops, nulls, 128)
        r.apply(rc)
        p.apply(pc)
        if i % 2:
            r.on_barrier(None)
            p.on_barrier(None)
        assert p.snapshot() == r.snapshot()
    assert p.table.capacity == r.table.capacity > 1 << 6  # grew
    np.testing.assert_array_equal(p.to_numpy()["x"], r.to_numpy()["x"])
    # import the reference's state, then both take the same chunk
    q = port.DeviceMaterializeExecutor(schema_dtypes=PORT_DT, device="cpu", **kw)
    q.load_reference_state(jax.device_get({"table": r.table, "state": r.state}))
    cols, ops, nulls = _chunk_data(rng, 100, 300)
    rc, pc = _chunks(cols, ops, nulls, 128)
    r.apply(rc)
    q.apply(pc)
    _assert_same(r.table, r.state, q.table, q.state)
    assert q.snapshot() == r.snapshot()
