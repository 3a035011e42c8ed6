"""Kernel AC and the EOWC SortExecutor: the port's plain PyTorch
versions (``risingwave_tpu_torch/executors/sort.py``) against
``risingwave_tpu.executors.sort`` on JAX-CPU, on the same seeded inputs,
and the reference's own cases (``tests/test_sort_eowc.py``) run on both
packages.

Emissions compare row for row (the (ts, seq) order is the reference's),
arena lanes slot for slot, digests and checkpoint deltas exactly.
Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import sort as rs
from risingwave_tpu.executors.base import Watermark as RefWatermark
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import sort as ps
from risingwave_tpu_torch.executors.base import Watermark

DT_R = {"ts": jnp.int64, "v": jnp.int64}
DT_P = {"ts": torch.int64, "v": torch.int64}


def _pair(cols, cap, ops=None, nulls=None):
    ops = None if ops is None else np.asarray(ops, np.int32)
    return (RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls),
            StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu"))


def _same_outs(ref_outs, port_outs):
    assert len(ref_outs) == len(port_outs)
    for r, p in zip(ref_outs, port_outs):
        dr, dp = r.to_numpy(), p.to_numpy()
        assert sorted(dr) == sorted(dp)
        for k in dr:
            np.testing.assert_array_equal(dp[k], np.asarray(dr[k]), err_msg=k)


def _rows(chunks):
    out = []
    for c in chunks:
        d = c.to_numpy()
        out.extend(zip(d["ts"].tolist(), d["v"].tolist()))
    return out


def _both(capacity=32, table_id="srt", dt=(DT_R, DT_P), nullable=()):
    return (rs.SortExecutor("ts", dt[0], capacity=capacity, nullable=nullable,
                            table_id=table_id),
            ps.SortExecutor("ts", dt[1], capacity=capacity, nullable=nullable,
                            table_id=table_id, device="cpu"))


def _same_state(r, p):
    for n in r.names:
        np.testing.assert_array_equal(p.buf[n].numpy(), np.asarray(r.buf[n]))
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(r.valid))
    np.testing.assert_array_equal(p.seq.numpy(), np.asarray(r.seq))
    assert int(p.next_seq) == int(r.next_seq)
    assert p.state_digest() == r.state_digest()


def _same_deltas(rd, pd):
    assert len(rd) == len(pd)
    for r, p in zip(rd, pd):
        assert (p.table_id, p.key_order) == (r.table_id, r.key_order)
        assert p.key_cols.keys() == r.key_cols.keys()
        assert p.value_cols.keys() == r.value_cols.keys()
        for k in r.key_cols:
            np.testing.assert_array_equal(p.key_cols[k], np.asarray(r.key_cols[k]))
        for k in r.value_cols:
            np.testing.assert_array_equal(p.value_cols[k], np.asarray(r.value_cols[k]))
        np.testing.assert_array_equal(p.tombstone, np.asarray(r.tombstone))


def _wm(r, p, value):
    _, ro = r.on_watermark(RefWatermark("ts", value))
    _, po = p.on_watermark(Watermark("ts", value))
    _same_outs(ro, po)
    return po


def _apply(r, p, ts, v, cap=8, ops=None):
    rc, pc = _pair({"ts": np.asarray(ts, np.int64), "v": np.asarray(v, np.int64)}, cap, ops)
    assert r.apply(rc) == [] and p.apply(pc) == []


def _case_emits_closed_rows_in_order():
    r, p = _both()
    _apply(r, p, [30, 10, 20], [1, 2, 3])
    _apply(r, p, [5, 40, 10], [4, 5, 6])
    _apply(r, p, [], [])
    assert _rows(_wm(r, p, 25)) == [(5, 4), (10, 2), (10, 6), (20, 3)]
    _same_state(r, p)
    assert _rows(_wm(r, p, 100)) == [(30, 1), (40, 5)]
    assert _rows(_wm(r, p, 200)) == []


def _case_overflow_and_delete_raise():
    r, p = _both(capacity=4)
    _apply(r, p, [1, 2, 3], [0, 0, 0])
    _apply(r, p, [4, 5, 6], [0, 0, 0])  # exceeds capacity
    _same_state(r, p)
    for ex in (r, p):
        with pytest.raises(RuntimeError, match="overflow"):
            ex.on_barrier(None)
    r, p = _both(capacity=8)
    _apply(r, p, [1], [2], cap=4, ops=[1])
    for ex in (r, p):
        with pytest.raises(RuntimeError, match="append-only"):
            ex.on_barrier(None)


def _case_checkpoint_restore_roundtrip():
    r, p = _both()
    _apply(r, p, [30, 10, 20], [1, 2, 3])
    rd, pd = r.checkpoint_delta(), p.checkpoint_delta()
    _same_deltas(rd, pd)
    r2, p2 = _both()
    r2.restore_state("srt", rd[0].key_cols, rd[0].value_cols)
    p2.restore_state("srt", pd[0].key_cols, pd[0].value_cols)
    _same_state(r2, p2)
    assert _rows(_wm(r2, p2, 100)) == [(10, 2), (20, 3), (30, 1)]
    _apply(r2, p2, [10], [9])  # post-restore appends continue the seq order
    assert _rows(_wm(r2, p2, 200)) == [(10, 9)]


def _case_checkpoint_tombstones_emitted_rows():
    r, p = _both()
    _apply(r, p, [10, 30], [1, 2])
    _same_deltas(r.checkpoint_delta(), p.checkpoint_delta())
    _wm(r, p, 20)
    rd, pd = r.checkpoint_delta(), p.checkpoint_delta()
    _same_deltas(rd, pd)
    assert pd[0].tombstone.any()


@pytest.mark.parametrize("case", [
    _case_emits_closed_rows_in_order,
    _case_overflow_and_delete_raise,
    _case_checkpoint_restore_roundtrip,
    _case_checkpoint_tombstones_emitted_rows,
], ids=lambda f: f.__name__[6:])
def test_reference_case(case):
    """The four cases of ``tests/test_sort_eowc.py``, each run on both
    packages side by side: emissions, arena lanes, digests and deltas
    equal, and the reference's expected rows."""
    case()


def test_seeded_stream_with_nulls_ties_and_negative_times():
    """A seeded stream (negative and tied timestamps, a nullable lane, an
    int32 lane) through several watermarks, a checkpoint after each, and
    a restore that grows the arena: equal at every step."""
    rng = np.random.default_rng(5)
    dt = ({"ts": jnp.int64, "v": jnp.int64, "w": jnp.int32},
          {"ts": torch.int64, "v": torch.int64, "w": torch.int32})
    r, p = _both(capacity=64, dt=dt, nullable=("v",))
    wm = -40
    for step in range(6):
        n = int(rng.integers(5, 16))
        cols = {"ts": rng.integers(wm, wm + 60, n).astype(np.int64),
                "v": rng.integers(-9, 9, n).astype(np.int64),
                "w": rng.integers(0, 5, n).astype(np.int32)}
        nulls = {"v": rng.random(n) < 0.3}
        rc, pc = _pair(cols, 16, nulls=nulls)
        r.apply(rc)
        p.apply(pc)
        _same_state(r, p)
        wm += int(rng.integers(5, 25))
        _wm(r, p, wm)
        _same_state(r, p)
        _same_deltas(r.checkpoint_delta(), p.checkpoint_delta())
    rd, pd = r.checkpoint_delta(), p.checkpoint_delta()
    _same_deltas(rd, pd)
    # a restore of every live row into an arena a quarter as large grows it
    sel = np.flatnonzero(np.asarray(r.valid))
    keys = {"k0": np.asarray(r.seq)[sel]}
    vals = {f"v_{n}": np.asarray(r.buf[n])[sel] for n in r.names}
    vals["n_v"] = np.asarray(r.bnulls["v"])[sel].astype(np.uint8)
    r2 = rs.SortExecutor("ts", dt[0], capacity=max(1, len(sel) // 4), nullable=("v",))
    p2 = ps.SortExecutor("ts", dt[1], capacity=max(1, len(sel) // 4), nullable=("v",),
                         device="cpu")
    r2.restore_state("sort", keys, vals)
    p2.restore_state("sort", keys, vals)
    assert p2.capacity == r2.capacity >= len(sel)
    assert p2.state_digest() == r2.state_digest() == r.state_digest()
    _wm(r2, p2, wm + 100)
