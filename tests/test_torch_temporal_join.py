"""Temporal join (kernel AB on the card) on the CPU: the port's
``TemporalJoinExecutor`` over its ``DeviceMaterializeExecutor`` against
the reference's over its own, fed the same seeded chunks: inner and
left joins, NULL keys (never matching a real pk 0), MV rows deleted
(they must not match) and updated, the MV growing and rebuilding
between probes (the executor reads the MV's current table), a left key
of another dtype than the pk (cast first), a nullable MV column, and
the plain probe step lane for lane. ``valid`` and every null lane are
compared exactly everywhere, values where the row matched (a miss reads
slot cap - 1, whose content depends on placement).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor as RefMv
from risingwave_tpu.executors.temporal_join import TemporalJoinExecutor as RefTj
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
from risingwave_tpu_torch.executors.temporal_join import TemporalJoinExecutor
from risingwave_tpu_torch.types import Op
from test_torch_project_set import both

OUT = ("seller", "category", "name")


def make_mvs(cap):
    dt = {"id": torch.int64, "seller": torch.int64, "category": torch.int64, "name": torch.int32}
    rdt = {"id": jnp.int64, "seller": jnp.int64, "category": jnp.int64, "name": jnp.int32}
    mv = DeviceMaterializeExecutor(("id",), OUT, dt, capacity=cap, nullable=("category",),
                                   device="cpu")
    rmv = RefMv(("id",), OUT, rdt, capacity=cap, nullable=("category",))
    return mv, rmv


def right_chunk(rng, ids, ops=None, cap=None):
    n = len(ids)
    cols = {"id": np.asarray(ids, np.int64), "seller": rng.integers(0, 50, n).astype(np.int64),
            "category": rng.integers(0, 9, n).astype(np.int64),
            "name": rng.integers(0, 100, n).astype(np.int32)}
    return both(cols, cap or max(2, n), ops=ops, nulls={"category": rng.random(n) < 0.25})


def left_chunk(rng, n, cap, hi, key_dtype=np.int32):
    cols = {"auction": rng.integers(0, hi, n).astype(key_dtype),
            "price": rng.integers(1, 1000, n).astype(np.int64)}
    cols["auction"][:2] = 0  # key 0: a real pk below, and a NULL key's placeholder
    nulls = {"auction": rng.random(n) < 0.15}
    nulls["auction"][1] = True
    ops = rng.integers(0, 4, n).astype(np.int32)
    return both(cols, cap, ops=ops, nulls=nulls)


def assert_probe_equal(got, want, what):
    assert set(got.columns) == set(want.columns) and set(got.nulls) == set(want.nulls), what
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid, err_msg=what)
    np.testing.assert_array_equal(got.ops.numpy(), np.asarray(want.ops), err_msg=what)
    for n in want.nulls:
        np.testing.assert_array_equal(got.nulls[n].numpy(), np.asarray(want.nulls[n]),
                                      err_msg=f"{what} null {n}")
    for n in want.columns:
        g, w = got.col(n).numpy(), np.asarray(want.col(n))
        assert g.dtype == w.dtype, (what, n)
        seen = ~np.asarray(want.nulls[n]) if n in want.nulls else np.ones(len(w), bool)
        np.testing.assert_array_equal(g[seen], w[seen], err_msg=f"{what} {n}")


@pytest.mark.parametrize("jt", ["inner", "left"])
@pytest.mark.parametrize("seed", [11, 12])
def test_probe_matches_reference_through_deletes_and_growth(jt, seed):
    rng = np.random.default_rng(seed)
    mv, rmv = make_mvs(16)
    tj = TemporalJoinExecutor(mv, ("auction",), OUT, jt)
    rtj = RefTj(rmv, ("auction",), OUT, jt)
    next_id = 0
    for step in range(6):
        # the MV grows: new ids (id 0 among the first), then deletes and updates
        ids = np.arange(next_id, next_id + 20 + 10 * step)
        next_id = int(ids[-1]) + 1
        p, r = right_chunk(rng, ids)
        mv.apply(p)
        rmv.apply(r)
        if step >= 1:
            gone = rng.choice(next_id, 6, replace=False)
            ops = np.full(len(gone), int(Op.DELETE), np.int32)
            p, r = right_chunk(rng, gone, ops=ops)
            mv.apply(p)
            rmv.apply(r)
        if step % 2:
            mv.on_barrier(None)
            rmv.on_barrier(None)
            rmv.finish_barrier()
        lp, lr = left_chunk(rng, 40, 48, next_id + 5)
        (got,), (want,) = tj.apply(lp), rtj.apply(lr)
        assert_probe_equal(got, want, f"{jt} step {step}")
        # a NULL key never matches, even key 0 with a live pk 0
        assert not got.valid[1] or jt == "left"
        assert bool(got.nulls["seller"][1])
    assert mv.table.capacity > 16  # the MV rebuilt under the executor


def test_deleted_row_does_not_match_and_key_dtype_casts():
    rng = np.random.default_rng(13)
    mv, rmv = make_mvs(64)
    p, r = right_chunk(rng, [5, 6, 7])
    mv.apply(p)
    rmv.apply(r)
    p, r = right_chunk(rng, [6], ops=np.asarray([int(Op.DELETE)], np.int32))
    mv.apply(p)
    rmv.apply(r)
    cols = {"auction": np.asarray([5, 6, 7, 8], np.int32)}  # int32 against an int64 pk
    for jt in ("inner", "left"):
        lp, lr = both(cols, 4)
        (got,), (want,) = (TemporalJoinExecutor(mv, ("auction",), OUT, jt).apply(lp),
                           RefTj(rmv, ("auction",), OUT, jt).apply(lr))
        assert_probe_equal(got, want, jt)
        matched = ~got.nulls["seller"].numpy()
        assert matched.tolist() == [True, False, True, False]
        assert got.valid.numpy().tolist() == ([True, False, True, False] if jt == "inner"
                                              else [True] * 4)
    with pytest.raises(ValueError, match="inner/left"):
        TemporalJoinExecutor(mv, ("auction",), OUT, "full")
    with pytest.raises(ValueError, match="table pk"):
        TemporalJoinExecutor(mv, ("auction", "x"), OUT).apply(lp)


def test_plain_probe_step_lane_for_lane():
    """The plain step against ``_probe_step`` on one slot layout (the
    port's MV loaded with the reference's state, so slots agree and
    every lane compares, the miss gathers included)."""
    from risingwave_tpu.executors.temporal_join import _probe_step as ref_probe
    from risingwave_tpu_torch.executors.temporal_join import _probe_torch

    rng = np.random.default_rng(14)
    mv, rmv = make_mvs(64)
    p, r = right_chunk(rng, np.arange(30))
    rmv.apply(r)
    p, r = right_chunk(rng, np.arange(0, 30, 4), ops=np.full(8, int(Op.DELETE), np.int32))
    rmv.apply(r)
    mv.load_reference_state({"table": rmv.table, "state": rmv.state})
    lp, lr = left_chunk(rng, 24, 32, 40, np.int64)
    key_ok = ~lp.null_of("auction")
    rkey_ok = ~lr.null_of("auction")
    for jt in ("inner", "left"):
        got = _probe_torch(mv.table, mv.state.values, mv.state.vnulls, lp, (lp.col("auction"),),
                           key_ok, OUT, jt)
        want = ref_probe(rmv.table, rmv.state.values, rmv.state.vnulls, lr,
                         (lr.col("auction"),), rkey_ok, OUT, jt)
        for n in want.columns:
            np.testing.assert_array_equal(got.col(n).numpy(), np.asarray(want.col(n)),
                                          err_msg=n)
        for n in want.nulls:
            np.testing.assert_array_equal(got.nulls[n].numpy(), np.asarray(want.nulls[n]))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_host_map_right_side_is_not_ported():
    """Kept under its old name: a host-map right side (the host MV, now
    ported) is probed on the host as the reference's ``_probe_host``,
    lane for lane equal to it (``tests/test_torch_materialize_host.py``
    holds more cases); a right side that is neither MV still fails."""
    from risingwave_tpu.executors.materialize import MaterializeExecutor as RefHostMv
    from risingwave_tpu_torch.executors.materialize import MaterializeExecutor

    mv = MaterializeExecutor(("id",), ("x",), table_id="dim")
    rmv = RefHostMv(("id",), ("x",), table_id="dim")
    rp, rr = both({"id": np.arange(3), "x": np.array([7, 8, 9])}, 4)
    mv.apply(rp)
    rmv.apply(rr)
    lp, lr = both({"auction": np.array([2, 5])}, 2)
    for jt in ("inner", "left"):
        (got,) = TemporalJoinExecutor(mv, ("auction",), ("x",), jt).apply(lp)
        (want,) = RefTj(rmv, ("auction",), ("x",), jt).apply(lr)
        assert_probe_equal(got, want, jt)

    class HostMv:  # a right side that is not an MV
        pk = ("id",)

    with pytest.raises(AttributeError):
        TemporalJoinExecutor(HostMv(), ("auction",), ("x",)).apply(lp)
