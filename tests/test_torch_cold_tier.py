"""The cold tier through the port (kernel AG's and R's plain versions on
the CPU) against ``risingwave_tpu`` on JAX-CPU:

- the ten cases of ``tests/test_cold_tier.py`` on both packages, with
  the reference's own assertions on each and the two packages'
  emissions, MV snapshots and counts equal. The three
  ``StreamingRuntime`` cases (``:116``, ``:165``, ``:462``) drive the
  reference's runtime as the reference test does; the port side is a
  ``Pipeline`` (or ``TwoInputPipeline``) with a ``CheckpointManager``
  committing after every barrier and the budget rule applied by hand
  (``budget_barrier``: over the budget, every armed executor evicts);
- AG's select and merge and R's fault-in lane for lane against the
  reference's jitted ``_evict``, ``_cold_merge`` and
  ``_fault_in_scatter`` and the masks of ``evict_cold`` and
  ``_evict_side``, on seeded states with NULLs, nullable and float keys,
  float MIN/MAX order keys, -0.0 and an overflowing fault-in;
- seeded q5, q8 and q5-max streams with a commit and an eviction after
  every barrier, equal to the reference's at every barrier (MV and
  store rows), fused equal to interpreted, and a kill after an eviction
  recovered to the uninterrupted run.

Tolerance: none. Integer lanes, MV snapshots, counts and store rows are
compared exactly; float sums fold the same operands in the same order
in both packages and are compared bit for bit too.
"""

import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import hash_agg as ref_agg_mod
from risingwave_tpu.executors.base import Watermark as RefWatermark
from risingwave_tpu.executors.hash_agg import HashAggExecutor as RefHashAgg
from risingwave_tpu.executors.hash_join import HashJoinExecutor as RefHashJoin
from risingwave_tpu.executors.materialize import MaterializeExecutor as RefMv
from risingwave_tpu.ops.agg import AggCall as RefCall
from risingwave_tpu.runtime import StreamingRuntime
from risingwave_tpu.runtime.pipeline import Pipeline as RefPipeline
from risingwave_tpu.runtime.pipeline import TwoInputPipeline as RefTwoInput
from risingwave_tpu.storage.object_store import MemObjectStore as RefStore
from risingwave_tpu.storage.state_table import CheckpointManager as RefManager
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Watermark
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor
from risingwave_tpu_torch.executors.materialize import MaterializeExecutor
from risingwave_tpu_torch.ops import cold_tier as ct
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.runtime.fused_step import (
    checkpointed_executors,
    cold_executors,
    expand_fused,
)
from risingwave_tpu_torch.runtime.pipeline import Pipeline, TwoInputPipeline
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore
from risingwave_tpu_torch.types import Op

CAP = 64


# -- the two packages behind one surface ---------------------------------------
@dataclasses.dataclass
class Pkg:
    """One package's constructors: ``chunk(cols, cap, ops)`` and the
    executors with the package's dtypes (``dt``) and device."""

    name: str
    chunk: object
    agg: object
    join: object
    mv: object
    call: object
    wm: object
    manager: object
    store: object
    i64: object
    f64: object


REF = Pkg("ref", lambda cols, cap, ops=None: RefChunk.from_numpy(cols, cap, ops=ops),
          RefHashAgg, RefHashJoin, RefMv, RefCall, RefWatermark, RefManager, RefStore,
          jnp.int64, jnp.float64)
PORT = Pkg("port", lambda cols, cap, ops=None: StreamChunk.from_numpy(cols, cap, ops=ops,
                                                                     device="cpu"),
           partial(HashAggExecutor, device="cpu"), partial(HashJoinExecutor, device="cpu"),
           MaterializeExecutor, AggCall, Watermark, CheckpointManager, MemObjectStore,
           torch.int64, torch.float64)


def kv_chunk(pkg, rows, cap=CAP):
    return pkg.chunk({"k": np.asarray([r[0] for r in rows], np.int64),
                      "v": np.asarray([r[1] for r in rows], np.int64)},
                     cap, ops=np.asarray([r[2] for r in rows], np.int32))


def replay(snap, chunks, cols):
    """Fold emitted chunks into ``{(k,): row}`` as downstream would."""
    for c in chunks:
        d = c.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            key = (int(d["k"][i]),)
            if d["__op__"][i] in (Op.DELETE, Op.UPDATE_DELETE):
                snap.pop(key, None)
            else:
                row = []
                for n in cols:
                    nl = d.get(n + "__null")
                    row.append(None if nl is not None and nl[i] else int(d[n][i]))
                snap[key] = tuple(row)
    return snap


def armed(ex, mgr):
    """Arm an executor's cold tier on ``mgr``'s store, as the runtime does."""
    if hasattr(ex, "cold_get_rows"):
        ex.cold_get_rows = mgr.get_rows
    else:
        ex.cold_reader = lambda keys, tid=ex.table_id: mgr.get_rows(tid, keys)
    return ex


def budget_barrier(pipeline, mgr, budget: int) -> int:
    """The port's stand-in for the reference runtime's barrier with a
    memory budget (``runtime.py:1478-1497``): the barrier, a commit,
    then, over the budget, ``evict_cold`` on every armed executor.
    Returns the groups or keys evicted."""
    pipeline.barrier()
    executors = expand_fused(pipeline.executors)
    mgr.commit_epoch(pipeline.epoch, executors)
    total = sum(ex.state_nbytes() for ex in executors if hasattr(ex, "state_nbytes"))
    if total <= budget:
        return 0
    return sum(ex.evict_cold() for ex in executors
               if hasattr(ex, "evict_cold") and (getattr(ex, "cold_reader", None) is not None
                                                 or getattr(ex, "cold_get_rows", None)
                                                 is not None))


def both(case):
    """Run ``case(pkg)`` on each package; their results must be equal."""
    got = {p.name: case(p) for p in (REF, PORT)}
    assert got["port"] == got["ref"]
    return got["port"]


# -- the ten cases of tests/test_cold_tier.py -------------------------------------
def mk_agg(pkg, cap=1 << 12):
    return pkg.agg(group_keys=("k",),
                   calls=(pkg.call("count_star", None, "cnt"), pkg.call("sum", "v", "s")),
                   schema_dtypes={"k": pkg.i64, "v": pkg.i64}, capacity=cap, out_cap=1 << 10,
                   table_id="cold1")


def test_evict_then_merge_on_return():
    def case(pkg):
        store = pkg.store()
        mgr = pkg.manager(store)
        ex = armed(mk_agg(pkg), mgr)
        snap = {}
        rows = [(k, k * 3, Op.INSERT) for k in range(500)]
        for at in range(0, len(rows), CAP):
            replay(snap, ex.apply(kv_chunk(pkg, rows[at:at + CAP])), ("cnt", "s"))
        replay(snap, ex.on_barrier(None), ("cnt", "s"))
        mgr.commit_epoch(1 << 16, [ex])
        before = ex.state_nbytes()
        evicted = ex.evict_cold()
        assert evicted == 500
        after = ex.state_nbytes()
        assert after < before
        assert int(ex.table.occupancy()) == 0
        upd = [(k, 1, Op.INSERT) for k in range(40)]
        upd += [(k, k * 3, Op.DELETE) for k in range(5)]
        upd += [(k, 7, Op.INSERT) for k in range(1000, 1010)]
        replay(snap, ex.apply(kv_chunk(pkg, upd[:CAP])), ("cnt", "s"))
        replay(snap, ex.apply(kv_chunk(pkg, upd[CAP:])), ("cnt", "s"))
        replay(snap, ex.on_barrier(None), ("cnt", "s"))
        want = {}
        for k in range(500):
            cnt, s = 1, k * 3
            if k < 40:
                cnt, s = cnt + 1, s + 1
            if k < 5:
                cnt, s = cnt - 1, s - k * 3
            want[(k,)] = (cnt, s)
        for k in range(1000, 1010):
            want[(k,)] = (1, 7)
        assert snap == want
        mgr.commit_epoch(2 << 16, [ex])
        ex2 = mk_agg(pkg)
        pkg.manager(store).recover([ex2])
        snap2 = {}
        replay(snap2, ex2.on_barrier(None), ("cnt", "s"))
        assert snap2 == {}
        replay(snap2, ex2.apply(kv_chunk(pkg, [(3, 100, Op.INSERT)])), ("cnt", "s"))
        replay(snap2, ex2.on_barrier(None), ("cnt", "s"))
        assert snap2[(3,)][0] == want[(3,)][0] + 1
        return snap, snap2, evicted

    both(case)


def test_runtime_memory_budget_triggers_eviction():
    def case(pkg):
        agg = mk_agg(pkg)
        mv = pkg.mv(pk=("k",), columns=("cnt", "s"), table_id="cold1.mv")
        if pkg is REF:
            rt = StreamingRuntime(RefStore(), async_checkpoint=False, memory_budget_bytes=1)
            rt.register("f", RefPipeline([agg, mv]))
            rt.push("f", kv_chunk(pkg, [(k, k, Op.INSERT) for k in range(50)]))
            rt.barrier()
            occ = int(agg.table.occupancy())
            rt.push("f", kv_chunk(pkg, [(7, 5, Op.INSERT)]))
            rt.barrier()
        else:
            mgr = CheckpointManager(MemObjectStore())
            armed(agg, mgr)
            mv.checkpoint_enabled = True
            pipe = Pipeline([agg, mv])
            pipe.push(kv_chunk(pkg, [(k, k, Op.INSERT) for k in range(50)]))
            budget_barrier(pipe, mgr, 1)
            occ = int(agg.table.occupancy())
            pipe.push(kv_chunk(pkg, [(7, 5, Op.INSERT)]))
            budget_barrier(pipe, mgr, 1)
        assert occ == 0
        assert mv.snapshot()[(7,)] == (2, 12)
        return mv.snapshot()

    both(case)


def test_cold_min_max_merge_append_only():
    def case(pkg):
        mgr = pkg.manager(pkg.store())
        ex = armed(pkg.agg(group_keys=("k",),
                           calls=(pkg.call("min", "v", "mn"), pkg.call("max", "v", "mx")),
                           schema_dtypes={"k": pkg.i64, "v": pkg.i64}, capacity=1 << 10,
                           out_cap=1 << 9, table_id="cold1"), mgr)
        snap = {}
        replay(snap, ex.apply(kv_chunk(pkg, [(1, 50, Op.INSERT), (1, 10, Op.INSERT)])),
               ("mn", "mx"))
        replay(snap, ex.on_barrier(None), ("mn", "mx"))
        mgr.commit_epoch(1 << 16, [ex])
        assert ex.evict_cold() == 1
        replay(snap, ex.apply(kv_chunk(pkg, [(1, 30, Op.INSERT), (1, 99, Op.INSERT)])),
               ("mn", "mx"))
        replay(snap, ex.on_barrier(None), ("mn", "mx"))
        assert snap[(1,)] == (10, 99)
        return snap

    both(case)


def mk_join(pkg, tid, left=("lk", "lv"), right=("rk", "rv"), dt=None, **kw):
    dt = dt or pkg.i64
    return pkg.join((left[0],), (right[0],), {left[0]: dt, left[1]: pkg.i64},
                    {right[0]: dt, right[1]: pkg.i64}, table_id=tid, **kw)


def join_chunk(pkg, names, ks, vs, cap=32, kdt=np.int64):
    return pkg.chunk({names[0]: np.asarray(ks, kdt), names[1]: np.asarray(vs, np.int64)}, cap)


def test_join_cold_tier_eviction_and_fault_in():
    def case(pkg):
        mk = lambda tid: mk_join(pkg, tid, capacity=1 << 10, fanout=8, out_cap=1 << 12)
        mk_mv = lambda tid: pkg.mv(pk=("lk", "lv", "rk", "rv"), columns=(), table_id=tid)
        store = pkg.store()
        j, mv = mk("cj"), mk_mv("cj.mv")
        if pkg is REF:
            rt = StreamingRuntime(store, async_checkpoint=False, memory_budget_bytes=1)
            rt.register("j", RefTwoInput([], [], j, [mv]))
        else:
            mgr = CheckpointManager(store)
            armed(j, mgr)
            mv.checkpoint_enabled = True
            pipe = TwoInputPipeline([], [], j, [mv])
        twin, twin_mv = mk("cj_twin"), mk_mv("twin.mv")
        rng = np.random.default_rng(41)
        seen, evicted_sizes = [], []
        for epoch in range(8):
            ks = [int(rng.choice(seen)) if seen and rng.random() < 0.5
                  else int(rng.integers(0, 64)) + 100 * epoch for _ in range(6)]
            seen.extend(ks)
            lvs = rng.integers(0, 9, 6).tolist()
            rvs = rng.integers(0, 9, 6).tolist()
            lc, rc = (join_chunk(pkg, ("lk", "lv"), ks, lvs),
                      join_chunk(pkg, ("rk", "rv"), ks, rvs))
            if pkg is REF:
                rt.push("j", lc, side="left")
                rt.push("j", rc, side="right")
                rt.barrier()
            else:
                pipe.push_left(lc)
                pipe.push_right(rc)
                budget_barrier(pipe, mgr, 1)
            for out in twin.apply_left(lc):
                twin_mv.apply(out)
            for out in twin.apply_right(rc):
                twin_mv.apply(out)
            twin.on_barrier(None)
            twin_mv.on_barrier(None)
            assert j._evicted["left"] or j._evicted["right"] or epoch == 0
            evicted_sizes.append((len(j._evicted["left"]), len(j._evicted["right"])))
        assert mv.snapshot() == twin_mv.snapshot()
        assert len(mv.snapshot()) > 20
        j2, mv2 = mk("cj"), mk_mv("cj.mv")
        if pkg is REF:
            rt.wait_compaction()
            rt2 = StreamingRuntime(store, async_checkpoint=False)
            rt2.register("j", RefTwoInput([], [], j2, [mv2]), backfill=False)
            rt2.recover()
        else:
            mgr2 = CheckpointManager(store)
            mgr2.recover([j2, mv2])
            armed(j2, mgr2)
            pipe2 = TwoInputPipeline([], [], j2, [mv2])
        assert mv2.snapshot() == twin_mv.snapshot()
        lc = join_chunk(pkg, ("lk", "lv"), seen[:5], [7] * 5)
        if pkg is REF:
            rt2.push("j", lc, side="left")
            rt2.barrier()
        else:
            pipe2.push_left(lc)
            budget_barrier(pipe2, mgr2, 1 << 40)
        for out in twin.apply_left(lc):
            twin_mv.apply(out)
        twin.on_barrier(None)
        assert mv2.snapshot() == twin_mv.snapshot()
        return mv2.snapshot(), evicted_sizes

    both(case)


def window_join(pkg, tid):
    return mk_join(pkg, tid, left=("lw", "lv"), right=("rw", "rv"), capacity=1 << 8, fanout=4,
                   out_cap=1 << 9, window_cols=("lw", "rw"))


def emitted(outs, cols):
    d = outs[0].to_numpy(with_ops=True)
    return [tuple(int(d[c][i]) for c in cols) for i in range(len(d[cols[0]]))]


def test_join_evicted_keys_expire_under_watermark():
    def case(pkg):
        mgr = pkg.manager(pkg.store())
        j = window_join(pkg, "wj")
        j.cold_get_rows = mgr.get_rows
        j.apply_left(join_chunk(pkg, ("lw", "lv"), [10, 20], [1, 2], cap=8))
        j.on_barrier(None)
        mgr.commit_staged(1, mgr.stage([j]))
        assert j.evict_cold() == 2
        j.on_watermark(pkg.wm("lw", 15))
        j.on_watermark(pkg.wm("rw", 15))
        assert j._evicted["left"] == {(20,)}
        outs = j.apply_right(join_chunk(pkg, ("rw", "rv"), [10], [9], cap=8))
        assert len(outs[0].to_numpy(with_ops=True)["__op__"]) == 0
        j.on_barrier(None)
        mgr.commit_staged(2, mgr.stage([j]))
        j2 = window_join(pkg, "wj")
        mgr.recover([j2])
        outs = j2.apply_right(join_chunk(pkg, ("rw", "rv"), [10, 20], [9, 9], cap=8))
        rows = set(emitted(outs, ("lw", "lv")))
        assert rows == {(20, 2)}
        return rows

    both(case)


def test_cold_tombstone_dropped_when_key_recreated_late():
    def case(pkg):
        mgr = pkg.manager(pkg.store())
        j = window_join(pkg, "lj")
        j.cold_get_rows = mgr.get_rows
        j.apply_left(join_chunk(pkg, ("lw", "lv"), [10], [1], cap=8))
        j.on_barrier(None)
        mgr.commit_staged(1, mgr.stage([j]))
        assert j.evict_cold() == 1
        j.on_watermark(pkg.wm("lw", 15))
        j.on_watermark(pkg.wm("rw", 15))
        j.apply_left(join_chunk(pkg, ("lw", "lv"), [10], [5], cap=8))
        j.on_barrier(None)
        mgr.commit_staged(2, mgr.stage([j]))
        found, _ = mgr.get_rows("lj.left", {"k0": np.asarray([10], np.int64)})
        assert found[0]
        j2 = window_join(pkg, "lj")
        mgr.recover([j2])
        outs = j2.apply_right(join_chunk(pkg, ("rw", "rv"), [10], [9], cap=8))
        rows = emitted(outs, ("lw", "lv"))
        assert rows == [(10, 5)]
        return rows

    both(case)


def mk_mi(pkg, table_id, **kw):
    calls = kw.pop("calls", (pkg.call("min", "v", "mn", materialized=True),
                             pkg.call("max", "v", "mx", materialized=True),
                             pkg.call("count_star", None, "cnt")))
    kw.setdefault("capacity", 1 << 10)
    return pkg.agg(group_keys=("k",), calls=calls, schema_dtypes={"k": pkg.i64, "v": pkg.i64},
                   table_id=table_id, **kw)


def test_minput_min_max_evicts_and_faults_in_on_touch():
    MI = ("mn", "mx", "cnt")

    def case(pkg):
        store = pkg.store()
        mgr = pkg.manager(store)
        ex = armed(mk_mi(pkg, "coldmi", out_cap=1 << 10), mgr)
        snap = {}
        rows = [(k, v, Op.INSERT) for k in range(100) for v in (k, k + 50, k + 90)]
        for at in range(0, len(rows), CAP):
            replay(snap, ex.apply(kv_chunk(pkg, rows[at:at + CAP])), MI)
        replay(snap, ex.on_barrier(None), MI)
        mgr.commit_epoch(1 << 16, [ex])
        assert ex.evict_cold() == 100
        assert int(ex.table.occupancy()) == 0
        assert len(ex._evicted) == 100
        replay(snap, ex.apply(kv_chunk(pkg, [(k, k, Op.DELETE) for k in range(30)])), MI)
        replay(snap, ex.on_barrier(None), MI)
        for k in range(30):
            assert snap[(k,)] == (k + 50, k + 90, 2), (k, snap[(k,)])
        for k in range(30, 100):
            assert snap[(k,)] == (k, k + 90, 3)
        assert len(ex._evicted) == 70
        left = sorted(ex._evicted)
        mgr.commit_epoch(2 << 16, [ex])
        ex2 = mk_mi(pkg, "coldmi", out_cap=1 << 10)
        pkg.manager(store).recover([ex2])
        assert ex2._evicted == set()
        snap2 = dict(snap)
        replay(snap2, ex2.apply(kv_chunk(pkg, [(5, 55, Op.DELETE)])), MI)
        replay(snap2, ex2.on_barrier(None), MI)
        assert snap2[(5,)] == (95, 95, 1)
        return snap, snap2, left

    both(case)


def test_runtime_budget_evicts_minput_state():
    def case(pkg):
        agg = mk_mi(pkg, "coldmib", calls=(pkg.call("min", "v", "mn", materialized=True),))
        rows = [(k, k, Op.INSERT) for k in range(50)]
        if pkg is REF:
            rt = StreamingRuntime(RefStore(), async_checkpoint=False, memory_budget_bytes=1)
            rt.register("mi", RefPipeline([agg]))
            rt.push("mi", kv_chunk(pkg, rows))
            rt.barrier()
        else:
            mgr = CheckpointManager(MemObjectStore())
            armed(agg, mgr)
            pipe = Pipeline([agg])
            pipe.push(kv_chunk(pkg, rows))
            budget_barrier(pipe, mgr, 1)
        assert int(agg.table.occupancy()) == 0
        assert len(agg._evicted) == 50
        snap = {}
        replay(snap, agg.apply(kv_chunk(pkg, [(7, 3, Op.INSERT)])), ("mn",))
        replay(snap, agg.on_barrier(None), ("mn",))
        assert snap[(7,)] == (3,)
        return snap, sorted(agg._evicted)

    both(case)


def test_float_keyed_join_cold_tier():
    def case(pkg):
        mgr = pkg.manager(pkg.store())
        j = mk_join(pkg, "coldf.j", left=("fk", "a"), right=("fk2", "b"), dt=pkg.f64,
                    capacity=1 << 8, fanout=4, out_cap=1 << 8)
        j.cold_get_rows = mgr.get_rows
        j.apply_left(join_chunk(pkg, ("fk", "a"), [0.5, 1.25, 2.75], [1, 2, 3],
                                kdt=np.float64))
        j.on_barrier(None)
        mgr.commit_epoch(1 << 16, [j])
        assert j.evict_cold() == 3
        assert len(j._evicted["left"]) == 3
        outs = j.apply_right(join_chunk(pkg, ("fk2", "b"), [1.25], [9], kdt=np.float64))
        d = outs[0].to_numpy()
        assert len(d["b"]) == 1 and int(d["a"][0]) == 2
        assert float(d["fk"][0]) == 1.25
        assert len(j._evicted["left"]) == 2
        j._expire_evicted("left", 0, 1.0)
        assert len(j._evicted["left"]) == 1
        return sorted(j._evicted["left"])

    both(case)


def test_evicted_minput_groups_expire_under_watermark():
    def case(pkg):
        mgr = pkg.manager(pkg.store())
        ex = armed(mk_mi(pkg, "coldexp", calls=(pkg.call("min", "v", "mn", materialized=True),),
                         capacity=1 << 8, window_key=("k", 0, True)), mgr)
        snap = {}
        replay(snap, ex.apply(kv_chunk(pkg, [(1000, 5, Op.INSERT), (2000, 7, Op.INSERT)])),
               ("mn",))
        replay(snap, ex.on_barrier(None), ("mn",))
        mgr.commit_epoch(1 << 16, [ex])
        assert ex.evict_cold() == 2 and len(ex._evicted) == 2
        _, outs = ex.on_watermark(pkg.wm("k", 1500))
        replay(snap, outs, ("mn",))
        replay(snap, ex.on_barrier(None), ("mn",))
        assert (1000,) not in snap
        assert snap[(2000,)] == (7,)
        assert all(t[0] >= 1500 for t in ex._evicted)
        return snap, sorted(ex._evicted)

    both(case)


# -- AG's and R's plain versions lane for lane ---------------------------------------
LANE_CALLS = (
    ("count_star", None, "n", False), ("count", "v", "cv", False), ("sum", "v", "sv", False),
    ("sum", "f", "sf", False), ("sum", "h", "sh", False), ("min", "f", "mnf", False),
    ("max", "h", "mxh", False), ("min", "v", "mnv", False), ("max", "w", "mxw", False),
    ("max", "v", "mxm", True),
)
LANE_REF_DT = {"k": jnp.float64, "g": jnp.int32, "v": jnp.int64, "w": jnp.int32,
               "f": jnp.float64, "h": jnp.float32}
LANE_PORT_DT = {"k": torch.float64, "g": torch.int32, "v": torch.int64, "w": torch.int32,
                "f": torch.float64, "h": torch.float32}
KEY_VALUES = np.array([-0.0, 0.0, 0.5, 1.25, -3.0, 7.0, 1e300])


def lane_agg(pkg, cap, table_id="lanes"):
    dt = LANE_REF_DT if pkg is REF else LANE_PORT_DT
    calls = tuple(pkg.call(k, i, o, materialized=m) for k, i, o, m in LANE_CALLS)
    return pkg.agg(group_keys=("k", "g"), calls=calls, schema_dtypes=dt, capacity=cap,
                   out_cap=1 << 8, nullable_keys=("k",), minput_k=8, table_id=table_id)


def lane_chunk(pkg, rng, n, cap=64):
    f = rng.standard_normal(n) * 100
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.05] = np.nan
    cols = {"k": rng.choice(KEY_VALUES, n), "g": rng.integers(0, 12, n).astype(np.int32),
            "v": rng.integers(-10**12, 10**12, n), "w": rng.integers(-999, 999, n).astype(np.int32),
            "f": f, "h": (rng.standard_normal(n) * 10).astype(np.float32)}
    nulls = {"k": rng.random(n) < 0.15, "v": rng.random(n) < 0.1, "f": rng.random(n) < 0.1}
    if pkg is REF:
        return RefChunk.from_numpy(cols, cap, nulls=nulls)
    return StreamChunk.from_numpy(cols, cap, nulls=nulls, device="cpu")


def ref_agg_arrays(ex):
    import jax

    return {"table": jax.device_get(ex.table), "state": jax.device_get(ex.state),
            "minput": jax.device_get(ex.minput), "dropped": bool(ex.dropped),
            "mi_bad": bool(ex.mi_bad)}


def seeded_agg_pair(seed):
    """The reference's agg after a commit, a flushed epoch and an
    unflushed chunk (durable, sdirty, dirty and fresh groups side by
    side), and the port's with the same state."""
    rng = np.random.default_rng(seed)
    mgr = RefManager(RefStore())
    ref = lane_agg(REF, 1 << 8)
    streams = [lane_chunk(REF, np.random.default_rng(seed + i), 64) for i in range(3)]
    ref.apply(streams[0])
    ref.on_barrier(None)
    mgr.commit_epoch(1 << 16, [ref])
    ref.apply(streams[1])
    ref.on_barrier(None)
    ref.apply(streams[2])
    port = lane_agg(PORT, 1 << 8)
    port.load_reference_state(ref_agg_arrays(ref))
    return ref, port, mgr, rng


def assert_agg_equal(ref, port, table=True):
    """Every lane of the port's agg equal to the reference's, float
    MIN/MAX keys in the reference's unsigned dtypes."""
    from risingwave_tpu_torch.ops.agg import order_key_to_reference

    fx = dict(port._float_extremes)
    r = ref_agg_arrays(ref)
    rs, ps = r["state"], port.state
    np.testing.assert_array_equal(ps.row_count.numpy(), rs.row_count)
    for group in ("accums", "emitted"):
        for name, lane in getattr(ps, group).items():
            a = lane.numpy()
            if name in fx:
                a = order_key_to_reference(a, np.dtype(str(fx[name]).split(".")[1]))
            np.testing.assert_array_equal(a, getattr(rs, group)[name], err_msg=name)
    for group in ("nonnull", "emitted_isnull"):
        for name, lane in getattr(ps, group).items():
            np.testing.assert_array_equal(lane.numpy(), getattr(rs, group)[name], err_msg=name)
    for name in ("emitted_valid", "dirty", "sdirty", "stored", "minmax_retracted"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), getattr(rs, name),
                                      err_msg=name)
    for name, (v, c) in port.minput.items():
        rv, rc = r["minput"][name]
        np.testing.assert_array_equal(c.numpy(), rc, err_msg=name)
        np.testing.assert_array_equal(v.numpy(), rv, err_msg=name)
    if table:
        t = r["table"]
        np.testing.assert_array_equal(port.table.fp1.numpy(), np.asarray(t.fp1).view(np.int32))
        np.testing.assert_array_equal(port.table.live.numpy(), t.live)
        for a, b in zip(port.table.keys, t.keys):
            np.testing.assert_array_equal(a.numpy(), b)
    assert bool(port.dropped) == bool(ref.dropped)


@pytest.mark.parametrize("seed", [3, 17])
def test_select_and_rebuild_equal_reference_evict(seed):
    """AG's select (the hot mask, the durable keys, the counts) and the
    rebuild behind it equal the reference's ``evict_cold`` and ``_evict``
    slot for slot, the multisets and the recorded keys included."""
    ref, port, _, _ = seeded_agg_pair(seed)
    st, t = port.state, port.table
    got = ct.cold_select(ct.AGG, t.fp1, t.live, st.sdirty, st.stored, ev=st.emitted_valid,
                         dirty=st.dirty)
    rs, rt = ref.state, ref.table
    durable = np.asarray((rt.fp1 != 0) & rs.stored & ~rs.sdirty & ~rs.dirty)
    hot = np.asarray((rt.live | rs.emitted_valid | rs.dirty | rs.sdirty) & (rt.fp1 != 0)
                     & ~(rs.stored & ~rs.sdirty & ~rs.dirty))
    assert 0 < durable.sum() and 0 < hot.sum()
    np.testing.assert_array_equal(got.sel.numpy(), np.flatnonzero(durable))
    np.testing.assert_array_equal(got.hot.numpy(), hot)
    assert got.n_hot == int(hot.sum())
    ref.cold_reader = port.cold_reader = lambda keys: (np.zeros(0, bool), {})
    n_ref, n_port = ref.evict_cold(), port.evict_cold()
    assert n_port == n_ref == got.n_counted
    assert port._evicted == ref._evicted and len(port._evicted) == durable.sum()
    assert port.table.capacity == ref.table.capacity
    assert_agg_equal(ref, port)
    assert port.state_nbytes() == ct.tensor_nbytes(
        (port.table, port.state, port.minput))


def cold_rows(rng, ref, n):
    """Seeded stored rows of ``n`` groups in the reference's dtypes: every
    lane of a checkpoint row but the multisets, with -0.0 and NaN in the
    float sums and float MIN/MAX as unsigned order keys."""
    rs = ref.state
    out = {"row_count": rng.integers(-3, 9, n).astype(np.int64),
           "ev": rng.random(n) < 0.6}
    for name, a in rs.accums.items():
        dt = np.dtype(a.dtype)
        if dt.kind == "u":
            v = rng.integers(0, np.iinfo(dt).max, n, dtype=dt)
        elif dt.kind == "f":
            v = (rng.standard_normal(n) * 1e3).astype(dt)
            v[rng.random(n) < 0.2] = -0.0
            v[rng.random(n) < 0.05] = np.nan
        else:
            v = rng.integers(np.iinfo(dt).min // 2, np.iinfo(dt).max // 2, n).astype(dt)
        out[f"acc_{name}"] = v
        out[f"em_{name}"] = np.roll(v, 1)
    for name in rs.nonnull:
        out[f"nn_{name}"] = rng.integers(0, 5, n).astype(np.int64)
        out[f"ei_{name}"] = rng.random(n) < 0.3
    return out


@pytest.mark.parametrize("seed", [5, 23])
def test_merge_equals_reference_cold_merge(seed):
    """AG's merge over every call kind and dtype (COUNT/SUM add in int64,
    float64 and float32, MIN/MAX on int lanes and float order keys, the
    non-null counts add, the snapshots replace) and ``live`` after it
    equal the reference's ``_cold_merge`` and its ``set_live``."""
    from risingwave_tpu.ops.hash_table import set_live as ref_set_live
    from risingwave_tpu_torch.ops.agg import order_key_from_reference

    ref, port, _, rng = seeded_agg_pair(seed)
    claimed = np.flatnonzero(np.asarray(ref.table.fp1) != 0)
    hit = np.sort(rng.choice(claimed, len(claimed) // 2, replace=False)).astype(np.int32)
    cold = cold_rows(rng, ref, len(hit))
    ref.state = ref_agg_mod._cold_merge(ref.state, jnp.asarray(hit),
                                        {k: jnp.asarray(v) for k, v in cold.items()}, ref.calls)
    slots = jnp.asarray(hit)
    ref.table = ref_set_live(ref.table, slots, ref.state.row_count[slots] > 0)
    fx = {f"{p}{n}" for n, _ in port._float_extremes for p in ("acc_", "em_")}
    pcold = {k: order_key_from_reference(v) if k in fx else v for k, v in cold.items()}
    ct.cold_merge(ct.agg_merge_lanes(port.state, port.calls), torch.from_numpy(hit), pcold,
                  port.state.row_count, port.table.live)
    assert_agg_equal(ref, port)


@pytest.mark.parametrize("overflow", [False, True])
def test_fault_in_equals_reference_fault_in_scatter(overflow):
    """R as fault-in (kernel A's insert, then one scatter of every lane
    with ``stored`` and ``live``) equals the reference's
    ``_fault_in_scatter``: evicted groups read back from the store, the
    multisets included; into a table too small for them, the same
    overflow latch and the same rows landed."""
    from risingwave_tpu.ops import agg as ref_agg_ops
    from risingwave_tpu.ops import minput as ref_mi
    from risingwave_tpu.ops.hash_table import HashTable as RefTable
    from risingwave_tpu.storage.state_table import lanes_from_host_keys
    from risingwave_tpu_torch.executors.hash_agg import scatter_agg_rows
    from risingwave_tpu_torch.ops.checkpoint import insert_keys

    ref, port, mgr, _ = seeded_agg_pair(11)
    ref.cold_reader = lambda keys: mgr.get_rows("lanes", keys)
    ref.evict_cold()
    keys = sorted(ref._evicted)
    lanes_np = lanes_from_host_keys(keys, [k.dtype for k in ref.table.keys])
    found, vals = mgr.get_rows("lanes", lanes_np)
    assert found.all() and len(keys) > 8
    cold = {k: np.asarray(v) for k, v in vals.items()}
    if overflow:
        cap = 8
        rt = RefTable.create(cap, tuple(k.dtype for k in ref.table.keys))
        rs = ref_agg_ops.create_state(cap, ref.calls, ref._dtypes)
        rm = ref_mi.create_minput(cap, ref.minput_k, ref.calls, ref._dtypes)
        port_ex = lane_agg(PORT, cap)
    else:
        rt, rs, rm = ref.table, ref.state, ref.minput
        port_ex = lane_agg(PORT, ref.table.capacity)
        port_ex.load_reference_state(ref_agg_arrays(ref))
    key_lanes = tuple(jnp.asarray(lanes_np[f"k{i}"]) for i in range(len(keys[0])))
    ref.table, ref.state, ref.minput, ovf = ref_agg_mod._fault_in_scatter(
        rt, rs, rm, key_lanes, {k: jnp.asarray(v) for k, v in cold.items()}, ref.calls)
    ref.dropped = ref.dropped | ovf
    port_ex.table, slots = insert_keys(port_ex.table, lanes_np, len(keys))
    port_ex.dropped |= (slots < 0).any()
    scatter_agg_rows(port_ex.table, port_ex.state, port_ex.minput, slots, cold, port_ex.calls,
                     port_ex._dtypes, len(keys))
    assert bool(ovf) == overflow
    assert_agg_equal(ref, port_ex)


# -- q5, q8 and q5-max with an eviction after every commit ------------------------------
STREAMS = ("q5", "q8", "q8_wm", "q5_max")


def _query(name):
    """``(query, after)``: the kill matrix's query over a shorter stream
    (4 epochs, the kill after the second), or q8 at 400 events/s with
    ``after(pipeline, ep)`` a ``date_time`` watermark, run after each
    barrier's commit and eviction (windows close, so evicted keys become
    cold tombstones)."""
    import test_torch_checkpoint as ckt
    import test_torch_q5_max as q5mt
    import test_torch_q8 as q8t

    streams = {"q5": lambda: q5mt._stream(4, 1000, seed=1),
               "q8": lambda: q8t._stream(4, 1, 1500),
               "q5_max": lambda: q5mt._stream(4, 1000),
               "q8_wm": lambda: q8t._stream(4, 1, 1500, rate=400, seed=13)}
    q = ckt.QUERIES["q8" if name == "q8_wm" else name]
    q = ckt._Query(q.build, streams[name], q.drive, 2)
    if name != "q8_wm":
        return q, None

    def after(pipeline, ep):
        pipeline.watermark("date_time", max(int(c["date_time"].max()) for pa in ep for c in pa
                                            if len(c["date_time"])))

    return q, after


def _ref_cold_members(pipeline):
    from risingwave_tpu.runtime.fused_step import expand_fused as ref_expand

    return [ex for ex in ref_expand(pipeline.executors) if hasattr(ex, "evict_cold")
            and type(ex).__name__ in ("HashAggExecutor", "HashJoinExecutor")]


def _counts(members):
    return [ex.cold_counts for ex in members]


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
@pytest.mark.parametrize("name", STREAMS)
def test_stream_under_eviction_matches_reference(name, fuse):
    """Each barrier, both packages commit and then evict every durable
    group and key; the MV, every table's committed rows and each
    executor's evicted count (interpreted only: a fused program faults
    every evicted group or key back in before it runs) equal the
    reference's interpreted run at every barrier, and the MV equals an
    un-evicted port run's. The port
    fused as interpreted (the reference's fused program merges before
    the epoch's rows land, so it is not the twin here: ROADMAP Queue 3).
    The port then dies after an eviction and a fresh pipeline recovers
    from its store, is armed again and goes on evicting, equal to the
    uninterrupted run at every later barrier."""
    import test_torch_checkpoint as ckt
    from risingwave_tpu import integrity as ref_integrity
    from risingwave_tpu.runtime.fused_step import expand_fused as ref_expand
    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    q, after = _query(name)
    data = q.stream()
    ref_store, port_store = RefStore(), MemObjectStore()
    ref_mgr, port_mgr = RefManager(ref_store), CheckpointManager(port_store)
    ref, port, plain = q.build(False), q.build(True), q.build(True)
    if fuse:
        fuse_pipeline(port.pipeline)
    ref_members = _ref_cold_members(ref.pipeline)
    port_members = cold_executors(port.pipeline.executors)
    for ex in ref_members:
        armed(ex, ref_mgr)
    for ex in port_members:
        armed(ex, port_mgr)
    tids = [t for ex in checkpointed_executors(port.pipeline.executors)
            if hasattr(ex, "checkpoint_delta") for t in ex.checkpoint_table_ids()]
    assert tids == ckt._table_ids(ref.pipeline)
    port2 = mgr2 = None
    for e, ep in enumerate(data):
        runs = [(ref, False), (port, True), (plain, True)] + ([(port2, True)] if port2 else [])
        for run, is_port in runs:
            q.drive(run.pipeline, ep, is_port)
        ref_mgr.commit_epoch(ref.pipeline.epoch, ref_expand(ref.pipeline.executors))
        port_mgr.commit_epoch(port.pipeline.epoch, checkpointed_executors(port.pipeline.executors))
        got = [ex.evict_cold() for ex in port_members]
        want = [ex.evict_cold() for ex in ref_members]
        if not fuse:  # a fused program faults every evicted key in first
            assert got == want
        assert port.mview.snapshot() == ref.mview.snapshot() == plain.mview.snapshot()
        assert (ckt._row_images(port_mgr, tids, integrity.host_rows_digest)
                == ckt._row_images(ref_mgr, tids, ref_integrity.host_rows_digest))
        if port2 is not None:
            mgr2.commit_epoch(port2.pipeline.epoch,
                              checkpointed_executors(port2.pipeline.executors))
            for ex in cold_executors(port2.pipeline.executors):
                ex.evict_cold()
            assert port2.mview.snapshot() == plain.mview.snapshot()
        if after is not None:
            for run, _ in runs:
                after(run.pipeline, ep)
        if e == q.kill - 1:
            # the kill: a fresh pipeline from the store alone
            port2, mgr2 = q.build(True), CheckpointManager(port_store)
            mgr2.recover(checkpointed_executors(port2.pipeline.executors))
            if fuse:
                fuse_pipeline(port2.pipeline)
            for ex in cold_executors(port2.pipeline.executors):
                armed(ex, mgr2)
            assert port2.mview.snapshot() == port.mview.snapshot()
    totals = {k: sum(c[k] for c in _counts(port_members) if k in c)
              for k in ("evicted", "merged", "faulted_in", "cold_tombstones")}
    assert totals["evicted"] > 0
    if name == "q5":
        assert totals["merged"] > 0
    else:
        assert totals["faulted_in"] > 0
    if name == "q8_wm":
        assert totals["cold_tombstones"] > 0


def test_point_reads_equal_reference_across_compaction():
    """The store's point reads (``get_rows``, what every fault-in and merge
    reads) equal the reference's over flat and compacted (block) SSTs:
    two-lane keys with negative ints and floats, tombstones, keys read
    before, inside and past every file's key range."""
    from risingwave_tpu.storage.state_table import Checkpointable as RefCheckpointable
    from risingwave_tpu.storage.state_table import StateDelta as RefDelta
    from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta

    rng = np.random.default_rng(31)
    ref_mgr, port_mgr = RefManager(RefStore()), CheckpointManager(MemObjectStore())

    def table(base, delta_cls):
        class Table(base):
            table_id = "pts"

            def __init__(self):
                self.delta_cls, self.deltas = delta_cls, []

            def checkpoint_delta(self):
                out, self.deltas = self.deltas, []
                return out

        return Table()

    ref_t, port_t = table(RefCheckpointable, RefDelta), table(Checkpointable, StateDelta)
    for epoch in range(1, 9):
        n = 300
        keys = {"k0": rng.integers(-500, 500, n).astype(np.int64),
                "k1": rng.choice([-1.5, -0.0, 0.0, 2.25, 1e9], n)}
        vals = {"v": rng.integers(0, 1 << 40, n).astype(np.int64),
                "r": rng.integers(0, 9, (n, 4)).astype(np.int32)}
        tomb = rng.random(n) < 0.2
        # one row per key in a delta, as a staged delta holds
        _, first = np.unique(np.stack([keys["k0"], keys["k1"].view(np.int64)], 1), axis=0,
                             return_index=True)
        keys = {k: v[first] for k, v in keys.items()}
        vals = {k: v[first] for k, v in vals.items()}
        for t in (ref_t, port_t):
            t.deltas = [t.delta_cls("pts", dict(keys), dict(vals), tomb[first], ("k0", "k1"))]
        ref_mgr.commit_epoch(epoch << 16, [ref_t])
        port_mgr.commit_epoch(epoch << 16, [port_t])
        if epoch % 3 == 0:
            for m in (ref_mgr, port_mgr):
                for tid in m.tables_needing_compaction() or ["pts"]:
                    m.compact_once(tid, epoch << 16)
    q = {"k0": rng.integers(-700, 700, 2000).astype(np.int64),
         "k1": rng.choice([-1.5, -0.0, 0.0, 2.25, 1e9, 7.0], 2000)}
    rf, rv = ref_mgr.get_rows("pts", q)
    pf, pv = port_mgr.get_rows("pts", q)
    np.testing.assert_array_equal(pf, rf)
    assert 0 < pf.sum() < len(pf)
    for k in rv:
        np.testing.assert_array_equal(pv[k][pf], np.asarray(rv[k])[rf], err_msg=k)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_block_point_read_equals_reference(seed):
    """A block SST's point read (one search of the block bounds and one
    match of the block rows for all the queries) equals the reference's
    per-query loop on the same file: two-lane keys with -0.0 beside 0.0
    and NaN (which equals nothing), repeated queries, small blocks."""
    from risingwave_tpu.storage import block_sst as ref_bs
    from risingwave_tpu_torch.storage import block_sst as bs

    rng = np.random.default_rng(seed)
    floats = [-1.5, -0.0, 0.0, 2.25, np.nan, 7.0, 1e300]
    n = 4000
    k0, k1 = rng.integers(-50, 50, n), rng.choice(floats, n)
    _, first = np.unique(np.stack([k0, k1.view(np.int64)], 1), axis=0, return_index=True)
    keys = {"k0": k0[first], "k1": k1[first]}
    m = len(first)
    vals = {"v": rng.integers(0, 1 << 40, m), "r": rng.integers(0, 9, (m, 3)).astype(np.int32)}
    blob = bs.build_block_sst("t", 1, keys, vals, rng.random(m) < 0.2, ("k0", "k1"),
                              block_rows=int(rng.integers(8, 300)))
    port_store, ref_store = MemObjectStore(), RefStore()
    port_store.put("p", blob)
    ref_store.put("p", blob)
    q = [rng.integers(-60, 60, 3000), rng.choice(floats + [3.0], 3000)]
    mask = rng.random(3000) < 0.8
    hit, tomb, got = bs.BlockSst(port_store, "p").point_read(q, mask)
    r_hit, r_tomb, want = ref_bs.BlockSst(ref_store, "p").point_read(q, mask)
    np.testing.assert_array_equal(hit, r_hit)
    np.testing.assert_array_equal(tomb, r_tomb)
    assert 0 < hit.sum() < mask.sum() and got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k][hit], want[k][hit], err_msg=k)
