"""Checkpoint and recovery through the port (kernel R's plain versions
on the CPU) against ``risingwave_tpu`` on JAX-CPU:

- R's four functions (``ops/checkpoint.py``) equal the reference's
  ``stage_marks``, ``pull_rows``/``_gather``, ``_mark_checkpointed``
  and ``_side_mark_checkpointed`` slot for slot, on seeded lanes with
  1-D lanes of every dtype and 2-D lanes, and on an empty selection;
- every ported executor's ``checkpoint_delta`` equals the reference's
  (agg with float and materialized MIN/MAX, join sides with degrees,
  dedup, the dynamic max filter, the device MV): the same rows, in the
  same order, in the same dtypes;
- kill-and-recover of q5 (``tests/test_checkpoint.py:80``), q5 with
  state-cleaning tombstones (``:125``), q8 (``:168``), q7 (``:213``),
  q101, q5-max, q102 and the paths p25-p28 of
  ``tests/test_torch_table_paths.py``: each package commits after every barrier into its
  own store, both are killed and recovered into fresh pipelines, and
  then the MV snapshot and every executor's state digest equal the
  pre-kill state, the reference's recovered run and an uninterrupted
  port run at every barrier after recovery; the committed row image of
  every table equals the reference's at every commit;
- mirrors of ``tests/test_join_types.py:190`` (degrees survive),
  ``tests/test_minput.py:120`` (multisets survive) and
  ``tests/test_fused_step.py:758`` (a recovered pipeline re-fuses);
- cross-recovery of q5 and q8 in both directions: a store written by one
  package recovered by the other.

Tolerance: none. Every comparison is exact (equal arrays with equal
dtypes, equal MV snapshots, equal uint64 digests).
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.storage import CheckpointManager as RefManager
from risingwave_tpu.storage import MemObjectStore as RefStore
from risingwave_tpu.storage.state_table import pull_rows as ref_pull_rows
from risingwave_tpu.storage.state_table import stage_marks as ref_stage_marks
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.ops import checkpoint as ck
from risingwave_tpu_torch.runtime.fused_step import expand_fused, fuse_pipeline
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore
from risingwave_tpu_torch.storage.state_table import Checkpointable
from risingwave_tpu_torch.types import Op

import test_torch_q101 as q101t
import test_torch_q102 as q102t
import test_torch_q5_max as q5mt
import test_torch_q7 as q7t
import test_torch_q8 as q8t
import test_torch_table_paths as tpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- kernel R's plain versions against the reference ----------------------------
CAP = 512


def _marks(rng, empty: bool):
    sdirty = np.zeros(CAP, bool) if empty else rng.random(CAP) < 0.4
    return {"sdirty": sdirty, "live": rng.random(CAP) < 0.5, "ev": rng.random(CAP) < 0.2,
            "dirty": rng.random(CAP) < 0.1, "stored": rng.random(CAP) < 0.5}


def _lanes(rng):
    return {
        "k0": rng.integers(-2**40, 2**40, CAP).astype(np.int64),
        "k1": rng.integers(-5, 5, CAP).astype(np.int32),
        "f32": rng.normal(size=CAP).astype(np.float32),
        "f64": rng.normal(size=CAP),
        "b": rng.random(CAP) < 0.5,
        "rv": rng.random((CAP, 4)) < 0.5,
        "deg": rng.integers(0, 7, (CAP, 4)).astype(np.int32),
        "miv": rng.integers(-99, 99, (CAP, 8)).astype(np.int64),
        "r_f": rng.normal(size=(CAP, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("empty", [False, True], ids=["mixed", "empty_sel"])
def test_stage_select_and_gather_equal_reference(empty):
    rng = np.random.default_rng(11)
    m = _marks(rng, empty)
    alive = m["live"] | m["ev"] | m["dirty"]
    _up, tomb, sel = ref_stage_marks(m["sdirty"], alive, m["stored"])
    t = {k: torch.from_numpy(v) for k, v in m.items()}
    got_sel, got_tomb, n, n_sd = ck.stage_select(t["sdirty"], (t["live"], t["ev"], t["dirty"]),
                                                 t["stored"])
    assert n == len(sel) and n_sd == int(m["sdirty"].sum())
    assert got_sel.dtype == torch.int32 and np.array_equal(got_sel.numpy(), sel)
    assert np.array_equal(got_tomb.numpy(), tomb[sel])
    if empty:
        assert n == 0
    lanes = _lanes(rng)
    want = ref_pull_rows({k: jnp.asarray(v) for k, v in lanes.items()}, sel)
    got = ck.gather_rows({k: torch.from_numpy(v) for k, v in lanes.items()}, got_sel,
                         {"tomb": got_tomb})
    assert np.array_equal(got.pop("tomb"), tomb[sel])
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


@pytest.mark.parametrize("empty", [False, True], ids=["mixed", "empty_sel"])
def test_mark_checkpointed_equals_reference(empty):
    """``stored[sel] = ~tomb`` and sdirty cleared equals the reference's
    ``(stored | upsert) & ~tomb`` of the agg and of a join side."""
    from risingwave_tpu.executors.hash_agg import _mark_checkpointed
    from risingwave_tpu.executors.hash_join import _side_mark_checkpointed
    from risingwave_tpu.ops import agg as ref_agg
    from risingwave_tpu.ops.agg import AggCall as RefCall
    from risingwave_tpu.ops.join import JoinSide as RefSide

    rng = np.random.default_rng(12)
    m = _marks(rng, empty)
    alive = m["live"] | m["ev"] | m["dirty"]
    up, tomb, sel = ref_stage_marks(m["sdirty"], alive, m["stored"])
    st = ref_agg.create_state(CAP, (RefCall("count_star", None, "n"),), {})
    st = dataclasses.replace(st, sdirty=jnp.asarray(m["sdirty"]), stored=jnp.asarray(m["stored"]))
    want = _mark_checkpointed(st, jnp.asarray(up), jnp.asarray(tomb))
    side = RefSide.create(CAP, 2, (jnp.int64,), {"v": jnp.int64})
    side = dataclasses.replace(side, sdirty=jnp.asarray(m["sdirty"]),
                               stored=jnp.asarray(m["stored"]))
    want_side = _side_mark_checkpointed(side, jnp.asarray(up), jnp.asarray(tomb))
    stored, sdirty = torch.from_numpy(m["stored"].copy()), torch.from_numpy(m["sdirty"].copy())
    got_sel, got_tomb, _, _ = ck.stage_select(sdirty, (torch.from_numpy(alive),), stored)
    ck.mark_checkpointed(stored, sdirty, got_sel, got_tomb)
    for w in (want, want_side):
        assert np.array_equal(stored.numpy(), np.asarray(w.stored))
        assert np.array_equal(sdirty.numpy(), np.asarray(w.sdirty))
    assert not sdirty.any()


def test_scatter_rows_is_the_gathers_inverse():
    """Rows land at their slots in every lane (1-D and 2-D, cast to the
    lane's dtype), as the reference's per-lane ``.at[slots].set``; a
    slot of -1 drops its row (the reference's drop sentinel is the
    capacity)."""
    rng = np.random.default_rng(13)
    lanes = _lanes(rng)
    slots = rng.permutation(CAP)[:100].astype(np.int32)
    slots[::7] = -1
    rows = {k: np.asarray(v)[: len(slots)] for k, v in _lanes(rng).items()}
    dst = {k: torch.from_numpy(v.copy()) for k, v in lanes.items()}
    ck.scatter_rows(dst, torch.from_numpy(slots), rows)
    for k, v in lanes.items():
        ok = slots >= 0
        sink = np.where(ok, slots, CAP)
        want = jnp.asarray(v).at[jnp.asarray(sink)].set(jnp.asarray(rows[k]), mode="drop")
        assert np.array_equal(dst[k].numpy(), np.asarray(want)), k
    back = ck.gather_rows(dst, torch.from_numpy(slots[slots >= 0]))
    for k in lanes:
        assert np.array_equal(back[k], rows[k][slots >= 0]), k


# -- every executor's delta against the reference's -----------------------------
def _assert_deltas_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.table_id == w.table_id and tuple(g.key_order) == tuple(w.key_order)
        assert np.array_equal(g.tombstone, np.asarray(w.tombstone))
        for part in ("key_cols", "value_cols"):
            gp, wp = getattr(g, part), getattr(w, part)
            assert set(gp) == set(wp), (part, set(gp) ^ set(wp))
            for k, wa in wp.items():
                wa = np.asarray(wa)
                assert gp[k].dtype == wa.dtype and gp[k].shape == wa.shape, (k, gp[k].dtype)
                assert np.array_equal(gp[k], wa, equal_nan=wa.dtype.kind == "f"), k


def test_agg_deltas_equal_reference():
    """Float MIN/MAX (order keys in the reference's uint32/uint64
    lanes), materialized MIN/MAX multisets (2-D rows), a nullable SUM,
    and window-watermark tombstones, over five checkpoints."""
    from risingwave_tpu.executors.hash_agg import HashAggExecutor as RefAgg
    from risingwave_tpu.ops.agg import AggCall as RefCall
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.ops.agg import AggCall

    def calls(C):
        return (C("count_star", None, "n"), C("sum", "v", "s"), C("min", "f", "fmin"),
                C("max", "f32", "fmax"), C("max", "v", "vmax", materialized=True),
                C("min", "f", "mfmin", materialized=True))

    np_dt = {"g": np.int64, "v": np.int64, "f": np.float64, "f32": np.float32}
    t_dt = {"g": torch.int64, "v": torch.int64, "f": torch.float64, "f32": torch.float32}
    wk = ("g", 0, True)
    ref = RefAgg(("g",), calls(RefCall), np_dt, capacity=32, minput_k=32, table_id="agg",
                 window_key=wk)
    port = HashAggExecutor(("g",), calls(AggCall), t_dt, capacity=32, minput_k=32,
                           table_id="agg", window_key=wk, device="cpu")
    rng = np.random.default_rng(2)
    for step in range(5):
        n = 40
        cols = {"g": rng.integers(step * 4, step * 4 + 30, n).astype(np.int64),
                "v": rng.integers(-50, 50, n).astype(np.int64), "f": rng.normal(size=n),
                "f32": rng.normal(size=n).astype(np.float32)}
        nulls = {"v": rng.random(n) < 0.2}
        ref.apply(RefChunk.from_numpy(cols, 64, nulls=nulls))
        port.apply(StreamChunk.from_numpy(cols, 64, nulls=nulls, device="cpu"))
        ref.on_barrier(None)
        port.on_barrier(None)
        if step >= 2:  # close the lowest groups: tombstones of stored groups
            from risingwave_tpu.executors.base import Watermark as RefWm
            from risingwave_tpu_torch.executors.base import Watermark

            ref.on_watermark(RefWm("g", step * 4))
            port.on_watermark(Watermark("g", step * 4))
            ref.on_barrier(None)
            port.on_barrier(None)
        got, want = port.checkpoint_delta(), ref.checkpoint_delta()
        _assert_deltas_equal(got, want)
        if step >= 3:
            assert got[0].tombstone.any()
        assert port.state_digest() == ref.state_digest()
    assert port.checkpoint_delta() == [] and ref.checkpoint_delta() == []


def _join_chunk(rows, side, port):
    """rows: (key, value, op); left (lk, lv), right (rk, rv)."""
    k, v = ("lk", "lv") if side == "l" else ("rk", "rv")
    cols = {k: np.array([r[0] for r in rows], np.int64), v: np.array([r[1] for r in rows], np.int64)}
    ops = np.array([int(r[2]) for r in rows], np.int32)
    if port:
        return StreamChunk.from_numpy(cols, 16, ops=ops, device="cpu")
    return RefChunk.from_numpy(cols, 16, ops=ops)


def _join(port, join_type="left", table_id="j1"):
    l_dt = {"lk": np.int64, "lv": np.int64}
    r_dt = {"rk": np.int64, "rv": np.int64}
    kw = dict(capacity=64, fanout=4, out_cap=256, join_type=join_type, table_id=table_id)
    if port:
        from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor

        to_t = lambda d: {k: torch.int64 for k in d}
        return HashJoinExecutor(["lk"], ["rk"], to_t(l_dt), to_t(r_dt), device="cpu", **kw)
    from risingwave_tpu.executors.hash_join import HashJoinExecutor

    return HashJoinExecutor(["lk"], ["rk"], l_dt, r_dt, **kw)


@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_join_side_deltas_equal_reference(join_type):
    """Both sides of a join (buckets as (capacity, fanout) rows, degrees
    included) over inserts and deletes, both sides' deltas per
    checkpoint. An inner join's deltas are the reference's. A left outer
    join's are the reference's plus one row per key whose stored rows'
    degrees moved while the key itself was not sdirty (``ddirty``): the
    reference misses those degrees (ROADMAP Queue 3)."""
    rng = np.random.default_rng(4)
    ref, port = _join(False, join_type), _join(True, join_type)
    live = {"l": [], "r": []}
    extra_rows = 0
    for step in range(6):
        for s in ("l", "r"):
            rows = [(int(rng.integers(0, 64)), int(rng.integers(0, 100)), Op.INSERT)
                    for _ in range(6)]
            if live[s] and step % 2:
                rows.append(live[s].pop(0)[:2] + (Op.DELETE,))
            live[s] += [r for r in rows if r[2] == Op.INSERT]
            for ex, p in ((ref, False), (port, True)):
                (ex.apply_left if s == "l" else ex.apply_right)(_join_chunk(rows, s, p))
        ref.on_barrier(None)
        port.on_barrier(None)
        extra = {name: side.ddirty & ~side.sdirty
                 for name, side in (("left", port.left), ("right", port.right))}
        got, want = port.checkpoint_delta(), ref.checkpoint_delta()
        if join_type == "inner":
            assert not any(e.any() for e in extra.values())
            _assert_deltas_equal(got, want)
        else:
            extra_rows += _assert_delta_extends(got, want, extra)
        assert port.state_digest() == ref.state_digest()
    assert join_type == "inner" or extra_rows > 0


def _assert_delta_extends(got, want, extra) -> int:
    """``got`` holds ``want``'s rows unchanged, in order, plus upserts of
    keys whose slots ``extra`` marks; returns the extra rows' count."""
    by_id = {d.table_id: d for d in want}
    n_extra = 0
    for g in got:
        side = g.table_id.rsplit(".", 1)[1]
        w = by_id.get(g.table_id)
        gk = g.key_cols["k0"]
        wk = np.asarray(w.key_cols["k0"]) if w is not None else np.zeros(0, np.int64)
        in_want = np.isin(gk, wk)
        assert int(in_want.sum()) == len(wk)
        if w is not None:
            sub = type(g)(g.table_id, {k: a[in_want] for k, a in g.key_cols.items()},
                          {k: a[in_want] for k, a in g.value_cols.items()},
                          g.tombstone[in_want], g.key_order)
            _assert_deltas_equal([sub], [w])
        n_more = int((~in_want).sum())
        assert n_more == int(extra[side].sum()) and not g.tombstone[~in_want].any()
        n_extra += n_more
    return n_extra


def test_dedup_and_filter_deltas_equal_reference():
    """The seen-set (keys only) and the dynamic max filter (keys + max),
    with watermark expiry tombstones."""
    from risingwave_tpu.executors.base import Watermark as RefWm
    from risingwave_tpu.executors.dedup import AppendOnlyDedupExecutor as RefDedup
    from risingwave_tpu.executors.dynamic_filter import DynamicMaxFilterExecutor as RefFilter
    from risingwave_tpu_torch.executors.base import Watermark
    from risingwave_tpu_torch.executors.dedup import AppendOnlyDedupExecutor
    from risingwave_tpu_torch.executors.dynamic_filter import DynamicMaxFilterExecutor

    np_dt = {"k": np.int64, "w": np.int64, "v": np.int64}
    t_dt = {k: torch.int64 for k in np_dt}
    pairs = [
        (RefDedup(("w", "k"), np_dt, capacity=64, window_key=("w", 0), table_id="d"),
         AppendOnlyDedupExecutor(("w", "k"), t_dt, capacity=64, window_key=("w", 0),
                                 table_id="d", device="cpu")),
        (RefFilter("w", "v", np_dt, capacity=64, window_key=("w", 0), table_id="f"),
         DynamicMaxFilterExecutor("w", "v", t_dt, capacity=64, window_key=("w", 0),
                                  table_id="f", device="cpu")),
    ]
    rng = np.random.default_rng(5)
    for step in range(5):
        cols = {"k": rng.integers(0, 10, 24).astype(np.int64),
                "w": rng.integers(step, step + 6, 24).astype(np.int64),
                "v": rng.integers(0, 1000, 24).astype(np.int64)}
        for ref, port in pairs:
            ref.apply(RefChunk.from_numpy(cols, 32))
            port.apply(StreamChunk.from_numpy(cols, 32, device="cpu"))
            ref.on_barrier(None)
            port.on_barrier(None)
            if step >= 2:
                ref.on_watermark(RefWm("w", step + 1))
                port.on_watermark(Watermark("w", step + 1))
            got, want = port.checkpoint_delta(), ref.checkpoint_delta()
            _assert_deltas_equal(got, want)
            if step >= 3:
                assert got[0].tombstone.any()
            assert port.state_digest() == ref.state_digest()


def test_simple_agg_and_general_filter_deltas_equal_reference():
    """The SimpleAgg's one row (a float MIN/MAX key in the reference's
    unsigned lane, a nullable SUM) and the general dynamic filter's two
    tables (the row store with its pass flags, tombstones of deleted
    rows; the right value), over five checkpoints."""
    from risingwave_tpu.executors.dynamic_filter import DynamicFilterExecutor as RefFilter
    from risingwave_tpu.executors.simple_agg import SimpleAggExecutor as RefSimple
    from risingwave_tpu.ops.agg import AggCall as RefCall
    from risingwave_tpu_torch.executors import DynamicFilterExecutor, SimpleAggExecutor
    from risingwave_tpu_torch.ops.agg import AggCall

    def calls(C):
        return (C("count_star", None, "n"), C("sum", "v", "s"), C("min", "f", "fmin"),
                C("max", "f32", "fmax"))

    np_dt = {"k": np.int64, "v": np.int64, "f": np.float64, "f32": np.float32}
    t_dt = {"k": torch.int64, "v": torch.int64, "f": torch.float64, "f32": torch.float32}
    pairs = [
        (RefSimple(calls(RefCall), np_dt, table_id="sa"),
         SimpleAggExecutor(calls(AggCall), t_dt, table_id="sa", device="cpu")),
        (RefFilter("v", "<", ("k",), {"k": np.int64, "v": np.int64}, capacity=64,
                   table_id="gf"),
         DynamicFilterExecutor("v", "<", ("k",), {"k": torch.int64, "v": torch.int64},
                               capacity=64, table_id="gf", device="cpu")),
    ]
    rng = np.random.default_rng(4)
    stored = set()
    for step in range(5):
        n = 20
        ks = rng.integers(0, 40, n).astype(np.int64)
        ops = np.where(np.isin(ks, list(stored)) & (rng.random(n) < 0.5), int(Op.DELETE),
                       int(Op.INSERT)).astype(np.int32)
        stored |= set(ks[ops == int(Op.INSERT)].tolist())
        cols = {"k": ks, "v": rng.integers(-50, 50, n).astype(np.int64),
                "f": rng.normal(size=n), "f32": rng.normal(size=n).astype(np.float32)}
        nulls = {"v": rng.random(n) < 0.2}
        sa_ops = np.full(n, int(Op.INSERT), np.int32)  # append-only MIN/MAX
        (rs, ps), (rf, pf) = pairs
        rs.apply(RefChunk.from_numpy(cols, 32, ops=sa_ops, nulls=nulls))
        ps.apply(StreamChunk.from_numpy(cols, 32, ops=sa_ops, nulls=nulls, device="cpu"))
        kv = {"k": cols["k"], "v": cols["v"]}
        rf.apply_left(RefChunk.from_numpy(kv, 32, ops=ops))
        pf.apply_left(StreamChunk.from_numpy(kv, 32, ops=ops, device="cpu"))
        if step % 2 == 0:
            rv = {"v": np.asarray([int(rng.integers(-40, 40))], np.int64)}
            rf.apply_right(RefChunk.from_numpy(rv, 2))
            pf.apply_right(StreamChunk.from_numpy(rv, 2, device="cpu"))
        for ref, port in pairs:
            ref.on_barrier(None)
            port.on_barrier(None)
            got, want = port.checkpoint_delta(), ref.checkpoint_delta()
            _assert_deltas_equal(got, want)
            assert port.state_digest() == ref.state_digest()
        if step >= 2:
            assert any(d.tombstone.any() for d in got)


def test_mv_deltas_equal_reference():
    """Upserts, deletes of stored rows (tombstones), a nullable column
    (its lane in the reference's uint8)."""
    from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor as RefMV
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor

    ref = RefMV(("k",), ("a", "b"), {"k": np.int64, "a": np.int32, "b": np.float64},
                table_id="mv", capacity=64, nullable=("b",))
    port = DeviceMaterializeExecutor(("k",), ("a", "b"), {"k": torch.int64, "a": torch.int32,
                                                          "b": torch.float64},
                                     table_id="mv", capacity=64, nullable=("b",), device="cpu")
    rng = np.random.default_rng(6)
    tombs = 0
    for _ in range(5):
        n = 20
        cols = {"k": rng.integers(0, 30, n).astype(np.int64),
                "a": rng.integers(0, 9, n).astype(np.int32), "b": rng.normal(size=n)}
        ops = np.where(rng.random(n) < 0.3, int(Op.DELETE), int(Op.INSERT)).astype(np.int32)
        nulls = {"b": rng.random(n) < 0.3}
        ref.apply(RefChunk.from_numpy(cols, 32, ops=ops, nulls=nulls))
        port.apply(StreamChunk.from_numpy(cols, 32, ops=ops, nulls=nulls, device="cpu"))
        ref.on_barrier(None)
        port.on_barrier(None)
        got, want = port.checkpoint_delta(), ref.checkpoint_delta()
        _assert_deltas_equal(got, want)
        tombs += int(got[0].tombstone.sum())
        assert port.state_digest() == ref.state_digest()
    assert tombs and port.snapshot() == ref.snapshot()


def test_mv_restore_leaves_room_for_an_epoch():
    """A device MV restored from n rows takes a next epoch of n/2 new
    keys (q19's pattern: 985,672 rows, then 492,877) without passing
    the load at which a barrier grows it. The reference's restore size,
    ``grow_pow2(n, 2^10)``, leaves that chunk at load 0.71, under the
    mid-epoch guard's 0.75, where kernel A's probe bound can fail."""
    from risingwave_tpu_torch.executors.materialize import GROW_AT, DeviceMaterializeExecutor

    def mv():
        return DeviceMaterializeExecutor(("k",), ("a",), {"k": torch.int64, "a": torch.int64},
                                         table_id="mv", capacity=1 << 10, device="cpu")

    n, more = 500, 230
    first = mv()
    rows = {"k": np.arange(n, dtype=np.int64), "a": np.arange(n, dtype=np.int64) * 3}
    first.apply(StreamChunk.from_numpy(rows, 512, device="cpu"))
    first.on_barrier(None)
    (delta,) = first.checkpoint_delta()
    restored = mv()
    restored.restore_state("mv", delta.key_cols, delta.value_cols)
    assert restored.snapshot() == first.snapshot()
    nxt = {"k": n + np.arange(more, dtype=np.int64), "a": np.ones(more, np.int64)}
    for ex in (first, restored):
        ex.apply(StreamChunk.from_numpy(nxt, 256, device="cpu"))
    assert int(restored.table.occupancy()) <= restored.table.capacity * GROW_AT
    restored.on_barrier(None)
    first.on_barrier(None)
    assert restored.snapshot() == first.snapshot() and len(restored.snapshot()) == n + more


# -- kill-and-recover, held against the reference -------------------------------
def _checkpointables(pipeline):
    return [ex for ex in expand_fused(pipeline.executors) if hasattr(ex, "checkpoint_delta")]


def _digests(pipeline, skip=()):
    """Every Checkpointable executor's state digest by its table ids,
    but those in ``skip``."""
    out = {}
    for ex in _checkpointables(pipeline):
        tids = ",".join(ex.checkpoint_table_ids())
        if tids not in skip:
            out[tids] = ex.state_digest()
    return out


class _Query:
    """One query both ways: ``build(port)`` -> an object with
    ``pipeline`` and ``mview``; ``stream()`` -> per-epoch data;
    ``drive(pipeline, epoch, port)`` pushes an epoch, barriers and (where
    the query has one) runs its watermark."""

    def __init__(self, build, stream, drive, kill, ref_lags=()):
        self.build, self.stream, self.drive = build, stream, drive
        self.kill = kill
        # tables whose degrees the reference does not checkpoint (its
        # recovered state lags; the port's does not): held against the
        # uninterrupted port run only
        self.ref_lags = tuple(ref_lags)


def _q5_build(cleaning):
    from risingwave_tpu.queries.nexmark_q import build_q5_lite as ref_q5
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite

    def build(port):
        if port:
            return build_q5_lite(capacity=1 << 12, state_cleaning=cleaning, device="cpu")
        return ref_q5(capacity=1 << 12, state_cleaning=cleaning)

    return build


def _q5_stream(rate):
    def stream():
        return q5mt._stream(6, 1500, seed=1, rate=rate)

    return stream


def _q5_drive(watermark):
    def drive(pipeline, bids, port):
        mx = q5mt._drive(pipeline, bids, port, cap=2048)
        if watermark:
            pipeline.watermark("date_time", mx)

    return drive


def _q8_build(port):
    from risingwave_tpu.queries.nexmark_q import build_q8 as ref_q8
    from risingwave_tpu_torch.queries.nexmark_q import build_q8

    kw = dict(capacity=1 << 11, fanout=8, out_cap=1 << 11)
    return build_q8(**kw, device="cpu") if port else ref_q8(**kw)


def _q8_drive(pipeline, ep, port):
    q8t._push(pipeline, ep, port)
    pipeline.barrier()


def _q7_build(port):
    from risingwave_tpu.queries.nexmark_q import build_q7 as ref_q7
    from risingwave_tpu_torch.queries.nexmark_q import build_q7

    kw = q7t._sizes(1 << 10)
    return build_q7(**kw, device="cpu") if port else ref_q7(**kw)


def _q7_drive(pipeline, ep, port):
    pipeline.watermark("date_time", q7t._drive(pipeline, ep, port))


class _Q101:
    def __init__(self, port):
        self.pipeline, self.agg, self.join, self.mview = q101t._build(port, cap=1 << 10)


class _Q5Max:
    def __init__(self, port):
        if port:
            from risingwave_tpu_torch.queries.nexmark_q import build_q5_max

            q = build_q5_max(**q5mt._sizes(), device="cpu")
            self.pipeline, self.mview = q.pipeline, q.mview
        else:
            self.pipeline, _c, _m, self.mview = q5mt._ref_build(**q5mt._sizes())


def _q5max_drive(pipeline, bids, port):
    pipeline.watermark("date_time", q5mt._drive(pipeline, bids, port))


class _Q102:
    """q102's two stages as one ``pipeline`` (``Q102`` has ``executors``
    and ``epoch``), the reference's composed from its executors."""

    def __init__(self, port):
        self.pipeline = q102t._port_q102(1 << 10) if port else q102t._ref_q102(1 << 10)
        self.mview = self.pipeline.mview


QUERIES = {
    "q5": _Query(_q5_build(False), _q5_stream(10_000), _q5_drive(False), 3),
    # 500 events/s so the epochs span several hop windows and some close
    "q5_cleaning": _Query(_q5_build(True), _q5_stream(500), _q5_drive(True), 3),
    "q8": _Query(_q8_build, lambda: q8t._stream(6, 1, 2000), _q8_drive, 3),
    "q7": _Query(_q7_build, lambda: q7t._stream(6, 1, 1500, rate=500), _q7_drive, 3),
    "q101": _Query(_Q101, lambda: q101t._stream(5, 2000),
                   lambda p, e, port: q101t._drive(p, e, port), 3,
                   ref_lags=("q101.join.left,q101.join.right",)),
    "q5_max": _Query(_Q5Max, lambda: q5mt._stream(6, 1500), _q5max_drive, 3),
    "q102": _Query(_Q102, lambda: q102t._stream(6, seed=7), q102t._drive, 3),
    # the table-function, grouping-set and temporal-join paths
    **{name: _Query(tpt.BUILDS[name], lambda: tpt.stream(5, 2000, seed=23),
                    lambda pipeline, ep, port: pipeline.drive_epoch(ep), 3)
       for name in ("p25", "p26", "p27", "p28")},
}


def _join_contents(pipeline):
    """Each join side as {key: sorted (payload, nulls, degree) entries}
    of its live keys: the content, whatever the bucket positions."""
    out = []
    for ex in _checkpointables(pipeline):
        if not hasattr(ex, "left"):
            continue
        for side in (ex.left, ex.right):
            live = side.table.live.numpy()
            keys = [k.numpy()[live] for k in side.table.keys]
            rv = side.row_valid.numpy()[live]
            cols = [a.numpy()[live] for _, a in sorted(side.rows.items())]
            cols += [a.numpy()[live] for _, a in sorted(side.row_nulls.items())]
            cols.append(side.degree.numpy()[live])
            out.append({
                tuple(int(k[i]) for k in keys): sorted(
                    tuple(c[i, j].item() for c in cols) for j in np.flatnonzero(rv[i]))
                for i in range(len(rv))
            })
    return out


def _table_ids(pipeline):
    return [t for ex in _checkpointables(pipeline) for t in ex.checkpoint_table_ids()]


def _row_images(mgr, tids, digest):
    return [digest(*mgr.read_table(t)) for t in tids]


@pytest.mark.parametrize("name", list(QUERIES))
def test_kill_and_recover_matches_reference(name):
    q = QUERIES[name]
    data = q.stream()
    ref_store, port_store = RefStore(), MemObjectStore()
    ref_mgr, port_mgr = RefManager(ref_store), CheckpointManager(port_store)
    ref, port = q.build(False), q.build(True)
    tids = _table_ids(port.pipeline)
    assert tids == _table_ids(ref.pipeline)
    exact = [t for t in tids if not any(t in lag.split(",") for lag in q.ref_lags)]
    for e in data[: q.kill]:
        q.drive(ref.pipeline, e, False)
        q.drive(port.pipeline, e, True)
        ref_mgr.commit_epoch(ref.pipeline.epoch, ref.pipeline.executors)
        port_mgr.commit_epoch(port.pipeline.epoch, port.pipeline.executors)
        # the committed row image of every table is the reference's
        assert (_row_images(port_mgr, exact, integrity.host_rows_digest)
                == _row_images(ref_mgr, exact, ref_integrity.host_rows_digest))
    snap, digests = port.mview.snapshot(), _digests(port.pipeline)
    assert len(snap) > 0 and digests == _digests(ref.pipeline)

    # kill: fresh pipelines rebuilt from the stores alone
    ref2, port2 = q.build(False), q.build(True)
    RefManager(ref_store).recover(ref2.pipeline.executors)
    CheckpointManager(port_store).recover(port2.pipeline.executors)
    assert port2.mview.snapshot() == snap == ref2.mview.snapshot()
    assert _digests(port2.pipeline) == digests
    assert _digests(port2.pipeline, q.ref_lags) == _digests(ref2.pipeline, q.ref_lags)

    # the recovered runs continue as the uninterrupted one
    for e in data[q.kill:]:
        for run, is_port in ((port, True), (port2, True), (ref2, False)):
            q.drive(run.pipeline, e, is_port)
        snap = port.mview.snapshot()
        assert port2.mview.snapshot() == snap == ref2.mview.snapshot()
        assert _digests(port2.pipeline, q.ref_lags) == _digests(ref2.pipeline, q.ref_lags)
        # against the uninterrupted run: a join side that one run rebuilt
        # (the recovered side restarts at grow_pow2(n, capacity)) packs
        # its buckets (ROADMAP Queue 3), so joins compare by content
        joins = tuple(t for t in _digests(port.pipeline) if ".left," in t)
        assert _digests(port2.pipeline, joins) == _digests(port.pipeline, joins)
        assert _join_contents(port2.pipeline) == _join_contents(port.pipeline)


def test_reference_recovery_lags_outer_join_degrees():
    """Why q101's join digests are held against the uninterrupted port
    run only: the reference stages a join key only when it is sdirty, so
    a degree that moved later (an auction's first bid in a later epoch)
    is not checkpointed and its recovered left side differs from the
    pre-kill one; the port's (``ddirty``) does not."""
    q = QUERIES["q101"]
    data = q.stream()
    digests = {}
    for port in (False, True):
        store = MemObjectStore() if port else RefStore()
        mgr = (CheckpointManager if port else RefManager)(store)
        run = q.build(port)
        for e in data[: q.kill]:
            q.drive(run.pipeline, e, port)
            mgr.commit_epoch(run.pipeline.epoch, run.pipeline.executors)
        again = q.build(port)
        (CheckpointManager if port else RefManager)(store).recover(again.pipeline.executors)
        digests[port] = (_digests(run.pipeline), _digests(again.pipeline))
    assert digests[False][0] == digests[True][0]
    assert digests[True][1] == digests[True][0]
    assert digests[False][1] != digests[False][0]


def test_recover_after_state_cleaning_drops_tombstoned_groups():
    """Mirror of ``test_checkpoint.py:125``: expired agg groups are
    tombstones in the store and do not come back (the MV keeps its
    final rows)."""
    q = QUERIES["q5_cleaning"]
    store = MemObjectStore()
    mgr = CheckpointManager(store)
    q5 = q.build(True)
    for e in q.stream()[:4]:
        q.drive(q5.pipeline, e, True)
        mgr.commit_epoch(q5.pipeline.epoch, q5.pipeline.executors)
    live_before = int(q5.agg.table.num_live())
    mv_before = q5.mview.snapshot()
    assert live_before < len(mv_before)  # cleaning actually freed groups
    q5b = q.build(True)
    CheckpointManager(store).recover(q5b.pipeline.executors)
    assert int(q5b.agg.table.num_live()) == live_before
    assert q5b.mview.snapshot() == mv_before


def test_join_degrees_survive_recovery():
    """Mirror of ``test_join_types.py:190``: deleting the right row after
    recovery revives the NULL pad, which needs the left row's degree."""
    store = MemObjectStore()
    ex = _join(True)
    acc = collections.Counter()

    def drain(outs):
        for c in outs:
            d = c.to_numpy()
            for i in range(len(d["lk"])):
                key = tuple(None if (f"{n}__null" in d and d[f"{n}__null"][i]) else int(d[n][i])
                            for n in ("lk", "lv", "rk", "rv"))
                acc[key] += 1 if int(d["__op__"][i]) in (Op.INSERT, Op.UPDATE_INSERT) else -1

    drain(ex.apply_left(_join_chunk([(1, 10, Op.INSERT)], "l", True)))
    drain(ex.apply_right(_join_chunk([(1, 77, Op.INSERT)], "r", True)))
    CheckpointManager(store).commit_epoch(1 << 16, [ex])
    ex2 = _join(True)
    CheckpointManager(store).recover([ex2])
    assert int(ex2.left.degree.sum()) == 1
    drain(ex2.apply_right(_join_chunk([(1, 77, Op.DELETE)], "r", True)))
    acc = collections.Counter({k: v for k, v in acc.items() if v})
    assert dict(acc) == {(1, 10, None, None): 1}


def test_minput_multisets_survive_recovery():
    """Mirror of ``test_minput.py:120``: retracting the max after
    recovery falls back to the next value, which needs the multiset."""
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.ops.agg import AggCall

    def mk():
        return HashAggExecutor(("g",), (AggCall("count_star", None, "cnt"),
                                        AggCall("min", "v", "mn", materialized=True),
                                        AggCall("max", "v", "mx", materialized=True)),
                               {"g": torch.int64, "v": torch.int64}, capacity=64, out_cap=64,
                               table_id="mi1", device="cpu")

    def chunk(rows):
        cols = {"g": np.array([r[0] for r in rows], np.int64),
                "v": np.array([r[1] for r in rows], np.int64)}
        return StreamChunk.from_numpy(cols, 16, ops=np.array([int(r[2]) for r in rows], np.int32),
                                      device="cpu")

    def replay(snap, outs):
        for c in outs:
            d = c.to_numpy()
            for i in range(len(d["g"])):
                k = (int(d["g"][i]),)
                if int(d["__op__"][i]) in (Op.DELETE, Op.UPDATE_DELETE):
                    snap.pop(k, None)
                else:
                    snap[k] = (int(d["cnt"][i]), int(d["mn"][i]), int(d["mx"][i]))

    store = MemObjectStore()
    ex = mk()
    snap = {}
    ex.apply(chunk([(1, 10, Op.INSERT), (1, 30, Op.INSERT), (2, 5, Op.INSERT)]))
    replay(snap, ex.on_barrier(None))
    CheckpointManager(store).commit_epoch(1 << 16, [ex])
    ex2 = mk()
    CheckpointManager(store).recover([ex2])
    ex2.apply(chunk([(1, 30, Op.DELETE)]))
    replay(snap, ex2.on_barrier(None))
    assert snap[(1,)] == (1, 10, 10)
    assert snap[(2,)] == (1, 5, 5)


@pytest.mark.parametrize("name", ["q5", "q8"])
def test_recovered_pipeline_refuses_and_continues_fused(name):
    """Mirror of ``test_fused_step.py:758``: commits after fused barriers
    (the members stay the system of record), a fresh build recovers and
    re-fuses into one program, and it continues equal to the
    uninterrupted fused run, digests included."""
    q = QUERIES[name]
    data = q.stream()
    store = MemObjectStore()
    mgr = CheckpointManager(store)
    run = q.build(True)
    fuse_pipeline(run.pipeline, label=name)
    for e in data[: q.kill]:
        q.drive(run.pipeline, e, True)
        mgr.commit_epoch(run.pipeline.epoch, expand_fused(run.pipeline.executors))
    snap = run.mview.snapshot()
    run2 = q.build(True)
    CheckpointManager(store).recover(run2.pipeline.executors)
    assert len(fuse_pipeline(run2.pipeline, label=name)) == 1  # restored members re-fuse
    assert run2.mview.snapshot() == snap
    for e in data[q.kill:]:
        q.drive(run.pipeline, e, True)
        q.drive(run2.pipeline, e, True)
        assert run2.mview.snapshot() == run.mview.snapshot()
        assert _digests(run2.pipeline) == _digests(run.pipeline)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("name", ["q5", "q8"])
def test_cross_recovery(name, writer, monkeypatch):
    """A store written by one package (manifest table digests on) is
    recovered by the other; both recovered runs then continue equal, MV
    and digests, to the writer's uninterrupted run."""
    monkeypatch.setenv("RW_STATE_DIGEST", "1")
    q = QUERIES[name]
    data = q.stream()
    w_port = writer == "port"
    store = MemObjectStore() if w_port else RefStore()
    mgr = (CheckpointManager if w_port else RefManager)(store)
    run = q.build(w_port)
    for e in data[: q.kill]:
        q.drive(run.pipeline, e, w_port)
        mgr.commit_epoch(run.pipeline.epoch, run.pipeline.executors)
    snap, digests = run.mview.snapshot(), _digests(run.pipeline)
    other = q.build(not w_port)
    (RefManager if w_port else CheckpointManager)(store).recover(other.pipeline.executors)
    assert other.mview.snapshot() == snap
    assert _digests(other.pipeline) == digests
    for e in data[q.kill:]:
        q.drive(run.pipeline, e, w_port)
        q.drive(other.pipeline, e, not w_port)
        assert other.mview.snapshot() == run.mview.snapshot()
        assert _digests(other.pipeline) == _digests(run.pipeline)


def test_checkpointable_executors_and_empty_commit():
    """Every stateful executor of the ported queries is Checkpointable
    and has its reference table id; a barrier with no change stages no
    SST."""
    q5 = QUERIES["q5"].build(True)
    assert all(isinstance(ex, Checkpointable) for ex in _checkpointables(q5.pipeline))
    assert _table_ids(q5.pipeline) == ["q5.agg", "q5.mview"]
    assert _table_ids(QUERIES["q7"].build(True).pipeline) == [
        "q7.maxfilter", "q7.maxagg", "q7.join.left", "q7.join.right", "q7.mview"]
    mgr = CheckpointManager(MemObjectStore())
    q5.pipeline.barrier()
    assert mgr.commit_epoch(q5.pipeline.epoch, q5.pipeline.executors) == 0


# -- kernel R's wrappers marshal their C signatures ------------------------------
@pytest.fixture
def calls(monkeypatch):
    """Route every launch through a ``ctypes.CFUNCTYPE`` callback of its
    C signature (``_kernels.SIGNATURES``) on CPU tensors, so a wrong
    argument count or type raises here, not on the card; record the
    entry points."""
    import ctypes

    from risingwave_tpu_torch import _kernels

    log = []

    def call(name, fn, *args):
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *_kernels.SIGNATURES[name][fn])
        assert proto(lambda *a: 0)(*args, None) == 0
        log.append(fn)
        _kernels.LAUNCHES[_kernels.ENTRY_KEYS.get(fn, name)] += 1

    def check_cpu(name, *tensors, n=None):
        for t in tensors:
            assert t.is_contiguous(), name
            if n is not None:
                assert t.shape == (n,), name

    monkeypatch.setattr(_kernels, "call", call)
    monkeypatch.setattr(_kernels, "check_cuda", check_cpu)
    _kernels.reset_launches()
    return log


def test_r_entries_marshal(calls):
    from risingwave_tpu_torch import _kernels

    cap, n = 4096, 40
    z = lambda: torch.zeros(cap, dtype=torch.bool)
    ck._stage_select_launch(z(), (z(), z()), z(), z())
    ck._stage_select_launch(z(), (z(),), z())
    with pytest.raises(ValueError, match="aligned bool"):
        ck._stage_select_launch(z(), (torch.zeros(cap, dtype=torch.int8),), z())
    rng = np.random.default_rng(0)
    lanes = {k: torch.from_numpy(v) for k, v in _lanes(rng).items()}
    sel = torch.arange(n, dtype=torch.int32)
    packed, layout = ck._gather_packed(lanes, sel, set())
    assert packed.dtype == torch.uint8 and [r[0] for r in layout] == list(lanes)
    assert all(off % 16 == 0 for _, off, _ in layout)
    with pytest.raises(TypeError, match="int32"):
        ck._gather_packed(lanes, sel.long(), set())
    ck._scatter_packed(lanes, sel, packed, layout)
    ck._mark_checkpointed_cuda(z(), z(), sel, torch.zeros(n, dtype=torch.bool), z())
    ck._mark_checkpointed_cuda(z(), z(), sel[:0], torch.zeros(0, dtype=torch.bool))
    many = {f"l{i}": torch.zeros(cap, dtype=torch.int64) for i in range(40)}
    ck._gather_packed(many, sel, set())  # 40 lanes: two launches of at most 32
    assert calls == ["rw_stage_select"] * 2 + ["rw_gather_rows", "rw_scatter_rows"] + [
        "rw_mark_checkpointed"] * 2 + ["rw_gather_rows"] * 2
    assert _kernels.LAUNCHES["checkpoint"] == 2 and _kernels.LAUNCHES["gather_rows"] == 3
    assert _kernels.LAUNCHES["scatter_rows"] == 1 and _kernels.LAUNCHES["mark_checkpointed"] == 2


def test_p_marks_moved_degrees(calls):
    """Kernel P's wrapper passes the other side's ``ddirty`` lane (the
    port's addition), and the plain version marks exactly the key slots
    whose stored rows' degrees moved."""
    from risingwave_tpu_torch.ops import join as pj

    side = pj.JoinSide.create(64, 4, (torch.int64,), {"v": torch.int64}, device="cpu")
    side.row_valid[[3, 5, 9], 0] = True
    probed = pj.Probed({}, {}, torch.zeros(8, dtype=torch.int32),
                       torch.zeros(8, dtype=torch.bool),
                       torch.tensor([3, 5, 9, -1], dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32), torch.zeros((), dtype=torch.int32))
    ops = torch.tensor([Op.INSERT, Op.UPDATE_DELETE, Op.INSERT, Op.INSERT], dtype=torch.int32)
    em = torch.zeros((), dtype=torch.bool)
    pj._degree_emit_cuda(side, probed, ops, 8, em)
    assert calls == ["rw_join_degree"]
    pj._degree_emit_torch(side, probed, ops, 8, em)
    assert torch.nonzero(side.ddirty).flatten().tolist() == [3, 5, 9]
    assert side.degree[[3, 5, 9], 0].tolist() == [1, -1, 1] and not side.sdirty.any()


def test_c_entry_points_match_their_signatures():
    """Every ``RW_EXPORT`` entry of every kernel source takes as many
    parameters (the stream last) as its ``_kernels.SIGNATURES`` row
    declares: ctypes passes surplus arguments as 32-bit ints, which on
    the card truncates a pointer."""
    import re
    from pathlib import Path

    from risingwave_tpu_torch import _kernels

    seen = 0
    for name, src in _kernels.SOURCES.items():
        text = (Path(_kernels.CSRC) / src).read_text()
        for m in re.finditer(r"RW_EXPORT int (\w+)\(([^)]*)\)", text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            assert params[-1].split()[-1] == "stream", m.group(1)
            assert len(params) == len(_kernels.SIGNATURES[name][m.group(1)]), m.group(1)
            seen += 1
    assert seen == sum(len(v) for v in _kernels.SIGNATURES.values())
