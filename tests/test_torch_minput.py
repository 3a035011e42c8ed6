"""Kernel Q's plain version and the materialized-input MIN/MAX path of
HashAgg: ``risingwave_tpu_torch/ops/minput.py`` against
``risingwave_tpu/ops/minput.py`` on JAX-CPU, slot for slot and lane for
lane on numpy-seeded inputs, and mirrors of ``tests/test_minput.py``'s
executor tests (``test_minput_checkpoint_roundtrip`` waits for the
port's checkpoint layer).

On the CPU the plain version places every value in the reference's
lane, so every lane compares exactly; float values compare as order
keys, the reference's unsigned keys mapped into the port's int64 key
space (``ops/agg.py:order_key_from_reference``). Tolerance: none.
"""

from collections import Counter, defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.executors.hash_agg import HashAggExecutor as RefAgg
from risingwave_tpu.ops import minput as ref_mi
from risingwave_tpu.ops.agg import AggCall as RefCall
from risingwave_tpu.ops.agg import _float_to_order_key as ref_order_key
from risingwave_tpu_torch.array.chunk import StreamChunk, stack_chunks
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.ops import minput as mi
from risingwave_tpu_torch.ops.agg import AggCall, accum_init, order_key_from_reference
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.types import Op
from test_minput import _oracle, _replay

CAP = 32  # chunk capacity, as test_minput.py
DT = {"g": torch.int64, "v": torch.int64}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _keys(values: np.ndarray) -> tuple:
    """A value lane as the reference stores it (floats as their unsigned
    order keys) and as the port stores it (int64 keys)."""
    if values.dtype.kind != "f":
        return values, values
    ref = np.asarray(ref_order_key(jnp.asarray(values)))
    return ref, order_key_from_reference(ref)


def _pre_state(rng, capacity, k, pool, fill):
    """A multiset whose live lanes hold distinct values of ``pool`` (a
    lane is live with probability ``fill``); free lanes keep stale
    values, as after a retraction."""
    vals = np.empty((capacity, k), pool.dtype)
    cnt = np.zeros((capacity, k), np.int32)
    for s in range(capacity):
        vals[s] = rng.choice(pool, k, replace=False)
        cnt[s] = np.where(rng.random(k) < fill, rng.integers(1, 4, k), 0)
    return vals, cnt


def _batch(rng, n, capacity, pool, live_vals, null_share=0.15):
    """Rows: slots in [-1, capacity), signs in {-1, 0, +1} (retractions
    mostly of live values, some of values never inserted), values drawn
    so that (slot, value) pairs repeat and some net to zero."""
    slots = rng.integers(-1, capacity, n).astype(np.int32)
    signs = rng.choice(np.array([-1, 0, 1, 1], np.int32), n)
    v = rng.choice(pool, n)
    for i in np.flatnonzero(signs < 0):
        s = slots[i]
        if s >= 0 and live_vals[s] and rng.random() < 0.8:
            v[i] = live_vals[s][rng.integers(len(live_vals[s]))]
    # U-/U+ pairs on one value: nets to zero
    for i in range(0, n - 1, 7):
        slots[i + 1], v[i + 1], signs[i], signs[i + 1] = slots[i], v[i], -1, 1
    notnull = rng.random(n) >= null_share
    return slots, signs, v, notnull


def _run_both(vals, cnt, slots, signs, v, notnull, kind):
    """One batch through the reference and the port's plain version;
    returns both 7-tuples as numpy, floats in the port's key space."""
    ref_vals, port_vals = _keys(vals)
    ref = ref_mi.minput_apply(jnp.asarray(ref_vals), jnp.asarray(cnt), jnp.asarray(slots),
                              jnp.asarray(signs), jnp.asarray(v), jnp.asarray(notnull), kind)
    port = mi._minput_apply_torch(torch.from_numpy(port_vals.copy()),
                                  torch.from_numpy(cnt.copy()), torch.from_numpy(slots),
                                  torch.from_numpy(signs), torch.from_numpy(v),
                                  torch.from_numpy(notnull), kind)
    ref = [np.asarray(x) for x in ref]
    if v.dtype.kind == "f":
        ref[0] = order_key_from_reference(ref[0])
        ref[3] = order_key_from_reference(ref[3])
    return ref, [x.numpy() for x in port]


POOLS = {
    "int64": np.arange(-20, 20, dtype=np.int64) * 7,
    "float32": np.array([-3.5, -0.0, 0.0, 1.25, 2.5, np.inf, -np.inf, np.nan, 7.0, -7.0, 100.5,
                         0.001], np.float32),
    "float64": np.array([-3.5, -0.0, 1e300, 1.25, 2.5, np.inf, -1e-300, np.nan, 7.0, -7.0,
                         100.5, 0.001], np.float64),
}


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", list(POOLS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minput_apply_matches_reference_slot_for_slot(dtype, kind, seed):
    """Lanes, counts, representative slots, extremes, totals and both
    latches equal the reference's over NULL inputs, slot -1 rows,
    pairs netting to zero, retractions of values never inserted and
    (seed 2, K = 4) more new values than free lanes."""
    rng = np.random.default_rng(seed)
    capacity, k, n = 12, (4 if seed == 2 else 8), 96
    pool = POOLS[dtype]
    vals, cnt = _pre_state(rng, capacity, k, pool, fill=0.7 if seed == 2 else 0.4)
    live = [[x for x, c in zip(vals[s], cnt[s]) if c > 0] for s in range(capacity)]
    slots, signs, v, notnull = _batch(rng, n, capacity, pool, live)
    ref, port = _run_both(vals, cnt, slots, signs, v, notnull, kind)
    names = ("vals", "cnt", "rep_slots", "extreme", "total", "overflow", "inconsistent")
    for name, a, b in zip(names, ref, port):
        assert np.array_equal(a, b), name
    assert bool(port[6])  # every batch retracts some value never inserted
    if seed == 2:
        assert bool(port[5])


def test_minput_apply_consistent_batch_latches_nothing():
    """Inserts of new values into free lanes and retractions of live
    ones: no latch, and the extremes fall back past retracted maxima."""
    vals = np.zeros((4, 4), np.int64)
    cnt = np.zeros((4, 4), np.int32)
    vals[1, :3], cnt[1, :3] = (5, 9, 7), (1, 2, 1)
    slots = np.array([1, 1, 1, 2, 2, -1, 1], np.int32)
    signs = np.array([-1, -1, 1, 1, 1, 1, 1], np.int32)
    v = np.array([9, 9, 11, 3, 4, 8, 7], np.int64)
    notnull = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    ref, port = _run_both(vals, cnt, slots, signs, v, notnull, "max")
    for a, b in zip(ref, port):
        assert np.array_equal(a, b)
    assert not port[5] and not port[6]
    rep = port[2] >= 0
    assert dict(zip(port[2][rep].tolist(), port[3][rep].tolist())) == {1: 11, 2: 4}


def test_minput_apply_writes_accumulator_lanes_in_place():
    """The public function folds the batch in place and scatters each
    touched group's extreme and total, as the reference's
    ``_minput_pass`` does, and ORs both latches."""
    rng = np.random.default_rng(5)
    vals, cnt = _pre_state(rng, 8, 8, POOLS["int64"], 0.5)
    live = [[x for x, c in zip(vals[s], cnt[s]) if c > 0] for s in range(8)]
    slots, signs, v, notnull = _batch(rng, 64, 8, POOLS["int64"], live)
    ref = ref_mi.minput_apply(*(jnp.asarray(x) for x in (vals, cnt, slots, signs, v, notnull)),
                              "min")
    acc = jnp.full(8, accum_init("min", torch.int64), jnp.int64)
    nn = jnp.zeros(8, jnp.int64)
    idx = jnp.where(ref[2] >= 0, ref[2], 8)
    acc = acc.at[idx].set(ref[3], mode="drop")
    nn = nn.at[idx].set(ref[4], mode="drop")
    t = {k: torch.from_numpy(x.copy()) for k, x in
         dict(vals=vals, cnt=cnt, slots=slots, signs=signs, v=v, notnull=notnull).items()}
    p_acc = torch.full((8,), accum_init("min", torch.int64), dtype=torch.int64)
    p_nn = torch.zeros(8, dtype=torch.int64)
    ovf, inc = torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool)
    mi.minput_apply(t["vals"], t["cnt"], t["slots"], t["signs"], t["v"], t["notnull"], "min",
                    p_acc, p_nn, ovf, inc)
    assert np.array_equal(t["vals"].numpy(), np.asarray(ref[0]))
    assert np.array_equal(t["cnt"].numpy(), np.asarray(ref[1]))
    assert np.array_equal(p_acc.numpy(), np.asarray(acc))
    assert np.array_equal(p_nn.numpy(), np.asarray(nn))
    assert bool(ovf) == bool(ref[5]) and bool(inc) == bool(ref[6])


def test_minput_clear_and_rescatter_match_reference():
    """``minput_clear`` zeroes whole groups (slot -1 writes nothing);
    ``minput_rescatter`` moves the kept groups' rows to their new slots."""
    rng = np.random.default_rng(9)
    vals, cnt = _pre_state(rng, 16, 4, POOLS["int64"], 0.6)
    slots = np.where(rng.random(16) < 0.5, np.arange(16), -1).astype(np.int32)
    _, ref_cnt = ref_mi.minput_clear(jnp.asarray(vals), jnp.asarray(cnt), jnp.asarray(slots))
    pv, pc = torch.from_numpy(vals.copy()), torch.from_numpy(cnt.copy())
    mi.minput_clear(pv, pc, torch.from_numpy(slots))
    assert np.array_equal(pc.numpy(), np.asarray(ref_cnt))
    assert np.array_equal(pv.numpy(), vals)
    keep = rng.random(16) < 0.7
    new_slots = rng.permutation(32)[:16].astype(np.int32)
    rv, rc = ref_mi.minput_rescatter(jnp.asarray(vals), jnp.asarray(cnt), jnp.asarray(keep),
                                     jnp.asarray(new_slots), 32)
    nv, nc = mi.minput_rescatter(torch.from_numpy(vals), torch.from_numpy(cnt),
                                 torch.from_numpy(keep), torch.from_numpy(new_slots), 32)
    assert np.array_equal(nv.numpy(), np.asarray(rv))
    assert np.array_equal(nc.numpy(), np.asarray(rc))


def test_create_minput_matches_reference_lanes():
    calls = (AggCall("count_star", None, "n"), AggCall("min", "a", "mn", materialized=True),
             AggCall("max", "b", "mx", materialized=True), AggCall("max", "a", "plain"))
    got = mi.create_minput(8, 4, calls, {"a": torch.int32, "b": torch.float64}, device="cpu")
    assert set(got) == {"mn", "mx"}
    assert got["mn"][0].dtype == torch.int32 and got["mx"][0].dtype == torch.int64
    assert all(c.shape == (8, 4) and c.dtype == torch.int32 for _, c in got.values())


# -- mirrors of tests/test_minput.py's executor tests ----------------------------
def _chunk(rows):
    g = np.array([r[0] for r in rows], np.int64)
    v = np.array([r[1] for r in rows], np.int64)
    ops = np.array([r[2] for r in rows], np.int32)
    return StreamChunk.from_numpy({"g": g, "v": v}, CAP, ops=ops, device="cpu")


def _mk(**kw):
    return HashAggExecutor(
        group_keys=("g",),
        calls=(
            AggCall("count_star", None, "cnt"),
            AggCall("min", "v", "mn", materialized=True),
            AggCall("max", "v", "mx", materialized=True),
        ),
        schema_dtypes=DT,
        capacity=64,
        out_cap=64,
        device="cpu",
        **kw,
    )


def test_retract_current_extreme_falls_back():
    """Delete the max -> the flush emits the next-best value."""
    ex = _mk()
    snap = {}
    _replay(snap, ex.apply(_chunk([(1, 10, Op.INSERT), (1, 30, Op.INSERT),
                                   (1, 20, Op.INSERT)])), ("g",), ("cnt", "mn", "mx"))
    _replay(snap, ex.on_barrier(None), ("g",), ("cnt", "mn", "mx"))
    assert snap == {(1,): (3, 10, 30)}
    _replay(snap, ex.apply(_chunk([(1, 30, Op.DELETE)])), ("g",), ("cnt", "mn", "mx"))
    _replay(snap, ex.on_barrier(None), ("g",), ("cnt", "mn", "mx"))
    assert snap == {(1,): (2, 10, 20)}
    _replay(snap, ex.apply(_chunk([(1, 10, Op.DELETE), (1, 20, Op.DELETE)])),
            ("g",), ("cnt", "mn", "mx"))
    _replay(snap, ex.on_barrier(None), ("g",), ("cnt", "mn", "mx"))
    assert snap == {}


@pytest.mark.parametrize("mode", ["chunk", "stacked", "epoch_batch"])
def test_random_stream_matches_oracle(mode):
    """The reference test's stream and oracle; the port's multisets and
    accumulators also equal the reference executor's lane for lane.
    ``epoch_batch``: the agg behind ``EpochBatchedAggExecutor`` (its
    buffered chunks go through ``apply_stacked``)."""
    from risingwave_tpu_torch.executors.epoch_batch import EpochBatchedAggExecutor

    rng = np.random.default_rng(11)
    ex = _mk()
    front = EpochBatchedAggExecutor([], ex) if mode == "epoch_batch" else ex
    ref = RefAgg(group_keys=("g",),
                 calls=(RefCall("count_star", None, "cnt"),
                        RefCall("min", "v", "mn", materialized=True),
                        RefCall("max", "v", "mx", materialized=True)),
                 schema_dtypes={"g": jnp.int64, "v": jnp.int64}, capacity=64, out_cap=64)
    mult = defaultdict(Counter)
    snap = {}
    for _ in range(25):
        rows = []
        for _ in range(int(rng.integers(1, 12))):
            g = int(rng.integers(0, 6))
            live = [(vv, c) for vv, c in mult[g].items() if c > 0]
            if live and rng.random() < 0.4:
                vv = live[int(rng.integers(len(live)))][0]
                rows.append((g, vv, Op.DELETE))
                mult[g][vv] -= 1
            else:
                vv = int(rng.integers(0, 15))
                rows.append((g, vv, Op.INSERT))
                mult[g][vv] += 1
        ref_chunk = RefChunk.from_numpy(
            {"g": np.array([r[0] for r in rows], np.int64),
             "v": np.array([r[1] for r in rows], np.int64)}, CAP,
            ops=np.array([r[2] for r in rows], np.int32))
        if mode == "chunk":
            outs = ex.apply(_chunk(rows))
            ref.apply(ref_chunk)
        elif mode == "epoch_batch":
            from risingwave_tpu.parallel.sharded_agg import stack_chunks as ref_stack

            outs = front.apply(_chunk(rows))
            ref.apply_stacked(ref_stack([ref_chunk]))
        else:
            from risingwave_tpu.parallel.sharded_agg import stack_chunks as ref_stack

            outs = ex.apply_stacked(stack_chunks([_chunk(rows)]))
            ref.apply_stacked(ref_stack([ref_chunk]))
        _replay(snap, outs, ("g",), ("cnt", "mn", "mx"))
        _replay(snap, front.on_barrier(None), ("g",), ("cnt", "mn", "mx"))
        ref.on_barrier(None)
        for name in ("mn", "mx"):
            for got, want in zip(ex.minput[name], ref.minput[name]):
                assert np.array_equal(got.numpy(), np.asarray(want))
            assert np.array_equal(ex.state.accums[name].numpy(),
                                  np.asarray(ref.state.accums[name]))
            assert np.array_equal(ex.state.nonnull[name].numpy(),
                                  np.asarray(ref.state.nonnull[name]))
    assert snap == _oracle(mult)


def test_apply_stacked_scan_mode_refused_with_minput():
    with pytest.raises(ValueError, match="'reduce' mode"):
        _mk().apply_stacked(stack_chunks([_chunk([(1, 2, Op.INSERT)])]), mode="scan")


def test_minput_overflow_and_inconsistency_latch():
    ex = HashAggExecutor(
        group_keys=("g",),
        calls=(AggCall("max", "v", "mx", materialized=True),),
        schema_dtypes=DT,
        capacity=64,
        out_cap=64,
        minput_k=4,
        device="cpu",
    )
    # 5 distinct values > K=4 latches overflow
    ex.apply(_chunk([(1, v, Op.INSERT) for v in range(5)]))
    with pytest.raises(RuntimeError, match="minput_k|retracted"):
        ex.on_barrier(None)
        ex.finish_barrier()

    ex2 = HashAggExecutor(
        group_keys=("g",),
        calls=(AggCall("max", "v", "mx", materialized=True),),
        schema_dtypes=DT,
        capacity=64,
        out_cap=64,
        device="cpu",
    )
    ex2.apply(_chunk([(1, 7, Op.DELETE)]))  # never inserted
    with pytest.raises(RuntimeError):
        ex2.on_barrier(None)
        ex2.finish_barrier()


def test_minput_survives_rehash():
    ex = HashAggExecutor(
        group_keys=("g",),
        calls=(AggCall("min", "v", "mn", materialized=True),),
        schema_dtypes=DT,
        capacity=8,  # tiny: force growth
        out_cap=256,
        minput_k=8,
        device="cpu",
    )
    snap = {}
    rows = [(g, g * 10 + j, Op.INSERT) for g in range(10) for j in range(2)]
    for i in range(0, len(rows), 4):
        _replay(snap, ex.apply(_chunk(rows[i : i + 4])), ("g",), ("mn",))
    _replay(snap, ex.on_barrier(None), ("g",), ("mn",))
    assert ex.table.capacity > 8
    assert ex.minput["mn"][0].shape == (ex.table.capacity, 8)
    # retract each group's current min; falls back to the +1 value
    for g in range(10):
        _replay(snap, ex.apply(_chunk([(g, g * 10, Op.DELETE)])), ("g",), ("mn",))
    _replay(snap, ex.on_barrier(None), ("g",), ("mn",))
    assert snap == {(g,): (g * 10 + 1,) for g in range(10)}


def test_watermark_clears_closed_groups_multisets():
    """A window watermark clears the closed groups' multisets before it
    frees them, as the reference's ``on_watermark``: a value re-inserted
    into a reopened group starts from an empty multiset."""
    kw = dict(group_keys=("g",), schema_dtypes=DT, capacity=64, out_cap=64,
              window_key=("g", 0, False))
    ex = HashAggExecutor(calls=(AggCall("max", "v", "mx", materialized=True),), device="cpu",
                         **kw)
    ref = RefAgg(calls=(RefCall("max", "v", "mx", materialized=True),),
                 **{**kw, "schema_dtypes": {"g": jnp.int64, "v": jnp.int64}})
    from risingwave_tpu.executors.base import Watermark as RefWatermark
    from risingwave_tpu_torch.executors.base import Watermark

    rows = [(g, v, Op.INSERT) for g in range(4) for v in (3, 8)]
    ex.apply(_chunk(rows))
    ref.apply(RefChunk.from_numpy({"g": np.array([r[0] for r in rows], np.int64),
                                   "v": np.array([r[1] for r in rows], np.int64)}, CAP))
    ex.on_barrier(None)
    ref.on_barrier(None)
    ex.on_watermark(Watermark("g", 2))
    ref.on_watermark(RefWatermark("g", 2))
    got_v, got_c = ex.minput["mx"]
    want_v, want_c = ref.minput["mx"]
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert int((got_c > 0).sum()) == 4  # groups 2 and 3 keep two values each


def test_reference_state_with_multisets_carries_over():
    """A reference executor's state, multisets included (a float MIN's
    unsigned order keys mapped into the port's key space), taken over
    slot for slot by ``load_reference_state``: the next chunks, which
    retract current extremes, give the reference's emissions and
    lanes."""
    import jax

    dts = {"g": np.int64, "v": np.int64, "f": np.float64}
    ref = RefAgg(group_keys=("g",),
                 calls=(RefCall("min", "f", "mn", materialized=True),
                        RefCall("max", "v", "mx", materialized=True)),
                 schema_dtypes={k: jnp.dtype(d) for k, d in dts.items()}, capacity=64, out_cap=64)
    port = HashAggExecutor(group_keys=("g",),
                           calls=(AggCall("min", "f", "mn", materialized=True),
                                  AggCall("max", "v", "mx", materialized=True)),
                           schema_dtypes={"g": torch.int64, "v": torch.int64,
                                          "f": torch.float64},
                           capacity=64, out_cap=64, device="cpu")
    rng = np.random.default_rng(4)

    def cols(rows):
        return {"g": np.array([r[0] for r in rows], np.int64),
                "v": np.array([r[1] for r in rows], np.int64),
                "f": np.array([r[1] * 0.5 - 3 for r in rows], np.float64)}

    live = [(int(rng.integers(0, 5)), int(rng.integers(0, 20))) for _ in range(24)]
    ref.apply(RefChunk.from_numpy(cols(live), CAP))
    ref.on_barrier(None)
    port.load_reference_state(jax.device_get({
        "table": ref.table, "state": ref.state, "dropped": ref.dropped,
        "minput": ref.minput, "mi_bad": ref.mi_bad}))
    for name, fx in (("mn", True), ("mx", False)):
        want_v = np.asarray(ref.minput[name][0])
        want_v = order_key_from_reference(want_v) if fx else want_v
        assert np.array_equal(port.minput[name][0].numpy(), want_v)
    gone = sorted(set(live), key=lambda r: -r[1])[:6]  # the largest values: extremes
    rows = [r + (Op.DELETE,) for r in gone] + [(5, 7, Op.INSERT)]
    ops = np.array([r[2] for r in rows], np.int32)
    c = cols(rows)
    got = port.apply(StreamChunk.from_numpy(c, CAP, ops=ops, device="cpu"))
    ref.apply(RefChunk.from_numpy(c, CAP, ops=ops))
    got += port.on_barrier(None)
    want = ref.on_barrier(None)
    snap_got, snap_want = {}, {}
    _replay(snap_got, got, ("g",), ("mn", "mx"))
    _replay(snap_want, want, ("g",), ("mn", "mx"))
    assert snap_got == snap_want and len(snap_got) > 0
    for name in ("mn", "mx"):
        assert np.array_equal(port.minput[name][1].numpy(), np.asarray(ref.minput[name][1]))
