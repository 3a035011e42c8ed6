"""The slice end to end: Nexmark q1 and q2, q103's subquery (the hot
auctions), RisingWave's q103 and q104, and q7 with the planner's scan
watermark filters, through the port (plain PyTorch versions on the
CPU), interpreted and through ``fuse_pipeline``, against the same
compositions of ``risingwave_tpu``'s executors on JAX-CPU at every
barrier, and against numpy oracles.

Tolerance: none. q1's price is ``0.908 * price`` in float64 on both
sides (one multiplication, exactly rounded); everything else is
integer, and state digests are uint64 folds.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu.runtime.fused_step import fused_cache_stats as ref_cache_stats
from risingwave_tpu.runtime.fused_step import fusion_refusals as ref_refusals
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.epoch_batch import EpochBatchedAggExecutor
from risingwave_tpu_torch.queries import nexmark_q as Q
from risingwave_tpu_torch.runtime.fused_step import (
    FusedChainExecutor,
    fuse_pipeline,
    fused_cache_stats,
    fusion_refusals,
    lift_plan,
)

B_COLS = ("auction", "bidder", "price", "date_time")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_build(kind: str, cap: int = 1 << 12, **kw):
    """The same plans from the reference's executors, in the reference
    planner's order."""
    import jax.numpy as jnp
    from risingwave_tpu.executors import (
        FilterExecutor,
        HashAggExecutor,
        HashJoinExecutor,
        ProjectExecutor,
        RowIdGenExecutor,
    )
    from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu.expr import expr as E
    from risingwave_tpu.expr.functions import Func
    from risingwave_tpu.ops.agg import AggCall
    from risingwave_tpu.runtime import Pipeline, TwoInputPipeline

    i64 = jnp.int64
    if kind == "q1":
        mv = DeviceMaterializeExecutor(
            pk=("_row_id",), columns=("auction", "bidder", "price", "date_time"),
            schema_dtypes={"_row_id": i64, "auction": i64, "bidder": i64,
                           "price": jnp.float64, "date_time": i64},
            table_id="q1.mview", capacity=cap)
        proj = ProjectExecutor({"auction": E.col("auction"), "bidder": E.col("bidder"),
                                "price": E.lit(Q.Q1_RATE) * E.col("price"),
                                "date_time": E.col("date_time"), "_row_id": E.col("_row_id")})
        return Pipeline([RowIdGenExecutor(table_id="q1.rowid"), proj, mv]), mv
    if kind == "q2":
        mv = DeviceMaterializeExecutor(
            pk=("_row_id",), columns=("auction", "price"),
            schema_dtypes={"_row_id": i64, "auction": i64, "price": i64},
            table_id="q2.mview", capacity=cap)
        where = FilterExecutor(Func("mod", (E.col("auction"), E.lit(Q.Q2_MODULUS))) == E.lit(0))
        proj = ProjectExecutor({"auction": E.col("auction"), "price": E.col("price"),
                                "_row_id": E.col("_row_id")})
        return Pipeline([where, RowIdGenExecutor(table_id="q2.rowid"), proj, mv]), mv

    def agg(tid):
        return HashAggExecutor(group_keys=("auction",), calls=(AggCall("count_star", None, "num"),),
                               schema_dtypes={"auction": i64}, capacity=cap, table_id=tid)

    having = FilterExecutor(E.BinOp(kw["op"], E.col("num"), E.lit(kw["threshold"])))
    if kind == "hot":
        a = agg("hot.agg")
        mv = DeviceMaterializeExecutor(pk=("auction",), columns=("num",),
                                       schema_dtypes={"auction": i64, "num": i64},
                                       table_id="hot.mview", capacity=max(1 << 12, cap))
        return Pipeline([a, having, mv]), mv, a
    anti = kind == "q104"
    a = agg(f"{kind}.agg")
    join = HashJoinExecutor(left_keys=("id",), right_keys=("auction",), left_dtypes={"id": i64},
                            right_dtypes={"auction": i64}, capacity=cap, fanout=4,
                            out_cap=1 << 11, join_type="left_anti" if anti else "left_semi",
                            table_id=f"{kind}.join")
    mv = DeviceMaterializeExecutor(pk=("id",), columns=(), schema_dtypes={"id": i64},
                                   table_id=f"{kind}.mview", capacity=max(1 << 12, cap))
    pipe = TwoInputPipeline([], [a, having], join, [ProjectExecutor({"id": E.col("id")}), mv])
    return pipe, mv, a, join


def _stream(epochs, events, seed=3, rate=10_000):
    """Per epoch the auction ids and the bids of ``events`` events."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    out = []
    for _ in range(epochs):
        ev = gen.next_events(events)
        out.append(({"id": ev["auction"]["id"]}, {k: ev["bid"][k] for k in B_COLS}))
    return out


def _mk(port: bool):
    return (lambda c, cap: StreamChunk.from_numpy(c, cap, device="cpu")) if port else (
        lambda c, cap: RefChunk.from_numpy(c, cap))


def _push_bids(pipeline, bids, port: bool, cap: int = 1024, right: bool = False):
    mk = _mk(port)
    for lo in range(0, len(bids["auction"]), cap):
        c = mk({k: v[lo:lo + cap] for k, v in bids.items()}, cap)
        (pipeline.push_right if right else pipeline.push)(c)


def _mv_digest(port: bool, mv) -> int:
    if port:
        return integrity.host_digest(*integrity.host_lanes(*integrity.mv_lanes(mv.table,
                                                                               mv.state)))
    lanes, live = ref_integrity.mv_lanes(mv.table, mv.state)
    return ref_integrity.host_digest({k: np.asarray(v) for k, v in lanes.items()},
                                     np.asarray(live))


def _agg_digest(port: bool, agg) -> int:
    if port:
        return integrity.host_digest(*integrity.host_lanes(
            *integrity.agg_lanes(agg.table, agg.state, agg._float_extremes)))
    lanes, live = ref_integrity.agg_lanes(agg.table, agg.state)
    return ref_integrity.host_digest({k: np.asarray(v) for k, v in lanes.items()},
                                     np.asarray(live))


@pytest.mark.parametrize("kind", ["q1", "q2"])
@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_stateless_queries_match_reference_at_every_barrier(kind, fuse):
    """q1 and q2 (RowIdGen, Project, Filter, a device MV on _row_id):
    MV snapshots and digests equal at every barrier, and the numpy
    oracle of the same rows and expressions. Through fuse_pipeline both
    packages leave the MV run interpreted (its feeder, RowIdGen, emits
    a passthrough shape) and record the same refusal."""
    ref_pipe, ref_mv = _ref_build(kind, cap=1 << 13)
    port = (Q.build_q1 if kind == "q1" else Q.build_q2)(1 << 13, device="cpu")
    if fuse:
        ref_refusals(clear=True)
        fusion_refusals(clear=True)
        assert ref_fuse(ref_pipe, label=kind) == [] == fuse_pipeline(port.pipeline, label=kind)
        assert fusion_refusals() == ref_refusals()
        assert fusion_refusals()[0]["executor"] == "RowIdGenExecutor"
    rows = []
    for _, bids in _stream(3, 3000):
        _push_bids(ref_pipe, bids, port=False)
        _push_bids(port.pipeline, bids, port=True)
        ref_pipe.barrier()
        port.pipeline.barrier()
        assert port.mview.snapshot() == ref_mv.snapshot()
        assert _mv_digest(True, port.mview) == _mv_digest(False, ref_mv)
        rows.append(bids)
    bids = {k: np.concatenate([r[k] for r in rows]) for k in B_COLS}
    got = sorted(port.mview.snapshot().values())
    if kind == "q1":
        want = sorted(zip(bids["auction"].tolist(), bids["bidder"].tolist(),
                          (Q.Q1_RATE * bids["price"]).tolist(), bids["date_time"].tolist()))
    else:
        keep = bids["auction"] % Q.Q2_MODULUS == 0
        want = sorted(zip(bids["auction"][keep].tolist(), bids["price"][keep].tolist()))
        assert 0 < len(want) < len(bids["auction"])
    assert got == want


def _hot_oracle(stream, threshold, op):
    counts = {}
    for _, bids in stream:
        for a in bids["auction"].tolist():
            counts[a] = counts.get(a, 0) + 1
    test = (lambda n: n >= threshold) if op == ">=" else (lambda n: n < threshold)
    return {(a,): (n,) for a, n in counts.items() if test(n)}


@pytest.mark.parametrize("op", [">=", "<"])
@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_hot_auctions_match_reference_at_every_barrier(op, fuse):
    """q103's subquery: HashAgg -> Filter(HAVING) -> MV, the filter
    turning the torn halves of update pairs into inserts and deletes.
    Fused, both packages lift the threshold into a parameter slot and
    stage the same digests."""
    ref_pipe, ref_mv, ref_agg = _ref_build("hot", cap=1 << 12, op=op, threshold=Q.HOT_BIDS)
    port = Q.build_hot_auctions(Q.HOT_BIDS, op, capacity=1 << 12, device="cpu")
    if fuse:
        before, ref_before = fused_cache_stats(), ref_cache_stats()
        (rw,) = ref_fuse(ref_pipe, label="hot")
        (pw,) = fuse_pipeline(port.pipeline, label="hot")
        assert isinstance(pw, FusedChainExecutor) and pw.plan.mid is not None
    stream = _stream(4, 3000)
    for epoch in stream:
        _push_bids(ref_pipe, epoch[1], port=False)
        _push_bids(port.pipeline, epoch[1], port=True)
        ref_pipe.barrier()
        port.pipeline.barrier()
        assert port.mview.snapshot() == ref_mv.snapshot()
        assert _mv_digest(True, port.mview) == _mv_digest(False, ref_mv)
        assert _agg_digest(True, port.agg) == _agg_digest(False, ref_agg)
        if fuse:
            assert pw.last_digests == rw.last_digests
            assert pw._lift_state == rw._lift_state == "on"
    if fuse:
        lifted = fused_cache_stats()["plans_lifted"] - before["plans_lifted"]
        assert lifted == ref_cache_stats()["plans_lifted"] - ref_before["plans_lifted"] == 1
    got = port.mview.snapshot()
    assert got == _hot_oracle(stream, Q.HOT_BIDS, op) and len(got) > 0


def test_two_thresholds_lift_to_one_plan():
    """Two hot-auction plans that differ only in the threshold lift to
    equal plans (one compiled kernel-S program on the card) with two
    parameter vectors, as the reference's lift_plan gives."""
    from risingwave_tpu.runtime.fused_step import lift_plan as ref_lift

    plans, params = [], []
    for t in (20, 25):
        (w,) = fuse_pipeline(Q.build_hot_auctions(t, ">=", capacity=1 << 8,
                                                  device="cpu").pipeline)
        lifted, p = lift_plan(w.plan, "cpu")
        plans.append(lifted)
        params.append(p["i"].tolist())
        ref_pipe, _, _ = _ref_build("hot", cap=1 << 8, op=">=", threshold=t)
        (rw,) = ref_fuse(ref_pipe)
        _, rp = ref_lift(rw.plan)
        assert np.asarray(rp["i"]).tolist() == p["i"].tolist() == [t]
    assert plans[0] == plans[1] and hash(plans[0]) == hash(plans[1])
    assert params == [[20], [25]]
    (w20,) = fuse_pipeline(Q.build_hot_auctions(20, ">=", capacity=1 << 8, device="cpu").pipeline)
    (w20b,) = fuse_pipeline(Q.build_hot_auctions(20, "<", capacity=1 << 8, device="cpu").pipeline)
    assert lift_plan(w20.plan, "cpu")[0] != lift_plan(w20b.plan, "cpu")[0]


def _semi_oracle(stream, anti: bool):
    counts, ids = {}, []
    for auctions, bids in stream:
        ids += auctions["id"].tolist()
        for a in bids["auction"].tolist():
            counts[a] = counts.get(a, 0) + 1
    if anti:  # NOT IN (count < 20): no bids yet, or at least 20
        return {(i,): () for i in ids if not 0 < counts.get(i, 0) < Q.HOT_BIDS}
    return {(i,): () for i in ids if counts.get(i, 0) >= Q.HOT_BIDS}


@pytest.mark.parametrize("kind", ["q103", "q104"])
@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_semi_anti_queries_match_reference_at_every_barrier(kind, fuse):
    """q103 / q104: auctions left, bids through the count agg and the
    HAVING filter right, a left semi / anti join, an MV on id. Through
    fuse_pipeline both packages refuse the whole program for the same
    reason and fall back per chain the same way; MVs, agg and join-side
    digests equal at every barrier; the final MV equals the oracle."""
    anti = kind == "q104"
    threshold, op = Q.HOT_BIDS, "<" if anti else ">="
    ref_pipe, ref_mv, ref_agg, ref_join = _ref_build(kind, cap=1 << 12, op=op,
                                                     threshold=threshold)
    port = (Q.build_q104 if anti else Q.build_q103)(1 << 12, out_cap=1 << 11, device="cpu")
    if fuse:
        ref_refusals(clear=True)
        fusion_refusals(clear=True)
        ref_created = ref_fuse(ref_pipe, label=kind)
        created = fuse_pipeline(port.pipeline, label=kind)
        assert fusion_refusals() == ref_refusals()
        (rec,) = fusion_refusals()
        assert rec["fragment"] == f"{kind}/right" and rec["executor"] == "FilterExecutor"
        shape = lambda p: [[type(e).__name__ for e in getattr(p, a)]
                           for a in ("left", "right", "tail")]
        assert shape(port.pipeline) == shape(ref_pipe) == [
            [], ["EpochBatchedAggExecutor", "FilterExecutor"], ["FusedChainExecutor"]]
        assert len(created) == len(ref_created) == 1
        assert isinstance(port.pipeline.right[0], EpochBatchedAggExecutor)
    stream = _stream(4, 4000)
    mk_r, mk_p = _mk(False), _mk(True)
    for auctions, bids in stream:
        ref_pipe.push_left(mk_r(auctions, 512))
        port.pipeline.push_left(mk_p(auctions, 512))
        _push_bids(ref_pipe, bids, port=False, right=True)
        _push_bids(port.pipeline, bids, port=True, right=True)
        ref_pipe.barrier()
        port.pipeline.barrier()
        assert port.mview.snapshot() == ref_mv.snapshot()
        assert _mv_digest(True, port.mview) == _mv_digest(False, ref_mv)
        assert _agg_digest(True, port.agg) == _agg_digest(False, ref_agg)
        jl, jr = port.join.side_digests()
        side = lambda s: ref_integrity.host_digest(*ref_integrity.join_side_lanes(s, np.where))
        assert (jl, jr) == (side(ref_join.left), side(ref_join.right))
    got = port.mview.snapshot()
    assert got == _semi_oracle(stream, anti) and len(got) > 0


# -- q7 with the planner's scan watermark filters ----------------------------

Q7_LAG_MS = 1000  # tests/test_watermark_filter.py's lag


def _q7_with_scan_filters(port: bool, cap: int = 1 << 12):
    sizes = dict(capacity=cap, fanout=8, out_cap=1 << 11, agg_capacity=cap >> 2,
                 filter_capacity=cap >> 2)
    if port:
        from risingwave_tpu_torch.executors.watermark_filter import WatermarkFilterExecutor

        q7 = Q.build_q7(**sizes, device="cpu")
        mk = lambda: WatermarkFilterExecutor("date_time", Q7_LAG_MS, device="cpu")
    else:
        from risingwave_tpu.executors import WatermarkFilterExecutor
        from risingwave_tpu.queries.nexmark_q import build_q7 as ref_build

        q7 = ref_build(**sizes)
        mk = lambda: WatermarkFilterExecutor("date_time", Q7_LAG_MS)
    q7.pipeline.left.insert(0, mk())
    q7.pipeline.right.insert(0, mk())
    return q7


def test_q7_with_scan_watermark_filters_matches_reference():
    """q7 as the planner builds it over a ``WATERMARK FOR date_time``
    source: a WatermarkFilter at the head of both sides and no injected
    watermark calls. The generated watermarks walk each side, align at
    the join and clean every table; both packages equal at every
    barrier, and fuse_pipeline refuses a side holding the filter as the
    reference does."""
    ref, port = _q7_with_scan_filters(False), _q7_with_scan_filters(True)
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=3)
    mx = None
    for _ in range(5):
        for _ in range(2):
            b = gen.next_events(1500)["bid"]
            cols = {k: b[k] for k in B_COLS}
            for pipe, mk in ((ref.pipeline, _mk(False)), (port.pipeline, _mk(True))):
                pipe.push_left(mk(cols, 2048))
                pipe.push_right(mk(cols, 2048))
            mx = int(cols["date_time"].max())
        ref.pipeline.barrier()
        port.pipeline.barrier()
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert _mv_digest(True, port.mview) == _mv_digest(False, ref.mview)
        assert _agg_digest(True, port.agg) == _agg_digest(False, ref.agg)
        for i in (0, 1):
            pw, rw = port.pipeline.left[0] if i == 0 else port.pipeline.right[0], (
                ref.pipeline.left[0] if i == 0 else ref.pipeline.right[0])
            assert pw._wm == rw._wm == mx - Q7_LAG_MS
    assert port.agg.cleaning_watermarks() == ref.agg.cleaning_watermarks()
    assert len(port.mview.snapshot()) > 0
    # the closed windows are gone from the agg: no live window starts
    # below the last watermark's window
    live = port.agg.table.keys[0][port.agg.table.live]
    assert live.numel() and int(live.min()) >= (mx - Q7_LAG_MS) // Q.Q7_WINDOW_MS * Q.Q7_WINDOW_MS \
        - Q.Q7_WINDOW_MS
    ref_refusals(clear=True)
    fusion_refusals(clear=True)
    again, ref_again = _q7_with_scan_filters(True), _q7_with_scan_filters(False)
    fuse_pipeline(again.pipeline, label="q7")
    ref_fuse(ref_again.pipeline, label="q7")
    assert again.pipeline._fused is None
    (got, *_), (want, *_) = fusion_refusals(), ref_refusals()
    # the port's message adds why (its agg side is the right one only)
    assert {k: got[k] for k in ("code", "fragment", "executor")} == {
        k: want[k] for k in ("code", "fragment", "executor")}
    assert got["message"].startswith(want["message"])
    assert got["executor"] == "WatermarkFilterExecutor"
