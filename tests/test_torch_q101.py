"""Nexmark q101 through the port: each auction LEFT OUTER JOIN its
maximum bid,

    SELECT a.id, a.item_name, b.max_price
    FROM auction a LEFT OUTER JOIN
         (SELECT auction, MAX(price) AS max_price FROM bid GROUP BY auction) b
    ON a.id = b.auction

planned from executors as the reference plans it (a plain left input;
``HashAgg`` MAX on the right, whose flush feeds the join's right
arrival; ``HashJoin(join_type="left")``; a device MV keyed on the
join's stream key ``(id, auction)``), interpreted and fused, against
the same plan composed from ``risingwave_tpu``'s executors on JAX-CPU
and against a numpy oracle. Plain PyTorch versions on the CPU.

Every comparison is exact: q101 has no float lanes, and state digests
are uint64 folds.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu.runtime.fused_step import fusion_refusals as ref_refusals
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.runtime.fused_step import (
    FusedTwoInputExecutor,
    fuse_pipeline,
    fusion_refusals,
)

A_COLS = ("id", "item_name")
B_COLS = ("auction", "price")
STREAM_KEY = ("id", "auction")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _build(port: bool, cap: int = 1 << 12, agg_out_cap: int = 1 << 9, out_cap: int = 1 << 11,
           mv_pk=STREAM_KEY, materialized: bool = False):
    """The q101 plan from one package's executors (``materialized``: the
    right-hand MAX keeps its input, a retractable MAX, with the SQL
    planner's 256 distinct values per group). Returns (pipeline, agg,
    join, mview)."""
    if port:
        from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
        from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor
        from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
        from risingwave_tpu_torch.ops.agg import AggCall
        from risingwave_tpu_torch.runtime.pipeline import TwoInputPipeline

        i32, i64, dev = torch.int32, torch.int64, {"device": "cpu"}
    else:
        import jax.numpy as jnp
        from risingwave_tpu.executors import HashAggExecutor, HashJoinExecutor
        from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor
        from risingwave_tpu.ops.agg import AggCall
        from risingwave_tpu.runtime import TwoInputPipeline

        i32, i64, dev = jnp.int32, jnp.int64, {}
    agg = HashAggExecutor(group_keys=("auction",),
                          calls=(AggCall("max", "price", "max_price", materialized=materialized),),
                          schema_dtypes={"auction": i64, "price": i64}, capacity=cap,
                          out_cap=agg_out_cap, table_id="q101.maxbid",
                          **({"minput_k": 256} if materialized else {}), **dev)
    join = HashJoinExecutor(left_keys=("id",), right_keys=("auction",),
                            left_dtypes={"id": i64, "item_name": i32},
                            right_dtypes={"auction": i64, "max_price": i64}, capacity=cap,
                            fanout=4, out_cap=out_cap, right_nullable=("max_price",),
                            join_type="left", table_id="q101.join", **dev)
    columns = tuple(c for c in ("item_name", "auction", "max_price") if c not in mv_pk)
    mview = DeviceMaterializeExecutor(
        pk=mv_pk, columns=columns,
        schema_dtypes={"id": i64, "item_name": i32, "auction": i64, "max_price": i64},
        nullable=tuple(c for c in ("auction", "max_price") if c in columns),
        capacity=2 * cap, table_id="q101.mview", **dev,
    )
    return TwoInputPipeline([], [agg], join, [mview]), agg, join, mview


def _stream(epochs, events, seed=3, rate=10_000):
    """Per epoch the auctions (id, item_name) and the bids (auction,
    price) of ``events`` generated events."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    out = []
    for _ in range(epochs):
        ev = gen.next_events(events)
        out.append(({k: ev["auction"][k] for k in A_COLS}, {k: ev["bid"][k] for k in B_COLS}))
    return out


def _drive(pipeline, epoch, port: bool, a_cap: int = 512, b_cap: int = 1024):
    """The epoch's auctions left, then its bids right in ``b_cap``-row
    pieces, then the barrier."""
    mk = (lambda c, cap: StreamChunk.from_numpy(c, cap, device="cpu")) if port else (
        lambda c, cap: RefChunk.from_numpy(c, cap))
    auctions, bids = epoch
    pipeline.push_left(mk(auctions, a_cap))
    for lo in range(0, len(bids["auction"]), b_cap):
        pipeline.push_right(mk({k: v[lo:lo + b_cap] for k, v in bids.items()}, b_cap))
    pipeline.barrier()


def _oracle(stream):
    """Every auction with its item and its maximum bid (None without
    bids), keyed on the join's stream key (id, auction); an unmatched
    auction's NULL auction lane holds 0."""
    best = {}
    for _, bids in stream:
        for a, p in zip(bids["auction"].tolist(), bids["price"].tolist()):
            best[a] = max(best.get(a, p), p)
    out = {}
    for auctions, _ in stream:
        for i, item in zip(auctions["id"].tolist(), auctions["item_name"].tolist()):
            out[(i, i if i in best else 0)] = (item, best.get(i))
    return out


def _port_digests(agg, join, mview):
    jl, jr = join.side_digests()
    host = lambda lanes_live: integrity.host_digest(*integrity.host_lanes(*lanes_live))
    return {"right": host(integrity.agg_lanes(agg.table, agg.state, agg._float_extremes)),
            "join_left": jl, "join_right": jr,
            "mv": host(integrity.mv_lanes(mview.table, mview.state))}


def _ref_digests(agg, join, mview):
    np_lanes = lambda lanes, live: ({k: np.asarray(v) for k, v in lanes.items()},
                                    np.asarray(live))
    side = lambda s: ref_integrity.host_digest(*ref_integrity.join_side_lanes(s, np.where))
    return {"right": ref_integrity.host_digest(*np_lanes(*ref_integrity.agg_lanes(agg.table,
                                                                                  agg.state))),
            "join_left": side(join.left), "join_right": side(join.right),
            "mv": ref_integrity.host_digest(*np_lanes(*ref_integrity.mv_lanes(mview.table,
                                                                            mview.state)))}


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q101_matches_reference_at_every_barrier(fuse):
    """Both packages' q101 over the same epochs: the MV snapshot and the
    agg, join-side and MV digests equal at every barrier (degrees
    included); fused, also the staged digests and the telemetry
    counters; the final MV equals the numpy oracle."""
    ref, port = _build(port=False), _build(port=True)
    if fuse:
        ref_refusals(clear=True)
        fusion_refusals(clear=True)
        (rw,) = ref_fuse(ref[0], label="q101")
        (pw,) = fuse_pipeline(port[0], label="q101")
        assert isinstance(pw, FusedTwoInputExecutor) and pw.agg is port[1]
        assert ref_refusals() == [] and fusion_refusals() == []
    stream = _stream(4, 4000)
    for epoch in stream:
        _drive(ref[0], epoch, port=False)
        _drive(port[0], epoch, port=True)
        assert port[3].snapshot() == ref[3].snapshot()
        assert _port_digests(*port[1:]) == _ref_digests(*ref[1:])
        if fuse:
            assert pw.last_digests == rw.last_digests
            assert pw.last_digests == _port_digests(*port[1:])
            tel = {k: rw._telemetry[k]
                   for k in ("rows_left", "rows_right", "join_rows", "dirty_groups", "mv_rows")}
            assert {k: pw.last_telemetry[k] for k in tel} == tel
            assert tel["join_rows"] == tel["mv_rows"] > 0
    got = port[3].snapshot()
    assert got == _oracle(stream)
    assert any(v[1] is None for v in got.values()) and any(k[1] for k in got)
    assert bool((port[2].left.degree > 0).any())


def test_q101_fused_equals_interpreted():
    """The port's fused q101 and its interpreted q101: equal MV
    snapshots at every barrier, flush rounds of several U-/U+ chunks."""
    snaps = []
    for fuse in (False, True):
        pipeline, *_, mview = _build(port=True, agg_out_cap=1 << 7)
        if fuse:
            (w,) = fuse_pipeline(pipeline, label="q101")
            assert isinstance(w, FusedTwoInputExecutor)
        got = []
        for epoch in _stream(3, 3000, seed=11):
            _drive(pipeline, epoch, port=True)
            got.append(mview.snapshot())
        snaps.append(got)
    assert snaps[0] == snaps[1]


def test_q101_mv_keyed_on_id_alone_loses_rows_as_the_reference():
    """With MV pk (id,) instead of the stream key, a right arrival
    writes its pair Insert (X, item, X, max) and, after it in the same
    chunk, the went-positive Delete (X, item, NULL, NULL); the upsert MV
    keeps the last row per pk, so the auction vanishes. The port loses
    exactly the reference's rows, at every barrier."""
    ref = _build(port=False, mv_pk=("id",))
    port = _build(port=True, mv_pk=("id",))
    stream = _stream(3, 4000)
    for epoch in stream:
        _drive(ref[0], epoch, port=False)
        _drive(port[0], epoch, port=True)
        assert port[3].snapshot() == ref[3].snapshot()
    got = port[3].snapshot()
    want = _oracle(stream)
    assert len(got) < len(want)
    for (i,), (item, auction, mx) in got.items():
        assert want.get((i, auction or 0)) == (item, mx)


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q101_materialized_max_matches_reference_at_every_barrier(fuse):
    """q101 with its right-hand MAX materialized (the two-input
    program's agg side runs the minput pass): both packages equal at
    every barrier (MV, digests; fused, the staged digests and the
    telemetry), the multisets lane for lane, and the answers those of
    the append-only MAX, the numpy oracle's."""
    ref = _build(port=False, materialized=True)
    port = _build(port=True, materialized=True)
    plain = _build(port=True)
    if fuse:
        (rw,) = ref_fuse(ref[0], label="q101")
        (pw,) = fuse_pipeline(port[0], label="q101")
        (plain_w,) = fuse_pipeline(plain[0], label="q101")
        assert isinstance(pw, FusedTwoInputExecutor)
        assert any(c.materialized for c in pw.plan.right.agg.calls)
        assert not any(c.materialized for c in plain_w.plan.right.agg.calls)
    stream = _stream(3, 3000, seed=5)
    for epoch in stream:
        _drive(ref[0], epoch, port=False)
        _drive(port[0], epoch, port=True)
        _drive(plain[0], epoch, port=True)
        assert port[3].snapshot() == ref[3].snapshot() == plain[3].snapshot()
        assert _port_digests(*port[1:]) == _ref_digests(*ref[1:])
        for got, want in zip(port[1].minput["max_price"], ref[1].minput["max_price"]):
            assert np.array_equal(got.numpy(), np.asarray(want))
        if fuse:
            assert pw.last_digests == rw.last_digests == plain_w.last_digests
            tel = {k: rw._telemetry[k]
                   for k in ("rows_left", "rows_right", "join_rows", "dirty_groups", "mv_rows")}
            assert {k: pw.last_telemetry[k] for k in tel} == tel
    assert not bool(port[1].mi_bad)
    assert port[3].snapshot() == _oracle(stream)
