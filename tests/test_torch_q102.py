"""RisingWave's Nexmark q102 through the port: the auctions with at least
the average number of bids,

    SELECT a.id, a.item_name, COUNT(b.auction) AS bid_count
    FROM auction a JOIN bid b ON a.id = b.auction
    GROUP BY a.id, a.item_name
    HAVING COUNT(b.auction) >= (SELECT COUNT(*) / COUNT(DISTINCT auction) FROM bid)

as ``build_q102`` plans it (two pipelines: the count per auction joined
with the auctions; a dynamic filter of that join's U-/U+ stream against
a SimpleAgg over a second count, a device MV), interpreted and with
each stage through ``fuse_pipeline``, against the same plan composed
from ``risingwave_tpu``'s executors on JAX-CPU and a numpy oracle, at
every barrier. Plain PyTorch versions on the CPU; every comparison
exact.
"""

import jax.numpy as jnp
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu.runtime.fused_step import fusion_refusals as ref_refusals
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.queries.nexmark_q import Q102, build_q102
from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_q102(cap) -> Q102:
    """The same plan from the reference's executors, driven in the same
    lockstep order."""
    from risingwave_tpu.executors import (
        HashAggExecutor,
        HashJoinExecutor,
        ProjectExecutor,
        SimpleAggExecutor,
    )
    from risingwave_tpu.executors.dynamic_filter import DynamicFilterExecutor
    from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu.expr.expr import col
    from risingwave_tpu.ops.agg import AggCall
    from risingwave_tpu.runtime import TwoInputPipeline

    i64 = jnp.int64

    def count(table_id):
        return HashAggExecutor(group_keys=("auction",),
                               calls=(AggCall("count_star", None, "bid_count"),),
                               schema_dtypes={"auction": i64}, capacity=cap, table_id=table_id)

    join = HashJoinExecutor(left_keys=("id",), right_keys=("auction",),
                            left_dtypes={"id": i64, "item_name": jnp.int32},
                            right_dtypes={"auction": i64, "bid_count": i64}, capacity=cap,
                            fanout=4, out_cap=1 << 11, join_type="inner", table_id="q102.join")
    simple = SimpleAggExecutor((AggCall("count_star", None, "n_auctions"),
                                AggCall("sum", "bid_count", "n_bids")), {"bid_count": i64},
                               table_id="q102.avg")
    project = ProjectExecutor({"bid_count": col("n_bids") // col("n_auctions")})
    dt = {"id": i64, "item_name": jnp.int32, "auction": i64, "bid_count": i64}
    dfilter = DynamicFilterExecutor("bid_count", ">=", ("id", "auction"), dt, capacity=cap,
                                    table_id="q102.filter")
    mview = DeviceMaterializeExecutor(pk=("id", "auction"), columns=("item_name", "bid_count"),
                                      schema_dtypes=dt, table_id="q102.mview", capacity=cap)
    stage1 = TwoInputPipeline([], [count("q102.count")], join, [])
    stage2 = TwoInputPipeline([], [count("q102.count2"), simple, project], dfilter, [mview])
    return Q102(stage1, stage2, None)


def _port_q102(cap) -> Q102:
    return build_q102(capacity=cap, out_cap=1 << 11, device="cpu")


def _stream(epochs, events=3000, seed=5, first_without_bids=False):
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=seed)
    out = []
    for e in range(epochs):
        ev = gen.next_events(events)
        bids = {k: ev["bid"][k] for k in ("auction", "price")}
        if first_without_bids and e == 0:
            bids = {k: v[:0] for k, v in bids.items()}
        out.append(({k: ev["auction"][k] for k in ("id", "item_name")}, bids))
    return out


def _drive(q: Q102, epoch, port: bool):
    mk = (lambda c, cap: StreamChunk.from_numpy(c, cap, device="cpu")) if port else (
        lambda c, cap: RefChunk.from_numpy(c, cap))
    auctions, bids = epoch
    q.push_auction(mk(auctions, 256))
    for lo in range(0, len(bids["auction"]), 1024):
        q.push_bid(mk({k: v[lo:lo + 1024] for k, v in bids.items()}, 1024))
    return q.barrier()


def _oracle(stream) -> dict:
    """Per-auction counts of every bid so far, rv = all bids // auctions
    with a bid, the inner join with the auctions seen so far, the rows
    with count >= rv; keyed on (id, auction)."""
    counts, items = {}, {}
    for auctions, bids in stream:
        items.update(zip(auctions["id"].tolist(), auctions["item_name"].tolist()))
        for a in bids["auction"].tolist():
            counts[a] = counts.get(a, 0) + 1
    if not counts:
        return {}
    rv = sum(counts.values()) // len(counts)
    return {(a, a): (items[a], c) for a, c in counts.items() if a in items and c >= rv}


def _digests(q: Q102) -> dict:
    return {n: getattr(q, n).state_digest()
            for n in ("count", "count2", "simple", "dfilter", "mview")}


def _fuse_both(q: Q102, label: str, fuse) -> list:
    return (fuse(q.stage1, label=f"{label}/1") + fuse(q.stage2, label=f"{label}/2"))


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q102_matches_reference_at_every_barrier(fuse):
    """Both packages' q102 over the same epochs: the MV snapshot and the
    digests of both counts, the SimpleAgg, the filter and the MV equal at
    every barrier, and the MV equals the numpy oracle; the filter both
    promotes and retracts rows on its own (the average moves both ways).
    Fused, the same decision as the reference's: stage 1 one
    ``FusedTwoInputExecutor``; stage 2's whole program refused (the
    two-input executor is a dynamic filter), then its chains per chain,
    the join-fed MV tail left interpreted, with the same refusals."""
    rq, q = _ref_q102(1 << 10), _port_q102(1 << 10)
    if fuse:
        ref_refusals(clear=True)
        fusion_refusals(clear=True)
        made = _fuse_both(q, "q102", fuse_pipeline)
        ref_made = _fuse_both(rq, "q102", ref_fuse)
        assert [type(w).__name__ for w in made] == [type(w).__name__ for w in ref_made] == [
            "FusedTwoInputExecutor"]
        got, want = fusion_refusals(), ref_refusals()
        assert [(r["code"], r["fragment"], r["executor"], r["message"]) for r in got] == [
            (r["code"], r["fragment"], r["executor"], r["message"]) for r in want]
        assert [(r["fragment"], r["executor"]) for r in got] == [
            ("q102/2", "DynamicFilterExecutor"), ("q102/2/tail", "DynamicFilterExecutor")]
        for side in ("left", "right", "tail"):
            assert [type(e).__name__ for e in getattr(q.stage2, side)] == [
                type(e).__name__ for e in getattr(rq.stage2, side)]
        assert [type(e).__name__ for e in q.stage2.right] == [
            "EpochBatchedAggExecutor", "SimpleAggExecutor", "ProjectExecutor"]
    stream = _stream(6)
    moved = {"up": 0, "down": 0}
    for i, epoch in enumerate(stream):
        _drive(rq, epoch, port=False)
        outs = _drive(q, epoch, port=True)
        want = _oracle(stream[:i + 1])
        assert q.mview.snapshot() == rq.mview.snapshot() == want
        assert _digests(q) == _digests(rq)
        for o in outs:
            ops = o.to_numpy()["__op__"]
            moved["down"] += int((ops == 1).sum())
            moved["up"] += int((ops == 0).sum())
    assert len(q.mview.snapshot()) > 10 and moved["down"] and moved["up"]


def test_q102_fused_equals_interpreted():
    snaps = []
    for fuse in (False, True):
        q = _port_q102(1 << 10)
        if fuse:
            _fuse_both(q, "q102", fuse_pipeline)
        got = []
        for epoch in _stream(4, seed=13):
            _drive(q, epoch, port=True)
            got.append((q.mview.snapshot(), q.dfilter.state_digest(), q.simple.state_digest()))
        snaps.append(got)
    assert snaps[0] == snaps[1] and snaps[0][-1][0]


def test_q102_first_epoch_without_bids_matches_reference():
    """An epoch with no bid: the SimpleAgg emits (0, NULL), the Project's
    ``NULL // 0`` is NULL with the placeholder 0 in its lane, and the
    filter takes 0 as a valid right value (its ``apply_right`` reads no
    NULL lane), where SQL would compare against NULL. No left row exists
    yet, so the MV stays empty either way; later epochs are exact (ROADMAP
    Queue 3, limits of the reference plan)."""
    rq, q = _ref_q102(1 << 10), _port_q102(1 << 10)
    stream = _stream(3, seed=3, first_without_bids=True)
    for i, epoch in enumerate(stream):
        _drive(rq, epoch, port=False)
        _drive(q, epoch, port=True)
        if i == 0:
            assert bool(q.dfilter.rv_valid) and int(q.dfilter.rv) == 0
            assert bool(rq.dfilter.rv_valid) and int(rq.dfilter.rv) == 0
        assert q.mview.snapshot() == rq.mview.snapshot() == _oracle(stream[:i + 1])
        assert _digests(q) == _digests(rq)
