"""RisingWave's Nexmark q105 through the port: the auctions with the
most bids,

    SELECT a.id, a.item_name, COUNT(b.auction) AS bid_count
    FROM auction a JOIN bid b ON a.id = b.auction
    GROUP BY a.id, a.item_name ORDER BY bid_count DESC LIMIT 1000

as ``build_q105`` plans it (the count per auction before the join, an
inner join with the auctions, the plain retractable TopN keyed on the
join's stream key, a device MV), interpreted and through
``fuse_pipeline``, against the same chain composed from
``risingwave_tpu``'s executors on JAX-CPU and a numpy oracle. The
agg's U-/U+ pairs reach the TopN through the join, so its input
retracts. Plain PyTorch versions on the CPU; every comparison exact.
"""

import jax.numpy as jnp
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu.runtime.fused_step import fusion_refusals as ref_refusals
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.queries.nexmark_q import build_q105
from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals

LIMIT = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_q105(cap):
    from risingwave_tpu.executors import HashAggExecutor, HashJoinExecutor, TopNExecutor
    from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu.ops.agg import AggCall
    from risingwave_tpu.runtime import TwoInputPipeline

    i64 = jnp.int64
    agg = HashAggExecutor(group_keys=("auction",),
                          calls=(AggCall("count_star", None, "bid_count"),),
                          schema_dtypes={"auction": i64}, capacity=cap, table_id="q105.agg")
    join = HashJoinExecutor(left_keys=("id",), right_keys=("auction",),
                            left_dtypes={"id": i64, "item_name": jnp.int32},
                            right_dtypes={"auction": i64, "bid_count": i64}, capacity=cap,
                            fanout=4, out_cap=1 << 11, join_type="inner", table_id="q105.join")
    dt = {"id": i64, "item_name": jnp.int32, "auction": i64, "bid_count": i64}
    topn = TopNExecutor("bid_count", LIMIT, ("id", "auction"), dt, desc=True, capacity=cap,
                        table_id="q105.topn")
    mview = DeviceMaterializeExecutor(pk=("id", "auction"), columns=("item_name", "bid_count"),
                                      schema_dtypes=dt, table_id="q105.mview", capacity=1 << 12)
    return TwoInputPipeline([], [agg], join, [topn, mview]), topn, mview


def _stream(epochs, events=3000, seed=5):
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=seed)
    out = []
    for _ in range(epochs):
        ev = gen.next_events(events)
        out.append(({k: ev["auction"][k] for k in ("id", "item_name")},
                    {k: ev["bid"][k] for k in ("auction", "price")}))
    return out


def _drive(pipeline, epoch, port: bool):
    mk = (lambda c, cap: StreamChunk.from_numpy(c, cap, device="cpu")) if port else (
        lambda c, cap: RefChunk.from_numpy(c, cap))
    auctions, bids = epoch
    pipeline.push_left(mk(auctions, 256))
    for lo in range(0, len(bids["auction"]), 1024):
        pipeline.push_right(mk({k: v[lo:lo + 1024] for k, v in bids.items()}, 1024))
    return pipeline.barrier()


def _oracle(stream) -> dict:
    """The LIMIT auctions with the most bids so far (ties to the lower
    id), keyed on (id, auction)."""
    counts, items = {}, {}
    for auctions, bids in stream:
        items.update(zip(auctions["id"].tolist(), auctions["item_name"].tolist()))
        for a in bids["auction"].tolist():
            counts[a] = counts.get(a, 0) + 1
    ranked = sorted((-c, a) for a, c in counts.items() if a in items)[:LIMIT]
    return {(a, a): (items[a], -c) for c, a in ranked}


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q105_matches_reference_at_every_barrier(fuse):
    """Both packages' q105 over the same epochs: the MV snapshot, the
    TopN's and the MV's digests equal at every barrier, the TopN's
    emissions retract (count changes of ranked auctions); fused, the
    same decision as the reference's: the whole program refused for the
    TopN in the tail with the same refusal, the same per-chain
    fallback. The MV equals the numpy oracle."""
    rp, rt, rm = _ref_q105(1 << 10)
    q = build_q105(capacity=1 << 10, out_cap=1 << 11, limit=LIMIT, device="cpu")
    if fuse:
        ref_refusals(clear=True)
        fusion_refusals(clear=True)
        assert len(ref_fuse(rp, label="q105")) == len(fuse_pipeline(q.pipeline, label="q105")) == 1
        assert fusion_refusals() == ref_refusals() != []
        for side in ("left", "right", "tail"):
            assert [type(e).__name__ for e in getattr(q.pipeline, side)] == [
                type(e).__name__ for e in getattr(rp, side)]
        assert [type(e).__name__ for e in q.pipeline.tail] == ["TopNExecutor",
                                                               "FusedChainExecutor"]
    stream = _stream(5)
    retracted = 0
    for i, epoch in enumerate(stream):
        _drive(rp, epoch, port=False)
        outs = _drive(q.pipeline, epoch, port=True)
        assert q.mview.snapshot() == rm.snapshot() == _oracle(stream[:i + 1])
        assert q.topn.state_digest() == rt.state_digest()
        assert q.mview.state_digest() == rm.state_digest()
        retracted += sum(int((o.to_numpy()["__op__"] == 1).sum()) for o in outs)
    assert len(q.mview.snapshot()) == LIMIT
    assert fuse or retracted > 0


def test_q105_fused_equals_interpreted():
    snaps = []
    for fuse in (False, True):
        q = build_q105(capacity=1 << 10, out_cap=1 << 11, limit=LIMIT, device="cpu")
        if fuse:
            fuse_pipeline(q.pipeline, label="q105")
        got = []
        for epoch in _stream(4, seed=13):
            _drive(q.pipeline, epoch, port=True)
            got.append(q.mview.snapshot())
        snaps.append(got)
    assert snaps[0] == snaps[1] and snaps[0][-1]
