"""Nexmark q19 through the port: the top 10 bids per auction by price,

    SELECT * FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY auction
      ORDER BY price DESC) AS rank_number FROM bid) WHERE rank_number <= 10

without the rank column, on the retractable GroupTopN the SQL planner's
row_number rule lowers it to (``build_q19``: RowIdGen, the TopN keyed
by ``_row_id``, a device MV on ``_row_id``) and on the append-only
GroupTopN (``build_q19_append_only``, every other bid column its
payload), interpreted and fused, against the same chains composed from
``risingwave_tpu``'s executors on JAX-CPU and against a numpy oracle.
Plain PyTorch versions on the CPU. Every comparison is exact.
"""

import jax.numpy as jnp
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu.runtime.fused_step import fusion_refusals as ref_refusals
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.queries.nexmark_q import build_q19, build_q19_append_only
from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals

BID = ("auction", "bidder", "price", "channel", "date_time")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_q19(kind: str, cap: int):
    """The chain of ``build_q19`` (or its append-only twin) from the
    reference's executors."""
    from risingwave_tpu.executors import GroupTopNExecutor, RetractableGroupTopNExecutor
    from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu.executors.row_id_gen import RowIdGenExecutor
    from risingwave_tpu.runtime import Pipeline

    dt = {"auction": jnp.int64, "bidder": jnp.int64, "price": jnp.int64,
          "channel": jnp.int32, "date_time": jnp.int64, "_row_id": jnp.int64}
    if kind == "retractable":
        topn = RetractableGroupTopNExecutor(("auction",), "price", 10, ("_row_id",), dt,
                                            desc=True, capacity=cap, table_id="q19.gtopn")
        tid = "q19"
    else:
        topn = GroupTopNExecutor(("auction",), "price", 10, dt,
                                 payload=("bidder", "channel", "date_time", "_row_id"),
                                 desc=True, capacity=cap, out_cap=1 << 11,
                                 table_id="q19ao.topn")
        tid = "q19ao"
    mview = DeviceMaterializeExecutor(pk=("_row_id",), columns=BID, schema_dtypes=dt,
                                      table_id=f"{tid}.mview", capacity=1 << 13)
    return Pipeline([RowIdGenExecutor(table_id=f"{tid}.rowid"), topn, mview]), topn, mview


def _port_q19(kind: str, cap: int):
    if kind == "retractable":
        q = build_q19(capacity=cap, mv_capacity=1 << 13, device="cpu")
    else:
        q = build_q19_append_only(capacity=cap, out_cap=1 << 11, mv_capacity=1 << 13,
                                  device="cpu")
    return q.pipeline, q.topn, q.mview


def _stream(epochs, events, seed=7):
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=seed)
    return [gen.next_events(events)["bid"] for _ in range(epochs)]


def _oracle(bids) -> dict:
    """Per auction the 10 highest prices, a tie to the earlier bid, as
    ``_row_id -> row``; a bid's row id is its chunk's base plus its row."""
    rows = []
    for k, b in enumerate(bids):
        for i in range(len(b["auction"])):
            rows.append((k * 1024 + i,) + tuple(int(b[c][i]) for c in BID))
    per = {}
    for r in rows:
        per.setdefault(r[1], []).append(r)
    out = {}
    for a, rs in per.items():
        for r in sorted(rs, key=lambda r: (-r[3], r[0]))[:10]:
            out[(r[0],)] = r[1:]
    return out


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
@pytest.mark.parametrize("kind", ["retractable", "append_only"])
def test_q19_matches_reference_at_every_barrier(kind, fuse):
    """Both packages' q19 over the same bid chunks (one per epoch, 1,024
    rows, a 64-group table or store that grows): the MV snapshot, the
    TopN's and the MV's digests equal at every barrier; fused, the same
    chains (the MV fused behind the TopN), no refusal, the staged MV
    digest; the MV equals the numpy oracle."""
    cap = 64
    rp, rt, rm = _ref_q19(kind, cap)
    pp, pt, pm = _port_q19(kind, cap)
    if fuse:
        ref_refusals(clear=True)
        fusion_refusals(clear=True)
        (rw,) = ref_fuse(rp, label="q19")
        (pw,) = fuse_pipeline(pp, label="q19")
        assert [type(e).__name__ for e in pp.executors] == [type(e).__name__
                                                              for e in rp.executors]
        assert pw.members == [pm] and ref_refusals() == [] == fusion_refusals()
    bids = _stream(5, 1100)
    for b in bids:
        cols = {c: b[c] for c in BID}
        rp.push(RefChunk.from_numpy(cols, 1024))
        pp.push(StreamChunk.from_numpy(cols, 1024, device="cpu"))
        rp.barrier()
        pp.barrier()
        assert pm.snapshot() == rm.snapshot()
        assert pt.state_digest() == rt.state_digest()
        assert pm.state_digest() == rm.state_digest()
        if fuse:
            assert pw.last_digests == rw.last_digests
            assert pw.last_digests["mv"] == pm.state_digest()
    assert pt.table.capacity > cap
    assert pm.snapshot() == _oracle(bids)


def test_q19_both_executors_give_one_relation():
    """The retractable and the append-only q19 hold the same MV at every
    barrier: ties to the earlier bid in both (pk order, and incumbents
    then chunk order)."""
    qs = [_port_q19("retractable", 1 << 10), _port_q19("append_only", 1 << 8)]
    for b in _stream(4, 1100, seed=9):
        for p, _, _ in qs:
            p.push(StreamChunk.from_numpy({c: b[c] for c in BID}, 1024, device="cpu"))
            p.barrier()
        assert qs[0][2].snapshot() == qs[1][2].snapshot()
    assert len(qs[0][2].snapshot()) > 100
