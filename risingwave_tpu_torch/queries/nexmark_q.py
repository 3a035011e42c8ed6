"""Nexmark query pipelines.

Port of ``risingwave_tpu/queries/nexmark_q.py:28-277`` (q5-lite, q7,
q8), and q5-max, q1, q2, q103, q104 and q103's subquery, which the
reference composes from its executors with no ``build_*`` function of
its own: each here chains the executors in the order the reference's
SQL planner emits them (``sql/planner.py:749-942``: WatermarkFilter at
the scan, Filter for WHERE, HashAgg, Filter for HAVING, RowIdGen for a
pk-less source, then the Project; ``:1900-1960`` for the joins). Reference queries:
e2e_test/nexmark/ — q5 (hot items) counts bids per auction per hop
window (size 10 s, slide 2 s); "q5-lite" is its stateful core, the
HashAgg stage; "q5-max" is q5's ``MaxBids`` subquery on top of it, the
top count per window. q7 (highest bid): the bids at their 10 s tumble
window's maximum price. q8 (monitor new users): persons who
opened auctions in the same 10 s tumble window — per-side tumble +
DISTINCT, then an inner join on (person.id, window) =
(auction.seller, window). q1 (currency conversion) and q2 (selection)
are the Nexmark suite's stateless queries; q103 and q104 are
RisingWave's Nexmark extensions: the auctions with at least 20 bids so
far (a left semi join against a HAVING count), and those without a
count below 20 (a left anti join). q19 (top 10 bids per auction by
price) runs on the retractable GroupTopN the SQL planner's row_number
rule lowers it to (``sql/planner.py:948-1060``) and, as RisingWave's own
planner picks for an insert-only input, on the append-only GroupTopN;
q105 (RisingWave's extension: the 1,000 auctions with the most bids)
on the plain TopN of ``ORDER BY ... LIMIT`` (``planner.py:1272``);
q102 (the auctions with at least the average number of bids) on a
dynamic filter whose right input is a SimpleAgg, RisingWave's plan of a
HAVING against a scalar subquery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from risingwave_tpu_torch import resolve_device
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.executors.dedup import AppendOnlyDedupExecutor
from risingwave_tpu_torch.executors.dynamic_filter import (
    DynamicFilterExecutor,
    DynamicMaxFilterExecutor,
)
from risingwave_tpu_torch.executors.filter import FilterExecutor
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor
from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
from risingwave_tpu_torch.executors.project import ProjectExecutor
from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor
from risingwave_tpu_torch.executors.simple_agg import SimpleAggExecutor
from risingwave_tpu_torch.executors.top_n import GroupTopNExecutor
from risingwave_tpu_torch.executors.top_n_plain import (
    RetractableGroupTopNExecutor,
    TopNExecutor,
)
from risingwave_tpu_torch.expr.expr import BinOp, col, lit
from risingwave_tpu_torch.expr.functions import Func
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.runtime.pipeline import Pipeline, TwoInputPipeline

Q5_WINDOW_MS = 10_000
Q5_SLIDE_MS = 2_000
Q7_WINDOW_MS = 10_000
Q8_WINDOW_MS = 10_000


@dataclass
class Q5Lite:
    pipeline: Pipeline
    agg: HashAggExecutor
    mview: DeviceMaterializeExecutor


def build_q5_lite(
    capacity: int = 1 << 16,
    window_ms: int = Q5_WINDOW_MS,
    slide_ms: int = Q5_SLIDE_MS,
    state_cleaning: bool = True,
    device="cuda",
) -> Q5Lite:
    """bids -> hop window -> COUNT(*) per (auction, window_start) -> MV.

    ``state_cleaning`` declares the agg's window key as the reference
    does: a ``date_time`` watermark then closes the windows below it
    (emit-on-window-close: the agg flushes, then frees them).
    """
    dev = resolve_device(device)
    hop = HopWindowExecutor("date_time", window_ms, slide_ms)
    agg = HashAggExecutor(
        group_keys=("auction", "window_start"),
        calls=(AggCall("count_star", None, "num"),),
        schema_dtypes={"auction": torch.int64, "window_start": torch.int64},
        capacity=capacity,
        table_id="q5.agg",
        window_key=("window_start", 0, False) if state_cleaning else None,
        device=dev,
    )
    mview = DeviceMaterializeExecutor(
        pk=("auction", "window_start"),
        columns=("num",),
        schema_dtypes={
            "auction": torch.int64,
            "window_start": torch.int64,
            "num": torch.int64,
        },
        table_id="q5.mview",
        capacity=max(1 << 12, capacity),
        device=dev,
    )
    return Q5Lite(Pipeline([hop, agg, mview]), agg, mview)


@dataclass
class Q5Max:
    pipeline: Pipeline
    count_agg: HashAggExecutor
    max_agg: HashAggExecutor
    mview: DeviceMaterializeExecutor


def build_q5_max(
    capacity: int = 1 << 16,
    max_capacity: int = 1 << 6,
    minput_k: int = 256,
    state_cleaning: bool = True,
    device="cuda",
) -> Q5Max:
    """The MAX half of Nexmark q5 (its ``MaxBids`` subquery)::

      bids -> hop window -> COUNT(*) AS num per (auction, window_start)
           -> MAX(num) AS maxn per window_start -> MV pk=(window_start)

    Every count change makes the first agg emit U-/U+, so the MAX's
    input retracts: it is materialized (``minput_k`` distinct counts
    per window, the SQL planner's 256). ``state_cleaning`` declares both
    aggs' window key: a ``date_time`` watermark closes the windows below
    it (emit-on-window-close: each agg flushes, then frees them, the
    MAX's multisets too). ``fuse_pipeline`` splits the chain as the
    reference's ``fuse_chain`` does: the hop and the count agg as one
    epoch batch, the MAX agg and the MV as one fused program.
    """
    dev = resolve_device(device)
    i64 = torch.int64
    hop = HopWindowExecutor("date_time", Q5_WINDOW_MS, Q5_SLIDE_MS)
    count_agg = HashAggExecutor(
        group_keys=("auction", "window_start"),
        calls=(AggCall("count_star", None, "num"),),
        schema_dtypes={"auction": i64, "window_start": i64},
        capacity=capacity,
        table_id="q5max.count",
        window_key=("window_start", 0, False) if state_cleaning else None,
        device=dev,
    )
    max_agg = HashAggExecutor(
        group_keys=("window_start",),
        calls=(AggCall("max", "num", "maxn", materialized=True),),
        schema_dtypes={"window_start": i64, "num": i64},
        capacity=max_capacity,
        table_id="q5max.max",
        window_key=("window_start", 0, False) if state_cleaning else None,
        minput_k=minput_k,
        device=dev,
    )
    mview = DeviceMaterializeExecutor(
        pk=("window_start",),
        columns=("maxn",),
        schema_dtypes={"window_start": i64, "maxn": i64},
        nullable=("maxn",),
        table_id="q5max.mview",
        capacity=max(1 << 12, max_capacity),
        device=dev,
    )
    return Q5Max(Pipeline([hop, count_agg, max_agg, mview]), count_agg, max_agg, mview)


@dataclass
class Q8:
    pipeline: TwoInputPipeline
    join: HashJoinExecutor
    mview: DeviceMaterializeExecutor


def build_q8(
    capacity: int = 1 << 14,
    fanout: int = 8,
    out_cap: int = 1 << 14,
    window_ms: int = Q8_WINDOW_MS,
    state_cleaning: bool = True,
    device="cuda",
) -> Q8:
    """person ⋈ auction per 10 s tumble window, as the reference plans it:

      person  -> tumble(date_time) -> DISTINCT(id, name, starttime)    ┐
                                                                        ⋈ inner on
      auction -> tumble(date_time) -> DISTINCT(seller, astarttime)     ┘ (id, starttime) = (seller, astarttime)
              -> MV pk=(id, starttime)

    Both inputs are append-only, so each DISTINCT is an
    AppendOnlyDedup. ``state_cleaning`` declares the window keys as the
    reference does: a ``date_time`` watermark then expires the closed
    windows of both seen-sets and both join sides.
    """
    dev = resolve_device(device)
    person_chain = [
        HopWindowExecutor("date_time", window_ms, window_ms, out_start="starttime"),
        AppendOnlyDedupExecutor(
            keys=("id", "name", "starttime"),
            schema_dtypes={"id": torch.int64, "name": torch.int32, "starttime": torch.int64},
            capacity=capacity,
            window_key=("starttime", 0) if state_cleaning else None,
            table_id="q8.dedup_person",
            device=dev,
        ),
    ]
    auction_chain = [
        HopWindowExecutor("date_time", window_ms, window_ms, out_start="astarttime"),
        AppendOnlyDedupExecutor(
            keys=("seller", "astarttime"),
            schema_dtypes={"seller": torch.int64, "astarttime": torch.int64},
            capacity=capacity,
            window_key=("astarttime", 0) if state_cleaning else None,
            table_id="q8.dedup_auction",
            device=dev,
        ),
    ]
    join = HashJoinExecutor(
        left_keys=("id", "starttime"),
        right_keys=("seller", "astarttime"),
        left_dtypes={"id": torch.int64, "name": torch.int32, "starttime": torch.int64},
        right_dtypes={"seller": torch.int64, "astarttime": torch.int64},
        capacity=capacity,
        fanout=fanout,
        out_cap=out_cap,
        window_cols=("starttime", "astarttime") if state_cleaning else None,
        table_id="q8.join",
        device=dev,
    )
    mview = DeviceMaterializeExecutor(
        pk=("id", "starttime"),
        columns=("name",),
        schema_dtypes={"id": torch.int64, "starttime": torch.int64, "name": torch.int32},
        table_id="q8.mview",
        capacity=max(1 << 12, capacity),
        device=dev,
    )
    pipeline = TwoInputPipeline(person_chain, auction_chain, join, [mview])
    return Q8(pipeline, join, mview)


@dataclass
class Q7:
    pipeline: TwoInputPipeline
    join: HashJoinExecutor
    agg: HashAggExecutor
    mview: DeviceMaterializeExecutor


def build_q7(
    capacity: int = 1 << 16,
    fanout: int = 4,
    out_cap: int = 1 << 14,
    window_ms: int = Q7_WINDOW_MS,
    state_cleaning: bool = True,
    agg_capacity: Optional[int] = None,
    filter_capacity: Optional[int] = None,
    device="cuda",
) -> Q7:
    """Highest bid per 10 s tumble window, as the reference plans it:

      bid -> tumble -> DynamicMaxFilter -> (left)  bids keyed (wstart, price)    ┐
                                                                                 ⋈ inner on
      bid -> tumble -> MAX(price) per window -> (right) (mwstart, maxprice)     ┘ (wstart, price)
              change stream [U-/U+ on every new max]                               = (mwstart, maxprice)
          -> MV pk=(wstart, auction, bidder)

    The right side retracts: each new window max emits U-(old)/U+(new),
    which the join turns into deletes and inserts of the matching bid
    pairs. Both sides take the same bid chunks: drive with
    ``pipeline.push_left(c); pipeline.push_right(c)``. The dynamic
    pre-filter keeps the join's bid side at the chain of ascending
    maxima and their ties. With ``state_cleaning``, advance
    ``pipeline.watermark("date_time", max_event_ts)`` every barrier:
    the filter, the agg (emit-on-window-close) and both join sides drop
    their closed windows. The state walks the bucket lattice (the
    reference's ``bucketed=False`` twin is not ported).
    """
    dev = resolve_device(device)
    left_chain = [
        HopWindowExecutor("date_time", window_ms, window_ms, out_start="wstart"),
        DynamicMaxFilterExecutor(
            group_col="wstart",
            value_col="price",
            schema_dtypes={"wstart": torch.int64, "price": torch.int64},
            capacity=filter_capacity or max(1 << 10, capacity >> 6),
            window_key=("wstart", 0) if state_cleaning else None,
            table_id="q7.maxfilter",
            device=dev,
        ),
    ]
    right_chain = [
        HopWindowExecutor("date_time", window_ms, window_ms, out_start="mwstart"),
        HashAggExecutor(
            group_keys=("mwstart",),
            calls=(AggCall("max", "price", "maxprice"),),
            schema_dtypes={"mwstart": torch.int64, "price": torch.int64},
            capacity=agg_capacity or max(1 << 12, capacity >> 4),
            window_key=("mwstart", 0, False) if state_cleaning else None,
            table_id="q7.maxagg",
            device=dev,
        ),
    ]
    join = HashJoinExecutor(
        left_keys=("wstart", "price"),
        right_keys=("mwstart", "maxprice"),
        left_dtypes={"wstart": torch.int64, "price": torch.int64, "auction": torch.int64,
                     "bidder": torch.int64},
        right_dtypes={"mwstart": torch.int64, "maxprice": torch.int64},
        capacity=capacity,
        fanout=fanout,
        out_cap=out_cap,
        # the agg's delta chunks carry a maxprice null lane (all False:
        # price is non-null); the bucket state keeps it
        right_nullable=("maxprice",),
        window_cols=("wstart", "mwstart") if state_cleaning else None,
        table_id="q7.join",
        device=dev,
    )
    mview = DeviceMaterializeExecutor(
        pk=("wstart", "auction", "bidder"),
        columns=("price",),
        schema_dtypes={"wstart": torch.int64, "auction": torch.int64, "bidder": torch.int64,
                       "price": torch.int64},
        table_id="q7.mview",
        capacity=max(1 << 12, capacity),
        device=dev,
    )
    pipeline = TwoInputPipeline(left_chain, right_chain, join, [mview])
    return Q7(pipeline, join, right_chain[1], mview)


Q1_RATE = 0.908  # dollars -> euros
Q2_MODULUS = 123
HOT_BIDS = 20  # q103 / q104's HAVING threshold


@dataclass
class StatelessMV:
    pipeline: Pipeline
    mview: DeviceMaterializeExecutor


def build_q1(capacity: int = 1 << 16, device="cuda") -> StatelessMV:
    """Nexmark q1, currency conversion, without ``extra`` (the generator
    has none)::

      SELECT auction, bidder, 0.908 * price AS price, date_time FROM bid

      bid -> RowIdGen -> Project -> MV pk=(_row_id)

    The bid source has no pk, so the planner adds a hidden ``_row_id``
    and keys the MV on it; ``price`` becomes float64 (an int64 lane
    times a Python float). ``capacity`` sizes the MV: it holds every bid.
    """
    dev = resolve_device(device)
    i64 = torch.int64
    project = ProjectExecutor({
        "auction": col("auction"),
        "bidder": col("bidder"),
        "price": lit(Q1_RATE) * col("price"),
        "date_time": col("date_time"),
        "_row_id": col("_row_id"),
    })
    mview = DeviceMaterializeExecutor(
        pk=("_row_id",),
        columns=("auction", "bidder", "price", "date_time"),
        schema_dtypes={"_row_id": i64, "auction": i64, "bidder": i64,
                       "price": torch.float64, "date_time": i64},
        table_id="q1.mview",
        capacity=capacity,
        device=dev,
    )
    rowid = RowIdGenExecutor(table_id="q1.rowid")
    return StatelessMV(Pipeline([rowid, project, mview]), mview)


def build_q2(capacity: int = 1 << 16, modulus: int = Q2_MODULUS, device="cuda") -> StatelessMV:
    """Nexmark q2, selection (nexmark-flink ``q2.sql``)::

      SELECT auction, price FROM bid WHERE MOD(auction, 123) = 0

      bid -> Filter -> RowIdGen -> Project -> MV pk=(_row_id)

    ``MOD`` compiles to ``Func("mod")``, as the reference planner's.
    """
    dev = resolve_device(device)
    i64 = torch.int64
    where = FilterExecutor(Func("mod", (col("auction"), lit(modulus))) == lit(0))
    project = ProjectExecutor({
        "auction": col("auction"), "price": col("price"), "_row_id": col("_row_id"),
    })
    mview = DeviceMaterializeExecutor(
        pk=("_row_id",),
        columns=("auction", "price"),
        schema_dtypes={"_row_id": i64, "auction": i64, "price": i64},
        table_id="q2.mview",
        capacity=capacity,
        device=dev,
    )
    rowid = RowIdGenExecutor(table_id="q2.rowid")
    return StatelessMV(Pipeline([where, rowid, project, mview]), mview)


@dataclass
class HotAuctions:
    pipeline: Pipeline
    agg: HashAggExecutor
    having: FilterExecutor
    mview: DeviceMaterializeExecutor


def _bid_count_agg(capacity: int, table_id: str, dev) -> HashAggExecutor:
    return HashAggExecutor(
        group_keys=("auction",),
        calls=(AggCall("count_star", None, "num"),),
        schema_dtypes={"auction": torch.int64},
        capacity=capacity,
        table_id=table_id,
        device=dev,
    )


def _having(threshold: int, op: str) -> FilterExecutor:
    return FilterExecutor(BinOp(op, col("num"), lit(threshold)))


def build_hot_auctions(
    threshold: int = HOT_BIDS,
    op: str = ">=",
    capacity: int = 1 << 16,
    mv_capacity: Optional[int] = None,
    device="cuda",
) -> HotAuctions:
    """q103's subquery as an MV of its own::

      SELECT auction, COUNT(*) AS num FROM bid GROUP BY auction
        HAVING COUNT(*) <op> <threshold>

      bid -> HashAgg COUNT(*) by auction -> Filter(HAVING) -> MV pk=(auction)

    The HAVING filter reads the agg's U-/U+ stream: when a count crosses
    the threshold, one half of its update pair passes and becomes a
    plain Insert or Delete (the torn-pair rewrite). ``fuse_pipeline``
    makes the three one program per barrier, the filter in its ``mid``
    segment, with the threshold lifted into a parameter slot.
    """
    dev = resolve_device(device)
    agg = _bid_count_agg(capacity, "hot.agg", dev)
    having = _having(threshold, op)
    mview = DeviceMaterializeExecutor(
        pk=("auction",),
        columns=("num",),
        schema_dtypes={"auction": torch.int64, "num": torch.int64},
        table_id="hot.mview",
        capacity=mv_capacity or max(1 << 12, capacity),
        device=dev,
    )
    return HotAuctions(Pipeline([agg, having, mview]), agg, having, mview)


@dataclass
class SemiAntiQuery:
    pipeline: TwoInputPipeline
    agg: HashAggExecutor
    join: HashJoinExecutor
    mview: DeviceMaterializeExecutor


def _q103_like(anti: bool, threshold: int, op: str, capacity: int, agg_capacity: Optional[int],
               fanout: int, out_cap: int, mv_capacity: Optional[int], device) -> SemiAntiQuery:
    dev = resolve_device(device)
    i64 = torch.int64
    name = "q104" if anti else "q103"
    agg = _bid_count_agg(agg_capacity or capacity, f"{name}.agg", dev)
    join = HashJoinExecutor(
        left_keys=("id",),
        right_keys=("auction",),
        left_dtypes={"id": i64},
        right_dtypes={"auction": i64},
        capacity=capacity,
        fanout=fanout,
        out_cap=out_cap,
        join_type="left_anti" if anti else "left_semi",
        table_id=f"{name}.join",
        device=dev,
    )
    mview = DeviceMaterializeExecutor(
        pk=("id",),
        columns=(),
        schema_dtypes={"id": i64},
        table_id=f"{name}.mview",
        capacity=mv_capacity or max(1 << 12, capacity),
        device=dev,
    )
    pipeline = TwoInputPipeline([], [agg, _having(threshold, op)], join,
                                [ProjectExecutor({"id": col("id")}), mview])
    return SemiAntiQuery(pipeline, agg, join, mview)


def build_q103(
    capacity: int = 1 << 16,
    agg_capacity: Optional[int] = None,
    fanout: int = 4,
    out_cap: int = 1 << 14,
    mv_capacity: Optional[int] = None,
    threshold: int = HOT_BIDS,
    device="cuda",
) -> SemiAntiQuery:
    """RisingWave's Nexmark q103::

      SELECT a.id FROM auction a WHERE a.id IN
        (SELECT b.auction FROM bid b GROUP BY b.auction HAVING COUNT(*) >= 20)

      auction (id)                                              ┐ LEFT SEMI JOIN
      bid -> HashAgg COUNT(*) by auction -> Filter(HAVING)      ┘ id = auction
          -> Project(id) -> MV pk=(id)

    Drive with ``push_left(auction.select(["id"]))`` and
    ``push_right(bid)``. ``fuse_pipeline`` refuses the whole-pipeline
    program (the right side's Filter follows its HashAgg) and falls back
    per chain, as the reference does: an epoch-batched agg and the raw
    filter on the right, the join interpreted, the join-fed MV tail one
    program.
    """
    return _q103_like(False, threshold, ">=", capacity, agg_capacity, fanout, out_cap,
                      mv_capacity, device)


def build_q104(
    capacity: int = 1 << 16,
    agg_capacity: Optional[int] = None,
    fanout: int = 4,
    out_cap: int = 1 << 14,
    mv_capacity: Optional[int] = None,
    threshold: int = HOT_BIDS,
    device="cuda",
) -> SemiAntiQuery:
    """RisingWave's Nexmark q104::

      SELECT a.id FROM auction a WHERE a.id NOT IN
        (SELECT b.auction FROM bid b GROUP BY b.auction HAVING COUNT(*) < 20)

    ``build_q103``'s plan with a LEFT ANTI join and the HAVING ``< 20``:
    the MV holds the auctions with no bid yet or at least 20.
    """
    return _q103_like(True, threshold, "<", capacity, agg_capacity, fanout, out_cap,
                      mv_capacity, device)


Q19_TOP = 10  # bids kept per auction
Q105_TOP = 1000  # auctions kept
# a bid chunk's columns (connectors/nexmark.py BID_SCHEMA) and its row id
BID_DTYPES = {"auction": torch.int64, "bidder": torch.int64, "price": torch.int64,
              "channel": torch.int32, "date_time": torch.int64, "_row_id": torch.int64}


@dataclass
class Q19:
    pipeline: Pipeline
    topn: Executor
    mview: DeviceMaterializeExecutor


def _q19_mview(capacity: int, table_id: str, dev) -> DeviceMaterializeExecutor:
    return DeviceMaterializeExecutor(
        pk=("_row_id",),
        columns=("auction", "bidder", "price", "channel", "date_time"),
        schema_dtypes=BID_DTYPES,
        table_id=table_id,
        capacity=capacity,
        device=dev,
    )


def build_q19(capacity: int = 1 << 16, mv_capacity: Optional[int] = None,
              device="cuda") -> Q19:
    """Nexmark q19, the top 10 bids per auction by price, without the
    rank column (the planner refuses to select it)::

      SELECT * FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY auction
        ORDER BY price DESC) AS rank_number FROM bid) WHERE rank_number <= 10

      bid -> RowIdGen(_row_id) -> RetractableGroupTopN(auction, price DESC,
        10, pk _row_id) -> MV pk=(_row_id)

    as the row_number rule lowers it. The store holds every bid
    (``capacity`` sizes it); price ties go to the earlier bid (the store
    orders by pk, and row ids rise with arrival). ``fuse_pipeline``
    fuses the MV behind the TopN's bucketed emissions.
    """
    dev = resolve_device(device)
    topn = RetractableGroupTopNExecutor(
        group_by=("auction",), order_col="price", limit=Q19_TOP, pk=("_row_id",),
        schema_dtypes=BID_DTYPES, desc=True, capacity=capacity, table_id="q19.gtopn",
        device=dev,
    )
    mview = _q19_mview(mv_capacity or max(1 << 12, capacity >> 2), "q19.mview", dev)
    rowid = RowIdGenExecutor(table_id="q19.rowid")
    return Q19(Pipeline([rowid, topn, mview]), topn, mview)


def build_q19_append_only(capacity: int = 1 << 14, out_cap: int = 1 << 17,
                          mv_capacity: Optional[int] = None, device="cuda") -> Q19:
    """q19 on the append-only GroupTopN, the executor RisingWave's planner
    picks for an insert-only input: per auction a band of the 10 best
    (price, payload) entries, every other bid column the payload::

      bid -> RowIdGen(_row_id) -> GroupTopN(auction, price DESC, 10,
        payload bidder, channel, date_time, _row_id) -> MV pk=(_row_id)

    Ties go to the incumbents, then to chunk order: the same rows as
    ``build_q19``'s. ``capacity`` sizes the auction table; every emission
    chunk has ``out_cap`` rows.
    """
    dev = resolve_device(device)
    topn = GroupTopNExecutor(
        group_keys=("auction",), order_col="price", k=Q19_TOP, schema_dtypes=BID_DTYPES,
        payload=("bidder", "channel", "date_time", "_row_id"), desc=True, capacity=capacity,
        out_cap=out_cap, table_id="q19ao.topn", device=dev,
    )
    mview = _q19_mview(mv_capacity or max(1 << 12, 4 * capacity), "q19ao.mview", dev)
    rowid = RowIdGenExecutor(table_id="q19ao.rowid")
    return Q19(Pipeline([rowid, topn, mview]), topn, mview)


@dataclass
class Q105:
    pipeline: TwoInputPipeline
    agg: HashAggExecutor
    join: HashJoinExecutor
    topn: TopNExecutor
    mview: DeviceMaterializeExecutor


def build_q105(
    capacity: int = 1 << 16,
    agg_capacity: Optional[int] = None,
    fanout: int = 4,
    out_cap: int = 1 << 14,
    topn_capacity: Optional[int] = None,
    limit: int = Q105_TOP,
    device="cuda",
) -> Q105:
    """RisingWave's Nexmark q105, the auctions with the most bids::

      SELECT a.id AS auction_id, a.item_name AS auction_item_name,
        COUNT(b.auction) AS bid_count
      FROM auction a JOIN bid b ON a.id = b.auction
      GROUP BY a.id, a.item_name ORDER BY bid_count DESC LIMIT 1000

      auction (id, item_name)                        ┐ INNER JOIN
      bid -> HashAgg COUNT(*) AS bid_count by auction ┘ id = auction
          -> TopN(bid_count DESC, 1000, pk (id, auction)) -> MV pk=(id, auction)

    A plan change from the published one, which groups the join's
    output: here the count is taken before the join. The published
    plan's join side would hold every bid of an auction under one key,
    far past the join sides' bucket fanout (4-16 rows a key); auction
    ids are unique, so the relation is the same. The agg's U-/U+ pairs
    reach the TopN through the join as retractions. Drive with
    ``push_left(auction.select(["id", "item_name"]))``,
    ``push_right(bid)``, ``barrier()``. ``fuse_pipeline`` refuses the
    whole program (the TopN in the tail) and falls back per chain, as the
    reference does: an epoch-batched agg, the join and the TopN
    interpreted, the MV behind the TopN one program.
    """
    dev = resolve_device(device)
    i64 = torch.int64
    agg = HashAggExecutor(
        group_keys=("auction",),
        calls=(AggCall("count_star", None, "bid_count"),),
        schema_dtypes={"auction": i64},
        capacity=agg_capacity or capacity,
        table_id="q105.agg",
        device=dev,
    )
    join = HashJoinExecutor(
        left_keys=("id",), right_keys=("auction",),
        left_dtypes={"id": i64, "item_name": torch.int32},
        right_dtypes={"auction": i64, "bid_count": i64},
        capacity=capacity, fanout=fanout, out_cap=out_cap, join_type="inner",
        table_id="q105.join", device=dev,
    )
    dtypes = {"id": i64, "item_name": torch.int32, "auction": i64, "bid_count": i64}
    topn = TopNExecutor("bid_count", limit, pk=("id", "auction"), schema_dtypes=dtypes,
                        desc=True, capacity=topn_capacity or capacity, table_id="q105.topn",
                        device=dev)
    mview = DeviceMaterializeExecutor(
        pk=("id", "auction"), columns=("item_name", "bid_count"), schema_dtypes=dtypes,
        table_id="q105.mview", capacity=1 << 12, device=dev,
    )
    pipeline = TwoInputPipeline([], [agg], join, [topn, mview])
    return Q105(pipeline, agg, join, topn, mview)


class Q102:
    """Nexmark q102's two pipelines, driven in lockstep.

    ``push_auction`` feeds stage 1's left; ``push_bid`` stage 1's right
    and stage 2's right; what stage 1 emits is stage 2's left input. At
    ``barrier`` stage 1 takes its barrier first, its emission is pushed
    into stage 2 (against the old right value), then stage 2 takes its
    barrier: the right chain's flush, the SimpleAgg row, the Project,
    the filter's ``apply_right``, then its diff -- right moves apply at
    the barrier (dynamic_filter.rs). ``fuse_pipeline`` takes each stage
    on its own."""

    def __init__(self, stage1: TwoInputPipeline, stage2: TwoInputPipeline, dev):
        self.stage1, self.stage2 = stage1, stage2
        self.count = stage1.right[0]
        self.join = stage1.join
        self.count2, self.simple, self.project = stage2.right
        self.dfilter = stage2.join
        self.mview = stage2.tail[0]
        self.device = dev

    def _forward(self, chunks) -> list:
        outs = []
        for c in chunks:
            outs.extend(self.stage2.push_left(c))
        return outs

    def push_auction(self, chunk) -> list:
        return self._forward(self.stage1.push_left(chunk))

    def push_bid(self, chunk) -> list:
        outs = self._forward(self.stage1.push_right(chunk))
        return outs + self.stage2.push_right(chunk)

    def barrier(self) -> list:
        outs = self._forward(self.stage1.barrier())
        return outs + self.stage2.barrier()

    @property
    def executors(self) -> list:
        """Every executor of both stages (what a checkpoint commits)."""
        return self.stage1.executors + self.stage2.executors

    @property
    def epoch(self) -> int:
        """The epoch the last barrier closed."""
        return self.stage2.epoch


def build_q102(
    capacity: int = 1 << 16,
    agg_capacity: Optional[int] = None,
    fanout: int = 4,
    out_cap: int = 1 << 14,
    filter_capacity: Optional[int] = None,
    mv_capacity: Optional[int] = None,
    device="cuda",
) -> Q102:
    """RisingWave's Nexmark q102, the auctions with at least the average
    number of bids::

      SELECT a.id AS auction_id, a.item_name AS auction_item_name,
        COUNT(b.auction) AS bid_count
      FROM auction a JOIN bid b ON a.id = b.auction
      GROUP BY a.id, a.item_name
      HAVING COUNT(b.auction) >= (SELECT COUNT(*) / COUNT(DISTINCT auction) FROM bid)

      stage 1: auction (id, item_name)                   ┐ INNER JOIN
               bid -> HashAgg COUNT(*) AS bid_count BY auction ┘ id = auction
      stage 2: left  = stage 1's output (id, item_name, auction, bid_count), U-/U+
               right = bid -> HashAgg COUNT(*) BY auction
                       -> SimpleAgg(COUNT(*) n_auctions, SUM(bid_count) n_bids)
                       -> Project(bid_count = n_bids // n_auctions)
               DynamicFilter(bid_count >= right value, pk (id, auction))
               -> MV pk=(id, auction)

    RisingWave plans the HAVING as a dynamic filter whose right input is
    a SimpleAgg. Two plan changes from the published plan:

    - the count is taken before the join, as ``build_q105`` does: the
      published join side would hold every bid of an auction under one
      key, and auction ids are unique, so the relation is the same;
    - the right value ``COUNT(*) / COUNT(DISTINCT auction)`` comes from a
      second per-auction count, since ``AggCall`` has no DISTINCT: over
      its U-/U+ stream ``SUM(bid_count)`` is ``COUNT(*) FROM bid``, and
      ``COUNT(*)`` nets each update pair to 0, so it counts the auctions
      with a bid. ``//`` is SQL's integer division of two bigints.

    The Project names its output ``bid_count``: ``apply_right`` reads the
    left value column's name. The MV is keyed on the join's stream key.
    ``capacity`` sizes the join sides (with ``fanout``), ``agg_capacity``
    both counts, ``filter_capacity`` the filter's row store.
    """
    dev = resolve_device(device)
    i64 = torch.int64
    agg_cap = agg_capacity or capacity

    def count(table_id):
        return HashAggExecutor(group_keys=("auction",),
                               calls=(AggCall("count_star", None, "bid_count"),),
                               schema_dtypes={"auction": i64}, capacity=agg_cap,
                               table_id=table_id, device=dev)

    join = HashJoinExecutor(
        left_keys=("id",), right_keys=("auction",),
        left_dtypes={"id": i64, "item_name": torch.int32},
        right_dtypes={"auction": i64, "bid_count": i64},
        capacity=capacity, fanout=fanout, out_cap=out_cap, join_type="inner",
        table_id="q102.join", device=dev,
    )
    simple = SimpleAggExecutor(
        (AggCall("count_star", None, "n_auctions"), AggCall("sum", "bid_count", "n_bids")),
        {"bid_count": i64}, table_id="q102.avg", device=dev,
    )
    project = ProjectExecutor({"bid_count": col("n_bids") // col("n_auctions")})
    dtypes = {"id": i64, "item_name": torch.int32, "auction": i64, "bid_count": i64}
    dfilter = DynamicFilterExecutor("bid_count", ">=", ("id", "auction"), dtypes,
                                    capacity=filter_capacity or capacity,
                                    table_id="q102.filter", device=dev)
    mview = DeviceMaterializeExecutor(
        pk=("id", "auction"), columns=("item_name", "bid_count"), schema_dtypes=dtypes,
        table_id="q102.mview", capacity=mv_capacity or capacity, device=dev,
    )
    stage1 = TwoInputPipeline([], [count("q102.count")], join, [])
    stage2 = TwoInputPipeline([], [count("q102.count2"), simple, project], dfilter, [mview])
    return Q102(stage1, stage2, dev)
