"""The SQL front half of the port (``risingwave_tpu_torch/sql/``) against
the reference's on the CPU: the same statement, planned by both
packages, gives the same executor chain (types in order, table ids),
the same MV schema (dtypes mapped) and, over the same seeded Nexmark
events, the same MV snapshot at every barrier. Mirrors
``tests/test_sql.py``'s planner cases and
``tests/test_q7_sql.py::test_q7_sql_matches_hand_built``; the session
cases need ``frontend/``, which is not ported.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors import nexmark as ref_nexmark
from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu.runtime import fragmenter as ref_frag
from risingwave_tpu.sql import Catalog as RefCatalog
from risingwave_tpu.sql import StreamPlanner as RefPlanner
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.connectors import nexmark as port_nexmark
from risingwave_tpu_torch.queries.nexmark_q import build_q7
from risingwave_tpu_torch.runtime import fragmenter as port_frag
from risingwave_tpu_torch.sql import Catalog, StreamPlanner, parse
from risingwave_tpu_torch.sql import parser as P


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_catalog():
    return RefCatalog({"bid": ref_nexmark.BID_SCHEMA, "person": ref_nexmark.PERSON_SCHEMA,
                       "auction": ref_nexmark.AUCTION_SCHEMA})


def port_catalog():
    return Catalog({"bid": port_nexmark.BID_SCHEMA, "person": port_nexmark.PERSON_SCHEMA,
                    "auction": port_nexmark.AUCTION_SCHEMA})


def ref_factory(cap=1 << 12):
    cat = ref_catalog()
    return lambda: RefPlanner(cat, capacity=cap)


def port_factory(cap=1 << 12):
    cat = port_catalog()
    return lambda: StreamPlanner(cat, capacity=cap, device="cpu")


def events(epochs, n=1500, rate=10_000, seed=1):
    """Per epoch, one ``next_events(n)`` batch of every Nexmark table."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    return [gen.next_events(n) for _ in range(epochs)]


def cap_of(n: int) -> int:
    return max(2, 1 << (n - 1).bit_length())


def push(pipeline, inputs, ev, port: bool, cap=None) -> None:
    """Push one epoch's events into a planned MV's pipeline, each table
    to its side (a self-join's table to both)."""
    for table, side in inputs.items():
        cols = ev[table]
        n = len(next(iter(cols.values())))
        if not n:
            continue
        c = cap or cap_of(n)
        chunk = (StreamChunk.from_numpy(cols, c, device="cpu") if port
                 else RefChunk.from_numpy(cols, c))
        if side == "single":
            pipeline.push(chunk)
        if side in ("left", "both"):
            pipeline.push_left(chunk)
        if side in ("right", "both"):
            pipeline.push_right(chunk)


def np_dtype(d) -> np.dtype:
    if isinstance(d, torch.dtype):
        return torch.empty(0, dtype=d).numpy().dtype
    return np.dtype(d)


def chain_of(mv):
    return [(type(ex).__name__, getattr(ex, "table_id", None)) for ex in mv.pipeline.executors]


def assert_same_plan(ref, port) -> None:
    assert chain_of(port) == chain_of(ref)
    assert port.inputs == ref.inputs
    assert port.name == ref.name
    assert {k: np_dtype(v) for k, v in port.schema.items()} == {
        k: np_dtype(v) for k, v in ref.schema.items()}
    assert type(port.mview).__name__ == type(ref.mview).__name__
    assert tuple(port.mview.pk) == tuple(ref.mview.pk)
    assert tuple(port.mview.columns) == tuple(ref.mview.columns)


def run_both(sql, epochs=3, n=1500, rate=10_000, seed=1, cap=1 << 12):
    """Plan ``sql`` in both packages, check the plans agree, then run the
    same events through both and compare the MV at every barrier."""
    ref = ref_factory(cap)().plan(sql)
    port = port_factory(cap)().plan(sql)
    assert_same_plan(ref, port)
    for ev in events(epochs, n, rate, seed):
        push(ref.pipeline, ref.inputs, ev, port=False)
        push(port.pipeline, port.inputs, ev, port=True)
        ref.pipeline.barrier()
        port.pipeline.barrier()
        assert port.mview.snapshot() == ref.mview.snapshot()
    return ref, port


JOIN_SQL = (
    "CREATE MATERIALIZED VIEW j AS "
    "SELECT p.id, p.name, p.starttime{sel_a} FROM "
    "(SELECT id, name, window_start AS starttime "
    " FROM TUMBLE(person, date_time, INTERVAL '10' SECOND) "
    " GROUP BY id, name, window_start) AS p "
    "{jt} JOIN "
    "(SELECT seller, window_start AS astarttime "
    " FROM TUMBLE(auction, date_time, INTERVAL '10' SECOND) "
    " GROUP BY seller, window_start) AS a "
    "ON p.id = a.seller AND p.starttime = a.astarttime"
)

GROUP_OVER_JOIN_SQL = (
    "CREATE MATERIALIZED VIEW g AS "
    "SELECT p.starttime, count(*) AS cnt, max(a.seller) AS mx FROM "
    "(SELECT id, name, window_start AS starttime "
    " FROM TUMBLE(person, date_time, INTERVAL '10' SECOND) "
    " GROUP BY id, name, window_start) AS p "
    "LEFT JOIN "
    "(SELECT seller, window_start AS astarttime "
    " FROM TUMBLE(auction, date_time, INTERVAL '10' SECOND) "
    " GROUP BY seller, window_start) AS a "
    "ON p.id = a.seller AND p.starttime = a.astarttime "
    "GROUP BY p.starttime"
)

# (statement, event rate): the reference's planner cases (tests/test_sql.py),
# the three queries of the actor-graph slice, and one statement for each
# other plan shape the planner lowers
CASES = {
    "q5_lite": (
        "CREATE MATERIALIZED VIEW q5 AS "
        "SELECT auction, window_start, count(*) AS num "
        "FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND) "
        "GROUP BY auction, window_start", 10_000),
    "filter_project_rowid": (
        "CREATE MATERIALIZED VIEW cheap AS "
        "SELECT auction, price * 2 AS dbl FROM bid WHERE price < 500", 10_000),
    "q8_join": (graft.Q8_SQL, 10_000),
    "left_outer_join": (JOIN_SQL.format(jt="LEFT OUTER", sel_a=", a.seller"), 400),
    "left_semi_join": (JOIN_SQL.format(jt="LEFT SEMI", sel_a=""), 400),
    "left_anti_join": (JOIN_SQL.format(jt="LEFT ANTI", sel_a=""), 400),
    "group_by_over_left_join": (GROUP_OVER_JOIN_SQL, 400),
    "q7_self_join": (graft.Q7_SQL, 1000),
    "q5_filtered": (
        "CREATE MATERIALIZED VIEW q5f AS "
        "SELECT auction, window_start, count(*) AS num "
        "FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND) "
        "WHERE price > 100 GROUP BY auction, window_start", 10_000),
    "having": (
        "CREATE MATERIALIZED VIEW h AS SELECT auction, count(*) AS c "
        "FROM bid GROUP BY auction HAVING c > 2", 10_000),
    "distinct": ("CREATE MATERIALIZED VIEW d AS SELECT DISTINCT auction FROM bid", 10_000),
    "count_distinct": (
        "CREATE MATERIALIZED VIEW cd AS SELECT auction, count(DISTINCT bidder) AS nb "
        "FROM bid GROUP BY auction", 10_000),
    "avg_sum_min_max": (
        "CREATE MATERIALIZED VIEW a AS SELECT auction, avg(price) AS ap, sum(price) AS sp, "
        "min(price) AS lo, max(price) AS hi FROM bid GROUP BY auction", 10_000),
    "global_agg": (
        "CREATE MATERIALIZED VIEW ga AS SELECT count(*) AS n, sum(price) AS s, "
        "max(price) AS m FROM bid", 10_000),
    "top_n": (
        "CREATE MATERIALIZED VIEW t AS SELECT auction, price FROM bid "
        "ORDER BY price DESC LIMIT 10", 10_000),
    "row_number_to_group_top_n": (
        "CREATE MATERIALIZED VIEW gt AS SELECT auction, bidder, price FROM "
        "(SELECT auction, bidder, price, row_number() OVER "
        "(PARTITION BY auction ORDER BY price DESC) AS rn FROM bid) AS x "
        "WHERE rn <= 2", 10_000),
    "window_function": (
        "CREATE MATERIALIZED VIEW w AS SELECT auction, price, row_number() OVER "
        "(PARTITION BY auction ORDER BY price) AS rn FROM bid", 10_000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_planned_sql_matches_reference(case):
    sql, rate = CASES[case]
    ref, port = run_both(sql, rate=rate)
    assert port.mview.snapshot()


def test_parse_shapes():
    stmt = parse(
        "CREATE MATERIALIZED VIEW mv AS "
        "SELECT auction, count(*) AS cnt "
        "FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND) "
        "WHERE price > 100 GROUP BY auction, window_start"
    )
    assert isinstance(stmt, P.CreateMaterializedView)
    sel = stmt.select
    assert isinstance(sel.from_, P.WindowTVF)
    assert sel.from_.slide_ms == 2000 and sel.from_.size_ms == 10000
    assert sel.group_by == (P.Ident("auction"), P.Ident("window_start"))
    assert isinstance(sel.where, P.BinaryOp)


@pytest.mark.parametrize("sql", [graft.Q5_SQL, graft.Q7_SQL, graft.Q8_SQL,
                                 CASES["having"][0], GROUP_OVER_JOIN_SQL])
def test_parse_equals_reference(sql):
    from risingwave_tpu.sql import parse as ref_parse

    assert repr(parse(sql)) == repr(ref_parse(sql))


def test_join_words_stay_contextual():
    sel = parse("SELECT anti, semi FROM t WHERE outer > 1")
    assert sel.items[0].expr == P.Ident("anti")
    sel = parse("SELECT x FROM t AS left")
    assert sel.from_.alias == "left"
    assert parse("SELECT x FROM t LEFT OUTER JOIN u ON t.a = u.b").from_.join_type == "left"


def _raises_alike(sql, ref_planner, port_planner):
    with pytest.raises(Exception) as want:
        ref_planner.plan(sql)
    with pytest.raises(Exception) as got:
        port_planner.plan(sql)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_sql_errors_match_reference():
    ref, port = ref_factory()(), port_factory()()
    _raises_alike("SELECT price, count(*) c FROM bid GROUP BY auction", ref, port)
    _raises_alike("SELECT nope FROM bid", ref, port)
    with pytest.raises(SyntaxError):
        parse("SELECT FROM bid")


def test_semi_join_rejects_other_side_columns_as_reference():
    ref, port = ref_factory()(), port_factory()()
    _raises_alike(JOIN_SQL.format(jt="LEFT SEMI", sel_a=", a.seller"), ref, port)
    _raises_alike(JOIN_SQL.format(jt="LEFT SEMI", sel_a="") + " WHERE a.astarttime > 0",
                  ref, port)


def test_table_ids_deterministic_across_planners():
    """``graph_planned_mv`` plans once per instance with fresh planners;
    the partitioned views concatenate deltas by table id, so two fresh
    planners must name every table alike (``planner.py:463``)."""
    for sql in (graft.Q5_SQL, graft.Q7_SQL, graft.Q8_SQL):
        a, b = port_factory()().plan(sql), port_factory()().plan(sql)
        assert chain_of(a) == chain_of(b)


def test_split_decisions_match_reference():
    """q5 partitions on ``auction``, q8 on ``id``/``seller``, q7 not at all
    (its join keys trace to no source column), in both packages."""
    ref5 = ref_factory()().plan(graft.Q5_SQL)
    port5 = port_factory()().plan(graft.Q5_SQL)
    r = ref_frag._split_single(list(ref5.pipeline.executors))
    p = port_frag._split_single(list(port5.pipeline.executors))
    assert (p[0], p[1]) == (r[0], r[1]) == (2, ["auction"])
    assert p[2] == r[2]
    ref8 = ref_factory()().plan(graft.Q8_SQL)
    port8 = port_factory()().plan(graft.Q8_SQL)
    r = ref_frag._split_join(ref8.pipeline)
    p = port_frag._split_join(port8.pipeline)
    assert (p[0], p[1]) == (r[0], r[1]) == (["id"], ["seller"])
    assert p[2] == r[2] and p[3] == r[3]
    ref7 = ref_factory()().plan(graft.Q7_SQL)
    port7 = port_factory()().plan(graft.Q7_SQL)
    assert ref_frag._split_join(ref7.pipeline) is None
    assert port_frag._split_join(port7.pipeline) is None


def _q7_rows(mview):
    cols = mview.to_numpy()
    names = ("wstart", "auction", "bidder")
    price = cols.get("price", cols.get("maxprice"))
    return sorted(zip(*(np.asarray(cols[n]).tolist() for n in names), price.tolist()))


def test_q7_sql_matches_hand_built():
    """Mirror of ``tests/test_q7_sql.py``: the SQL q7 (a self-join fed on
    both sides) lands on the hand-built pipeline's MV, and on the
    reference's SQL q7's."""
    port = StreamPlanner(port_catalog(), capacity=1 << 14, device="cpu").plan(graft.Q7_SQL)
    ref = RefPlanner(ref_catalog(), capacity=1 << 14).plan(graft.Q7_SQL)
    assert port.inputs == {"bid": "both"}
    hand = build_q7(capacity=1 << 14, state_cleaning=False, device="cpu")
    for ev in events(8, n=1500, rate=1000, seed=5):
        bid = ev["bid"]
        pc = StreamChunk.from_numpy(bid, 2048, device="cpu")
        rc = RefChunk.from_numpy(bid, 2048)
        for p in (port.pipeline, hand.pipeline):
            p.push_left(pc)
            p.push_right(pc)
            p.barrier()
        ref.pipeline.push_left(rc)
        ref.pipeline.push_right(rc)
        ref.pipeline.barrier()
    want = _q7_rows(hand.mview)
    assert want
    assert _q7_rows(port.mview) == want
    assert port.mview.snapshot() == ref.mview.snapshot()


def test_sql_q7_overflows_where_the_reference_does():
    """On chip_smoke.py's q7 stream (10,000 events/s, 8,192-event chunks,
    seed 20261017) the SQL q7's join side passes its fanout of 16 in the
    second chunk: both packages hold barrier 1 with the same MV and raise
    the same overflow at barrier 2 (``scripts/q7_sql_depth.py``)."""
    port = StreamPlanner(port_catalog(), capacity=1 << 16, device="cpu").plan(graft.Q7_SQL)
    ref = RefPlanner(ref_catalog(), capacity=1 << 16).plan(graft.Q7_SQL)
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=20261017)
    errors = {}
    for k in range(2):
        bid = {c: v for c, v in gen.next_events(8192)["bid"].items()
               if c in ("auction", "bidder", "price", "date_time")}
        for name, mv, chunk in (("port", port, StreamChunk.from_numpy(bid, 8192, device="cpu")),
                                ("ref", ref, RefChunk.from_numpy(bid, 8192))):
            mv.pipeline.push_left(chunk)
            mv.pipeline.push_right(chunk)
            try:
                mv.pipeline.barrier()
            except RuntimeError as e:
                errors[name] = (k, str(e))
        if k == 0:
            assert not errors and port.mview.snapshot() == ref.mview.snapshot() != {}
    assert errors["port"] == errors["ref"] and errors["port"][0] == 1
    assert "overflowed" in errors["port"][1]
