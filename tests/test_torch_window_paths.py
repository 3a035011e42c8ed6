"""The three window paths of ``chip_smoke.py`` (phases 29-31), each
composed from one package's executors in the SQL planner's order
(``risingwave_tpu/sql/planner.py:1098-1241``: a hidden row id first),
the port's against the reference's over the same seeded Nexmark bids,
interpreted and fused, and killed and recovered:

- p29, ranked bids: RowIdGen -> Sort(date_time) -> OverWindow
  (append-only, partitioned by auction: row_number, count(*),
  sum/min/max(price), lag(price), rank and dense_rank by date_time) ->
  MV on _row_id; the MV behind the passthrough OverWindow is not fused
  (the refusal is recorded, as the reference's);
- p30, closed-window bid sequences: RowIdGen -> a 10 s tumble (hop with
  size = slide) -> EowcOverWindow partitioned by (window_start, auction),
  ordered by date_time (row_number, rank, dense_rank, lead(price),
  lag(price, 2), sum and count over ROWS (-2, 0), min over (-2, 1),
  running max) -> MV on _row_id; the MV fuses behind the EOWC's fixed
  emission;
- p31, hot auctions ranked per window: hop (10 s, 2 s) -> COUNT(*) per
  (auction, window_start) -> Project neg_num = 0 - num ->
  GeneralOverWindow (pk (auction, window_start), partition
  window_start, order neg_num: rank, dense_rank, row_number, lag(num),
  sum(num)) -> Project -> MV on the pk; fused, the agg is epoch-batched
  and the MV tail fuses.

After every barrier a date_time watermark at the epoch's maximum. At
every barrier (before its watermark) the MV snapshots equal, the
barrier's and the watermark's emissions equal as multisets, every
executor's state digest equal; each fused run equals its interpreted
run; at the end each MV equals a numpy oracle. Exact throughout.
"""

from collections import Counter, defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator

BID_COLS = ("auction", "bidder", "price", "date_time")
P29_CALLS = (("row_number", None, "rn"), ("count", None, "cnt"), ("sum", "price", "total"),
             ("min", "price", "lo"), ("max", "price", "hi"), ("lag", "price", "prev"),
             ("rank", "date_time", "rk"), ("dense_rank", "date_time", "drk"))
P30_CALLS = (("row_number", None, "rn"), ("rank", "date_time", "rk"),
             ("dense_rank", "date_time", "drk"), ("lead", "price", "nxt"),
             ("lag", "price", "prev2", {"offset": 2}), ("sum", "price", "s3", {"frame": (-2, 0)}),
             ("count", None, "c3", {"frame": (-2, 0)}), ("min", "price", "m4", {"frame": (-2, 1)}),
             ("max", "price", "hi"))
P31_CALLS = (("rank", "neg_num", "rk"), ("dense_rank", "neg_num", "drk"),
             ("row_number", None, "rn"), ("lag", "num", "prev"), ("sum", "num", "run"))
TUMBLE_MS, HOP_MS, SLIDE_MS = 10_000, 10_000, 2_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def pkg(port: bool):
    """One package's executors, dtypes and chunk constructor."""
    if port:
        from risingwave_tpu_torch.array.chunk import StreamChunk
        from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
        from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
        from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
        from risingwave_tpu_torch.executors.over_window import (
            EowcOverWindowExecutor,
            GeneralOverWindowExecutor,
            OverWindowExecutor,
            WindowCall,
        )
        from risingwave_tpu_torch.executors.project import ProjectExecutor
        from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor
        from risingwave_tpu_torch.executors.sort import SortExecutor
        from risingwave_tpu_torch.expr import col, lit
        from risingwave_tpu_torch.ops.agg import AggCall
        from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals
        from risingwave_tpu_torch.runtime.pipeline import Pipeline
        from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore

        dev = {"device": "cpu"}
        i64 = torch.int64
        chunk = lambda c, cap, **kw: StreamChunk.from_numpy(c, cap, device="cpu", **kw)
    else:
        import jax.numpy as jnp
        from risingwave_tpu.array.chunk import StreamChunk
        from risingwave_tpu.executors.hash_agg import HashAggExecutor
        from risingwave_tpu.executors.hop_window import HopWindowExecutor
        from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor
        from risingwave_tpu.executors.over_window import (
            EowcOverWindowExecutor,
            GeneralOverWindowExecutor,
            OverWindowExecutor,
            WindowCall,
        )
        from risingwave_tpu.executors.project import ProjectExecutor
        from risingwave_tpu.executors.row_id_gen import RowIdGenExecutor
        from risingwave_tpu.executors.sort import SortExecutor
        from risingwave_tpu.expr import col, lit
        from risingwave_tpu.ops.agg import AggCall
        from risingwave_tpu.runtime import Pipeline
        from risingwave_tpu.runtime.fused_step import fuse_pipeline, fusion_refusals
        from risingwave_tpu.storage import CheckpointManager, MemObjectStore

        dev = {}
        i64 = jnp.int64
        chunk = lambda c, cap, **kw: StreamChunk.from_numpy(c, cap, **kw)
    d = lambda cls: (lambda *a, **k: cls(*a, **dev, **k))
    calls = lambda specs: tuple(WindowCall(*s[:3], **(s[3] if len(s) > 3 else {}))
                                for s in specs)
    return SimpleNamespace(
        Project=ProjectExecutor, RowIdGen=RowIdGenExecutor, Hop=HopWindowExecutor,
        Sort=d(SortExecutor), Over=d(OverWindowExecutor), Eowc=d(EowcOverWindowExecutor),
        General=d(GeneralOverWindowExecutor), Agg=d(HashAggExecutor),
        Mv=d(DeviceMaterializeExecutor), Call=AggCall, calls=calls, col=col, lit=lit, i64=i64,
        chunk=chunk, Pipeline=Pipeline, fuse=fuse_pipeline, refusals=fusion_refusals,
        Manager=CheckpointManager, Store=MemObjectStore, port=port)


def build_p29(port, cap=1 << 12):
    p = pkg(port)
    dt = {n: p.i64 for n in ("_row_id",) + BID_COLS}
    outs = tuple(c[2] for c in P29_CALLS)
    q = SimpleNamespace(p=p)
    q.sort = p.Sort("date_time", dt, capacity=cap, table_id="p29.sort")
    q.over = p.Over(("auction",), p.calls(P29_CALLS), dt, capacity=cap >> 2, table_id="p29.over")
    q.mview = p.Mv(("_row_id",), BID_COLS + outs, {**dt, **dict.fromkeys(outs, p.i64)},
                   capacity=cap, nullable=("lo", "hi", "prev"), table_id="p29.mview")
    q.pipeline = p.Pipeline([p.RowIdGen(table_id="p29.row_id"), q.sort, q.over, q.mview])
    return q


def build_p30(port, cap=1 << 12):
    p = pkg(port)
    dt = {n: p.i64 for n in ("_row_id", "window_start") + BID_COLS}
    outs = tuple(c[2] for c in P30_CALLS)
    q = SimpleNamespace(p=p)
    q.eowc = p.Eowc(("window_start", "auction"), "date_time", p.calls(P30_CALLS), dt,
                    win_col="window_start", capacity=cap, table_id="p30.eowc")
    q.mview = p.Mv(("_row_id",), BID_COLS + ("window_start",) + outs,
                   {**dt, **dict.fromkeys(outs, p.i64)}, capacity=cap, nullable=outs,
                   table_id="p30.mview")
    q.pipeline = p.Pipeline([p.RowIdGen(table_id="p30.row_id"),
                             p.Hop("date_time", TUMBLE_MS, TUMBLE_MS), q.eowc, q.mview])
    return q


def build_p31(port, cap=1 << 13, out_cap=1 << 8):
    p = pkg(port)
    col, lit = p.col, p.lit
    keys = ("auction", "window_start")
    outs = tuple(c[2] for c in P31_CALLS)
    q = SimpleNamespace(p=p)
    q.agg = p.Agg(keys, (p.Call("count_star", None, "num"),), dict.fromkeys(keys, p.i64),
                  capacity=cap, out_cap=out_cap, table_id="p31.agg")
    q.over = p.General(("window_start",), "neg_num", keys, p.calls(P31_CALLS),
                       dict.fromkeys(keys + ("num", "neg_num"), p.i64), capacity=cap,
                       table_id="p31.over")
    q.mview = p.Mv(keys, ("num",) + outs, dict.fromkeys(keys + ("num",) + outs, p.i64),
                   capacity=cap, nullable=("prev",), table_id="p31.mview")
    q.pipeline = p.Pipeline([
        p.Hop("date_time", HOP_MS, SLIDE_MS), q.agg,
        p.Project({"auction": col("auction"), "window_start": col("window_start"),
                   "num": col("num"), "neg_num": lit(0) - col("num")}),
        q.over,
        p.Project({n: col(n) for n in keys + ("num",) + outs}),
        q.mview])
    return q


BUILDS = {"p29": build_p29, "p30": build_p30, "p31": build_p31}
CHAINS = {  # the fused chain, as the reference's fuse_chain splits it
    "p29": ["RowIdGenExecutor", "SortExecutor", "OverWindowExecutor",
            "DeviceMaterializeExecutor"],
    "p30": ["RowIdGenExecutor", "HopWindowExecutor", "EowcOverWindowExecutor",
            "FusedChainExecutor"],
    "p31": ["EpochBatchedAggExecutor", "ProjectExecutor", "GeneralOverWindowExecutor",
            "FusedChainExecutor"],
}


def stream(epochs=4, events=800, seed=29, chunk=256, rate=150):
    """Per epoch the bids in ``chunk``-row pieces and the epoch's largest
    date_time (a low event rate, so 10 s windows close within a few
    epochs)."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    out = []
    for _ in range(epochs):
        b = gen.next_events(events)["bid"]
        out.append({"bids": [{k: b[k][lo:lo + chunk] for k in BID_COLS}
                             for lo in range(0, len(b["auction"]), chunk)],
                    "wm": int(b["date_time"].max())})
    return out


def drive(q, ep, chunk=256):
    """One epoch: the bids, a barrier, a date_time watermark at the
    epoch's maximum; returns the barrier's and the watermark's output."""
    for b in ep["bids"]:
        q.pipeline.push(q.p.chunk(b, chunk))
    outs = list(q.pipeline.barrier())
    return outs + list(q.pipeline.watermark("date_time", ep["wm"]))


def emission(chunks):
    rows = Counter()
    for c in chunks:
        d = c.to_numpy(with_ops=True)
        names = sorted(k for k in d if k != "__op__")
        for i in range(len(d["__op__"])):
            rows[(int(d["__op__"][i]),) + tuple(np.asarray(d[k])[i].item() for k in names)] += 1
    return rows


def digests(q):
    """Every checkpointed executor's state digest by table id (an
    epoch-batched agg's too)."""
    if q.p.port:
        from risingwave_tpu_torch.runtime.fused_step import expand_fused
    else:
        from risingwave_tpu.runtime.fused_step import expand_fused
    members = [getattr(ex, "agg", ex) if type(ex).__name__ == "EpochBatchedAggExecutor" else ex
               for ex in expand_fused(q.pipeline.executors)]
    return {",".join(ex.checkpoint_table_ids()): ex.state_digest()
            for ex in members if hasattr(ex, "checkpoint_delta")}


def oracle(name, data):
    """Each path's final MV from numpy over the bids pushed, with the row
    id RowIdGen gives a bid (chunk index x capacity + row)."""
    rows, rid = [], 0
    for ep in data:
        for b in ep["bids"]:
            for i in range(len(b["auction"])):
                rows.append((rid + i,) + tuple(int(b[k][i]) for k in BID_COLS))
            rid += 256
    last_wm = data[-1]["wm"]
    out = {}
    if name == "p29":  # rows below the last watermark, in (time, arrival) order
        hist = defaultdict(list)
        for r in sorted((r for r in rows if r[4] < last_wm), key=lambda r: (r[4], r[0])):
            h = hist[r[1]]
            prev = h[-1][3] if h else None
            h.append(r)
            ts = [x[4] for x in h]
            prices = [x[3] for x in h]
            out[(r[0],)] = r[1:] + (len(h), len(h), sum(prices), min(prices), max(prices), prev,
                                    1 + sum(t < r[4] for t in ts),
                                    1 + len({t for t in ts if t < r[4]}))
        return out
    if name == "p30":  # complete windows below the last watermark's window
        parts = defaultdict(list)
        for r in rows:
            ws = r[4] - r[4] % TUMBLE_MS
            if ws < last_wm - last_wm % TUMBLE_MS:  # the hop's window_start watermark
                parts[(ws, r[1])].append(r)
        for (ws, _), rs in parts.items():
            rs.sort(key=lambda r: (r[4], r[0]))
            pr = [r[3] for r in rs]
            for i, r in enumerate(rs):
                ts = [x[4] for x in rs]
                out[(r[0],)] = r[1:] + (ws, i + 1, 1 + sum(t < r[4] for t in ts),
                                        1 + len({t for t in ts if t < r[4]}),
                                        pr[i + 1] if i + 1 < len(rs) else None,
                                        pr[i - 2] if i >= 2 else None,
                                        sum(pr[max(0, i - 2):i + 1]), len(pr[max(0, i - 2):i + 1]),
                                        min(pr[max(0, i - 2):i + 2]), max(pr[:i + 1]))
        return out
    counts = Counter()
    for r in rows:
        last = r[4] - r[4] % SLIDE_MS
        for k in range(HOP_MS // SLIDE_MS):
            counts[(r[1], last - k * SLIDE_MS)] += 1
    per = defaultdict(list)
    for (a, ws), n in counts.items():
        per[ws].append((a, n))
    per_window = Counter()
    for ws, items in per.items():
        nums = sorted((n for _, n in items), reverse=True)
        for a, n in items:
            out[(a, ws)] = (n, 1 + sum(x > n for x in nums), 1 + len({x for x in nums if x > n}))
        for i, n in enumerate(nums):  # tied rows share these by position
            per_window[(ws, i + 1, nums[i - 1] if i else None, sum(nums[:i + 1]))] += 1
    return out, per_window


def canon(name, snap):
    """What two runs must agree on. p31 orders ties of num by arrival
    (seq), and the epoch-batched agg flushes a barrier's groups in
    another order than the interpreted one: per pk num, rank and
    dense_rank, and per window the multiset of (row_number, lag, running
    sum) triples, which the tied rows share by position."""
    if name != "p31":
        return snap
    per_pk = {k: v[:3] for k, v in snap.items()}
    per_window = Counter((k[1],) + v[3:] for k, v in snap.items())
    return per_pk, per_window


@pytest.mark.parametrize("fused", [False, True], ids=["interpreted", "fused"])
@pytest.mark.parametrize("name", list(BUILDS))
def test_path_matches_reference_at_every_barrier(name, fused):
    """Port and reference in lockstep, each both ways: emissions, MV
    snapshots and digests equal at every barrier; the fused chain split
    as the reference's (and p29's MV refusal recorded); the final MV
    equal to the numpy oracle."""
    ref, port = BUILDS[name](False), BUILDS[name](True)
    if fused:
        port.p.refusals(clear=True)
        ref.p.refusals(clear=True)
        port.p.fuse(port.pipeline, label=name)
        ref.p.fuse(ref.pipeline, label=name)
        got = [type(e).__name__ for e in port.pipeline.executors]
        assert got == [type(e).__name__ for e in ref.pipeline.executors] == CHAINS[name]
        if name == "p29":
            (r,) = port.p.refusals()
            assert r["executor"] == "OverWindowExecutor" and "passthrough" in r["message"]
    data = stream()
    for e, ep in enumerate(data):
        got, want = drive(port, ep), drive(ref, ep)
        assert emission(got) == emission(want), f"{name} epoch {e}: emission"
        assert port.mview.snapshot() == ref.mview.snapshot(), f"{name} epoch {e}: MV"
        assert digests(port) == digests(ref), f"{name} epoch {e}: digests"
    port.pipeline.barrier()  # a fused MV takes the last watermark's emission here
    ref.pipeline.barrier()
    snap = port.mview.snapshot()
    assert snap == ref.mview.snapshot()
    assert canon(name, snap) == oracle(name, data)


@pytest.mark.parametrize("name", list(BUILDS))
def test_fused_equals_interpreted_and_recovers_from_a_kill(name):
    """The port alone: an interpreted and a fused run in lockstep equal at
    every barrier; a third run commits after every barrier's watermark,
    is killed after epoch 2 of 4 and recovered into a fresh build: its
    state equals the state before the kill, and it equals the
    uninterrupted runs at every later barrier. On p31 the runs agree as
    ``canon`` says and every executor but the general over-window (whose
    emitted lanes, and the MV, hold the tie-ordered outputs) by digest:
    the fused and the recovered agg flush their groups in another
    order."""
    data = stream()
    plain, fused, victim = (BUILDS[name](True) for _ in range(3))
    fused.p.fuse(fused.pipeline, label=name)
    mgr = victim.p.Manager(victim.p.Store())

    def same(a, b, what):
        assert canon(name, a.mview.snapshot()) == canon(name, b.mview.snapshot()), what
        da, db = digests(a), digests(b)
        if name == "p31":  # the tie-ordered outputs: compared by canon
            for d in (da, db):
                d.pop("p31.over"), d.pop("p31.mview")
        assert da == db, what

    for e, ep in enumerate(data):
        for q in (plain, fused, victim):
            for b in ep["bids"]:
                q.pipeline.push(q.p.chunk(b, 256))
            q.pipeline.barrier()
        same(plain, fused, f"{name} barrier {e}: fused")
        same(plain, victim, f"{name} barrier {e}: recovered")
        for q in (plain, fused, victim):
            q.pipeline.watermark("date_time", ep["wm"])
        mgr.commit_epoch(victim.pipeline.epoch, victim.pipeline.executors)
        if e == 1:  # the kill
            before = digests(victim)
            victim = BUILDS[name](True)
            mgr.recover(victim.pipeline.executors)
            assert digests(victim) == before, f"{name}: recovered state"
    for q in (plain, fused, victim):
        q.pipeline.barrier()
    same(plain, fused, f"{name} end: fused")
    same(plain, victim, f"{name} end: recovered")
