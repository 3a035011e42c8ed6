"""The four paths of the table-function, grouping-set and temporal-join
operators, each composed from one package's executors as
``chip_smoke.py`` composes them on the card (no SQL plan of the
reference reaches ProjectSet or Expand), the port's against the
reference's over the same seeded Nexmark epochs, interpreted and fused:

- p25, q5 as a table function: Project (lo, hi) -> ProjectSet
  (generate_series(lo, hi), max_steps 5) -> Project (window_start) ->
  HashAgg COUNT(*) per (auction, window_start) -> MV; its MV also equals
  q5-lite's (the hop's first window is (t // 2000 - 4) * 2000);
- p26, grouping sets: Expand((auction), (bidder), ()) -> HashAgg
  COUNT(*), SUM(price) on (auction, bidder, flag), the first two nullable
  -> MV;
- p27, unnest: auctions with a LIST<int64> ``tags`` column (0-8 tags,
  some lists NULL) encoded by ``array/composite.py`` -> ProjectSet
  (unnest(tags)) -> HashAgg COUNT(*) per tag -> MV;
- p28, temporal enrichment: auctions -> a device MV on id; bids ->
  TemporalJoin(inner, seller and category) -> HashAgg COUNT(*),
  SUM(price) per seller -> MV, the two pipelines in lockstep (each
  epoch's auctions first); only the bid chain fuses.

At every barrier: the MV snapshots equal, the barrier's emission equal
as a multiset, every executor's state digest equal (``host_digest``),
and, fused, the staged digests the reference's; at the end each MV
equals a numpy oracle. A troublemaker in front of an MV shows its
logged faults there. Exact throughout (integer lanes, uint64 digests).
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.array.composite import encode_column
from risingwave_tpu_torch.types import DataType, Field

SLIDE, STEPS = 2000, 5
TAG_CAP, TAG_DOMAIN = 8, 1 << 16
BID_COLS = ("auction", "bidder", "price", "channel", "date_time")


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
        from risingwave_tpu_torch.executors import (
            ExpandExecutor,
            ProjectSetExecutor,
            TemporalJoinExecutor,
        )
        from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
        from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
        from risingwave_tpu_torch.executors.project import ProjectExecutor
        from risingwave_tpu_torch.expr import col, lit
        from risingwave_tpu_torch.ops.agg import AggCall
        from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline
        from risingwave_tpu_torch.runtime.pipeline import Pipeline

        dev = {"device": "cpu"}
        i64 = torch.int64
        chunk = lambda c, cap, **kw: StreamChunk.from_numpy(c, cap, device="cpu", **kw)
    else:
        import jax.numpy as jnp
        from risingwave_tpu.array.chunk import StreamChunk
        from risingwave_tpu.executors.expand import ExpandExecutor
        from risingwave_tpu.executors.hash_agg import HashAggExecutor
        from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor
        from risingwave_tpu.executors.project import ProjectExecutor
        from risingwave_tpu.executors.project_set import ProjectSetExecutor
        from risingwave_tpu.executors.temporal_join import TemporalJoinExecutor
        from risingwave_tpu.expr import col, lit
        from risingwave_tpu.ops.agg import AggCall
        from risingwave_tpu.runtime import Pipeline
        from risingwave_tpu.runtime.fused_step import fuse_pipeline

        dev = {}
        i64 = jnp.int64
        chunk = lambda c, cap, **kw: StreamChunk.from_numpy(c, cap, **kw)
    agg = lambda *a, **k: HashAggExecutor(*a, **dev, **k)
    mv = lambda *a, **k: DeviceMaterializeExecutor(*a, **dev, **k)
    return SimpleNamespace(Project=ProjectExecutor, ProjectSet=ProjectSetExecutor,
                           Expand=ExpandExecutor, TemporalJoin=TemporalJoinExecutor, Agg=agg,
                           Mv=mv, Call=AggCall, col=col, lit=lit, i64=i64, chunk=chunk,
                           Pipeline=Pipeline, fuse=fuse_pipeline, port=port)


class Path:
    """One path of one package: ``pipeline`` (its ``executors`` and
    ``epoch``, what a checkpoint takes), ``mview``, ``drive(epoch)``."""


def build_p25(port, cap=1 << 12):
    p = pkg(port)
    col, lit = p.col, p.lit
    q = Path()
    keys = ("auction", "window_start")
    q.agg = p.Agg(keys, (p.Call("count_star", None, "num"),), dict.fromkeys(keys, p.i64),
                  capacity=cap, table_id="p25.agg")
    q.mview = p.Mv(keys, ("num",), dict.fromkeys(keys + ("num",), p.i64), capacity=cap,
                   table_id="p25.mview")
    q.pipeline = p.Pipeline([
        p.Project({"auction": col("auction"),
                   "lo": col("date_time") // lit(SLIDE) - lit(STEPS - 1),
                   "hi": col("date_time") // lit(SLIDE)}),
        p.ProjectSet("generate_series", out="value", start_col="lo", stop_col="hi",
                     max_steps=STEPS),
        p.Project({"auction": col("auction"), "window_start": col("value") * lit(SLIDE)}),
        q.agg, q.mview])

    def drive(ep):
        for b in ep["bids"]:
            q.pipeline.push(p.chunk({k: b[k] for k in ("auction", "date_time")}, len(b["auction"])))
        return q.pipeline.barrier()

    q.drive = q.pipeline.drive_epoch = drive  # phase 16's kill drives the pipeline
    q.p = p
    return q


def build_p26(port, cap=1 << 12):
    p = pkg(port)
    q = Path()
    keys = ("auction", "bidder", "flag")
    q.agg = p.Agg(keys, (p.Call("count_star", None, "n"), p.Call("sum", "price", "total")),
                  {**dict.fromkeys(keys, p.i64), "price": p.i64}, capacity=cap,
                  nullable_keys=("auction", "bidder"), table_id="p26.agg")
    q.mview = p.Mv(keys, ("n", "total"), dict.fromkeys(keys + ("n", "total"), p.i64),
                   capacity=cap, table_id="p26.mview")
    q.pipeline = p.Pipeline([p.Expand([("auction",), ("bidder",), ()]), q.agg, q.mview])

    def drive(ep):
        for b in ep["bids"]:
            q.pipeline.push(p.chunk({k: b[k] for k in ("auction", "bidder", "price")},
                                    len(b["auction"])))
        return q.pipeline.barrier()

    q.drive = q.pipeline.drive_epoch = drive  # phase 16's kill drives the pipeline
    q.p = p
    return q


def build_p27(port, cap=1 << 12):
    p = pkg(port)
    q = Path()
    q.agg = p.Agg(("tag",), (p.Call("count_star", None, "n"),), {"tag": p.i64}, capacity=cap,
                  table_id="p27.agg")
    q.mview = p.Mv(("tag",), ("n",), {"tag": p.i64, "n": p.i64}, capacity=cap,
                   table_id="p27.mview")
    q.pipeline = p.Pipeline([p.ProjectSet("unnest", out="tag", list_col="tags",
                                          list_cap=TAG_CAP), q.agg, q.mview])

    def drive(ep):
        lanes, nulls, n = ep["tag_lanes"]
        q.pipeline.push(p.chunk(lanes, n, nulls=nulls))
        return q.pipeline.barrier()

    q.drive = q.pipeline.drive_epoch = drive  # phase 16's kill drives the pipeline
    q.p = p
    return q


class Lockstep:
    """Two pipelines driven as one: a checkpoint takes both chains'
    executors at the bid pipeline's epoch."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    @property
    def executors(self):
        return list(self.first.executors) + list(self.second.executors)

    @property
    def epoch(self):
        return self.second.epoch


def build_p28(port, cap=1 << 12):
    p = pkg(port)
    q = Path()
    q.auctions = p.Mv(("id",), ("seller", "category"), dict.fromkeys(
        ("id", "seller", "category"), p.i64), capacity=cap, table_id="p28.auctions")
    q.agg = p.Agg(("seller",), (p.Call("count_star", None, "n"), p.Call("sum", "price", "total")),
                  {"seller": p.i64, "price": p.i64}, capacity=cap,
                  nullable_keys=("seller",), table_id="p28.agg")  # the join's null lane
    q.mview = p.Mv(("seller",), ("n", "total"), dict.fromkeys(("seller", "n", "total"), p.i64),
                   capacity=cap, table_id="p28.mview")
    q.right = p.Pipeline([q.auctions])
    q.bids = p.Pipeline([p.TemporalJoin(q.auctions, ("auction",), ("seller", "category"),
                                        "inner"), q.agg, q.mview])
    q.pipeline = Lockstep(q.right, q.bids)

    def drive(ep):
        a = ep["auctions"]
        q.right.push(p.chunk({k: a[k] for k in ("id", "seller", "category")}, ep["a_cap"]))
        for b in ep["bids"]:
            q.bids.push(p.chunk({k: b[k] for k in ("auction", "price")}, len(b["auction"])))
        q.right.barrier()
        return q.bids.barrier()

    q.drive = q.pipeline.drive_epoch = drive  # phase 16's kill drives the pipeline
    q.p = p
    return q


BUILDS = {"p25": build_p25, "p26": build_p26, "p27": build_p27, "p28": build_p28}


def fuse(q):
    """Fuse the path's bid (or only) chain; the auction MV of p28 stays
    interpreted (a fused MV writes at the barrier, and the probe would
    read it an epoch late)."""
    chain = q.bids if hasattr(q, "bids") else q.pipeline
    return q.p.fuse(chain, label="p")


def stream(epochs=4, events=3000, seed=21, chunk=512):
    """Per epoch: the bids in ``chunk``-row pieces, the auctions (with
    ``a_cap``), and the auctions' tag lists encoded as LIST<int64>
    lanes (0-8 tags from a 2^16 domain, about a tenth NULL)."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=seed)
    rng = np.random.default_rng(seed)
    f = Field("tags", DataType.LIST, elem=DataType.INT64, list_cap=TAG_CAP)
    out = []
    for _ in range(epochs):
        ev = gen.next_events(events)
        b, a = ev["bid"], ev["auction"]
        n = len(a["id"])
        tags = [None if rng.random() < 0.1 else
                rng.integers(0, TAG_DOMAIN, int(rng.integers(0, TAG_CAP + 1))).tolist()
                for _ in range(n)]
        lanes, nulls = encode_column(f, tags)
        lanes["id"] = a["id"]
        out.append({
            "bids": [{k: b[k][lo:lo + chunk] for k in BID_COLS}
                     for lo in range(0, len(b["auction"]), chunk)],
            "auctions": a, "a_cap": 1 << max(1, (n - 1).bit_length()), "tags": tags,
            "tag_lanes": (lanes, nulls, 1 << max(1, (n - 1).bit_length())),
        })
    return out


def oracle(name, data):
    """Each path's MV as {pk: values} from numpy."""
    bids = {k: np.concatenate([b[k] for ep in data for b in ep["bids"]]) for k in BID_COLS}
    if name == "p25":
        out = Counter()
        for a, t in zip(bids["auction"].tolist(), bids["date_time"].tolist()):
            for i in range(STEPS):
                out[(a, (t // SLIDE - STEPS + 1 + i) * SLIDE)] += 1
        return {k: (v,) for k, v in out.items()}
    if name == "p26":
        out = {}
        for a, b, pr in zip(bids["auction"].tolist(), bids["bidder"].tolist(),
                            bids["price"].tolist()):
            for key in ((a, 0, 0), (0, b, 1), (0, 0, 2)):  # a NULL key lane holds 0
                n, s = out.get(key, (0, 0))
                out[key] = (n + 1, s + pr)
        return out
    if name == "p27":
        out = Counter(t for ep in data for tags in ep["tags"] if tags for t in tags)
        return {(t,): (n,) for t, n in out.items()}
    seller = {}
    out = {}
    for ep in data:  # the epoch's auctions are pushed before its bids
        seller.update(zip(ep["auctions"]["id"].tolist(), ep["auctions"]["seller"].tolist()))
        for b in ep["bids"]:
            for a, pr in zip(b["auction"].tolist(), b["price"].tolist()):
                if a in seller:
                    n, s = out.get((seller[a],), (0, 0))
                    out[(seller[a],)] = (n + 1, s + pr)
    return out


def emission(chunks):
    """The barrier's output as a multiset of (op, sorted columns) rows."""
    rows = Counter()
    for c in chunks:
        d = c.to_numpy(with_ops=True)
        names = sorted(k for k in d if k != "__op__")
        for i in range(len(d["__op__"])):
            rows[(int(d["__op__"][i]),) + tuple(np.asarray(d[k])[i].item() for k in names)] += 1
    return rows


def digests(q):
    """Every checkpointed executor's state digest by table id."""
    from risingwave_tpu_torch.runtime.fused_step import expand_fused

    return {",".join(ex.checkpoint_table_ids()): ex.state_digest()
            for ex in expand_fused(q.pipeline.executors) if hasattr(ex, "checkpoint_delta")}


def ref_digests(q):
    from risingwave_tpu.runtime.fused_step import expand_fused

    return {",".join(ex.checkpoint_table_ids()): ex.state_digest()
            for ex in expand_fused(q.pipeline.executors) if hasattr(ex, "checkpoint_delta")}


@pytest.mark.parametrize("fused", [False, True], ids=["interpreted", "fused"])
@pytest.mark.parametrize("name", list(BUILDS))
def test_path_matches_reference_at_every_barrier(name, fused):
    ref, port = BUILDS[name](False), BUILDS[name](True)
    if fused:
        rw, pw = fuse(ref), fuse(port)
        assert [type(w).__name__ for w in pw] == [type(w).__name__ for w in rw] == [
            "FusedChainExecutor"]
        chain = port.bids if name == "p28" else port.pipeline
        rchain = ref.bids if name == "p28" else ref.pipeline
        assert [type(e).__name__ for e in chain.executors] == [
            type(e).__name__ for e in rchain.executors]
    data = stream()
    for e, ep in enumerate(data):
        got, want = port.drive(ep), ref.drive(ep)
        assert emission(got) == emission(want), f"{name} barrier {e}: emission"
        assert port.mview.snapshot() == ref.mview.snapshot(), f"{name} barrier {e}: MV"
        assert digests(port) == ref_digests(ref), f"{name} barrier {e}: digests"
        if fused:
            assert pw[0].last_digests == rw[0].last_digests
    assert port.mview.snapshot() == oracle(name, data)


def test_fused_chains_split_as_the_issue_plans():
    names = {}
    for name in BUILDS:
        q = BUILDS[name](True)
        fuse(q)
        chain = q.bids if name == "p28" else q.pipeline
        names[name] = [type(e).__name__ for e in chain.executors]
    assert names == {
        "p25": ["ProjectExecutor", "ProjectSetExecutor", "FusedChainExecutor"],
        "p26": ["ExpandExecutor", "FusedChainExecutor"],
        "p27": ["ProjectSetExecutor", "FusedChainExecutor"],
        "p28": ["TemporalJoinExecutor", "FusedChainExecutor"],
    }


def test_p25_equals_q5_lite():
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite

    q5 = build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
    p25 = build_p25(True)
    for ep in stream(3):
        p25.drive(ep)
        for b in ep["bids"]:
            q5.pipeline.push(p25.p.chunk(b, len(b["auction"])))
        q5.pipeline.barrier()
        assert p25.mview.snapshot() == q5.mview.snapshot()


def troublemaker_run(port: bool, chaos: bool, seed: int = 9):
    """A troublemaker at rate 1 (or none) in front of COUNT(*) per k ->
    MV over four two-row chunks. Returns the MV snapshot, the rows the
    troublemaker emitted and its log."""
    p = pkg(port)
    if port:
        from risingwave_tpu_torch.executors import TroublemakerExecutor
    else:
        from risingwave_tpu.executors.troublemaker import TroublemakerExecutor
    agg = p.Agg(("k",), (p.Call("count_star", None, "n"),), {"k": p.i64}, capacity=1 << 8)
    mv = p.Mv(("k",), ("n",), {"k": p.i64, "n": p.i64}, capacity=1 << 8)
    pipe = p.Pipeline([agg, mv])
    tm = TroublemakerExecutor(seed=seed, rate=1.0)
    emitted = []
    for i in range(4):
        c = p.chunk({"k": np.asarray([i, i + 1], np.int64), "v": np.asarray([i, i + 1], np.int64)},
                    2)
        for out in (tm.apply(c) if chaos else [c]):
            emitted.append(out.to_numpy(with_ops=True))
            pipe.push(out)
    pipe.barrier()
    return mv.snapshot(), emitted, tm.log


@pytest.mark.parametrize("seed", [9, 10, 20261017])
def test_troublemaker_faults_show_in_the_mv(seed):
    """``tests/test_troublemaker.py``'s downstream test on the port: the
    MV behind a troublemaker at rate 1 holds the signed count of what it
    emitted (its logged faults included), differs from the clean run's,
    and equals the reference's under the same seed."""
    clean, _, _ = troublemaker_run(True, False)
    dirty, emitted, log = troublemaker_run(True, True, seed)
    ref_dirty, _, ref_log = troublemaker_run(False, True, seed)
    assert len(log) == 4 and log == ref_log
    assert dirty == ref_dirty and dirty != clean
    counts = Counter()
    for d in emitted:
        for k, op in zip(d["k"].tolist(), d["__op__"].tolist()):
            counts[k] += -1 if op in (1, 2) else 1
    # a group whose signed count is not positive is absent, in both packages
    assert dirty == {(k,): (n,) for k, n in counts.items() if n > 0}
