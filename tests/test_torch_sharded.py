"""The port's sharded executors (``risingwave_tpu_torch/parallel/``) on the
CPU against the reference's sharded executors on its 8 virtual devices
and against the port's single-chip executors.

Mirrors ``tests/test_sharded_agg.py`` (6 cases), ``test_sharded_join.py``
(q8 and every join type), ``test_sharded_top_n.py`` (2),
``test_sharded_checkpoint.py`` (recovery at another shard count; a
sharded join's checkpoint restored into a single-chip join). Flush
deltas equal the reference's row for row (on the CPU the plain versions
place keys in the reference's slots), digests through
``integrity.host_digest``. q7's two cases are in
``test_torch_sharded_plan.py`` (it is planned from SQL there, as the
reference's test plans it).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.ops.agg import AggCall as RefAggCall
from risingwave_tpu.parallel import (
    ShardedDedup as RefShardedDedup,
    ShardedGroupTopN as RefShardedGroupTopN,
    ShardedHashAgg as RefShardedHashAgg,
    ShardedHashJoin as RefShardedHashJoin,
    flatten_stacked as ref_flatten,
    make_mesh as ref_make_mesh,
)
from risingwave_tpu.parallel.sharded_agg import stack_chunks as ref_stack
from risingwave_tpu_torch.array.chunk import StreamChunk, flatten_stacked, stack_chunks
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.executors.dedup import AppendOnlyDedupExecutor
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.executors.hash_join import JOIN_TYPES, HashJoinExecutor
from risingwave_tpu_torch.executors.hop_window import hop_step_fn as _hop_step
from risingwave_tpu_torch.executors.materialize import MaterializeExecutor
from risingwave_tpu_torch.executors.top_n_plain import RetractableGroupTopNExecutor
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.parallel import (
    ShardedDedup,
    ShardedGroupTopN,
    ShardedHashAgg,
    ShardedHashJoin,
    make_mesh,
)
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore
from risingwave_tpu_torch.types import Op

N = 8
I64 = torch.int64
WINDOW_MS = 10_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mesh(n=N):
    return make_mesh(n, device="cpu")


def _replay(snap, chunk, n_keys=1):
    d = chunk.to_numpy(with_ops=True)
    names = [n for n in d if n != "__op__" and not n.endswith("__null")]
    for i in range(len(d["__op__"])):
        key = tuple(d[n][i] for n in names[:n_keys])
        if d["__op__"][i] in (Op.DELETE, Op.UPDATE_DELETE):
            snap.pop(key, None)
        else:
            snap[key] = tuple(d[n][i] for n in names[n_keys:])
    return snap


def _rows(chunks) -> dict:
    """A barrier's emission, every chunk's live rows in order."""
    parts = [c.to_numpy(with_ops=True) for c in chunks]
    keys = sorted(set().union(*parts)) if parts else []
    return {k: np.concatenate([p[k] for p in parts if k in p]) for k in keys}


def _same_rows(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k].astype(np.int64), b[k].astype(np.int64)), k


def _both(cols, cap, nulls=None, ops=None):
    return (StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu"),
            RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls))


def _ref_call(c):
    return RefAggCall(c.kind, c.input, c.output)


def _ref_dtypes(dt):
    return {k: jnp.dtype(torch.empty(0, dtype=v).numpy().dtype) for k, v in dt.items()}


# -- ShardedHashAgg (tests/test_sharded_agg.py) ------------------------------------
def _agg_trio(calls, dtypes, cap, out_cap, single_cap, **kw):
    return (ShardedHashAgg(mesh(), ("k",) if "k" in dtypes else ("auction",), calls, dtypes,
                           capacity=cap, out_cap=out_cap, **kw),
            RefShardedHashAgg(ref_make_mesh(N), ("k",) if "k" in dtypes else ("auction",),
                              tuple(_ref_call(c) for c in calls), _ref_dtypes(dtypes),
                              capacity=cap, out_cap=out_cap, **kw),
            HashAggExecutor(("k",) if "k" in dtypes else ("auction",), calls, dtypes,
                            capacity=single_cap, out_cap=single_cap, device="cpu",
                            nullable_keys=kw.get("nullable_keys", ())))


def _splits(n=N):
    """One Nexmark split per shard, the reference's multi-split setup."""
    dicts = NexmarkGenerator.make_dictionaries()
    return [NexmarkGenerator(NexmarkConfig(), split_index=i, split_num=n, dictionaries=dicts)
            for i in range(n)]


def test_sharded_agg_matches_single_chip_and_reference():
    calls = (AggCall("count_star", None, "cnt"), AggCall("sum", "price", "total"))
    dtypes = {"auction": I64, "price": I64}
    sharded, ref, single = _agg_trio(calls, dtypes, 1 << 10, 1 << 8, 1 << 13)
    snaps = [{}, {}]
    gens = _splits()
    for epoch in range(3):
        per, rper = [], []
        for g in gens:
            bid = g.next_chunks(300, 512, device="cpu")["bid"].select(["auction", "price"])
            per.append(bid)
            rper.append(_to_ref(bid))
            single.apply(bid)
        sharded.apply(stack_chunks(per))
        ref.apply(ref_stack(rper))
        got = sharded.on_barrier(None)
        _same_rows(_rows(got), _rows(ref.on_barrier(None)))  # the deltas, row for row
        for out in got:
            _replay(snaps[0], out)
        for out in single.on_barrier(None):
            _replay(snaps[1], out)
        assert snaps[0] == snaps[1]
        assert sharded.state_digest() == ref.state_digest() == single.state_digest()
    assert len(snaps[1]) > 100
    counts = sharded.ex_counts_last
    assert counts.shape == (N, N) and int(counts.sum()) == sum(int(c.valid.sum()) for c in per)


def test_sharded_agg_state_is_actually_sharded():
    calls = (AggCall("count_star", None, "cnt"),)
    sharded = ShardedHashAgg(mesh(), ("k",), calls, {"k": I64}, capacity=1 << 10)
    keys = np.arange(64, dtype=np.int64)
    sharded.apply(stack_chunks([StreamChunk.from_numpy({"k": keys}, 64, device="cpu")
                                for _ in range(N)]))
    live = sharded.table.live.sum(1)
    assert int(live.sum()) == 64  # no group on two shards
    assert int((live > 0).sum()) > 1  # and spread
    assert sharded.table.live.shape == (N, 1 << 10)
    snap = {}
    for out in sharded.on_barrier(None):
        _replay(snap, out)
    assert {k[0] for k in snap} == set(range(64))
    assert all(v == (N,) for v in snap.values())


def test_sharded_agg_null_inputs_match_single_chip_and_reference():
    calls = (AggCall("count", "price", "cnt"), AggCall("sum", "price", "total"))
    dtypes = {"k": I64, "price": I64}
    sharded, ref, single = _agg_trio(calls, dtypes, 1 << 10, 1 << 9, 1 << 12)
    rng = np.random.default_rng(7)
    per, rper = [], []
    for _ in range(N):
        cols = {"k": rng.integers(0, 40, 128).astype(np.int64),
                "price": rng.integers(1, 1000, 128).astype(np.int64)}
        c, rc = _both(cols, 128, nulls={"price": rng.random(128) < 0.3})
        per.append(c)
        rper.append(rc)
        single.apply(c)
    sharded.apply(stack_chunks(per))
    ref.apply(ref_stack(rper))
    got = sharded.on_barrier(None)
    _same_rows(_rows(got), _rows(ref.on_barrier(None)))
    a, b = {}, {}
    for out in got:
        _replay(a, out)
    for out in single.on_barrier(None):
        _replay(b, out)
    assert b and a == b


def test_sharded_agg_nullable_group_key():
    calls = (AggCall("count_star", None, "cnt"),)
    sharded, ref, single = _agg_trio(calls, {"k": I64}, 1 << 10, 1 << 9, 1 << 12,
                                     nullable_keys=("k",))
    rng = np.random.default_rng(11)
    per, rper = [], []
    for _ in range(N):
        k = rng.integers(0, 10, 64).astype(np.int64)
        isnull = rng.random(64) < 0.25
        k[isnull] = 0  # NULL rows carry 0: they must not merge with the real 0
        c, rc = _both({"k": k}, 64, nulls={"k": isnull})
        per.append(c)
        rper.append(rc)
        single.apply(c)
    sharded.apply(stack_chunks(per))
    ref.apply(ref_stack(rper))

    def groups(outs):
        snap = {}
        for out in outs:
            d = out.to_numpy(with_ops=True)
            for i in range(len(d["__op__"])):
                key = None if d["k__null"][i] else d["k"][i]
                if d["__op__"][i] in (Op.DELETE, Op.UPDATE_DELETE):
                    snap.pop(key, None)
                else:
                    snap[key] = d["cnt"][i]
        return snap

    got = sharded.on_barrier(None)
    _same_rows(_rows(got), _rows(ref.on_barrier(None)))
    want = groups(single.on_barrier(None))
    assert None in want and groups(got) == want


def test_sharded_agg_checkpoint_restore_across_mesh_sizes():
    """Commit at 8 shards, recover at 4 (every group routed by
    ``dest_shard``), continue: equal to an unkilled single-chip twin."""
    calls = (AggCall("count_star", None, "cnt"), AggCall("sum", "price", "total"))
    dtypes = {"auction": I64, "price": I64}

    def mk(n):
        return ShardedHashAgg(mesh(n), ("auction",), calls, dtypes, capacity=1 << 10,
                              out_cap=1 << 9, table_id="sagg")

    store = MemObjectStore()
    mgr = CheckpointManager(store)
    sharded = mk(N)
    single = HashAggExecutor(("auction",), calls, dtypes, capacity=1 << 12, out_cap=1 << 11,
                             device="cpu")
    gens = _splits()
    a, b = {}, {}
    for epoch in range(2):
        per = [g.next_chunks(400, 512, device="cpu")["bid"].select(["auction", "price"])
               for g in gens]
        for bid in per:
            single.apply(bid)
        sharded.apply(stack_chunks(per))
        for out in sharded.on_barrier(None):
            _replay(a, out)
        for out in single.on_barrier(None):
            _replay(b, out)
        mgr.commit_epoch((epoch + 1) << 16, [sharded])
    assert a == b
    restored = mk(4)
    CheckpointManager(store).recover([restored])
    assert restored.state_digest() == sharded.state_digest()
    assert int((restored.table.live.sum(1) > 0).sum()) == 4
    for _ in range(2):
        per8 = [g.next_chunks(400, 512, device="cpu")["bid"].select(["auction", "price"])
                for g in gens]
        for bid in per8:
            single.apply(bid)
        per4 = []
        for k in range(4):
            x, y = per8[2 * k].to_numpy(False), per8[2 * k + 1].to_numpy(False)
            cols = {n: np.concatenate([x[n], y[n]]) for n in ("auction", "price")}
            per4.append(StreamChunk.from_numpy(cols, 1024, device="cpu"))
        restored.apply(stack_chunks(per4))
        for out in restored.on_barrier(None):
            _replay(a, out)
        for out in single.on_barrier(None):
            _replay(b, out)
    assert a == b


def test_sharded_agg_grows():
    """A tiny capacity grows (every shard to one capacity) instead of
    latching ``dropped``, and stays equal to the reference's growth."""
    calls = (AggCall("count_star", None, "cnt"),)
    sharded, ref, single = _agg_trio(calls, {"k": I64}, 64, 1 << 12, 1 << 12, bucket_cap=512)
    rng = np.random.default_rng(5)
    a, b = {}, {}
    for _ in range(4):
        per, rper = [], []
        for _ in range(N):
            c, rc = _both({"k": rng.integers(0, 3000, 256).astype(np.int64)}, 256)
            per.append(c)
            rper.append(rc)
            single.apply(c)
        sharded.apply(stack_chunks(per))
        ref.apply(ref_stack(rper))
        got = sharded.on_barrier(None)
        _same_rows(_rows(got), _rows(ref.on_barrier(None)))
        for out in got:
            _replay(a, out)
        for out in single.on_barrier(None):
            _replay(b, out)
    assert sharded.capacity > 64 and sharded.capacity == ref.capacity
    assert a == b


# -- ShardedDedup + ShardedHashJoin (tests/test_sharded_join.py) ---------------------
P_DT = {"id": I64, "name": torch.int32, "starttime": I64}
A_DT = {"seller": I64, "astarttime": I64}


def _per_shard_q8(n_epochs=3, events=800, cap=1024, n=N):
    """Per-shard person and auction chunks (one Nexmark split each),
    tumbled on the host, for both packages."""
    gens = _splits(n)
    epochs = []
    for _ in range(n_epochs):
        p_sh, a_sh, rp_sh, ra_sh = [], [], [], []
        for g in gens:
            ch = g.next_chunks(events, cap, device="cpu")
            p = ch["person"]
            p = (StreamChunk.from_numpy({"id": np.zeros(0, np.int64), "name": np.zeros(0, np.int32),
                                         "date_time": np.zeros(0, np.int64)}, cap, device="cpu")
                 if p is None else p.select(["id", "name", "date_time"]))
            a = ch["auction"]
            a = (StreamChunk.from_numpy({"seller": np.zeros(0, np.int64),
                                         "date_time": np.zeros(0, np.int64)}, cap, device="cpu")
                 if a is None else a.select(["seller", "date_time"]))
            p = _hop_step(p, "date_time", WINDOW_MS, WINDOW_MS, "starttime").select(
                ["id", "name", "starttime"])
            a = _hop_step(a, "date_time", WINDOW_MS, WINDOW_MS, "astarttime").select(
                ["seller", "astarttime"])
            p_sh.append(p)
            a_sh.append(a)
            rp_sh.append(_to_ref(p))
            ra_sh.append(_to_ref(a))
        epochs.append((p_sh, a_sh, rp_sh, ra_sh))
    return epochs


def _to_ref(c: StreamChunk) -> RefChunk:
    return RefChunk(columns={k: jnp.asarray(v.numpy()) for k, v in c.columns.items()},
                    valid=jnp.asarray(c.valid.numpy()),
                    nulls={k: jnp.asarray(v.numpy()) for k, v in c.nulls.items()},
                    ops=jnp.asarray(c.ops.numpy()))


def _q8_sharded(m, capacity=1 << 10):
    sd_p = ShardedDedup(m, ("id", "name", "starttime"), P_DT, capacity=capacity,
                        table_id="sq8.dp")
    sd_a = ShardedDedup(m, ("seller", "astarttime"), A_DT, capacity=capacity, table_id="sq8.da")
    sj = ShardedHashJoin(m, ("id", "starttime"), ("seller", "astarttime"), P_DT, A_DT,
                         capacity=capacity, fanout=8, out_cap=1 << 11, table_id="sq8.j")
    mv = MaterializeExecutor(pk=("id", "starttime"), columns=("name",), table_id="sq8.mview")
    return sd_p, sd_a, sj, mv


def _q8_epoch(sd_p, sd_a, sj, mv, sp, sa, flat=flatten_stacked):
    for out in sd_p.apply(sp):
        for j in sj.apply_left(out):
            mv.apply(flat(j))
    for out in sd_a.apply(sa):
        for j in sj.apply_right(out):
            mv.apply(flat(j))
    for ex in (sd_p, sd_a, sj, mv):
        ex.on_barrier(None)


def _q8_oracle(epochs):
    o_dp = AppendOnlyDedupExecutor(("id", "name", "starttime"), P_DT, capacity=1 << 12,
                                   device="cpu")
    o_da = AppendOnlyDedupExecutor(("seller", "astarttime"), A_DT, capacity=1 << 12,
                                   device="cpu")
    o_j = HashJoinExecutor(("id", "starttime"), ("seller", "astarttime"), P_DT, A_DT,
                           capacity=1 << 12, fanout=8, out_cap=1 << 13, device="cpu")
    o_mv = MaterializeExecutor(pk=("id", "starttime"), columns=("name",), table_id="oq8")
    for p_sh, a_sh, _, _ in epochs:
        for c in p_sh:
            for d in o_dp.apply(c):
                for j in o_j.apply_left(d):
                    o_mv.apply(j)
        for c in a_sh:
            for d in o_da.apply(c):
                for j in o_j.apply_right(d):
                    o_mv.apply(j)
    return o_mv.snapshot(), (o_dp, o_da, o_j)


def test_sharded_q8_matches_single_chip_and_reference():
    from risingwave_tpu.executors.materialize import MaterializeExecutor as RefMV

    epochs = _per_shard_q8()
    port = _q8_sharded(mesh())
    rm = ref_make_mesh(N)
    rdt = lambda d: _ref_dtypes(d)  # noqa: E731
    ref = (RefShardedDedup(rm, ("id", "name", "starttime"), rdt(P_DT), capacity=1 << 10),
           RefShardedDedup(rm, ("seller", "astarttime"), rdt(A_DT), capacity=1 << 10),
           RefShardedHashJoin(rm, ("id", "starttime"), ("seller", "astarttime"), rdt(P_DT),
                              rdt(A_DT), capacity=1 << 10, fanout=8, out_cap=1 << 11),
           RefMV(pk=("id", "starttime"), columns=("name",), table_id="rq8"))
    for p_sh, a_sh, rp_sh, ra_sh in epochs:
        _q8_epoch(*port, stack_chunks(p_sh), stack_chunks(a_sh))
        _q8_epoch(*ref, ref_stack(rp_sh), ref_stack(ra_sh), flat=ref_flatten)
        assert port[3].snapshot() == ref[3].snapshot()
    want, (o_dp, o_da, o_j) = _q8_oracle(epochs)
    assert len(want) > 50 and port[3].snapshot() == want
    for mine, theirs in zip(port[:3], ref[:3]):
        assert mine.state_digest() == theirs.state_digest()
    assert port[0].state_digest() == o_dp.state_digest()
    assert port[1].state_digest() == o_da.state_digest()


def _join_stream(rng, steps=6, cap=32):
    out = []
    for step in range(steps):
        side = "l" if step % 2 == 0 else "r"
        names = ("lk", "lv") if side == "l" else ("rk", "rv")
        cols = {names[0]: rng.integers(0, 48, cap).astype(np.int64),
                names[1]: rng.integers(0, 5, cap).astype(np.int64)}
        empty = {k: np.zeros(0, np.int64) for k in names}
        port = [StreamChunk.from_numpy(cols if i == step % N else empty, cap, device="cpu")
                for i in range(N)]
        ref = [RefChunk.from_numpy(cols if i == step % N else empty, cap) for i in range(N)]
        out.append((side, port[step % N], stack_chunks(port), ref_stack(ref)))
    return out


def _acc(counter, chunks, out_names):
    for c in chunks:
        d = c.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            row = tuple(None if (d.get(n + "__null") is not None and d[n + "__null"][i])
                        else int(d[n][i]) for n in out_names)
            counter[row] += 1 if d["__op__"][i] in (Op.INSERT, Op.UPDATE_INSERT) else -1


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_sharded_join_types_match_single_and_reference(join_type):
    L, R = {"lk": I64, "lv": I64}, {"rk": I64, "rv": I64}
    sj = ShardedHashJoin(mesh(), ("lk",), ("rk",), L, R, capacity=256, fanout=16,
                         out_cap=1 << 10, join_type=join_type)
    ref = RefShardedHashJoin(ref_make_mesh(N), ("lk",), ("rk",), _ref_dtypes(L),
                             _ref_dtypes(R), capacity=256, fanout=16, out_cap=1 << 10,
                             join_type=join_type)
    single = HashJoinExecutor(("lk",), ("rk",), L, R, capacity=1 << 10, fanout=16,
                              out_cap=1 << 12, join_type=join_type, device="cpu")
    got, want, theirs = Counter(), Counter(), Counter()
    for side, flat, stacked, rstacked in _join_stream(np.random.default_rng(7)):
        if side == "l":
            outs, routs, souts = sj.apply_left(stacked), ref.apply_left(rstacked), \
                single.apply_left(flat)
        else:
            outs, routs, souts = sj.apply_right(stacked), ref.apply_right(rstacked), \
                single.apply_right(flat)
        assert outs[0].valid.shape == (N, 1 << 10)
        _acc(got, [flatten_stacked(o) for o in outs], sj.out_names)
        _acc(theirs, [ref_flatten(o) for o in routs], ref.out_names)
        _acc(want, souts, single.out_names)
    for ex in (sj, ref, single):
        ex.on_barrier(None)
    nz = lambda c: {k: v for k, v in c.items() if v}  # noqa: E731
    assert nz(want) and nz(got) == nz(want) == nz(theirs)
    assert sj.state_digest() == ref.state_digest() == single.state_digest()


# -- ShardedGroupTopN (tests/test_sharded_top_n.py) -----------------------------------
T_DT = {"g": I64, "o": I64, "id": I64}


def _top_mv(snap, chunks):
    for c in chunks:
        d = c.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            row = (int(d["g"][i]), int(d["o"][i]), int(d["id"][i]))
            if int(d["__op__"][i]) in (1, 3):
                snap.discard(row)
            else:
                snap.add(row)
    return snap


def _top_streams(rng, epochs):
    """Per epoch: the stacked chunk (port), the same for the reference,
    and the flat chunks, of mixed inserts and deletes split round-robin."""
    live, nid, out = {}, 0, []
    for _ in range(epochs):
        rows = []
        for _ in range(int(rng.integers(8, 30))):
            if live and rng.random() < 0.3:
                rid = int(rng.choice(list(live)))
                g, o = live.pop(rid)
                rows.append((g, o, rid, 1))
            else:
                g, o = int(rng.integers(0, 6)), int(rng.integers(0, 100))
                live[nid] = (g, o)
                rows.append((g, o, nid, 0))
                nid += 1
        per = [[] for _ in range(N)]
        for j, r in enumerate(rows):
            per[j % N].append(r)

        def chunks(rs):
            cols = {c: np.asarray([r[i] for r in rs], np.int64) for i, c in enumerate("goi")}
            cols["id"] = cols.pop("i")
            return _both(cols, 16, ops=np.asarray([r[3] for r in rs], np.int32))

        both = [chunks(p) for p in per]
        out.append((stack_chunks([b[0] for b in both]), ref_stack([b[1] for b in both]),
                    [b[0] for b, p in zip(both, per) if p]))
    return out


def _mk_top(m, table_id="stn", cap=1 << 9):
    return ShardedGroupTopN(m, ("g",), "o", 3, ("id",), T_DT, capacity=cap, table_id=table_id)


def test_sharded_group_top_n_matches_single_chip_and_reference():
    sharded = _mk_top(mesh())
    ref = RefShardedGroupTopN(ref_make_mesh(N), ("g",), "o", 3, ("id",), _ref_dtypes(T_DT),
                              capacity=1 << 9, table_id="rtn")
    single = RetractableGroupTopNExecutor(("g",), "o", 3, ("id",), T_DT, capacity=1 << 10,
                                          table_id="stn1", device="cpu")
    s, r, o = set(), set(), set()
    for stacked, rstacked, flat in _top_streams(np.random.default_rng(13), 10):
        sharded.apply(stacked)
        ref.apply(rstacked)
        for c in flat:
            single.apply(c)
        _top_mv(s, sharded.on_barrier(None))
        _top_mv(r, ref.on_barrier(None))
        _top_mv(o, single.on_barrier(None))
        assert s == o == r
    assert len(s) > 5
    assert sharded.state_digest() == ref.state_digest() == single.state_digest()


def test_sharded_group_top_n_checkpoint_cross_layout():
    """A sharded checkpoint restores into a fresh sharded executor at
    another shard count and into the single-chip one; both continue to
    the uninterrupted run's result."""
    store = MemObjectStore()
    sharded = _mk_top(mesh(), table_id="stx", cap=1 << 4)  # grows on the way
    streams = _top_streams(np.random.default_rng(29), 8)
    s = set()
    for stacked, _, _ in streams[:5]:
        sharded.apply(stacked)
        _top_mv(s, sharded.on_barrier(None))
    assert sharded.capacity > 1 << 4
    CheckpointManager(store).commit_epoch(1 << 16, [sharded])
    twin = _mk_top(mesh(), table_id="stx2")
    t = set()
    for stacked, _, _ in streams:
        twin.apply(stacked)
        _top_mv(t, twin.on_barrier(None))
    again = _mk_top(mesh(), table_id="stx")
    CheckpointManager(store).recover([again])
    s2 = set(s)
    for stacked, _, _ in streams[5:]:
        again.apply(stacked)
        _top_mv(s2, again.on_barrier(None))
    assert s2 == t
    single = RetractableGroupTopNExecutor(("g",), "o", 3, ("id",), T_DT, capacity=1 << 10,
                                          table_id="stx", device="cpu")
    CheckpointManager(store).recover([single])
    s1 = set(s)
    for _, _, flat in streams[5:]:
        for c in flat:
            single.apply(c)
        _top_mv(s1, single.on_barrier(None))
    assert s1 == t


# -- checkpoints (tests/test_sharded_checkpoint.py) -------------------------------------
@pytest.mark.parametrize("recover_shards", [N, 4])
def test_sharded_q8_kill_and_recover_midstream(recover_shards):
    """Two epochs sharded, a commit, the kill; a rebuild (at 8 or 4
    shards) recovers and two more epochs end at the single-chip run of
    all four."""
    epochs = _per_shard_q8(n_epochs=4)
    want, _ = _q8_oracle(epochs)
    assert len(want) > 50
    mgr = CheckpointManager(MemObjectStore())
    q8 = _q8_sharded(mesh())
    for p_sh, a_sh, _, _ in epochs[:2]:
        _q8_epoch(*q8, stack_chunks(p_sh), stack_chunks(a_sh))
    staged = mgr.stage(list(q8))
    assert {d.table_id for d in staged} >= {"sq8.dp", "sq8.da", "sq8.j.left", "sq8.j.right"}
    mgr.commit_staged(1, staged)
    del q8  # the kill
    q8b = _q8_sharded(mesh(recover_shards))
    mgr.recover(list(q8b))
    for p_sh, a_sh, _, _ in epochs[2:]:
        for i in range(0, N, recover_shards):
            _q8_epoch(*q8b, stack_chunks(p_sh[i:i + recover_shards]),
                      stack_chunks(a_sh[i:i + recover_shards]))
    assert q8b[3].snapshot() == want


def test_sharded_join_checkpoint_restores_into_single_chip():
    L, R = {"lk": I64, "lv": I64}, {"rk": I64, "rv": I64}
    sj = ShardedHashJoin(mesh(), ("lk",), ("rk",), L, R, capacity=256, fanout=16,
                         out_cap=1 << 10, table_id="xj")
    oracle = HashJoinExecutor(("lk",), ("rk",), L, R, capacity=1 << 10, fanout=16,
                              out_cap=1 << 12, table_id="oj", device="cpu")
    stream = _join_stream(np.random.default_rng(11), steps=8)
    for side, flat, stacked, _ in stream[:4]:
        if side == "l":
            sj.apply_left(stacked)
            oracle.apply_left(flat)
        else:
            sj.apply_right(stacked)
            oracle.apply_right(flat)
    sj.on_barrier(None)
    mgr = CheckpointManager(MemObjectStore())
    staged = mgr.stage([sj])
    assert {d.table_id for d in staged} == {"xj.left", "xj.right"}
    mgr.commit_staged(1, staged)
    single = HashJoinExecutor(("lk",), ("rk",), L, R, capacity=1 << 10, fanout=16,
                              out_cap=1 << 12, table_id="xj", device="cpu")
    mgr.recover([single])
    assert single.state_digest() == oracle.state_digest() == sj.state_digest()
    got, want = Counter(), Counter()
    for side, flat, _, _ in stream[4:]:
        if side == "l":
            _acc(got, single.apply_left(flat), single.out_names)
            _acc(want, oracle.apply_left(flat), oracle.out_names)
        else:
            _acc(got, single.apply_right(flat), single.out_names)
            _acc(want, oracle.apply_right(flat), oracle.out_names)
    nz = lambda c: {k: v for k, v in c.items() if v}  # noqa: E731
    assert nz(want) and nz(got) == nz(want)


# -- the capacity escape (the reference's grow_for_replay) ----------------------------
def test_capacity_escape_latches_and_grows():
    """A chunk whose rows all route to one shard past its bucket latches
    every sharded executor (its barrier raises); ``grow_for_replay``
    doubles the bucket and the capacities and empties the state."""
    m = mesh(4)
    cols = {"k": np.full(64, 7, np.int64), "v": np.arange(64, dtype=np.int64)}
    stacked = stack_chunks([StreamChunk.from_numpy(cols, 64, device="cpu") for _ in range(4)])
    dt = {"k": I64, "v": I64}
    exs = [
        ShardedHashAgg(m, ("k",), (AggCall("count_star", None, "n"),), dt, capacity=64,
                       bucket_cap=16),
        ShardedDedup(m, ("k", "v"), dt, capacity=64, bucket_cap=16),
        ShardedGroupTopN(m, ("k",), "v", 2, ("v",), dt, capacity=64, bucket_cap=16),
    ]
    from risingwave_tpu_torch.parallel import ShardedMaterialize

    exs.append(ShardedMaterialize(m, ("k",), ("v",), dt, capacity=64, bucket_cap=16))
    for ex in exs:
        ex.apply(stacked)
        assert ex.capacity_overflow_latched(), type(ex).__name__
        with pytest.raises(RuntimeError, match="overflow"):
            ex.on_barrier(None)
        cap = ex.table.fp1.shape[-1]
        ex.grow_for_replay()
        assert ex.bucket_cap == 32 and ex.table.fp1.shape[-1] == 2 * cap
        assert not ex.capacity_overflow_latched() and not bool(ex.table.live.any())
    L, R = {"lk": I64, "lv": I64}, {"rk": I64, "rv": I64}
    sj = ShardedHashJoin(m, ("lk",), ("rk",), L, R, capacity=64, fanout=4, out_cap=256,
                         bucket_cap=16)
    lcols = {"lk": cols["k"], "lv": cols["v"]}
    sj.apply_left(stack_chunks([StreamChunk.from_numpy(lcols, 64, device="cpu")] * 4))
    assert sj.capacity_overflow_latched()
    with pytest.raises(RuntimeError, match="overflowed"):
        sj.on_barrier(None)
    sj.grow_for_replay()
    assert sj.bucket_cap == 32 and sj.out_cap == 512 and not sj.capacity_overflow_latched()


def test_sharded_mv_takes_a_copartitioned_flush_whole():
    """An agg's stacked flush keyed like the MV's pk routes each shard's
    whole round to one shard: past the reference's bucket (2 * width /
    n) once a round carries U-/U+ pairs, so the reference's MV latches
    (a fault it has at q5's scale); the port's bucket is the width, and
    its MV equals the single-chip agg's groups."""
    from risingwave_tpu.parallel.sharded_mv import ShardedMaterialize as RefShardedMV
    from risingwave_tpu_torch.parallel import ShardedMaterialize

    calls = (AggCall("count_star", None, "n"),)
    m, n = mesh(4), 4
    agg = ShardedHashAgg(m, ("k",), calls, {"k": I64}, capacity=1 << 10, out_cap=64,
                         stacked_out=True)
    mv = ShardedMaterialize(m, ("k",), ("n",), {"k": I64, "n": I64}, capacity=1 << 10)
    ref_agg = RefShardedHashAgg(ref_make_mesh(n), ("k",), tuple(_ref_call(c) for c in calls),
                                _ref_dtypes({"k": I64}), capacity=1 << 10, out_cap=64,
                                stacked_out=True)
    ref_mv = RefShardedMV(ref_make_mesh(n), ("k",), ("n",), _ref_dtypes({"k": I64, "n": I64}),
                          capacity=1 << 10)
    single = HashAggExecutor(("k",), calls, {"k": I64}, capacity=1 << 12, device="cpu")
    keys = np.arange(400, dtype=np.int64)
    ref_latched = False
    for _ in range(2):  # the second epoch updates every group: U-/U+ pairs
        per = [_both({"k": keys[i::n]}, 128) for i in range(n)]
        agg.apply(stack_chunks([p for p, _ in per]))
        ref_agg.apply(ref_stack([r for _, r in per]))
        for p, _ in per:
            single.apply(p)
        for out in agg.on_barrier(None):
            mv.apply(out)
        for out in ref_agg.on_barrier(None):
            ref_mv.apply(out)
        mv.on_barrier(None)
        single.on_barrier(None)
        try:
            ref_mv.on_barrier(None)
        except RuntimeError as e:
            ref_latched = "overflow" in str(e)
    assert ref_latched, "the reference's MV bucket overflows on this flush"
    want = {(int(k),): (2,) for k in keys}
    assert mv.snapshot() == want and not mv.capacity_overflow_latched()
    assert mv.bucket_cap is None and mv._built_bucket_cap == 128
