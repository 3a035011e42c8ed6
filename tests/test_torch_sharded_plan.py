"""SQL planned onto the mesh: the port's ``sharded_planned_mv`` against
the reference's on its virtual CPU devices.

Mirrors ``__graft_entry__.py:133`` ``dryrun_multichip`` and
``tests/test_sharded_q7.py``: q5, q8 and q7 from SQL, each plan's
executor classes position by position against the reference's, each MV
against the reference's sharded plan and the port's serial plan at
every barrier; q8 killed after a commit and recovered at another shard
count through the port's ``CheckpointManager`` (``StreamingRuntime`` is
not ported).
"""

import pytest
import torch

import __graft_entry__ as graft
from risingwave_tpu.runtime import fragmenter as ref_frag
from risingwave_tpu_torch.parallel import (
    ShardedDedup,
    ShardedHashAgg,
    ShardedHashJoin,
    ShardedMaterialize,
)
from risingwave_tpu_torch.runtime import sharded_planned_mv
from risingwave_tpu_torch.runtime.fragmenter import FlattenExecutor, StackSplitExecutor
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore
from test_torch_sql import events, port_factory, push, ref_factory

N = 4
TIMEOUT = 20.0
SQL = {"q5": graft.Q5_SQL, "q8": graft.Q8_SQL, "q7": graft.Q7_SQL}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _barrier_timeout(monkeypatch):
    monkeypatch.setenv("RW_BARRIER_TIMEOUT_S", str(TIMEOUT))


def _kinds(mv):
    return [type(e).__name__ for e in mv.pipeline.executors]


@pytest.mark.parametrize("query", ["q5", "q8", "q7"])
def test_sharded_plan_matches_reference_classes(query):
    port = sharded_planned_mv(port_factory(), SQL[query], N)
    ref = ref_frag.sharded_planned_mv(ref_factory(), SQL[query], N)
    try:
        assert _kinds(port) == _kinds(ref)
        assert type(port.mview).__name__ == type(ref.mview).__name__ == "ShardedMaterialize"
        exs = port.pipeline.executors
        assert any(isinstance(e, StackSplitExecutor) for e in exs)
        assert isinstance(exs[-1], FlattenExecutor)
        want = {"q5": (ShardedHashAgg,), "q8": (ShardedDedup, ShardedHashJoin),
                "q7": (ShardedHashAgg, ShardedHashJoin)}[query]
        for cls in want:
            assert any(isinstance(e, cls) for e in exs), cls
        assert all(e.mesh.n_shards == N for e in exs if hasattr(e, "mesh"))
        if query == "q7":
            (agg,) = [e for e in exs if isinstance(e, ShardedHashAgg)]
            assert agg.stacked_out, "the join side's agg flushes stacked chunks"
    finally:
        port.pipeline.close()
        ref.pipeline.close()


def _run_three(query, batches, cap, factory_cap=1 << 12):
    """The port's sharded plan, the reference's and the port's serial
    plan over the same batches; the MVs equal at every barrier."""
    port = sharded_planned_mv(port_factory(factory_cap), SQL[query], N)
    ref = ref_frag.sharded_planned_mv(ref_factory(factory_cap), SQL[query], N)
    serial = port_factory(factory_cap)().plan(SQL[query])
    try:
        for ev in batches:
            for mv, is_port in ((port, True), (ref, False), (serial, True)):
                push(mv.pipeline, mv.inputs, ev, port=is_port, cap=cap)
                mv.pipeline.barrier()
            want = serial.mview.snapshot()
            assert port.mview.snapshot() == want == ref.mview.snapshot()
        return port, want
    finally:
        port.pipeline.close()
        ref.pipeline.close()


def test_sharded_q5_matches_reference_every_barrier():
    batches = [{"bid": ev["bid"]} for ev in events(4, n=1024, rate=10_000, seed=2)]
    port, want = _run_three("q5", batches, cap=1024)
    assert len(want) > 50
    (smv,) = [e for e in port.pipeline.executors if isinstance(e, ShardedMaterialize)]
    rows = smv.shard_rows()
    assert sum(rows) == len(want) and all(r > 0 for r in rows)
    keys = sorted(want)[:5] + [(-1, -1)]
    assert smv.get_rows(keys) == [want.get(k) for k in keys]  # point reads, a miss too


def test_sharded_q8_matches_reference_every_barrier():
    batches = [{"person": ev["person"], "auction": ev["auction"]}
               for ev in events(4, n=1500, rate=10_000, seed=6)]
    _, want = _run_three("q8", batches, cap=2048)
    assert want


def test_sharded_q7_matches_reference_every_barrier():
    batches = [{"bid": ev["bid"]} for ev in events(8, n=1500, rate=1000)]
    _, want = _run_three("q7", batches, cap=2048, factory_cap=1 << 13)
    assert len(want) >= 2


def test_sharded_q8_kill_recover_at_another_shard_count():
    """Two epochs at N shards, a commit, the kill; a fresh plan at 2*N
    shards recovers (every row routed by ``dest_shard``) and the rest of
    the stream ends where an uninterrupted run does, at every barrier."""
    batches = [{"person": ev["person"], "auction": ev["auction"]}
               for ev in events(5, n=1500, rate=10_000, seed=9)]
    twin = sharded_planned_mv(port_factory(), SQL["q8"], N)
    a = sharded_planned_mv(port_factory(), SQL["q8"], N)
    b = None
    mgr = CheckpointManager(MemObjectStore())
    try:
        for ev in batches[:2]:
            for mv in (twin, a):
                push(mv.pipeline, mv.inputs, ev, port=True, cap=2048)
                mv.pipeline.barrier()
            mgr.commit_epoch(a.pipeline.epoch, a.pipeline.executors)
        pre = a.mview.snapshot()
        a.pipeline.close()  # the kill
        b = sharded_planned_mv(port_factory(), SQL["q8"], 2 * N)
        mgr.recover(b.pipeline.executors)
        b.pipeline._epoch = mgr.max_committed_epoch
        assert b.mview.snapshot() == pre
        for e in b.pipeline.executors:
            if hasattr(e, "mesh"):
                assert e.mesh.n_shards == 2 * N
        for ev in batches[2:]:
            for mv in (twin, b):
                push(mv.pipeline, mv.inputs, ev, port=True, cap=2048)
                mv.pipeline.barrier()
            assert b.mview.snapshot() == twin.mview.snapshot()
        assert len(twin.mview.snapshot()) > len(pre) > 0
    finally:
        for mv in (twin, a, b):
            if mv is not None:
                mv.pipeline.close()


def test_sharded_q7_kill_recover():
    """The whole sharded q7 plane (the MAX agg, both join sides, the
    sharded MV) committed after barrier 4, killed, recovered into a
    fresh plan, and continued: the MV ends at the serial plan's."""
    batches = [{"bid": ev["bid"]} for ev in events(8, n=1500, rate=1000)]
    serial = port_factory(1 << 13)().plan(SQL["q7"])
    for ev in batches:
        push(serial.pipeline, serial.inputs, ev, port=True, cap=2048)
        serial.pipeline.barrier()
    want = serial.mview.snapshot()
    mgr = CheckpointManager(MemObjectStore())
    a = sharded_planned_mv(port_factory(1 << 13), SQL["q7"], N)
    b = None
    try:
        for ev in batches[:4]:
            push(a.pipeline, a.inputs, ev, port=True, cap=2048)
            a.pipeline.barrier()
            mgr.commit_epoch(a.pipeline.epoch, a.pipeline.executors)
        a.pipeline.close()  # the kill
        b = sharded_planned_mv(port_factory(1 << 13), SQL["q7"], N)
        mgr.recover(b.pipeline.executors)
        b.pipeline._epoch = mgr.max_committed_epoch
        for ev in batches[4:]:
            push(b.pipeline, b.inputs, ev, port=True, cap=2048)
            b.pipeline.barrier()
        assert len(want) >= 2 and b.mview.snapshot() == want
    finally:
        a.pipeline.close()
        if b is not None:
            b.pipeline.close()
