"""The unified path of the port: SQL planned by ``StreamPlanner`` and run
through ``graph_planned_mv``'s actor graph (dispatchers on kernel AH's
plain masks, permit channels, parallel ``FragmentActor`` threads) on
the CPU, against the serial plan and against the reference's graph.

Mirrors ``tests/test_unified_runtime.py:72-190`` with the port's
``CheckpointManager`` in place of ``StreamingRuntime`` (not ported yet):
q5 and q8 at parallelism 2 against serial, a checkpoint at 2 restored
at 2 and at 3 (restore routes every row through ``vnode_of``), and a
store written by either package's graph recovered by the other's.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from risingwave_tpu.runtime import fragmenter as ref_frag
from risingwave_tpu.storage.object_store import LocalFsObjectStore as RefFsStore
from risingwave_tpu.storage.state_table import CheckpointManager as RefManager
from risingwave_tpu_torch.runtime.fragmenter import (
    GraphPipeline,
    PartitionedStateView,
    graph_planned_mv,
)
from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore, MemObjectStore
from test_torch_sql import events, port_factory, push, ref_factory

TIMEOUT = 20.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _barrier_timeout(monkeypatch):
    monkeypatch.setenv("RW_BARRIER_TIMEOUT_S", str(TIMEOUT))


def _bids(n=6, seed=2):
    return [{"bid": ev["bid"]} for ev in events(n, n=1500, rate=10_000, seed=seed)]


def _serial_q5(batches):
    serial = port_factory()().plan(graft.Q5_SQL)
    for ev in batches:
        push(serial.pipeline, serial.inputs, ev, port=True, cap=2048)
        serial.pipeline.barrier()
    return serial.mview.snapshot()


def _instance_live(view) -> list:
    return [int(np.asarray(inst.table.live).sum()) for inst in view._instances]


@pytest.mark.parametrize("epoch_batch", [True, False])
def test_graph_single_input_matches_serial_and_reference(epoch_batch):
    batches = _bids()
    serial = port_factory()().plan(graft.Q5_SQL)
    graph = graph_planned_mv(port_factory(), graft.Q5_SQL, parallelism=2,
                             epoch_batch=epoch_batch)
    ref = ref_frag.graph_planned_mv(ref_factory(), graft.Q5_SQL, parallelism=2,
                                    epoch_batch=epoch_batch)
    assert isinstance(graph.pipeline, GraphPipeline)
    try:
        for ev in batches:
            push(serial.pipeline, serial.inputs, ev, port=True, cap=2048)
            push(graph.pipeline, graph.inputs, ev, port=True, cap=2048)
            push(ref.pipeline, ref.inputs, ev, port=False, cap=2048)
            serial.pipeline.barrier()
            graph.pipeline.barrier()
            ref.pipeline.barrier()
            want = serial.mview.snapshot()
            assert want and graph.mview.snapshot() == want == ref.mview.snapshot()
        views = [v for v in graph.pipeline.executors if isinstance(v, PartitionedStateView)]
        ref_views = [v for v in ref.pipeline.executors
                     if isinstance(v, ref_frag.PartitionedStateView)]
        assert len(views) == len(ref_views) == 1
        counts = _instance_live(views[0])
        assert all(0 < c < len(want) for c in counts)
        # the same vnodes land on the same instance in both packages
        assert counts == _instance_live(ref_views[0])
        assert views[0].state_digest() == ref_views[0].state_digest()
    finally:
        graph.pipeline.close()
        ref.pipeline.close()
    assert not any(a.is_alive() for a in graph.pipeline.graph.actors)


@pytest.mark.parametrize("epoch_batch", [True, False])
def test_graph_join_matches_serial_and_reference(epoch_batch):
    serial = port_factory()().plan(graft.Q8_SQL)
    graph = graph_planned_mv(port_factory(), graft.Q8_SQL, parallelism=2,
                             epoch_batch=epoch_batch)
    ref = ref_frag.graph_planned_mv(ref_factory(), graft.Q8_SQL, parallelism=2,
                                    epoch_batch=epoch_batch)
    assert [type(e).__name__ for e in graph.pipeline.executors] == [
        type(e).__name__ for e in ref.pipeline.executors]
    try:
        for ev in events(6, n=2000, rate=10_000, seed=6):
            for mv, port in ((serial, True), (graph, True), (ref, False)):
                push(mv.pipeline, mv.inputs, ev, port=port, cap=2048)
                mv.pipeline.barrier()
            want = serial.mview.snapshot()
            assert graph.mview.snapshot() == want == ref.mview.snapshot()
        assert want
    finally:
        graph.pipeline.close()
        ref.pipeline.close()


def test_q7_falls_back_to_one_actor_as_reference():
    graph = graph_planned_mv(port_factory(1 << 14), graft.Q7_SQL, parallelism=4)
    ref = ref_frag.graph_planned_mv(ref_factory(1 << 14), graft.Q7_SQL, parallelism=4)
    serial = port_factory(1 << 14)().plan(graft.Q7_SQL)
    try:
        names = sorted(a.actor_name for a in graph.pipeline.graph.actors)
        assert names == sorted(a.actor_name for a in ref.pipeline.graph.actors)
        assert names == ["join#0", "left_src#0", "right_src#0"]
        for ev in events(6, n=1500, rate=1000, seed=8):
            for mv, port in ((serial, True), (graph, True), (ref, False)):
                push(mv.pipeline, mv.inputs, ev, port=port, cap=2048)
                mv.pipeline.barrier()
            assert graph.mview.snapshot() == serial.mview.snapshot() == ref.mview.snapshot()
        assert serial.mview.snapshot()
    finally:
        graph.pipeline.close()
        ref.pipeline.close()


def _commit(mgr, pipeline):
    mgr.commit_epoch(pipeline.epoch, pipeline.executors)


@pytest.mark.parametrize("restore_p", [2, 3])
def test_graph_checkpoint_restores_across_parallelism(restore_p):
    store = MemObjectStore()
    mgr = CheckpointManager(store)
    batches = _bids()
    graph = graph_planned_mv(port_factory(), graft.Q5_SQL, parallelism=2)
    try:
        for ev in batches[:3]:
            push(graph.pipeline, graph.inputs, ev, port=True, cap=2048)
            graph.pipeline.barrier()
            _commit(mgr, graph.pipeline)
        mid = graph.mview.snapshot()
        assert mid
    finally:
        graph.pipeline.close()

    graph2 = graph_planned_mv(port_factory(), graft.Q5_SQL, parallelism=restore_p)
    try:
        mgr2 = CheckpointManager(store)
        mgr2.recover(graph2.pipeline.executors)
        graph2.pipeline._epoch = mgr2.max_committed_epoch
        assert graph2.mview.snapshot() == mid
        view = next(v for v in graph2.pipeline.executors if isinstance(v, PartitionedStateView))
        assert sum(_instance_live(view)) == len(mid) and min(_instance_live(view)) > 0
        for ev in batches[3:]:
            push(graph2.pipeline, graph2.inputs, ev, port=True, cap=2048)
            graph2.pipeline.barrier()
            _commit(mgr2, graph2.pipeline)
        assert graph2.mview.snapshot() == _serial_q5(batches)
    finally:
        graph2.pipeline.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_graph_store_read_by_the_other_package(writer, tmp_path):
    """q5 at parallelism 2 committed by one package's graph, recovered at
    parallelism 3 by the other's, then continued: the partitioned views
    route restored rows alike, so both land on the serial MV."""
    batches = _bids(seed=4)
    port_w = writer == "port"
    store = (LocalFsObjectStore if port_w else RefFsStore)(str(tmp_path))
    mgr = (CheckpointManager if port_w else RefManager)(store)
    first = (graph_planned_mv(port_factory(), graft.Q5_SQL, parallelism=2) if port_w
             else ref_frag.graph_planned_mv(ref_factory(), graft.Q5_SQL, parallelism=2))
    try:
        for ev in batches[:3]:
            push(first.pipeline, first.inputs, ev, port=port_w, cap=2048)
            first.pipeline.barrier()
            mgr.commit_epoch(first.pipeline.epoch, first.pipeline.executors)
        mid = first.mview.snapshot()
    finally:
        first.pipeline.close()

    second = (ref_frag.graph_planned_mv(ref_factory(), graft.Q5_SQL, parallelism=3) if port_w
              else graph_planned_mv(port_factory(), graft.Q5_SQL, parallelism=3))
    try:
        store2 = (RefFsStore if port_w else LocalFsObjectStore)(str(tmp_path))
        mgr2 = (RefManager if port_w else CheckpointManager)(store2)
        mgr2.recover(second.pipeline.executors)
        second.pipeline._epoch = mgr2.max_committed_epoch
        assert second.mview.snapshot() == mid
        for ev in batches[3:]:
            push(second.pipeline, second.inputs, ev, port=not port_w, cap=2048)
            second.pipeline.barrier()
        assert second.mview.snapshot() == _serial_q5(batches)
    finally:
        second.pipeline.close()


def test_restore_routes_rows_as_the_dispatcher():
    """Every row a restore hands an instance hashes to that instance,
    with the reference's vnode: the check the MV alone cannot make (a
    group split across two instances still sums right in the MV)."""
    from risingwave_tpu.ops.hashing import vnode_of as ref_vnode_of
    import jax.numpy as jnp

    store = MemObjectStore()
    mgr = CheckpointManager(store)
    batches = _bids(n=3, seed=7)
    graph = graph_planned_mv(port_factory(), graft.Q5_SQL, parallelism=2)
    try:
        for ev in batches:
            push(graph.pipeline, graph.inputs, ev, port=True, cap=2048)
            graph.pipeline.barrier()
            _commit(mgr, graph.pipeline)
    finally:
        graph.pipeline.close()
    graph3 = graph_planned_mv(port_factory(), graft.Q5_SQL, parallelism=3)
    try:
        CheckpointManager(store).recover(graph3.pipeline.executors)
        view = next(v for v in graph3.pipeline.executors if isinstance(v, PartitionedStateView))
        for i, inst in enumerate(view._instances):
            live = inst.table.live.numpy()
            auction = inst.table.keys[0].numpy()[live]
            vn = np.asarray(ref_vnode_of([jnp.asarray(auction)]))
            assert len(auction) and ((vn % 3) == i).all()
    finally:
        graph3.pipeline.close()
