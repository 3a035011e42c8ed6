"""The actor graph of the port (``risingwave_tpu_torch/runtime/graph.py``)
against the reference's ``GraphRuntime`` on the CPU, and kernel AH's
plain versions (``ops/hashing.vnode_of``, ``vnode_slice_masks``) against
the reference's ``vnode_of`` and ``_vnode_slice_mask`` bit for bit.

The eight cases mirror ``tests/test_graph_runtime.py``; each runs the
same seeded chunks through both packages' graphs. Every graph gets a
barrier timeout of a few seconds and is stopped in a ``finally``, so a
hung actor fails its test instead of holding the suite.
"""

import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu.executors.base import Executor as RefExecutor
from risingwave_tpu.ops import hashing as ref_hashing
from risingwave_tpu.queries import nexmark_q as ref_q
from risingwave_tpu.runtime import graph as ref_graph
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.ops import hashing
from risingwave_tpu_torch.queries import nexmark_q as port_q
from risingwave_tpu_torch.runtime import fused_step
from risingwave_tpu_torch.runtime.graph import FragmentSpec, GraphRuntime, PermitChannel

TIMEOUT = 20.0  # seconds a barrier may take before the test fails


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _barrier_timeout(monkeypatch):
    monkeypatch.setenv("RW_BARRIER_TIMEOUT_S", str(TIMEOUT))


def _bid_events(n_chunks=6, events=2_000, rate=50_000, seed=3):
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    out = []
    while len(out) < n_chunks:
        bid = gen.next_events(events)["bid"]
        if len(bid["auction"]):
            out.append(bid)
    return out


def _chunks(batches, cap, port: bool):
    if port:
        return [StreamChunk.from_numpy(b, cap, device="cpu") for b in batches]
    return [RefChunk.from_numpy(b, cap) for b in batches]


def _run(g, fn):
    g.start()
    try:
        fn(g)
    finally:
        g.stop(timeout=TIMEOUT)


# -- kernel AH's plain versions, bit for bit ----------------------------------
def _key_columns(n=1024, seed=11):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal(n).astype(np.float32)
    f64 = rng.standard_normal(n)
    specials = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    f32[: len(specials)] = specials
    f64[: len(specials)] = specials
    f32[6] = np.array(0x7FC00123, np.uint32).view(np.float32)
    f64[6] = np.array(0x7FF0000000000ABC, np.uint64).view(np.float64)
    return {
        "int32": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "int64": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        "bool": rng.random(n) < 0.5,
        "float32": f32,
        "float64": f64,
    }


KEYS = [("int64",), ("int32",), ("bool",), ("float32",), ("float64",), ("int64", "int64"),
        ("int64", "float64", "bool"), ("int32", "float32")]


@pytest.mark.parametrize("key", KEYS, ids=["-".join(k) for k in KEYS])
def test_vnode_of_bit_exact(key):
    cols = _key_columns()
    lanes = [cols[k] if i == 0 else np.roll(cols[k], i) for i, k in enumerate(key)]
    want = np.asarray(ref_hashing.vnode_of([jnp.asarray(c) for c in lanes]))
    got = hashing.vnode_of([torch.from_numpy(c) for c in lanes])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # -0.0 and every NaN take +0.0's and the one NaN's vnode
    if key == ("float64",):
        assert want[0] == want[1] and want[2] == want[3] == want[6]


@pytest.mark.parametrize("n_down", [2, 3, 4])
@pytest.mark.parametrize("key", KEYS, ids=["-".join(k) for k in KEYS])
def test_dispatch_masks_bit_exact(key, n_down):
    cols = _key_columns(seed=n_down)
    lanes = [cols[k] if i == 0 else np.roll(cols[k], i) for i, k in enumerate(key)]
    valid = np.random.default_rng(n_down).random(len(lanes[0])) < 0.8
    masks = hashing.vnode_slice_masks([torch.from_numpy(c) for c in lanes],
                                      torch.from_numpy(valid), n_down)
    assert masks.shape == (n_down, len(valid)) and masks.dtype == torch.bool
    for d in range(n_down):
        want = np.asarray(ref_graph._vnode_slice_mask(
            tuple(jnp.asarray(c) for c in lanes), jnp.asarray(valid), n_down, d))
        np.testing.assert_array_equal(masks[d].numpy(), want)
    # every valid row goes to exactly one downstream, an invalid one to none
    np.testing.assert_array_equal(masks.sum(0).numpy(), valid.astype(np.int64))


# -- the graph cases of tests/test_graph_runtime.py, both packages -----------
def test_parallel_hash_agg_matches_single_pipeline_and_reference():
    """source -> hash(auction) -> 2x [q5 chain] == 1x chain, and each
    port instance owns exactly the keys the reference's instance owns."""
    batches = _bid_events()
    oracle = port_q.build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
    for c in _chunks(batches, 1 << 11, port=True):
        oracle.pipeline.push(c)
    oracle.pipeline.barrier()
    want = oracle.mview.snapshot()
    assert want

    owned = {}
    for port in (False, True):
        built = {}

        def build_agg(inst, port=port, built=built):
            q5 = (port_q.build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
                  if port else ref_q.build_q5_lite(capacity=1 << 12, state_cleaning=False))
            built[inst] = q5
            return list(q5.pipeline.executors)

        mod = (GraphRuntime, FragmentSpec) if port else (ref_graph.GraphRuntime,
                                                          ref_graph.FragmentSpec)
        g = mod[0]([
            mod[1]("src", lambda i: [], dispatch=("hash", ["auction"])),
            mod[1]("agg", build_agg, inputs=[("src", 0)], parallelism=2),
        ])

        def drive(g, port=port):
            for c in _chunks(batches, 1 << 11, port):
                g.inject_chunk("src", c)
            g.inject_barrier(timeout=TIMEOUT)

        _run(g, drive)
        owned[port] = [built[i].mview.snapshot() for i in range(2)]

    got = {}
    for snap in owned[True]:
        assert not set(snap) & set(got)  # disjoint vnode ownership
        got.update(snap)
    assert got == want
    assert all(len(s) < len(want) for s in owned[True])
    assert owned[True] == owned[False]


def test_two_source_join_graph_matches_two_input_pipeline():
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=25_000), seed=4)
    ev = gen.next_events(20_000)
    p = {k: ev["person"][k] for k in ("id", "name", "date_time")}
    a = {k: ev["auction"][k] for k in ("seller", "date_time")}
    oracle = port_q.build_q8(capacity=1 << 12, fanout=8, out_cap=1 << 12, device="cpu")
    oracle.pipeline.push_left(StreamChunk.from_numpy(p, 1 << 15, device="cpu"))
    oracle.pipeline.push_right(StreamChunk.from_numpy(a, 1 << 15, device="cpu"))
    oracle.pipeline.barrier()
    want = oracle.mview.snapshot()
    assert want
    snaps = {}
    for port in (False, True):
        q8 = (port_q.build_q8(capacity=1 << 12, fanout=8, out_cap=1 << 12, device="cpu")
              if port else ref_q.build_q8(capacity=1 << 12, fanout=8, out_cap=1 << 12))
        tip = q8.pipeline
        mod = (GraphRuntime, FragmentSpec) if port else (ref_graph.GraphRuntime,
                                                          ref_graph.FragmentSpec)
        g = mod[0]([
            mod[1]("p", lambda i: []),
            mod[1]("a", lambda i: []),
            mod[1]("join", lambda i, tip=tip: {"left": tip.left, "right": tip.right,
                                               "join": tip.join, "tail": tip.tail},
                   inputs=[("p", 0), ("a", 1)]),
        ])
        mk = ((lambda c: StreamChunk.from_numpy(c, 1 << 15, device="cpu")) if port
              else (lambda c: RefChunk.from_numpy(c, 1 << 15)))

        def drive(g, mk=mk):
            g.inject_chunk("p", mk(p))
            g.inject_chunk("a", mk(a))
            g.inject_barrier(timeout=TIMEOUT)

        _run(g, drive)
        snaps[port] = q8.mview.snapshot()
    assert snaps[True] == want == snaps[False]


@pytest.mark.parametrize("kind,copies", [("broadcast", 2), ("round_robin", 1)])
def test_broadcast_and_round_robin_dispatch(kind, copies):
    batches = _bid_events(n_chunks=4)
    for port in (False, True):
        mod = (GraphRuntime, FragmentSpec) if port else (ref_graph.GraphRuntime,
                                                          ref_graph.FragmentSpec)
        g = mod[0]([
            mod[1]("src", lambda i: [], dispatch=kind),
            mod[1]("down", lambda i: [], inputs=[("src", 0)], parallelism=2),
        ])

        def drive(g, port=port):
            for c in _chunks(batches, 1 << 11, port):
                g.inject_chunk("src", c)
            g.inject_barrier(timeout=TIMEOUT)

        _run(g, drive)
        assert len(g.drain("down")) == copies * len(batches)


def test_union_merge_preserves_rows_and_aligns_barriers():
    batches = _bid_events(n_chunks=4)
    for port in (False, True):
        base = Executor if port else RefExecutor

        class CountBarriers(base):
            def __init__(self):
                self.barriers = 0
                self.rows = 0

            def apply(self, chunk):
                self.rows += int(np.asarray(chunk.valid).sum())
                return [chunk]

            def on_barrier(self, b):
                self.barriers += 1
                return []

        rec = CountBarriers()
        mod = (GraphRuntime, FragmentSpec) if port else (ref_graph.GraphRuntime,
                                                          ref_graph.FragmentSpec)
        g = mod[0]([
            mod[1]("s1", lambda i: []),
            mod[1]("s2", lambda i: []),
            mod[1]("u", lambda i, rec=rec: [rec], inputs=[("s1", 0), ("s2", 0)]),
        ])
        chunks = _chunks(batches, 1 << 11, port)

        def drive(g, chunks=chunks):
            g.inject_chunk("s1", chunks[0])
            g.inject_chunk("s2", chunks[1])
            g.inject_barrier(timeout=TIMEOUT)
            g.inject_chunk("s2", chunks[2])
            g.inject_chunk("s1", chunks[3])
            g.inject_barrier(timeout=TIMEOUT)

        _run(g, drive)
        assert rec.rows == sum(len(b["auction"]) for b in batches)
        assert rec.barriers == 2


def _record_wm(port: bool):
    base = Executor if port else RefExecutor

    class RecordWM(base):
        def __init__(self):
            self.seen = []

        def on_watermark(self, wm):
            self.seen.append((wm.column, wm.value))
            return wm, []

    return RecordWM()


def _merge_graph(port: bool, rec):
    mod = (GraphRuntime, FragmentSpec) if port else (ref_graph.GraphRuntime,
                                                      ref_graph.FragmentSpec)
    return mod[0]([
        mod[1]("s1", lambda i: []),
        mod[1]("s2", lambda i: []),
        mod[1]("m", lambda i: [rec], inputs=[("s1", 0), ("s2", 0)]),
    ])


def test_watermark_min_alignment_across_sources():
    seen = {}
    for port in (False, True):
        rec = _record_wm(port)
        g = _merge_graph(port, rec)
        steps = []

        def drive(g, rec=rec, steps=steps):
            g.inject_watermark("ts", 100, source="s1")
            g.inject_barrier(timeout=TIMEOUT)
            steps.append(list(rec.seen))
            g.inject_watermark("ts", 50, source="s2")
            g.inject_barrier(timeout=TIMEOUT)
            steps.append(list(rec.seen))
            g.inject_watermark("ts", 120, source="s2")
            g.inject_barrier(timeout=TIMEOUT)
            steps.append(list(rec.seen))

        _run(g, drive)
        seen[port] = steps
    assert seen[True] == [[], [("ts", 50)], [("ts", 50), ("ts", 100)]] == seen[False]


def _wait_for(pred, secs=5.0):
    deadline = time.time() + secs
    while time.time() < deadline and not pred():
        time.sleep(0.01)


def test_watermark_aligns_after_source_stop():
    for port in (False, True):
        rec = _record_wm(port)
        g = _merge_graph(port, rec)

        def drive(g, rec=rec):
            g.inject_watermark("ts", 100, source="s1")
            g.inject_barrier(timeout=TIMEOUT)
            assert rec.seen == []
            for ch in g._source_channels["s2"]:
                ch.send_control("stop")
            _wait_for(lambda: rec.seen == [("ts", 100)])
            assert rec.seen == [("ts", 100)]
            g.inject_watermark("ts", 200, source="s1")
            _wait_for(lambda: len(rec.seen) >= 2)
            assert rec.seen == [("ts", 100), ("ts", 200)]

        _run(g, drive)


def test_permit_channel_backpressure():
    ch = PermitChannel(record_permits=8)
    c = StreamChunk.from_numpy({"x": np.arange(8)}, 8, device="cpu")
    ch.send_chunk(c)
    done = threading.Event()

    def sender():
        ch.send_chunk(c)
        done.set()

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()
    kind, got = ch.recv()
    assert kind == "chunk" and got is c
    assert done.wait(timeout=5.0)
    ch.send_control("barrier", None)
    assert len(ch) == 2


def test_actor_failure_surfaces_on_inject_barrier():
    class Boom(Executor):
        def on_barrier(self, b):
            raise ValueError("kaboom")

    g = GraphRuntime([
        FragmentSpec("src", lambda i: []),
        FragmentSpec("f", lambda i: [Boom()], inputs=[("src", 0)]),
    ]).start()
    try:
        with pytest.raises(RuntimeError) as err:
            g.inject_barrier(timeout=TIMEOUT)
        assert isinstance(err.value.__cause__, ValueError)
        assert g.failed_fragments == {"f"}
        assert g.stall_snapshot()["actor_errors"]
    finally:
        g.stop(timeout=TIMEOUT)


def test_stuck_actor_times_out_naming_it():
    gate = threading.Event()

    class Stall(Executor):
        def on_barrier(self, b):
            gate.wait(10.0)
            return []

    g = GraphRuntime([
        FragmentSpec("src", lambda i: []),
        FragmentSpec("slow", lambda i: [Stall()], inputs=[("src", 0)]),
    ]).start()
    try:
        with pytest.raises(TimeoutError, match="slow#0"):
            g.inject_barrier(timeout=0.5)
    finally:
        gate.set()
        g.stop(timeout=TIMEOUT)


def test_hash_dispatcher_sends_each_downstream_its_mask():
    """The dispatcher hands downstream d the full chunk with ``valid`` the
    reference's ``_vnode_slice_mask(.., d)`` (no compaction)."""
    batches = _bid_events(n_chunks=2)
    got = {}
    for port in (False, True):
        mod = (GraphRuntime, FragmentSpec) if port else (ref_graph.GraphRuntime,
                                                          ref_graph.FragmentSpec)
        g = mod[0]([
            mod[1]("src", lambda i: [], dispatch=("hash", ["auction", "bidder"])),
            mod[1]("down", lambda i: [], inputs=[("src", 0)], parallelism=3),
        ])
        out = []

        def drive(g, port=port, out=out):
            for c in _chunks(batches, 1 << 11, port):
                g.inject_chunk("src", c)
            g.inject_barrier(timeout=TIMEOUT)
            out.extend(g.drain("down"))

        _run(g, drive)
        got[port] = sorted(tuple(np.asarray(c.valid).nonzero()[0][:8].tolist()) + (
            int(np.asarray(c.valid).sum()),) for c in out)
        assert all(c.capacity == 1 << 11 for c in out)
    assert got[True] == got[False]


# -- the fused program's read guard under actor threads -----------------------
class _FakeSyncMode:
    """torch.cuda's process-wide sync debug mode, on a machine without a
    card: the guard's bookkeeping runs as on the card."""

    def __init__(self):
        self.mode = 0
        self.sets = []

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.sets.append(self.mode)


def _device_read():
    """What a synchronizing call does under mode "warn"."""
    warnings.warn(fused_step._SYNC_MESSAGE)


def test_read_guard_single_thread_stays_strict(monkeypatch):
    fake = _FakeSyncMode()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    with fused_step.no_device_reads(torch.device("cuda")):
        assert fake.mode == 2  # "error", as before actors existed
    assert fake.mode == 0 and fake.sets == [2, 0]


def test_read_guard_two_actor_threads(monkeypatch):
    """Two actors' barriers at once: a read inside a guarded block raises,
    another thread's read between its own blocks does not, and the mode
    comes back only when the last guarded thread leaves."""
    fake = _FakeSyncMode()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    monkeypatch.setattr(warnings, "showwarning", warnings.showwarning)
    monkeypatch.setattr(warnings, "filters", list(warnings.filters))
    monkeypatch.setitem(fused_step._GUARD, "hooked", False)
    dev = torch.device("cuda")
    a_in, b_read, a_out = threading.Event(), threading.Event(), threading.Event()
    errors = {}

    def actor_a():
        with fused_step.shared_device_thread():
            with fused_step.no_device_reads(dev):
                a_in.set()
                b_read.wait(5)
                try:
                    _device_read()
                except fused_step.DeviceReadInFusedProgram as e:
                    errors["a"] = e
            a_out.set()

    def actor_b():
        with fused_step.shared_device_thread():
            a_in.wait(5)
            _device_read()  # a barrier read outside B's program: fine
            with fused_step.no_device_reads(dev):
                b_read.set()
                a_out.wait(5)
                assert fake.mode == 1  # A left, B is still inside
                try:
                    _device_read()
                except fused_step.DeviceReadInFusedProgram as e:
                    errors["b"] = e

    ts = [threading.Thread(target=actor_a), threading.Thread(target=actor_b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert set(errors) == {"a", "b"}
    assert fake.mode == 0 and fake.sets == [1, 0]
    assert fused_step._GUARD["depth"] == 0 and fused_step._GUARD["shared"] == 0


def test_two_fused_actors_barrier_together():
    """q5's fused chain in two parallel actors, barriers collected
    together, against one serial fused chain."""
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    batches = _bid_events(n_chunks=6, seed=9)
    serial = port_q.build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
    serial.pipeline.executors = fuse_pipeline(serial.pipeline)
    built = {}

    def build(inst):
        q5 = port_q.build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
        built[inst] = q5
        return list(q5.pipeline.executors)

    g = GraphRuntime([
        FragmentSpec("src", lambda i: [], dispatch=("hash", ["auction"])),
        FragmentSpec("agg", build, inputs=[("src", 0)], parallelism=2),
    ])
    aggs = [a for a in g.actors if a.actor_name.startswith("agg#")]
    assert [type(a.chain[0]).__name__ for a in aggs] == ["FusedChainExecutor"] * 2

    def drive(g):
        for k in range(0, len(batches), 2):
            for c in _chunks(batches[k:k + 2], 1 << 11, port=True):
                g.inject_chunk("src", c)
                serial.pipeline.push(c)
            g.inject_barrier(timeout=TIMEOUT)
            serial.pipeline.barrier()
            got = {}
            for q in built.values():
                got.update(q.mview.snapshot())
            assert got == serial.mview.snapshot()

    _run(g, drive)
