"""The fused per-barrier program (``runtime/fused_step.py``) of the port
against the reference's fused program and against the port's own
interpreted walk, plus the wrapper's contracts (mirrors
``test_fused_step.py``'s q5 tests).

The port runs its plain PyTorch versions on the CPU. Every comparison is
exact: q5 is integer-only, and state digests are uint64 folds.
"""

import jax
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
from risingwave_tpu.connectors.nexmark import NexmarkGenerator as RefGenerator
from risingwave_tpu.queries.nexmark_q import build_q5_lite as ref_build
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse_pipeline
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.executors.epoch_batch import EpochBatchedAggExecutor
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite
from risingwave_tpu_torch.runtime.fused_step import (
    FusedChainExecutor,
    expand_fused,
    fuse_chain,
    fuse_pipeline,
)
from risingwave_tpu_torch.runtime.pipeline import Pipeline


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _epochs(rate, epochs, chunks, n, cap, seed=1):
    """Bid batches as numpy columns, made once and fed to every side."""
    gen = RefGenerator(RefConfig(first_event_rate=rate), seed=seed)
    out = []
    for _ in range(epochs):
        ep = []
        while len(ep) < chunks:
            b = gen.next_events(n)["bid"]
            if len(b["auction"]):
                ep.append({"auction": b["auction"], "date_time": b["date_time"]})
        out.append((ep, cap))
    return out


def _host_digests(q5):
    agg = integrity.agg_lanes(q5.agg.table, q5.agg.state, q5.agg._float_extremes)
    mv = integrity.mv_lanes(q5.mview.table, q5.mview.state)
    return {
        "agg": integrity.host_digest(*integrity.host_lanes(*agg)),
        "mv": integrity.host_digest(*integrity.host_lanes(*mv)),
    }


@pytest.mark.parametrize("capacity", [1 << 12, 1 << 8], ids=["sized", "grows"])
def test_fused_q5_matches_reference_fused_at_every_barrier(capacity):
    ref_q5 = ref_build(capacity=capacity, state_cleaning=False)
    (ref_w,) = ref_fuse_pipeline(ref_q5.pipeline, label="q5")
    q5 = build_q5_lite(capacity=capacity, state_cleaning=False, device="cpu")
    (w,) = fuse_pipeline(q5.pipeline, label="q5")
    assert w.covers_whole_chain
    for ep, cap in _epochs(50_000, 3, 3, 700, 1024):
        for cols in ep:
            ref_q5.pipeline.push(RefChunk.from_numpy(cols, cap))
            q5.pipeline.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
        ref_q5.pipeline.barrier()
        q5.pipeline.barrier()
        assert q5.mview.snapshot() == ref_q5.mview.snapshot()
        assert w.last_digests == ref_w.last_digests
        assert w.last_digests == _host_digests(q5)
    assert q5.agg.table.capacity == ref_q5.agg.table.capacity
    assert q5.mview.table.capacity == ref_q5.mview.table.capacity
    if capacity == 1 << 8:
        assert q5.agg.table.capacity > capacity


def test_fused_q5_telemetry_and_occupancy_match_reference():
    """The counters kernels A, C and D keep in place of passes of their
    own (the tables' claimed counters, dirty_groups, mv_rows) equal the
    reference's reductions at every barrier, across a growth rebuild."""
    ref_q5 = ref_build(capacity=1 << 8, state_cleaning=False)
    (ref_w,) = ref_fuse_pipeline(ref_q5.pipeline, label="q5")
    q5 = build_q5_lite(capacity=1 << 8, state_cleaning=False, device="cpu")
    (w,) = fuse_pipeline(q5.pipeline, label="q5")
    for ep, cap in _epochs(50_000, 3, 3, 700, 1024, seed=5):
        for cols in ep:
            ref_q5.pipeline.push(RefChunk.from_numpy(cols, cap))
            q5.pipeline.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
        ref_q5.pipeline.barrier()
        q5.pipeline.barrier()
        tel = ref_w._telemetry
        assert w.last_telemetry == {k: tel[k] for k in ("rows_in", "dirty_groups", "mv_rows")}
        assert tel["dirty_groups"] > 0
        for table, key in ((q5.agg.table, "agg"), (q5.mview.table, "mv")):
            occ = int(table.occupancy())
            assert occ == int((table.fp1 != 0).sum()) == tel["occupancy"][key]
    assert q5.agg.table.capacity > 1 << 8 and q5.mview.table.capacity > 1 << 8


def test_fused_q5_equals_interpreted_q5():
    interp = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    fused = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    (w,) = fuse_pipeline(fused.pipeline)
    for ep, cap in _epochs(20_000, 3, 3, 800, 1024, seed=4):
        for cols in ep:
            interp.pipeline.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
            fused.pipeline.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
        interp.pipeline.barrier()
        fused.pipeline.barrier()
        assert fused.mview.snapshot() == interp.mview.snapshot()
        assert _host_digests(fused) == _host_digests(interp) == w.last_digests
    assert w.last_telemetry["rows_in"] > 0 and w.last_telemetry["mv_rows"] > 0


def _bid_chunk(gen, n=400, cap=512):
    c = None
    while c is None:
        c = gen.next_chunks(n, cap, device="cpu")["bid"]
    return c.select(["auction", "date_time"])


def test_fused_flush_rounds_cover_small_out_cap():
    """The round count comes from the dirty bound after the epoch landed
    in it: an out_cap far below the epoch's groups still drains them."""
    mk = lambda: build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")

    def drive(q5, fuse):
        q5.agg.out_cap = 128
        if fuse:  # fuse after sizing: the plan captures out_cap
            fuse_pipeline(q5.pipeline)
        gen = NexmarkGenerator(NexmarkConfig(first_event_rate=20_000))
        for _ in range(2):
            q5.pipeline.push(_bid_chunk(gen, 800, 1024))
            q5.pipeline.barrier()
        return q5.mview.snapshot()

    interp = drive(mk(), fuse=False)
    fused = drive(mk(), fuse=True)
    assert len(interp) > 128
    assert fused == interp


def test_signature_change_mid_epoch_flushes_buffer():
    mk = lambda: build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    a, b = mk(), mk()
    fuse_pipeline(b.pipeline)
    for q5 in (a, b):
        gen = NexmarkGenerator(NexmarkConfig(first_event_rate=20_000))
        q5.pipeline.push(_bid_chunk(gen, 400, 512))
        q5.pipeline.push(_bid_chunk(gen, 900, 1024))  # another capacity: a new signature
        q5.pipeline.push(_bid_chunk(gen, 400, 512))
        q5.pipeline.barrier()
    assert a.mview.snapshot() == b.mview.snapshot()


def test_overflow_latch_still_raises_at_finish_barrier():
    q5 = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    (wrapper,) = fuse_pipeline(q5.pipeline)
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=20_000))
    q5.pipeline.push(_bid_chunk(gen))
    q5.pipeline.barrier()
    q5.agg.dropped = torch.ones((), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="overflowed MAX_PROBE"):
        q5.pipeline.push(_bid_chunk(gen))
        q5.pipeline.barrier()
    assert wrapper.agg is q5.agg  # members stayed the system of record


def test_fuse_chain_falls_back_around_unfusible_ops():
    class HostOp(Executor):  # no pure_step -> not fusible
        pass

    agg = HashAggExecutor(
        group_keys=("k",), calls=(AggCall("count_star", None, "n"),),
        schema_dtypes={"k": torch.int64}, capacity=64, out_cap=32, device="cpu",
    )
    host = HostOp()
    out = fuse_chain([host, agg], label="t")
    assert out[0] is host
    assert isinstance(out[1], EpochBatchedAggExecutor)
    assert out[1].agg is agg
    hop = HopWindowExecutor("t", 10, 10)
    assert fuse_chain([hop, host], label="t") == [hop, host]


def test_agg_without_mv_epoch_batches_and_matches_interpreted():
    """[hop, agg] with no MV after it: fuse_chain epoch-batches it, and
    its (interpreted, exact-sliced) flush equals the per-chunk walk."""

    def build():
        hop = HopWindowExecutor("date_time", 10_000, 2_000)
        agg = HashAggExecutor(
            group_keys=("auction", "window_start"), calls=(AggCall("count_star", None, "num"),),
            schema_dtypes={"auction": torch.int64, "window_start": torch.int64},
            capacity=1 << 12, device="cpu",
        )
        return Pipeline([hop, agg])

    interp, batched = build(), build()
    batched.executors = fuse_chain(batched.executors)
    assert len(batched.executors) == 1
    assert isinstance(batched.executors[0], EpochBatchedAggExecutor)
    for ep, cap in _epochs(20_000, 2, 3, 600, 1024, seed=7):
        for cols in ep:
            interp.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
            batched.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
        a, b = interp.barrier(), batched.barrier()
        rows = lambda outs: sorted(
            tuple(r) for c in outs for r in zip(*(v.tolist() for v in c.to_numpy().values()))
        )
        assert rows(a) == rows(b) and rows(a)


def test_fuse_epoch_batch_wraps_each_pure_prefix_and_agg():
    """The epoch-batching policy alone (the reference's fallback when
    fusion is off): [hop, agg] becomes one batched wrapper, the MV
    stays, and q5 gives the interpreted MV."""
    from risingwave_tpu_torch.executors.epoch_batch import fuse_epoch_batch

    interp = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    batched = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    batched.pipeline.executors = fuse_epoch_batch(batched.pipeline.executors)
    kinds = [type(e).__name__ for e in batched.pipeline.executors]
    assert kinds == ["EpochBatchedAggExecutor", "DeviceMaterializeExecutor"]
    assert batched.pipeline.executors[0].agg is batched.agg
    for ep, cap in _epochs(20_000, 2, 3, 800, 1024, seed=5):
        for cols in ep:
            interp.pipeline.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
            batched.pipeline.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
        interp.pipeline.barrier()
        batched.pipeline.barrier()
        assert batched.mview.snapshot() == interp.mview.snapshot()


def test_mv_only_run_fuses_when_built_directly():
    """The agg-less branch of the program: the epoch flattened into the
    device MV as one batch equals the chunks applied in order."""
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor

    def mv():
        return DeviceMaterializeExecutor(
            pk=("k",), columns=("v",), schema_dtypes={"k": torch.int64, "v": torch.int64},
            capacity=1 << 8, device="cpu",
        )

    a, b = mv(), mv()
    w = FusedChainExecutor([b])
    rng = np.random.default_rng(2)
    for _ in range(2):
        for _ in range(3):
            n = 50
            cols = {"k": rng.integers(0, 30, n).astype(np.int64), "v": rng.integers(0, 9, n).astype(np.int64)}
            ops = rng.choice([0, 1, 3], n).astype(np.int32)
            a.apply(StreamChunk.from_numpy(cols, 64, ops=ops, device="cpu"))
            w.apply(StreamChunk.from_numpy(cols, 64, ops=ops, device="cpu"))
        a.on_barrier(None)
        w.on_barrier(None)
        assert a.snapshot() == b.snapshot()
        lanes = integrity.mv_lanes(a.table, a.state)
        assert w.last_digests["mv"] == integrity.host_digest(*integrity.host_lanes(*lanes))


def test_expand_fused_exposes_members():
    q5 = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    fuse_pipeline(q5.pipeline)
    assert isinstance(q5.pipeline.executors[0], FusedChainExecutor)
    names = [type(e).__name__ for e in expand_fused(q5.pipeline.executors)]
    assert names == ["HopWindowExecutor", "HashAggExecutor", "DeviceMaterializeExecutor"]


def test_window_watermark_raises_under_fusion_until_state_cleaning_is_ported():
    """The watermarks=True case of test_fused_step.py's q5 twin: under
    fusion a ``date_time`` watermark first applies the buffered chunks,
    then walks the members interpreted (the agg flushes and frees its
    closed windows). With a watermark before and after every barrier,
    the fused MV and the staged digests equal the reference's fused
    run, and the host fold of the port's lanes after each watermark
    equals the reference's."""
    ref_q5 = ref_build(capacity=1 << 11)
    (ref_w,) = ref_fuse_pipeline(ref_q5.pipeline, label="q5")
    q5 = build_q5_lite(capacity=1 << 11, device="cpu")
    (w,) = fuse_pipeline(q5.pipeline, label="q5")
    mx = 0
    for ep, cap in _epochs(300, 4, 2, 600, 1024, seed=6):
        for cols in ep:
            ref_q5.pipeline.push(RefChunk.from_numpy(cols, cap))
            q5.pipeline.push(StreamChunk.from_numpy(cols, cap, device="cpu"))
            mx = max(mx, int(cols["date_time"].max()))
        for step in ("watermark", "barrier", "watermark"):
            getattr(ref_q5.pipeline, step)(*(("date_time", mx) if step == "watermark" else ()))
            getattr(q5.pipeline, step)(*(("date_time", mx) if step == "watermark" else ()))
            assert q5.mview.snapshot() == ref_q5.mview.snapshot()
            assert _host_digests(q5) == _ref_host_digests(ref_q5)
        assert w.last_digests == ref_w.last_digests
    assert int(q5.agg.table.live.sum()) < int(q5.agg.table.occupancy())


def _ref_host_digests(ref_q5):
    from risingwave_tpu import integrity as ref_integrity

    out = {}
    for key, (lanes, live) in (
        ("agg", ref_integrity.agg_lanes(ref_q5.agg.table, ref_q5.agg.state)),
        ("mv", ref_integrity.mv_lanes(ref_q5.mview.table, ref_q5.mview.state)),
    ):
        out[key] = ref_integrity.host_digest(
            {k: np.asarray(v) for k, v in lanes.items()}, np.asarray(live)
        )
    return out


def test_reference_state_digest_equals_port_after_import():
    """The digest lanes of a reference q5 state, imported slot for slot,
    fold to the reference's digests."""
    from risingwave_tpu import integrity as ref_integrity

    ref_q5 = ref_build(capacity=1 << 12, state_cleaning=False)
    for ep, cap in _epochs(50_000, 2, 2, 600, 1024, seed=3):
        for cols in ep:
            ref_q5.pipeline.push(RefChunk.from_numpy(cols, cap))
        ref_q5.pipeline.barrier()
    q5 = build_q5_lite(capacity=1 << 12, state_cleaning=False, device="cpu")
    q5.agg.load_reference_state(jax.device_get(
        {"table": ref_q5.agg.table, "state": ref_q5.agg.state, "dropped": ref_q5.agg.dropped}
    ))
    q5.mview.load_reference_state(jax.device_get(
        {"table": ref_q5.mview.table, "state": ref_q5.mview.state}
    ))
    want = {}
    for key, (lanes, live) in (
        ("agg", ref_integrity.agg_lanes(ref_q5.agg.table, ref_q5.agg.state)),
        ("mv", ref_integrity.mv_lanes(ref_q5.mview.table, ref_q5.mview.state)),
    ):
        want[key] = ref_integrity.host_digest(
            {k: np.asarray(v) for k, v in lanes.items()}, np.asarray(live)
        )
    assert _host_digests(q5) == want
