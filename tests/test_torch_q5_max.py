"""The MAX half of Nexmark q5 through the port: each window's top bid
count,

    SELECT starttime, MAX(num) AS maxn
    FROM (SELECT auction, window_start AS starttime, COUNT(*) AS num
          FROM HOP(bid, date_time, 2s, 10s) GROUP BY auction, window_start)
    GROUP BY starttime

planned from executors (``build_q5_max``: hop, HashAgg COUNT(*) by
(auction, window_start), HashAgg MAX(num) by window_start with
``materialized=True``, a device MV keyed on window_start), interpreted
and fused, with a watermark after every barrier, against the same chain
composed from ``risingwave_tpu``'s executors on JAX-CPU (the reference
has no ``build_*`` function for it) and against a numpy oracle. Plain PyTorch versions on
the CPU.

Every comparison is exact: the plan has no float lanes, and state
digests are uint64 folds.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu.executors import HashAggExecutor as RefAgg
from risingwave_tpu.executors import HopWindowExecutor as RefHop
from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor as RefMV
from risingwave_tpu.ops.agg import AggCall as RefCall
from risingwave_tpu.runtime import Pipeline as RefPipeline
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.epoch_batch import EpochBatchedAggExecutor
from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS, build_q5_max
from risingwave_tpu_torch.runtime.fused_step import FusedChainExecutor, fuse_pipeline

COLS = ("auction", "date_time")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sizes():
    return dict(capacity=1 << 12, max_capacity=1 << 6)


def _ref_build(capacity, max_capacity, minput_k=256):
    """q5-max from the reference's executors, as ``build_q5_max``."""
    i64 = jnp.int64
    count = RefAgg(group_keys=("auction", "window_start"),
                   calls=(RefCall("count_star", None, "num"),),
                   schema_dtypes={"auction": i64, "window_start": i64}, capacity=capacity,
                   table_id="q5max.count", window_key=("window_start", 0, False))
    mx = RefAgg(group_keys=("window_start",),
                calls=(RefCall("max", "num", "maxn", materialized=True),),
                schema_dtypes={"window_start": i64, "num": i64}, capacity=max_capacity,
                table_id="q5max.max", window_key=("window_start", 0, False),
                minput_k=minput_k)
    mview = RefMV(pk=("window_start",), columns=("maxn",),
                  schema_dtypes={"window_start": i64, "maxn": i64}, nullable=("maxn",),
                  table_id="q5max.mview", capacity=max(1 << 12, max_capacity))
    hop = RefHop("date_time", Q5_WINDOW_MS, Q5_SLIDE_MS)
    return RefPipeline([hop, count, mx, mview]), count, mx, mview


def _stream(epochs, events, seed=3, rate=10_000):
    """Per epoch the bids (auction, date_time) of ``events`` events."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    return [{k: gen.next_events(events)["bid"][k] for k in COLS} for _ in range(epochs)]


def _drive(pipeline, bids, port: bool, cap: int = 1024):
    """The epoch's bids in ``cap``-row chunks, the barrier, and the
    watermark at the epoch's largest event time."""
    mk = (lambda c: StreamChunk.from_numpy(c, cap, device="cpu")) if port else (
        lambda c: RefChunk.from_numpy(c, cap))
    for lo in range(0, len(bids["auction"]), cap):
        pipeline.push(mk({k: v[lo:lo + cap] for k, v in bids.items()}))
    pipeline.barrier()
    return int(bids["date_time"].max())


def _port_digests(count, mx, mview):
    host = lambda lanes_live: integrity.host_digest(*integrity.host_lanes(*lanes_live))
    return {"count": host(integrity.agg_lanes(count.table, count.state, ())),
            "max": host(integrity.agg_lanes(mx.table, mx.state, ())),
            "mv": host(integrity.mv_lanes(mview.table, mview.state))}


def _ref_digests(count, mx, mview):
    np_lanes = lambda lanes, live: ({k: np.asarray(v) for k, v in lanes.items()},
                                    np.asarray(live))
    host = lambda lanes_live: ref_integrity.host_digest(*np_lanes(*lanes_live))
    return {"count": host(ref_integrity.agg_lanes(count.table, count.state)),
            "max": host(ref_integrity.agg_lanes(mx.table, mx.state)),
            "mv": host(ref_integrity.mv_lanes(mview.table, mview.state))}


def _oracle(stream):
    """window_start -> the largest bid count of one auction in it."""
    counts = collections.Counter()
    for bids in stream:
        for a, ts in zip(bids["auction"].tolist(), bids["date_time"].tolist()):
            first = ((ts - Q5_WINDOW_MS) // Q5_SLIDE_MS + 1) * Q5_SLIDE_MS
            for k in range(Q5_WINDOW_MS // Q5_SLIDE_MS):
                if first + k * Q5_SLIDE_MS <= ts:
                    counts[(a, first + k * Q5_SLIDE_MS)] += 1
    best = {}
    for (_, ws), n in counts.items():
        best[(ws,)] = (max(best.get((ws,), (0,))[0], n),)
    return best


def _minput_lanes(mx):
    """Each multiset's lanes, as numpy (the reference's are uint-free:
    the MAX is over int64 counts)."""
    return {n: (np.asarray(v), np.asarray(c)) for n, (v, c) in mx.minput.items()}


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q5_max_matches_reference_at_every_barrier(fuse):
    """Both packages' q5-max over the same epochs, a watermark after
    every barrier: the MV snapshot and the count, max and MV digests
    equal after each barrier and each watermark, the MAX's multisets
    lane for lane; fused, the staged digests equal the reference's and
    the host fold of the port's lanes; the final MV equals the oracle."""
    ref = _ref_build(**_sizes())
    port = build_q5_max(**_sizes(), device="cpu")
    if fuse:
        (rw,) = ref_fuse(ref[0], label="q5max")
        (pw,) = fuse_pipeline(port.pipeline, label="q5max")
        assert isinstance(pw, FusedChainExecutor) and pw.agg is port.max_agg
        assert any(c.materialized for c in pw.plan.agg.calls) and pw.agg.minput
        assert isinstance(port.pipeline.executors[0], EpochBatchedAggExecutor)
    members = (port.count_agg, port.max_agg, port.mview)
    stream = _stream(4, 3000)
    for bids in stream:
        mx = _drive(ref[0], bids, port=False)
        assert _drive(port.pipeline, bids, port=True) == mx
        assert port.mview.snapshot() == ref[3].snapshot()
        assert _port_digests(*members) == _ref_digests(*ref[1:])
        if fuse:
            assert pw.last_digests == rw.last_digests
            d = _port_digests(*members)
            assert pw.last_digests == {"agg": d["max"], "mv": d["mv"]}
        ref[0].watermark("date_time", mx)
        port.pipeline.watermark("date_time", mx)
        assert _port_digests(*members) == _ref_digests(*ref[1:])
        got, want = _minput_lanes(port.max_agg), _minput_lanes(ref[2])
        assert all(np.array_equal(got[n][i], want[n][i]) for n in want for i in (0, 1))
        assert port.mview.snapshot() == ref[3].snapshot()
    assert not bool(port.max_agg.mi_bad)
    assert port.mview.snapshot() == _oracle(stream)
    assert port.max_agg.table.capacity == ref[2].table.capacity


def test_q5_max_fused_equals_interpreted():
    """The port's fused q5-max and its interpreted q5-max: equal MV
    snapshots at every barrier."""
    snaps = []
    for fuse in (False, True):
        q = build_q5_max(**_sizes(), device="cpu")
        if fuse:
            fuse_pipeline(q.pipeline, label="q5max")
        got = []
        for bids in _stream(3, 3000, seed=7):
            q.pipeline.watermark("date_time", _drive(q.pipeline, bids, port=True))
            got.append(q.mview.snapshot())
        snaps.append(got)
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q5_max_small_minput_k_latches_at_the_reference_barrier(fuse):
    """With ``minput_k=32`` a window's counts overflow its multiset: both
    packages raise ``mi_bad`` at the same barrier, with the reference's
    message."""
    ref = _ref_build(**_sizes(), minput_k=32)
    port = build_q5_max(**_sizes(), minput_k=32, device="cpu")
    if fuse:
        ref_fuse(ref[0], label="q5max")
        fuse_pipeline(port.pipeline, label="q5max")
    raised = {}
    for name, pipeline, is_port in (("ref", ref[0], False), ("port", port.pipeline, True)):
        for e, bids in enumerate(_stream(4, 3000)):
            try:
                mx = _drive(pipeline, bids, port=is_port)
            except RuntimeError as err:
                raised[name] = (e, str(err))
                break
            pipeline.watermark("date_time", mx)
    assert "port" in raised and raised["port"] == raised["ref"]
    assert "minput_k" in raised["port"][1]
