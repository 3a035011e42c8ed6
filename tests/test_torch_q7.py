"""The slice end to end: Nexmark q7 through the port (hop -> dynamic max
filter left, hop -> HashAgg MAX right, inner HashJoin, device MV;
plain PyTorch versions on the CPU), interpreted and fused, with a
watermark after every barrier, against ``risingwave_tpu`` on JAX-CPU,
against the pandas oracle of ``tests/test_q7_pipeline.py``, and against
itself (mirrors of ``tests/test_q7_pipeline.py`` and
``tests/test_fused_step.py``'s q7 case).

Every comparison is exact: q7 has no float lanes, and state digests are
uint64 folds.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu.queries.nexmark_q import build_q7 as ref_build
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.queries.nexmark_q import Q7_WINDOW_MS, build_q7
from risingwave_tpu_torch.runtime.fused_step import FusedTwoInputExecutor, fuse_pipeline
from test_q7_pipeline import _oracle

COLS = ("auction", "bidder", "price", "date_time")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stream(epochs, per_epoch, events, rate=10_000, seed=3):
    """Per epoch, ``per_epoch`` bid batches as numpy columns."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    out = []
    for _ in range(epochs):
        ep = []
        while len(ep) < per_epoch:
            b = gen.next_events(events)["bid"]
            if len(b["auction"]):
                ep.append({k: b[k] for k in COLS})
        out.append(ep)
    return out


def _drive(pipeline, ep, port: bool, cap: int = 2048):
    """Push an epoch's bids to both sides, barrier, then the watermark at
    the epoch's largest event time."""
    mk = (lambda c: StreamChunk.from_numpy(c, cap, device="cpu")) if port else (
        lambda c: RefChunk.from_numpy(c, cap))
    for cols in ep:
        pipeline.push_left(mk(cols))
        pipeline.push_right(mk(cols))
    pipeline.barrier()
    return int(max(c["date_time"].max() for c in ep))


def _port_digests(q7):
    mv = integrity.mv_lanes(q7.mview.table, q7.mview.state)
    agg = integrity.agg_lanes(q7.agg.table, q7.agg.state, q7.agg._float_extremes)
    jl, jr = q7.join.side_digests()
    return {"left": q7.pipeline.left[1].state_digest(),
            "right": integrity.host_digest(*integrity.host_lanes(*agg)),
            "join_left": jl, "join_right": jr,
            "mv": integrity.host_digest(*integrity.host_lanes(*mv))}


def _ref_digests(q7):
    np_lanes = lambda lanes, live: ({k: np.asarray(v) for k, v in lanes.items()},
                                    np.asarray(live))
    mv = ref_integrity.mv_lanes(q7.mview.table, q7.mview.state)
    agg = ref_integrity.agg_lanes(q7.agg.table, q7.agg.state)
    jl = ref_integrity.host_digest(*ref_integrity.join_side_lanes(q7.join.left, np.where))
    jr = ref_integrity.host_digest(*ref_integrity.join_side_lanes(q7.join.right, np.where))
    return {"left": q7.pipeline.left[1].state_digest(),
            "right": ref_integrity.host_digest(*np_lanes(*agg)),
            "join_left": jl, "join_right": jr,
            "mv": ref_integrity.host_digest(*np_lanes(*mv))}


def _sizes(capacity):
    return dict(capacity=capacity, fanout=8, out_cap=1 << 11, agg_capacity=capacity >> 2,
                filter_capacity=capacity >> 2)


@pytest.mark.parametrize("capacity", [1 << 12, 1 << 8], ids=["sized", "grows"])
def test_q7_matches_reference_at_every_barrier(capacity):
    """Interpreted walks with a watermark after every barrier: MV
    snapshot and the five state digests (filter, agg, two join sides,
    MV) equal after each barrier and each watermark; capacities follow
    the reference's through growth."""
    ref = ref_build(**_sizes(capacity))
    port = build_q7(**_sizes(capacity), device="cpu")
    for ep in _stream(5, 2, 1500):
        mx = _drive(ref.pipeline, ep, port=False)
        assert _drive(port.pipeline, ep, port=True) == mx
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert _port_digests(port) == _ref_digests(ref)
        ref.pipeline.watermark("date_time", mx)
        port.pipeline.watermark("date_time", mx)
        assert _port_digests(port) == _ref_digests(ref)
    assert len(port.mview.snapshot()) > 0
    assert port.join.left.capacity == ref.join.left.capacity
    assert port.pipeline.left[1].table.capacity == ref.pipeline.left[1].table.capacity
    assert port.agg.table.capacity == ref.agg.table.capacity
    assert port.agg.cleaning_watermarks() == ref.agg.cleaning_watermarks()
    if capacity == 1 << 8:
        assert port.join.left.capacity > capacity


@pytest.mark.parametrize("per_epoch", [1, 3], ids=["one_chunk", "padded_segments"])
def test_q7_fused_matches_reference_fused_at_every_barrier(per_epoch):
    """Both fused programs over the same chunks, a watermark after every
    barrier: MV snapshot, every staged digest and the telemetry counters
    equal at every barrier; the staged digests equal the host fold of
    the members' lanes."""
    ref = ref_build(**_sizes(1 << 12))
    port = build_q7(**_sizes(1 << 12), device="cpu")
    (rw,) = ref_fuse(ref.pipeline, label="q7")
    (pw,) = fuse_pipeline(port.pipeline, label="q7")
    assert isinstance(pw, FusedTwoInputExecutor) and port.pipeline._fused is pw
    assert pw.agg is port.agg and pw.covers_whole_chain
    for ep in _stream(5, per_epoch, 2000 // per_epoch):
        mx = _drive(ref.pipeline, ep, port=False)
        _drive(port.pipeline, ep, port=True)
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert pw.last_digests == rw.last_digests
        assert pw.last_digests == _port_digests(port)
        tel = {k: rw._telemetry[k]
               for k in ("rows_left", "rows_right", "join_rows", "dirty_groups", "mv_rows")}
        assert {k: pw.last_telemetry[k] for k in tel} == tel
        ref.pipeline.watermark("date_time", mx)
        port.pipeline.watermark("date_time", mx)
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert _port_digests(port) == _ref_digests(ref)


def test_q7_fused_equals_interpreted():
    """Mirror of test_fused_step.py's q7 twin: fused and interpreted MV
    snapshots equal at every barrier, watermarks included."""
    snaps = []
    for fuse in (False, True):
        q7 = build_q7(capacity=1 << 13, agg_capacity=1 << 11, filter_capacity=1 << 11,
                      out_cap=1 << 11, device="cpu")
        if fuse:
            (w,) = fuse_pipeline(q7.pipeline, label="q7")
            assert isinstance(w, FusedTwoInputExecutor)
        got = []
        for ep in _stream(4, 2, 1200, seed=7):
            mx = _drive(q7.pipeline, ep, port=True, cap=2048)
            q7.pipeline.watermark("date_time", mx)
            got.append(q7.mview.snapshot())
        snaps.append(got)
    assert snaps[0] == snaps[1]
    assert len(snaps[0][-1]) > 0


def _bids(rows):
    return {k: np.array([r[i] for r in rows], np.int64) for i, k in enumerate(COLS)}


def test_q7_matches_pandas_oracle():
    """Mirror of test_q7_pipeline.py's oracle test on the port."""
    q7 = build_q7(capacity=1 << 14, fanout=8, out_cap=1 << 14, device="cpu")
    all_bids = {k: [] for k in COLS}
    for ep in _stream(4, 3, 1500, rate=500, seed=0):
        for cols in ep:
            for k in COLS:
                all_bids[k].extend(cols[k].tolist())
        _drive(q7.pipeline, ep, port=True, cap=2048)
    want = _oracle(all_bids)
    assert len({k[0] for k in want}) >= 3
    assert q7.mview.snapshot() == want


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q7_cross_epoch_max_retraction(fuse):
    """Mirror of test_q7_pipeline.py: a higher bid in a later epoch
    retracts the earlier epoch's max pairs of its window; a tie keeps
    both."""
    q7 = build_q7(capacity=1 << 10, fanout=8, out_cap=1 << 10, device="cpu")
    if fuse:
        fuse_pipeline(q7.pipeline, label="q7")

    def epoch(rows):
        _drive(q7.pipeline, [_bids(rows)], port=True, cap=64)
        return q7.mview.snapshot()

    assert epoch([(1, 10, 100, 1000), (2, 20, 50, 2000)]) == {(0, 1, 10): (100,)}
    assert epoch([(3, 30, 120, 3000)]) == {(0, 3, 30): (120,)}
    assert epoch([(4, 40, 120, 4000)]) == {(0, 3, 30): (120,), (0, 4, 40): (120,)}


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q7_watermark_keeps_state_bounded(fuse):
    """Mirror of test_q7_pipeline.py: after the watermarks, every live
    key of the join's left side lies at or after the cutoff, and the MV
    keeps every closed window's answer."""
    q7 = build_q7(capacity=1 << 14, fanout=8, out_cap=1 << 14, device="cpu")
    if fuse:
        fuse_pipeline(q7.pipeline, label="q7")
    mx = 0
    for ep in _stream(6, 1, 1500, rate=500, seed=5):
        mx = max(mx, _drive(q7.pipeline, ep, port=True, cap=2048))
        q7.pipeline.watermark("date_time", mx)
    cutoff = (mx - Q7_WINDOW_MS) // Q7_WINDOW_MS * Q7_WINDOW_MS
    lane = q7.join.left.table.keys[0].numpy()
    live = q7.join.left.table.live.numpy()
    assert live.sum() > 0
    assert (lane[live] >= cutoff).all()
    for t in (q7.pipeline.left[1].table, q7.agg.table, q7.join.right.table):
        assert (t.keys[0].numpy()[t.live.numpy()] >= cutoff).all()
    assert len({k[0] for k in q7.mview.snapshot()}) >= 2


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_q7_late_bid_for_an_expired_window_matches_reference(fuse):
    """A bid for a window the watermark already closed: the filter's and
    the agg's tombstoned slots are found again with neither ``found``
    nor ``inserted``; whatever follows, the port does what the
    reference does (MV and digests)."""
    ref = ref_build(**_sizes(1 << 10))
    port = build_q7(**_sizes(1 << 10), device="cpu")
    if fuse:
        ref_fuse(ref.pipeline, label="q7")
        fuse_pipeline(port.pipeline, label="q7")
    steps = [
        [(1, 10, 100, 1000), (2, 20, 50, 2000)],
        [(3, 30, 70, 12_000)],
        [(4, 40, 90, 3000), (5, 50, 130, 4000), (6, 60, 80, 13_000)],  # window 0 is closed
        [(7, 70, 200, 5000), (8, 80, 75, 14_000)],
    ]
    for rows in steps:
        mx = _drive(ref.pipeline, [_bids(rows)], port=False, cap=64)
        _drive(port.pipeline, [_bids(rows)], port=True, cap=64)
        assert port.mview.snapshot() == ref.mview.snapshot()
        ref.pipeline.watermark("date_time", max(mx, 11_000))
        port.pipeline.watermark("date_time", max(mx, 11_000))
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert _port_digests(port) == _ref_digests(ref)
