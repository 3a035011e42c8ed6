"""The slice end to end: Nexmark q8 through the port (hop -> dedup per
side, inner HashJoin, device MV; plain PyTorch versions on the CPU),
interpreted and fused, against ``risingwave_tpu`` on JAX-CPU, against
the pandas oracle of ``tests/test_q8_pipeline.py``, and against itself
(mirrors of ``tests/test_fused_step.py``'s q8 cases).

Every comparison is exact: q8 has no float lanes, and state digests are
uint64 folds.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu.queries.nexmark_q import build_q8 as ref_build
from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
from risingwave_tpu_torch.queries.nexmark_q import Q8_WINDOW_MS, build_q8
from risingwave_tpu_torch.runtime.fused_step import (
    FusedTwoInputExecutor,
    expand_fused,
    fuse_pipeline,
    fusion_refusals,
)
from test_q8_pipeline import _oracle


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stream(epochs, per_epoch, events, rate=10_000, seed=3):
    """Per epoch, ``per_epoch`` (persons, auctions) numpy batches."""
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=rate), seed=seed)
    out = []
    for _ in range(epochs):
        ep = []
        for _ in range(per_epoch):
            ev = gen.next_events(events)
            p = {k: ev["person"][k] for k in ("id", "name", "date_time")}
            a = {k: ev["auction"][k] for k in ("seller", "date_time")}
            ep.append((p, a))
        out.append(ep)
    return out


def _push(pipeline, ep, port: bool):
    mk = (lambda c, n: StreamChunk.from_numpy(c, n, device="cpu")) if port else RefChunk.from_numpy
    for p, a in ep:
        if len(p["id"]):
            pipeline.push_left(mk(p, 256))
        if len(a["seller"]):
            pipeline.push_right(mk(a, 512))


def _port_digests(q8):
    mv = integrity.mv_lanes(q8.mview.table, q8.mview.state)
    left, right = q8.pipeline.left[1], q8.pipeline.right[1]
    jl, jr = q8.join.side_digests()
    return {"left": left.state_digest(), "right": right.state_digest(), "join_left": jl,
            "join_right": jr, "mv": integrity.host_digest(*integrity.host_lanes(*mv))}


def _ref_digests(q8):
    mv = ref_integrity.mv_lanes(q8.mview.table, q8.mview.state)
    jl = ref_integrity.host_digest(*ref_integrity.join_side_lanes(q8.join.left, np.where))
    jr = ref_integrity.host_digest(*ref_integrity.join_side_lanes(q8.join.right, np.where))
    return {"left": q8.pipeline.left[1].state_digest(),
            "right": q8.pipeline.right[1].state_digest(), "join_left": jl, "join_right": jr,
            "mv": ref_integrity.host_digest(*mv)}


@pytest.mark.parametrize("capacity", [1 << 11, 1 << 7], ids=["sized", "grows"])
def test_q8_matches_reference_at_every_barrier(capacity):
    """Interpreted walks: MV snapshot and the five state digests (two
    seen-sets, two join sides, MV) equal at every barrier; capacities
    follow the reference's through growth."""
    ref = ref_build(capacity=capacity, out_cap=1 << 11)
    port = build_q8(capacity=capacity, out_cap=1 << 11, device="cpu")
    for ep in _stream(4, 2, 3000):
        _push(ref.pipeline, ep, port=False)
        _push(port.pipeline, ep, port=True)
        ref.pipeline.barrier()
        port.pipeline.barrier()
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert _port_digests(port) == _ref_digests(ref)
    assert port.join.left.capacity == ref.join.left.capacity
    assert port.pipeline.left[1].table.capacity == ref.pipeline.left[1].table.capacity
    if capacity == 1 << 7:
        assert port.join.left.capacity > capacity


def test_q8_matches_pandas_oracle():
    """Mirror of test_q8_pipeline.py's oracle test on the port."""
    q8 = build_q8(capacity=1 << 12, fanout=8, out_cap=1 << 14, device="cpu")
    all_p = {"id": [], "name": [], "date_time": []}
    all_a = {"seller": [], "date_time": []}
    for ep in _stream(4, 3, 2000, rate=NexmarkConfig().first_event_rate, seed=0):
        for p, a in ep:
            for k in all_p:
                all_p[k].extend(p[k].tolist())
            for k in all_a:
                all_a[k].extend(a[k].tolist())
        _push(q8.pipeline, ep, port=True)
        q8.pipeline.barrier()
    want = _oracle(all_p, all_a, Q8_WINDOW_MS)
    assert len(want) > 50
    assert q8.mview.snapshot() == want


@pytest.mark.parametrize(
    "capacity,per_epoch", [(1 << 11, 1), (1 << 7, 3)], ids=["sized", "grows_padded"]
)
def test_q8_fused_matches_reference_fused_at_every_barrier(capacity, per_epoch):
    """Both fused programs over the same chunks (three a side per epoch:
    segments padded to four): MV snapshot, every staged digest and the
    telemetry counters equal at every barrier."""
    ref = ref_build(capacity=capacity, out_cap=1 << 11)
    port = build_q8(capacity=capacity, out_cap=1 << 11, device="cpu")
    (rw,) = ref_fuse(ref.pipeline, label="q8")
    (pw,) = fuse_pipeline(port.pipeline, label="q8")
    assert isinstance(pw, FusedTwoInputExecutor) and port.pipeline._fused is pw
    for ep in _stream(4, per_epoch, 3000 // per_epoch):
        _push(ref.pipeline, ep, port=False)
        _push(port.pipeline, ep, port=True)
        ref.pipeline.barrier()
        port.pipeline.barrier()
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert pw.last_digests == rw.last_digests
        assert pw.last_digests == _port_digests(port)
        tel = {k: rw._telemetry[k] for k in ("rows_left", "rows_right", "join_rows", "mv_rows")}
        assert {k: pw.last_telemetry[k] for k in tel} == tel
    assert port.join.right.capacity == ref.join.right.capacity
    assert port.mview.table.capacity == ref.mview.table.capacity


def test_q8_fused_equals_interpreted():
    """Mirror of test_fused_step.py's q8 twin: fused and interpreted MV
    snapshots equal at every barrier, with several chunks per side."""
    snaps = []
    for fuse in (False, True):
        q8 = build_q8(capacity=1 << 12, out_cap=1 << 11, device="cpu")
        if fuse:
            fuse_pipeline(q8.pipeline, label="q8")
        got = []
        for ep in _stream(4, 2, 3000, seed=7):
            _push(q8.pipeline, ep, port=True)
            q8.pipeline.barrier()
            got.append(q8.mview.snapshot())
        snaps.append(got)
    assert snaps[0] == snaps[1]
    assert len(snaps[0][-1]) > 0


def test_two_input_fallback_twin():
    """Mirror of test_fused_step.py's fallback twin: a tail the program
    cannot absorb (a second device MV) refuses whole-pipeline fusion
    (recorded), each chain falls back to the per-chain policy (the
    join-fed MV tail fuses, each device MV one program, as the
    reference's ``fuse_chain`` rewrites it), and the result equals the
    interpreted run."""
    def build():
        q8 = build_q8(capacity=1 << 12, out_cap=1 << 11, device="cpu")
        twin_mv = DeviceMaterializeExecutor(
            ("id", "starttime"), ("name",), {"id": torch.int64, "starttime": torch.int64,
                                             "name": torch.int32}, device="cpu",
        )
        q8.pipeline.tail.append(twin_mv)
        return q8.pipeline, q8.mview, twin_mv

    fusion_refusals(clear=True)
    twin, twin_mv, _ = build()
    pipe, mv, mv2 = build()
    created = fuse_pipeline(pipe, label="q8")
    assert [w.members for w in created] == [[mv], [mv2]]
    assert pipe._fused is None
    (rec,) = fusion_refusals()
    assert rec["executor"] == "DeviceMaterializeExecutor" and rec["code"] == "RW-E807"
    for ep in _stream(3, 2, 3000, seed=11):
        _push(twin, ep, port=True)
        _push(pipe, ep, port=True)
        twin.barrier()
        pipe.barrier()
        assert mv.snapshot() == twin_mv.snapshot() == mv2.snapshot()
    assert expand_fused(pipe.executors) == pipe.left + pipe.right + [pipe.join, mv, mv2]


def test_two_input_overflow_latch_raises_at_finish():
    """Mirror of test_fused_step.py's latch test: a poisoned member
    latch surfaces at the barrier through the packed scalar lane."""
    q8 = build_q8(capacity=1 << 10, out_cap=1 << 9, device="cpu")
    (w,) = fuse_pipeline(q8.pipeline, label="q8")
    ((p, a),) = _stream(1, 1, 800)[0]
    chunk = lambda: StreamChunk.from_numpy(p, 256, device="cpu")
    q8.pipeline.push_left(chunk())
    q8.pipeline.barrier()
    dedup = q8.pipeline.left[1]
    dedup._dropped.fill_(True)
    with pytest.raises(RuntimeError, match="dedup table overflowed"):
        q8.pipeline.push_left(chunk())
        q8.pipeline.barrier()
    assert w.l_stateful is dedup  # members stayed the system of record


def test_join_emission_overflow_raises_under_fusion():
    q8 = build_q8(capacity=1 << 10, out_cap=4, device="cpu")
    fuse_pipeline(q8.pipeline, label="q8")
    p = {"id": np.arange(10, dtype=np.int64), "name": np.zeros(10, np.int32),
         "date_time": np.zeros(10, np.int64)}
    a = {"seller": np.arange(10, dtype=np.int64), "date_time": np.zeros(10, np.int64)}
    q8.pipeline.push_left(StreamChunk.from_numpy(p, 16, device="cpu"))
    q8.pipeline.push_right(StreamChunk.from_numpy(a, 16, device="cpu"))
    with pytest.raises(RuntimeError, match="emission overflowed"):
        q8.pipeline.barrier()


@pytest.mark.parametrize("fuse", [False, True], ids=["interpreted", "fused"])
def test_window_watermark_raises_until_state_cleaning_is_ported(fuse):
    """Watermark state cleaning of q8 (both seen-sets and both join
    sides, kernel O's plain versions), interpreted or fused, with a
    ``date_time`` watermark after every barrier: the MV snapshot and the
    five state digests equal the reference's after each watermark, the
    join emits the aligned watermark, and closed windows leave every
    table. A plan without window keys passes watermarks through."""
    ref = ref_build(capacity=1 << 11, out_cap=1 << 11)
    port = build_q8(capacity=1 << 11, out_cap=1 << 11, device="cpu")
    if fuse:
        ref_fuse(ref.pipeline, label="q8")
        fuse_pipeline(port.pipeline, label="q8")
    mx = 0
    for ep in _stream(4, 2, 1500, rate=400, seed=13):
        _push(ref.pipeline, ep, port=False)
        _push(port.pipeline, ep, port=True)
        ref.pipeline.barrier()
        port.pipeline.barrier()
        mx = max([mx] + [int(c["date_time"].max()) for pa in ep for c in pa if len(c["date_time"])])
        ref.pipeline.watermark("date_time", mx)
        port.pipeline.watermark("date_time", mx)
        assert port.mview.snapshot() == ref.mview.snapshot()
        assert _port_digests(port) == _ref_digests(ref)
    assert port.join._wm == ref.join._wm and port.join._wm["out"] is not None
    cutoff = (mx - Q8_WINDOW_MS) // Q8_WINDOW_MS * Q8_WINDOW_MS
    for t, k in ((port.join.left.table, 1), (port.join.right.table, 1),
                 (port.pipeline.left[1].table, 2), (port.pipeline.right[1].table, 1)):
        assert int(t.live.sum()) < int(t.occupancy())
        assert (t.keys[k].numpy()[t.live.numpy()] >= cutoff).all()
    q8 = build_q8(capacity=1 << 10, state_cleaning=False, device="cpu")
    assert q8.pipeline.watermark("date_time", 20_000) == []
