"""The slice end to end: Nexmark q5-lite through the port
(hop -> HashAgg -> device MV, plain PyTorch versions on the CPU) against
``risingwave_tpu`` on JAX-CPU and the pandas oracle of
``tests/test_q5_pipeline.py``.

Every comparison is exact: the slice is integer-only (ids, timestamps,
counts), so MV snapshots, flush deltas and state lanes must be equal.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.array.chunk import concat_chunks as ref_concat
from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
from risingwave_tpu.connectors.nexmark import NexmarkGenerator as RefGenerator
from risingwave_tpu.executors.hop_window import hop_step_fn as ref_hop
from risingwave_tpu.queries.nexmark_q import build_q5_lite as ref_build
from risingwave_tpu_torch.array.chunk import StreamChunk, concat_chunks
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.executors.hop_window import hop_step_fn
from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite
from test_q5_pipeline import _oracle_counts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_np_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_generator_gives_the_reference_events():
    for cfg in ({}, {"first_event_rate": 200_000, "hot_auction_ratio": 3}):
        r = RefGenerator(RefConfig(**cfg), seed=9)
        p = NexmarkGenerator(NexmarkConfig(**cfg), seed=9)
        for n in (777, 3000):
            re, pe = r.next_events(n), p.next_events(n)
            for stream in ("person", "auction", "bid"):
                _assert_np_dicts_equal(pe[stream], re[stream])
        rc = r.next_chunks(1000, 1024)["bid"]
        pc = p.next_chunks(1000, 1024, device="cpu")["bid"]
        _assert_np_dicts_equal(pc.to_numpy(), rc.to_numpy())
        assert pc.col("channel").dtype == torch.int32
        assert pc.col("date_time").dtype == torch.int64


def test_chunk_helpers_match_reference():
    rng = np.random.default_rng(1)
    cols = {"a": rng.integers(0, 9, 50), "b": rng.standard_normal(50)}
    ops = rng.integers(0, 4, 50).astype(np.int32)
    nulls = {"b": rng.random(50) < 0.3}
    rc = RefChunk.from_numpy(cols, 64, ops=ops, nulls=nulls)
    pc = StreamChunk.from_numpy(cols, 64, ops=ops, nulls=nulls, device="cpu")
    np.testing.assert_array_equal(pc.effective_signs().numpy(), np.asarray(rc.effective_signs()))
    keep = rng.random(64) < 0.5
    _assert_np_dicts_equal(
        pc.mask(torch.from_numpy(keep)).select(["b"]).to_numpy(),
        rc.mask(keep).select(["b"]).to_numpy(),
    )
    np.testing.assert_array_equal(pc.null_of("a").numpy(), np.asarray(rc.null_of("a")))
    _assert_np_dicts_equal(
        concat_chunks([pc, pc], 128).to_numpy(), ref_concat([rc, rc], 128).to_numpy()
    )
    with pytest.raises(ValueError):
        StreamChunk.from_numpy({"a": np.arange(3)}, 2, device="cpu")


def test_hop_step_matches_reference():
    gen = RefGenerator(RefConfig(first_event_rate=5_000))
    bid = gen.next_chunks(700, 700)["bid"]
    data = bid.to_numpy()
    ops = data.pop("__op__")
    pc = StreamChunk.from_numpy(data, 700, ops=ops, device="cpu")
    r = ref_hop(bid, "date_time", 10_000, 2_000, "window_start")
    p = hop_step_fn(pc, "date_time", 10_000, 2_000, "window_start")
    assert p.capacity == r.capacity == 5 * 700
    for name in r.columns:
        np.testing.assert_array_equal(p.col(name).numpy(), np.asarray(r.col(name)), err_msg=name)
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(r.valid))
    np.testing.assert_array_equal(p.ops.numpy(), np.asarray(r.ops))


def _feed(pipelines, gens, events, chunk_events, cap):
    """Push the same bid chunks (numpy-generated once) into both."""
    bids = []
    done = 0
    while done < events:
        n = min(chunk_events, events - done)
        done += n
        data = gens.next_events(n)["bid"]
        if not len(data["auction"]):
            continue
        bids.append(pd.DataFrame(data))
        rp, pp = pipelines
        rp.push(RefChunk.from_numpy(data, cap))
        pp.push(StreamChunk.from_numpy(data, cap, device="cpu"))
    return bids


@pytest.mark.parametrize(
    "capacity,rate", [(1 << 14, 50_000), (1 << 8, 200_000)], ids=["sized", "grows"]
)
def test_q5_matches_reference_at_every_barrier(capacity, rate):
    ref_q5 = ref_build(capacity=capacity, state_cleaning=False)
    q5 = build_q5_lite(capacity=capacity, state_cleaning=False, device="cpu")
    gen = RefGenerator(RefConfig(first_event_rate=rate))
    bids = []
    for _ in range(4):
        bids += _feed((ref_q5.pipeline, q5.pipeline), gen, 3000, 600, 600)
        ref_q5.pipeline.barrier()
        q5.pipeline.barrier()
        assert q5.mview.snapshot() == ref_q5.mview.snapshot()
    assert q5.mview.snapshot() == _oracle_counts(pd.concat(bids))
    assert q5.agg.table.capacity == ref_q5.agg.table.capacity
    assert q5.mview.table.capacity == ref_q5.mview.table.capacity
    if capacity == 1 << 8:  # growth rebuilt both tables
        assert q5.agg.table.capacity > capacity
        assert q5.mview.table.capacity > 1 << 12


def _agg_lanes(agg):
    t, s = agg.table, agg.state
    arr = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    out = {
        "fp1": arr(t.fp1).view(np.uint32), "fp2": arr(t.fp2).view(np.uint32),
        "live": arr(t.live), "row_count": arr(s.row_count),
        "emitted_valid": arr(s.emitted_valid), "dirty": arr(s.dirty),
        "sdirty": arr(s.sdirty),
    }
    out.update({f"key{i}": arr(k) for i, k in enumerate(t.keys)})
    out.update({f"acc.{n}": arr(a) for n, a in s.accums.items()})
    out.update({f"em.{n}": arr(a) for n, a in s.emitted.items()})
    return out


def _mv_lanes(mv):
    t, s = mv.table, mv.state
    arr = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    out = {
        "fp1": arr(t.fp1).view(np.uint32), "live": arr(t.live),
        "sdirty": arr(s.sdirty), "num": arr(s.values["num"]),
    }
    out.update({f"key{i}": arr(k) for i, k in enumerate(t.keys)})
    return out


def test_state_carried_across_matches_slot_for_slot():
    """Run the reference three epochs, import its state into the port,
    then run both two more: flush deltas and every state lane must be
    equal slot for slot."""
    gen = RefGenerator(RefConfig(first_event_rate=50_000))
    ref_q5 = ref_build(capacity=1 << 14, state_cleaning=False)
    for _ in range(3):
        for _ in range(4):
            ref_q5.pipeline.push(gen.next_chunks(600, 600)["bid"])
        ref_q5.pipeline.barrier()
    q5 = build_q5_lite(capacity=1 << 14, state_cleaning=False, device="cpu")
    q5.agg.load_reference_state(
        jax.device_get({"table": ref_q5.agg.table, "state": ref_q5.agg.state,
                        "dropped": ref_q5.agg.dropped})
    )
    q5.mview.load_reference_state(
        jax.device_get({"table": ref_q5.mview.table, "state": ref_q5.mview.state})
    )
    _assert_np_dicts_equal(_agg_lanes(q5.agg), _agg_lanes(ref_q5.agg))
    for _ in range(2):
        _feed((ref_q5.pipeline, q5.pipeline), gen, 2400, 600, 600)
        r_out = ref_q5.pipeline.barrier()
        p_out = q5.pipeline.barrier()
        # the MV passes the agg's flush deltas through: compare them in order
        assert len(p_out) == len(r_out) >= 1
        for rc, pc in zip(r_out, p_out):
            assert pc.capacity == rc.capacity
            _assert_np_dicts_equal(pc.to_numpy(), rc.to_numpy())
        _assert_np_dicts_equal(_agg_lanes(q5.agg), _agg_lanes(ref_q5.agg))
        _assert_np_dicts_equal(_mv_lanes(q5.mview), _mv_lanes(ref_q5.mview))
    assert q5.mview.snapshot() == ref_q5.mview.snapshot()


def test_window_watermark_raises_until_state_cleaning_is_ported():
    """Watermark state cleaning of q5's agg (emit-on-window-close): a
    ``date_time`` watermark after some chunks and after each barrier
    flushes the dirty groups (their deltas come out of the watermark,
    equal to the reference's) and frees the closed windows: every
    agg lane, slot for slot, and the MV equal the reference's. A plan
    without a window key passes watermarks through."""
    ref_q5 = ref_build(capacity=1 << 12)
    q5 = build_q5_lite(capacity=1 << 12, device="cpu")
    gen = RefGenerator(RefConfig(first_event_rate=300))
    mx = 0
    for _ in range(4):
        bids = _feed((ref_q5.pipeline, q5.pipeline), gen, 1600, 400, 512)
        mx = max(mx, int(pd.concat(bids)["date_time"].max()))
        r_out = ref_q5.pipeline.watermark("date_time", mx)
        p_out = q5.pipeline.watermark("date_time", mx)
        assert len(p_out) == len(r_out) == 1
        _assert_np_dicts_equal(p_out[0].to_numpy(), r_out[0].to_numpy())
        _assert_np_dicts_equal(_agg_lanes(q5.agg), _agg_lanes(ref_q5.agg))
        ref_q5.pipeline.barrier()
        q5.pipeline.barrier()
        ref_q5.pipeline.watermark("date_time", mx)
        q5.pipeline.watermark("date_time", mx)
        _assert_np_dicts_equal(_agg_lanes(q5.agg), _agg_lanes(ref_q5.agg))
        assert q5.mview.snapshot() == ref_q5.mview.snapshot()
    assert int(q5.agg.table.live.sum()) < int(q5.agg.table.occupancy())
    assert q5.agg.cleaning_watermarks() == ref_q5.agg.cleaning_watermarks()
    # a plan without a window key passes watermarks through
    q5 = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    assert q5.pipeline.watermark("date_time", 1_436_918_500_000) == []
