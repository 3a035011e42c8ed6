"""The HashAgg flush chunk of a table below ``out_cap`` has the
reference's capacity (a fixed fault of ROADMAP Queue 3).

The reference's ``agg_ops.flush`` takes ``order[:out_cap]``
(``risingwave_tpu/ops/agg.py:632-633``), which clamps to the table's
capacity, so its delta lanes hold ``2 * min(out_cap, capacity)`` rows
and ``_delta_to_chunk``'s ``[:flush_pad(...)]`` slice cannot lengthen
them. The port's flush emitted ``2 * out_cap`` rows. Held here:

- the delta of one flush round, lane for lane (length, status, every
  valid row), on tables below, at and above ``out_cap``;
- every flush chunk of an interpreted agg below ``out_cap``: its
  capacity, valid lane and valid rows equal to the reference's;
- p31 (hop -> COUNT(*) -> a general over-window numbering rows by the
  capacities before them) at q5's ``out_cap`` 2^15, interpreted and
  fused: emissions, MV snapshots and digests equal at every barrier
  (before the repair ``seq`` of ``p31.over`` differed at barrier 2).

Tolerance: none; every lane is an integer or a bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors.hash_agg import HashAggExecutor as RefAgg
from risingwave_tpu.ops import agg as ref_ops
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.ops import agg as port_ops

import test_torch_window_paths as wpt


@pytest.mark.parametrize("cap,out_cap", [(64, 256), (64, 64), (256, 64), (64, 1 << 15)])
def test_flush_round_rows_clamp_to_capacity(cap, out_cap):
    rng = np.random.default_rng(cap + out_cap)
    calls = (("count_star", None, "n"), ("sum", "v", "s"))
    rcalls = tuple(ref_ops.AggCall(*c) for c in calls)
    pcalls = tuple(port_ops.AggCall(*c) for c in calls)
    rs = ref_ops.create_state(cap, rcalls, {"v": jnp.int64})
    ps = port_ops.create_state(cap, pcalls, {"v": torch.int64}, device="cpu")
    n = 3 * cap // 4
    slots = rng.permutation(cap)[:n].astype(np.int32)
    signs = np.ones(n, np.int32)
    v = rng.integers(-100, 100, n)
    rs = ref_ops.apply(rs, rcalls, jnp.asarray(slots), jnp.asarray(signs), {"v": jnp.asarray(v)}, {})
    port_ops.apply(ps, pcalls, torch.from_numpy(slots), torch.from_numpy(signs),
                   {"v": torch.from_numpy(v)}, {})
    keys = np.arange(cap, dtype=np.int64)
    while True:
        rs, rd = ref_ops.flush(rs, (jnp.asarray(keys),), out_cap)
        ps, pd = port_ops.flush(ps, (torch.from_numpy(keys),), out_cap)
        assert pd["valid"].shape[0] == rd["valid"].shape[0] == 2 * min(out_cap, cap)
        assert pd["status"].tolist() == np.asarray(rd["status"]).tolist()
        valid = np.asarray(rd["valid"])
        np.testing.assert_array_equal(pd["valid"].numpy(), valid)
        for name in ("ops", "key0", "n", "s"):
            np.testing.assert_array_equal(pd[name].numpy()[valid], np.asarray(rd[name])[valid],
                                          err_msg=name)
        if not np.asarray(rd["status"])[1]:
            break


def test_agg_flush_chunks_below_out_cap():
    """A 256-slot agg with ``out_cap`` 2^10 flushing more dirty groups than
    the small pad holds (its table grows only after the flush): every
    flush chunk of every barrier has the reference's capacity, valid
    lane and rows."""
    kw = dict(group_keys=("k",), capacity=256, out_cap=1 << 10)
    ref = RefAgg(calls=(ref_ops.AggCall("count_star", None, "n"),
                        ref_ops.AggCall("sum", "v", "s")),
                 schema_dtypes={"k": jnp.int64, "v": jnp.int64}, **kw)
    port = HashAggExecutor(calls=(port_ops.AggCall("count_star", None, "n"),
                                  port_ops.AggCall("sum", "v", "s")),
                           schema_dtypes={"k": torch.int64, "v": torch.int64}, device="cpu", **kw)
    rng = np.random.default_rng(7)
    caps = []
    for epoch in range(3):
        keys = rng.permutation(np.arange(192) % 150) + 150 * epoch  # 150 groups
        for j in range(3):
            cols = {"k": keys[64 * j:64 * j + 64], "v": rng.integers(-9, 9, 64)}
            ref.apply(RefChunk.from_numpy(cols, 64))
            port.apply(StreamChunk.from_numpy(cols, 64, device="cpu"))
        got, want = port.on_barrier(None), ref.on_barrier(None)
        assert [c.capacity for c in got] == [c.capacity for c in want]
        caps += [c.capacity for c in got]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
            gd, wd = g.to_numpy(with_ops=True), w.to_numpy(with_ops=True)
            assert gd.keys() == wd.keys()
            for name in gd:
                np.testing.assert_array_equal(gd[name], wd[name], err_msg=name)
    assert caps[0] == 512  # 2 x 256 slots, not the full pad of 2 x 2^10


@pytest.mark.parametrize("fused", [False, True], ids=["interpreted", "fused"])
def test_p31_at_q5_out_cap_matches_reference(fused):
    """p31 with its agg at q5's ``out_cap`` (2^15) over the seed-29 stream:
    the over-window's ``seq`` follows the flush chunks' capacities, so
    its emissions, MV and digests equal the reference's at every barrier
    only if every flush chunk has the reference's capacity."""
    ref = wpt.build_p31(False, out_cap=1 << 15)
    port = wpt.build_p31(True, out_cap=1 << 15)
    if fused:
        port.p.fuse(port.pipeline, label="p31")
        ref.p.fuse(ref.pipeline, label="p31")
    for e, ep in enumerate(wpt.stream()):
        got, want = wpt.drive(port, ep), wpt.drive(ref, ep)
        assert [c.capacity for c in got] == [c.capacity for c in want], f"barrier {e + 1}"
        assert wpt.emission(got) == wpt.emission(want), f"barrier {e + 1}: emission"
        assert port.mview.snapshot() == ref.mview.snapshot(), f"barrier {e + 1}: MV"
        assert wpt.digests(port) == wpt.digests(ref), f"barrier {e + 1}: digests"
