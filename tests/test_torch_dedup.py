"""Kernel J and the append-only dedup: the port's plain PyTorch versions
(``executors/dedup.py``, ``ops/hash_table.first_occurrence_mask``)
against ``risingwave_tpu`` on JAX-CPU, on the same seeded inputs.

On the CPU the port's hash table places keys in the reference's slots,
so the emission mask and every state lane must be equal. Tolerance:
none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import dedup as rd
from risingwave_tpu.executors.base import Barrier, Epoch, Watermark
from risingwave_tpu.ops import hash_table as rht
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import dedup as pd_
from risingwave_tpu_torch.executors.base import Watermark as PortWatermark
from risingwave_tpu_torch.ops import hash_table as pht
from risingwave_tpu.types import Op

KEYS = ("a", "b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chunks(rng, n, n_keys, cap, p_delete=0.0):
    a = rng.integers(0, n_keys, n).astype(np.int64)
    b = (rng.integers(0, 3, n) * 10_000).astype(np.int64)
    ops = np.where(rng.random(n) < p_delete, Op.DELETE, Op.INSERT).astype(np.int32)
    cols = {"a": a, "b": b}
    return (RefChunk.from_numpy(cols, cap, ops=ops),
            StreamChunk.from_numpy(cols, cap, ops=ops, device="cpu"))


def _lanes_equal(ref_table, ref_sdirty, port_table, port_sdirty):
    np.testing.assert_array_equal(port_table.fp1.numpy().view(np.uint32), np.asarray(ref_table.fp1))
    np.testing.assert_array_equal(port_table.fp2.numpy().view(np.uint32), np.asarray(ref_table.fp2))
    for r, p in zip(ref_table.keys, port_table.keys):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    np.testing.assert_array_equal(port_table.live.numpy(), np.asarray(ref_table.live))
    np.testing.assert_array_equal(port_sdirty.numpy(), np.asarray(ref_sdirty))


@pytest.mark.parametrize(
    "cap,n_keys,p_delete",
    [(1024, 300, 0.0), (1024, 300, 0.05), (64, 400, 0.0)],
    ids=["inserts", "with_delete", "overflow"],
)
def test_dedup_step_matches_reference(cap, n_keys, p_delete):
    """Emission (first row of each new key; in-chunk twins and keys seen
    before drop), live, sdirty and both latches equal after every chunk;
    a 64-slot table drops rows (the dropped latch)."""
    rng = np.random.default_rng(cap + n_keys)
    rt = rht.HashTable.create(cap, (jnp.int64, jnp.int64))
    rs = jnp.zeros(cap, jnp.bool_)
    pt = pht.HashTable.create(cap, (torch.int64, torch.int64), device="cpu")
    ps = torch.zeros(cap, dtype=torch.bool)
    scratch = pht.first_scratch(cap, "cpu")
    r_saw = r_drop = False
    latches = (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    for _ in range(4):
        rc, pc = _chunks(rng, 200, n_keys, 256, p_delete)
        rt, rs, r_out, saw, drop = rd.dedup_step_fn(rt, rs, rc, KEYS)
        r_saw, r_drop = r_saw or bool(saw), r_drop or bool(drop)
        pt, ps, p_out = pd_.dedup_step_fn(pt, ps, pc, KEYS, scratch, latches)
        np.testing.assert_array_equal(p_out.valid.numpy(), np.asarray(r_out.valid))
        _lanes_equal(rt, rs, pt, ps)
        assert (bool(latches[0]), bool(latches[1])) == (r_saw, r_drop)
    assert r_saw == (p_delete > 0)
    assert r_drop == (cap == 64)


def test_first_occurrence_mask_matches_reference():
    rng = np.random.default_rng(5)
    for n in (1, 17, 500):
        slots = rng.integers(-1, 40, n).astype(np.int32)
        valid = rng.random(n) < 0.8
        want = np.asarray(rht.first_occurrence_mask(jnp.asarray(slots), jnp.asarray(valid)))
        got = pht.first_occurrence_mask(torch.from_numpy(slots), torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), want)


def test_rebuild_matches_reference():
    rng = np.random.default_rng(9)
    cap = 256
    rt = rht.HashTable.create(cap, (jnp.int64, jnp.int64))
    rs = jnp.zeros(cap, jnp.bool_)
    pt = pht.HashTable.create(cap, (torch.int64, torch.int64), device="cpu")
    ps = torch.zeros(cap, dtype=torch.bool)
    latches = (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    for _ in range(2):
        rc, pc = _chunks(rng, 100, 90, 128)
        rt, rs, _, _, _ = rd.dedup_step_fn(rt, rs, rc, KEYS)
        pt, ps, _ = pd_.dedup_step_fn(pt, ps, pc, KEYS, pht.first_scratch(cap, "cpu"), latches)
    stored = rng.random(cap) < 0.3
    for new_cap in (512, 256):
        r = rd._rebuild(rt, rs, jnp.asarray(stored), new_cap)
        p = pd_._rebuild(pt, ps, torch.from_numpy(stored), new_cap)
        _lanes_equal(r[0], r[1], p[0], p[1])
        np.testing.assert_array_equal(p[2].numpy(), np.asarray(r[2]))
        assert int(p[0].occupancy()) == int(r[0].occupancy())


def _executors(cap, **kw):
    dt = {"a": jnp.int64, "b": jnp.int64}
    ref = rd.AppendOnlyDedupExecutor(KEYS, dt, capacity=cap, **kw)
    port = pd_.AppendOnlyDedupExecutor(KEYS, {"a": torch.int64, "b": torch.int64}, capacity=cap,
                                       device="cpu", **kw)
    return ref, port


def test_executor_matches_reference_through_growth():
    """apply + barrier over a 64-slot seen-set that grows: emissions,
    capacities and state digests equal at every barrier."""
    rng = np.random.default_rng(13)
    ref, port = _executors(64)
    for e in range(4):
        for _ in range(2):
            rc, pc = _chunks(rng, 120, 2_000, 128)
            (r_out,) = ref.apply(rc)
            (p_out,) = port.apply(pc)
            np.testing.assert_array_equal(p_out.valid.numpy(), np.asarray(r_out.valid))
        ref.on_barrier(Barrier(Epoch(e, e + 1)))
        ref.finish_barrier()
        port.on_barrier(None)
        assert port.table.capacity == ref.table.capacity
        assert port.state_digest() == ref.state_digest()
    assert port.table.capacity > 64


def test_delete_raises_at_the_barrier():
    _, port = _executors(256)
    _, pc = _chunks(np.random.default_rng(1), 50, 20, 64, p_delete=0.5)
    port.apply(pc)
    with pytest.raises(RuntimeError, match="append-only dedup received a DELETE"):
        port.on_barrier(None)


def test_window_watermark_raises_and_other_columns_pass():
    """A watermark on the window column expires the seen-set's keys
    below ``value - retention`` (kernel O's plain version): live,
    sdirty and the digest equal the reference's after each watermark,
    and an expired key seen again is found as a tombstone (no emission),
    as in the reference; a watermark on another column passes through
    and changes nothing."""
    rng = np.random.default_rng(17)
    ref, port = _executors(1024, window_key=("b", 5_000))
    for value in (12_000, 16_000, 24_000):
        for _ in range(2):
            rc, pc = _chunks(rng, 150, 100, 256)
            (r_out,) = ref.apply(rc)
            (p_out,) = port.apply(pc)
            np.testing.assert_array_equal(p_out.valid.numpy(), np.asarray(r_out.valid))
        r_wm, r_outs = ref.on_watermark(Watermark("b", value))
        p_wm, p_outs = port.on_watermark(PortWatermark("b", value))
        assert (p_wm.column, p_wm.value, p_outs) == (r_wm.column, r_wm.value, r_outs) == (
            "b", value, [])
        _lanes_equal(ref.table, ref.sdirty, port.table, port.sdirty)
        assert port.state_digest() == ref.state_digest()
    live_b = port.table.keys[1].numpy()[port.table.live.numpy()]
    assert len(live_b) and (live_b >= 24_000 - 5_000).all()
    wm = PortWatermark("a", 5)
    before = port.table.live.clone()
    assert port.on_watermark(wm) == (wm, [])
    assert torch.equal(port.table.live, before)
    assert ref.on_watermark(Watermark("a", 5))[0].column == "a"


def test_null_key_lane_is_refused():
    _, port = _executors(256)
    pc = StreamChunk.from_numpy({"a": np.arange(4), "b": np.zeros(4, np.int64)}, 8,
                                nulls={"a": np.array([True, False, False, False])}, device="cpu")
    with pytest.raises(ValueError, match="null lane"):
        port.apply(pc)
