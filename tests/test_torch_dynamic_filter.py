"""Kernel N and the dynamic max filter: the port's plain PyTorch versions
(``executors/dynamic_filter.py``) against ``risingwave_tpu`` on JAX-CPU,
on the same seeded inputs.

On the CPU the port's hash table places keys in the reference's slots,
so the pass mask and every state lane must be equal. Tolerance: none
(int64 lanes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import dynamic_filter as rdf
from risingwave_tpu.executors.base import Barrier, Epoch, Watermark
from risingwave_tpu.ops import hash_table as rht
from risingwave_tpu.types import Op
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import dynamic_filter as pdf
from risingwave_tpu_torch.executors.base import Watermark as PortWatermark
from risingwave_tpu_torch.ops import hash_table as pht

MIN64 = np.iinfo(np.int64).min


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chunks(rng, n, n_groups, cap, p_delete=0.0, base=0):
    """Bids of ``n_groups`` windows; prices on a coarse grid so ties at
    the running max are common."""
    w = ((base + rng.integers(0, n_groups, n)) * 10_000).astype(np.int64)
    p = (rng.integers(1, 40, n) * 25).astype(np.int64)
    ops = np.where(rng.random(n) < p_delete, Op.DELETE, Op.INSERT).astype(np.int32)
    cols = {"w": w, "p": p}
    return (RefChunk.from_numpy(cols, cap, ops=ops),
            StreamChunk.from_numpy(cols, cap, ops=ops, device="cpu"))


def _lanes_equal(ref, port, upto=None):
    """Table and filter lanes of ``(table, maxes, sdirty)`` equal over
    slots ``[:upto]``."""
    (rt, rm, rs), (pt, pm, ps) = ref, port
    sl = slice(None, upto)
    np.testing.assert_array_equal(pt.fp1.numpy().view(np.uint32)[sl], np.asarray(rt.fp1)[sl])
    np.testing.assert_array_equal(pt.keys[0].numpy()[sl], np.asarray(rt.keys[0])[sl])
    np.testing.assert_array_equal(pt.live.numpy()[sl], np.asarray(rt.live)[sl])
    np.testing.assert_array_equal(pm.numpy()[sl], np.asarray(rm)[sl])
    np.testing.assert_array_equal(ps.numpy()[sl], np.asarray(rs)[sl])


def _states(cap, rng=None):
    """Empty reference and port states; with ``rng``, both max lanes
    start from the same garbage (a fresh slot's max must be reset)."""
    maxes = np.full(cap, MIN64, np.int64) if rng is None else rng.integers(0, 2000, cap)
    ref = (rht.HashTable.create(cap, (jnp.int64,)), jnp.asarray(maxes), jnp.zeros(cap, jnp.bool_))
    port = (pht.HashTable.create(cap, (torch.int64,), device="cpu"), torch.from_numpy(maxes),
            torch.zeros(cap, dtype=torch.bool))
    return ref, port


@pytest.mark.parametrize(
    "cap,n_groups,p_delete,garbage",
    [(1024, 12, 0.0, False), (1024, 12, 0.0, True), (1024, 40, 0.05, False),
     (16, 40, 0.0, False)],
    ids=["fresh", "stale_maxes_reset", "with_delete", "overflow"],
)
def test_filter_step_matches_reference(cap, n_groups, p_delete, garbage):
    """Pass mask (new groups pass; others iff >= the pre-chunk max, so
    ties pass), live, maxes, sdirty and both latches equal after every
    chunk. A 16-slot table drops rows: the latches equal, and the lanes
    and the pass mask equal except at the last slot, where the
    reference's index -1 of a dropped row wraps (the port folds nothing
    for it; the barrier raises on the latch either way)."""
    rng = np.random.default_rng(cap + n_groups)
    ref, port = _states(cap, rng if garbage else None)
    latches = (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    r_saw = r_drop = False
    ties = 0
    for e in range(5):
        rc, pc = _chunks(rng, 200, n_groups, 256, p_delete, base=e // 2)
        rt, rm, rs = ref
        pre_max = np.asarray(rm).copy()
        rt, rm, rs, r_out, saw, drop = rdf.filter_step_fn(rt, rm, rs, rc, "w", "p")
        ref = (rt, rm, rs)
        r_saw, r_drop = r_saw or bool(saw), r_drop or bool(drop)
        pt, pm, ps, p_out = pdf.filter_step_fn(*port, pc, "w", "p", latches)
        port = (pt, pm, ps)
        slots = np.asarray(rht.lookup(rt, (rc.col("w"),), rc.valid)[0])
        ok = np.asarray(r_out.valid)
        rows = slots != cap - 1 if cap == 16 else slice(None)
        np.testing.assert_array_equal(p_out.valid.numpy()[rows], ok[rows])
        _lanes_equal(ref, port, upto=-1 if cap == 16 else None)
        assert (bool(latches[0]), bool(latches[1])) == (r_saw, r_drop)
        hit = (slots >= 0) & ok
        ties += int((pc.col("p").numpy()[hit] == pre_max[slots[hit]]).sum())
    assert r_saw == (p_delete > 0)
    assert r_drop == (cap == 16)
    if cap != 16:
        assert ties > 0


def test_rebuild_matches_reference():
    rng = np.random.default_rng(9)
    cap = 256
    ref, port = _states(cap)
    latches = (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    for e in range(3):
        rc, pc = _chunks(rng, 100, 60, 128, base=e * 30)
        ref = rdf.filter_step_fn(*ref, rc, "w", "p")[:3]
        port = pdf.filter_step_fn(*port, pc, "w", "p", latches)[:3]
    stored = rng.random(cap) < 0.3
    for new_cap in (512, 256):
        r = rdf._rebuild(*ref, jnp.asarray(stored), new_cap)
        p = pdf._rebuild(*port, torch.from_numpy(stored), new_cap)
        _lanes_equal(r[:3], p[:3])
        np.testing.assert_array_equal(p[3].numpy(), np.asarray(r[3]))
        assert int(p[0].occupancy()) == int(r[0].occupancy())


def _executors(cap, **kw):
    ref = rdf.DynamicMaxFilterExecutor("w", "p", {"w": jnp.int64, "p": jnp.int64},
                                       capacity=cap, **kw)
    port = pdf.DynamicMaxFilterExecutor("w", "p", {"w": torch.int64, "p": torch.int64},
                                        capacity=cap, device="cpu", **kw)
    return ref, port


def test_executor_matches_reference_through_growth_and_watermarks():
    """apply + barrier + watermark over a 64-slot table that grows:
    pass masks, capacities and state digests equal at every step; the
    watermark expires the closed windows (kernel O's plain version)."""
    rng = np.random.default_rng(13)
    ref, port = _executors(64, window_key=("w", 10_000))
    for e in range(5):
        for _ in range(2):
            rc, pc = _chunks(rng, 120, 80, 128, base=e * 40)
            (r_out,) = ref.apply(rc)
            (p_out,) = port.apply(pc)
            np.testing.assert_array_equal(p_out.valid.numpy(), np.asarray(r_out.valid))
        ref.on_barrier(Barrier(Epoch(e, e + 1)))
        ref.finish_barrier()
        port.on_barrier(None)
        assert port.table.capacity == ref.table.capacity
        assert port.state_digest() == ref.state_digest()
        value = (e * 40 + 20) * 10_000
        assert ref.on_watermark(Watermark("w", value))[1] == []
        assert port.on_watermark(PortWatermark("w", value)) == (PortWatermark("w", value), [])
        _lanes_equal((ref.table, ref.maxes, ref.sdirty), (port.table, port.maxes, port.sdirty))
        assert port.state_digest() == ref.state_digest()
    assert port.table.capacity > 64
    live_w = port.table.keys[0].numpy()[port.table.live.numpy()]
    assert len(live_w) and (live_w >= (4 * 40 + 20) * 10_000 - 10_000).all()
    wm = PortWatermark("p", 5)
    assert port.on_watermark(wm) == (wm, [])


@pytest.mark.parametrize("what", ["delete", "dropped"])
def test_latches_raise_at_the_barrier(what):
    """A DELETE reaching the filter raises at the barrier; so does the
    dropped latch (set by the step when a row finds no slot, see
    test_filter_step_matches_reference)."""
    _, port = _executors(256)
    _, pc = _chunks(np.random.default_rng(1), 60, 40, 64,
                    p_delete=0.5 if what == "delete" else 0.0)
    port.apply(pc)
    if what == "dropped":
        port._dropped.fill_(True)
    msg = "received a DELETE" if what == "delete" else "overflowed MAX_PROBE"
    with pytest.raises(RuntimeError, match=msg):
        port.on_barrier(None)


def test_null_columns_and_float_values_are_refused():
    _, port = _executors(64)
    pc = StreamChunk.from_numpy({"w": np.zeros(4, np.int64), "p": np.arange(4)}, 8,
                                nulls={"p": np.array([True, False, False, False])}, device="cpu")
    with pytest.raises(ValueError, match="non-nullable"):
        port.apply(pc)
    with pytest.raises(TypeError, match="int32 or int64"):
        pdf.DynamicMaxFilterExecutor("w", "p", {"w": torch.int64, "p": torch.float64},
                                     device="cpu")
