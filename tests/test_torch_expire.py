"""Kernel O, the watermark expiry: the port's plain PyTorch versions of
the four state kinds' expiries (``ops.hash_table.expire_table`` for the
dynamic filter and the dedup, ``ops.join.expire_keys``,
``executors.hash_agg._expire`` with ``ops.agg._reset_groups``) against
``risingwave_tpu`` on JAX-CPU, on the same seeded lanes, and the
expiry half of ``tests/test_hash_join.py``'s growth-and-watermark case.

Every lane is compared exactly, and the state digests of the lanes.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import dedup as rdd
from risingwave_tpu.executors import dynamic_filter as rdf
from risingwave_tpu.executors import hash_agg as rha
from risingwave_tpu.executors.base import Barrier, Epoch, Watermark
from risingwave_tpu.executors.hash_join import HashJoinExecutor as RefJoin
from risingwave_tpu.ops import agg as ragg
from risingwave_tpu.ops import hash_table as rht
from risingwave_tpu.ops import join as rjoin
from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import hash_agg as pha
from risingwave_tpu_torch.executors.base import Watermark as PortWatermark
from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor
from risingwave_tpu_torch.ops import agg as pagg
from risingwave_tpu_torch.ops import hash_table as pht
from risingwave_tpu_torch.ops import join as pjoin
from test_torch_agg import (
    CALLS,
    PORT_DTYPES,
    REF_DTYPES,
    _apply_both,
    _assert_states_equal,
    _batch,
    _calls,
    _flush_both,
)

CAP = 1 << 10  # test_torch_agg's CAP: its batches' slots lie below CAP // 4
WINDOW = 10_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tables(rng, cap, n_keys=2, live=None):
    """One key table, as the reference's and as the port's: claimed
    slots with random keys (lane 1 a window start), live a random subset
    of them (or ``live``)."""
    claimed = rng.random(cap) < 0.6
    fp1 = np.where(claimed, rng.integers(1, 2**32, cap), 0).astype(np.uint32)
    fp2 = rng.integers(0, 2**32, cap).astype(np.uint32)
    keys = [rng.integers(0, 1000, cap).astype(np.int64) for _ in range(n_keys)]
    keys[-1] = (rng.integers(0, 8, cap) * WINDOW).astype(np.int64)
    live = claimed & (rng.random(cap) < 0.7) if live is None else live
    ref = rht.HashTable(jnp.asarray(fp1), jnp.asarray(fp2), tuple(map(jnp.asarray, keys)),
                        jnp.asarray(live))
    port = pht.HashTable.from_reference_arrays(fp1, fp2, keys, live, device="cpu")
    return ref, port


def _table_lanes_equal(rt, pt):
    np.testing.assert_array_equal(pt.live.numpy(), np.asarray(rt.live))
    np.testing.assert_array_equal(pt.fp1.numpy().view(np.uint32), np.asarray(rt.fp1))
    for r, p in zip(rt.keys, pt.keys):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("kind", ["filter", "dedup"])
@pytest.mark.parametrize("cutoff", [-5, 35_000, 80_000], ids=["none", "half", "all"])
def test_key_table_expiry_matches_reference(kind, cutoff):
    """The filter's and the dedup's expiry (the reference executors'
    ``on_watermark``) against ``expire_table``: live, sdirty, the maxes
    left in place, and the digest equal."""
    rng = np.random.default_rng(cutoff + 7)
    rt, pt = _tables(rng, 512, n_keys=1 if kind == "filter" else 2)
    sdirty = rng.random(512) < 0.2
    if kind == "filter":
        ref = rdf.DynamicMaxFilterExecutor("w", "p", {"w": jnp.int64, "p": jnp.int64},
                                           capacity=512, window_key=("w", 0))
        maxes = rng.integers(0, 10**6, 512)
        ref.table, ref.maxes, ref.sdirty = rt, jnp.asarray(maxes), jnp.asarray(sdirty)
        col = "w"
    else:
        ref = rdd.AppendOnlyDedupExecutor(("a", "w"), {"a": jnp.int64, "w": jnp.int64},
                                          capacity=512, window_key=("w", 0))
        ref.table, ref.sdirty = rt, jnp.asarray(sdirty)
        col = "w"
    ref.on_watermark(Watermark(col, cutoff))
    ps = torch.from_numpy(sdirty.copy())
    pht.expire_table(pt, ps, len(pt.keys) - 1, cutoff)
    _table_lanes_equal(ref.table, pt)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(ref.sdirty))
    if kind == "filter":
        got = integrity.host_digest(*integrity.host_lanes(
            *integrity.filter_lanes(pt, torch.from_numpy(maxes))))
    else:
        got = integrity.host_digest(*integrity.host_lanes(*integrity.dedup_lanes(pt)))
    assert got == ref.state_digest()
    n_live = int(pt.live.sum())
    assert (n_live == 0) == (cutoff == 80_000) and (cutoff != -5 or n_live > 0)


def _sides(rng, cap=256, fanout=4):
    """One join side with random claimed keys and bucket entries, as the
    reference's and the port's."""
    rt, pt = _tables(rng, cap)
    rows = {"v": rng.integers(-99, 99, (cap, fanout)).astype(np.int64)}
    nulls = {"v": rng.random((cap, fanout)) < 0.1}
    row_valid = (rng.random((cap, fanout)) < 0.5) & np.asarray(rt.live)[:, None]
    degree = rng.integers(0, 5, (cap, fanout)).astype(np.int32)
    sdirty = rng.random(cap) < 0.2
    stored = rng.random(cap) < 0.2
    ref = rjoin.JoinSide(
        rt, {k: jnp.asarray(v) for k, v in rows.items()},
        {k: jnp.asarray(v) for k, v in nulls.items()}, jnp.asarray(row_valid),
        jnp.zeros((), jnp.bool_), jnp.zeros((), jnp.bool_), jnp.asarray(sdirty),
        jnp.asarray(stored), jnp.asarray(degree),
    )
    port = pjoin.JoinSide(
        pt, {k: torch.from_numpy(v.copy()) for k, v in rows.items()},
        {k: torch.from_numpy(v.copy()) for k, v in nulls.items()},
        torch.from_numpy(row_valid.copy()), torch.zeros((), dtype=torch.bool),
        torch.zeros((), dtype=torch.bool), torch.from_numpy(sdirty.copy()),
        torch.from_numpy(stored.copy()), torch.from_numpy(degree.copy()),
    )
    return ref, port


@pytest.mark.parametrize("cutoff", [35_000, 80_000], ids=["half", "all"])
def test_join_side_expiry_matches_reference(cutoff):
    """``ops.join.expire_keys``: live, sdirty, row_valid, degree and
    payload lanes equal, and the side's digest."""
    ref, port = _sides(np.random.default_rng(cutoff))
    ref = rjoin.expire_keys(ref, 1, jnp.asarray(cutoff, jnp.int64))
    port = pjoin.expire_keys(port, 1, cutoff)
    _table_lanes_equal(ref.table, port.table)
    for name in ("row_valid", "degree", "sdirty", "stored"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(port.rows["v"].numpy(), np.asarray(ref.rows["v"]))
    want = ref_integrity.host_digest(*ref_integrity.join_side_lanes(ref, np.where))
    got = integrity.host_digest(*integrity.host_lanes(*integrity.join_side_lanes(port)))
    assert got == want
    assert int(port.row_valid.sum()) < int(_sides(np.random.default_rng(cutoff))[1]
                                           .row_valid.sum())


@pytest.mark.parametrize("emit_deletes", [False, True], ids=["forget", "delete"])
def test_agg_expiry_matches_reference(emit_deletes):
    """HashAgg's ``_expire`` in both modes over every agg kind (float
    MIN/MAX among them, in order-key form): every state lane and the
    live lane equal after the expiry, the digests equal, and the next
    flush emits the same delta (Deletes for the closed groups that were
    emitted, with ``delete_groups``; nothing for them with
    ``forget_groups``)."""
    rng = np.random.default_rng(31 + emit_deletes)
    rcalls, pcalls = _calls(CALLS)
    rs = ragg.create_state(CAP, rcalls, REF_DTYPES)
    ps = pagg.create_state(CAP, pcalls, PORT_DTYPES, device="cpu")
    rfx = ragg.float_extreme_meta(rcalls, REF_DTYPES)
    pfx = pagg.float_extreme_meta(pcalls, PORT_DTYPES)
    keys = (np.arange(CAP, dtype=np.int64) % 9 * WINDOW,)
    names = ["key0"] + [c[2] for c in CALLS]
    names += [c[2] + "__isnull" for c in CALLS if c[0] in ("sum", "min", "max")]
    for _ in range(2):
        rs, ps = _apply_both(rs, ps, rcalls, pcalls, *_batch(rng, 300, False))
        rs, ps, _ = _flush_both(rs, ps, keys, 1 << 9, rfx, pfx, names)
    rs, ps = _apply_both(rs, ps, rcalls, pcalls, *_batch(rng, 300, False))  # pending dirt
    live = ps.row_count.numpy() > 0
    fp1 = np.where(live | ps.emitted_valid.numpy(), 7, 0).astype(np.uint32)
    rt = rht.HashTable(jnp.asarray(fp1), jnp.asarray(fp1), (jnp.asarray(keys[0]),),
                       jnp.asarray(live))
    pt = pht.HashTable.from_reference_arrays(fp1, fp1, keys, live, device="cpu")
    cutoff = 4 * WINDOW
    rt, rs = rha._expire(rt, rs, jnp.asarray(cutoff, jnp.int64), rcalls, 0, emit_deletes)
    pha._expire(pt, ps, cutoff, pcalls, 0, emit_deletes, pfx)
    _assert_states_equal(rs, ps, dict(pfx))
    np.testing.assert_array_equal(pt.live.numpy(), np.asarray(rt.live))
    want = ref_integrity.host_digest(*(
        lambda lanes, live: ({k: np.asarray(v) for k, v in lanes.items()}, np.asarray(live))
    )(*ref_integrity.agg_lanes(rt, rs)))
    assert integrity.host_digest(*integrity.host_lanes(*integrity.agg_lanes(pt, ps, pfx))) == want
    expired = live & (keys[0] < cutoff)
    assert expired.any() and not pt.live.numpy()[expired].any()
    rs, ps, _ = _flush_both(rs, ps, keys, 1 << 9, rfx, pfx, names)
    _assert_states_equal(rs, ps, dict(pfx))


def test_reset_groups_is_cpu_only():
    _, pcalls = _calls(CALLS)
    ps = pagg.create_state(8, pcalls, PORT_DTYPES, device="cpu")
    pagg.forget_groups(ps, pcalls, torch.tensor([1, -1], dtype=torch.int32))
    assert bool(ps.sdirty[1]) and not bool(ps.sdirty[0])
    pagg.delete_groups(ps, pcalls, torch.tensor([0], dtype=torch.int32))
    assert bool(ps.dirty[0])
    meta = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="kernel O"):
        pagg._reset_groups(ps, pcalls, meta, mark_dirty=True)


def _chunk(cols, cap=64):
    return StreamChunk.from_numpy({k: np.asarray(v, np.int64) for k, v in cols.items()}, cap,
                                  device="cpu")


def _collect(outs, got, names):
    for o in outs:
        d = o.to_numpy()
        for i in range(len(d["__op__"])):
            got[tuple(int(d[n][i]) for n in names)] += 1 if d["__op__"][i] in (0, 3) else -1


def test_join_growth_and_watermark_expiry():
    """The expiry half of test_hash_join.py's growth-and-watermark case
    on the port, beside the reference executor: after growth, a
    watermark on the left window column drops the closed keys of the
    left side (same live count as the reference), emits no downstream
    watermark until the right side passes one too, then the aligned
    minimum."""
    names = ("lk", "lw", "lv", "rk", "rw", "rv")
    kw = dict(capacity=1 << 6, fanout=4, out_cap=1 << 12, window_cols=("lw", "rw"))
    ex = HashJoinExecutor(("lk", "lw"), ("rk", "rw"),
                          {"lk": torch.int64, "lw": torch.int64, "lv": torch.int64},
                          {"rk": torch.int64, "rw": torch.int64, "rv": torch.int64},
                          device="cpu", **kw)
    ref = RefJoin(("lk", "lw"), ("rk", "rw"),
                  {"lk": jnp.int64, "lw": jnp.int64, "lv": jnp.int64},
                  {"rk": jnp.int64, "rw": jnp.int64, "rv": jnp.int64}, **kw)
    got = collections.Counter()
    n_keys = 300
    for start in range(0, n_keys, 50):
        ks = np.arange(start, start + 50, dtype=np.int64)
        lc = {"lk": ks, "lw": ks % 4, "lv": ks * 2}
        rc = {"rk": ks, "rw": ks % 4, "rv": ks * 3}
        _collect(ex.apply_left(_chunk(lc)), got, names)
        _collect(ex.apply_right(_chunk(rc)), got, names)
        ref.apply_left(RefChunk.from_numpy(lc, 64))
        ref.apply_right(RefChunk.from_numpy(rc, 64))
    ex.on_barrier(None)
    ref.on_barrier(Barrier(Epoch(0, 1)))
    ref.finish_barrier()
    assert len(got) == n_keys and ex.left.capacity >= n_keys
    assert ex.on_watermark(PortWatermark("lw", 2)) == (None, [])
    ref.on_watermark(Watermark("lw", 2))
    live_left = int(ex.left.table.num_live())
    assert live_left == len([k for k in range(n_keys) if k % 4 >= 2])
    assert live_left == int(ref.left.table.num_live())
    assert ex.side_digests()[0] == ref_integrity.host_digest(
        *ref_integrity.join_side_lanes(ref.left, np.where))
    assert ex.on_watermark(PortWatermark("rw", 1)) == (PortWatermark("lw", 1), [])
    assert ex.on_watermark(PortWatermark("rw", 1)) == (None, [])  # no new minimum
    assert ex.on_watermark(PortWatermark("lv", 9)) == (PortWatermark("lv", 9), [])


@pytest.mark.parametrize("emit_deletes", [False, True], ids=["eowc", "retracting"])
def test_agg_executor_watermark_matches_reference(emit_deletes):
    """``HashAggExecutor.on_watermark`` in both modes, beside the
    reference executor: the watermark's own output (the EOWC flush of
    the dirty groups, or nothing), the next barrier's flush (the
    retracting mode's Deletes), every state lane, the dirty bound and
    the cleaning watermark equal; a watermark on another column passes
    through untouched."""
    calls = (("count_star", None, "n"), ("max", "f", "mxf"), ("sum", "v", "sv"))
    kw = dict(capacity=256, out_cap=64, window_key=("w", 5_000, emit_deletes))
    ref = rha.HashAggExecutor(("k", "w"), tuple(ragg.AggCall(*c) for c in calls),
                              {"k": jnp.int64, "w": jnp.int64, "f": jnp.float64, "v": jnp.int64},
                              **kw)
    port = pha.HashAggExecutor(("k", "w"), tuple(pagg.AggCall(*c) for c in calls),
                               {"k": torch.int64, "w": torch.int64, "f": torch.float64,
                                "v": torch.int64}, device="cpu", **kw)
    rng = np.random.default_rng(3 + emit_deletes)

    def rows(outs):
        out = []
        for c in outs:
            d = c.to_numpy()
            out += sorted(zip(*(np.asarray(d[k]).tolist() for k in sorted(d))))
        return out

    for e, value in enumerate((20_000, 40_000, 60_000)):
        for _ in range(2):
            cols = {"k": rng.integers(0, 20, 100), "w": rng.integers(0, 8, 100) * WINDOW,
                    "f": rng.standard_normal(100), "v": rng.integers(-50, 50, 100)}
            ref.apply(RefChunk.from_numpy(cols, 128))
            port.apply(StreamChunk.from_numpy(cols, 128, device="cpu"))
        if e:  # the first watermark meets dirty groups; the later ones a flushed state
            assert rows(port.on_barrier(None)) == rows(ref.on_barrier(Barrier(Epoch(e, e + 1))))
            ref.finish_barrier()
        r_wm, r_out = ref.on_watermark(Watermark("w", value))
        p_wm, p_out = port.on_watermark(PortWatermark("w", value))
        assert (p_wm.column, p_wm.value) == (r_wm.column, r_wm.value)
        assert rows(p_out) == rows(r_out)
        assert port._dirty_bound == ref._dirty_bound
        assert port.cleaning_watermarks() == ref.cleaning_watermarks()
        np.testing.assert_array_equal(port.table.live.numpy(), np.asarray(ref.table.live))
        _assert_states_equal(ref.state, port.state, dict(port._float_extremes))
    final = rows(port.on_barrier(None))
    assert final == rows(ref.on_barrier(Barrier(Epoch(9, 10))))
    assert any(r[0] == 1 for r in final) == emit_deletes  # Deletes of the closed windows
    wm = PortWatermark("k", 1)
    assert port.on_watermark(wm) == (wm, [])
