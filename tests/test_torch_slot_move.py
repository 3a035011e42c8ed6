"""Kernel I parity: the table rebuilds (``_rehash``, ``_mv_rebuild``)
and their lane moves (``ops.hash_table.move_slots``).

The port's agg rebuild runs on the same numpy-seeded table and state as
``risingwave_tpu.executors.hash_agg._rehash`` and must give the same
lanes, down to the slot. Kernel I's wrapper is checked without a card:
``_kernels.call`` is replaced by a ``ctypes`` callback of the entry
point's declared signature that does the move on the CPU memory behind
the pointers, so the descriptor rows, pointers and lane split the
wrapper passes are the ones the CUDA entry point would read. Every
comparison is exact.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.executors import hash_agg as ref_agg_ex
from risingwave_tpu.ops import agg as ref_agg
from risingwave_tpu.ops import hash_table as ref_ht
from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.executors import hash_agg as port_agg_ex
from risingwave_tpu_torch.executors import materialize as port_mv
from risingwave_tpu_torch.ops import agg as port_agg
from risingwave_tpu_torch.ops import hash_table as port_ht

CAP = 1 << 9
NEW_CAP = 1 << 11
CALLS = (
    ("count_star", None, "n"),
    ("sum", "v", "sv"),
    ("min", "v", "mnv"),
    ("max", "f", "mxf"),
)
REF_DTYPES = {"v": jnp.int64, "f": jnp.float64}
PORT_DTYPES = {"v": torch.int64, "f": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_agg(seed):
    """A reference table with random keys and a state whose marks
    (live, emitted, dirty, sdirty, stored) are random on the claimed
    slots, so some slots survive the rebuild and some do not."""
    rng = np.random.default_rng(seed)
    rcalls = tuple(ref_agg.AggCall(*c) for c in CALLS)
    n_keys = CAP // 3
    keys = (
        rng.choice(10**9, n_keys, replace=False).astype(np.int64),
        rng.integers(0, 5, n_keys).astype(np.int32),
    )
    table = ref_ht.HashTable.create(CAP, (jnp.int64, jnp.int32))
    table, _, _, _ = ref_ht.lookup_or_insert(
        table, tuple(jnp.asarray(k) for k in keys), jnp.ones(n_keys, jnp.bool_)
    )
    table, state = jax.device_get((table, ref_agg.create_state(CAP, rcalls, REF_DTYPES)))
    claimed = np.asarray(table.fp1) != 0
    mark = lambda p: claimed & (rng.random(CAP) < p)
    row_count = np.where(claimed, rng.integers(0, 4, CAP), 0).astype(np.int64)
    live = row_count > 0
    rand64 = lambda: np.where(claimed, rng.integers(-(10**12), 10**12, CAP), 0).astype(np.int64)
    randu64 = np.where(claimed, rng.integers(0, 2**63, CAP, dtype=np.uint64), 0).astype(np.uint64)
    accums = {"n": row_count.copy(), "sv": rand64(), "mnv": rand64(), "mxf": randu64}
    emitted = {"n": rand64(), "sv": rand64(), "mnv": rand64(), "mxf": randu64[::-1].copy()}
    state = dataclasses.replace(
        state,
        row_count=row_count,
        accums={k: accums[k].astype(np.asarray(v).dtype) for k, v in state.accums.items()},
        nonnull={k: rng.integers(0, 3, CAP).astype(np.int64) for k in state.nonnull},
        emitted={k: emitted[k].astype(np.asarray(v).dtype) for k, v in state.emitted.items()},
        emitted_isnull={k: mark(0.3) for k in state.emitted_isnull},
        emitted_valid=mark(0.4),
        dirty=mark(0.2),
        sdirty=mark(0.2),
        stored=mark(0.5),
    )
    table = dataclasses.replace(table, live=live)
    return rcalls, table, state


def _port_agg(table, state):
    pcalls = tuple(port_agg.AggCall(*c) for c in CALLS)
    fx = port_agg.float_extreme_meta(pcalls, PORT_DTYPES)
    pt = port_ht.HashTable.from_reference_arrays(
        table.fp1, table.fp2, table.keys, table.live, device="cpu"
    )
    ps = port_agg.AggState.from_reference_arrays(state, fx, device="cpu")
    return pcalls, fx, pt, ps


def _port_state_as_reference(state, fx):
    fx = dict(fx)
    out = {"row_count": state.row_count.numpy()}
    for group in ("accums", "emitted"):
        for name, lane in getattr(state, group).items():
            a = lane.numpy()
            if name in fx:
                a = port_agg.order_key_to_reference(a, np.dtype(str(fx[name]).split(".")[1]))
            out[f"{group}.{name}"] = a
    for group in ("nonnull", "emitted_isnull"):
        for name, lane in getattr(state, group).items():
            out[f"{group}.{name}"] = lane.numpy()
    for name in ("emitted_valid", "dirty", "minmax_retracted", "sdirty", "stored"):
        out[name] = getattr(state, name).numpy()
    return out


def _ref_state_lanes(state):
    out = {"row_count": np.asarray(state.row_count)}
    for group in ("accums", "emitted", "nonnull", "emitted_isnull"):
        for name, lane in getattr(state, group).items():
            out[f"{group}.{name}"] = np.asarray(lane)
    for name in ("emitted_valid", "dirty", "minmax_retracted", "sdirty", "stored"):
        out[name] = np.asarray(getattr(state, name))
    return out


def _assert_tables_equal(pt, rt):
    np.testing.assert_array_equal(pt.fp1.numpy().view(np.uint32), np.asarray(rt.fp1))
    np.testing.assert_array_equal(pt.fp2.numpy().view(np.uint32), np.asarray(rt.fp2))
    np.testing.assert_array_equal(pt.live.numpy(), np.asarray(rt.live))
    for a, b in zip(pt.keys, rt.keys):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _emulated_slot_move(new_cap):
    """``rw_slot_move`` done on the CPU behind a ctypes callback of its
    declared signature; returns the callback and its launch log."""
    log = []

    def entry(lanes, n_lanes, n, new_slots, keep, stream):
        rows = (ctypes.c_int64 * (3 * n_lanes)).from_address(lanes)
        keep_a = np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(keep)) != 0
        slots_a = np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(new_slots))
        ok = keep_a & (slots_a >= 0)
        for k in range(n_lanes):
            src, dst, es = rows[3 * k], rows[3 * k + 1], rows[3 * k + 2]
            ct = {1: ctypes.c_uint8, 4: ctypes.c_uint32, 8: ctypes.c_uint64}[es]
            s = np.ctypeslib.as_array((ct * n).from_address(src))
            d = np.ctypeslib.as_array((ct * new_cap).from_address(dst))
            d[slots_a[ok]] = s[ok]
        log.append(n_lanes)
        return 0

    proto = ctypes.CFUNCTYPE(ctypes.c_int, *_kernels.SIGNATURES["slot_move"]["rw_slot_move"])
    cb = proto(entry)

    def call(name, fn, *args):
        assert (name, fn) == ("slot_move", "rw_slot_move")
        assert cb(*args, None) == 0
        _kernels.LAUNCHES[name] += 1

    return call, log


@pytest.fixture
def kernel_i_on_cpu(monkeypatch):
    """Route ``move_slots`` through kernel I's wrapper with the emulated
    entry point (CPU tensors pass its checks but the device one)."""

    def check_cpu(name, *tensors, n=None):
        for t in tensors:
            assert t.is_contiguous(), name
            if n is not None:
                assert t.shape == (n,), name

    def setup(new_cap):
        call, log = _emulated_slot_move(new_cap)
        monkeypatch.setattr(_kernels, "call", call)
        monkeypatch.setattr(_kernels, "check_cuda", check_cpu)
        for mod in (port_agg_ex, port_mv):
            monkeypatch.setattr(mod, "move_slots", port_ht._move_slots_cuda)
        return log

    return setup


@pytest.mark.parametrize("seed", [3, 4])
def test_rehash_matches_reference(seed):
    rcalls, rt, rs = _ref_agg(seed)
    pcalls, fx, pt, ps = _port_agg(rt, rs)
    rt2, rs2, _ = ref_agg_ex._rehash(rt, rs, {}, rcalls, NEW_CAP)
    pt2, ps2, _ = port_agg_ex._rehash(pt, ps, {}, pcalls, NEW_CAP, fx)
    assert pt2.capacity == NEW_CAP
    _assert_tables_equal(pt2, jax.device_get(rt2))
    r, p = _ref_state_lanes(jax.device_get(rs2)), _port_state_as_reference(ps2, fx)
    assert r.keys() == p.keys()
    for k in r:
        np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    keep = rs.dirty | rs.sdirty | rs.emitted_valid | rt.live
    assert 0 < int(ps2.row_count.count_nonzero()) and int(keep.sum()) < int((rt.fp1 != 0).sum())


def test_kernel_i_wrapper_rehash_equals_plain(kernel_i_on_cpu):
    _, rt, rs = _ref_agg(5)
    pcalls, fx, pt, ps = _port_agg(rt, rs)
    want_t, want_s, _ = port_agg_ex._rehash(pt, ps, {}, pcalls, NEW_CAP, fx)
    log = kernel_i_on_cpu(NEW_CAP)
    _kernels.reset_launches()
    got_t, got_s, _ = port_agg_ex._rehash(pt, ps, {}, pcalls, NEW_CAP, fx)
    assert _kernels.LAUNCHES["slot_move"] == 1 and log == [2 + 2 * 4 + 2 * 3 + 4]  # live, row_count; accums, emitted;
    # nonnull, emitted_isnull of the three nullable calls; four marks
    assert torch.equal(got_t.live, want_t.live) and torch.equal(got_t.fp1, want_t.fp1)
    g, w = _port_state_as_reference(got_s, fx), _port_state_as_reference(want_s, fx)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_kernel_i_wrapper_mv_rebuild_equals_plain(kernel_i_on_cpu):
    rng = np.random.default_rng(6)
    dtypes = {"k": torch.int64, "x": torch.int64, "y": torch.int32}
    mv = port_mv.DeviceMaterializeExecutor(
        ("k",), ("x", "y"), dtypes, capacity=CAP, nullable=("y",), device="cpu"
    )
    from risingwave_tpu_torch.array.chunk import StreamChunk

    n = CAP // 3
    cols = {
        "k": rng.integers(0, n, n).astype(np.int64),
        "x": rng.integers(-(10**12), 10**12, n).astype(np.int64),
        "y": rng.integers(0, 100, n).astype(np.int32),
    }
    ops = rng.choice([0, 1], n, p=[0.7, 0.3]).astype(np.int32)
    chunk = StreamChunk.from_numpy(cols, n, ops=ops, nulls={"y": rng.random(n) < 0.3}, device="cpu")
    mv.table, mv.state = port_mv.mv_step_fn(mv.table, mv.state, chunk, mv.pk, mv.columns)
    mv.state.sdirty[: CAP // 2] = False  # some tombstones no one needs
    want_t, want_s = port_mv._mv_rebuild(mv.table, mv.state, NEW_CAP)
    log = kernel_i_on_cpu(NEW_CAP)
    got_t, got_s = port_mv._mv_rebuild(mv.table, mv.state, NEW_CAP)
    assert log == [1 + 2 + 1 + 2]  # live, values x, y, null lane y, sdirty, stored
    assert torch.equal(got_t.live, want_t.live)
    for a, b in ((got_s.values, want_s.values), (got_s.vnulls, want_s.vnulls)):
        assert all(torch.equal(a[c], b[c]) for c in b)
    assert torch.equal(got_s.sdirty, want_s.sdirty) and torch.equal(got_s.stored, want_s.stored)


def test_kernel_i_wrapper_splits_long_lane_lists(kernel_i_on_cpu):
    rng = np.random.default_rng(7)
    n, new_cap = 300, 1 << 10
    keep = torch.from_numpy(rng.random(n) < 0.6)
    perm = rng.permutation(new_cap)[:n].astype(np.int32)
    perm[rng.random(n) < 0.1] = -1  # kept slots the new table dropped
    slots = torch.from_numpy(perm)
    dts = (torch.bool, torch.int32, torch.int64, torch.float32, torch.float64)
    srcs = [torch.from_numpy(rng.integers(0, 2**31, n)).to(dts[i % 5]) for i in range(30)]
    want = [torch.full((new_cap,), 7, dtype=s.dtype) for s in srcs]
    got = [w.clone() for w in want]
    port_ht._move_slots_torch(srcs, want, slots, keep)
    log = kernel_i_on_cpu(new_cap)
    _kernels.reset_launches()
    port_ht._move_slots_cuda(srcs, got, slots, keep)
    assert log == [24, 6] and _kernels.LAUNCHES["slot_move"] == 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        port_ht._move_slots_cuda(srcs[:1], [want[1]], slots, keep)
