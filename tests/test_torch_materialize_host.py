"""The host MV (``MaterializeExecutor``) and the temporal join's host
probe through the port against ``risingwave_tpu`` on JAX-CPU.

Both packages take the same seeded chunks (inserts, updates as U-/U+,
deletes, deletes of absent keys, pks repeated within a chunk) with each
backend: the native C++ row map (integer, NULL-free columns) and the
Python dict (pinned on both, or chosen by float or NULL columns, or by
a NULL cell that moves a native map to the dict mid-stream). Held
equal: ``apply``'s returned chunks (a conflict-resolving MV's
emissions), ``snapshot``, ``to_numpy``, each ``checkpoint_delta``,
``state_digest``, a restore from each package's own store and the
restored map's backend, ``state_nbytes``; and the temporal join probing
a host MV, inner and left, with NULL keys, lane for lane.

Tolerance: none; every value is compared exactly (floats bit for bit).
"""

import numpy as np
import pytest

from risingwave_tpu.executors.materialize import MaterializeExecutor as RefMv
from risingwave_tpu.executors.temporal_join import TemporalJoinExecutor as RefTj
from risingwave_tpu.storage import CheckpointManager as RefManager
from risingwave_tpu.storage import MemObjectStore as RefStore
from risingwave_tpu_torch import native
from risingwave_tpu_torch.executors.materialize import MaterializeExecutor
from risingwave_tpu_torch.executors.temporal_join import TemporalJoinExecutor
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore
from risingwave_tpu_torch.types import Op
from test_torch_project_set import both
from test_torch_temporal_join import assert_probe_equal


def chunk_rows(rng, n, keys, floats=False, nulls=False, cap=None):
    cols = {"a": rng.integers(0, keys, n).astype(np.int64),
            "b": rng.integers(0, 3, n).astype(np.int32),
            "v": rng.integers(-10**9, 10**9, n).astype(np.int64),
            "w": (rng.standard_normal(n) if floats else rng.integers(0, 99, n)).astype(
                np.float64 if floats else np.int32)}
    ops = rng.choice([Op.INSERT, Op.DELETE, Op.UPDATE_DELETE, Op.UPDATE_INSERT], n,
                     p=[0.55, 0.2, 0.1, 0.15]).astype(np.int32)
    nl = {"v": rng.random(n) < 0.2} if nulls else None
    return both(cols, cap or n, ops=ops, nulls=nl)


def make(backend, conflict=False):
    kw = dict(pk=("a", "b"), columns=("v", "w"), table_id="hmv", conflict_resolve=conflict)
    port, ref = MaterializeExecutor(**kw), RefMv(**kw)
    if backend == "python":
        port._force_python = ref._force_python = True
    return port, ref


def emitted(chunks):
    out = []
    for c in chunks:
        d = c.to_numpy(with_ops=True)
        out.append({k: np.asarray(v).tolist() for k, v in sorted(d.items())})
    return out


def assert_deltas_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.table_id == w.table_id and g.key_order == w.key_order
        for part in ("key_cols", "value_cols"):
            gp, wp = getattr(g, part), getattr(w, part)
            assert gp.keys() == wp.keys()
            for k in gp:
                assert gp[k].dtype == np.asarray(wp[k]).dtype, k
                np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)
        np.testing.assert_array_equal(g.tombstone, w.tombstone)


def assert_same(port, ref):
    assert port._backend == ref._backend
    assert port.snapshot() == ref.snapshot()
    gp, wp = port.to_numpy(), ref.to_numpy()
    assert gp.keys() == wp.keys()
    order_g = np.lexsort([gp[k] for k in reversed(port.pk)]) if len(gp["a"]) else []
    order_w = np.lexsort([wp[k] for k in reversed(ref.pk)]) if len(wp["a"]) else []
    for k in gp:
        np.testing.assert_array_equal(np.asarray(gp[k])[order_g], np.asarray(wp[k])[order_w])
    assert port.state_digest() == ref.state_digest()
    assert port.state_nbytes() == ref.state_nbytes()


CASES = {  # backend, floats, nulls, conflict resolution
    "native": ("auto", False, False, False),
    "python": ("python", False, False, False),
    "python_floats": ("auto", True, False, False),
    "native_then_null": ("auto", False, "late", False),
    "conflict": ("auto", True, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_mv_matches_reference(case):
    """Apply, snapshot, to_numpy, digest and each checkpoint's delta equal
    the reference's at every barrier; then both recover from their own
    stores into the same map and backend and continue equal."""
    backend, floats, nulls, conflict = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    port, ref = make(backend, conflict)
    pm, rm = CheckpointManager(MemObjectStore()), RefManager(RefStore())
    port.checkpoint_enabled = ref.checkpoint_enabled = True
    for epoch in range(4):
        for _ in range(3):
            with_nulls = nulls is True or (nulls == "late" and epoch == 2)
            lp, lr = chunk_rows(rng, 40, 30, floats, with_nulls, cap=64)
            assert emitted(port.apply(lp)) == emitted(ref.apply(lr))
        port.on_barrier(None)
        ref.on_barrier(None)
        assert_same(port, ref)
        assert_deltas_equal(port.checkpoint_delta(), ref.checkpoint_delta())
    if nulls == "late":
        assert port._backend == "python"
    elif backend == "auto" and not floats:
        assert port._backend == "native"
    # both commit the whole state and recover into fresh executors
    p2, r2 = make(backend, conflict)
    p3, r3 = make(backend, conflict)
    for mgr, ex, fresh in ((pm, port, p2), (rm, ref, r2)):
        ex._changed.update(ex.snapshot())  # every row, whatever the backend
        ex._pending = []
        if ex._backend == "native":
            keys, vals = ex._native.dump()
            ex._pending = [(keys, vals, np.zeros(len(keys), np.uint8))]
        mgr.commit_epoch(1 << 16, [ex])
        mgr.recover([fresh])
    assert_same(p2, r2)
    assert p2.snapshot() == port.snapshot()
    lp, lr = chunk_rows(rng, 40, 30, floats, nulls is True, cap=64)
    assert emitted(p2.apply(lp)) == emitted(r2.apply(lr))
    assert_same(p2, r2)


def test_native_library_builds_from_the_ports_source():
    """The row map is the port's own copy of the C++ source, built with
    g++ into the git-ignored build directory, and agrees with the dict."""
    lib = native.get_lib()
    assert lib is not None
    m = native.NativeMvMap(2, 1)
    keys = np.array([[1, 2], [3, 4], [1, 2]], np.int64)
    m.apply(keys, np.array([[5], [6], [7]], np.int64), np.array([0, 0, 0], np.uint8))
    assert len(m) == 2 and m.get([1, 2]) == (7,) and m.get([9, 9]) is None
    m.apply(keys[:1], np.array([[0]], np.int64), np.array([1], np.uint8))
    assert len(m) == 1 and m.get([1, 2]) is None


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("jt", ["inner", "left"])
def test_temporal_join_host_probe_matches_reference(jt, backend):
    """``_probe_host`` against a host MV: every lane of the enriched
    chunk equal to the reference's, NULL keys never matching, misses
    dropped (inner) or NULL-padded (left), after updates and deletes."""
    rng = np.random.default_rng(5)
    kw = dict(pk=("id",), columns=("seller", "category"), table_id="dim")
    mv, rmv = MaterializeExecutor(**kw), RefMv(**kw)
    if backend == "python":
        mv._force_python = rmv._force_python = True
    for step in range(3):
        n = 24
        cols = {"id": rng.integers(0, 40, n).astype(np.int64),
                "seller": rng.integers(0, 50, n).astype(np.int64),
                "category": rng.integers(0, 9, n).astype(np.int64)}
        ops = np.where(rng.random(n) < 0.25, Op.DELETE, Op.INSERT).astype(np.int32)
        p, r = both(cols, 32, ops=ops)
        mv.apply(p)
        rmv.apply(r)
        lcols = {"auction": rng.integers(0, 40, 48).astype(np.int64),
                 "price": rng.integers(1, 1000, 48).astype(np.int64)}
        lnulls = {"auction": rng.random(48) < 0.15}
        lp, lr = both(lcols, 64, ops=np.zeros(48, np.int32), nulls=lnulls)
        (got,) = TemporalJoinExecutor(mv, ("auction",), ("seller", "category"), jt).apply(lp)
        (want,) = RefTj(rmv, ("auction",), ("seller", "category"), jt).apply(lr)
        assert_probe_equal(got, want, f"{jt} {backend} step {step}")
        assert int(got.valid.sum()) > 0
