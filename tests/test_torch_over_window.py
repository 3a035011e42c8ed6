"""Kernels AD, AE and AF and the three over-window executors: the port's
plain PyTorch versions (``risingwave_tpu_torch/executors/over_window.py``)
against ``risingwave_tpu.executors.over_window`` on JAX-CPU, on the same
seeded inputs, and the reference's own cases (``tests/test_over_window.py``,
``tests/test_general_over_window.py``) run on both packages side by side.

On the CPU the port's hash table places keys in the reference's slots,
so every emission compares row for row (the append-only step's chunk,
the EOWC emission in its sorted order, the general executor's retract
and insert chunks in slot order), accumulator and arena lanes slot for
slot, digests and checkpoint deltas exactly. Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_general_over_window as rgo
import test_over_window as row_
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import over_window as rov
from risingwave_tpu.executors.base import Watermark as RefWatermark
from risingwave_tpu.ops import hash_table as rht
from risingwave_tpu.storage.object_store import MemObjectStore as RefStore
from risingwave_tpu.storage.state_table import CheckpointManager as RefManager
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import over_window as pov
from risingwave_tpu_torch.executors.base import Watermark
from risingwave_tpu_torch.ops import hash_table as pht
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore

IMAX, IMIN = np.iinfo(np.int64).max, np.iinfo(np.int64).min
RT = {"i64": jnp.int64, "i32": jnp.int32}
PT = {"i64": torch.int64, "i32": torch.int32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dt(spec, pkg):
    table = RT if pkg == "ref" else PT
    return {k: table[v] for k, v in spec.items()}


def _calls(pkg, specs):
    mod = rov if pkg == "ref" else pov
    return tuple(mod.WindowCall(*s[:3], **(s[3] if len(s) > 3 else {})) for s in specs)


def _pair(cols, cap, ops=None, nulls=None):
    ops = None if ops is None else np.asarray(ops, np.int32)
    cols = {k: np.asarray(v) for k, v in cols.items()}
    return (RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls),
            StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu"))


def _same_chunk(r, p, keep=None):
    """Equal valid rows, column for column (``keep`` masks the rows
    compared, in valid-row order)."""
    dr, dp = r.to_numpy(), p.to_numpy()
    assert sorted(dr) == sorted(dp)
    for k in dr:
        a, b = np.asarray(dr[k]), dp[k]
        if keep is not None:
            a, b = a[keep], b[keep]
        np.testing.assert_array_equal(b, a, err_msg=k)
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(r.valid))
    np.testing.assert_array_equal(p.ops.numpy(), np.asarray(r.ops))


def _same_outs(ro, po):
    assert len(ro) == len(po)
    for r, p in zip(ro, po):
        _same_chunk(r, p)


def _same_deltas(rd, pd):
    assert len(rd) == len(pd)
    for r, p in zip(rd, pd):
        assert (p.table_id, p.key_order) == (r.table_id, r.key_order)
        assert p.key_cols.keys() == r.key_cols.keys()
        assert p.value_cols.keys() == r.value_cols.keys()
        for k in r.key_cols:
            np.testing.assert_array_equal(p.key_cols[k], np.asarray(r.key_cols[k]))
        for k in r.value_cols:
            np.testing.assert_array_equal(p.value_cols[k], np.asarray(r.value_cols[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(p.tombstone, np.asarray(r.tombstone))


def _twins(kind, calls, dtypes, **kw):
    """The same executor from both packages."""
    cls = {"append": "OverWindowExecutor", "eowc": "EowcOverWindowExecutor",
           "general": "GeneralOverWindowExecutor"}[kind]
    args = {"append": lambda pkg: (kw["partition_by"], _calls(pkg, calls), _dt(dtypes, pkg)),
            "eowc": lambda pkg: (kw["partition_by"], kw["order_col"], _calls(pkg, calls),
                                 _dt(dtypes, pkg)),
            "general": lambda pkg: (kw["partition_by"], kw["order_col"], kw["pk"],
                                    _calls(pkg, calls), _dt(dtypes, pkg))}[kind]
    extra = {k: v for k, v in kw.items() if k not in ("partition_by", "order_col", "pk")}
    return (getattr(rov, cls)(*args("ref"), **extra),
            getattr(pov, cls)(*args("port"), device="cpu", **extra))


def _apply(r, p, cols, cap, ops=None, nulls=None, keep=None):
    rc, pc = _pair(cols, cap, ops, nulls)
    ro, po = r.apply(rc), p.apply(pc)
    assert len(ro) == len(po)
    for a, b in zip(ro, po):
        _same_chunk(a, b, keep)
    assert p.state_digest() == r.state_digest()
    return po


def _barrier(r, p, match=None):
    if match is None:
        r.on_barrier(None)
        p.on_barrier(None)
        return
    for ex in (r, p):
        with pytest.raises(RuntimeError, match=match):
            ex.on_barrier(None)


def _rows(outs, names):
    got = []
    for out in outs:
        d = out.to_numpy()
        for i in range(len(d[names[0]])):
            got.append(tuple(None if d.get(n + "__null") is not None and d[n + "__null"][i]
                             else int(d[n][i]) for n in names))
    return got


# -- the cases of tests/test_over_window.py --------------------------------------
def _case_running_min_max_and_lag():
    calls = (("min", "x", "rmin"), ("max", "x", "rmax"), ("lag", "x", "prev"))
    r, p = _twins("append", calls, {"p": "i64", "x": "i64"}, partition_by=("p",),
                  capacity=1 << 8)
    rng = np.random.default_rng(7)
    got, hist, want = [], {}, []
    for _ in range(6):
        n = int(rng.integers(3, 30))
        ps, xs = rng.integers(0, 4, n), rng.integers(-50, 50, n)
        (out,) = _apply(r, p, {"p": ps, "x": xs}, 32)
        got += _rows([out], ("p", "rmin", "rmax", "prev"))
        for pp, x in zip(ps.tolist(), xs.tolist()):
            seen = hist.setdefault(pp, [])
            prev = seen[-1] if seen else None
            seen.append(x)
            want.append((pp, min(seen), max(seen), prev))
    assert got == want


def _case_rank_dense_rank_ordered_arrivals():
    calls = (("rank", "x", "rk"), ("dense_rank", "x", "drk"), ("row_number", None, "rn"))
    r, p = _twins("append", calls, {"p": "i64", "x": "i64"}, partition_by=("p",),
                  capacity=1 << 8)
    rng = np.random.default_rng(3)
    cur = {q: 0 for q in range(4)}
    hist, want, got = {}, [], []
    for _ in range(5):
        n = int(rng.integers(4, 24))
        ps = rng.integers(0, 4, n)
        xs = []
        for q in ps.tolist():
            cur[q] += int(rng.choice([0, 0, 1, 2]))
            xs.append(cur[q])
        (out,) = _apply(r, p, {"p": ps, "x": np.asarray(xs, np.int64)}, 32)
        got += _rows([out], ("p", "rk", "drk", "rn"))
        for q, x in zip(ps.tolist(), xs):
            seen = hist.setdefault(q, [])
            seen.append(x)
            want.append((q, 1 + sum(1 for v in seen if v < x),
                         len({v for v in seen if v < x}) + 1, len(seen)))
    _barrier(r, p)  # the ooo latch must not fire
    assert got == want


def _case_rank_out_of_order_raises():
    r, p = _twins("append", (("rank", "x", "rk"),), {"p": "i64", "x": "i64"},
                  partition_by=("p",), capacity=1 << 6)
    _apply(r, p, {"p": np.zeros(2, np.int64), "x": np.asarray([5, 3], np.int64)}, 8)
    _barrier(r, p, "out-of-order")


def _case_over_window_checkpoint_restore():
    calls = (("row_number", None, "rn"), ("sum", "x", "rs"), ("min", "x", "rmin"),
             ("lag", "x", "prev"), ("rank", "o", "rk"))
    dt = {"p": "i64", "x": "i64", "o": "i64"}
    rng = np.random.default_rng(9)
    cur = {q: 0 for q in range(5)}
    chunks = []
    for _ in range(6):
        n = int(rng.integers(4, 20))
        ps = rng.integers(0, 5, n)
        xs = rng.integers(-40, 40, n).astype(np.int64)
        os_ = []
        for q in ps.tolist():
            cur[q] += int(rng.choice([0, 1, 3]))
            os_.append(cur[q])
        chunks.append({"p": ps, "x": xs, "o": np.asarray(os_, np.int64)})
    mk = lambda: _twins("append", calls, dt, partition_by=("p",), capacity=1 << 7,
                        table_id="ow")
    r, p = mk()
    names = ("p", "rn", "rs", "rmin", "prev", "rk")
    whole = [_rows(_apply(r, p, c, 32), names) for c in chunks]
    r1, p1 = mk()
    for c in chunks[:3]:
        _apply(r1, p1, c, 32)
    rmgr, pmgr = RefManager(RefStore()), CheckpointManager(MemObjectStore())
    rs_, ps_ = rmgr.stage([r1]), pmgr.stage([p1])
    _same_deltas(rs_, ps_)
    rmgr.commit_staged(1, rs_)
    pmgr.commit_staged(1, ps_)
    r2, p2 = mk()
    rmgr.recover([r2])
    pmgr.recover([p2])
    assert p2.state_digest() == r2.state_digest() == p1.state_digest()
    rest = [_rows(_apply(r2, p2, c, 32), names) for c in chunks[3:]]
    _barrier(r2, p2)
    assert rest == whole[3:]


_EOWC_CALLS = (("row_number", None, "rn"), ("rank", "o", "rk"), ("dense_rank", "o", "drk"),
               ("lead", "x", "ld"), ("lag", "x", "lg"),
               ("sum", "x", "fsum", {"frame": (-2, 1)}), ("min", "x", "fmin", {"frame": (-2, 1)}))


def _case_eowc_over_window_lead_and_frames():
    dt = {"p": "i64", "w": "i64", "o": "i64", "x": "i64"}
    mk = lambda: _twins("eowc", _EOWC_CALLS, dt, partition_by=("w", "p"), order_col="o",
                        win_col="w", capacity=1 << 9, table_id="eow")
    rng = np.random.default_rng(21)
    all_rows, epochs = [], []
    for e in range(4):
        n = int(rng.integers(6, 28))
        rows = [{"p": int(rng.integers(0, 3)), "w": e // 2, "o": int(rng.integers(0, 6)),
                 "x": int(rng.integers(-20, 20))} for _ in range(n)]
        all_rows += rows
        epochs.append({k: np.asarray([q[k] for q in rows], np.int64) for k in dt})
    names = ("p", "w", "o", "x", "rn", "rk", "drk", "ld", "lg", "fsum", "fmin")

    def run(r, p, chunks, wms):
        got = []
        for c in chunks:
            _apply(r, p, c, 32)
        for v in wms:
            _, ro = r.on_watermark(RefWatermark("w", v))
            _, po = p.on_watermark(Watermark("w", v))
            _same_outs(ro, po)
            assert p.state_digest() == r.state_digest()
            got += [dict(zip(names, t)) for t in _rows(po, names)]
        return got

    r, p = mk()
    got = run(r, p, epochs, [1, 2])
    _barrier(r, p)
    want = row_._eowc_oracle(all_rows, None)
    key = lambda q: (q["w"], q["p"], q["o"], q["rn"])
    assert sorted(got, key=key) == sorted(want, key=key)
    # kill + recover between the two windows
    rmgr, pmgr = RefManager(RefStore()), CheckpointManager(MemObjectStore())
    r1, p1 = mk()
    got1 = run(r1, p1, epochs[:2], [1])
    rs_, ps_ = rmgr.stage([r1]), pmgr.stage([p1])
    _same_deltas(rs_, ps_)
    rmgr.commit_staged(1, rs_)
    pmgr.commit_staged(1, ps_)
    r2, p2 = mk()
    rmgr.recover([r2])
    pmgr.recover([p2])
    assert p2.state_digest() == r2.state_digest()
    got2 = run(r2, p2, epochs[2:], [2])
    assert sorted(got1 + got2, key=key) == sorted(want, key=key)


# -- the cases of tests/test_general_over_window.py ----------------------------------
_G_DT = {"id": "i64", "p": "i64", "o": "i64", "x": "i64"}


def _general(calls, capacity=1 << 9):
    return _twins("general", calls, _G_DT, partition_by=("p",), order_col="o", pk=("id",),
                  capacity=capacity, nullable=("x",))


def _drive(r, p, chunks_ops, calls, mv=None):
    """``rgo._drive`` on both executors: every emission equal, the MV kept
    from the port's retract/insert chunks."""
    mv = set() if mv is None else mv
    names = ("id", "p", "o", "x") + tuple(c[2] for c in calls)
    for ops_rows in chunks_ops:
        cols = {"id": [q[1] for q in ops_rows], "p": [q[2] for q in ops_rows],
                "o": [q[3] for q in ops_rows],
                "x": [0 if q[4] is None else q[4] for q in ops_rows]}
        cols = {k: np.asarray(v, np.int64) for k, v in cols.items()}
        nulls = {"x": np.asarray([q[4] is None for q in ops_rows], bool)}
        ops = np.asarray([0 if q[0] == "+" else 1 for q in ops_rows], np.int32)
        outs = _apply(r, p, cols, rgo.CAP, ops, nulls)
        for out in outs:
            d = out.to_numpy()
            for row, op in zip(_rows([out], names), d["__op__"].tolist()):
                if op == 1:
                    assert row in mv, f"retracting absent row {row}"
                    mv.remove(row)
                else:
                    assert row not in mv, f"double insert {row}"
                    mv.add(row)
        _barrier(r, p)
    return mv


def _oracle(rows, calls):
    return rgo._oracle(rows, _calls("ref", calls))


def _case_retractable_rank_and_frames_oracle():
    calls = (("row_number", None, "rn"), ("rank", "o", "rk"), ("dense_rank", "o", "dr"),
             ("sum", "x", "sx"), ("min", "x", "mn"), ("sum", "x", "fs", {"frame": (-1, 0)}),
             ("lead", "x", "ld"), ("lag", "x", "lg"))
    r, p = _general(calls)
    chunks, rows, _ = rgo._random_stream(np.random.default_rng(11), 8, {}, 0)
    assert _drive(r, p, chunks, calls) == _oracle(rows, calls)


def _case_rank_ties_and_ooo_arrivals():
    calls = (("rank", "o", "rk"), ("dense_rank", "o", "dr"), ("row_number", None, "rn"))
    r, p = _general(calls)
    chunks = [[("+", 0, 1, 30, 5), ("+", 1, 1, 20, 6), ("+", 2, 1, 30, 7)],
              [("+", 3, 1, 10, 8), ("+", 4, 1, 20, 9)],
              [("-", 1, 1, 20, 6)]]
    rows = {0: (1, 30, 5, 0), 2: (1, 30, 7, 2), 3: (1, 10, 8, 3), 4: (1, 20, 9, 4)}
    assert _drive(r, p, chunks, calls) == _oracle(rows, calls)


def _case_same_chunk_partition_move_dirties_old_partition():
    calls = (("row_number", None, "rn"), ("sum", "x", "sx"))
    r, p = _general(calls)
    chunks = [[("+", 0, 1, 10, 5), ("+", 1, 1, 20, 6), ("+", 2, 1, 30, 7)],
              [("-", 1, 1, 20, 6), ("+", 1, 2, 20, 6)]]  # a ghost carries the old partition
    rows = {0: (1, 10, 5, 0), 1: (2, 20, 6, 3), 2: (1, 30, 7, 2)}
    assert _drive(r, p, chunks, calls) == _oracle(rows, calls)


def _case_churn_keeps_capacity_bounded():
    calls = (("row_number", None, "rn"),)
    r, p = _general(calls, capacity=1 << 7)
    rid, mv = 0, set()
    for _ in range(40):
        ins = [("+", rid + i, 0, i, i) for i in range(8)]
        dels = [("-", rid + i, 0, i, i) for i in range(8)]
        rid += 8
        mv = _drive(r, p, [ins, dels], calls, mv=mv)
        _same_deltas(r.checkpoint_delta(), p.checkpoint_delta())
    assert mv == set()
    assert p.capacity == r.capacity <= 1 << 9


def _case_checkpoint_restore_mid_stream():
    calls = (("row_number", None, "rn"), ("rank", "o", "rk"), ("sum", "x", "sx"),
             ("lead", "x", "ld"))
    chunks, rows, _ = rgo._random_stream(np.random.default_rng(23), 10, {}, 0)
    r, p = _general(calls)
    mv = _drive(r, p, chunks[:6], calls)
    rmgr, pmgr = RefManager(RefStore()), CheckpointManager(MemObjectStore())
    rs_, ps_ = rmgr.stage([r]), pmgr.stage([p])
    _same_deltas(rs_, ps_)
    rmgr.commit_staged(1, rs_)
    pmgr.commit_staged(1, ps_)
    r2, p2 = _general(calls)
    rmgr.recover([r2])
    pmgr.recover([p2])
    assert p2.state_digest() == r2.state_digest() == p.state_digest()
    assert _drive(r2, p2, chunks[6:], calls, mv=set(mv)) == _oracle(rows, calls)


@pytest.mark.parametrize("case", [
    _case_running_min_max_and_lag,
    _case_rank_dense_rank_ordered_arrivals,
    _case_rank_out_of_order_raises,
    _case_over_window_checkpoint_restore,
    _case_eowc_over_window_lead_and_frames,
    _case_retractable_rank_and_frames_oracle,
    _case_rank_ties_and_ooo_arrivals,
    _case_same_chunk_partition_move_dirties_old_partition,
    _case_churn_keeps_capacity_bounded,
    _case_checkpoint_restore_mid_stream,
], ids=lambda f: f.__name__[6:])
def test_reference_case(case):
    """The ten cases of the reference's over-window tests, each run on
    both packages side by side (every emission, digest and delta equal)
    and checked against the reference test's own oracle."""
    case()


# -- beyond the reference's cases ---------------------------------------------------
def _extreme_stream(rng, n_chunks, n, with_deletes):
    """Chunks whose values include INT64_MIN/MAX and NULLs, with negative
    order keys (non-decreasing per partition for the append-only case)."""
    out, live, rid, cur = [], {}, 0, {q: -50 for q in range(3)}
    pool = np.asarray([IMIN, IMIN + 1, -7, 0, 3, IMAX - 1, IMAX], np.int64)
    for _ in range(n_chunks):
        ids, ps, os_, xs, nul, ops = [], [], [], [], [], []
        for _ in range(n):
            if with_deletes and live and rng.random() < 0.3:
                k = int(rng.choice(sorted(live)))
                q, o, x, xn = live.pop(k)
                ids.append(k), ps.append(q), os_.append(o), xs.append(x), nul.append(xn)
                ops.append(1)
                continue
            q = int(rng.integers(0, 3))
            cur[q] += int(rng.integers(0, 3))
            o = cur[q] if not with_deletes else int(rng.integers(-9, 9))
            x, xn = int(rng.choice(pool)), bool(rng.random() < 0.2)
            ids.append(rid), ps.append(q), os_.append(o), xs.append(x), nul.append(xn)
            ops.append(0)
            live[rid] = (q, o, x, xn)
            rid += 1
        out.append(({"id": np.asarray(ids, np.int64), "p": np.asarray(ps, np.int64),
                     "o": np.asarray(os_, np.int64), "x": np.asarray(xs, np.int64)},
                    np.asarray(ops, np.int32), {"x": np.asarray(nul, bool)}))
    return out


@pytest.mark.parametrize("kind", ["append", "eowc", "general"])
def test_int64_extremes_nulls_and_negative_order_keys(kind):
    """min/max over INT64_MIN/MAX and NULL inputs (the ``#has`` lanes and
    the frame identities), rank over negative order keys, per chunk on
    both packages: every emission, digest and delta equal."""
    rng = np.random.default_rng(41)
    if kind == "append":
        calls = (("min", "x", "mn"), ("max", "x", "mx"), ("sum", "x", "sx"),
                 ("rank", "o", "rk"), ("dense_rank", "o", "dr"), ("lag", "x", "lg"),
                 ("count", None, "c"))
        r, p = _twins(kind, calls, {"p": "i64", "o": "i64", "x": "i64"}, partition_by=("p",),
                      capacity=1 << 6)
    elif kind == "eowc":
        calls = (("min", "x", "mn"), ("max", "x", "mx"), ("min", "x", "fm", {"frame": (-1, 2)}),
                 ("max", "x", "fx", {"frame": (0, 1)}), ("count", None, "fc", {"frame": (-2, 0)}),
                 ("count", None, "c"), ("rank", "o", "rk"), ("lag", "x", "lg", {"offset": 2}))
        r, p = _twins(kind, calls, {"id": "i64", "p": "i64", "o": "i64", "x": "i64"},
                      partition_by=("p", "id"), order_col="o", win_col="id", capacity=1 << 6,
                      nullable=("x",))
    else:
        calls = (("min", "x", "mn"), ("max", "x", "mx"), ("max", "x", "fx", {"frame": (-1, 1)}),
                 ("rank", "o", "rk"), ("dense_rank", "o", "dr"), ("lag", "x", "lg"),
                 ("count", None, "c"))
        r, p = _twins(kind, calls, _G_DT, partition_by=("p",), order_col="o", pk=("id",),
                      capacity=1 << 7, nullable=("x",))
    for cols, ops, nulls in _extreme_stream(rng, 4, 12, kind == "general"):
        if kind == "append":
            cols = {k: cols[k] for k in ("p", "o", "x")}
        if kind == "eowc":
            cols["id"] = cols["id"] // 5  # five rows a window
        _apply(r, p, cols, 16, ops, nulls)
        if kind == "eowc":
            cut = int(cols["id"].max())
            _, ro = r.on_watermark(RefWatermark("id", cut))
            _, po = p.on_watermark(Watermark("id", cut))
            _same_outs(ro, po)
        _barrier(r, p)
        _same_deltas(r.checkpoint_delta(), p.checkpoint_delta())
        assert p.state_digest() == r.state_digest()


@pytest.mark.parametrize("kind", ["append", "general"])
def test_growth_rehash_equal(kind):
    """A table four times too small grows (kernel A into the new table,
    kernel I moving every lane, unclaimed accumulators at their INIT
    values) while the stream runs: emissions, digests and deltas equal
    at every barrier."""
    rng = np.random.default_rng(17)
    if kind == "append":
        calls = (("min", "x", "mn"), ("row_number", None, "rn"), ("lag", "x", "lg"))
        r, p = _twins(kind, calls, {"p": "i64", "x": "i64"}, partition_by=("p",),
                      capacity=1 << 5)
        for _ in range(4):
            _apply(r, p, {"p": rng.integers(0, 40, 24), "x": rng.integers(-9, 9, 24)}, 32)
            _barrier(r, p)
            _same_deltas(r.checkpoint_delta(), p.checkpoint_delta())
        assert p.table.capacity == r.table.capacity > 1 << 5
    else:
        calls = (("rank", "o", "rk"), ("sum", "x", "sx"), ("lead", "x", "ld"))
        r, p = _general(calls, capacity=1 << 5)
        chunks, rows, _ = rgo._random_stream(rng, 5, {}, 0)
        mv = _drive(r, p, chunks, calls)
        assert mv == _oracle(rows, calls)
        assert p.capacity == r.capacity > 1 << 5


@pytest.mark.parametrize("kind", ["append", "general"])
def test_dropped_row_latches(kind):
    """A row whose key finds no slot (a full table driven directly through
    the step) latches ``dropped`` on both packages; every other row's
    output and every slot but ``cap - 1`` (where the reference's wrapped
    ``.at[-1]`` writes the dropped row) compare equal."""
    cap, n = 8, 16
    keys = np.arange(100, 100 + n, dtype=np.int64)
    cols = {"p": keys, "x": np.arange(n, dtype=np.int64)}
    if kind == "general":
        cols = {"id": keys, "p": keys % 3, "o": -keys, "x": np.arange(n, dtype=np.int64)}
    rc, pc = _pair(cols, n)
    if kind == "append":
        calls = (("row_number", None, "rn"), ("sum", "x", "sx"), ("max", "x", "mx"))
        rcalls, pcalls = _calls("ref", calls), _calls("port", calls)
        rt = rht.HashTable.create(cap, (jnp.int64,))
        pt = pht.HashTable.create(cap, (torch.int64,), device="cpu")
        racc, pacc = {}, {}
        for rc_, pc_ in zip(rcalls, pcalls):
            for name in rov._accum_names(rc_):
                init = rov._accum_init(rc_) if name == rc_.output else 0
                racc[name] = jnp.full(cap, init, jnp.int64)
                pacc[name] = torch.full((cap,), int(init), dtype=torch.int64)
        rsd, psd = jnp.zeros(cap, jnp.bool_), torch.zeros(cap, dtype=torch.bool)
        rt, racc, rsd, rout, _, rdr, _ = rov._over_step(rt, racc, rsd, rc, rcalls, ("p",))
        lat = tuple(torch.zeros((), dtype=torch.bool) for _ in range(3))
        pout = pov.over_step(pt, pacc, psd, pc, pcalls, ("p",), lat)
        assert bool(rdr) and bool(lat[1])
        ok = np.asarray(pt.fp1.numpy() != 0)
        slots = pht._lookup_torch(pt, (pc.col("p"),), pc.valid)[0].numpy()
        keep = slots >= 0
        _same_chunk(rout, pout, keep)
        inner = np.arange(cap) != cap - 1
        for name in racc:
            np.testing.assert_array_equal(pacc[name].numpy()[inner & ok],
                                          np.asarray(racc[name])[inner & ok])
    else:
        calls = (("row_number", None, "rn"), ("rank", "o", "rk"))
        r, p = _twins(kind, calls, _G_DT, partition_by=("p",), order_col="o", pk=("id",),
                      capacity=cap)
        # the step itself, skipping the growth the executor would do
        r._maybe_grow = lambda incoming: None
        p._maybe_grow = lambda incoming: None
        ro, po = r.apply(rc), p.apply(pc)
        assert bool(r._dropped) and bool(p._dropped)
        _same_outs(ro, po)  # the wrapped touched[-1] recomputes one partition, unchanged
        _barrier(r, p, "overflowed")
