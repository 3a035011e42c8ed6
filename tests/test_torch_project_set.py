"""ProjectSet (kernel AA's unnest and series entries on the card) on the
CPU: the port's plain ``unnest_step``/``series_step`` held lane for lane
against the reference's ``_unnest_step``/``_series_step`` (every value,
null, valid and op lane), NULL lists,
lists of length 0 and at the cap, NULL series bounds, the truncation
latch and its messages, the reference's own ProjectSet tests on the
port, and ``fuse_chain`` splitting a chain at the executor as the
reference's does. Exact: every lane is an integer or a bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import project_set as ref_ps
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.array.composite import encode_column
from risingwave_tpu_torch.executors import project_set as ps
from risingwave_tpu_torch.types import DataType, Field


def assert_chunks_equal(got, want, what=""):
    """Every lane of a port chunk equal to the reference chunk's (a jitted
    step returns its dicts in sorted key order, so names compare as
    sets)."""
    assert set(got.columns) == set(want.columns), what
    assert set(got.nulls) == set(want.nulls), what
    for n in want.columns:
        g, w = got.col(n).numpy(), np.asarray(want.col(n))
        assert g.dtype == w.dtype, (what, n)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {n}")
    for n in want.nulls:
        np.testing.assert_array_equal(got.nulls[n].numpy(), np.asarray(want.nulls[n]),
                                      err_msg=f"{what} null {n}")
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid), err_msg=what)
    np.testing.assert_array_equal(got.ops.numpy(), np.asarray(want.ops), err_msg=what)


def both(cols, cap, ops=None, nulls=None):
    return (StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu"),
            RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls))


def list_chunk(rng, n, cap, list_cap, with_nulls=True):
    """Rows with lists of length 0..list_cap (some NULL), an int32 and an
    int64 column, a nullable one, random ops."""
    vals = []
    for _ in range(n):
        ln = int(rng.integers(0, list_cap + 1))
        vals.append(None if with_nulls and rng.random() < 0.2 else
                    rng.integers(-50, 50, ln).tolist())
    vals[0], vals[1] = [], list(range(list_cap))  # length 0 and the cap
    f = Field("xs", DataType.LIST, elem=DataType.INT64, list_cap=list_cap)
    lanes, nulls = encode_column(f, vals)
    lanes.update(k=rng.integers(0, 100, n).astype(np.int64),
                 ch=rng.integers(0, 4, n).astype(np.int32))
    nulls = dict(nulls or {})
    nulls["ch"] = rng.random(n) < 0.3
    ops = rng.integers(0, 4, n).astype(np.int32)
    return both(lanes, cap, ops, nulls), vals


@pytest.mark.parametrize("seed,ordinal", [(1, True), (2, False), (3, True)])
def test_unnest_step_equals_reference(seed, ordinal):
    rng = np.random.default_rng(seed)
    (c, r), vals = list_chunk(rng, 37, 48, 5)
    got = ps._unnest_torch(c, "xs", "x", 5, ordinal)
    want = ref_ps._unnest_step(r, "xs", "x", 5, ordinal)
    assert_chunks_equal(got, want, "unnest")
    # a NULL list and an empty one yield nothing; a full one all five
    v = got.valid.numpy().reshape(5, 48)
    assert not v[:, 0].any() and v[:, 1].all() == bool(c.valid[1])
    null_rows = [i for i, x in enumerate(vals) if x is None]
    assert not v[:, null_rows].any()


@pytest.mark.parametrize("seed,ordinal", [(4, True), (5, False)])
def test_series_step_equals_reference(seed, ordinal):
    rng = np.random.default_rng(seed)
    n, cap, k = 41, 64, 6
    lo = rng.integers(-10, 10, n).astype(np.int32)
    hi = (lo + rng.integers(-3, 9, n)).astype(np.int64)  # empty, short and past k
    cols = {"k": rng.integers(0, 9, n).astype(np.int64), "lo": lo, "hi": hi,
            "x": rng.integers(0, 9, n).astype(np.int64)}
    nulls = {"lo": rng.random(n) < 0.15, "hi": rng.random(n) < 0.15, "x": rng.random(n) < 0.3}
    ops = rng.integers(0, 4, n).astype(np.int32)
    c, r = both(cols, cap, ops, nulls)
    got = ps._series_torch(c, "lo", "hi", "s", k, ordinal)
    want = ref_ps._series_step(r, "lo", "hi", "s", k, ordinal)
    assert_chunks_equal(got, want, "series")
    # a NULL bound yields an empty series
    bad = np.flatnonzero(nulls["lo"] | nulls["hi"])
    assert not got.valid.numpy().reshape(k, cap)[:, bad].any()
    # the output column replaces an input column of its name, NULL lane and all
    got = ps._series_torch(c, "lo", "hi", "x", k, ordinal)
    want = ref_ps._series_step(r, "lo", "hi", "x", k, ordinal)
    assert_chunks_equal(got, want, "series into x")
    assert "x" not in got.nulls


def test_executor_unnest_and_latch_match_reference():
    rng = np.random.default_rng(6)
    (c, r), _ = list_chunk(rng, 30, 32, 4)
    ex = ps.ProjectSetExecutor("unnest", out="tag", list_col="xs", list_cap=4)
    rex = ref_ps.ProjectSetExecutor("unnest", out="tag", list_col="xs", list_cap=4)
    (got,), (want,) = ex.apply(c), rex.apply(r)
    assert_chunks_equal(got, want, "executor unnest")
    assert ex.on_barrier(None) == [] and rex.on_barrier(None) == []
    # lists longer than the executor's cap latch (both raise the same message)
    ex3 = ps.ProjectSetExecutor("unnest", out="tag", list_col="xs", list_cap=3)
    rex3 = ref_ps.ProjectSetExecutor("unnest", out="tag", list_col="xs", list_cap=3)
    f = Field("xs", DataType.LIST, elem=DataType.INT64, list_cap=3)
    lanes, nulls = encode_column(f, [[1], [2, 3]])
    c3, r3 = both(lanes, 2, nulls=nulls)
    ex3.apply(c3)
    rex3.apply(r3)
    ex3.on_barrier(None)
    rex3.on_barrier(None)
    lanes["xs.#"] = np.asarray([1, 4], np.int32)  # a list of 4 under a cap of 3
    c4, r4 = both(lanes, 2)
    ex3.apply(c4)
    rex3.apply(r4)
    with pytest.raises(RuntimeError) as ours:
        ex3.on_barrier(None)
    with pytest.raises(RuntimeError) as theirs:
        rex3.on_barrier(None)
    assert str(ours.value) == str(theirs.value) == "unnest list exceeded list_cap; raise the cap"


def test_series_latch_ignores_null_bounds_and_invalid_rows():
    cols = {"lo": np.asarray([0, 0, 0], np.int64), "hi": np.asarray([100, 100, 3], np.int64)}
    for nulls, n, raises in (
        ({"lo": np.asarray([True, False, False])}, 3, True),   # row 1 spans 101
        ({"hi": np.asarray([True, True, False])}, 3, False),   # NULL bounds never count
        ({}, 1, True),
    ):
        sl = {k: v[:n] for k, v in cols.items()}
        nl = {k: v[:n] for k, v in nulls.items()}
        c, r = both(sl, 4, nulls=nl or None)
        ex = ps.ProjectSetExecutor("generate_series", out="s", start_col="lo", stop_col="hi",
                                   max_steps=8)
        rex = ref_ps.ProjectSetExecutor("generate_series", out="s", start_col="lo",
                                        stop_col="hi", max_steps=8)
        ex.apply(c)
        rex.apply(r)
        if raises:
            with pytest.raises(RuntimeError, match="generate_series exceeded max_steps; raise"):
                ex.on_barrier(None)
            with pytest.raises(RuntimeError, match="generate_series exceeded max_steps; raise"):
                rex.on_barrier(None)
        else:
            assert ex.on_barrier(None) == [] and rex.on_barrier(None) == []


def test_reference_project_set_tests_on_the_port():
    """``tests/test_project_set.py``'s two tests, on the port."""
    f = Field("xs", DataType.LIST, elem=DataType.INT64, list_cap=4)
    lanes, nulls = encode_column(f, [[10, 11], [], None, [7]])
    lanes["k"] = np.asarray([1, 2, 3, 4])
    chunk = StreamChunk.from_numpy(lanes, 4, nulls=nulls, device="cpu")
    ex = ps.ProjectSetExecutor("unnest", out="x", list_col="xs", list_cap=4)
    (out,) = ex.apply(chunk)
    d = out.to_numpy()
    rows = sorted(zip(d["k"].tolist(), d["x"].tolist(), d["projected_row_id"].tolist()))
    assert rows == [(1, 10, 0), (1, 11, 1), (4, 7, 0)]
    assert "xs.0" not in d

    chunk = StreamChunk.from_numpy({"k": np.asarray([1, 2]), "lo": np.asarray([5, 0]),
                                    "hi": np.asarray([7, -1])}, 2, device="cpu")
    ex = ps.ProjectSetExecutor("generate_series", out="s", start_col="lo", stop_col="hi",
                               max_steps=8)
    (out,) = ex.apply(chunk)
    d = out.to_numpy()
    assert sorted(zip(d["k"].tolist(), d["s"].tolist())) == [(1, 5), (1, 6), (1, 7)]
    ex.on_barrier(None)
    big = StreamChunk.from_numpy({"k": np.asarray([9]), "lo": np.asarray([0]),
                                  "hi": np.asarray([100])}, 2, device="cpu")
    ex.apply(big)
    with pytest.raises(RuntimeError, match="max_steps"):
        ex.on_barrier(None)
    with pytest.raises(ValueError, match="unknown table function"):
        ps.ProjectSetExecutor("explode")


def test_fuse_chain_splits_at_project_set_as_the_reference():
    """Project -> ProjectSet -> Project -> HashAgg -> MV: both packages'
    ``fuse_chain`` leave the Project before the ProjectSet and the
    ProjectSet interpreted and fuse the rest into one program."""
    from risingwave_tpu.executors.hash_agg import HashAggExecutor as RefAgg
    from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor as RefMv
    from risingwave_tpu.executors.project import ProjectExecutor as RefProject
    from risingwave_tpu.expr import Col as RefCol
    from risingwave_tpu.expr import Lit as RefLit
    from risingwave_tpu.ops.agg import AggCall as RefCall
    from risingwave_tpu.runtime.fused_step import fuse_chain as ref_fuse
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.executors.project import ProjectExecutor
    from risingwave_tpu_torch.expr import Col, Lit
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.fused_step import FusedChainExecutor, fuse_chain

    def chain(P, C, L, PS, A, Call, M, i64):
        return [
            P({"auction": C("auction"), "lo": C("date_time") // L(2000) - L(4),
               "hi": C("date_time") // L(2000)}),
            PS("generate_series", out="value", start_col="lo", stop_col="hi", max_steps=5),
            P({"auction": C("auction"), "window_start": C("value") * L(2000)}),
            A(("auction", "window_start"), (Call("count_star", None, "num"),),
              {"auction": i64, "window_start": i64}, capacity=64),
            M(("auction", "window_start"), ("num",),
              {"auction": i64, "window_start": i64, "num": i64}, capacity=64),
        ]

    dev = lambda cls: (lambda *a, **k: cls(*a, device="cpu", **k))
    ours = fuse_chain(chain(ProjectExecutor, Col, Lit, ps.ProjectSetExecutor,
                            dev(HashAggExecutor), AggCall, dev(DeviceMaterializeExecutor),
                            torch.int64))
    theirs = ref_fuse(chain(RefProject, RefCol, RefLit, ref_ps.ProjectSetExecutor, RefAgg,
                            RefCall, RefMv, jnp.int64))
    names = lambda out: [type(e).__name__ for e in out]
    assert names(ours) == names(theirs) == ["ProjectExecutor", "ProjectSetExecutor",
                                            "FusedChainExecutor"]
    assert isinstance(ours[2], FusedChainExecutor)
    assert [type(m).__name__ for m in ours[2].members] == [
        "ProjectExecutor", "HashAggExecutor", "DeviceMaterializeExecutor"]
    assert names(ours[2].members) == names(theirs[2].members)
