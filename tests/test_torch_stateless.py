"""The stateless executors and their kernels' plain versions: Filter and
Project (kernel S), WatermarkFilter (kernel T) and RowIdGen, the port
on the CPU against ``risingwave_tpu``'s executors on JAX-CPU over the
same seeded chunks.

Tolerance: none -- every lane (values, NULL lanes, valid, ops), the
running max, the watermarks, row ids, checkpoint deltas and digests
equal the reference's exactly (the projections here use + - * / and
comparisons only).
"""

import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors.base import Watermark as RefWatermark
from risingwave_tpu.executors.filter import FilterExecutor as RefFilter
from risingwave_tpu.executors.project import ProjectExecutor as RefProject
from risingwave_tpu.executors.row_id_gen import RowIdGenExecutor as RefRowIdGen
from risingwave_tpu.executors.watermark_filter import WatermarkFilterExecutor as RefWmFilter
from risingwave_tpu.expr import expr as RE
from risingwave_tpu_torch.array.chunk import StreamChunk, stack_chunks
from risingwave_tpu_torch.executors.base import Watermark
from risingwave_tpu_torch.executors.filter import FilterExecutor
from risingwave_tpu_torch.executors.project import ProjectExecutor
from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor
from risingwave_tpu_torch.executors.watermark_filter import INT64_MIN, WatermarkFilterExecutor
from risingwave_tpu_torch.expr import expr as PE
from risingwave_tpu_torch.types import Op

CAP = 64


def _update_chunk(rng, n=CAP, cap=CAP):
    """Rows whose ops hold adjacent U-/U+ pairs (as an agg flush lays them
    out), plain inserts and deletes, and -- with ``n == cap`` -- a pair
    split across the wraparound: the last row a U-, row 0 a U+."""
    ops = np.zeros(n, np.int32)
    i = 1
    while i < n - 2:
        r = rng.random()
        if r < 0.5:
            ops[i], ops[i + 1] = Op.UPDATE_DELETE, Op.UPDATE_INSERT
            i += 2
        else:
            ops[i] = Op.DELETE if r < 0.7 else Op.INSERT
            i += 1
    if n == cap:
        ops[0], ops[n - 1] = Op.UPDATE_INSERT, Op.UPDATE_DELETE
    cols = {
        "k": rng.integers(0, 40, n).astype(np.int64),
        "num": rng.integers(0, 40, n).astype(np.int64),
        "v": rng.integers(-5, 5, n).astype(np.int32),
        "f": rng.standard_normal(n).round(3),
    }
    nulls = {"v": rng.random(n) < 0.25}
    return cols, ops, nulls


def _pair(cols, ops, nulls, cap=CAP):
    return (RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls),
            StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu"))


def _assert_chunk(ref, port):
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(port.ops.numpy(), np.asarray(ref.ops))
    assert set(port.columns) == set(ref.columns) and set(port.nulls) == set(ref.nulls)
    for n in ref.columns:
        assert port.columns[n].numpy().dtype == np.asarray(ref.columns[n]).dtype, n
        np.testing.assert_array_equal(port.columns[n].numpy(), np.asarray(ref.columns[n]), n)
    for n in ref.nulls:
        np.testing.assert_array_equal(port.nulls[n].numpy(), np.asarray(ref.nulls[n]), n)


def _preds(E):
    c = E.col
    return [
        c("num") >= 20,                               # the HAVING of q103
        c("num") < 20,                                # q104's
        (c("v") > 0) | (c("num") > 30),               # NULL-bearing (three-valued)
        E.Not(c("v") < 2),                            # NULL predicate drops
        c("v"),                                       # an int predicate: nonzero passes
        E.BinOp("/", c("num"), c("v")) > 3,           # zero divisors give NULL
        c("f") * 2.5 > c("num") - 20,
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("i", range(len(_preds(PE))))
@pytest.mark.parametrize("full", [True, False], ids=["full", "padded"])
def test_filter_matches_reference(seed, i, full):
    """valid & keep and the torn-pair rewrite, on chunks with U-/U+
    pairs, NULL lanes and (full) a pair across the wraparound."""
    rng = np.random.default_rng(seed)
    cols, ops, nulls = _update_chunk(rng, n=CAP if full else CAP - 9)
    ref_chunk, port_chunk = _pair(cols, ops, nulls)
    (want,) = RefFilter(_preds(RE)[i]).apply(ref_chunk)
    (got,) = FilterExecutor(_preds(PE)[i]).apply(port_chunk)
    _assert_chunk(want, got)
    assert FilterExecutor(_preds(PE)[i]).lint_info() == RefFilter(_preds(RE)[i]).lint_info()


def test_filter_wraparound_downgrades_both_halves():
    """A chunk whose last row is a U- and row 0 its U+: dropping the U-
    turns row 0 into an Insert (row 0 looks back at row cap-1); keeping
    only the U- turns it into a Delete."""
    cols = {"num": np.array([25, 1, 2, 10], np.int64)}
    ops = np.array([Op.UPDATE_INSERT, Op.INSERT, Op.INSERT, Op.UPDATE_DELETE], np.int32)
    chunk = StreamChunk.from_numpy(cols, 4, ops=ops, device="cpu")
    (got,) = FilterExecutor(PE.col("num") >= 20).apply(chunk)
    assert got.valid.tolist() == [True, False, False, False]
    assert got.ops.tolist()[0] == Op.INSERT
    (got,) = FilterExecutor(PE.col("num") < 20).apply(chunk)
    assert got.valid.tolist() == [False, True, True, True]
    assert got.ops.tolist()[3] == Op.DELETE


def test_filter_step_maps_a_stacked_chunk_chunk_by_chunk():
    """The pure step on stacked (n_chunks, C) lanes equals the step on
    each chunk: torn pairs wrap within their own chunk, as under the
    reference's vmap."""
    rng = np.random.default_rng(5)
    chunks = [_pair(*_update_chunk(rng))[1] for _ in range(4)]
    step = FilterExecutor(PE.col("num") >= 20).pure_step()
    got = step(stack_chunks(chunks))
    for j, c in enumerate(chunks):
        one = step(c)
        assert torch.equal(got.valid[j], one.valid) and torch.equal(got.ops[j], one.ops)
    assert step == FilterExecutor(PE.col("num") >= 20).pure_step()
    assert step != FilterExecutor(PE.col("num") >= 21).pure_step()


def _outputs(E):
    c = E.col
    return {"k": c("k"), "price": E.lit(0.908) * c("num"), "vv": c("v") * 3 + c("k"),
            "ratio": E.BinOp("/", c("num"), c("v")), "flag": c("f") > 0,
            "cast": E.Cast(c("f") * 100, np.int32), "v": c("v")}


@pytest.mark.parametrize("seed", [0, 1])
def test_project_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref_chunk, port_chunk = _pair(*_update_chunk(rng))
    (want,) = RefProject(_outputs(RE)).apply(ref_chunk)
    (got,) = ProjectExecutor(_outputs(PE)).apply(port_chunk)
    _assert_chunk(want, got)
    assert got.columns["k"] is port_chunk.columns["k"]  # a bare column passes as it is
    assert ProjectExecutor(_outputs(PE)).lint_info() == RefProject(_outputs(RE)).lint_info()


def test_project_step_signature_is_the_executor_output():
    rng = np.random.default_rng(3)
    _, port_chunk = _pair(*_update_chunk(rng))
    step = ProjectExecutor(_outputs(PE)).pure_step()
    out = step(port_chunk)
    sig = {n: (a.dtype, n in port_chunk.nulls) for n, a in port_chunk.columns.items()}
    assert step.signature(sig) == {n: (a.dtype, n in out.nulls) for n, a in out.columns.items()}


# -- WatermarkFilter ------------------------------------------------------


def _wm_chunks(rng, n_chunks=6, n=48, nulls=False):
    """Event times that mostly rise, with late inserts, retractions far
    below the running max and U-/U+ pairs whose U+ falls below it."""
    out, base = [], 10_000
    for _ in range(n_chunks):
        ts = base + rng.integers(-3_000, 2_000, n)
        ops = np.where(rng.random(n) < 0.15, Op.DELETE, Op.INSERT).astype(np.int32)
        for i in range(2, n - 1, 7):
            ops[i], ops[i + 1] = Op.UPDATE_DELETE, Op.UPDATE_INSERT
            ts[i + 1] = base - 5_000  # the update moves the row below the floor
        ops[-1] = Op.UPDATE_DELETE  # its U+ wraps around to row 0
        cols = {"date_time": ts.astype(np.int64), "x": np.arange(n, dtype=np.int64)}
        nl = {"date_time": rng.random(n) < 0.1} if nulls else None
        out.append((cols, ops, nl))
        base += 1_500
    return out


@pytest.mark.parametrize("nulls", [False, True], ids=["plain", "null_ts"])
def test_watermark_filter_matches_reference(nulls):
    """Chunk by chunk: the surviving rows and ops, the running max, and
    the watermarks emitted at each barrier; an upstream watermark above
    ours advances it."""
    rng = np.random.default_rng(11)
    ref, port = RefWmFilter("date_time", 2_000), WatermarkFilterExecutor("date_time", 2_000,
                                                                         device="cpu")
    assert port.emit_watermark() is None and ref.emit_watermark() is None
    dropped = 0
    for j, (cols, ops, nl) in enumerate(_wm_chunks(rng, nulls=nulls)):
        rc, pc = (RefChunk.from_numpy(cols, 64, ops=ops, nulls=nl),
                  StreamChunk.from_numpy(cols, 64, ops=ops, nulls=nl, device="cpu"))
        (want,), (got,) = ref.apply(rc), port.apply(pc)
        _assert_chunk(want, got)
        dropped += int(pc.valid.sum() - got.valid.sum())
        assert int(port._running_max) == int(ref._running_max)
        rw, pw = ref.emit_watermark(), port.emit_watermark()
        assert (rw is None) == (pw is None)
        if rw is not None:
            assert (pw.column, pw.value) == (rw.column, rw.value)
        if j == 3:  # an upstream watermark on our column, above ours
            up = int(ref._wm) + 700
            assert ref.on_watermark(RefWatermark("date_time", up))[0].value == up
            assert port.on_watermark(Watermark("date_time", up))[0].value == up
            port.on_watermark(Watermark("other", up + 10**9))
        assert port._wm == ref._wm
    assert dropped > 0
    assert port.lint_info() == ref.lint_info()


def test_watermark_filter_trace_step_leaves_state_alone():
    port = WatermarkFilterExecutor("date_time", 100, device="cpu")
    chunk = StreamChunk.from_numpy({"date_time": np.arange(5, dtype=np.int64)}, 8, device="cpu")
    out = port.trace_contract()["trace_step"](chunk)
    assert int(port._running_max) == INT64_MIN and out.valid.sum() == 5


# -- RowIdGen -------------------------------------------------------------


def test_row_id_gen_matches_reference():
    """Ids per chunk, a chunk that already carries ids passes untouched,
    the digest, and the checkpoint delta and restore of the counter."""
    ref, port = RefRowIdGen(table_id="t.rowid"), RowIdGenExecutor(table_id="t.rowid")
    for cap in (8, 16, 4):
        cols = {"a": np.arange(cap // 2, dtype=np.int64)}
        (want,) = ref.apply(RefChunk.from_numpy(cols, cap))
        (got,) = port.apply(StreamChunk.from_numpy(cols, cap, device="cpu"))
        np.testing.assert_array_equal(got.columns["_row_id"].numpy(),
                                      np.asarray(want.columns["_row_id"]))
        assert got.columns["_row_id"].dtype == torch.int64
    carried = StreamChunk.from_numpy({"_row_id": np.arange(3, dtype=np.int64)}, 4, device="cpu")
    assert port.apply(carried)[0] is carried
    assert port.state_digest() == ref.state_digest()
    (rd,), (pd,) = ref.checkpoint_delta(), port.checkpoint_delta()
    assert (pd.table_id, pd.key_order) == (rd.table_id, rd.key_order)
    for a, b in ((pd.key_cols, rd.key_cols), (pd.value_cols, rd.value_cols)):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(pd.tombstone, rd.tombstone)
    assert port.checkpoint_delta() == [] and ref.checkpoint_delta() == []
    again = RowIdGenExecutor(table_id="t.rowid")
    again.restore_state("t.rowid", pd.key_cols, pd.value_cols)
    (nxt,) = again.apply(StreamChunk.from_numpy({"a": np.zeros(2, np.int64)}, 2, device="cpu"))
    assert nxt.columns["_row_id"].tolist() == [28, 29]
    (d,) = again.checkpoint_delta()
    assert d.value_cols["base"].tolist() == [30] and again.checkpoint_delta() == []
    assert port.lint_info()["table_ids"] == ref.lint_info()["table_ids"]
