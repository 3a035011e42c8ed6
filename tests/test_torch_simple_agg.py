"""SimpleAgg (``SimpleAggExecutor``, kernel Y's plain version on the CPU)
against ``risingwave_tpu``'s on JAX-CPU.

Mirrors ``tests/test_simple_agg_topn.py:34,56`` (the row present before
any input, updates as U-/U+ pairs, a SUM of nothing is NULL, the
checkpoint round trip) and holds the state of ``simple_step`` against
the reference's ``_simple_step`` over seeded chunks of every call kind:
integer lanes exactly, float64 sums to a relative 1e-12, float32 sums
to ``2 n 2^-24 sum|x|`` (two orders of n float32 additions each err by
at most ``(n - 1) 2^-24 sum|x|``). A retraction that reaches a MIN
raises at the barrier in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import MaterializeExecutor as RefMv
from risingwave_tpu.executors import SimpleAggExecutor as RefSimple
from risingwave_tpu.executors.simple_agg import _simple_step as ref_step
from risingwave_tpu.ops import agg as ref_agg
from risingwave_tpu.ops.agg import AggCall as RefCall
from risingwave_tpu.runtime import Pipeline as RefPipeline
from risingwave_tpu.storage.object_store import MemObjectStore as RefStore
from risingwave_tpu.storage.state_table import CheckpointManager as RefManager
from risingwave_tpu_torch.array.chunk import StreamChunk, _numpy_dtype
from risingwave_tpu_torch.executors.simple_agg import SimpleAggExecutor, simple_step
from risingwave_tpu_torch.ops import agg as agg_ops
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.storage import CheckpointManager, MemObjectStore
from risingwave_tpu_torch.types import Op

CAP = 32
DT_REF = {"k": jnp.int64, "v": jnp.int64}
DT = {"k": torch.int64, "v": torch.int64}
CALLS = (("count_star", None, "cnt"), ("sum", "v", "s"))


def _calls(spec, port: bool):
    mk = AggCall if port else RefCall
    return tuple(mk(*c) for c in spec)


def _chunks(rows, cap=CAP):
    cols = {"k": np.asarray([r[0] for r in rows], np.int64),
            "v": np.asarray([r[1] for r in rows], np.int64)}
    ops = np.asarray([r[2] for r in rows], np.int32)
    return (RefChunk.from_numpy(cols, cap, ops=ops),
            StreamChunk.from_numpy(cols, cap, ops=ops, device="cpu"))


def _replay(rows: dict, outs) -> dict:
    for c in outs:
        d = c.to_numpy(with_ops=True)
        for i, op in enumerate(d["__op__"]):
            row = tuple(None if d.get(f"{n}__null", np.zeros(len(d["__op__"]), bool))[i]
                        else d[n][i].item() for n in ("cnt", "s"))
            if op in (int(Op.DELETE), int(Op.UPDATE_DELETE)):
                assert rows.pop(()) == row
            else:
                assert () not in rows
                rows[()] = row
    return rows


def test_simple_agg_initial_row_and_updates():
    """The row exists before any input; deletes move it back to (0,
    NULL); the port's emissions, replayed, equal the reference's MV."""
    ref = RefSimple(_calls(CALLS, False), DT_REF)
    mv = RefMv(pk=(), columns=("cnt", "s"))
    pipe = RefPipeline([ref, mv])
    port = SimpleAggExecutor(_calls(CALLS, True), DT, device="cpu")
    rows = {}
    pipe.barrier()
    _replay(rows, port.on_barrier(None))
    assert rows == mv.snapshot() == {(): (0, None)}
    for batch, want in (
        ([(1, 10, Op.INSERT), (2, 5, Op.INSERT)], (2, 15)),
        ([(1, 10, Op.DELETE)], (1, 5)),
        ([], (1, 5)),
        ([(2, 5, Op.DELETE)], (0, None)),
    ):
        if batch:
            rc, pc = _chunks(batch)
            pipe.push(rc)
            port.apply(pc)
        pipe.barrier()
        outs = port.on_barrier(None)
        assert bool(outs) == bool(batch)
        _replay(rows, outs)
        assert rows == mv.snapshot() == {(): want}
        assert port.state_digest() == ref.state_digest()


def test_simple_agg_checkpoint_roundtrip():
    """``tests/test_simple_agg_topn.py:56``: committed, recovered into a
    fresh executor, the next change emits the U-/U+ pair from the
    recovered row; the port's delta equals the reference's."""
    calls = _calls(CALLS, True)
    port = SimpleAggExecutor(calls, DT, table_id="sa", device="cpu")
    ref = RefSimple(_calls(CALLS, False), DT_REF, table_id="sa")
    rc, pc = _chunks([(1, 7, Op.INSERT), (1, 3, Op.INSERT)])
    ref.apply(rc)
    port.apply(pc)
    ref.on_barrier(None)
    port.on_barrier(None)
    (pd,), (rd,) = port.checkpoint_delta(), ref.checkpoint_delta()
    assert pd.table_id == rd.table_id == "sa" and set(pd.value_cols) == set(rd.value_cols)
    for k in pd.value_cols:
        assert np.array_equal(pd.value_cols[k], np.asarray(rd.value_cols[k])), k
    assert port.checkpoint_delta() == [] and not bool(port.state.sdirty.any())
    store = MemObjectStore()
    CheckpointManager(store).commit_staged(1 << 16, [pd])
    port2 = SimpleAggExecutor(calls, DT, table_id="sa", device="cpu")
    CheckpointManager(store).recover([port2])
    assert port2.state_digest() == ref.state_digest()
    _, pc = _chunks([(1, 7, Op.DELETE)])
    port2.apply(pc)
    d = port2.on_barrier(None)[0].to_numpy(with_ops=True)
    assert d["__op__"].tolist() == [Op.UPDATE_DELETE, Op.UPDATE_INSERT]
    assert d["cnt"].tolist() == [2, 1] and d["s"].tolist() == [10, 3]


def test_recovery_reads_the_reference_store():
    """The port recovers from a store the reference committed (float
    MIN/MAX keys staged as the reference's) into the reference's row."""
    spec = (("count_star", None, "c"), ("min", "f", "mn"), ("max", "x", "mx"),
            ("sum", "f", "sf"))
    dt_ref, dt = {"f": jnp.float64, "x": jnp.float32}, {"f": torch.float64, "x": torch.float32}
    ref = RefSimple(_calls(spec, False), dt_ref, table_id="saf")
    cols = {"f": np.asarray([2.5, -1.25, 7.0]), "x": np.asarray([1.5, -3.0, 0.25], np.float32)}
    ref.apply(RefChunk.from_numpy(cols, 4))
    ref.on_barrier(None)
    store = RefStore()
    RefManager(store).commit_epoch(1 << 16, [ref])
    port = SimpleAggExecutor(_calls(spec, True), dt, table_id="saf", device="cpu")
    CheckpointManager(store).recover([port])
    assert port._current_row() == ref._current_row() == (3, -1.25, 1.5, 8.25)
    assert port.state_digest() == ref.state_digest()
    assert port.checkpoint_delta() == []  # a restored row is not dirty


SPEC = (
    ("count_star", None, "c"),
    ("count", "i", "ci"),
    ("sum", "i", "si"),
    ("sum", "j", "sj"),
    ("sum", "f", "sf"),
    ("sum", "g", "sg"),
    ("min", "f", "mnf"),
    ("max", "g", "mxg"),
)
DT_MIX_REF = {"i": jnp.int32, "j": jnp.int64, "f": jnp.float64, "g": jnp.float32}
DT_MIX = {"i": torch.int32, "j": torch.int64, "f": torch.float64, "g": torch.float32}


def _mixed_chunk(rng, n, cap, retract: bool):
    cols = {"i": rng.integers(-1000, 1000, n).astype(np.int32),
            "j": rng.integers(-10**12, 10**12, n).astype(np.int64),
            "f": rng.standard_normal(n) * 1e3,
            "g": (rng.standard_normal(n) * 50).astype(np.float32)}
    nulls = {k: rng.random(n) < 0.2 for k in ("i", "f")}
    ops = np.where(rng.random(n) < 0.5, int(Op.INSERT), int(Op.UPDATE_INSERT)).astype(np.int32)
    if retract:
        ops[rng.random(n) < 0.3] = int(Op.DELETE)
        nulls["f"][ops == int(Op.DELETE)] = True  # the MIN sees no retraction
    return cols, ops, nulls


def test_simple_step_state_matches_reference():
    """``simple_step`` folds every call kind into slot 0 as the
    reference's ``_simple_step``: row_count, counts, integer sums and
    the non-null counters exactly, MIN/MAX keys exactly, float64 sums to
    1e-12 relative, float32 sums to the derived bound; a retraction
    reaching the float32 MAX latches minmax_retracted in both."""
    rng = np.random.default_rng(11)
    port_calls, ref_calls = _calls(SPEC, True), _calls(SPEC, False)
    st = agg_ops.create_state(2, port_calls, DT_MIX, "cpu")
    rst = ref_agg.create_state(2, ref_calls, DT_MIX_REF)
    abs_g = 0.0
    n_g = 0
    for e in range(6):
        n = int(rng.integers(50, 200))
        cols, ops, nulls = _mixed_chunk(rng, n, 256, retract=e >= 3)
        abs_g += float(np.abs(cols["g"]).sum())
        n_g += n
        simple_step(st, StreamChunk.from_numpy(cols, 256, ops=ops, nulls=nulls, device="cpu"),
                    port_calls)
        rst = ref_step(rst, RefChunk.from_numpy(cols, 256, ops=ops, nulls=nulls), ref_calls)
        assert np.array_equal(st.row_count.numpy(), np.asarray(rst.row_count))
        assert np.array_equal(st.dirty.numpy(), np.asarray(rst.dirty))
        assert np.array_equal(st.sdirty.numpy(), np.asarray(rst.sdirty))
        for name in st.nonnull:
            assert np.array_equal(st.nonnull[name].numpy(), np.asarray(rst.nonnull[name])), name
        fx = dict(agg_ops.float_extreme_meta(port_calls, DT_MIX))
        for name, acc in st.accums.items():
            got, want = acc.numpy(), np.asarray(rst.accums[name])
            if name in fx:
                got = agg_ops.order_key_to_reference(got, _numpy_dtype(fx[name]))
            if name == "sf":
                assert np.allclose(got, want, rtol=1e-12, atol=0), name
            elif name == "sg":
                assert np.all(np.abs(got.astype(np.float64) - want) <= 2 * n_g * 2**-24 * abs_g)
            else:
                assert np.array_equal(got, want), name
        assert bool(st.minmax_retracted) == bool(rst.minmax_retracted) == (e >= 3)


def test_min_retraction_raises_at_the_barrier():
    spec = (("count_star", None, "c"), ("min", "v", "mn"))
    ref = RefSimple(_calls(spec, False), DT_REF)
    port = SimpleAggExecutor(_calls(spec, True), DT, device="cpu")
    rc, pc = _chunks([(1, 4, Op.INSERT), (2, 9, Op.INSERT)])
    ref.apply(rc)
    port.apply(pc)
    assert port._current_row() == ref._current_row() == (2, 4)
    rc, pc = _chunks([(1, 4, Op.DELETE)])
    ref.apply(rc)
    port.apply(pc)
    with pytest.raises(RuntimeError, match="append-only global MIN/MAX"):
        ref.on_barrier(None)
    with pytest.raises(RuntimeError, match="append-only global MIN/MAX"):
        port.on_barrier(None)


def test_null_sum_and_float_extremes_row():
    """A SUM over NULLs alone is NULL; float MIN/MAX decode from their
    order keys to the reference's values; the row chunks equal."""
    spec = (("count_star", None, "c"), ("sum", "f", "s"), ("min", "f", "mn"),
            ("max", "x", "mx"))
    dt_ref, dt = {"f": jnp.float64, "x": jnp.float32}, {"f": torch.float64, "x": torch.float32}
    ref = RefSimple(_calls(spec, False), dt_ref)
    port = SimpleAggExecutor(_calls(spec, True), dt, device="cpu")
    cols = {"f": np.asarray([1.0, 2.0]), "x": np.asarray([-0.0, np.nan], np.float32)}
    nulls = {"f": np.asarray([True, True])}
    ref.apply(RefChunk.from_numpy(cols, 4, nulls=nulls))
    port.apply(StreamChunk.from_numpy(cols, 4, nulls=nulls, device="cpu"))
    want = ref.on_barrier(None)[0].to_numpy(with_ops=True)
    got = port.on_barrier(None)[0].to_numpy(with_ops=True)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k
    assert got["s__null"].tolist() == [True] and got["mn__null"].tolist() == [True]
    assert np.isnan(got["mx"][0])
    assert port.state_digest() == ref.state_digest()


def test_materialized_calls_are_refused():
    with pytest.raises(NotImplementedError):
        SimpleAggExecutor((AggCall("max", "v", "m", materialized=True),), DT, device="cpu")
