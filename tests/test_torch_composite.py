"""Wide SQL types on fixed-width device lanes, the port's copy
(``risingwave_tpu_torch/array/composite.py``, ``types.py``'s rest and
``array/arrow.py``) against the reference's: the round trips of
``tests/test_types_composite.py``, each encode equal lane for lane to
the reference's, and the four SQL end-to-end tests there carried by the
port's executors (the port has no SQL layer yet): DECIMAL sums exact
through a HashAgg and a device MV, VARCHAR and JSONB codes through an MV
and back, NULLs decoding as None. Exact throughout.
"""

from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array import composite as ref_comp
from risingwave_tpu.array.arrow import chunk_from_arrow as ref_from_arrow
from risingwave_tpu.array.arrow import chunk_to_arrow as ref_to_arrow
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.array.dictionary import StringDictionary as RefDict
from risingwave_tpu import types as ref_types
from risingwave_tpu_torch import types as port_types
from risingwave_tpu_torch.array.arrow import chunk_from_arrow, chunk_to_arrow
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.array.composite import (
    LIST_LEN_SUFFIX,
    decode_column,
    encode_column,
    encode_rows,
    expand_field,
)
from risingwave_tpu_torch.array.dictionary import StringDictionary
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.runtime.pipeline import Pipeline
from risingwave_tpu_torch.types import (
    DataType,
    Field,
    Interval,
    Schema,
    schema_from_dtypes,
)


def _roundtrip(field, values, strings=None):
    lanes, nulls = encode_column(field, values, strings)
    null_of = lambda ln: (nulls or {}).get(ln)
    return decode_column(field, lanes, null_of, strings)


def test_decimal_roundtrip_exact():
    f = Field("amt", DataType.DECIMAL, scale=2)
    vals = [Decimal("1.23"), Decimal("-0.01"), "99.99", 7, None]
    got = _roundtrip(f, vals)
    assert got == [Decimal("1.23"), Decimal("-0.01"), Decimal("99.99"), Decimal("7.00"), None]
    lanes, _ = encode_column(f, [Decimal("0.1"), Decimal("0.2")])
    assert int(lanes["amt"].sum()) == 30  # 0.30 at scale 2


def test_interval_roundtrip():
    f = Field("dur", DataType.INTERVAL)
    vals = [Interval.of(months=2, days=1), Interval.of(hours=3, seconds=1.5), None]
    got = _roundtrip(f, vals)
    assert got[0] == Interval(2, 86_400_000_000)
    assert got[1] == Interval(0, 3 * 3_600_000_000 + 1_500_000)
    assert got[2] is None
    assert [ln for ln, _ in expand_field(f)] == ["dur.months", "dur.usecs"]
    assert Interval.of(months=1).total_usecs() == ref_types.Interval.of(months=1).total_usecs()


def test_jsonb_roundtrip_and_equality_codes():
    f = Field("doc", DataType.JSONB)
    d = StringDictionary()
    vals = [{"b": 1, "a": [1, 2]}, {"a": [1, 2], "b": 1}, None, 42]
    lanes, nulls = encode_column(f, vals, d)
    assert lanes["doc"][0] == lanes["doc"][1]
    got = decode_column(f, lanes, lambda ln: (nulls or {}).get(ln), d)
    assert got[0] == {"a": [1, 2], "b": 1}
    assert got[2] is None and got[3] == 42


def test_struct_decomposes_to_child_lanes():
    f = Field("addr", DataType.STRUCT,
              children=Schema([("zip", DataType.INT32), ("street", DataType.VARCHAR)]))
    d = StringDictionary()
    vals = [{"zip": 94110, "street": "valencia"}, {"zip": 10001, "street": None}, None]
    lanes, nulls = encode_column(f, vals, d)
    assert set(lanes) == {"addr.zip", "addr.street"}
    got = decode_column(f, lanes, lambda ln: (nulls or {}).get(ln), d)
    assert got[0] == {"zip": 94110, "street": "valencia"}
    assert got[1]["zip"] == 10001 and got[1]["street"] is None
    assert got[2] == {"zip": None, "street": None}


def test_list_pads_to_cap_and_errors_past_it():
    f = Field("xs", DataType.LIST, elem=DataType.INT64, list_cap=4)
    vals = [[1, 2, 3], [], None, [9, 9, 9, 9]]
    assert _roundtrip(f, vals) == [[1, 2, 3], [], None, [9, 9, 9, 9]]
    with pytest.raises(ValueError, match="cap"):
        encode_column(f, [[1, 2, 3, 4, 5]])


def test_encode_rows_mixed_schema():
    schema = Schema([Field("k", DataType.INT64), Field("amt", DataType.DECIMAL, scale=3),
                     Field("tag", DataType.VARCHAR)])
    d = StringDictionary()
    lanes, nulls = encode_rows(schema, [(1, "2.5", "a"), (2, None, "b")], d)
    assert lanes["amt"].tolist() == [2500, 0]
    assert nulls["amt"].tolist() == [False, True]
    assert d.decode(lanes["tag"]).tolist() == ["a", "b"]


# -- the port's encodings against the reference's ------------------------------------------
def _fields(mod_types):
    T = mod_types.DataType
    F = mod_types.Field
    return [
        (F("amt", T.DECIMAL, scale=3), ["1.5", None, Decimal("-2.125"), 4]),
        (F("dur", T.INTERVAL), [mod_types.Interval.of(days=2), None, mod_types.Interval(3, 7)]),
        (F("doc", T.JSONB), [{"z": 1, "a": [True, None]}, None, "x"]),
        (F("s", T.STRUCT, children=mod_types.Schema([("a", T.INT64), ("b", T.BOOLEAN)])),
         [{"a": 1, "b": True}, None, {"a": None, "b": False}]),
        (F("xs", T.LIST, elem=T.INT32, list_cap=3), [[1, 2], None, [], [5, 6, 7]]),
        (F("big", T.INT256), [2**200 + 5, -(2**255), None, -1]),
        (F("f", T.FLOAT32), [1.5, None, -0.0]),
        (F("t", T.TIMESTAMP), [1_700_000_000_000, None]),
    ]


@pytest.mark.parametrize("i", range(8))
def test_encode_column_equals_reference(i):
    (f, vals), (rf, rvals) = _fields(port_types)[i], _fields(ref_types)[i]
    d, rd = StringDictionary(), RefDict()
    lanes, nulls = encode_column(f, vals, d)
    rlanes, rnulls = ref_comp.encode_column(rf, rvals, rd)
    assert list(lanes) == list(rlanes)
    for k in rlanes:
        assert lanes[k].dtype == rlanes[k].dtype, k
        np.testing.assert_array_equal(lanes[k], rlanes[k], err_msg=k)
    assert (nulls is None) == (rnulls is None)
    for k in rnulls or {}:
        np.testing.assert_array_equal(nulls[k], rnulls[k], err_msg=k)
    assert [(n, np.dtype(t)) for n, t in expand_field(f)] == [
        (n, np.dtype(t)) for n, t in ref_comp.expand_field(rf)]
    null_of = lambda ln: (nulls or {}).get(ln)
    plain = lambda v: (v.months, v.usecs) if hasattr(v, "usecs") else v  # two Interval classes
    got = decode_column(f, lanes, null_of, d)
    want = ref_comp.decode_column(rf, rlanes, lambda ln: (rnulls or {}).get(ln), rd)
    assert [plain(v) for v in got] == [plain(v) for v in want]


def test_types_helpers_equal_reference():
    assert LIST_LEN_SUFFIX == ref_comp.LIST_LEN_SUFFIX
    for t in DataType:
        r = ref_types.DataType(t.value)
        assert t.is_composite == r.is_composite, t
        if t.is_composite:
            with pytest.raises(TypeError):
                t.device_dtype
            continue
        assert t.numpy_dtype == r.device_dtype, t
        assert type(t.null_value) is type(r.null_value) and t.null_value == r.null_value, t
    s = Schema([("a", DataType.INT64), ("b", DataType.VARCHAR), ("c", DataType.FLOAT64)])
    rs = ref_types.Schema([("a", ref_types.DataType.INT64), ("b", ref_types.DataType.VARCHAR),
                           ("c", ref_types.DataType.FLOAT64)])
    assert s.names == rs.names and len(s) == len(rs) and s.index("c") == rs.index("c")
    assert s.select(["c", "a"]).names == rs.select(["c", "a"]).names
    assert s.concat(s.select(["a"]), prefix="r_").names == rs.concat(rs.select(["a"]),
                                                                       prefix="r_").names
    assert [f.name for f in s] == list(s.names) and s.field("b").dtype is DataType.VARCHAR
    with pytest.raises(KeyError):
        s.index("zz")
    got = schema_from_dtypes({"a": torch.int32, "b": np.float64, "c": torch.bool})
    want = ref_types.schema_from_dtypes({"a": jnp.int32, "b": np.float64, "c": jnp.bool_})
    assert [(f.name, f.dtype.value) for f in got] == [(f.name, f.dtype.value) for f in want]
    with pytest.raises(ValueError, match="children"):
        Field("s", DataType.STRUCT)
    assert Field("xs", DataType.LIST, elem=DataType.INT64).list_cap == 16
    assert Field("d", DataType.DECIMAL).scale == 6


def test_arrow_round_trip_equals_reference():
    pytest.importorskip("pyarrow")
    rng = np.random.default_rng(5)
    n = 11
    cols = {"k": rng.integers(0, 9, n).astype(np.int64), "name": rng.integers(0, 3, n).astype(
        np.int32), "x": rng.standard_normal(n)}
    nulls = {"x": rng.random(n) < 0.3}
    ops = rng.integers(0, 4, n).astype(np.int32)
    d, rd = StringDictionary(), RefDict()
    words = ["alpha", "beta", "gamma"]
    d.encode(words)
    rd.encode(words)
    chunk = StreamChunk.from_numpy(cols, 16, ops=ops, nulls=nulls, device="cpu")
    ref = RefChunk.from_numpy(cols, 16, ops=ops, nulls=nulls)
    batch = chunk_to_arrow(chunk, {"name": d}, with_ops=True)
    rbatch = ref_to_arrow(ref, {"name": rd}, with_ops=True)
    assert batch.equals(rbatch)
    assert batch.column(batch.schema.names.index("name")).to_pylist()[:3] == [
        words[c] for c in cols["name"][:3]]
    back = chunk_from_arrow(batch, device="cpu")
    rback = ref_from_arrow(rbatch)
    assert back.capacity == rback.capacity == 16
    got, want = back.to_numpy(with_ops=True), rback.to_numpy(with_ops=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# -- the SQL tests' paths through the port's executors -------------------------------------
def _mv_pipeline(pk, cols, dtypes, nullable=(), agg=None):
    mv = DeviceMaterializeExecutor(pk, cols, dtypes, capacity=64, nullable=nullable,
                                   device="cpu")
    return Pipeline([agg, mv] if agg is not None else [mv]), mv


def test_decimal_sum_exact_through_agg_and_mv():
    schema = Schema([Field("uid", DataType.INT64), Field("amount", DataType.DECIMAL, scale=2)])
    agg = HashAggExecutor(("uid",), (AggCall("sum", "amount", "total"),),
                          {"uid": torch.int64, "amount": torch.int64}, capacity=64,
                          device="cpu")
    pipe, mv = _mv_pipeline(("uid",), ("total",), {"uid": torch.int64, "total": torch.int64},
                            agg=agg)
    for rows in ([(1, "0.10"), (1, "0.20"), (2, "99.99")], [(1, "0.40")]):
        lanes, nulls = encode_rows(schema, rows)
        pipe.push(StreamChunk.from_numpy(lanes, 4, nulls=nulls, device="cpu"))
        pipe.barrier()
    snap = mv.to_numpy()
    order = np.argsort(snap["uid"])
    total = Field("total", DataType.DECIMAL, scale=2)
    got = decode_column(total, {"total": snap["total"][order]}, lambda ln: None)
    assert got == [Decimal("0.70"), Decimal("99.99")]  # no 0.7000000001


def test_varchar_codes_through_agg_and_mv():
    d = StringDictionary()
    schema = Schema([Field("name", DataType.VARCHAR), Field("n", DataType.INT64)])
    lanes, _ = encode_rows(schema, [("click", 1), ("view", 2), ("click", 3)], d)
    agg = HashAggExecutor(("name",), (AggCall("count_star", None, "c"),), {"name": torch.int32},
                          capacity=64, device="cpu")
    pipe, mv = _mv_pipeline(("name",), ("c",), {"name": torch.int32, "c": torch.int64}, agg=agg)
    pipe.push(StreamChunk.from_numpy(lanes, 4, device="cpu"))
    pipe.barrier()
    snap = mv.to_numpy()
    order = np.argsort(-snap["c"])
    assert d.decode(snap["name"][order]).tolist() == ["click", "view"]
    assert snap["c"][order].tolist() == [2, 1]


def test_jsonb_and_nulls_through_mv():
    d = StringDictionary()
    schema = Schema([Field("id", DataType.INT64), Field("doc", DataType.JSONB),
                     Field("v", DataType.INT64)])
    lanes, nulls = encode_rows(schema, [(1, {"k": [1, 2]}, None), (2, None, 5)], d)
    pipe, mv = _mv_pipeline(("id",), ("doc", "v"),
                            {"id": torch.int64, "doc": torch.int32, "v": torch.int64},
                            nullable=("doc", "v"))
    pipe.push(StreamChunk.from_numpy(lanes, 2, nulls=nulls, device="cpu"))
    pipe.barrier()
    snap = mv.to_numpy()
    order = np.argsort(snap["id"])
    null_of = lambda ln: snap[ln + "__null"][order]
    docs = decode_column(schema.field("doc"), {"doc": snap["doc"][order]}, null_of, d)
    vs = decode_column(schema.field("v"), {"v": snap["v"][order]}, null_of)
    assert docs == [{"k": [1, 2]}, None]
    assert vs == [None, 5]
