"""Host-edge encoding of wide SQL types onto fixed-width device lanes.

A copy of ``risingwave_tpu/array/composite.py`` (host-only numpy code;
the port keeps its own copy so it never imports the JAX package). Lane
dtypes are numpy's (``DataType.numpy_dtype``): these are host arrays
that ``StreamChunk.from_numpy`` puts on the device.

Reference: src/common/src/types/ (ScalarImpl for decimal / interval /
jsonb / struct / list) and the per-type arrays in src/common/src/array/
(struct_array.rs, list_array.rs, jsonb_array.rs, decimal in
primitive_array.rs). The reference stores variable-width payloads in
heap buffers; device lanes must be fixed-width, so:

- DECIMAL(p, s): scaled int64 (``round(v * 10^s)``) — exact, and +/-/
  sum/compare work natively on the lane;
- INTERVAL: ``name.months`` int32 + ``name.usecs`` int64;
- JSONB: canonical JSON text (sort_keys) -> int32 code in a shared
  StringDictionary (equality on codes == jsonb equality);
- STRUCT: recursive decomposition into ``parent.child`` leaf lanes,
  plus a per-struct null lane when the struct itself is nullable;
- LIST: element lanes ``name.0`` .. ``name.<cap-1>`` + length lane
  ``name.#`` (pad-to-cap; rows whose list exceeds cap raise at encode).

``expand_field`` gives the lane layout; ``encode_rows``/``decode_rows``
convert python values <-> lane dicts for DML and SELECT edges.
"""

from __future__ import annotations

import json
from decimal import Decimal
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.array.dictionary import StringDictionary
from risingwave_tpu_torch.types import DataType, Field, Interval

LIST_LEN_SUFFIX = ".#"


def _child_field(parent: Field, child: Field) -> Field:
    """Child Field re-rooted under its parent's lane prefix — the one
    place the prefixed reconstruction lives (expand/encode/decode all
    route through it, so new Field parameters thread automatically)."""
    return Field(
        f"{parent.name}.{child.name}",
        child.dtype,
        scale=child.scale,
        children=child.children,
        elem=child.elem,
        list_cap=child.list_cap,
    )


_I256_BITS = 256
_I256_LIMBS = 4
_U64_MASK = (1 << 64) - 1


def _int256_to_limbs(v: int) -> Tuple[int, ...]:
    """Signed 256-bit int -> 4 little-endian 64-bit limbs, each stored
    two's-complement in an int64 lane (reference: types/int256 — a
    4-limb wide integer; limb lanes keep device storage fixed-width)."""
    if not -(1 << 255) <= v < (1 << 255):
        raise OverflowError(f"{v} overflows INT256")
    u = v & ((1 << _I256_BITS) - 1)  # two's complement
    out = []
    for i in range(_I256_LIMBS):
        limb = (u >> (64 * i)) & _U64_MASK
        out.append(limb - (1 << 64) if limb >= (1 << 63) else limb)
    return tuple(out)


def _limbs_to_int256(limbs: Sequence[int]) -> int:
    u = 0
    for i, limb in enumerate(limbs):
        u |= (int(limb) & _U64_MASK) << (64 * i)
    return u - (1 << _I256_BITS) if u >= (1 << 255) else u


def expand_field(field: Field) -> List[Tuple[str, np.dtype]]:
    """Leaf device lanes (name, dtype) for one logical column."""
    dt = field.dtype
    if dt is DataType.INT256:
        return [
            (f"{field.name}.l{i}", np.dtype(np.int64))
            for i in range(_I256_LIMBS)
        ]
    if dt is DataType.INTERVAL:
        return [
            (f"{field.name}.months", np.dtype(np.int32)),
            (f"{field.name}.usecs", np.dtype(np.int64)),
        ]
    if dt is DataType.STRUCT:
        out: List[Tuple[str, np.dtype]] = []
        for child in field.children:
            out.extend(expand_field(_child_field(field, child)))
        return out
    if dt is DataType.LIST:
        ed = field.elem.numpy_dtype
        lanes = [
            (f"{field.name}.{i}", ed) for i in range(field.list_cap)
        ]
        lanes.append((field.name + LIST_LEN_SUFFIX, np.dtype(np.int32)))
        return lanes
    return [(field.name, dt.numpy_dtype)]


def _dec_to_scaled(v, scale: int) -> int:
    if isinstance(v, Decimal):
        q = v.scaleb(scale)
    elif isinstance(v, str):
        q = Decimal(v).scaleb(scale)
    else:
        q = Decimal(repr(v)).scaleb(scale)
    return int(q.to_integral_value())


def encode_column(
    field: Field,
    values: Sequence,
    strings: Optional[StringDictionary] = None,
) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """python values -> {lane: array}, plus null lanes ({lane: bool[]}
    or None). NULL python value = None. Composite children may be
    individually NULL via None inside the composite value."""
    n = len(values)
    dt = field.dtype
    isnull = np.asarray([v is None for v in values], bool)
    # null lanes must ride a real device lane: composites anchor theirs
    # on a designated leaf (interval -> .usecs, list -> .#); a NULL
    # struct marks every child NULL (no struct-level lane exists)
    anchor = field.name
    if dt is DataType.INTERVAL:
        anchor = f"{field.name}.usecs"
    elif dt is DataType.LIST:
        anchor = field.name + LIST_LEN_SUFFIX
    elif dt is DataType.INT256:
        anchor = f"{field.name}.l0"
    nulls = {anchor: isnull} if isnull.any() else None

    if dt is DataType.VARCHAR or dt is DataType.JSONB:
        if strings is None:
            raise ValueError(f"{dt} column {field.name!r} needs a dictionary")
        texts = [
            ""
            if v is None
            else (
                v
                if dt is DataType.VARCHAR
                else json.dumps(v, sort_keys=True, separators=(",", ":"))
            )
            for v in values
        ]
        return {field.name: strings.encode(texts)}, nulls
    if dt is DataType.DECIMAL:
        arr = np.asarray(
            [
                0 if v is None else _dec_to_scaled(v, field.scale)
                for v in values
            ],
            np.int64,
        )
        return {field.name: arr}, nulls
    if dt is DataType.INT256:
        limb_arrs = [np.zeros(n, np.int64) for _ in range(_I256_LIMBS)]
        for i, v in enumerate(values):
            if v is None:
                continue
            for j, limb in enumerate(_int256_to_limbs(int(v))):
                limb_arrs[j][i] = limb
        return {
            f"{field.name}.l{j}": limb_arrs[j]
            for j in range(_I256_LIMBS)
        }, nulls
    if dt is DataType.INTERVAL:
        months = np.zeros(n, np.int32)
        usecs = np.zeros(n, np.int64)
        for i, v in enumerate(values):
            if v is None:
                continue
            if not isinstance(v, Interval):
                raise TypeError(f"expected Interval, got {type(v)}")
            months[i] = v.months
            usecs[i] = v.usecs
        lanes = {
            f"{field.name}.months": months,
            f"{field.name}.usecs": usecs,
        }
        return lanes, nulls
    if dt is DataType.STRUCT:
        lanes: Dict[str, np.ndarray] = {}
        all_nulls: Dict[str, np.ndarray] = {}
        for child in field.children:
            cvals = [
                None if v is None else v.get(child.name) for v in values
            ]
            clanes, cnulls = encode_column(
                _child_field(field, child), cvals, strings
            )
            lanes.update(clanes)
            if cnulls:
                all_nulls.update(cnulls)
        return lanes, all_nulls or None
    if dt is DataType.LIST:
        cap = field.list_cap
        ed = field.elem.numpy_dtype
        lens = np.zeros(n, np.int32)
        elems = np.zeros((cap, n), ed)
        for i, v in enumerate(values):
            if v is None:
                continue
            if len(v) > cap:
                raise ValueError(
                    f"list in {field.name!r} has {len(v)} elements, "
                    f"cap is {cap}"
                )
            lens[i] = len(v)
            for j, e in enumerate(v):
                elems[j, i] = e
        lanes = {f"{field.name}.{i}": elems[i] for i in range(cap)}
        lanes[field.name + LIST_LEN_SUFFIX] = lens
        return lanes, nulls

    arr = np.asarray(
        [dt.null_value if v is None else v for v in values],
        dt.numpy_dtype,
    )
    return {field.name: arr}, nulls


def decode_column(
    field: Field,
    lanes: Dict[str, np.ndarray],
    null_of,
    strings: Optional[StringDictionary] = None,
) -> List:
    """{lane: array} -> python values. ``null_of(lane_name)`` returns a
    bool array (or None) marking SQL NULLs for a lane."""
    dt = field.dtype
    if dt is DataType.INTERVAL:
        isnull = null_of(f"{field.name}.usecs")
    elif dt is DataType.LIST:
        isnull = null_of(field.name + LIST_LEN_SUFFIX)
    elif dt is DataType.STRUCT:
        isnull = None  # NULL struct == all children NULL
    elif dt is DataType.INT256:
        isnull = null_of(f"{field.name}.l0")
    else:
        isnull = null_of(field.name)

    def _masked(vals):
        if isnull is None:
            return list(vals)
        return [None if m else v for v, m in zip(vals, isnull)]

    if dt is DataType.VARCHAR:
        return _masked(strings.decode(lanes[field.name]).tolist())
    if dt is DataType.JSONB:
        texts = strings.decode(lanes[field.name])
        if isnull is None:
            return [json.loads(s) for s in texts]
        # NULL rows encode as "" — mask BEFORE parsing
        return [
            None if m else json.loads(s) for s, m in zip(texts, isnull)
        ]
    if dt is DataType.DECIMAL:
        return _masked(
            [
                Decimal(int(v)).scaleb(-field.scale)
                for v in lanes[field.name]
            ]
        )
    if dt is DataType.INT256:
        limb_arrs = [
            lanes[f"{field.name}.l{j}"] for j in range(_I256_LIMBS)
        ]
        return _masked(
            [
                _limbs_to_int256([a[i] for a in limb_arrs])
                for i in range(len(limb_arrs[0]))
            ]
        )
    if dt is DataType.INTERVAL:
        months = lanes[f"{field.name}.months"]
        usecs = lanes[f"{field.name}.usecs"]
        return _masked(
            [Interval(int(m), int(u)) for m, u in zip(months, usecs)]
        )
    if dt is DataType.STRUCT:
        per_child = {}
        for child in field.children:
            per_child[child.name] = decode_column(
                _child_field(field, child), lanes, null_of, strings
            )
        n = len(next(iter(per_child.values())))
        rows = [
            {k: per_child[k][i] for k in per_child} for i in range(n)
        ]
        return _masked(rows)
    if dt is DataType.LIST:
        lens = lanes[field.name + LIST_LEN_SUFFIX]
        elem_lanes = [
            lanes[f"{field.name}.{i}"] for i in range(field.list_cap)
        ]
        py = field.elem.numpy_dtype.type
        rows = [
            [py(elem_lanes[j][i]).item() for j in range(int(lens[i]))]
            for i in range(len(lens))
        ]
        return _masked(rows)
    vals = lanes[field.name]
    if dt is DataType.BOOLEAN:
        return _masked([bool(v) for v in vals])
    return _masked([v.item() for v in np.asarray(vals)])


def encode_rows(
    schema,
    rows: Sequence[Sequence],
    strings: Optional[StringDictionary] = None,
):
    """Row tuples (schema order) -> (lanes, null_lanes) column dicts."""
    lanes: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    for j, field in enumerate(schema):
        vals = [r[j] for r in rows]
        cl, cn = encode_column(field, vals, strings)
        lanes.update(cl)
        if cn:
            nulls.update(cn)
    return lanes, nulls or None
