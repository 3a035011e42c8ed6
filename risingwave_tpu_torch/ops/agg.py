"""Grouped aggregation state — the core of HashAgg.

Port of ``risingwave_tpu/ops/agg.py`` (:60-257 state and helpers,
``apply`` :257-332, ``_reset_groups``/``delete_groups``/``forget_groups``
:533-595, ``flush`` :597-705). Reference roles:
src/stream/src/executor/hash_agg.rs:326 (apply_chunk) and :406
(flush_data), executor/aggregation/{agg_group,agg_state}.rs.

Agg state is a struct of slot-indexed lanes next to the group table.
``apply`` scatters a chunk's rows into it (kernel B on the card,
``csrc/agg_apply.cu``); ``flush`` compacts the dirty slots into one
interleaved (old, new) delta per barrier round (kernel C,
``csrc/agg_flush.cu``). The epoch path pre-reduces a whole epoch's rows
by key first (``reduce_by_key``, kernel F, ``csrc/reduce_by_key.cu``)
and then scatters one row per distinct key (``apply_reduced``, kernel
G, ``csrc/apply_reduced.cu``). Watermark expiry (``expire_groups``:
the reference executor's ``_expire`` with ``_reset_groups``) resets
closed groups (kernel O, ``csrc/expire.cu``). Everything that takes a
state updates it IN PLACE.

Semantics as the reference: SUM/MIN/MAX over only-NULL inputs is NULL
(a per-call non-null counter); MIN/MAX are append-only and a retraction
reaching one latches ``minmax_retracted``. Float MIN/MAX accumulate
total-order keys, stored here as int64 (see ``_float_to_order_key``).
A materialized-input MIN/MAX (``AggCall(materialized=True)``) is
skipped by ``apply``, ``reduce_by_key`` and ``apply_reduced``, in the
plain versions and in kernels B, F and G alike: the minput pass
(``ops/minput.py``, kernel Q) keeps its accumulator and non-null lanes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, resolve_device
from risingwave_tpu_torch.array.chunk import to_device
from risingwave_tpu_torch.ops import hashing
from risingwave_tpu_torch.ops.hash_table import expired_slots, expiry_key_args
from risingwave_tpu_torch.types import Op

KINDS = ("count_star", "count", "sum", "min", "max")
# kinds whose SQL result is NULL when no non-NULL input exists
NULLABLE_KINDS = ("sum", "min", "max")
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}  # agg_apply.cu AggKind


@dataclass(frozen=True)
class AggCall:
    """One aggregate call: kind + input column -> output column.
    ``materialized`` makes a MIN/MAX retractable (``ops/minput.py``)."""

    kind: str
    input: Optional[str]  # None for count_star
    output: str
    materialized: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unsupported agg kind {self.kind!r}")
        if (self.input is None) != (self.kind == "count_star"):
            raise ValueError(f"{self.kind} input mismatch")
        if self.materialized and self.kind not in ("min", "max"):
            raise ValueError("materialized only applies to min/max")


# -- ordered-float total-order keys -------------------------------------
# The reference stores a float MIN/MAX as an unsigned total-order key
# (uint32 for float32, uint64 for float64; NaN orders above everything).
# torch has no usable unsigned 32/64-bit arithmetic, so the port keeps
# the same keys in int64 lanes: a float32 key is the uint32 key as a
# non-negative int64; a float64 key is the uint64 key with its top bit
# flipped, read as int64. Both maps keep the unsigned order, so int64
# min/max on them is the reference's min/max.
_SIGN64 = -(2**63)


def _float_to_order_key(v: torch.Tensor) -> torch.Tensor:
    v = torch.where(v == 0.0, torch.zeros_like(v), v)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
    if v.dtype == torch.float32:
        bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        neg = bits >= 2**31
        return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 2**31)
    bits = v.view(torch.int64)
    # uint64 key = ~bits (negative) or bits | sign; flip the sign bit
    return torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)


def _order_key_to_float(k: torch.Tensor, float_dtype: torch.dtype) -> torch.Tensor:
    if float_dtype == torch.float32:
        was_pos = k >= 2**31
        bits = torch.where(was_pos, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
        return bits.to(torch.int32).view(torch.float32)
    bits = torch.where(k < 0, k ^ 0x7FFFFFFFFFFFFFFF, k)
    return bits.view(torch.float64)


def topn_order_key(v: torch.Tensor, desc: bool) -> torch.Tensor:
    """The TopN order key (``executors/top_n_plain.py:68``
    ``_order_key_u64``): the reference's unsigned 64-bit key (a float's
    total-order key zero-extended, an unsigned lane as it is, a signed
    one with its top bit flipped, all bits inverted for DESC) with bit
    63 flipped, read as int64, so that signed int64 order is the
    reference's unsigned order. A signed lane's key is then the lane
    itself (``~v`` for DESC)."""
    if v.is_floating_point():
        key = _float_to_order_key(v)
        if v.dtype == torch.float32:
            key = key ^ _SIGN64  # the zero-extended uint32 key, then the flip
    elif v.dtype == torch.uint8:
        key = v.to(torch.int64) ^ _SIGN64
    else:
        key = v.to(torch.int64)
    return ~key if desc else key


def order_key_from_reference(key: np.ndarray) -> np.ndarray:
    """The reference's uint32/uint64 order-key lane -> the port's int64."""
    key = np.asarray(key)
    if key.dtype == np.uint32:
        return key.astype(np.int64)
    return key.astype(np.uint64).view(np.int64) ^ np.int64(_SIGN64)


def order_key_to_reference(key: np.ndarray, float_dtype) -> np.ndarray:
    """The port's int64 order-key lane -> the reference's unsigned lane."""
    key = np.asarray(key, np.int64)
    if np.dtype(float_dtype) == np.float32:
        return key.astype(np.uint32)
    return (key ^ np.int64(_SIGN64)).view(np.uint64)


def order_key_to_reference_lane(key: torch.Tensor, float_dtype: torch.dtype) -> torch.Tensor:
    """``order_key_to_reference`` on the tensor's device, with the
    unsigned lane's bits held in the signed dtype of its width (int32
    for a float32 key, int64 for a float64 one)."""
    if float_dtype == torch.float32:
        # the low word, as a lane of its own (kernel H takes contiguous lanes)
        return key.contiguous().view(torch.int32).reshape(-1, 2)[:, 0].contiguous()
    return key ^ _SIGN64


def _is_float_extreme(call: AggCall, input_dtype) -> bool:
    return call.kind in ("min", "max") and input_dtype is not None and input_dtype.is_floating_point


def _accum_dtype(call: AggCall, input_dtype) -> torch.dtype:
    if call.kind in ("count_star", "count"):
        return torch.int64
    if call.kind == "sum" and not input_dtype.is_floating_point:
        return torch.int64  # SQL SUM(int) widens to bigint
    if _is_float_extreme(call, input_dtype):
        return torch.int64  # total-order key
    return input_dtype


def accum_init(kind: str, dtype: torch.dtype, float_input=None) -> int:
    """The empty-group accumulator value for one agg kind. For a float
    MIN/MAX (``float_input`` its input dtype) this is the image of the
    reference's unsigned sentinel in the port's key space."""
    if kind not in ("min", "max"):
        return 0
    if float_input == torch.float32:
        return 0xFFFFFFFF if kind == "min" else 0
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def emitted_init(float_input=None) -> int:
    """The empty snapshot value: 0, or for a float64 MIN/MAX the port's
    key of the reference's zero key."""
    return _SIGN64 if float_input == torch.float64 else 0


def float_extreme_meta(calls: Sequence[AggCall], input_dtypes) -> tuple:
    """(output, float dtype) for every MIN/MAX over a float input —
    flush decodes those lanes from order keys back to floats."""
    return tuple(
        (c.output, input_dtypes[c.input])
        for c in calls
        if _is_float_extreme(c, input_dtypes.get(c.input))
    )


@dataclass
class AggState:
    """Slot-indexed aggregation state (all lanes of length capacity).

    ``row_count`` is the implicit COUNT(*) deciding group liveness;
    ``accums[out]`` one accumulator per call; ``nonnull[out]`` non-NULL
    input counts for NULLABLE_KINDS; ``emitted*`` what downstream has
    seen; ``dirty`` touched since the last flush; ``minmax_retracted`` a
    () bool latch; ``sdirty``/``stored`` the checkpoint marks.
    """

    row_count: torch.Tensor
    accums: Dict[str, torch.Tensor]
    nonnull: Dict[str, torch.Tensor]
    emitted: Dict[str, torch.Tensor]
    emitted_isnull: Dict[str, torch.Tensor]
    emitted_valid: torch.Tensor
    dirty: torch.Tensor
    minmax_retracted: torch.Tensor
    sdirty: torch.Tensor
    stored: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.row_count.shape[0]

    @staticmethod
    def from_reference_arrays(state, float_extremes=(), device="cuda") -> "AggState":
        """Build from the reference's AggState with numpy leaves (any
        object with its attribute names, or a dict of them). Float
        MIN/MAX lanes (``float_extremes`` as from float_extreme_meta)
        are moved into the port's int64 key space."""
        dev = resolve_device(device)
        get = state.get if isinstance(state, dict) else lambda k: getattr(state, k)
        put = lambda a: to_device(a, dev)
        fx = dict(float_extremes)

        def acc(name, a):
            return put(order_key_from_reference(a) if name in fx else np.asarray(a))

        return AggState(
            row_count=put(np.asarray(get("row_count"), np.int64)),
            accums={n: acc(n, a) for n, a in get("accums").items()},
            nonnull={n: put(np.asarray(a)) for n, a in get("nonnull").items()},
            emitted={n: acc(n, a) for n, a in get("emitted").items()},
            emitted_isnull={
                n: put(np.asarray(a)) for n, a in get("emitted_isnull").items()
            },
            emitted_valid=put(np.asarray(get("emitted_valid"))),
            dirty=put(np.asarray(get("dirty"))),
            minmax_retracted=put(np.asarray(get("minmax_retracted"), np.bool_)),
            sdirty=put(np.asarray(get("sdirty"))),
            stored=put(np.asarray(get("stored"))),
        )


def create_state(capacity: int, calls: Sequence[AggCall], input_dtypes, device="cuda") -> AggState:
    """``input_dtypes`` maps input column name -> torch dtype."""
    dev = resolve_device(device)
    accums, nonnull, emitted, e_isnull = {}, {}, {}, {}
    for c in calls:
        in_dt = None if c.input is None else input_dtypes[c.input]
        dt = _accum_dtype(c, in_dt)
        fx = in_dt if _is_float_extreme(c, in_dt) else None
        accums[c.output] = torch.full((capacity,), accum_init(c.kind, dt, fx), dtype=dt, device=dev)
        emitted[c.output] = torch.full((capacity,), emitted_init(fx), dtype=dt, device=dev)
        if c.kind in NULLABLE_KINDS:
            nonnull[c.output] = torch.zeros(capacity, dtype=torch.int64, device=dev)
            e_isnull[c.output] = torch.zeros(capacity, dtype=torch.bool, device=dev)
    z = lambda: torch.zeros(capacity, dtype=torch.bool, device=dev)
    return AggState(
        row_count=torch.zeros(capacity, dtype=torch.int64, device=dev),
        accums=accums,
        nonnull=nonnull,
        emitted=emitted,
        emitted_isnull=e_isnull,
        emitted_valid=z(),
        dirty=z(),
        minmax_retracted=torch.zeros((), dtype=torch.bool, device=dev),
        sdirty=z(),
        stored=z(),
    )


def apply(
    state: AggState,
    calls: Tuple[AggCall, ...],
    slots: torch.Tensor,  # (n,) int32, -1 = skip
    signs: torch.Tensor,  # (n,) int32 in {-1, 0, +1}; 0 for padding
    values: Dict[str, torch.Tensor],
    nulls: Dict[str, torch.Tensor],
    live: Optional[torch.Tensor] = None,
) -> AggState:
    """Apply one chunk's rows to ``state`` in place.

    ``signs`` must already fold visibility (StreamChunk.effective_signs).
    NULL inputs count only toward COUNT(*). With ``live`` (the group
    table's live lane) every row's slot then gets live = row_count > 0,
    the ``set_live`` of ``hash_agg.py:135``. Materialized calls are
    skipped (``ops/agg.py:297-301`` in the reference).
    """
    calls = _unmaterialized(calls)
    if slots.device.type == "cpu":
        _apply_torch(state, calls, slots, signs, values, nulls, live)
    elif slots.device.type == "cuda":
        _apply_cuda(state, calls, slots, signs, values, nulls, live)
    else:
        raise ValueError(f"unsupported device {slots.device}")
    return state


def _apply_torch(state, calls, slots, signs, values, nulls, live):
    active = (slots >= 0) & (signs != 0)
    idx = slots[active].long()
    w = signs[active].to(torch.int64)
    state.row_count.index_add_(0, idx, w)
    state.dirty[idx] = True
    state.sdirty[idx] = True
    for c in calls:
        acc = state.accums[c.output]
        if c.kind == "count_star":
            acc.index_add_(0, idx, w)
            continue
        v = values[c.input][active]
        notnull = ~nulls[c.input][active] if c.input in nulls else torch.ones_like(w, dtype=torch.bool)
        wn = torch.where(notnull, w, torch.zeros_like(w))
        if c.kind == "count":
            acc.index_add_(0, idx, wn)
        elif c.kind == "sum":
            contrib = torch.where(notnull, v.to(acc.dtype) * w.to(acc.dtype), torch.zeros((), dtype=acc.dtype))
            acc.index_add_(0, idx, contrib)
            state.nonnull[c.output].index_add_(0, idx, wn)
        else:  # min / max — append-only
            use = notnull & (w > 0)
            if v.dtype.is_floating_point:
                v = _float_to_order_key(v)
            acc.scatter_reduce_(
                0, idx[use], v[use].to(acc.dtype),
                reduce="amin" if c.kind == "min" else "amax",
            )
            state.nonnull[c.output].index_add_(0, idx[use], torch.ones_like(idx[use]))
            state.minmax_retracted |= (notnull & (w < 0)).any()
    if live is not None:
        has = slots >= 0
        s = slots[has].long()
        live[s] = state.row_count[s] > 0


def call_rows(name: str, state: AggState, calls, values, nulls, n: int) -> list:
    """The calls as the descriptor rows kernels B and Y take: (kind,
    input dtype, accumulator dtype, input, input nulls, accumulator,
    non-null counter) per call, every lane checked (``n`` input rows)."""
    cap = state.capacity
    rows = []
    for c in calls:
        acc = state.accums[c.output]
        nonnull = state.nonnull.get(c.output)
        _kernels.check_cuda(name, acc, *(() if nonnull is None else (nonnull,)), n=cap)
        val = nul = None
        vdt = 0
        if c.input is not None:
            val = values[c.input]
            nul = nulls.get(c.input)
            _kernels.check_cuda(name, val, *(() if nul is None else (nul,)), n=n)
            vdt = _kernels.dtype_code(val)
            if c.kind in ("sum", "min", "max") and val.dtype == torch.bool:
                raise TypeError(f"{c.kind} over a bool lane is not supported")
            if c.kind == "sum" and acc.dtype.is_floating_point and val.dtype != acc.dtype:
                raise TypeError("float SUM input must match its accumulator dtype")
        rows.append((
            _KIND_CODE[c.kind], vdt, _kernels.dtype_code(acc),
            0 if val is None else val.data_ptr(),
            0 if nul is None else nul.data_ptr(),
            acc.data_ptr(),
            0 if nonnull is None else nonnull.data_ptr(),
        ))
    return rows


def _apply_cuda(state, calls, slots, signs, values, nulls, live):
    n = slots.shape[0]
    cap = state.capacity
    if slots.dtype != torch.int32 or signs.dtype != torch.int32:
        raise TypeError("slots and signs must be int32")
    _kernels.check_cuda("agg_apply", slots, signs, n=n)
    _kernels.check_cuda(
        "agg_apply", state.row_count, state.dirty, state.sdirty, n=cap
    )
    rows = call_rows("agg_apply", state, calls, values, nulls, n)
    _kernels.call(
        "agg_apply", "rw_agg_apply",
        _kernels.int64_rows(rows, 8), len(rows), n, slots.data_ptr(), signs.data_ptr(),
        state.row_count.data_ptr(), state.dirty.data_ptr(), state.sdirty.data_ptr(),
        state.minmax_retracted.data_ptr(),
    )
    if live is not None:
        _kernels.check_cuda("agg_apply", live, n=cap)
        _kernels.call(
            "agg_apply", "rw_agg_set_live",
            n, slots.data_ptr(), state.row_count.data_ptr(), live.data_ptr(),
        )


# -- the epoch path: reduce_by_key (kernel F) + apply_reduced (kernel G) ----
_ALL_ONES = 0xFFFFFFFF  # fingerprint of an invisible row: it sorts last

# reduced-lane codes shared with csrc/reduce_by_key.cu: what a row adds
# (RbkSrc) and how rows of a segment combine (RbkOp)
_SRC_SIGN, _SRC_WN, _SRC_SUM, _SRC_EXT, _SRC_USE = range(5)
_OP_SUM_I64, _OP_SUM_F32, _OP_SUM_F64, _OP_MIN_I64, _OP_MAX_I64, _OP_MIN_I32, _OP_MAX_I32 = range(7)


def _unmaterialized(calls) -> tuple:
    """The calls this module maintains: every call but a materialized
    MIN/MAX, whose lanes the minput pass keeps."""
    return tuple(c for c in calls if not c.materialized)


def reduce_by_key(
    key_lanes: Tuple[torch.Tensor, ...],
    signs: torch.Tensor,
    calls: Tuple[AggCall, ...],
    values: Dict[str, torch.Tensor],
    nulls: Dict[str, torch.Tensor],
):
    """Pre-reduce a row batch by group key (``ops/agg.py:334``).

    A stable sort on the fingerprint pair ``(h1, h2)`` of ``hash128``
    (invisible rows, ``signs == 0``, take ``0xFFFFFFFF`` for both and
    sort last) clusters equal keys; a segment starts at any change of
    fingerprint, visibility or exact key lane (NaN equals NaN), and every
    contribution is summed (or min/max-ed) per segment and broadcast to
    the segment's rows, so the table downstream is touched once per
    distinct key.

    Returns ``(sorted_keys, rep_valid, w, reduced, minmax_ret)``:
    ``sorted_keys`` the key lanes in sort order, ``rep_valid`` True on
    each visible segment's first row, ``w`` the int64 sum of signs per
    segment, ``reduced`` the per-call lanes ``cnt_<out>``,
    ``sum_<out>``/``nn_<out>`` and ``ext_<out>``/``nnp_<out>``, and
    ``minmax_ret`` a () bool: a retraction reached a MIN/MAX call.
    Materialized calls get no lane (``ops/agg.py:442-443``).
    """
    calls = _unmaterialized(calls)
    if signs.device.type == "cpu":
        return _reduce_by_key_torch(tuple(key_lanes), signs, calls, values, nulls)
    if signs.device.type == "cuda":
        return _reduce_by_key_cuda(tuple(key_lanes), signs, calls, values, nulls)
    raise ValueError(f"unsupported device {signs.device}")


def _reduce_by_key_torch(key_lanes, signs, calls, values, nulls, fingerprints=None):
    """The plain version: two stable sorts (h2, then h1) give the
    reference's permutation. ``fingerprints`` (h1, h2), uint32 values in
    int64 lanes, replace ``hash128`` of the keys (chip_smoke forces a
    fingerprint collision through it)."""
    n = signs.shape[0]
    dev = signs.device
    h1, h2 = hashing.hash128(key_lanes) if fingerprints is None else fingerprints
    vmask = signs != 0
    h1s = torch.where(vmask, h1, _ALL_ONES)
    h2s = torch.where(vmask, h2, _ALL_ONES)
    order = torch.argsort(h2s, stable=True)
    order = order[torch.argsort(h1s[order], stable=True)]
    h1s, h2s = h1s[order], h2s[order]
    sorted_keys = tuple(k[order] for k in key_lanes)
    s_sign = signs[order].to(torch.int64)
    s_vmask = vmask[order]

    def change(lane):
        out = torch.ones(n, dtype=torch.bool, device=dev)
        out[1:] = lane[1:] != lane[:-1]
        return out

    boundary = change(h1s) | change(h2s) | change(s_vmask)
    for lane in sorted_keys:
        ch = change(lane)
        if lane.dtype.is_floating_point:  # NaN == NaN for grouping
            ch[1:] &= ~(torch.isnan(lane[1:]) & torch.isnan(lane[:-1]))
        boundary |= ch
    rep_valid = boundary & s_vmask
    seg_id = torch.cumsum(boundary.to(torch.int64), 0) - 1

    def segsum(x):
        return torch.zeros(n, dtype=x.dtype, device=dev).index_add_(0, seg_id, x)[seg_id]

    w = segsum(s_sign)
    reduced: Dict[str, torch.Tensor] = {}
    minmax_ret = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for c in calls:
        if c.kind == "count_star":
            continue  # uses w directly
        v = values[c.input][order]
        notnull = ~nulls[c.input][order] if c.input in nulls else torch.ones_like(s_vmask)
        wn = torch.where(notnull, s_sign, zero)
        if c.kind == "count":
            reduced[f"cnt_{c.output}"] = segsum(wn)
        elif c.kind == "sum":
            acc_dt = _accum_dtype(c, v.dtype)
            contrib = torch.where(
                notnull, v.to(acc_dt) * s_sign.to(acc_dt), torch.zeros((), dtype=acc_dt, device=dev)
            )
            reduced[f"sum_{c.output}"] = segsum(contrib)
            reduced[f"nn_{c.output}"] = segsum(wn)
        else:  # min / max (append-only)
            use = s_vmask & notnull & (s_sign > 0)
            acc_dt = _accum_dtype(c, v.dtype)
            fx = v.dtype if v.dtype.is_floating_point else None
            if fx is not None:
                v = _float_to_order_key(v)
            sentinel = accum_init(c.kind, acc_dt, fx)
            vv = torch.where(use, v.to(acc_dt), torch.full((), sentinel, dtype=acc_dt, device=dev))
            seg = torch.full((n,), sentinel, dtype=acc_dt, device=dev).scatter_reduce_(
                0, seg_id, vv, reduce="amin" if c.kind == "min" else "amax"
            )
            reduced[f"ext_{c.output}"] = seg[seg_id]
            reduced[f"nnp_{c.output}"] = segsum(use.to(torch.int64))
            minmax_ret |= (s_vmask & notnull & (s_sign < 0)).any()
    return sorted_keys, rep_valid, w, reduced, minmax_ret


def _reduced_lane_specs(calls, values, nulls):
    """(name, src, op, value lane, null lane, out dtype, sentinel) per
    reduced lane, ``w`` first."""
    specs = [("w", _SRC_SIGN, _OP_SUM_I64, None, None, torch.int64, 0)]
    for c in calls:
        if c.kind == "count_star":
            continue
        v = values[c.input]
        nul = nulls.get(c.input)
        if c.kind == "count":
            specs.append((f"cnt_{c.output}", _SRC_WN, _OP_SUM_I64, v, nul, torch.int64, 0))
            continue
        acc_dt = _accum_dtype(c, v.dtype)
        if c.kind == "sum":
            if v.dtype == torch.bool:
                raise TypeError("sum over a bool lane is not supported")
            if acc_dt.is_floating_point and v.dtype != acc_dt:
                raise TypeError("float SUM input must match its accumulator dtype")
            op = {torch.int64: _OP_SUM_I64, torch.float32: _OP_SUM_F32, torch.float64: _OP_SUM_F64}[acc_dt]
            specs.append((f"sum_{c.output}", _SRC_SUM, op, v, nul, acc_dt, 0))
            specs.append((f"nn_{c.output}", _SRC_WN, _OP_SUM_I64, v, nul, torch.int64, 0))
            continue
        if v.dtype == torch.bool:
            raise TypeError(f"{c.kind} over a bool lane is not supported")
        fx = v.dtype if v.dtype.is_floating_point else None
        if acc_dt == torch.int32:
            op = _OP_MIN_I32 if c.kind == "min" else _OP_MAX_I32
        else:
            op = _OP_MIN_I64 if c.kind == "min" else _OP_MAX_I64
        specs.append((f"ext_{c.output}", _SRC_EXT, op, v, nul, acc_dt, accum_init(c.kind, acc_dt, fx)))
        specs.append((f"nnp_{c.output}", _SRC_USE, _OP_SUM_I64, v, nul, torch.int64, 0))
    return specs


def reduce_scratch_bytes(n: int, n_lanes: int) -> int:
    """Bytes of kernel F's scratch for ``n`` rows and ``n_lanes`` reduced
    lanes, laid out by ``rw_reduce_by_key`` (each region 256-aligned): the
    sort's two (key, row) buffers; the digit counts, eight passes' look-back
    words and counters, and the reduce tiles' flags and counter (zeroed);
    then the reduce tiles' records."""
    a = lambda b: -(-b // 256) * 256
    tiles = -(-n // _kernels.OS_TILE)  # the sort's tiles and the reduce's
    return (2 * a(8 * n) + 2 * a(4 * n) + a(4 * 8 * 256) + a(4 * 8 * (tiles * 256 + 1))
            + a(4 * (tiles + 1)) + 3 * a(4 * tiles) + 3 * a(8 * tiles * n_lanes))


def _reduce_by_key_cuda(key_lanes, signs, calls, values, nulls, fingerprints=None):
    n = signs.shape[0]
    dev = signs.device
    if signs.dtype != torch.int32:
        signs = signs.to(torch.int32)
    _kernels.check_cuda("reduce_by_key", signs, *key_lanes, n=n)
    sorted_keys = tuple(torch.empty_like(k) for k in key_lanes)
    keys = [(k.data_ptr(), _kernels.dtype_code(k), o.data_ptr()) for k, o in zip(key_lanes, sorted_keys)]
    fp = (0, 0)
    if fingerprints is not None:
        h1, h2 = (f.to(torch.int64).contiguous() for f in fingerprints)
        _kernels.check_cuda("reduce_by_key", h1, h2, n=n)
        fp = (h1.data_ptr(), h2.data_ptr())
    specs = _reduced_lane_specs(calls, values, nulls)
    outs, rows = {}, []
    for name, src, op, v, nul, dt, sentinel in specs:
        if v is not None:
            _kernels.check_cuda("reduce_by_key", v, *(() if nul is None else (nul,)), n=n)
        out = torch.empty(n, dtype=dt, device=dev)
        outs[name] = out
        rows.append((
            src, op, 0 if v is None else v.data_ptr(), 0 if v is None else _kernels.dtype_code(v),
            0 if nul is None else nul.data_ptr(), out.data_ptr(), sentinel,
        ))
    rep_valid = torch.empty(n, dtype=torch.bool, device=dev)
    minmax_ret = torch.empty((), dtype=torch.bool, device=dev)  # written by the kernel
    scratch = torch.empty(reduce_scratch_bytes(n, len(rows)), dtype=torch.uint8, device=dev)
    _kernels.call(
        "reduce_by_key", "rw_reduce_by_key",
        _kernels.int64_rows(keys, 8), len(keys), n, signs.data_ptr(), fp[0], fp[1],
        _kernels.int64_rows(rows, 20), len(rows), rep_valid.data_ptr(), minmax_ret.data_ptr(),
        scratch.data_ptr(), scratch.numel(),
    )
    w = outs.pop("w")
    return sorted_keys, rep_valid, w, outs, minmax_ret


def apply_reduced(
    state: AggState,
    calls: Tuple[AggCall, ...],
    slots: torch.Tensor,
    rep_valid: torch.Tensor,
    w: torch.Tensor,
    reduced: Dict[str, torch.Tensor],
    minmax_ret: torch.Tensor,
    live: Optional[torch.Tensor] = None,
) -> AggState:
    """Apply ``reduce_by_key`` output to ``state`` in place
    (``ops/agg.py:464``): one scatter per lane at each representative's
    slot; rows that are not representatives, or whose slot is -1, write
    nothing. With ``live`` (the group table's live lane) each
    representative's slot then gets live = row_count > 0, the
    ``set_live`` of ``hash_agg.py:228-232``. Two representatives may
    share a slot (a visible key whose fingerprints are both 0xFFFFFFFF
    sorts among the invisible rows and splits), so every scatter
    accumulates. Materialized calls are skipped (``ops/agg.py:504-505``)."""
    calls = _unmaterialized(calls)
    if slots.device.type == "cpu":
        _apply_reduced_torch(state, calls, slots, rep_valid, w, reduced, minmax_ret, live)
    elif slots.device.type == "cuda":
        _apply_reduced_cuda(state, calls, slots, rep_valid, w, reduced, minmax_ret, live)
    else:
        raise ValueError(f"unsupported device {slots.device}")
    return state


def _apply_reduced_torch(state, calls, slots, rep_valid, w, reduced, minmax_ret, live):
    active = rep_valid & (slots >= 0)
    idx = slots[active].long()
    ww = w[active]
    state.row_count.index_add_(0, idx, ww)
    state.dirty[idx] = True
    state.sdirty[idx] = True
    for c in calls:
        acc = state.accums[c.output]
        if c.kind == "count_star":
            acc.index_add_(0, idx, ww)
        elif c.kind == "count":
            acc.index_add_(0, idx, reduced[f"cnt_{c.output}"][active])
        elif c.kind == "sum":
            acc.index_add_(0, idx, reduced[f"sum_{c.output}"][active].to(acc.dtype))
            state.nonnull[c.output].index_add_(0, idx, reduced[f"nn_{c.output}"][active])
        else:
            acc.scatter_reduce_(
                0, idx, reduced[f"ext_{c.output}"][active].to(acc.dtype),
                reduce="amin" if c.kind == "min" else "amax",
            )
            state.nonnull[c.output].index_add_(0, idx, reduced[f"nnp_{c.output}"][active])
    state.minmax_retracted |= minmax_ret
    if live is not None:
        live[idx] = state.row_count[idx] > 0


def _apply_reduced_cuda(state, calls, slots, rep_valid, w, reduced, minmax_ret, live):
    n = slots.shape[0]
    cap = state.capacity
    if slots.dtype != torch.int32 or w.dtype != torch.int64 or rep_valid.dtype != torch.bool:
        raise TypeError("apply_reduced: slots int32, w int64, rep_valid bool")
    _kernels.check_cuda("apply_reduced", slots, rep_valid, w, n=n)
    _kernels.check_cuda("apply_reduced", state.row_count, state.dirty, state.sdirty, n=cap)
    _kernels.check_cuda("apply_reduced", minmax_ret, state.minmax_retracted)
    rows = []
    for c in calls:
        acc = state.accums[c.output]
        nonnull = state.nonnull.get(c.output)
        _kernels.check_cuda("apply_reduced", acc, *(() if nonnull is None else (nonnull,)), n=cap)
        red = nn_red = None
        if c.kind == "count":
            red = reduced[f"cnt_{c.output}"]
        elif c.kind == "sum":
            red, nn_red = reduced[f"sum_{c.output}"], reduced[f"nn_{c.output}"]
        elif c.kind in ("min", "max"):
            red, nn_red = reduced[f"ext_{c.output}"], reduced[f"nnp_{c.output}"]
        for lane in (red, nn_red):
            if lane is not None:
                _kernels.check_cuda("apply_reduced", lane, n=n)
        if red is not None and red.dtype != acc.dtype:
            raise TypeError(f"apply_reduced: {c.output} lane {red.dtype} != accumulator {acc.dtype}")
        if nn_red is not None and nn_red.dtype != torch.int64:
            raise TypeError("apply_reduced: non-null lanes must be int64")
        rows.append((
            _KIND_CODE[c.kind], _kernels.dtype_code(acc), acc.data_ptr(),
            0 if red is None else red.data_ptr(),
            0 if nonnull is None else nonnull.data_ptr(),
            0 if nn_red is None else nn_red.data_ptr(),
        ))
    if live is not None:
        _kernels.check_cuda("apply_reduced", live, n=cap)
    _kernels.call(
        "apply_reduced", "rw_apply_reduced",
        _kernels.int64_rows(rows, 16), len(rows), n, slots.data_ptr(), rep_valid.data_ptr(),
        w.data_ptr(), state.row_count.data_ptr(), state.dirty.data_ptr(), state.sdirty.data_ptr(),
        minmax_ret.data_ptr(), state.minmax_retracted.data_ptr(),
        0 if live is None else live.data_ptr(),
    )


def _reset_groups(
    state: AggState,
    calls: Tuple[AggCall, ...],
    slots: torch.Tensor,
    *,
    mark_dirty: bool,
    float_extremes: tuple = (),
) -> AggState:
    """Zero out groups' accumulators in place (``ops/agg.py:533``);
    ``slots`` -1 writes nothing. Plain PyTorch, CPU only (on the card
    the expiry's kernel O does this, ``expire_groups``).

    ``mark_dirty=True`` (delete_groups): the next flush emits a Delete
    for each previously emitted group — windowed retraction.
    ``mark_dirty=False`` (forget_groups): silent finalisation — the
    flush emits nothing and downstream keeps the last emitted row as the
    window's final result (emit-on-window-close). Callers must flush
    dirty groups first or pending updates are lost."""
    _cpu_only("_reset_groups", slots)
    return _reset_groups_torch(state, calls, slots, mark_dirty, float_extremes)


def _reset_groups_torch(state, calls, slots, mark_dirty, float_extremes) -> AggState:
    idx = slots[slots >= 0].long()
    state.row_count[idx] = 0
    state.sdirty[idx] = True
    state.dirty[idx] = mark_dirty
    if not mark_dirty:
        state.emitted_valid[idx] = False
    for c in calls:
        acc = state.accums[c.output]
        acc[idx] = _accum_init_of(c, acc, float_extremes)
    for nn in state.nonnull.values():
        nn[idx] = 0
    return state


def _accum_init_of(call: AggCall, acc: torch.Tensor, float_extremes: tuple) -> int:
    return accum_init(call.kind, acc.dtype, dict(float_extremes).get(call.output))


def delete_groups(state: AggState, calls, slots, float_extremes: tuple = ()) -> AggState:
    """Drop whole groups (window expiry) with downstream retraction."""
    return _reset_groups(state, calls, slots, mark_dirty=True, float_extremes=float_extremes)


def forget_groups(state: AggState, calls, slots, float_extremes: tuple = ()) -> AggState:
    """Silently free groups (EOWC finalisation). See ``_reset_groups``."""
    return _reset_groups(state, calls, slots, mark_dirty=False, float_extremes=float_extremes)


def _cpu_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{name} is a plain PyTorch version for the CPU; on the card the watermark "
            "expiry runs in kernel O (expire_groups)"
        )


def expire_groups(table, state: AggState, calls: Tuple[AggCall, ...], key_index: int,
                  cutoff: int, mark_dirty: bool, float_extremes: tuple = ()) -> None:
    """Watermark state cleaning of a HashAgg, in place
    (``hash_agg.py:_expire`` :393): every live group whose key lane
    ``key_index`` < ``cutoff`` turns dead and is reset, as
    ``delete_groups`` (``mark_dirty``) or ``forget_groups`` reset
    groups.
    Kernel O's ``rw_expire_agg`` (``csrc/expire.cu``) on the card; on
    the CPU the mask, ``_reset_groups`` and ``set_live``."""
    dev = state.row_count.device
    if dev.type == "cpu":
        _expire_groups_torch(table, state, calls, key_index, cutoff, mark_dirty, float_extremes)
    elif dev.type == "cuda":
        _expire_groups_cuda(table, state, calls, key_index, cutoff, mark_dirty, float_extremes)
    else:
        raise ValueError(f"unsupported device {dev}")


def _expire_groups_torch(table, state, calls, key_index, cutoff, mark_dirty, float_extremes):
    expired = expired_slots(table, key_index, cutoff)
    slots = torch.where(
        expired, torch.arange(table.capacity, dtype=torch.int32, device=expired.device), -1
    )
    _reset_groups_torch(state, calls, slots, mark_dirty, float_extremes)
    table.live &= ~expired


def _init_bits(value: int, dtype: torch.dtype) -> int:
    """A lane's init value as the raw bits kernel O writes."""
    bits = {4: torch.int32, 8: torch.int64}[dtype.itemsize]
    return int(torch.tensor([value], dtype=dtype).view(bits)[0])


def _expire_groups_cuda(table, state, calls, key_index, cutoff, mark_dirty, float_extremes):
    cap = state.capacity
    args = expiry_key_args("expire_agg", table, key_index, state.sdirty, state.dirty,
                           state.emitted_valid)
    _kernels.check_cuda("expire_agg", state.row_count, n=cap)
    if state.row_count.dtype != torch.int64:
        raise TypeError("expire_agg: row_count must be int64")
    rows = []
    for c in calls:
        acc = state.accums[c.output]
        if acc.element_size() not in (4, 8):
            raise TypeError(f"expire_agg: accumulator {c.output} of dtype {acc.dtype}")
        rows.append((acc.data_ptr(), acc.element_size(),
                     _init_bits(_accum_init_of(c, acc, float_extremes), acc.dtype)))
    for nn in state.nonnull.values():
        rows.append((nn.data_ptr(), nn.element_size(), 0))
    _kernels.check_cuda("expire_agg", *state.accums.values(), *state.nonnull.values(), n=cap)
    _kernels.call(
        "expire", "rw_expire_agg", *args, int(cutoff), state.row_count.data_ptr(),
        state.sdirty.data_ptr(), state.dirty.data_ptr(), state.emitted_valid.data_ptr(),
        int(mark_dirty), _kernels.int64_rows(rows, _kernels.EXPIRE_AGG_LANES), len(rows),
    )


def flush(
    state: AggState,
    table_keys: Tuple[torch.Tensor, ...],
    out_cap: int,
    float_extremes: tuple = (),
    dirty_total: Optional[torch.Tensor] = None,
):
    """Emit the per-barrier delta for up to ``out_cap`` dirty groups, in
    ascending slot order (hash_agg.rs:406); updates ``state`` in place.

    Returns ``(state, delta)``; delta holds (2 * min(out_cap,
    capacity),) lanes (the reference's ``order[:out_cap]`` slice is
    clamped to the table) ``ops``, ``valid``, ``key<i>``, one per agg output and
    ``<output>__isnull`` for NULLABLE_KINDS, with rows interleaved
    (old_i, new_i): old (U-/D) rows carry the previously emitted values,
    new (U+/I) rows the current ones. ``status`` is the (2,) int32
    [groups taken, overflow]; overflow means more dirty groups remain
    and the caller must flush again. Float MIN/MAX lanes listed in
    ``float_extremes`` are decoded back to floats. ``dirty_total``, a ()
    int64 tensor, if given receives the number of dirty groups before
    this round (counted by the flush's own pass over ``dirty``).
    """
    out_cap = min(int(out_cap), state.capacity)
    if state.dirty.device.type == "cpu":
        return state, _flush_torch(state, table_keys, out_cap, float_extremes, dirty_total)
    if state.dirty.device.type == "cuda":
        return state, _flush_cuda(state, table_keys, out_cap, float_extremes, dirty_total)
    raise ValueError(f"unsupported device {state.dirty.device}")


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=1).reshape(-1)


def _flush_torch(state, table_keys, out_cap, float_extremes, dirty_total=None):
    dev = state.dirty.device
    dirty_ids = torch.nonzero(state.dirty).flatten()
    n_dirty = dirty_ids.numel()
    if dirty_total is not None:
        dirty_total.fill_(n_dirty)
    n_take = min(n_dirty, out_cap)
    take = dirty_ids[:n_take]
    pad = out_cap - n_take

    def rows(lane_at_take, fill):
        return torch.cat([lane_at_take, torch.full((pad,), fill, dtype=lane_at_take.dtype, device=dev)])

    live = rows(state.row_count[take] > 0, False)
    was = rows(state.emitted_valid[take], False)
    minus_op = torch.where(live, int(Op.UPDATE_DELETE), int(Op.DELETE)).to(torch.int32)
    plus_op = torch.where(was, int(Op.UPDATE_INSERT), int(Op.INSERT)).to(torch.int32)
    in_take = torch.arange(out_cap, device=dev) < n_take
    delta = {
        "ops": _interleave(minus_op * in_take, plus_op * in_take),
        "valid": _interleave(was, live),
        "status": torch.tensor([n_take, int(n_dirty > out_cap)], dtype=torch.int32, device=dev),
    }
    for i, lane in enumerate(table_keys):
        kv = rows(lane[take], 0)
        delta[f"key{i}"] = _interleave(kv, kv)
    decode = dict(float_extremes)
    for name, acc in state.accums.items():
        old = rows(state.emitted[name][take], 0)
        new = rows(acc[take], 0)
        if name in decode:
            zero = torch.zeros((), dtype=decode[name], device=dev)
            old = torch.where(in_take, _order_key_to_float(old, decode[name]), zero)
            new = torch.where(in_take, _order_key_to_float(new, decode[name]), zero)
        delta[name] = _interleave(old, new)
    for name, nn in state.nonnull.items():
        old_isnull = rows(state.emitted_isnull[name][take], False)
        new_isnull = rows(nn[take] == 0, False)
        delta[name + "__isnull"] = _interleave(old_isnull, new_isnull)
    # snapshot what was just emitted, for the taken slots only
    for name in state.accums:
        state.emitted[name][take] = state.accums[name][take]
    for name in state.nonnull:
        state.emitted_isnull[name][take] = state.nonnull[name][take] == 0
    state.emitted_valid[take] = state.row_count[take] > 0
    state.dirty[take] = False
    return delta


def _flush_cuda(state, table_keys, out_cap, float_extremes, dirty_total=None):
    cap = state.capacity
    dev = state.dirty.device
    if dirty_total is not None:
        if dirty_total.shape != () or dirty_total.dtype != torch.int64:
            raise TypeError("dirty_total must be a () int64 tensor")
        _kernels.check_cuda("agg_flush", state.dirty, dirty_total)
    lanes = [state.row_count, state.emitted_valid, state.dirty, *table_keys]
    lanes += list(state.accums.values()) + list(state.emitted.values())
    lanes += list(state.nonnull.values()) + list(state.emitted_isnull.values())
    _kernels.check_cuda("agg_flush", *lanes, n=cap)
    if state.dirty.data_ptr() % 16:
        raise ValueError("agg_flush: the dirty lane must be 16-byte aligned")
    n_out = 2 * out_cap
    empty = lambda dt: torch.empty(n_out, dtype=dt, device=dev)
    delta = {"ops": empty(torch.int32), "valid": empty(torch.bool)}
    gather = []

    def add(name, old_src, new_src, out_dtype, xform=0):
        out = empty(out_dtype)
        delta[name] = out
        gather.append((old_src.data_ptr(), new_src.data_ptr(), out.data_ptr(),
                       out.element_size(), xform))

    for i, lane in enumerate(table_keys):
        add(f"key{i}", lane, lane, lane.dtype)
    decode = dict(float_extremes)
    for name, acc in state.accums.items():
        if name in decode:
            fdt = decode[name]
            add(name, state.emitted[name], acc, fdt, 1 if fdt == torch.float32 else 2)
        else:
            add(name, state.emitted[name], acc, acc.dtype)
    for name, nn in state.nonnull.items():
        add(name + "__isnull", state.emitted_isnull[name], nn, torch.bool, 3)
    snap = [
        (state.accums[n].data_ptr(), state.emitted[n].data_ptr(),
         state.accums[n].element_size(), 0)
        for n in state.accums
    ]
    snap += [
        (state.nonnull[n].data_ptr(), state.emitted_isnull[n].data_ptr(), 1, 1)
        for n in state.nonnull
    ]
    n_tiles = -(-cap // 4096)  # agg_flush.cu FL_TILE
    tile_counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    status = torch.empty(2, dtype=torch.int32, device=dev)
    _kernels.call(
        "agg_flush", "rw_agg_flush",
        _kernels.int64_rows(gather, 16), len(gather), _kernels.int64_rows(snap, 16), len(snap),
        state.dirty.data_ptr(), cap, tile_counts.data_ptr(), status.data_ptr(), out_cap,
        state.row_count.data_ptr(), state.emitted_valid.data_ptr(),
        delta["ops"].data_ptr(), delta["valid"].data_ptr(),
        0 if dirty_total is None else dirty_total.data_ptr(),
    )
    delta["status"] = status
    return delta
