"""Dynamic filters: against a per-group running maximum, and against a
moving one-row right value.

Port of ``risingwave_tpu/executors/dynamic_filter.py``. Reference:
src/stream/src/executor/dynamic_filter.rs:40 -- filters the left input
against a moving right-side value.

``DynamicMaxFilterExecutor`` (``filter_step_fn`` :56, ``_rebuild`` :98,
the executor :111) is the grouped, append-only specialisation q7's plan
uses: pass a row iff ``value >= max-so-far(group)``. A bid below its
window's running max can never match a later max (an append-only max
only rises), so dropping it early keeps the join's bid side at the
chain of ascending maxima and their ties. The comparison uses the max
BEFORE the current chunk (same-chunk stragglers pass and the join's
probe drops them), then folds the chunk into the running max. Per
chunk: kernel A finds or inserts the group key, then kernel N
(``csrc/dyn_filter.cu``) decides, resets the maxes of newly claimed
slots, folds and latches ``saw_delete`` / ``dropped``. A watermark on
``window_key`` expires closed groups (kernel O,
``ops.hash_table.expire_table``). Checkpoint and restore
(``dynamic_filter.py:348-390``) are the key table's of
``KeyTableGrowth`` with the ``max`` lane (kernel R).

``DynamicFilterExecutor`` (``_dyn_left_step`` :417, ``_dyn_rv_diff``
:442, the executor :451) is the general one: it emits the left rows
with ``value_col <op> rv``, ``rv`` the last value of a one-row right
change stream (a SimpleAgg, say). Left rows are stored by pk: kernel A
finds or inserts the pk, then kernel Z's left step
(``csrc/dyn_general.cu``) stores the last row per pk and passes the
rows that pass against the current ``rv``. Right moves apply at the
barrier: kernel Z's diff recomputes the pass set over the store, and
the rows that flipped are pulled through kernel R's gather and emitted
as DELETE then INSERT chunks. Its checkpoint is two tables, the row
store (``KeyTableGrowth``'s, with the row and pass lanes) and the
right value.

Both walk the bucket lattice (the reference's unbucketed twins are not
ported). State is updated in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk, _numpy_dtype
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.executors.dedup import GROW_AT, KeyTableGrowth
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    _last_occurrence_torch,
    expire_table,
    lookup_or_insert,
    move_slots,
    set_live,
    stage_scalars,
)
from risingwave_tpu_torch.runtime.bucketing import BucketAllocator, BucketPolicy, emission_bucket
from risingwave_tpu_torch.storage.state_table import StateDelta, pull_rows
from risingwave_tpu_torch.types import Op

_VALUE_DTYPES = (torch.int32, torch.int64)


def filter_step_fn(table: HashTable, maxes, sdirty, chunk: StreamChunk, group_col: str,
                   value_col: str, latches):
    """One chunk through the filter, in place: returns ``(table, maxes,
    sdirty, out)``, ``out`` the chunk with only its passing rows
    visible. ``latches`` = (saw_delete, dropped), () bool tensors set in
    place."""
    keys = (chunk.col(group_col),)
    value = chunk.col(value_col)
    signs = chunk.effective_signs()
    valid = chunk.valid & (signs > 0)
    table, slots, _, inserted = lookup_or_insert(table, keys, valid)
    if slots.device.type == "cpu":
        ok = _filter_torch(table, maxes, sdirty, chunk, value, signs, valid, slots, inserted,
                           latches)
    elif slots.device.type == "cuda":
        ok = _filter_cuda(table, maxes, sdirty, chunk, value, slots, inserted, latches)
    else:
        raise ValueError(f"unsupported device {slots.device}")
    return table, maxes, sdirty, chunk.mask(ok)


def _filter_torch(table, maxes, sdirty, chunk, value, signs, valid, slots, inserted, latches):
    """The reference's ``filter_step_fn`` after its find-or-insert, line
    for line, except that a row without a slot folds nothing (the
    reference's index -1 wraps to the last slot; its barrier raises on
    ``dropped`` either way)."""
    saw_delete, dropped = latches
    saw_delete |= (chunk.valid & (signs < 0)).any()
    set_live(table, torch.where(inserted, slots, -1), True)
    dropped |= (valid & (slots < 0)).any()
    sl = slots.clamp(min=0).long()
    # pass iff >= the pre-chunk max of the row's group (new groups pass)
    ok = valid & (inserted | (value >= maxes[sl]))
    # then fold the chunk in: new groups start again from the minimum
    take = valid & (slots >= 0)
    idx = slots[take].long()
    init = torch.iinfo(maxes.dtype).min
    maxes[idx] = torch.where(inserted[take], torch.full_like(maxes[idx], init), maxes[idx])
    maxes.scatter_reduce_(0, idx, value[take].to(maxes.dtype), reduce="amax")
    sdirty[idx] = True
    return ok


def _filter_cuda(table, maxes, sdirty, chunk, value, slots, inserted, latches):
    n = chunk.capacity
    saw_delete, dropped = latches
    _kernels.check_cuda("dyn_filter", chunk.valid, chunk.ops, slots, inserted, value, n=n)
    _kernels.check_cuda("dyn_filter", table.live, maxes, sdirty, n=table.capacity)
    _kernels.check_cuda("dyn_filter", chunk.valid, saw_delete, dropped)
    if value.dtype != maxes.dtype or value.dtype not in _VALUE_DTYPES:
        raise TypeError("dyn_filter: value and maxes lanes of one int32 or int64 dtype")
    if chunk.ops.dtype != torch.int32 or slots.dtype != torch.int32:
        raise TypeError("dyn_filter: int32 ops and slots lanes")
    if saw_delete.dtype != torch.bool or dropped.dtype != torch.bool:
        raise TypeError("dyn_filter: bool latches")
    ok = torch.empty(n, dtype=torch.bool, device=slots.device)
    _kernels.call(
        "dyn_filter", "rw_dyn_filter", n, chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        slots.data_ptr(), inserted.data_ptr(), value.data_ptr(), _kernels.dtype_code(value),
        maxes.data_ptr(), table.live.data_ptr(), sdirty.data_ptr(), table.capacity,
        ok.data_ptr(), saw_delete.data_ptr(), dropped.data_ptr(),
    )
    return ok


def _rebuild(table: HashTable, maxes, sdirty, stored, new_cap: int):
    """Re-insert the kept keys (``live | sdirty``) into a fresh table
    (kernel A) and move the slot lanes there (kernel I). Returns
    ``(table, maxes, sdirty, stored)``."""
    keep = table.live | sdirty
    dev = table.device
    new = HashTable.create(new_cap, tuple(k.dtype for k in table.keys), device=dev)
    new, slots, _, _ = lookup_or_insert(new, table.keys, keep)
    new_maxes = torch.full((new_cap,), torch.iinfo(maxes.dtype).min, dtype=maxes.dtype,
                           device=dev)
    new_sdirty = torch.zeros(new_cap, dtype=torch.bool, device=dev)
    new_stored = torch.zeros(new_cap, dtype=torch.bool, device=dev)
    move_slots((table.live, maxes, sdirty, stored), (new.live, new_maxes, new_sdirty, new_stored),
               slots, keep)
    return new, new_maxes, new_sdirty, new_stored


class DynamicMaxFilterExecutor(KeyTableGrowth, Executor):
    """Append-only: pass rows with ``value_col >= running max`` of their
    ``group_col`` group. Conservative: it may pass superseded rows, and
    never drops a row that could still match a later group max.

    ``window_key``: (column, retention) — a watermark on ``column``
    expires every group whose key lies below ``value - retention``.
    Growth and the barrier checks are the dedup's (``KeyTableGrowth``)."""

    _DELETE_ERROR = "dynamic max filter received a DELETE"
    _DROPPED_ERROR = "dynamic filter table overflowed MAX_PROBE; grow capacity"

    def __init__(
        self,
        group_col: str,
        value_col: str,
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 14,
        window_key: Optional[Tuple[str, int]] = None,
        table_id: str = "dynfilter",
        bucket_policy: Optional[BucketPolicy] = None,
        device="cuda",
    ):
        vdtype = schema_dtypes[value_col]
        if vdtype not in _VALUE_DTYPES:
            raise TypeError(f"dynamic filter value column must be int32 or int64, not {vdtype}")
        self.device = resolve_device(device)
        self.group_col = group_col
        self.value_col = value_col
        self.table_id = table_id
        self.table = HashTable.create(capacity, (schema_dtypes[group_col],), device=self.device)
        self.maxes = torch.full((capacity,), torch.iinfo(vdtype).min, dtype=vdtype,
                                device=self.device)
        self.sdirty = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self.stored = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self.window_key = window_key
        self._buckets = BucketAllocator(
            bucket_policy or BucketPolicy.from_capacity(capacity, grow_at=GROW_AT)
        )
        self._bound = 0
        self._occ_note = 0  # true claimed at the last barrier (staged)
        self._grew_midepoch = False  # one overflow-guard bump per epoch
        self._saw_delete = torch.zeros((), dtype=torch.bool, device=self.device)
        self._dropped = torch.zeros((), dtype=torch.bool, device=self.device)

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        if self.group_col in chunk.nulls or self.value_col in chunk.nulls:
            raise ValueError("dynamic filter columns must be non-nullable")
        self._maybe_grow(chunk.capacity)
        self._bound += chunk.capacity
        self.table, self.maxes, self.sdirty, out = filter_step_fn(
            self.table, self.maxes, self.sdirty, chunk, self.group_col, self.value_col,
            (self._saw_delete, self._dropped),
        )
        return [out]

    def _rebuild_to(self, new_cap: int) -> None:
        self.table, self.maxes, self.sdirty, self.stored = _rebuild(
            self.table, self.maxes, self.sdirty, self.stored, new_cap
        )

    def _value_lanes(self):
        return {"max": self.maxes}

    def _reset_state(self, cap: int) -> None:
        dev = self.table.device
        self.maxes = torch.full((cap,), torch.iinfo(self.maxes.dtype).min,
                                dtype=self.maxes.dtype, device=dev)
        self.sdirty = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.stored = torch.zeros(cap, dtype=torch.bool, device=dev)

    def on_watermark(self, watermark: Watermark):
        if self.window_key is None or watermark.column != self.window_key[0]:
            return watermark, []
        expire_table(self.table, self.sdirty, 0, watermark.value - self.window_key[1])
        return watermark, []

    # -- integrity --------------------------------------------------------
    def digest_lanes(self):
        return integrity.filter_lanes(self.table, self.maxes)

    def state_digest(self) -> int:
        """Host twin of the fused program's digest lane."""
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))


# -- the general dynamic filter (comparator, both directions) -----------------
_CMP = {
    ">": lambda v, rv: v > rv,
    ">=": lambda v, rv: v >= rv,
    "<": lambda v, rv: v < rv,
    "<=": lambda v, rv: v <= rv,
}
_CMP_CODE = {">": 0, ">=": 1, "<": 2, "<=": 3}  # dyn_general.cu DgCmp


def dyn_left_step(table: HashTable, rows, passing, sdirty, scratch, chunk: StreamChunk, rv,
                  rv_valid, op: str, pk, value_col: str, dropped):
    """Store the left chunk's rows by pk and pass them through the
    comparator against the CURRENT right value (right moves apply at the
    barrier, so ``cmp(value, rv)`` is every stored row's emitted status),
    in place: returns ``(table, out)``, ``out`` the chunk masked by
    ``valid & rv_valid & cmp(value, rv)``. Where rows of the chunk share
    a pk, the last one writes every lane. ``scratch`` is the store's
    per-slot int32 lane (all -1 between calls); ``dropped`` a () bool
    latch."""
    keys = tuple(chunk.col(k) for k in pk)
    signs = chunk.effective_signs()
    active = chunk.valid & (signs != 0)
    table, slots, _, _ = lookup_or_insert(table, keys, active)
    if slots.device.type == "cpu":
        ok = _dyn_left_torch(table, rows, passing, sdirty, chunk, slots, signs, active, rv,
                             rv_valid, op, value_col, dropped)
    elif slots.device.type == "cuda":
        ok = _dyn_left_cuda(table, rows, passing, sdirty, scratch, chunk, slots, rv, rv_valid,
                            op, value_col, dropped)
    else:
        raise ValueError(f"unsupported device {slots.device}")
    return table, chunk.mask(ok)


def _dyn_left_torch(table, rows, passing, sdirty, chunk, slots, signs, active, rv, rv_valid, op,
                    value_col, dropped):
    """The reference's step after its find-or-insert, with the last row
    per slot elected explicitly (XLA's CPU scatter lets the last write
    win; a torch index_put_ with repeated indices does not say which
    does), so it also runs on CUDA tensors."""
    dropped |= (active & (slots < 0)).any()
    ok = chunk.valid & rv_valid & _CMP[op](chunk.col(value_col), rv)
    win = _last_occurrence_torch(slots, active)
    idx = slots[win].long()
    for n, lane in rows.items():
        lane[idx] = chunk.col(n)[win].to(lane.dtype)
    ins = signs[win] > 0
    table.live[idx] = ins
    sdirty[idx] = True
    passing[idx] = ok[win] & ins
    return ok


def _dyn_left_cuda(table, rows, passing, sdirty, scratch, chunk, slots, rv, rv_valid, op,
                   value_col, dropped):
    n = chunk.capacity
    cap = table.capacity
    value = chunk.col(value_col)
    _kernels.check_cuda("dyn_general", chunk.valid, chunk.ops, slots, value, n=n)
    _kernels.check_cuda("dyn_general", table.live, passing, sdirty, scratch, *rows.values(),
                        n=cap)
    _kernels.check_cuda("dyn_general", chunk.valid, rv, rv_valid, dropped)
    if chunk.ops.dtype != torch.int32 or slots.dtype != torch.int32:
        raise TypeError("dyn_general: int32 ops and slots lanes")
    if scratch.dtype != torch.int32 or rv_valid.dtype != torch.bool or dropped.dtype != torch.bool:
        raise TypeError("dyn_general: int32 scratch, bool rv_valid and dropped")
    if value.dtype != rv.dtype or rv.shape != ():
        raise TypeError("dyn_general: rv is a () tensor of the value column's dtype")
    lanes, keep_alive = [], []
    for name, dst in rows.items():
        src = chunk.col(name)
        if src.dtype != dst.dtype:
            src = src.to(dst.dtype)  # the reference's set casts on write
            keep_alive.append(src)
        _kernels.check_cuda("dyn_general", src, n=n)
        lanes.append((src.data_ptr(), dst.data_ptr(), dst.element_size()))
    ok = torch.empty(n, dtype=torch.bool, device=slots.device)
    _kernels.call(
        "dyn_general", "rw_dyn_left_step", _kernels.int64_rows(lanes, 8), len(lanes), n,
        chunk.valid.data_ptr(), chunk.ops.data_ptr(), slots.data_ptr(), value.data_ptr(),
        _kernels.dtype_code(value), rv.data_ptr(), rv_valid.data_ptr(), _CMP_CODE[op],
        scratch.data_ptr(), table.live.data_ptr(), sdirty.data_ptr(), passing.data_ptr(),
        ok.data_ptr(), dropped.data_ptr(),
    )
    return ok


def dyn_rv_diff(table: HashTable, value, passing, sdirty, rv, rv_valid, op: str, dropped):
    """The right value moved: ``mask_new = live & rv_valid & cmp(value,
    rv)`` over the store, ``passing = mask_new`` and ``sdirty |=
    changed`` in place (a checkpoint must persist the flipped rows with
    the new rv). Returns ``(sel, now, n, dropped)``: the ``n`` changed
    slots in ascending order (int32) with their new status, and the
    left steps' overflow latch, read with the count (one read)."""
    if value.device.type == "cpu":
        return _dyn_rv_diff_torch(table, value, passing, sdirty, rv, rv_valid, op, dropped)
    if value.device.type == "cuda":
        return _dyn_rv_diff_cuda(table, value, passing, sdirty, rv, rv_valid, op, dropped)
    raise ValueError(f"unsupported device {value.device}")


def _dyn_rv_diff_torch(table, value, passing, sdirty, rv, rv_valid, op, dropped):
    mask_new = table.live & rv_valid & _CMP[op](value, rv)
    changed = mask_new != passing
    passing.copy_(mask_new)
    sdirty |= changed
    sel = torch.nonzero(changed).flatten().to(torch.int32)
    return sel, mask_new[sel.long()], int(sel.numel()), bool(dropped)


def _dyn_rv_diff_cuda(table, value, passing, sdirty, rv, rv_valid, op, dropped):
    cap = table.capacity
    _kernels.check_cuda("dyn_general", table.live, value, passing, sdirty, n=cap)
    _kernels.check_cuda("dyn_general", value, rv, rv_valid, dropped)
    if value.dtype != rv.dtype or rv.shape != ():
        raise TypeError("dyn_general: rv is a () tensor of the value lane's dtype")
    dev = value.device
    tile_counts = _kernels.compact_scratch(cap, dev)
    sel = torch.empty(cap, dtype=torch.int32, device=dev)
    now = torch.empty(cap, dtype=torch.bool, device=dev)
    status = torch.empty(2, dtype=torch.int64, device=dev)
    _kernels.call(
        "dyn_general", "rw_dyn_rv_diff", cap, table.live.data_ptr(), value.data_ptr(),
        _kernels.dtype_code(value), rv.data_ptr(), rv_valid.data_ptr(), _CMP_CODE[op],
        passing.data_ptr(), sdirty.data_ptr(), dropped.data_ptr(), tile_counts.data_ptr(),
        sel.data_ptr(), now.data_ptr(), status.data_ptr(),
    )
    n, drop = status.tolist()  # the diff's one scalar read
    return sel[:n], now[:n], int(n), bool(drop)


class DynamicFilterExecutor(KeyTableGrowth, Executor):
    """General dynamic filter (dynamic_filter.rs:40): emits the left rows
    with ``value_col <op> right value``, the right side a one-row change
    stream (a SimpleAgg, say). Right moves apply at the barrier and
    re-emit or retract stored rows, both ways. Growth (kernels A and I)
    and the row store's checkpoint are ``KeyTableGrowth``'s."""

    _DROPPED_ERROR = "dynamic filter row store overflowed; grow capacity"

    def __init__(
        self,
        value_col: str,
        op: str,
        pk: Sequence[str],
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 14,
        table_id: str = "dynfilter_general",
        bucket_policy: Optional[BucketPolicy] = None,
        device="cuda",
    ):
        if op not in _CMP:
            raise ValueError(f"unsupported comparator {op!r}")
        self.device = resolve_device(device)
        self._buckets = BucketAllocator(
            bucket_policy or BucketPolicy.from_capacity(capacity, grow_at=GROW_AT)
        )
        self.op = op
        self.value_col = value_col
        self.pk = tuple(pk)
        self.names = tuple(sorted(schema_dtypes))
        self._dtypes = {n: schema_dtypes[n] for n in self.names}
        self.table = HashTable.create(capacity, tuple(self._dtypes[k] for k in self.pk),
                                      device=self.device)
        self._reset_state(capacity)
        self.rv = torch.zeros((), dtype=self._dtypes[value_col], device=self.device)
        self.rv_valid = torch.zeros((), dtype=torch.bool, device=self.device)
        self._staged_rv = None  # (device value, device valid) pending
        self._rv_dirty = True  # the first checkpoint must persist the rv
        self.table_id = table_id
        self._bound = 0
        self._dropped = torch.zeros((), dtype=torch.bool, device=self.device)

    def _reset_state(self, cap: int) -> None:
        dev = self.device
        z = lambda d: torch.zeros(cap, dtype=d, device=dev)
        self.rows = {n: z(self._dtypes[n]) for n in self.names}
        self.passing = z(torch.bool)
        self.sdirty = z(torch.bool)
        self.stored = z(torch.bool)
        self.scratch = torch.full((cap,), -1, dtype=torch.int32, device=dev)

    def _value_lanes(self) -> Dict[str, torch.Tensor]:
        lanes = {f"r_{n}": a for n, a in self.rows.items()}
        lanes["pass"] = self.passing
        return lanes

    def _rebuild_to(self, new_cap: int) -> None:
        """The kept slots (``live | sdirty``) re-inserted into a fresh
        table (kernel A), their lanes moved there (kernel I)."""
        keep = self.table.live | self.sdirty
        new = HashTable.create(new_cap, tuple(k.dtype for k in self.table.keys),
                               device=self.device)
        new, slots, _, _ = lookup_or_insert(new, self.table.keys, keep)
        old = (self.rows, self.passing, self.sdirty, self.stored)
        self._reset_state(new_cap)
        srcs = (self.table.live, *old[0].values(), *old[1:])
        dsts = (new.live, *self.rows.values(), self.passing, self.sdirty, self.stored)
        move_slots(srcs, dsts, slots, keep)
        self.table = new

    # -- left input -------------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self.apply_left(chunk)

    def apply_left(self, chunk: StreamChunk) -> List[StreamChunk]:
        for c in self.pk + (self.value_col,):
            if c in chunk.nulls:
                raise ValueError(f"dynamic filter column {c!r} cannot be NULL")
        self._maybe_grow(chunk.capacity)
        self._bound += chunk.capacity
        self.table, out = dyn_left_step(
            self.table, self.rows, self.passing, self.sdirty, self.scratch, chunk, self.rv,
            self.rv_valid, self.op, self.pk, self.value_col, self._dropped,
        )
        return [out]

    # -- right input (a one-row change stream) ----------------------------
    def apply_right(self, chunk: StreamChunk) -> List[StreamChunk]:
        """Stage the chunk's right value on the card, no host read. Rows
        apply in order (dynamic_filter.rs): the last insert gives the
        value, the last op its validity, so an insert followed by its
        own retraction leaves no right value. A NULL lane is not read,
        as in the reference: a NULL row's placeholder value is valid."""
        signs = chunk.effective_signs()
        pos = torch.arange(chunk.capacity, dtype=torch.int32, device=signs.device)
        none = torch.full_like(pos, -1)
        last_ins = torch.where(chunk.valid & (signs > 0), pos, none).max()
        last_del = torch.where(chunk.valid & (signs < 0), pos, none).max()
        at = last_ins.clamp(min=0).reshape(1).long()
        v = chunk.col(self.value_col).index_select(0, at).reshape(())
        prev_v, prev_valid = self._staged_rv or (self.rv, self.rv_valid)
        new_v = torch.where(last_ins >= 0, v.to(self.rv.dtype), prev_v)
        # positions differ, so last_ins == last_del only when both are -1
        new_valid = (last_ins > last_del) | ((last_ins == last_del) & prev_valid)
        self._staged_rv = (new_v, new_valid)
        return []

    def on_barrier(self, barrier) -> List[StreamChunk]:
        """Apply the staged right value: kernel Z's diff, then the rows
        that flipped, pulled through kernel R's gather, as a DELETE chunk
        and an INSERT chunk in pow2 emission buckets (in slot order).
        With no staged value only the overflow latch is staged."""
        self._buckets.note_barrier(self.table.capacity, self._bound)
        if self._staged_rv is None:
            self._staged_scalars = stage_scalars(self._dropped)
            if barrier is None:  # direct drive: checks fire inline
                self.finish_barrier()
            return []
        self.rv, self.rv_valid = self._staged_rv
        self._staged_rv = None
        self._rv_dirty = True
        sel, now, n, dropped = dyn_rv_diff(
            self.table, self.rows[self.value_col], self.passing, self.sdirty, self.rv,
            self.rv_valid, self.op, self._dropped,
        )
        if dropped:
            raise RuntimeError(self._DROPPED_ERROR)
        if not n:
            return []
        pulled = pull_rows(self.rows, sel, {"__now__": now})
        now_h = pulled.pop("__now__")
        outs = []
        for promote in (False, True):
            m = now_h == promote
            k = int(m.sum())
            if not k:
                continue
            outs.append(StreamChunk.from_numpy(
                {name: pulled[name][m] for name in self.names}, emission_bucket(k),
                ops=np.full(k, int(Op.INSERT if promote else Op.DELETE), np.int32),
                device=self.device,
            ))
        return outs

    def _on_barrier_scalars(self, vals) -> None:
        if vals[0]:
            raise RuntimeError(self._DROPPED_ERROR)

    # -- integrity --------------------------------------------------------
    def digest_lanes(self):
        """Keys, row lanes and pass flags of the live rows; the one-row
        right value folds in as lanes broadcast over the live slots."""
        lanes = {f"k{i}": k for i, k in enumerate(self.table.keys)}
        live = self.table.live
        for n in self.names:
            lanes[f"r_{n}"] = self.rows[n]
        lanes["pass"] = self.passing
        lanes["rv"] = torch.where(live, self.rv, torch.zeros((), dtype=self.rv.dtype,
                                                             device=self.device))
        lanes["rvv"] = live & self.rv_valid
        return lanes, live

    def state_digest(self) -> int:
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore ----------------------------------------------
    def checkpoint_table_ids(self):
        return [f"{self.table_id}.rows", f"{self.table_id}.rv"]

    def checkpoint_delta(self):
        """The row store's changed rows (``KeyTableGrowth``, kernel R),
        and the right value as a one-row table when it moved."""
        out = KeyTableGrowth.checkpoint_delta(self)
        if self._rv_dirty:
            raw = torch.cat([self.rv.reshape(1).view(torch.uint8),
                             self.rv_valid.reshape(1).view(torch.uint8)]).cpu().numpy()
            rv = raw[:-1].view(_numpy_dtype(self.rv.dtype))
            out.append(StateDelta(
                f"{self.table_id}.rv", {"k0": np.zeros(1, np.int64)},
                {"rv": rv, "rv_valid": raw[-1:].astype(bool)}, np.zeros(1, bool), ("k0",),
            ))
            self._rv_dirty = False
        return out

    def restore_state(self, table_id, key_cols, value_cols):
        """The right value, or the row store at ``grow_pow2`` capacity
        (``KeyTableGrowth.restore_state``: kernel A inserts the keys,
        kernel R lands live, stored, the rows and the pass flags)."""
        if table_id.endswith(".rv"):
            if key_cols:
                self.rv = torch.tensor(np.asarray(value_cols["rv"])[0], dtype=self.rv.dtype,
                                       device=self.device)
                self.rv_valid = torch.tensor(bool(value_cols["rv_valid"][0]), device=self.device)
            return
        KeyTableGrowth.restore_state(self, table_id, key_cols, value_cols)
        self._dropped = torch.zeros((), dtype=torch.bool, device=self.device)
        self._staged_rv = None
