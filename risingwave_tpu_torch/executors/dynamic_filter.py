"""Dynamic filter against a per-group running maximum.

Port of the grouped, append-only half of
``risingwave_tpu/executors/dynamic_filter.py`` (``filter_step_fn`` :56,
``_rebuild`` :98, ``DynamicMaxFilterExecutor`` :111). Reference:
src/stream/src/executor/dynamic_filter.rs:40 — filters the left input
against a moving right-side value; this is the specialisation q7's plan
uses: pass a row iff ``value >= max-so-far(group)``. A bid below its
window's running max can never match a later max (an append-only max
only rises), so dropping it early keeps the join's bid side at the
chain of ascending maxima and their ties.

The comparison uses the max BEFORE the current chunk (same-chunk
stragglers pass and the join's probe drops them), then folds the chunk
into the running max. Per chunk: kernel A finds or inserts the group
key, then kernel N (``csrc/dyn_filter.cu``) decides, resets the maxes
of newly claimed slots, folds and latches ``saw_delete`` / ``dropped``.
A watermark on ``window_key`` expires closed groups (kernel O,
``ops.hash_table.expire_table``). State is updated in place.

Checkpoint and restore (``dynamic_filter.py:348-390``) are the key
table's of ``KeyTableGrowth`` with the ``max`` lane (kernel R). Not
ported yet: the general ``DynamicFilterExecutor`` (``_dyn_left_step`` :417, ``_dyn_rv_diff``
:442). The capacity walks the bucket lattice (the reference's
unbucketed twin is not ported).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.executors.dedup import GROW_AT, KeyTableGrowth
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    expire_table,
    lookup_or_insert,
    move_slots,
    set_live,
)
from risingwave_tpu_torch.runtime.bucketing import BucketAllocator, BucketPolicy

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
