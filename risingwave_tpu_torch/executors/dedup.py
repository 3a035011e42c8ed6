"""Append-only dedup executor — streaming DISTINCT on a key.

Port of ``risingwave_tpu/executors/dedup.py`` (``dedup_step_fn`` :47,
``_rebuild`` :71, ``AppendOnlyDedupExecutor`` :82, its ``on_watermark``
:284). Reference:
src/stream/src/executor/dedup/append_only_dedup.rs — emits each key's
FIRST row and drops later duplicates; the state is the set of seen keys.

The seen-set is a ``HashTable``: per chunk, kernel A finds or inserts
the keys, then kernel J (``csrc/dedup_emit.cu``) marks the new slots
live and sdirty and keeps the first row per new slot. Append-only by
contract: a DELETE latches ``saw_delete`` and raises at the barrier.
State is updated in place. A watermark on ``window_key`` expires the
closed keys of the seen-set (kernel O, ``ops.hash_table.expire_table``).
``KeyTableGrowth`` holds the growth and barrier bookkeeping that the
dynamic max filter shares, and the checkpoint and restore of a key
table with slot lanes (``dedup.py:305-350``, ``dynamic_filter.py:348-390``)
through kernel R.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.ops.checkpoint import (
    insert_keys,
    mark_checkpointed,
    scatter_rows,
    stage_select,
)
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    _first_occurrence_torch,
    expire_table,
    first_scratch,
    lookup_or_insert,
    move_slots,
    read_scalars,
    set_live,
    stage_scalars,
)
from risingwave_tpu_torch.runtime.bucketing import BucketAllocator, BucketPolicy
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    StateDelta,
    grow_pow2,
    pull_rows,
)

GROW_AT = 0.5
# mid-epoch rebuild only when the host insert bound nears the table
HARD_GROW_AT = 0.75


def survivors(table: HashTable, sdirty: torch.Tensor) -> torch.Tensor:
    """Slots a rebuild keeps (``live | sdirty``), counted on the device."""
    return (table.live | sdirty).sum()


def dedup_step_fn(
    table: HashTable, sdirty, chunk: StreamChunk, keys: Tuple[str, ...], scratch, latches
):
    """One chunk through the seen-set, in place: returns ``(table,
    sdirty, out)``, ``out`` the chunk with only each new key's first row
    visible. ``latches`` = (saw_delete, dropped), () bool tensors set in
    place. ``scratch`` is the table's ``first_scratch`` lane (the card's
    first-row rule)."""
    key_cols = tuple(chunk.col(k) for k in keys)
    signs = chunk.effective_signs()
    valid = chunk.valid & (signs > 0)
    table, slots, _, inserted = lookup_or_insert(table, key_cols, valid)
    if slots.device.type == "cpu":
        emit = _dedup_emit_torch(table, sdirty, chunk, signs, valid, slots, inserted, latches)
    elif slots.device.type == "cuda":
        emit = _dedup_emit_cuda(table, sdirty, chunk, slots, inserted, scratch, latches)
    else:
        raise ValueError(f"unsupported device {slots.device}")
    return table, sdirty, chunk.mask(emit)


def _dedup_emit_torch(table, sdirty, chunk, signs, valid, slots, inserted, latches):
    saw_delete, dropped = latches
    saw_delete |= (chunk.valid & (signs < 0)).any()
    set_live(table, torch.where(inserted, slots, -1), True)
    sdirty[slots[inserted].long()] = True
    dropped |= (valid & (slots < 0)).any()
    # `inserted` marks a claim's winner AND its same-key twins; keep one
    return inserted & _first_occurrence_torch(slots, inserted)


def _dedup_emit_cuda(table, sdirty, chunk, slots, inserted, scratch, latches):
    n = chunk.capacity
    saw_delete, dropped = latches
    _kernels.check_cuda("dedup_emit", chunk.valid, chunk.ops, slots, inserted, n=n)
    _kernels.check_cuda("dedup_emit", table.live, sdirty, scratch, n=table.capacity)
    _kernels.check_cuda("dedup_emit", chunk.valid, saw_delete, dropped)
    if chunk.ops.dtype != torch.int32 or scratch.dtype != torch.int32:
        raise TypeError("dedup_emit: int32 ops and scratch lanes")
    if saw_delete.dtype != torch.bool or dropped.dtype != torch.bool:
        raise TypeError("dedup_emit: bool latches")
    emit = torch.empty(n, dtype=torch.bool, device=slots.device)
    _kernels.call(
        "dedup_emit", "rw_dedup_emit", n, chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        slots.data_ptr(), inserted.data_ptr(), table.live.data_ptr(), sdirty.data_ptr(),
        scratch.data_ptr(), table.capacity, emit.data_ptr(), saw_delete.data_ptr(),
        dropped.data_ptr(),
    )
    return emit


def _rebuild(table: HashTable, sdirty, stored, new_cap: int):
    """Re-insert the kept keys (``live | sdirty``: sdirty dead keys carry
    pending tombstones) into a fresh table (kernel A) and move the slot
    lanes there (kernel I). Returns ``(table, sdirty, stored)``."""
    keep = table.live | sdirty
    dev = table.device
    new = HashTable.create(new_cap, tuple(k.dtype for k in table.keys), device=dev)
    new, slots, _, _ = lookup_or_insert(new, table.keys, keep)
    new_sdirty = torch.zeros(new_cap, dtype=torch.bool, device=dev)
    new_stored = torch.zeros(new_cap, dtype=torch.bool, device=dev)
    move_slots((table.live, sdirty, stored), (new.live, new_sdirty, new_stored), slots, keep)
    return new, new_sdirty, new_stored


class KeyTableGrowth(Checkpointable):
    """Growth, barrier and checkpoint bookkeeping shared by the executors
    whose state is one key table with slot lanes and a ``(saw_delete,
    dropped)`` latch pair: the append-only dedup and the dynamic max
    filter. The general dynamic filter takes its growth and its row
    store's checkpoint and restore (its first checkpoint table) from
    here, and keeps its own barrier.

    The owner holds ``table``, ``sdirty``, ``stored``, ``_buckets``,
    ``_bound``, ``_occ_note``, ``_grew_midepoch``, ``_saw_delete`` and
    ``_dropped``, implements ``_rebuild_to(new_cap)``, names its two
    barrier errors in ``_DELETE_ERROR`` and ``_DROPPED_ERROR``, its
    checkpointed value lanes in ``_value_lanes()`` (name -> lane), and
    ``_reset_state(cap)``, which gives it fresh slot lanes."""

    _DELETE_ERROR = ""
    _DROPPED_ERROR = ""

    def _value_lanes(self) -> Dict[str, torch.Tensor]:
        return {}

    # -- checkpoint/restore --------------------------------------------------
    def checkpoint_delta(self):
        """The keys (and value lanes) changed since the last checkpoint,
        through kernel R; the marks flip eagerly."""
        sel, tomb, n, n_sdirty = stage_select(self.sdirty, (self.table.live,), self.stored)
        if not n_sdirty:
            return []
        lanes = {f"k{i}": k for i, k in enumerate(self.table.keys)}
        key_names = tuple(lanes)
        lanes.update(self._value_lanes())
        pulled = pull_rows(lanes, sel, {"tombstone": tomb})
        tombstone = pulled.pop("tombstone")
        mark_checkpointed(self.stored, self.sdirty, sel, tomb)
        keys = {k: pulled[k] for k in key_names}
        vals = {k: v for k, v in pulled.items() if k not in key_names}
        table_id = self.checkpoint_table_ids()[0]
        return [StateDelta(table_id, keys, vals, tombstone, key_names)]

    def restore_state(self, table_id, key_cols, value_cols):
        """Fresh lanes of ``grow_pow2`` capacity; kernel A inserts the
        keys, kernel R lands live, stored and the value lanes in one
        launch."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        cap = grow_pow2(n, self.table.capacity, GROW_AT)
        table = HashTable.create(cap, tuple(k.dtype for k in self.table.keys),
                                 device=self.table.device)
        self._reset_state(cap)
        if n:
            table, slots = insert_keys(table, key_cols, n)
            dst = dict(self._value_lanes())
            src = {name: value_cols[name] for name in dst}
            dst["live"], src["live"] = table.live, np.ones(n, np.bool_)
            dst["stored"], src["stored"] = self.stored, np.ones(n, np.bool_)
            scatter_rows(dst, slots, src)
        self.table = table
        self._bound = self._occ_note = int(n)

    def _grow_hint(self, incoming: int) -> None:
        """The fused program's pre-dispatch growth bookkeeping, with no
        device read: at most one one-bucket bump per epoch, as
        headroom against MAX_PROBE; ordinary growth resolves at the
        barrier from the staged occupancy note."""
        cap = self.table.capacity
        self._bound = min(self._bound, cap)
        if self._grew_midepoch or self._bound + incoming <= cap * HARD_GROW_AT:
            return
        new_cap = self._buckets.bump(cap)
        if new_cap is not None:
            self._rebuild_to(new_cap)
            self._bound = min(self._bound, new_cap)
        self._grew_midepoch = True

    def _maybe_grow(self, incoming: int) -> None:
        """Interpreted-path growth: when the trigger trips, one packed
        blocking read of the true occupancy, then the plan."""
        cap = self.table.capacity
        if not self._buckets.should_plan(cap, self._bound, incoming):
            return
        claimed, surv = read_scalars(self.table.occupancy(), survivors(self.table, self.sdirty))
        new_cap = self._buckets.plan(cap, incoming, claimed, surv)
        if new_cap is not None:
            self._rebuild_to(new_cap)
            claimed = int(self.table.occupancy())
        self._bound = claimed

    def on_barrier(self, barrier) -> List[StreamChunk]:
        self._staged_scalars = stage_scalars(
            self._saw_delete, self._dropped, self.table.occupancy(),
            survivors(self.table, self.sdirty),
        )
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return []

    def _on_barrier_scalars(self, vals) -> None:
        saw_delete, dropped, claimed, surv = vals
        self._grew_midepoch = False
        epoch_inc = max(self._bound - self._occ_note, 0)
        self._occ_note = int(claimed)
        self._bound = int(claimed)
        cap = self.table.capacity
        self._buckets.note_barrier(cap, int(claimed))
        new_cap = self._buckets.plan(
            cap, 0, int(claimed), int(surv), margin=max(int(claimed), epoch_inc)
        )
        if new_cap is not None and new_cap != cap:
            self._rebuild_to(new_cap)
        if saw_delete:
            raise RuntimeError(self._DELETE_ERROR)
        if dropped:
            raise RuntimeError(self._DROPPED_ERROR)


class AppendOnlyDedupExecutor(KeyTableGrowth, Executor):
    """DISTINCT ON (keys): the first row per key passes, duplicates drop.

    ``window_key``: (column, retention_ms) as in the reference: a
    watermark on that column expires every key whose column lies below
    ``value - retention_ms``. The seen-set's capacity walks the bucket
    lattice (the reference's unbucketed twin is not ported)."""

    _DELETE_ERROR = "append-only dedup received a DELETE"
    _DROPPED_ERROR = "dedup table overflowed MAX_PROBE; grow capacity"

    def __init__(
        self,
        keys: Sequence[str],
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 16,
        window_key: Optional[Tuple[str, int]] = None,
        table_id: str = "dedup",
        bucket_policy: Optional[BucketPolicy] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.keys = tuple(keys)
        self.table_id = table_id
        self.table = HashTable.create(
            capacity, tuple(schema_dtypes[k] for k in self.keys), device=self.device
        )
        self.sdirty = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self.stored = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self.scratch = first_scratch(capacity, self.device)
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
        for k in self.keys:
            if k in chunk.nulls:
                raise ValueError(f"dedup key {k!r} carries a null lane (unsupported)")
        self._maybe_grow(chunk.capacity)
        self._bound += chunk.capacity
        self.table, self.sdirty, out = dedup_step_fn(
            self.table, self.sdirty, chunk, self.keys, self.scratch,
            (self._saw_delete, self._dropped),
        )
        return [out]

    def _rebuild_to(self, new_cap: int) -> None:
        self.table, self.sdirty, self.stored = _rebuild(
            self.table, self.sdirty, self.stored, new_cap
        )
        self.scratch = first_scratch(new_cap, self.table.device)

    def _reset_state(self, cap: int) -> None:
        dev = self.table.device
        self.sdirty = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.stored = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.scratch = first_scratch(cap, dev)

    def on_watermark(self, watermark: Watermark):
        if self.window_key is None or watermark.column != self.window_key[0]:
            return watermark, []
        col, retention = self.window_key
        expire_table(self.table, self.sdirty, self.keys.index(col), watermark.value - retention)
        return watermark, []

    # -- integrity --------------------------------------------------------
    def digest_lanes(self):
        return integrity.dedup_lanes(self.table)

    def state_digest(self) -> int:
        """Host twin of the fused program's digest lane."""
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))
