"""OverWindow -- window functions over partitions.

Port of ``risingwave_tpu/executors/over_window.py``: ``KINDS`` :50,
``WindowCall`` :64, ``_accum_names`` :97, ``_accum_init`` :116,
``_over_step`` :129, ``_eowc_over_emit`` :403,
``EowcOverWindowExecutor`` :588, ``OverWindowExecutor`` :673,
``_general_over_step`` :927, ``_chunk_dup`` :1311 and
``GeneralOverWindowExecutor`` :1318. Reference:
src/stream/src/executor/over_window/general.rs:49 and eowc.rs:88.

Three executors, four kernels:

- ``OverWindowExecutor`` (append-only, arrival order): per chunk kernel
  A finds or inserts the partition keys, then kernel AD
  (``csrc/over_step.cu``, ``rw_over_step``) orders the rows by slot with
  stable radix passes (ties keep arrival order: the reference's
  ``(slot, pos)`` sort), runs the segmented scans of every call at once,
  reads each partition's stored accumulators, writes the outputs back at
  arrival positions and each segment's end into the accumulators.
- ``EowcOverWindowExecutor`` (emit on window close) buffers rows in
  ``sort.ArenaBufferedExecutor``'s arena (kernel AC's append); at a
  watermark kernel AE (``csrc/window_calls.cu`` over ``csrc/window.cuh``)
  folds the closed slots' key lanes (``rw_window_fold``, one host read of
  the count and the fold), packs (partition keys, order, seq) into one
  key by ``window_pack_plan`` and sorts it with single-sweep radix passes
  (``rw_window_order``, ``csrc/onesweep.cuh``), then lays the sorted rows
  out and computes every call on the complete partitions in sorted order
  (``rw_window_calls``), gathering every lane into the emission.
- ``GeneralOverWindowExecutor`` (retractable): per chunk kernel A finds
  or inserts the pks, kernel AF's ``rw_over_apply``
  (``csrc/over_diff.cu``) lets the last row per pk write every lane,
  marks the touched slots and the ghost entries of same-chunk partition
  moves, kernel AE orders the members (the arena's rows that are present
  or emitted, plus the ghosts) and recomputes every call, writing each
  slot's new outputs (in dirty partitions) and whether its partition is
  dirty, and AF's ``rw_over_diff`` compares them with what was emitted
  and, in one pass over the slots, places the retract and the insert
  rows each into a dense prefix in slot order and updates the emitted
  lanes.

Each kernel has a plain PyTorch version behind the same function, taken
on CPU tensors. A row whose partition (or pk) found no slot latches
``dropped`` and takes no further part here; the reference's wrapped
``.at[-1]`` writes it into slot ``cap - 1`` (ROADMAP Queue 3), and both
raise at the barrier. ``lint_info``, ``state_nbytes`` and ``trace_step``
are not ported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.executors.sort import ArenaBufferedExecutor
from risingwave_tpu_torch.ops.checkpoint import (
    insert_keys,
    mark_checkpointed,
    scatter_rows,
    stage_select,
)
from risingwave_tpu_torch.ops.hash_table import (
    FIRST_SENTINEL,
    HashTable,
    lookup_or_insert,
    move_slots,
    plan_rehash,
    read_scalars,
    stage_scalars,
)
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    StateDelta,
    grow_pow2,
    pull_rows,
)
from risingwave_tpu_torch.types import Op

GROW_AT = 0.5
MAXI = 2**63 - 1
MINI = -(2**63)

KINDS = (
    "row_number",
    "count",
    "sum",
    "min",
    "max",
    "lag",
    "lead",
    "rank",
    "dense_rank",
)

# kind codes shared with csrc/window.cuh and csrc/over_step.cu (WinKind)
KIND_CODES = {k: i for i, k in enumerate(KINDS)}
# calls one launch of AD or AE computes (csrc/window.cuh WIN_MAX_CALLS)
WINDOW_CALLS = 16
# key lanes one rw_window_order call sorts by (csrc/window.cuh WIN_MAX_KEYS)
WINDOW_KEYS = 12
# lanes of rw_over_apply / rw_over_diff's tables (csrc/over_diff.cu OD_MAX_LANES)
DIFF_LANES = 32
# slots per tile of rw_over_diff (csrc/over_diff.cu OD_THREADS)
DIFF_TILE = 256
# a sort key's role in csrc/window.cuh (WinKeyMode)
_KEY_VALUE, _KEY_ABSENT = 0, 1


@dataclass(frozen=True)
class WindowCall:
    """One window function call.

    ``frame``: optional static ROWS frame (lo, hi) offsets relative to the
    current row (e.g. (-2, 0) = 2 PRECEDING..CURRENT ROW) for
    sum/min/max/count in the EOWC and general executors; None =
    UNBOUNDED PRECEDING..CURRENT ROW (running). ``offset``: lead/lag
    distance."""

    kind: str
    input: Optional[str]  # None for row_number / count(*)
    output: str
    frame: Optional[Tuple[int, int]] = None
    offset: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unsupported window kind {self.kind!r}")
        if (self.input is None) != (self.kind in ("row_number", "count")):
            raise ValueError(f"{self.kind} input mismatch")
        if self.frame is not None:
            lo, hi = self.frame
            if lo > hi:
                raise ValueError(f"frame {self.frame}: lo > hi")
            if hi - lo + 1 > 64:
                raise ValueError(
                    "ROWS frames wider than 64 are not supported (the "
                    "fused kernel combines one shift per frame row)"
                )
            if self.kind not in ("sum", "min", "max", "count"):
                raise ValueError(f"{self.kind} does not take a frame")
        if self.offset < 1:
            raise ValueError("lead/lag offset must be >= 1")


def _accum_names(call: WindowCall):
    """Accumulator lanes per call (lag keeps last-value + flags; min/max
    keep a presence flag so sentinel-valued inputs are not misread as
    NULL; rank/dense_rank keep (last rank, row count, dense count, last
    order value, presence))."""
    if call.kind == "lag":
        return (call.output, call.output + "#has", call.output + "#null")
    if call.kind in ("min", "max"):
        return (call.output, call.output + "#has")
    if call.kind in ("rank", "dense_rank"):
        return (
            call.output,
            call.output + "#cnt",
            call.output + "#dense",
            call.output + "#last",
            call.output + "#has",
        )
    return (call.output,)


def _accum_init(call: WindowCall) -> int:
    if call.kind == "min":
        return MAXI
    if call.kind == "max":
        return MINI
    return 0


# -- segmented helpers of the plain versions -------------------------------------
def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=dev)


def _seg_start(boundary: torch.Tensor) -> torch.Tensor:
    """Each position's segment start (``boundary[0]`` must be set)."""
    idx = _arange(boundary.shape[0], boundary.device)
    return torch.cummax(torch.where(boundary, idx, 0), 0).values


def _seg_ext(v: torch.Tensor, gid: torch.Tensor, kind: str) -> torch.Tensor:
    """Inclusive segmented prefix min or max of int64 ``v`` (segments are
    runs of the non-decreasing ``gid``): by each value's rank among the
    distinct values, offset per segment so one cummax never crosses a
    segment start."""
    if v.numel() == 0:
        return v.clone()
    uniq, rank = torch.unique(v, sorted=True, return_inverse=True)
    m = uniq.numel()
    if kind == "min":
        rank = m - 1 - rank
    off = gid.to(torch.int64) * m
    best = torch.cummax(off + rank, 0).values - off
    if kind == "min":
        best = m - 1 - best
    return uniq[best]


def _seg_sum(v: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented prefix sum (int64, wrapping as the reference's)."""
    csum = torch.cumsum(v, 0)
    return csum - (csum - v)[seg_start]


def _lexsort(keys) -> torch.Tensor:
    """Positions in the stable lexicographic order of ``keys`` (most
    significant first), ties by position."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        if key.dtype == torch.bool:
            key = key.to(torch.int32)
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _i64(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int64 else t.to(torch.int64)


def _call_rows(calls, lanes, nulls, outs, out_nulls):
    """Descriptor rows of every call for AD and AE: kind, whether it has a
    frame, frame lo and hi, offset, input value lane and its dtype code,
    its null lane, output lane and its null lane (0 where absent)."""
    rows = []
    for c in calls:
        lo, hi = c.frame if c.frame is not None else (0, 0)
        v = lanes.get(c.input) if c.input is not None else None
        nl = nulls.get(c.input) if c.input is not None else None
        on = out_nulls.get(c.output)
        rows.append((KIND_CODES[c.kind], 1 if c.frame is not None else 0, lo, hi, c.offset,
                     0 if v is None else v.data_ptr(), 0 if v is None else _kernels.dtype_code(v),
                     0 if nl is None else nl.data_ptr(), outs[c.output].data_ptr(),
                     0 if on is None else on.data_ptr()))
    return rows


# ---------------------------------------------------------------------------
# Append-only over-window: kernel AD
# ---------------------------------------------------------------------------
def over_step(table: HashTable, accums, sdirty, chunk: StreamChunk, calls, part_keys, latches,
              scratch=None) -> StreamChunk:
    """``_over_step`` in place on ``table``, ``accums`` and ``sdirty``:
    kernel A finds or inserts the partition keys of the chunk's inserts,
    then kernel AD (plain PyTorch on the CPU). ``latches`` are the ()
    bool lanes ``(saw_delete, dropped, ooo)``. Returns the chunk with
    every call's output lane (and the min/max and lag null lanes)."""
    signs = chunk.effective_signs()
    active = chunk.valid & (signs > 0)
    keys = tuple(chunk.col(k) for k in part_keys)
    table, slots, _, _ = lookup_or_insert(table, keys, active)
    dev = active.device
    if dev.type == "cpu":
        cols, nulls = _over_step_torch(table, accums, sdirty, chunk, slots, active, calls,
                                       latches)
    elif dev.type == "cuda":
        cols, nulls = _over_step_cuda(table, accums, sdirty, chunk, slots, calls, latches,
                                      scratch)
    else:
        raise ValueError(f"unsupported device {dev}")
    out_cols = dict(chunk.columns)
    out_cols.update(cols)
    out_nulls = dict(chunk.nulls)
    out_nulls.update(nulls)
    return StreamChunk(columns=out_cols, valid=chunk.valid & active, nulls=out_nulls,
                       ops=chunk.ops)


def _over_step_torch(table, accums, sdirty, chunk, slots, active, calls, latches):
    saw_delete, dropped, ooo = latches
    n, cap = chunk.capacity, table.capacity
    dev = active.device
    saw_delete |= (chunk.valid & (chunk.signs() < 0)).any()
    dropped |= (active & (slots < 0)).any()
    ok = active & (slots >= 0)
    hit = slots[ok].long()
    table.live[hit] = True
    sdirty[hit] = True

    skey = torch.where(ok, slots.to(torch.int64), torch.full_like(slots, cap, dtype=torch.int64))
    s_pos = torch.sort(skey, stable=True).indices  # (slot, arrival) order
    s_slot = skey[s_pos]
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = s_slot[1:] != s_slot[:-1]
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    ar = _arange(n, dev)
    seg_start = _seg_start(boundary)
    rank = ar - seg_start  # 0-based within (partition, chunk)
    s_active = s_slot < cap
    gslot = torch.where(s_active, s_slot, 0)
    is_last = torch.ones(n, dtype=torch.bool, device=dev)
    is_last[:-1] = boundary[1:]
    upd_m = s_active & is_last
    upd = gslot[upd_m]
    seg_len = torch.zeros(n, dtype=torch.int64, device=dev)
    seg_len.index_add_(0, gid, torch.ones(n, dtype=torch.int64, device=dev))
    totals = seg_len[gid]  # rows of the segment (all active or none)

    def sv(name):
        return _i64(chunk.col(name))[s_pos]

    def sn(name):
        lane = chunk.nulls.get(name)
        return lane[s_pos] if lane is not None else torch.zeros(n, dtype=torch.bool, device=dev)

    outs, out_nulls = {}, {}
    for c in calls:
        acc = accums[c.output]
        base = acc[gslot]
        if c.kind in ("row_number", "count"):
            o = base + rank + 1
            acc[upd] += totals[upd_m]
        elif c.kind == "sum":
            v = torch.where(s_active & ~sn(c.input), sv(c.input), 0)
            pre = _seg_sum(v, seg_start)
            o = base + pre
            acc[upd] += pre[upd_m]
        elif c.kind in ("min", "max"):
            sent = MAXI if c.kind == "min" else MINI
            comb = torch.minimum if c.kind == "min" else torch.maximum
            real = s_active & ~sn(c.input)
            v = torch.where(real, sv(c.input), sent)
            pref = _seg_ext(v, gid, c.kind)
            o = comb(base, pref)
            has = accums[c.output + "#has"]
            pref_has = _seg_sum(real.to(torch.int64), seg_start) > 0
            out_nulls[c.output] = ~((has[gslot] != 0) | pref_has)
            acc[upd] = comb(acc[upd], pref[upd_m])
            has[upd] = torch.maximum(has[upd], pref_has[upd_m].to(torch.int64))
        elif c.kind in ("rank", "dense_rank"):
            v = sv(c.input)
            prev_v = torch.zeros_like(v)
            prev_v[1:] = v[:-1]
            vb = boundary | (v != prev_v)  # value-group starts
            cum_vb = _seg_sum(vb.to(torch.int64), seg_start)
            grp_start = torch.cummax(torch.where(vb, ar, 0), 0).values - seg_start
            has = accums[c.output + "#has"][gslot] != 0
            lastv = accums[c.output + "#last"][gslot]
            cnt0 = accums[c.output + "#cnt"][gslot]
            dense0 = accums[c.output + "#dense"][gslot]
            rank0 = acc[gslot]
            eq_carry = has & (v == lastv) & (cum_vb == 1)
            ooo |= ((s_active & ~boundary & (v < prev_v))
                    | (s_active & boundary & has & (v < lastv))).any()
            ranked = torch.where(eq_carry, rank0, cnt0 + grp_start + 1)
            first_eq = eq_carry[seg_start]
            dense_row = dense0 + cum_vb - first_eq.to(torch.int64)
            o = ranked if c.kind == "rank" else dense_row
            acc[upd] = ranked[upd_m]
            accums[c.output + "#cnt"][upd] += totals[upd_m]
            accums[c.output + "#dense"][upd] = dense_row[upd_m]
            accums[c.output + "#last"][upd] = v[upd_m]
            accums[c.output + "#has"][upd] = 1
        else:  # lag(1): the previous row's value within the partition
            v, vnull = sv(c.input), sn(c.input)
            prev_v = torch.zeros_like(v)
            prev_v[1:] = v[:-1]
            prev_null = torch.zeros_like(vnull)
            prev_null[1:] = vnull[:-1]
            first = rank == 0
            prev_has = accums[c.output + "#has"][gslot] != 0
            prev_stored_null = accums[c.output + "#null"][gslot] != 0
            o = torch.where(first, base, prev_v)
            out_nulls[c.output] = torch.where(first, ~prev_has | prev_stored_null, prev_null)
            acc[upd] = v[upd_m]
            accums[c.output + "#null"][upd] = vnull[upd_m].to(torch.int64)
            accums[c.output + "#has"][upd] = 1
        outs[c.output] = o

    cols, nulls = {}, {}
    for name, o in outs.items():
        lane = torch.zeros(n, dtype=torch.int64, device=dev)
        lane[s_pos] = o
        cols[name] = lane
    for name, o in out_nulls.items():
        lane = torch.zeros(n, dtype=torch.bool, device=dev)
        lane[s_pos] = o
        nulls[name] = lane
    return cols, nulls


def over_step_scratch(n: int, n_lanes: int, n_acc: int, device) -> Dict[str, torch.Tensor]:
    """Kernel AD's scratch for ``n``-row chunks: the radix sort's two
    (key, row) buffers and counts, the segmented scan's ``n_lanes`` output
    lanes and tile carries, and the staged accumulator values of
    ``n_acc`` lanes."""
    tiles = max(1, -(-n // _kernels.RBK_TILE))
    stiles = max(1, -(-n // _kernels.SEG_SCAN_TILE))
    return {
        "keys": torch.empty(2 * n, dtype=torch.int64, device=device),
        "idx": torch.empty(2 * n, dtype=torch.int32, device=device),
        "hist": torch.empty(256 * tiles + 256, dtype=torch.int32, device=device),
        "scan": torch.empty(max(1, n_lanes) * n, dtype=torch.int64, device=device),
        "carry": torch.empty((2 * max(1, n_lanes) + 1) * stiles, dtype=torch.int64,
                             device=device),
        "stage": torch.empty(max(1, n_acc) * n, dtype=torch.int64, device=device),
    }


def _over_scan_lanes(calls) -> int:
    """Segmented-scan lanes AD runs for ``calls`` (csrc/over_step.cu
    os_plan): the in-chunk rank, then per call none (row_number, count,
    lag), one (sum) or two (min, max, rank, dense_rank)."""
    return 1 + sum({"sum": 1, "min": 2, "max": 2, "rank": 2, "dense_rank": 2}.get(c.kind, 0)
                   for c in calls)


def _over_step_cuda(table, accums, sdirty, chunk, slots, calls, latches, scratch):
    saw_delete, dropped, ooo = latches
    n, cap = chunk.capacity, table.capacity
    dev = slots.device
    if len(calls) > WINDOW_CALLS:
        raise ValueError(f"{len(calls)} calls exceed the kernel's {WINDOW_CALLS}")
    _kernels.check_cuda("over_step", slots, chunk.valid, chunk.ops, n=n)
    _kernels.check_cuda("over_step", table.live, sdirty, n=cap)
    _kernels.check_cuda("over_step", slots, saw_delete, dropped, ooo)
    keep = []
    lanes, lnulls = {}, {}
    for c in calls:
        if c.input is None or c.input in lanes:
            continue
        v = _i64(chunk.col(c.input))
        keep.append(v)
        _kernels.check_cuda("over_step", v, n=n)
        lanes[c.input] = v
        if c.input in chunk.nulls:
            lnulls[c.input] = chunk.nulls[c.input]
    outs = {c.output: torch.empty(n, dtype=torch.int64, device=dev) for c in calls}
    out_nulls = {c.output: torch.empty(n, dtype=torch.bool, device=dev)
                 for c in calls if c.kind in ("min", "max", "lag")}
    rows = _call_rows(calls, lanes, lnulls, outs, out_nulls)
    acc_rows = []
    for c in calls:
        names = _accum_names(c)
        for name in names:
            _kernels.check_cuda("over_step", accums[name], n=cap)
        acc_rows.append(tuple(accums[nm].data_ptr() for nm in names) + (0,) * (5 - len(names)))
    if scratch is None:
        scratch = over_step_scratch(n, _over_scan_lanes(calls),
                                    sum(len(_accum_names(c)) for c in calls), dev)
    _kernels.call(
        "over_step", "rw_over_step", _kernels.int64_rows(rows, WINDOW_CALLS),
        _kernels.int64_rows(acc_rows, WINDOW_CALLS), len(calls), n, cap, slots.data_ptr(),
        chunk.valid.data_ptr(), chunk.ops.data_ptr(), table.live.data_ptr(), sdirty.data_ptr(),
        saw_delete.data_ptr(), dropped.data_ptr(), ooo.data_ptr(), scratch["keys"].data_ptr(),
        scratch["idx"].data_ptr(), scratch["hist"].data_ptr(), scratch["scan"].data_ptr(),
        scratch["carry"].data_ptr(), scratch["stage"].data_ptr(),
    )
    return outs, out_nulls


class OverWindowExecutor(Executor, Checkpointable):
    """Append-only window functions: ROW_NUMBER / running COUNT / SUM /
    MIN / MAX / LAG / RANK / DENSE_RANK per partition in arrival order
    (rank kinds require arrival order == ORDER BY order; violations latch
    and raise at the barrier). Checkpointable: partition keys + every
    accumulator lane persist as one state table."""

    def __init__(
        self,
        partition_by: Sequence[str],
        calls: Sequence[WindowCall],
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 14,
        table_id: str = "over_window",
        device="cuda",
    ):
        self.part_keys = tuple(partition_by)
        self.calls = tuple(calls)
        for c in self.calls:
            if c.kind == "lead" or c.frame is not None:
                raise ValueError(
                    f"{c.kind}/frames need future rows: use "
                    "EowcOverWindowExecutor (emit on window close)"
                )
            if c.kind == "lag" and c.offset != 1:
                raise ValueError(
                    "streaming lag supports offset=1 only; use "
                    "EowcOverWindowExecutor for lag(k)"
                )
        self.device = resolve_device(device)
        self.table_id = table_id
        self._dtypes = dict(schema_dtypes)
        self._accum_inits = {}
        for c in self.calls:
            for name in _accum_names(c):
                self._accum_inits[name] = _accum_init(c) if name == c.output else 0
        self._alloc(capacity)
        self._bound = 0
        z = lambda: torch.zeros((), dtype=torch.bool, device=self.device)
        self._saw_delete, self._dropped, self._ooo = z(), z(), z()
        self._scratch = None

    def _alloc(self, cap: int) -> None:
        dev = self.device
        self.table = HashTable.create(cap, tuple(self._dtypes[k] for k in self.part_keys),
                                      device=dev)
        self.accums = {name: torch.full((cap,), init, dtype=torch.int64, device=dev)
                       for name, init in self._accum_inits.items()}
        self.sdirty = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.stored = torch.zeros(cap, dtype=torch.bool, device=dev)

    def trace_contract(self):
        """A passthrough emission (one output chunk per input chunk of its
        capacity): a device MV behind it is not fused (reference :750)."""
        return {"kind": "device", "state": (self.table, self.accums), "donate": True,
                "emission": "passthrough"}

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        for c in self.calls:
            if c.kind in ("rank", "dense_rank") and c.input in chunk.nulls:
                raise ValueError(f"rank order column {c.input!r} carries a null lane (NULL "
                                 "ordering unsupported)")
        self._maybe_grow(chunk.capacity)
        self._bound += chunk.capacity
        if self.device.type == "cuda" and (self._scratch is None
                                           or self._scratch["keys"].numel() != 2 * chunk.capacity):
            self._scratch = over_step_scratch(
                chunk.capacity, _over_scan_lanes(self.calls),
                sum(len(_accum_names(c)) for c in self.calls), self.device)
        out = over_step(self.table, self.accums, self.sdirty, chunk, self.calls,
                        self.part_keys, (self._saw_delete, self._dropped, self._ooo),
                        self._scratch)
        return [out]

    def _maybe_grow(self, incoming: int) -> None:
        cap = self.table.capacity
        if self._bound + incoming <= cap * GROW_AT:
            return
        (claimed,) = read_scalars(self.table.occupancy())
        new_cap = plan_rehash(cap, incoming, claimed, claimed, GROW_AT)
        if new_cap is not None:
            dev = self.device
            keep = self.table.fp1 != 0
            new = HashTable.create(new_cap, tuple(k.dtype for k in self.table.keys), device=dev)
            new, slots, _, _ = lookup_or_insert(new, self.table.keys, keep)
            # unclaimed slots keep each lane's INIT value (reference :798)
            accums = {name: torch.full((new_cap,), self._accum_inits[name], dtype=torch.int64,
                                       device=dev) for name in self.accums}
            sdirty = torch.zeros(new_cap, dtype=torch.bool, device=dev)
            stored = torch.zeros(new_cap, dtype=torch.bool, device=dev)
            names = tuple(self.accums)
            move_slots((self.table.live, self.sdirty, self.stored)
                       + tuple(self.accums[nm] for nm in names),
                       (new.live, sdirty, stored) + tuple(accums[nm] for nm in names),
                       slots, keep)
            self.table, self.accums, self.sdirty, self.stored = new, accums, sdirty, stored
            (claimed,) = read_scalars(self.table.occupancy())
        self._bound = int(claimed)

    def on_barrier(self, barrier) -> List[StreamChunk]:
        self._staged_scalars = stage_scalars(self._saw_delete, self._dropped, self._ooo)
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return []

    def _on_barrier_scalars(self, vals) -> None:
        sd, dr, ooo = vals
        if sd:
            raise RuntimeError("append-only OverWindow received a DELETE (the general "
                               "retractable executor is GeneralOverWindowExecutor)")
        if dr:
            raise RuntimeError("OverWindow partition table overflowed")
        if ooo:
            raise RuntimeError(
                "rank/dense_rank saw out-of-order arrivals: the append-only OverWindow "
                "requires arrival order to match ORDER BY (sort upstream, e.g. with the EOWC "
                "sort)")

    # -- integrity ----------------------------------------------------------
    def digest_lanes(self):
        lanes = {f"k{i}": k for i, k in enumerate(self.table.keys)}
        for name, a in self.accums.items():
            lanes[f"acc_{name}"] = a
        return lanes, self.table.fp1 != 0

    def state_digest(self) -> int:
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore -------------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        """The dirty partitions through kernel R (partitions never die
        here: alive = every claimed slot, so no tombstones)."""
        alive = self.table.fp1 != 0
        sel, tomb, _, n_dirty = stage_select(self.sdirty, (alive,), self.stored)
        if not n_dirty:
            return []
        lanes = {f"k{i}": k for i, k in enumerate(self.table.keys)}
        key_names = tuple(lanes)
        for name, a in self.accums.items():
            lanes[f"acc_{name}"] = a
        pulled = pull_rows(lanes, sel, {"tombstone": tomb})
        tombstone = pulled.pop("tombstone")
        mark_checkpointed(self.stored, self.sdirty, sel, tomb)
        keys = {k: pulled[k] for k in key_names}
        vals = {k: v for k, v in pulled.items() if k not in key_names}
        return [StateDelta(self.table_id, keys, vals, tombstone, key_names)]

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        self._alloc(grow_pow2(n, self.table.capacity, GROW_AT))
        if n:
            self.table, slots = insert_keys(self.table, key_cols, n)
            dst = {f"acc_{nm}": a for nm, a in self.accums.items()}
            src = {name: value_cols[name] for name in dst}
            dst["live"], src["live"] = self.table.live, np.ones(n, np.bool_)
            dst["stored"], src["stored"] = self.stored, np.ones(n, np.bool_)
            scatter_rows(dst, slots, src)
        self._bound = int(n)
        self._saw_delete.zero_()
        self._dropped.zero_()
        self._ooo.zero_()


# ---------------------------------------------------------------------------
# Kernel AE: the sorted-segment window body (EOWC emit and general recompute)
# ---------------------------------------------------------------------------
def _window_body_torch(total: int, part_s, v_order, live, calls, vals, vnulls, dev):
    """Every call over a sorted domain (the reference's
    ``_eowc_over_emit`` :437-572 and ``_general_over_step`` :1061-1202):
    ``part_s`` the sorted partition planes (plus any extra boundary
    lanes), ``v_order`` the sorted order values, ``live`` the rows that
    take part, ``vals``/``vnulls`` the sorted call inputs. Returns
    ``(gid, outs, out_nulls)``."""
    idx = _arange(total, dev)
    boundary = torch.zeros(total, dtype=torch.bool, device=dev)
    for lane in part_s:
        boundary[1:] |= lane[1:] != lane[:-1]
    if total:
        boundary[0] = True
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    seg_start = _seg_start(boundary) if total else idx
    in_seg = idx - seg_start
    zero_nulls = torch.zeros(total, dtype=torch.bool, device=dev)

    def shifted(v, nullm, d):
        j = idx + d
        jc = j.clamp(0, max(total - 1, 0))
        ok = (j >= 0) & (j < total) & (gid[jc] == gid) & live[jc] & live
        return torch.where(ok, v[jc], 0), torch.where(ok, nullm[jc], True)

    outs, out_nulls = {}, {}
    for c in calls:
        if c.input is not None:
            v, vnull = vals[c.input], vnulls[c.input]
        if c.kind == "row_number":
            o, onull = in_seg + 1, zero_nulls
        elif c.kind in ("rank", "dense_rank"):
            pv = torch.zeros_like(v_order)
            pv[1:] = v_order[:-1]
            vb = boundary | (v_order != pv)
            if c.kind == "dense_rank":
                o = _seg_sum(vb.to(torch.int64), seg_start)
            else:
                o = torch.cummax(torch.where(vb, idx, 0), 0).values - seg_start + 1
            onull = zero_nulls
        elif c.kind in ("lead", "lag"):
            d = c.offset if c.kind == "lead" else -c.offset
            o, onull = shifted(v, vnull, d)
        elif c.frame is not None:
            lo, hi = c.frame
            if c.kind == "count":
                v, vnull = torch.ones(total, dtype=torch.int64, device=dev), zero_nulls
            ident = MAXI if c.kind == "min" else MINI if c.kind == "max" else 0
            comb = (torch.minimum if c.kind == "min" else
                    torch.maximum if c.kind == "max" else torch.add)
            acc = torch.full((total,), ident, dtype=torch.int64, device=dev)
            any_real = zero_nulls.clone()
            for d in range(lo, hi + 1):
                s_v, s_n = shifted(v, vnull, d)
                real = ~s_n
                acc = comb(acc, torch.where(real, s_v, ident))
                any_real |= real
            o, onull = acc, (zero_nulls if c.kind == "count" else ~any_real)
        else:  # running UNBOUNDED PRECEDING .. CURRENT ROW
            if c.kind == "count":
                real, vv = live, torch.ones(total, dtype=torch.int64, device=dev)
            else:
                real, vv = live & ~vnull, v
            if c.kind in ("sum", "count"):
                o, onull = _seg_sum(torch.where(real, vv, 0), seg_start), zero_nulls
            else:
                sent = MAXI if c.kind == "min" else MINI
                o = _seg_ext(torch.where(real, vv, sent), gid, c.kind)
                onull = ~(_seg_sum(real.to(torch.int64), seg_start) > 0)
        outs[c.output] = o
        out_nulls[c.output] = onull
    return gid, outs, out_nulls


def _key_rows(keys):
    """Descriptor rows of sort keys, most significant first: ``(lane,
    dtype code, fallback int64 lane or 0, mode)``."""
    if len(keys) > WINDOW_KEYS:
        raise ValueError(f"{len(keys)} sort keys exceed the kernel's {WINDOW_KEYS}")
    rows = []
    for lane, fallback, mode in keys:
        rows.append((0 if lane is None else lane.data_ptr(),
                     0 if lane is None else _kernels.dtype_code(lane),
                     0 if fallback is None else fallback.data_ptr(), mode))
    return rows


_MASK64 = (1 << 64) - 1
_SIGN = 1 << 63


def _s64(v: int) -> int:
    """An unsigned 64-bit word as the int64 a descriptor row carries."""
    return v - (1 << 64) if v & _SIGN else v


class WindowPlan(NamedTuple):
    """Kernel AE's packed sort key, from the fold of its key lanes over
    the members (``window_pack_plan``). ``fields``: per varying lane
    ``(lane, lo, width, g0, lo_key)``, the bits of ``(encoded key -
    lo_key) >> lo``, ``width`` wide, with their lowest at bit ``g0`` of
    the whole key (``64 * words`` bits, word 0 its most significant).
    Per word: ``pass_masks`` bit b where byte b may vary (one radix pass
    each), ``part_masks`` and ``order_masks`` the bits of the partition
    fields and of the order field."""

    fields: Tuple[Tuple[int, int, int, int, int], ...]
    words: int
    bits: int
    pass_masks: Tuple[int, ...]
    part_masks: Tuple[int, ...]
    order_masks: Tuple[int, ...]

    def pack(self, enc: Sequence[int]) -> int:
        """The whole packed key of one member, ``enc`` its lanes' encoded
        keys (signed values with bit 63 flipped, as unsigned words)."""
        key = 0
        for lane, lo, _, g0, lo_key in self.fields:
            key |= ((enc[lane] - lo_key) >> lo) << g0
        return key

    def split(self, key: int) -> Tuple[int, ...]:
        """A whole key's 64-bit words, most significant first."""
        return tuple((key >> (64 * (self.words - 1 - w))) & _MASK64 for w in range(self.words))

    def rows(self) -> List[int]:
        """The plan as ``rw_window_order`` reads it."""
        flat = [v for lane, lo, width, g0, lo_key in self.fields
                for v in (lane, lo, width, g0, _s64(lo_key))]
        return [len(self.fields), self.words, *self.pass_masks, *flat]


def window_pack_plan(fold: Sequence[Tuple[int, int, int, int]], n_part: int,
                     order_lane: int) -> WindowPlan:
    """Kernel AE's packing plan from the fold of each key lane's encoded
    keys over the members (``fold[l]``: their OR, AND, MIN and MAX as
    unsigned words), most significant lane first; lanes ``< n_part`` are
    the partition keys, ``order_lane`` the order key. A lane that varies
    gets the field ``(key - MIN) >> lo``, ``lo`` its lowest varying bit
    (every member has the same bits below it), as wide as ``(MAX - MIN)
    >> lo`` needs: never wider than the span of its varying bits, and
    exact, since the shift drops only bits that are equal in every
    member. The fields fill the key from its top, most significant lane
    first, so the packed key orders and ties the members as their lanes
    do; past 64 bits the key takes more words."""
    widths = []
    for lane, (o, a, lo_key, hi_key) in enumerate(fold):
        v = (o ^ a) & _MASK64
        if v:
            lo = (v & -v).bit_length() - 1
            widths.append((lane, lo, ((hi_key - lo_key) >> lo).bit_length(), lo_key))
    bits = sum(w for _, _, w, _ in widths)
    words = -(-bits // 64)
    fields, end = [], 64 * words
    for lane, lo, width, lo_key in widths:
        end -= width
        fields.append((lane, lo, width, end, lo_key))

    def per_word(pick):
        whole = sum(((1 << w) - 1) << g0 for lane, _, w, g0, _ in fields if pick(lane))
        return tuple((whole >> (64 * (words - 1 - i))) & _MASK64 for i in range(words))

    varying = per_word(lambda lane: True)
    passes = tuple(sum(1 << b for b in range(8) if (w >> (8 * b)) & 0xFF) for w in varying)
    return WindowPlan(tuple(fields), words, bits, passes,
                      per_word(lambda lane: lane < n_part),
                      per_word(lambda lane: lane == order_lane))


def _window_inputs(calls) -> int:
    """Distinct call inputs AE lays out in sorted order (csrc/window_calls.cu
    win_calls): those of lag, lead, sum, min and max."""
    return len({c.input for c in calls if c.kind in ("lag", "lead", "sum", "min", "max")})


def window_scratch(dom: int, n_lanes: int, device) -> Dict[str, torch.Tensor]:
    """Kernel AE's scratch over a domain of ``dom`` entries, made once per
    domain size: the fold's tile counts and words, each member's packed
    key (one word; a key past 64 bits grows it) and entry, the sort's two
    (key, payload) buffers, digit counts and look-back words, the sorted
    layout (entry, flag byte; the call inputs' value and null lanes are
    made at the first call), the segmented scan's ``n_lanes`` lanes, tile
    carries and per-segment dirty marks, and the general step's sorted
    place of each slot and records of the outputs (made at its first
    call)."""
    d = max(dom, 1)
    stiles = max(1, -(-dom // _kernels.SEG_SCAN_TILE))
    e = lambda n, dt: torch.empty(n, dtype=dt, device=device)
    return {
        "part": _kernels.compact_scratch(d, device), "fold": e(4 * WINDOW_KEYS, torch.int64),
        "words": e(d, torch.int64), "ent": e(d, torch.int32),
        "ka": e(d, torch.int64), "kb": e(d, torch.int64),
        "pa": e(d, torch.int32), "pb": e(d, torch.int32),
        "hist": e(8 * 256, torch.int32),
        "status": e(-(-d // _kernels.OS_TILE) * 256 + 1, torch.int32),
        "idx": e(d, torch.int32), "hf": e(d, torch.uint8),
        "sv": e(0, torch.int64), "sn": e(0, torch.uint8),
        "scan": e(max(1, n_lanes) * d, torch.int64),
        "carry": e((2 * max(1, n_lanes) + 1) * stiles, torch.int64),
        "segmark": e(d, torch.uint8), "pos": e(d, torch.int32), "rec": e(0, torch.int64),
    }


def _record_words(calls) -> int:
    """Words of one member's record of outputs in the general step (its
    flags, then one output a call), rounded up to a power of two so a
    record covers whole 32-byte sectors."""
    return 1 << (len(calls)).bit_length()


def _scratch_lane(scratch, name: str, numel: int) -> torch.Tensor:
    """``scratch[name]`` with at least ``numel`` elements, regrown once if
    a call needs more (a key past 64 bits, more call inputs)."""
    t = scratch[name]
    if t.numel() < numel:
        t = scratch[name] = torch.empty(numel, dtype=t.dtype, device=t.device)
    return t


def _window_scan_lanes(calls) -> int:
    """Segmented-scan lanes AE runs for ``calls`` (csrc/window.cuh
    win_plan): in_seg and gid, then one for each of rank, dense_rank,
    running sum and count, two for running min and max."""
    n = 2
    for c in calls:
        if c.kind in ("rank", "dense_rank"):
            n += 1
        elif c.frame is None and c.kind in ("sum", "count"):
            n += 1
        elif c.frame is None and c.kind in ("min", "max"):
            n += 2
    return n


def _domain_args(d: dict):
    ptr = lambda t: 0 if t is None else t.data_ptr()
    return (d["cap"], d["n_ghost"], ptr(d.get("m1")), ptr(d.get("m2")), ptr(d.get("win")),
            int(d.get("cutoff", 0)), ptr(d.get("present")), ptr(d.get("ghost")),
            ptr(d.get("gslot")))


def window_fold(domain: dict, keys, scratch) -> Tuple[int, List[Tuple[int, int, int, int]]]:
    """Kernel AE's ``rw_window_fold``: the member count of ``domain`` and,
    per key lane (``(lane, fallback, mode)``, most significant first), the
    OR, AND, MIN and MAX of its encoded keys over the members (the call's
    one host read). CUDA only: the plain versions are ``_eowc_emit_torch``
    and ``_general_recompute_torch``."""
    host = (ctypes.c_int64 * (1 + 4 * WINDOW_KEYS))()
    _kernels.call("window_calls", "rw_window_fold", *_domain_args(domain),
                  _kernels.int64_rows(_key_rows(keys), WINDOW_KEYS), len(keys),
                  scratch["part"].data_ptr(), scratch["fold"].data_ptr(), host)
    fold = [tuple(host[1 + 4 * lane + j] & _MASK64 for j in range(4)) for lane in range(len(keys))]
    return int(host[0]), fold


def window_order(domain: dict, keys, plan: WindowPlan, m: int, scratch) -> Tuple[int, int]:
    """Kernel AE's ``rw_window_order``: the ``m`` members of ``domain``
    sorted by ``plan``'s packed key (entry order breaks ties: the stable
    lexicographic order of ``keys``); returns the device addresses of the
    sorted first words and of the sorted entries (one word) or
    compaction places (more words), both in ``scratch``."""
    total = domain["cap"] + domain["n_ghost"]
    words = _scratch_lane(scratch, "words", max(1, plan.words) * max(total, 1))
    host = (ctypes.c_int64 * 2)()
    _kernels.call(
        "window_calls", "rw_window_order", *_domain_args(domain),
        _kernels.int64_rows(_key_rows(keys), WINDOW_KEYS), len(keys),
        _kernels.int64_rows([plan.rows()], 1), m, scratch["part"].data_ptr(), words.data_ptr(),
        *(scratch[k].data_ptr() for k in ("ent", "ka", "kb", "pa", "pb", "hist", "status")),
        host,
    )
    return int(host[0]), int(host[1])


def onesweep_sort(keys: torch.Tensor, scratch, mask: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel AE's sort alone (``rw_onesweep_sort``): ``keys`` (int64,
    read as unsigned words) stably sorted by the bytes of ``mask`` (bit b:
    byte b), with their places; views into ``scratch`` (``window_scratch``
    of at least ``keys.numel()`` entries). CUDA only; for timing the sort
    by itself."""
    n = keys.numel()
    _kernels.check_cuda("window_calls", keys, n=n)
    host = (ctypes.c_int64 * 2)()
    _kernels.call("window_calls", "rw_onesweep_sort", keys.data_ptr(), 0, n, mask,
                  *(scratch[k].data_ptr() for k in ("ka", "kb", "pa", "pb", "hist", "status")),
                  host)
    base = {scratch[k].data_ptr(): scratch[k] for k in ("ka", "kb", "pa", "pb")}
    key_t = base.get(int(host[0]), keys)[:n]
    pay_t = base.get(int(host[1]))
    return key_t, (pay_t[:n] if pay_t is not None else torch.arange(n, dtype=torch.int32,
                                                                    device=keys.device))


def _window_calls_cuda(domain, plan, sorted_ptrs, calls, scratch, m, vals, vnulls, outs,
                       out_nulls, unsort, gather_rows, out_valid, clear_valid, dirty_slot,
                       touched):
    """Kernel AE's ``rw_window_calls`` over the ``m`` sorted members."""
    d = domain
    ptr = lambda t: 0 if t is None else t.data_ptr()
    total = d["cap"] + d["n_ghost"]
    rows = _call_rows(calls, vals, vnulls, outs, out_nulls)
    n_in = max(1, _window_inputs(calls))
    sv = _scratch_lane(scratch, "sv", n_in * max(total, 1))
    sn = _scratch_lane(scratch, "sn", n_in * max(total, 1))
    n_words = plan.words if plan is not None else 0
    rs = _record_words(calls)
    rec = _scratch_lane(scratch, "rec", rs * max(total, 1)) if unsort else scratch["rec"]
    sorted_rows = [sorted_ptrs[0], sorted_ptrs[1], scratch["words"].data_ptr(), total,
                   scratch["ent"].data_ptr()]
    if plan is not None:
        sorted_rows += [_s64(w) for w in plan.part_masks + plan.order_masks]
    _kernels.call(
        "window_calls", "rw_window_calls", d["cap"], d["n_ghost"], ptr(d.get("present")),
        ptr(touched), _kernels.int64_rows(rows, WINDOW_CALLS), len(calls), m,
        1 if unsort else 0, _kernels.int64_rows([sorted_rows], 1), n_words,
        scratch["idx"].data_ptr(), scratch["hf"].data_ptr(), sv.data_ptr(), sn.data_ptr(), n_in,
        scratch["scan"].data_ptr(), scratch["carry"].data_ptr(), scratch["segmark"].data_ptr(),
        scratch["pos"].data_ptr(), rec.data_ptr(), rs,
        ptr(dirty_slot), _kernels.int64_rows(gather_rows, _kernels.TILE_LANES),
        len(gather_rows), ptr(out_valid), 0 if out_valid is None else out_valid.shape[0],
        ptr(clear_valid),
    )


# ---------------------------------------------------------------------------
# EOWC over-window: complete-partition compute at window close
# ---------------------------------------------------------------------------
def eowc_over_emit(buf, bnulls, valid, seq, cutoff: int, names, calls, part_keys, order_col,
                   win_col, scratch=None):
    """``_eowc_over_emit``: ``(out_cols, out_nulls, out_valid, n_closed)``
    -- the closed rows (window column < cutoff) sorted by (partition
    keys, order, seq) with every call computed on their complete
    partitions, as a capacity-wide prefix; their slots are freed in
    place. Kernel AE on the card, plain PyTorch on the CPU."""
    if valid.device.type == "cpu":
        return _eowc_emit_torch(buf, bnulls, valid, seq, cutoff, names, calls, part_keys,
                                order_col, win_col)
    if valid.device.type == "cuda":
        return _eowc_emit_cuda(buf, bnulls, valid, seq, cutoff, names, calls, part_keys,
                               order_col, win_col, scratch)
    raise ValueError(f"unsupported device {valid.device}")


def _eowc_emit_torch(buf, bnulls, valid, seq, cutoff, names, calls, part_keys, order_col,
                     win_col):
    cap = valid.shape[0]
    dev = valid.device
    closed = valid & (buf[win_col] < cutoff)
    perm = _lexsort((~closed,) + tuple(buf[k] for k in part_keys) + (buf[order_col], seq))
    closed_s = closed[perm]
    part_s = [buf[k][perm] for k in part_keys] + [closed_s]
    vals, vnulls = {}, {}
    for c in calls:
        if c.input is not None:
            vals[c.input] = _i64(buf[c.input])[perm]
            vnulls[c.input] = (bnulls[c.input][perm] if c.input in bnulls
                               else torch.zeros(cap, dtype=torch.bool, device=dev))
    _, outs, onulls = _window_body_torch(cap, part_s, _i64(buf[order_col])[perm], closed_s,
                                            calls, vals, vnulls, dev)
    out_cols = {n: buf[n][perm] for n in names}
    out_cols.update(outs)
    out_nulls = {n: bnulls[n][perm] for n in bnulls}
    out_nulls.update(onulls)
    valid &= ~closed
    return out_cols, out_nulls, closed_s, int(closed.sum())


def _eowc_keys(buf, part_keys, order_col, seq):
    return ([(buf[k], None, _KEY_VALUE) for k in part_keys]
            + [(buf[order_col], None, _KEY_VALUE), (seq, None, _KEY_VALUE)])


def _eowc_emit_cuda(buf, bnulls, valid, seq, cutoff, names, calls, part_keys, order_col, win_col,
                    scratch):
    cap = valid.shape[0]
    dev = valid.device
    win = buf[win_col]
    if win.dtype != torch.int64:
        raise TypeError("eowc_over_emit: the window column must be int64")
    _kernels.check_cuda("window_calls", valid, seq, win, n=cap)
    keys = _eowc_keys(buf, part_keys, order_col, seq)
    for lane, _, _ in keys:
        _kernels.check_cuda("window_calls", lane, n=cap)
    if scratch is None:
        scratch = window_scratch(cap, _window_scan_lanes(calls), dev)
    domain = {"cap": cap, "n_ghost": 0, "m1": valid, "win": win, "cutoff": cutoff}
    m, fold = window_fold(domain, keys, scratch)
    if m == 0:
        return None, None, None, 0
    plan = window_pack_plan(fold, len(part_keys), len(part_keys))
    srt = window_order(domain, keys, plan, m, scratch)
    vals, vnulls = {}, {}
    for c in calls:
        if c.input is not None and c.input not in vals:
            vals[c.input] = buf[c.input]
            if c.input in bnulls:
                vnulls[c.input] = bnulls[c.input]
    outs = {c.output: torch.empty(cap, dtype=torch.int64, device=dev) for c in calls}
    onulls = {c.output: torch.empty(cap, dtype=torch.bool, device=dev) for c in calls}
    out_cols = {n: torch.empty_like(buf[n]) for n in names}
    out_nulls = {n: torch.empty_like(bnulls[n]) for n in bnulls}
    gather = []
    for n in names:
        if buf[n].element_size() not in (1, 4, 8):
            raise TypeError(f"eowc_over_emit: lane {n!r} of dtype {buf[n].dtype}")
        gather.append((buf[n].data_ptr(), out_cols[n].data_ptr(), buf[n].element_size()))
    for n in bnulls:
        gather.append((bnulls[n].data_ptr(), out_nulls[n].data_ptr(), 1))
    out_valid = torch.empty(cap, dtype=torch.bool, device=dev)
    _window_calls_cuda(domain, plan, srt, calls, scratch, m, vals, vnulls, outs, onulls, False,
                       gather, out_valid, valid, None, None)
    out_cols.update(outs)
    out_nulls.update(onulls)
    return out_cols, out_nulls, out_valid, m


class EowcOverWindowExecutor(ArenaBufferedExecutor):
    """Emit-on-window-close window functions (over_window/eowc.rs:88):
    rows buffer in the arena until the watermark closes their window
    column; complete partitions then compute EVERY call -- lead/lag and
    static ROWS frames included -- in one sorted-segment program. The
    partition key must include the window column (a closed partition
    receives no further rows)."""

    _arena_name = "EOWC over-window arena"

    def __init__(
        self,
        partition_by: Sequence[str],
        order_col: str,
        calls: Sequence[WindowCall],
        schema_dtypes: Dict[str, torch.dtype],
        win_col: Optional[str] = None,
        capacity: int = 1 << 14,
        nullable: Sequence[str] = (),
        table_id: str = "eowc_over",
        device="cuda",
    ):
        self.part_keys = tuple(partition_by)
        self.order_col = order_col
        self.win_col = win_col or self.part_keys[0]
        if self.win_col not in self.part_keys:
            raise ValueError("the window column must be one of the partition keys (a closed "
                             "partition may receive no further rows)")
        self.calls = tuple(calls)
        for c in self.calls:
            if c.kind in ("rank", "dense_rank") and c.input != self.order_col:
                raise ValueError(f"{c.kind} ranks by the executor's order column "
                                 f"{self.order_col!r}; got input {c.input!r}")
        super().__init__(schema_dtypes, capacity, nullable, table_id, device)
        self._wscratch = None

    def trace_contract(self):
        contract = super().trace_contract()
        contract["hot_methods"] = ("on_watermark",)
        return contract

    def on_watermark(self, watermark: Watermark):
        if watermark.column != self.win_col:
            return watermark, []
        if self.device.type == "cuda":
            cap = self.capacity
            if self._wscratch is None or self._wscratch["ent"].numel() < cap:
                self._wscratch = window_scratch(cap, _window_scan_lanes(self.calls), self.device)
        out_cols, out_nulls, out_valid, n_closed = eowc_over_emit(
            self.buf, self.bnulls, self.valid, self.seq, int(watermark.value), self.names,
            self.calls, self.part_keys, self.order_col, self.win_col, self._wscratch)
        if n_closed == 0:
            return watermark, []
        chunk = StreamChunk(
            columns=out_cols, valid=out_valid, nulls=out_nulls,
            ops=torch.zeros(self.capacity, dtype=torch.int32, device=self.device),
        )
        return watermark, [chunk]


# ---------------------------------------------------------------------------
# General (retractable) over-window: kernels AF and AE
# ---------------------------------------------------------------------------
def _chunk_dup(slots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rows whose slot already appeared earlier in the chunk (a delete may
    legitimately target a row inserted earlier in the same chunk, which
    lookup_or_insert reports as freshly inserted). Plain PyTorch."""
    from risingwave_tpu_torch.ops.hash_table import _first_occurrence_torch

    return valid & ~_first_occurrence_torch(slots, valid)


def apply_scratch(cap: int, device) -> Dict[str, torch.Tensor]:
    """Kernel AF's per-slot int32 lanes, kept at their sentinels between
    calls (first occurrence at INT32_MAX, last at -1)."""
    return {
        "first": torch.full((cap,), FIRST_SENTINEL, dtype=torch.int32, device=device),
        "last": torch.full((cap,), -1, dtype=torch.int32, device=device),
    }


def over_apply(table: HashTable, slots, found, st: dict, chunk: StreamChunk, part_keys,
               lane_names, seq_base: int, latches, scratch=None):
    """``_general_over_step`` :962-1011, in place on the arena ``st``
    (``buf``, ``bnulls``, ``present``, ``seq``, ``em``, ``em_valid``,
    ``sdirty``): the last row per pk writes every lane, ``present`` and
    ``seq``, and sets ``live``; ``latches`` = (dropped, bad_delete).
    Returns ``(touched, ghost, gslots)``: the touched slots (cap), the
    ghost entries of same-chunk partition moves and each row's clipped
    slot (n). Kernel AF's ``rw_over_apply`` on the card, plain PyTorch on
    the CPU."""
    if slots.device.type == "cpu":
        return _over_apply_torch(table, slots, found, st, chunk, part_keys, lane_names,
                                 seq_base, latches)
    if slots.device.type == "cuda":
        return _over_apply_cuda(table, slots, found, st, chunk, part_keys, lane_names,
                                seq_base, latches, scratch)
    raise ValueError(f"unsupported device {slots.device}")


def _over_apply_torch(table, slots, found, st, chunk, part_keys, lane_names, seq_base, latches):
    from risingwave_tpu_torch.ops.hash_table import _last_occurrence_torch

    dropped, bad_delete = latches
    cap, n = table.capacity, chunk.capacity
    dev = slots.device
    rows_active = chunk.valid
    signs = chunk.effective_signs()
    is_ins = signs > 0
    is_del = rows_active & (signs < 0)
    gslots = slots.clamp(0, cap - 1).long()
    dropped |= (rows_active & (slots < 0)).any()
    pre_present = st["present"][gslots]
    dup = _chunk_dup(slots, rows_active)
    bad_delete |= (is_del & ~dup & ~(slots < 0) & ~(found & pre_present)).any()
    writer = _last_occurrence_torch(slots, rows_active)
    w = slots[writer].long()
    table.live[w] = is_ins[writer]
    moved = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in part_keys:
        moved |= st["em"][k][gslots] != _i64(chunk.col(k))
    ghost = writer & is_ins & st["em_valid"][gslots] & moved
    st["present"][w] = is_ins[writer]
    for name in lane_names:
        st["buf"][name][w] = chunk.col(name)[writer].to(st["buf"][name].dtype)
        if name in st["bnulls"]:
            st["bnulls"][name][w] = chunk.null_of(name)[writer]
    st["seq"][w] = seq_base + _arange(n, dev)[writer]
    touched = torch.zeros(cap, dtype=torch.bool, device=dev)
    touched[slots[rows_active & (slots >= 0)].long()] = True
    st["sdirty"] |= touched
    return touched, ghost, gslots.to(torch.int32)


def _over_apply_cuda(table, slots, found, st, chunk, part_keys, lane_names, seq_base, latches,
                     scratch):
    dropped, bad_delete = latches
    cap, n = table.capacity, chunk.capacity
    dev = slots.device
    _kernels.check_cuda("over_apply", slots, found, chunk.valid, chunk.ops, n=n)
    _kernels.check_cuda("over_apply", table.live, st["present"], st["seq"], st["em_valid"],
                        st["sdirty"], n=cap)
    _kernels.check_cuda("over_apply", slots, dropped, bad_delete)
    if scratch is None or scratch["first"].shape[0] != cap:
        raise ValueError("over_apply on the card needs an apply_scratch of the arena's capacity")
    keep, lanes = [], []
    for name in lane_names:
        src, dst = chunk.col(name), st["buf"][name]
        if src.dtype != dst.dtype:
            src = src.to(dst.dtype)
            keep.append(src)
        _kernels.check_cuda("over_apply", src, n=n)
        lanes.append((src.data_ptr(), dst.data_ptr(), dst.element_size()))
        if name in st["bnulls"]:
            ns = chunk.null_of(name)
            keep.append(ns)
            lanes.append((ns.data_ptr(), st["bnulls"][name].data_ptr(), 1))
    pkeys = []
    for k in part_keys:
        src = _i64(chunk.col(k))
        keep.append(src)
        pkeys.append((src.data_ptr(), st["em"][k].data_ptr(), 0))
    touched = torch.empty(cap, dtype=torch.bool, device=dev)
    ghost = torch.empty(n, dtype=torch.bool, device=dev)
    gslots = torch.empty(n, dtype=torch.int32, device=dev)
    _kernels.call(
        "over_diff", "rw_over_apply", _kernels.int64_rows(lanes, DIFF_LANES), len(lanes),
        _kernels.int64_rows(pkeys, DIFF_LANES), len(pkeys), n, cap, slots.data_ptr(),
        found.data_ptr(), chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        st["present"].data_ptr(), st["seq"].data_ptr(), int(seq_base),
        st["em_valid"].data_ptr(), table.live.data_ptr(), st["sdirty"].data_ptr(),
        touched.data_ptr(), ghost.data_ptr(), gslots.data_ptr(), scratch["first"].data_ptr(),
        scratch["last"].data_ptr(), dropped.data_ptr(), bad_delete.data_ptr(),
    )
    return touched, ghost, gslots


def general_recompute(st: dict, touched, ghost, gslots, calls, part_keys, order_col,
                      scratch=None):
    """``_general_over_step`` :1013-1216: sort the members (present or
    emitted slots, plus the ghosts) by (partition keys, live first, order,
    seq) and recompute every call; returns ``(new_out, new_out_nulls,
    dirty_slot)`` by slot. Only the slots of dirty partitions are
    meaningful: kernel AE lands outputs only there (and 0 at every other
    slot). Kernel AE on the card, plain PyTorch on the CPU."""
    if touched.device.type == "cpu":
        return _general_recompute_torch(st, touched, ghost, gslots, calls, part_keys, order_col)
    if touched.device.type == "cuda":
        return _general_recompute_cuda(st, touched, ghost, gslots, calls, part_keys, order_col,
                                       scratch)
    raise ValueError(f"unsupported device {touched.device}")


def _general_recompute_torch(st, touched, ghost, gslots, calls, part_keys, order_col):
    buf, bnulls, em = st["buf"], st["bnulls"], st["em"]
    present, em_valid, seq = st["present"], st["em_valid"], st["seq"]
    cap, n = present.shape[0], ghost.shape[0]
    dev = present.device
    total = cap + n
    gs = gslots.long()
    member_e = torch.cat([present | em_valid, ghost])
    present_e = torch.cat([present, torch.zeros(n, dtype=torch.bool, device=dev)])
    plane_e = [torch.cat([torch.where(present, _i64(buf[k]), em[k]), em[k][gs]])
               for k in part_keys]
    order_e = torch.cat([torch.where(present, _i64(buf[order_col]), em[order_col]),
                         em[order_col][gs]])
    seq_e = torch.cat([seq, seq[gs]])
    touched_e = torch.cat([touched, ghost])
    s_idx = _lexsort([~member_e] + plane_e + [~present_e, order_e, seq_e])
    member_s = member_e[s_idx]
    live_s = present_e[s_idx]

    def s(a, fill):
        return torch.cat([a, torch.full((n,), fill, dtype=a.dtype, device=dev)])[s_idx]

    vals, vnulls = {}, {}
    for c in calls:
        if c.input is not None:
            vals[c.input] = s(_i64(buf[c.input]), 0)
            vnulls[c.input] = (s(bnulls[c.input], True) if c.input in bnulls
                               else torch.zeros(total, dtype=torch.bool, device=dev))
    part_s = [p[s_idx] for p in plane_e] + [member_s]
    gid, outs, onulls = _window_body_torch(total, part_s, order_e[s_idx], live_s, calls,
                                              vals, vnulls, dev)
    seg_t = torch.zeros(total, dtype=torch.bool, device=dev)
    seg_t[gid[touched_e[s_idx]]] = True
    dirty_s = seg_t[gid] & member_s
    at = s_idx < cap
    slot = s_idx[at]
    dirty_slot = torch.zeros(cap, dtype=torch.bool, device=dev)
    dirty_slot[slot] = dirty_s[at]
    new_out, new_nulls = {}, {}
    for name, o in outs.items():
        lane = torch.zeros(cap, dtype=torch.int64, device=dev)
        lane[slot] = o[at]
        new_out[name] = lane
    for name, o in onulls.items():
        lane = torch.zeros(cap, dtype=torch.bool, device=dev)
        lane[slot] = o[at]
        new_nulls[name] = lane
    return new_out, new_nulls, dirty_slot


def _general_keys(st, part_keys, order_col):
    buf, em = st["buf"], st["em"]
    keys = [(buf[k], em[k], _KEY_VALUE) for k in part_keys]
    keys.append((None, None, _KEY_ABSENT))
    keys.append((buf[order_col], em[order_col], _KEY_VALUE))
    keys.append((st["seq"], st["seq"], _KEY_VALUE))
    return keys


def _general_recompute_cuda(st, touched, ghost, gslots, calls, part_keys, order_col, scratch):
    present, em_valid = st["present"], st["em_valid"]
    cap, n = present.shape[0], ghost.shape[0]
    dev = present.device
    _kernels.check_cuda("window_calls", present, em_valid, touched, st["seq"], n=cap)
    _kernels.check_cuda("window_calls", ghost, gslots, n=n)
    keys = _general_keys(st, part_keys, order_col)
    for lane, fb, _ in keys:
        if lane is not None:
            _kernels.check_cuda("window_calls", lane, fb, n=cap)
            if fb.dtype != torch.int64:
                raise TypeError("general_recompute: emitted lanes must be int64")
    if scratch is None:
        scratch = window_scratch(cap + n, _window_scan_lanes(calls), dev)
    domain = {"cap": cap, "n_ghost": n, "m1": present, "m2": em_valid, "present": present,
              "ghost": ghost, "gslot": gslots}
    m, fold = window_fold(domain, keys, scratch)
    plan, srt = None, (0, 0)
    if m:
        plan = window_pack_plan(fold, len(part_keys), len(part_keys) + 1)
        srt = window_order(domain, keys, plan, m, scratch)
    vals, vnulls = {}, {}
    for c in calls:
        if c.input is not None and c.input not in vals:
            vals[c.input] = st["buf"][c.input]
            if c.input in st["bnulls"]:
                vnulls[c.input] = st["bnulls"][c.input]
    new_out = {c.output: torch.empty(cap, dtype=torch.int64, device=dev) for c in calls}
    new_nulls = {c.output: torch.empty(cap, dtype=torch.bool, device=dev) for c in calls}
    dirty_slot = torch.empty(cap, dtype=torch.bool, device=dev)
    _window_calls_cuda(domain, plan, srt, calls, scratch, m, vals, vnulls, new_out, new_nulls,
                       True, [], None, None, dirty_slot, touched)
    return new_out, new_nulls, dirty_slot


def over_diff(st: dict, emnulls: dict, new_out, new_nulls, dirty_slot, lane_names, out_names,
              ops_del, ops_ins, scratch=None):
    """``_general_over_step`` :1217-1292: ``(ret_chunk, ins_chunk)``, the
    retract rows (emitted, in a dirty partition, gone or changed) and the
    insert rows (present, in a dirty partition, new or changed), each
    compacted into a dense prefix in slot order; the emitted lanes
    (``st["em"]``, ``emnulls``, ``st["em_valid"]``) and ``sdirty`` are
    updated in place. Values are compared only where both sides are
    non-NULL. Kernel AF's ``rw_over_diff`` on the card, plain PyTorch on
    the CPU."""
    if dirty_slot.device.type == "cpu":
        return _over_diff_torch(st, emnulls, new_out, new_nulls, dirty_slot, lane_names,
                                out_names, ops_del, ops_ins)
    if dirty_slot.device.type == "cuda":
        return _over_diff_cuda(st, emnulls, new_out, new_nulls, dirty_slot, lane_names,
                               out_names, ops_del, ops_ins, scratch)
    raise ValueError(f"unsupported device {dirty_slot.device}")


def _over_diff_torch(st, emnulls, new_out, new_nulls, dirty_slot, lane_names, out_names,
                     ops_del, ops_ins):
    buf, bnulls, em = st["buf"], st["bnulls"], st["em"]
    present, em_valid = st["present"], st["em_valid"]
    cap = present.shape[0]
    dev = present.device
    zeros = lambda: torch.zeros(cap, dtype=torch.bool, device=dev)
    both = present & em_valid
    changed = zeros()
    for name in lane_names:
        cn = bnulls.get(name, zeros())
        en = emnulls.get(name, zeros())
        changed |= ~cn & ~en & (_i64(buf[name]) != em[name])
        changed |= cn != en
    for name in out_names:
        nn = new_nulls[name]
        en = emnulls.get(name, zeros())
        changed |= torch.where(~nn, new_out[name], 0) != torch.where(~en, em[name], 0)
        changed |= nn != en
    changed &= both
    retract = em_valid & dirty_slot & (~present | changed)
    insert = present & dirty_slot & (~em_valid | changed)
    st["sdirty"] |= retract | insert
    # a dense prefix in slot order: argsort(~mask, stable) (reference :1246)
    rorder = torch.sort((~retract).to(torch.int8), stable=True).indices
    iorder = torch.sort((~insert).to(torch.int8), stable=True).indices
    ret_cols = {name: em[name][rorder] for name in lane_names + out_names}
    ret_nulls = {name: a[rorder] for name, a in emnulls.items()}
    ret = StreamChunk(columns=ret_cols, valid=retract[rorder], nulls=ret_nulls, ops=ops_del)
    ins_cols = {name: _i64(buf[name])[iorder] for name in lane_names}
    ins_cols.update({name: new_out[name][iorder] for name in out_names})
    ins_nulls = {name: a[iorder] for name, a in bnulls.items()}
    ins_nulls.update({name: a[iorder] for name, a in new_nulls.items()})
    ins = StreamChunk(columns=ins_cols, valid=insert[iorder], nulls=ins_nulls, ops=ops_ins)
    upd = insert
    for name in lane_names:
        em[name][upd] = _i64(buf[name])[upd]
        lane = emnulls.setdefault(name, zeros())
        lane[upd] = bnulls.get(name, zeros())[upd]
    for name in out_names:
        em[name][upd] = new_out[name][upd]
        lane = emnulls.setdefault(name, zeros())
        lane[upd] = new_nulls[name][upd]
    st["em_valid"].copy_((em_valid & ~retract) | insert)
    return ret, ins


def diff_scratch(cap: int, device) -> Dict[str, torch.Tensor]:
    """Kernel AF's diff scratch over ``cap`` slots: each tile's published
    retract and insert counts (the look-back), the tile counter and the
    two totals."""
    tiles = -(-cap // DIFF_TILE)
    return {"status": torch.empty(tiles + 3, dtype=torch.int64, device=device)}


def _over_diff_cuda(st, emnulls, new_out, new_nulls, dirty_slot, lane_names, out_names,
                    ops_del, ops_ins, scratch):
    buf, bnulls, em = st["buf"], st["bnulls"], st["em"]
    present, em_valid = st["present"], st["em_valid"]
    cap = present.shape[0]
    dev = present.device
    _kernels.check_cuda("over_diff", present, em_valid, dirty_slot, st["sdirty"], n=cap)
    if scratch is None:
        scratch = diff_scratch(cap, dev)
    had = set(emnulls)  # the retract chunk carries the null lanes emitted before this step
    for name in lane_names + out_names:
        if name not in emnulls:
            emnulls[name] = torch.zeros(cap, dtype=torch.bool, device=dev)
    ret_cols = {name: torch.empty(cap, dtype=torch.int64, device=dev)
                for name in lane_names + out_names}
    ret_nulls = {name: torch.empty(cap, dtype=torch.bool, device=dev) for name in sorted(had)}
    ins_cols = {name: torch.empty(cap, dtype=torch.int64, device=dev)
                for name in lane_names + out_names}
    ins_nulls = {name: torch.empty(cap, dtype=torch.bool, device=dev) for name in bnulls}
    ins_nulls.update({name: torch.empty(cap, dtype=torch.bool, device=dev)
                      for name in out_names})
    rows = []
    for name in lane_names + out_names:
        is_out = name in out_names
        cur = new_out[name] if is_out else buf[name]
        cn = new_nulls[name] if is_out else bnulls.get(name)
        _kernels.check_cuda("over_diff", cur, em[name], emnulls[name], n=cap)
        if not is_out and cur.dtype not in (torch.int64, torch.int32, torch.bool):
            raise TypeError(f"over_diff: lane {name!r} of dtype {cur.dtype}")
        rows.append((cur.data_ptr(), _kernels.dtype_code(cur), 0 if cn is None else cn.data_ptr(),
                     em[name].data_ptr(), emnulls[name].data_ptr(),
                     ret_cols[name].data_ptr(),
                     ret_nulls[name].data_ptr() if name in ret_nulls else 0,
                     ins_cols[name].data_ptr(),
                     ins_nulls[name].data_ptr() if name in ins_nulls else 0))
    ret_valid = torch.empty(cap, dtype=torch.bool, device=dev)
    ins_valid = torch.empty(cap, dtype=torch.bool, device=dev)
    _kernels.call(
        "over_diff", "rw_over_diff", _kernels.int64_rows(rows, DIFF_LANES), len(rows), cap,
        present.data_ptr(), em_valid.data_ptr(), dirty_slot.data_ptr(), st["sdirty"].data_ptr(),
        scratch["status"].data_ptr(), ret_valid.data_ptr(), ins_valid.data_ptr(),
    )
    ret = StreamChunk(columns=ret_cols, valid=ret_valid, nulls=ret_nulls, ops=ops_del)
    ins = StreamChunk(columns=ins_cols, valid=ins_valid, nulls=ins_nulls, ops=ops_ins)
    return ret, ins


class GeneralOverWindowExecutor(Executor, Checkpointable):
    """General (retractable) window functions over partitions
    (general.rs:49): inserts, deletes and updates ANYWHERE in the ORDER
    BY order retract and re-emit every row whose window value changes.
    All rows live in a pk-keyed arena on the card; complete dirty
    partitions are recomputed per chunk and diffed against the emitted
    lanes. Supports every WindowCall kind including lead/lag(k) and
    static ROWS frames. Checkpointable: current rows + emitted rows
    persist."""

    def __init__(
        self,
        partition_by: Sequence[str],
        order_col: str,
        pk: Sequence[str],
        calls: Sequence[WindowCall],
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 12,
        nullable: Sequence[str] = (),
        table_id: str = "general_over",
        device="cuda",
    ):
        self.part_keys = tuple(partition_by)
        self.order_col = order_col
        self.pk = tuple(pk)
        self.calls = tuple(calls)
        for c in self.calls:
            if c.kind in ("rank", "dense_rank") and c.input != order_col:
                raise ValueError(f"{c.kind} ranks by the executor's order column "
                                 f"{order_col!r}; got input {c.input!r}")
        for nm, d in schema_dtypes.items():
            if d.is_floating_point or d.is_complex:
                raise ValueError(
                    f"general OverWindow lane {nm!r} has non-integer dtype {d}: emitted/diffed "
                    "lanes are carried as int64 (dictionary- or scale-encode upstream)")
        self.device = resolve_device(device)
        self.lane_names = tuple(schema_dtypes)
        self.out_names = tuple(c.output for c in self.calls)
        self.schema_dtypes = dict(schema_dtypes)
        self.nullable = tuple(nullable)
        self.table_id = table_id
        self._alloc(capacity)
        self._seq_base = 0
        self._dropped = torch.zeros((), dtype=torch.bool, device=self.device)
        self._bad_delete = torch.zeros((), dtype=torch.bool, device=self.device)
        self._bound = 0

    def trace_contract(self):
        """Retract/re-emit diff chunks are arena-capacity lanes: one fixed
        emission shape, so a device MV behind it fuses (reference :1394)."""
        return {"kind": "device", "state": (self.table, self.buf, self.em), "donate": True,
                "emission": "fixed", "emission_caps": (self.capacity,)}

    def _alloc(self, cap: int) -> None:
        dev = self.device
        self.table = HashTable.create(cap, tuple(self.schema_dtypes[k] for k in self.pk),
                                      device=dev)
        self.buf = {n: torch.zeros(cap, dtype=d, device=dev)
                    for n, d in self.schema_dtypes.items()}
        self.bnulls = {n: torch.zeros(cap, dtype=torch.bool, device=dev) for n in self.nullable}
        self.present = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.seq = torch.zeros(cap, dtype=torch.int64, device=dev)
        self.em = {n: torch.zeros(cap, dtype=torch.int64, device=dev)
                   for n in self.lane_names + self.out_names}
        self.emnulls: Dict[str, torch.Tensor] = {}
        self.em_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.sdirty = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.stored = torch.zeros(cap, dtype=torch.bool, device=dev)
        self._ops = None
        self._scr = None

    @property
    def capacity(self) -> int:
        return self.present.shape[0]

    def _state(self) -> dict:
        return {"buf": self.buf, "bnulls": self.bnulls, "present": self.present,
                "seq": self.seq, "em": self.em, "em_valid": self.em_valid,
                "sdirty": self.sdirty}

    def _scratch(self, n: int) -> dict:
        """The kernels' scratch on the card, made per capacity and chunk
        size; the constant ops lanes of the two emissions."""
        cap, dev = self.capacity, self.device
        if self._ops is None:
            self._ops = (torch.full((cap,), int(Op.DELETE), dtype=torch.int32, device=dev),
                         torch.zeros(cap, dtype=torch.int32, device=dev))
        if dev.type != "cuda":
            return {}
        if self._scr is None or self._scr["n"] != n:
            self._scr = {
                "n": n, "apply": apply_scratch(cap, dev),
                "window": window_scratch(cap + n, _window_scan_lanes(self.calls), dev),
                "diff": diff_scratch(cap, dev),
            }
        return self._scr

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        for c in self.calls:
            if c.kind in ("rank", "dense_rank") and c.input in chunk.nulls:
                raise ValueError(f"rank order column {c.input!r} carries a null lane (NULL "
                                 "ordering unsupported)")
        self._maybe_grow(chunk.capacity)
        scr = self._scratch(chunk.capacity)
        keys = tuple(chunk.col(k) for k in self.pk)
        self.table, slots, found, _ = lookup_or_insert(self.table, keys, chunk.valid)
        st = self._state()
        touched, ghost, gslots = over_apply(
            self.table, slots, found, st, chunk, self.part_keys, self.lane_names,
            self._seq_base, (self._dropped, self._bad_delete), scr.get("apply"))
        new_out, new_nulls, dirty_slot = general_recompute(
            st, touched, ghost, gslots, self.calls, self.part_keys, self.order_col,
            scr.get("window"))
        ret, ins = over_diff(st, self.emnulls, new_out, new_nulls, dirty_slot, self.lane_names,
                             self.out_names, self._ops[0], self._ops[1], scr.get("diff"))
        self._seq_base += chunk.capacity
        self._bound += chunk.capacity
        return [ret, ins]

    def _maybe_grow(self, incoming: int) -> None:
        cap = self.capacity
        if self._bound + incoming <= cap * GROW_AT:
            return
        claimed, survivors = read_scalars(self.table.occupancy(),
                                          (self.table.live | self.sdirty | self.stored).sum())
        new_cap = plan_rehash(cap, incoming, claimed, survivors, GROW_AT)
        if new_cap is not None:
            self._rehash(new_cap)
            (claimed,) = read_scalars(self.table.occupancy())
        self._bound = int(claimed)

    def _rehash(self, new_cap: int) -> None:
        """A slot survives iff a live row, an unflushed emission-state
        change (sdirty) or a durable row whose tombstone is not staged yet
        (stored) still needs it (reference :1517): kernel A into the new
        table, kernel I moves every lane."""
        dev = self.device
        old = self.table
        keep = (old.live | self.sdirty | self.stored) & (old.fp1 != 0)
        new = HashTable.create(new_cap, tuple(k.dtype for k in old.keys), device=dev)
        new, slots, _, _ = lookup_or_insert(new, old.keys, keep)
        srcs, dsts = [old.live], [new.live]

        def mv(a):
            out = torch.zeros((new_cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
            srcs.append(a)
            dsts.append(out)
            return out

        buf = {n: mv(a) for n, a in self.buf.items()}
        bnulls = {n: mv(a) for n, a in self.bnulls.items()}
        present, seq = mv(self.present), mv(self.seq)
        em = {n: mv(a) for n, a in self.em.items()}
        emnulls = {n: mv(a) for n, a in self.emnulls.items()}
        em_valid, sdirty, stored = mv(self.em_valid), mv(self.sdirty), mv(self.stored)
        move_slots(tuple(srcs), tuple(dsts), slots, keep)
        self.table, self.buf, self.bnulls = new, buf, bnulls
        self.present, self.seq, self.em, self.emnulls = present, seq, em, emnulls
        self.em_valid, self.sdirty, self.stored = em_valid, sdirty, stored
        self._ops = None
        self._scr = None

    def on_barrier(self, barrier) -> List[StreamChunk]:
        self._staged_scalars = stage_scalars(self._dropped, self._bad_delete)
        if barrier is None:
            self.finish_barrier()
        return []

    def _on_barrier_scalars(self, vals) -> None:
        dr, bd = vals
        if dr:
            raise RuntimeError("general OverWindow row arena overflowed")
        if bd:
            raise RuntimeError("general OverWindow received a DELETE for an unknown pk "
                               "(inconsistent upstream)")

    # -- integrity ----------------------------------------------------------
    def _lanes(self) -> Dict[str, torch.Tensor]:
        lanes = {f"k{i}": k for i, k in enumerate(self.table.keys)}
        for n in self.lane_names:
            lanes[f"c_{n}"] = self.buf[n]
        for n, a in self.bnulls.items():
            lanes[f"cn_{n}"] = a
        for n, a in self.em.items():
            lanes[f"e_{n}"] = a
        for n, a in self.emnulls.items():
            lanes[f"en_{n}"] = a
        lanes["seq"] = self.seq
        lanes["present"] = self.present
        return lanes

    def digest_lanes(self):
        return self._lanes(), self.present | self.em_valid

    def state_digest(self) -> int:
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore -------------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        sel, tomb, _, n_dirty = stage_select(self.sdirty, (self.present, self.em_valid),
                                             self.stored)
        if not n_dirty:
            return []
        lanes = self._lanes()
        key_names = tuple(f"k{i}" for i in range(len(self.table.keys)))
        pulled = pull_rows(lanes, sel, {"tombstone": tomb})
        tombstone = pulled.pop("tombstone")
        mark_checkpointed(self.stored, self.sdirty, sel, tomb)
        keys = {k: pulled[k] for k in key_names}
        vals = {k: v for k, v in pulled.items() if k not in key_names}
        return [StateDelta(self.table_id, keys, vals, tombstone, key_names)]

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        self._alloc(grow_pow2(max(n, 1), self.capacity, GROW_AT))
        if n:
            self.table, slots = insert_keys(self.table, key_cols, n)
            pres = np.asarray(value_cols["present"], dtype=bool)
            dst = {"live": self.table.live, "stored": self.stored, "present": self.present,
                   "em_valid": self.em_valid, "seq": self.seq}
            src = {"live": np.ones(n, np.bool_), "stored": np.ones(n, np.bool_),
                   "present": pres, "em_valid": pres,
                   "seq": np.asarray(value_cols["seq"], np.int64)}
            for nme in self.lane_names:
                dst[f"c_{nme}"], src[f"c_{nme}"] = self.buf[nme], value_cols[f"c_{nme}"]
            for nme in self.bnulls:
                if f"cn_{nme}" in value_cols:
                    dst[f"cn_{nme}"], src[f"cn_{nme}"] = self.bnulls[nme], value_cols[f"cn_{nme}"]
            for nme in self.em:
                if f"e_{nme}" in value_cols:
                    dst[f"e_{nme}"], src[f"e_{nme}"] = self.em[nme], value_cols[f"e_{nme}"]
            for key in value_cols:
                if key.startswith("en_"):
                    self.emnulls[key[3:]] = torch.zeros(self.capacity, dtype=torch.bool,
                                                        device=self.device)
                    dst[key], src[key] = self.emnulls[key[3:]], value_cols[key]
            scatter_rows(dst, slots, src)
            self._seq_base = int(np.asarray(value_cols["seq"]).max()) + 1
        self._bound = int(n)
        self._dropped.zero_()
        self._bad_delete.zero_()
