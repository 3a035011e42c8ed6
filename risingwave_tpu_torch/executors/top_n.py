"""Append-only GroupTopN — per-group top-k band maintenance.

Port of ``risingwave_tpu/executors/top_n.py`` (``_topn_step`` :67,
``_topn_rebuild`` :193, ``GroupTopNExecutor`` :211). Reference:
src/stream/src/executor/top_n/group_top_n.rs:63 with top_n_cache.rs's
band logic, specialised for insert-only input (top_n_appendonly.rs),
which RisingWave's planner picks for an append-only stream.

Each group's top k rows live in fixed-shape bands beside the group
table: ``order``, ``band_valid`` and one lane per payload column, each
``(capacity, k)``, a band's valid entries at positions 0.. in rank
order. The order key is one int64 lane (the order column cast, bitwise
NOT for DESC). Per chunk, kernel A finds or inserts each inserted row's
group, kernel J's first-occurrence entry marks one row per touched
group, and kernel U (``csrc/topn_band.cu``, ``topn_band_step``) merges
each touched group's band with the group's chunk rows, keeps rank < k
(ties: the band's entries first in rank order, then chunk rows in row
order, the reference's stable lexsort), rewrites the band and writes
the emission chunk: every band leaver as a DELETE (by group leader row,
then band position), then every entering chunk row as an INSERT (by
row), as the reference's layout does, so an upsert MV behind it keeps
the right row. Three latches stay on the card until the barrier: a
DELETE seen (append-only), a row without a group slot, an emission
past ``out_cap``.

A rebuild (``_topn_rebuild``) re-inserts the group keys (kernel A) and
moves the slot lanes and the ``(capacity, k)`` bands to their new slots
(kernel I; a band row moves as k elements). Digest, checkpoint and
restore stage the band rows as 2-D rows (``bv``, ``order``, ``p_*``)
through kernel R, the digest's band lanes masked by ``band_valid``.
The reference's unbucketed twin and its analysis hooks are not ported.
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
    expired_slots,
    first_occurrence_mask,
    first_scratch,
    lookup_or_insert,
    move_slots,
    read_scalars,
)
from risingwave_tpu_torch.runtime.bucketing import BucketAllocator, BucketPolicy
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    StateDelta,
    grow_pow2,
    pull_rows,
)
from risingwave_tpu_torch.types import Op

GROW_AT = 0.5
# payload lanes and group key lanes one rw_topn_step call takes, and the
# largest band (csrc/topn_band.cu TB_MAX_LANES, TB_MAX_KEYS, TB_MAX_K)
BAND_LANES = 16
BAND_KEYS = 8
BAND_MAX_K = 64


def band_workspace(n: int, k: int) -> int:
    """int32 words of kernel U's scratch for an n-row chunk (the layout
    of csrc/topn_band.cu ``rw_topn_step``)."""
    return (9 + k) * n + 2 * n // _kernels.SCAN_TILE + 8


def topn_band_step(table: HashTable, state: Dict[str, torch.Tensor], chunk: StreamChunk,
                   group_keys, order_col: str, desc: bool, k: int, payload, out_cap: int,
                   scratch: torch.Tensor, latches) -> StreamChunk:
    """``_topn_step``, with the table and the bands updated IN PLACE:
    kernel A, the first-occurrence mask (kernel J), then kernel U.
    ``latches`` = (saw_delete, dropped, overflow), () bool tensors set
    in place; ``scratch`` is the group table's ``first_scratch`` lane.
    Returns the emission chunk of ``out_cap`` rows."""
    signs = chunk.effective_signs()
    valid = chunk.valid & (signs > 0)
    key_cols = tuple(chunk.col(g) for g in group_keys)
    table, slots, _, _ = lookup_or_insert(table, key_cols, valid)
    dev = slots.device
    if dev.type == "cpu":
        return _topn_band_torch(table, state, chunk, slots, valid, group_keys, order_col, desc,
                                k, payload, out_cap, latches)
    if dev.type == "cuda":
        fmask = first_occurrence_mask(slots, valid, scratch)
        return _topn_band_cuda(table, state, chunk, slots, fmask, group_keys, order_col, desc,
                               k, payload, out_cap, scratch, latches)
    raise ValueError(f"unsupported device {dev}")


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))``: stable, by primary then
    secondary."""
    p1 = torch.sort(secondary, stable=True).indices
    return p1[torch.sort(primary[p1], stable=True).indices]


def _topn_band_torch(table, state, chunk, slots, valid, group_keys, order_col, desc, k, payload,
                     out_cap, latches):
    """The reference's step, op for op: one (n * (k + 1),) array of the
    touched bands' entries then the chunk's rows, lexsorted by (slot,
    order key), rank < k kept."""
    saw_delete, dropped, overflow = latches
    saw_delete |= (chunk.valid & (chunk.effective_signs() < 0)).any()
    table.live[slots[valid & (slots >= 0)].long()] = True
    dropped |= (valid & (slots < 0)).any()
    valid = valid & (slots >= 0)
    n = valid.shape[0]
    dev = slots.device
    sl = slots.clamp(min=0).long()
    state["sdirty"][sl[valid]] = True
    order_in = chunk.col(order_col).to(torch.int64)
    if desc:
        order_in = ~order_in
    fmask = _first_occurrence_torch(slots, valid)
    band_vld = state["band_valid"][sl] & fmask[:, None]
    big = 1 << 62
    rep = sl.repeat_interleave(k)
    c_slot = torch.cat([rep, sl])
    c_valid = torch.cat([band_vld.reshape(-1), valid])
    c_order = torch.cat([state["order"][sl].reshape(-1), order_in])
    c_origin = torch.arange(n * (k + 1), device=dev) >= n * k
    band_src = torch.cat([rep * k + torch.arange(k, device=dev).repeat(n), sl * 0])
    chunk_src = torch.cat([rep * 0, torch.arange(n, device=dev)])
    skey = torch.where(c_valid, c_slot, big)
    perm = _lexsort2(skey, torch.where(c_valid, c_order, big))
    s_sorted = skey[perm]
    seq = torch.arange(n * (k + 1), device=dev)
    is_new = torch.ones_like(c_valid)
    is_new[1:] = s_sorted[1:] != s_sorted[:-1]
    rank = seq - torch.cummax(torch.where(is_new, seq, 0), 0).values
    kept = torch.zeros_like(c_valid)
    kept[perm] = (rank < k) & (s_sorted < big)
    new_pos = torch.zeros_like(seq)
    new_pos[perm] = rank
    dst = (c_slot * k + new_pos)[kept]
    state["band_valid"][sl[valid & fmask]] = False
    state["band_valid"].view(-1)[dst] = True
    gathered = {}
    for name in ("order",) + tuple(payload):
        lane = state[name].view(-1)
        src = order_in if name == "order" else chunk.col(name)
        c_vals = torch.where(c_origin, src[chunk_src], lane[band_src])
        gathered[name] = c_vals
        lane[dst] = c_vals[kept].to(lane.dtype)
    emit_ins = kept & c_origin & c_valid
    emit = emit_ins | (~kept & ~c_origin & c_valid)
    pos = torch.cumsum(emit.to(torch.int64), 0) - 1
    overflow |= (emit & (pos >= out_cap)).any()
    ok = emit & (pos < out_cap)
    at = pos[ok]

    def compact(src):
        out = torch.zeros(out_cap, dtype=src.dtype, device=dev)
        out[at] = src[ok]
        return out

    cols = {g: compact(table.keys[i][c_slot]) for i, g in enumerate(group_keys)}
    cols[order_col] = compact(~gathered["order"] if desc else gathered["order"])
    for name in payload:
        cols[name] = compact(gathered[name])
    ops = compact(torch.where(emit_ins, int(Op.INSERT), int(Op.DELETE)).to(torch.int32))
    out_valid = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    out_valid[at] = True
    return StreamChunk(columns=cols, valid=out_valid, nulls={}, ops=ops)


def _topn_band_cuda(table, state, chunk, slots, fmask, group_keys, order_col, desc, k, payload,
                    out_cap, scratch, latches):
    n = chunk.capacity
    cap = table.capacity
    dev = slots.device
    if not 1 <= k <= BAND_MAX_K:
        raise ValueError(f"topn_band_step: k = {k} outside 1..{BAND_MAX_K}")
    _kernels.check_cuda("topn_band", slots, fmask, chunk.valid, chunk.ops, n=n)
    _kernels.check_cuda("topn_band", table.live, state["sdirty"], scratch, n=cap)
    _kernels.check_cuda("topn_band", state["order"], state["band_valid"], *latches)
    if chunk.ops.dtype != torch.int32 or scratch.dtype != torch.int32:
        raise TypeError("topn_band_step: int32 ops and scratch lanes")
    for t in latches:
        if t.dtype != torch.bool or t.shape != ():
            raise TypeError("topn_band_step: latches must be () bool tensors")
    keep_alive = []  # a cast lane must outlive the launch (_kernels.call)
    order_src = chunk.col(order_col)
    if order_src.dtype not in (torch.int32, torch.int64):
        order_src = order_src.to(torch.int64)  # the reference's astype(int64)
        keep_alive.append(order_src)
    _kernels.check_cuda("topn_band", order_src, n=n)
    cols = {}
    key_rows = []
    for g, lane in zip(group_keys, table.keys):
        if lane.element_size() not in (1, 4, 8):
            raise TypeError(f"topn_band_step: group key {g!r} of dtype {lane.dtype}")
        cols[g] = torch.zeros(out_cap, dtype=lane.dtype, device=dev)
        key_rows.append((lane.data_ptr(), cols[g].data_ptr(), lane.element_size()))
    cols[order_col] = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    pay_rows = []
    for name in payload:
        band = state[name]
        src = chunk.col(name)
        if src.dtype != band.dtype:
            src = src.to(band.dtype)
            keep_alive.append(src)
        _kernels.check_cuda("topn_band", src, n=n)
        if band.element_size() not in (1, 4, 8):
            raise TypeError(f"topn_band_step: band lane {name!r} of dtype {band.dtype}")
        if band.shape != (cap, k) or not band.is_contiguous():
            raise ValueError(f"topn_band_step: band lane {name!r} is not a contiguous ({cap}, {k})")
        cols[name] = torch.zeros(out_cap, dtype=band.dtype, device=dev)
        pay_rows.append((band.data_ptr(), src.data_ptr(), cols[name].data_ptr(),
                         band.element_size()))
    ops = torch.zeros(out_cap, dtype=torch.int32, device=dev)
    out_valid = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    work = torch.empty(band_workspace(n, k), dtype=torch.int32, device=dev)
    _kernels.call(
        "topn_band", "rw_topn_step", _kernels.int64_rows(key_rows, BAND_KEYS), len(key_rows),
        _kernels.int64_rows(pay_rows, BAND_LANES), len(pay_rows), n, k, cap, out_cap,
        slots.data_ptr(), fmask.data_ptr(), chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        order_src.data_ptr(), _kernels.dtype_code(order_src), int(desc), table.live.data_ptr(),
        state["sdirty"].data_ptr(), scratch.data_ptr(), state["order"].data_ptr(),
        state["band_valid"].data_ptr(), cols[order_col].data_ptr(), ops.data_ptr(),
        out_valid.data_ptr(), *(t.data_ptr() for t in latches), work.data_ptr(),
    )
    return StreamChunk(columns=cols, valid=out_valid, nulls={}, ops=ops)


def topn_rebuild(table: HashTable, state: Dict[str, torch.Tensor], new_cap: int):
    """``_topn_rebuild``: the kept groups (``live | sdirty``, claimed)
    into a fresh table of ``new_cap`` (kernel A), every slot lane and
    band row moved to its new slot (kernel I; a ``(capacity, k)`` lane
    moves as k elements a slot). Returns the new table and state."""
    dev = table.device
    keep = (table.live | state["sdirty"]) & (table.fp1 != 0)
    new = HashTable.create(new_cap, tuple(x.dtype for x in table.keys), device=dev)
    new, slots, _, _ = lookup_or_insert(new, table.keys, keep)
    k = state["band_valid"].shape[1]
    if new_cap * k >= 2**31:
        raise ValueError(f"topn_rebuild: ({new_cap}, {k}) bands exceed int32 positions")
    flat = slots.to(torch.int64)[:, None] * k + torch.arange(k, device=dev)
    flat_slots = torch.where(slots[:, None] >= 0, flat, -1).reshape(-1).to(torch.int32)
    flat_keep = keep.repeat_interleave(k)
    new_state, rows, bands = {}, [(table.live, new.live)], []
    for name, a in state.items():
        new_state[name] = torch.zeros((new_cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        (bands if a.dim() == 2 else rows).append((a, new_state[name]))
    move_slots([s for s, _ in rows], [d for _, d in rows], slots, keep)
    move_slots([s.reshape(-1) for s, _ in bands], [d.view(-1) for _, d in bands], flat_slots,
               flat_keep)
    return new, new_state


class GroupTopNExecutor(Executor, Checkpointable):
    """Append-only per-group TOP k BY order_col [DESC].

    Emits the top-k delta stream: INSERT when a row enters its group's
    top k, DELETE when a newcomer pushes it out; the chunk carries the
    group keys, the order column (int64) and the payload columns.
    ``window_key`` (a group column, retention): a watermark expires the
    groups below it. The group table walks the bucket lattice."""

    def __init__(
        self,
        group_keys: Sequence[str],
        order_col: str,
        k: int,
        schema_dtypes: Dict[str, torch.dtype],
        payload: Sequence[str] = (),
        desc: bool = True,
        capacity: int = 1 << 14,
        out_cap: int = 1 << 13,
        window_key: Optional[Tuple[str, int]] = None,
        table_id: str = "group_top_n",
        bucket_policy: Optional[BucketPolicy] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self._buckets = BucketAllocator(
            bucket_policy or BucketPolicy.from_capacity(capacity, grow_at=GROW_AT)
        )
        self.group_keys = tuple(group_keys)
        self.order_col = order_col
        self.k = int(k)
        self.desc = desc
        self.payload = tuple(p for p in payload if p != order_col)
        self.out_cap = out_cap
        self.window_key = window_key
        self.table_id = table_id
        self._dtypes = dict(schema_dtypes)
        self._fresh(capacity)
        self._bound = 0

    def _fresh(self, cap: int) -> None:
        """Empty group table, bands, marks, scratch and latches of ``cap``
        slots."""
        dev, k = self.device, self.k
        self.table = HashTable.create(cap, tuple(self._dtypes[g] for g in self.group_keys),
                                      device=dev)
        self.state = {
            "order": torch.zeros((cap, k), dtype=torch.int64, device=dev),
            "band_valid": torch.zeros((cap, k), dtype=torch.bool, device=dev),
            "sdirty": torch.zeros(cap, dtype=torch.bool, device=dev),
            "stored": torch.zeros(cap, dtype=torch.bool, device=dev),
        }
        for p in self.payload:
            self.state[p] = torch.zeros((cap, k), dtype=self._dtypes[p], device=dev)
        self.scratch = first_scratch(cap, dev)
        self._latches = tuple(torch.zeros((), dtype=torch.bool, device=dev) for _ in range(3))

    def trace_contract(self):
        """Every emission chunk has ``out_cap`` rows, and the group table
        and bands walk the allocator's lattice (reference :281)."""
        return {
            "kind": "device",
            "state": (self.table, self.state),
            "donate": True,
            "emission": "fixed",
            "emission_caps": (self.out_cap,),
            "window_buckets": self._buckets.lattice,
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        for c in self.group_keys + (self.order_col,) + self.payload:
            if c in chunk.nulls:
                raise ValueError(f"TopN column {c!r} carries NULLs (unsupported)")
        self._maybe_grow(chunk.capacity)
        self._bound += chunk.capacity
        out = topn_band_step(self.table, self.state, chunk, self.group_keys, self.order_col,
                             self.desc, self.k, self.payload, self.out_cap, self.scratch,
                             self._latches)
        return [out]

    def _maybe_grow(self, incoming: int) -> None:
        cap = self.table.capacity
        if not self._buckets.should_plan(cap, self._bound, incoming):
            return
        claimed, surv = read_scalars(self.table.occupancy(),
                                     (self.table.live | self.state["sdirty"]).sum())
        new_cap = self._buckets.plan(cap, incoming, claimed, surv)
        if new_cap is not None:
            self.table, self.state = topn_rebuild(self.table, self.state, new_cap)
            self.scratch = first_scratch(new_cap, self.device)
            claimed = int(self.table.occupancy())
        self._bound = claimed

    def on_barrier(self, barrier) -> List[StreamChunk]:
        # the host bound (an upper estimate) keeps shrink lazy and
        # conservative without a device read
        self._buckets.note_barrier(self.table.capacity, self._bound)
        saw_delete, dropped, overflow = read_scalars(*self._latches)
        if saw_delete:
            raise RuntimeError("append-only TopN received a DELETE")
        if dropped:
            raise RuntimeError("TopN group table overflowed; grow capacity")
        if overflow:
            raise RuntimeError("TopN emission overflowed out_cap")
        return []

    def on_watermark(self, watermark: Watermark):
        if self.window_key is None or watermark.column != self.window_key[0]:
            return watermark, []
        expired = expired_slots(self.table, self.group_keys.index(self.window_key[0]),
                                watermark.value - self.window_key[1])
        self.table.live &= ~expired
        self.state["band_valid"] &= ~expired[:, None]
        self.state["sdirty"] |= expired
        return watermark, []

    # -- integrity --------------------------------------------------------
    def digest_lanes(self):
        """Key lanes, ``bv`` and the band lanes masked by ``band_valid``
        (stale entries in vacated band positions must not move the
        digest), live groups."""
        bv = self.state["band_valid"]
        lanes = {f"k{i}": x for i, x in enumerate(self.table.keys)}
        lanes["bv"] = bv
        lanes["order"] = integrity.Masked(self.state["order"], bv)
        for p in self.payload:
            lanes[f"p_{p}"] = integrity.Masked(self.state[p], bv)
        return lanes, self.table.live

    def state_digest(self) -> int:
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore ----------------------------------------------
    def _band_lanes(self) -> Dict[str, torch.Tensor]:
        lanes = {"bv": self.state["band_valid"], "order": self.state["order"]}
        lanes.update({f"p_{p}": self.state[p] for p in self.payload})
        return lanes

    def checkpoint_delta(self) -> List[StateDelta]:
        """The groups changed since the last checkpoint with their whole
        bands as 2-D rows, through kernel R; the marks flip eagerly."""
        st = self.state
        sel, tomb, n, n_sdirty = stage_select(st["sdirty"], (self.table.live,), st["stored"])
        if not n_sdirty:
            return []
        lanes = {f"k{i}": x for i, x in enumerate(self.table.keys)}
        key_names = tuple(lanes)
        lanes.update(self._band_lanes())
        pulled = pull_rows(lanes, sel, {"tombstone": tomb})
        tombstone = pulled.pop("tombstone")
        mark_checkpointed(st["stored"], st["sdirty"], sel, tomb)
        keys = {x: pulled[x] for x in key_names}
        vals = {x: v for x, v in pulled.items() if x not in key_names}
        return [StateDelta(self.table_id, keys, vals, tombstone, key_names)]

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """A table of ``grow_pow2(n, capacity)`` slots; kernel A inserts
        the group keys, kernel R lands live, stored and the band rows."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        self._fresh(grow_pow2(n, self.table.capacity, GROW_AT))
        self._bound = int(n)
        if not n:
            return
        self.table, slots = insert_keys(self.table, key_cols, n)
        dst = self._band_lanes()
        src = {name: value_cols[name] for name in dst}
        dst["live"], src["live"] = self.table.live, np.ones(n, np.bool_)
        dst["stored"], src["stored"] = self.state["stored"], np.ones(n, np.bool_)
        scatter_rows(dst, slots, src)
