"""Sort executor -- emit-on-window-close ordered output.

Port of ``risingwave_tpu/executors/sort.py``: ``_sort_append`` :36,
``_sort_emit`` :72, ``ArenaBufferedExecutor`` :97 and ``SortExecutor``
:326. Reference: src/stream/src/executor/sort.rs:20 + sort_buffer.rs --
rows buffer until the watermark passes their timestamp, then emit in
timestamp order (the EOWC building block).

The buffer is a fixed-capacity slot arena on the card. Kernel AC
(``csrc/arena.cu``) runs both steps:

- ``rw_arena_append``: the chunk's valid rows claim the free slots in
  order (row of rank i into the i-th free slot; both ranks by
  compaction), every lane of 1, 4 or 8 bytes and its null lane scattered
  through one lane table, ``seq = next_seq + rank``; ``next_seq``, the
  overflow and the delete latches stay on the card.
- ``rw_arena_emit``: the closed slots (``valid & ts < cutoff``)
  compacted, sorted by (ts, seq) with stable LSD radix passes (seq
  first, then ts), every lane gathered into the emission's prefix, the
  slots freed; the closed count is the one host read per watermark
  (reference :363). The open rows' places in the emission are invalid
  and their content is free.

The latches are read in the barrier's staged scalars. ``lint_info``,
``state_nbytes`` and ``trace_step`` are not ported.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.ops.checkpoint import scatter_rows, stage_select
from risingwave_tpu_torch.ops.hash_table import stage_scalars
from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta, pull_rows

# lanes one rw_arena_append / rw_arena_emit call moves (csrc/arena.cu via
# csrc/tile.cuh RW_TILE_MAX_LANES)
ARENA_LANES = _kernels.TILE_LANES


def _lane_rows(pairs, name: str):
    """Lane-table rows ``(src, dst, esize)`` of (source, destination)
    tensor pairs of one dtype each."""
    rows = []
    for src, dst in pairs:
        if src.dtype != dst.dtype or dst.element_size() not in (1, 4, 8):
            raise TypeError(f"{name}: lanes of 1, 4 or 8 bytes, one dtype per pair "
                            f"({src.dtype} -> {dst.dtype})")
        rows.append((src.data_ptr(), dst.data_ptr(), dst.element_size()))
    return rows


def arena_scratch(cap: int, n: int, device) -> Dict[str, torch.Tensor]:
    """Kernel AC's scratch for an arena of ``cap`` slots fed ``n``-row
    chunks: the compactions' slot lists, payload bytes, tile counts and
    status words, and the sort's two (key, slot) buffers and counts."""
    big = max(cap, n)
    tiles = max(1, -(-cap // _kernels.RBK_TILE))
    return {
        "sel": torch.empty(big, dtype=torch.int32, device=device),
        "rows": torch.empty(max(n, 1), dtype=torch.int32, device=device),
        "payload": torch.empty(big, dtype=torch.uint8, device=device),
        "part": _kernels.compact_scratch(big, device),
        "status": torch.zeros(4, dtype=torch.int64, device=device),
        "keys": torch.empty(2 * cap, dtype=torch.int64, device=device),
        "idx": torch.empty(2 * cap, dtype=torch.int32, device=device),
        "hist": torch.empty(256 * tiles + 256, dtype=torch.int32, device=device),
        "bits": torch.empty(8, dtype=torch.int64, device=device),
    }


# -- kernel AC: append ---------------------------------------------------------------
def arena_append(buf, bnulls, valid, seq, next_seq, chunk: StreamChunk, names, overflow,
                 saw_delete, scratch=None) -> None:
    """``_sort_append`` in place: the chunk's valid rows into the free
    slots, ``next_seq`` advanced; ``overflow`` latches when more rows came
    than slots were free, ``saw_delete`` when a valid row retracts.
    Kernel AC's ``rw_arena_append`` on the card (``scratch`` from
    ``arena_scratch``), plain PyTorch on the CPU."""
    if valid.device.type == "cpu":
        _arena_append_torch(buf, bnulls, valid, seq, next_seq, chunk, names, overflow,
                            saw_delete)
    elif valid.device.type == "cuda":
        _arena_append_cuda(buf, bnulls, valid, seq, next_seq, chunk, names, overflow,
                           saw_delete, scratch)
    else:
        raise ValueError(f"unsupported device {valid.device}")


def _arena_append_torch(buf, bnulls, valid, seq, next_seq, chunk, names, overflow, saw_delete):
    live = chunk.valid
    saw_delete |= (live & (chunk.signs() < 0)).any()
    free_slots = torch.nonzero(~valid).flatten()
    n_free = free_slots.shape[0]
    row_rank = torch.cumsum(live.to(torch.int64), 0) - 1
    n_live = int(live.sum())
    overflow |= torch.tensor(n_live > n_free, device=valid.device)
    ok = live & (row_rank < n_free)
    dest = free_slots[row_rank[ok]]
    for n in names:
        buf[n][dest] = chunk.col(n)[ok].to(buf[n].dtype)
    for n in bnulls:
        bnulls[n][dest] = chunk.null_of(n)[ok]
    valid[dest] = True
    seq[dest] = next_seq + row_rank[ok]
    next_seq += n_live


def _arena_append_cuda(buf, bnulls, valid, seq, next_seq, chunk, names, overflow, saw_delete,
                       scratch):
    cap, n = valid.shape[0], chunk.capacity
    _kernels.check_cuda("arena", valid, seq, n=cap)
    _kernels.check_cuda("arena", chunk.valid, chunk.ops, n=n)
    _kernels.check_cuda("arena", valid, next_seq, overflow, saw_delete)
    if scratch is None:
        raise ValueError("arena_append on the card needs an arena_scratch")
    pairs, keep = [], []  # a cast lane must outlive the launch (_kernels.call)
    for name in names:
        src = chunk.col(name)
        if src.dtype != buf[name].dtype:
            src = src.to(buf[name].dtype)
            keep.append(src)
        _kernels.check_cuda("arena", src, n=n)
        pairs.append((src, buf[name]))
    for name, lane in bnulls.items():
        src = chunk.null_of(name)
        keep.append(src)
        pairs.append((src, lane))
    rows = _lane_rows(pairs, "arena_append")
    _kernels.call(
        "arena", "rw_arena_append", _kernels.int64_rows(rows, ARENA_LANES), len(rows), cap, n,
        chunk.valid.data_ptr(), chunk.ops.data_ptr(), valid.data_ptr(), seq.data_ptr(),
        next_seq.data_ptr(), overflow.data_ptr(), saw_delete.data_ptr(),
        scratch["sel"].data_ptr(), scratch["rows"].data_ptr(), scratch["payload"].data_ptr(),
        scratch["part"].data_ptr(), scratch["status"].data_ptr(),
    )


# -- kernel AC: emit -----------------------------------------------------------------
def arena_emit(buf, bnulls, valid, seq, cutoff: int, names, ts_col: str, scratch=None):
    """``_sort_emit``: ``(out_cols, out_nulls, out_valid, n_closed)``, the
    rows with ts < cutoff in (ts, seq) order as a capacity-wide prefix;
    their slots are freed in place. Kernel AC's ``rw_arena_emit`` on the
    card, plain PyTorch on the CPU."""
    if valid.device.type == "cpu":
        return _arena_emit_torch(buf, bnulls, valid, seq, cutoff, names, ts_col)
    if valid.device.type == "cuda":
        return _arena_emit_cuda(buf, bnulls, valid, seq, cutoff, names, ts_col, scratch)
    raise ValueError(f"unsupported device {valid.device}")


def _arena_emit_torch(buf, bnulls, valid, seq, cutoff, names, ts_col):
    ts = buf[ts_col]
    closed = valid & (ts < cutoff)
    big = torch.full_like(ts, 1 << 62)
    order1 = torch.sort(seq, stable=True).indices
    ts_sorted = torch.where(closed, ts, big)[order1]
    order = order1[torch.sort(ts_sorted, stable=True).indices]
    out_cols = {n: buf[n][order] for n in names}
    out_nulls = {n: bnulls[n][order] for n in bnulls}
    out_valid = closed[order]
    valid &= ~closed
    return out_cols, out_nulls, out_valid, int(closed.sum())


def _arena_emit_cuda(buf, bnulls, valid, seq, cutoff, names, ts_col, scratch):
    cap = valid.shape[0]
    ts = buf[ts_col]
    if ts.dtype != torch.int64:
        raise TypeError("arena_emit: the ts lane must be int64")
    _kernels.check_cuda("arena", valid, seq, ts, n=cap)
    if scratch is None:
        raise ValueError("arena_emit on the card needs an arena_scratch")
    dev = valid.device
    out_cols = {n: torch.empty_like(buf[n]) for n in names}
    out_nulls = {n: torch.empty_like(bnulls[n]) for n in bnulls}
    out_valid = torch.empty(cap, dtype=torch.bool, device=dev)
    pairs = [(buf[n], out_cols[n]) for n in names] + [(bnulls[n], out_nulls[n]) for n in bnulls]
    rows = _lane_rows(pairs, "arena_emit")
    n_closed = ctypes.c_int64(0)
    _kernels.call(
        "arena", "rw_arena_emit", _kernels.int64_rows(rows, ARENA_LANES), len(rows), cap,
        int(cutoff), ts.data_ptr(), valid.data_ptr(), seq.data_ptr(), out_valid.data_ptr(),
        scratch["sel"].data_ptr(), scratch["payload"].data_ptr(), scratch["part"].data_ptr(),
        scratch["status"].data_ptr(), scratch["keys"].data_ptr(), scratch["idx"].data_ptr(),
        scratch["hist"].data_ptr(), scratch["bits"].data_ptr(), ctypes.addressof(n_closed),
    )
    return out_cols, out_nulls, out_valid, int(n_closed.value)


class ArenaBufferedExecutor(Executor, Checkpointable):
    """Shared EOWC arena: a fixed-capacity slot buffer on the card holding
    open rows keyed by arrival seq. Subclasses decide WHEN rows close and
    WHAT to emit (SortExecutor: ordered rows; EowcOverWindowExecutor:
    window-function outputs over complete partitions)."""

    _arena_name = "EOWC arena"

    def __init__(
        self,
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 14,
        nullable: Sequence[str] = (),
        table_id: str = "arena",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.table_id = table_id
        self.names = tuple(schema_dtypes)
        self.capacity = capacity
        self._dtypes = dict(schema_dtypes)
        self.nullable = tuple(n for n in nullable if n in self.names)
        self._alloc(capacity)
        self.next_seq = torch.zeros((), dtype=torch.int64, device=self.device)
        self._overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        self._saw_delete = torch.zeros((), dtype=torch.bool, device=self.device)
        self._stored_seqs = np.zeros(0, np.int64)
        self._scratch_rows = 0

    def _alloc(self, cap: int) -> None:
        dev = self.device
        self.buf = {n: torch.zeros(cap, dtype=d, device=dev) for n, d in self._dtypes.items()}
        self.bnulls = {n: torch.zeros(cap, dtype=torch.bool, device=dev) for n in self.nullable}
        self.valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.seq = torch.zeros(cap, dtype=torch.int64, device=dev)
        self._scratch = None

    def _kernel_scratch(self, n: int = 0):
        """Kernel AC's scratch, made on first use on the card."""
        if self.device.type != "cuda":
            return None
        if self._scratch is None or n > self._scratch_rows:
            self._scratch_rows = max(n, self._scratch_rows)
            self._scratch = arena_scratch(self.capacity, self._scratch_rows, self.device)
        return self._scratch

    def trace_contract(self):
        """Window-close emissions are arena-capacity chunks: one declared
        bucket (reference :162-166)."""
        return {
            "kind": "device",
            "state": (self.buf, self.valid, self.seq),
            "donate": True,
            "emission": "fixed",
            "emission_caps": (self.capacity,),
            "window_buckets": (self.capacity,),
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        arena_append(self.buf, self.bnulls, self.valid, self.seq, self.next_seq, chunk,
                     self.names, self._overflow, self._saw_delete,
                     self._kernel_scratch(chunk.capacity))
        return []  # rows surface only when their time closes

    def on_barrier(self, barrier) -> List[StreamChunk]:
        self._staged_scalars = stage_scalars(self._saw_delete, self._overflow)
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return []

    def _on_barrier_scalars(self, vals) -> None:
        saw_delete, overflow = vals
        if saw_delete:
            raise RuntimeError(f"{self._arena_name} requires append-only input")
        if overflow:
            raise RuntimeError(f"{self._arena_name} overflowed; grow capacity or advance "
                               "watermarks faster")

    # -- integrity ----------------------------------------------------------
    def digest_lanes(self):
        lanes = {f"c_{n}": self.buf[n] for n in self.names}
        for n, a in self.bnulls.items():
            lanes[f"cn_{n}"] = a
        lanes["seq"] = self.seq
        return lanes, self.valid

    def state_digest(self) -> int:
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore -------------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        """Keyed by seq (reference :227): upsert the rows appended since
        the last checkpoint, tombstone the seqs that left. The live slots
        are compacted and their seqs pulled by kernel R."""
        sel_all, _, n_live, _ = stage_select(self.valid, (self.valid,), self.valid)
        cur = (pull_rows({"k0": self.seq}, sel_all)["k0"].astype(np.int64)
               if n_live else np.zeros(0, np.int64))
        prev = self._stored_seqs
        new_mask = ~np.isin(cur, prev)
        gone = np.setdiff1d(prev, cur)
        self._stored_seqs = cur
        n_up, n_del = int(new_mask.sum()), len(gone)
        if n_up + n_del == 0:
            return []
        lanes = {"k0": self.seq}
        lanes.update({f"v_{n}": self.buf[n] for n in self.names})
        lanes.update({f"n_{n}": a for n, a in self.bnulls.items()})
        sel_new = sel_all[torch.from_numpy(np.flatnonzero(new_mask)).to(sel_all.device)]
        rows = pull_rows(lanes, sel_new)
        key_cols = {"k0": np.concatenate([np.asarray(rows["k0"], np.int64), gone])}
        value_cols = {}
        for n in self.names:
            vals = np.asarray(rows[f"v_{n}"])
            value_cols[f"v_{n}"] = np.concatenate([vals, np.zeros(n_del, vals.dtype)])
        for n in self.bnulls:
            value_cols[f"n_{n}"] = np.concatenate(
                [np.asarray(rows[f"n_{n}"]).astype(np.uint8), np.zeros(n_del, np.uint8)])
        tomb = np.zeros(n_up + n_del, bool)
        tomb[n_up:] = True
        return [StateDelta(self.table_id, key_cols, value_cols, tomb, ("k0",))]

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """The rows into slots 0..n-1 through kernel R's scatter; the arena
        grows (doubling) to hold the checkpoint, as the reference's."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        # recovery clears the error latches (reference :276)
        self._overflow.zero_()
        self._saw_delete.zero_()
        cap = self.capacity
        while n > cap:
            cap *= 2
        self.capacity = cap
        self._alloc(cap)
        if n == 0:
            self.next_seq.zero_()
            self._stored_seqs = np.zeros(0, np.int64)
            return
        seqs = np.asarray(key_cols["k0"], np.int64)
        dst = {"seq": self.seq, "valid": self.valid}
        src = {"seq": seqs, "valid": np.ones(n, np.bool_)}
        for nme in self.names:
            dst[f"v_{nme}"] = self.buf[nme]
            src[f"v_{nme}"] = np.asarray(value_cols[f"v_{nme}"])
        for nme in self.bnulls:
            if f"n_{nme}" in value_cols:
                dst[f"n_{nme}"] = self.bnulls[nme]
                src[f"n_{nme}"] = np.asarray(value_cols[f"n_{nme}"]).astype(bool)
        slots = torch.arange(n, dtype=torch.int32, device=self.device)
        scatter_rows(dst, slots, src)
        self.next_seq.fill_(int(seqs.max()) + 1)
        self._stored_seqs = seqs


class SortExecutor(ArenaBufferedExecutor):
    """EOWC sort: buffer until the ``ts_col`` watermark closes rows, then
    emit in (ts, arrival) order. Append-only input."""

    _arena_name = "EOWC sort buffer"

    def __init__(
        self,
        ts_col: str,
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 14,
        nullable: Sequence[str] = (),
        table_id: str = "sort",
        device="cuda",
    ):
        super().__init__(schema_dtypes, capacity, nullable, table_id, device)
        self.ts_col = ts_col

    def on_watermark(self, watermark: Watermark):
        if watermark.column != self.ts_col:
            return watermark, []
        out_cols, out_nulls, out_valid, n_closed = arena_emit(
            self.buf, self.bnulls, self.valid, self.seq, int(watermark.value), self.names,
            self.ts_col, self._kernel_scratch())
        # one count per watermark: an all-invalid capacity-wide chunk would
        # cost O(capacity) in every downstream stage (reference :357)
        if n_closed == 0:
            return watermark, []
        chunk = StreamChunk(
            columns=out_cols, valid=out_valid, nulls=out_nulls,
            ops=torch.zeros(self.capacity, dtype=torch.int32, device=self.device),
        )
        return watermark, [chunk]
