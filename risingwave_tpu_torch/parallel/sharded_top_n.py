"""Mesh-parallel retractable GroupTopN.

Port of ``risingwave_tpu/parallel/sharded_top_n.py`` (``ShardedGroupTopN``
:57, its step :111, ``on_barrier`` :172-219, ``state_digest`` :320,
``checkpoint_delta`` :333, ``restore_state`` :355). Reference role: N
parallel GroupTopN actors each owning the groups whose vnode lands on
them (src/stream/src/executor/top_n/group_top_n.rs behind
HashDataDispatcher). Groups are disjoint across shards (the exchange
routes by the group columns), so each shard's per-group top k is
globally exact and the barrier emissions concatenate.

The row store (pk table, one lane per column, ``sdirty``, ``stored``,
``epoch_dirty``, ``emitted``) is stacked ``(n_shards, cap)``. Per chunk:
one exchange by the group columns (kernel AI), then per shard kernel A
and kernel V (``upsert_step``) on views of the stacks. At the barrier
the latch and the per-shard epoch-dirty vector come back in ONE packed
read; kernel X ranks each dirty shard; the single-chip executor's diff
(``RetractableGroupTopNExecutor._diff``: R's select and gather, numpy
against a host mirror kept by slot) runs once over the flat view
``(n * cap)`` of the store, where every shard's slots are distinct.
Checkpoints use the single-chip lanes (``k{i}``, ``r_*``), so either
executor restores the other's; a restore routes rows by the group
columns' vnode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk, _numpy_dtype
from risingwave_tpu_torch.executors.base import Barrier, Executor
from risingwave_tpu_torch.executors.top_n_plain import (
    RetractableGroupTopNExecutor,
    _RowStore,
    _move_store,
    emit_diffs,
    group_topk_mask,
    last_scratch,
    upsert_step,
)
from risingwave_tpu_torch.ops.checkpoint import insert_keys, scatter_rows, stage_select
from risingwave_tpu_torch.ops.hash_table import HashTable, plan_rehash, read_scalars
from risingwave_tpu_torch.parallel.exchange import exchange_chunk
from risingwave_tpu_torch.parallel.sharded_join import (
    double_bucket_cap,
    flat_view,
    restore_cap,
    route_rows,
    shard_view,
    split_rows,
    stack_for_mesh,
    stack_trees,
    step_bucket_cap,
    sync_gen,
)
from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta, pull_rows

GROW_AT = 0.5


class _FlatStore:
    """The flat view of a sharded store, as the single-chip executor's
    diff and mirror bookkeeping read it."""

    _mirror = RetractableGroupTopNExecutor._mirror
    _diff = RetractableGroupTopNExecutor._diff
    _after_move = RetractableGroupTopNExecutor._after_move

    def __init__(self, ex: "ShardedGroupTopN"):
        self.table = flat_view(ex.table)
        self.rows = flat_view(ex.rows)
        self.emitted = ex.emitted.view(-1)
        self.names = ex.names
        self._dtypes = ex._dtypes
        self._em_vals = ex._em_vals


class ShardedGroupTopN(Executor, Checkpointable):
    """GROUP BY g ORDER BY o LIMIT k over a mesh, with retractions."""

    def __init__(self, mesh, group_by: Sequence[str], order_col: str, limit: int,
                 pk: Sequence[str], schema_dtypes: Dict[str, torch.dtype], desc: bool = False,
                 capacity: int = 1 << 12, bucket_cap: Optional[int] = None,
                 table_id: str = "sharded_group_top_n"):
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.device = mesh.device
        self.group_by = tuple(group_by)
        self.order_col = order_col
        self.limit = int(limit)
        self.desc = desc
        self.pk = tuple(pk)
        self.store_keys = self.group_by + tuple(c for c in self.pk if c not in self.group_by)
        self.names = tuple(sorted(schema_dtypes))
        self._dtypes = {n: schema_dtypes[n] for n in self.names}
        self.bucket_cap = bucket_cap
        self.table_id = table_id
        self._built_bucket_cap: Optional[int] = None
        self.ex_counts_last = None  # (n, n) routed-row histogram, on the device
        self.ranked_last = 0  # shards kernel X ranked at the last barrier
        self._reset(capacity)

    def _reset(self, cap: int) -> None:
        dev, n = self.device, self.n_shards
        self.capacity = cap
        self.table = stack_for_mesh(
            HashTable.create(cap, tuple(self._dtypes[c] for c in self.store_keys), device=dev),
            self.mesh)
        self.rows = {c: torch.zeros((n, cap), dtype=self._dtypes[c], device=dev)
                     for c in self.names}
        z = lambda: torch.zeros((n, cap), dtype=torch.bool, device=dev)  # noqa: E731
        self.sdirty, self.stored, self.epoch_dirty, self.emitted = z(), z(), z(), z()
        self.scratch = stack_for_mesh(last_scratch(cap, dev), self.mesh)
        self.dropped = torch.zeros(n, dtype=torch.bool, device=dev)
        self._em_vals: Dict[str, np.ndarray] = {}  # host mirror by flat slot
        self._bound = 0

    def _aux(self) -> Dict[str, torch.Tensor]:
        return {"sdirty": self.sdirty, "stored": self.stored, "epoch_dirty": self.epoch_dirty,
                "emitted": self.emitted}

    # -- data ---------------------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        for c in self.pk + self.group_by + (self.order_col,):
            if c in chunk.nulls:
                raise ValueError(f"TopN key column {c!r} cannot be NULL")
        bc = step_bucket_cap(self, chunk)
        self._maybe_grow(self.n_shards * bc)
        self._bound += self.n_shards * bc
        rchunk, ovf, self.ex_counts_last = exchange_chunk(
            chunk, tuple(chunk.col(g) for g in self.group_by), self.n_shards, bc)
        self.dropped |= ovf
        views = []
        for s in range(self.n_shards):
            t = shard_view(self.table, s)
            upsert_step(t, shard_view(self.rows, s), self.sdirty[s], shard_view(rchunk, s),
                        self.store_keys, self.names, self.scratch[s], self.dropped[s],
                        self.epoch_dirty[s])
            views.append(t)
        sync_gen(self.table, views)
        return []

    def _maybe_grow(self, incoming: int) -> None:
        """Every shard's store moved to one new capacity (A, I) when the
        fullest may pass ``GROW_AT``; the host mirror follows its slots."""
        cap = self.capacity
        if self._bound + incoming <= cap * GROW_AT:
            return
        claimed, surv = read_scalars(self.table.claimed.max(),
                                     (self.table.live | self.sdirty).sum(1).max())
        new_cap = plan_rehash(cap, incoming, claimed, surv, GROW_AT)
        if new_cap is not None:
            old_aux = {k: v.view(-1) for k, v in self._aux().items()}
            moved, slots = [], []
            for s in range(self.n_shards):
                lanes = {f"r_{c}": a[s] for c, a in self.rows.items()}
                lanes.update({k: v[s] for k, v in self._aux().items()})
                t, out, sl = _move_store(shard_view(self.table, s), lanes, new_cap)
                moved.append((t, out))
                slots.append(torch.where(sl >= 0, sl.to(torch.int64) + s * new_cap, -1))
            table, lanes = stack_trees(moved)
            vals = self._em_vals
            self.table, self.capacity = table, new_cap
            self.rows = {c: lanes[f"r_{c}"] for c in self.names}
            for k in old_aux:
                setattr(self, k, lanes[k])
            self.scratch = stack_for_mesh(last_scratch(new_cap, self.device), self.mesh)
            flat = _FlatStore(self)
            flat._em_vals = vals
            flat._after_move(old_aux, torch.cat(slots).to(torch.int32))
            self._em_vals = flat._em_vals
            claimed = surv
        self._bound = claimed

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        # ONE packed read: the latch and the per-shard dirty vector
        packed = read_scalars(*torch.cat([self.dropped.any()[None],
                                          self.epoch_dirty.any(-1)]))
        if packed[0]:
            raise RuntimeError("sharded GroupTopN overflowed (probe or exchange bucket)")
        dirty = [s for s, d in enumerate(packed[1:]) if d]
        self.ranked_last = len(dirty)
        if not dirty:
            return []
        in_topk = torch.zeros_like(self.emitted)
        gdirty = torch.zeros_like(self.emitted)
        for s in dirty:
            it, gd = group_topk_mask(shard_view(self.table, s), shard_view(self.rows, s),
                                     self.epoch_dirty[s], self.limit, self.desc, self.group_by,
                                     self.order_col)
            in_topk[s] = it
            gdirty[s] = gd
        flat = _FlatStore(self)
        dels, ins = flat._diff(in_topk.view(-1), gdirty.view(-1))
        self.emitted = flat.emitted.view(self.n_shards, -1)
        self._em_vals = flat._em_vals
        self.epoch_dirty.zero_()
        return emit_diffs(dels, ins, self.names, self._dtypes, self.device)

    # -- capacity escape ----------------------------------------------------
    def capacity_overflow_latched(self) -> bool:
        return bool(self.dropped.any())

    def grow_for_replay(self) -> None:
        double_bucket_cap(self)
        self._reset(2 * self.capacity)

    # -- integrity ----------------------------------------------------------
    def digest_lanes(self):
        table = flat_view(self.table)
        lanes = {f"k{i}": k for i, k in enumerate(table.keys)}
        for c in self.names:
            lanes[f"r_{c}"] = self.rows[c].view(-1)
        return lanes, table.live

    def state_digest(self) -> int:
        """The shard-flattened row store's fold (the single-chip lanes)."""
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))


    # -- checkpoint/restore (the single-chip lanes) --------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        """The single-chip row store's staging (kernel R) over the flat view."""
        flat = _FlatStore(self)
        flat.sdirty, flat.stored, flat.table_id = (self.sdirty.view(-1), self.stored.view(-1),
                                                   self.table_id)
        return _RowStore.checkpoint_delta(flat)

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """Route the recovered rows by their group columns' vnode, rebuild
        every shard at one capacity (A, R), then the mirror: each group's
        current top k, as emitted (the MV downstream was restored to
        exactly this view)."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        dtypes = [_numpy_dtype(self._dtypes[c]) for c in self.store_keys]
        n_g = len(self.group_by)
        gcols = {f"k{i}": key_cols[f"k{i}"] for i in range(n_g)} if n else {}
        dest = route_rows(gcols, dtypes[:n_g], self.n_shards, self.device) if n else None
        cap = restore_cap(dest, self.n_shards, self.capacity)
        self._reset(cap)
        self._bound = int(np.bincount(dest, minlength=self.n_shards).max()) if n else 0
        if not n:
            return
        views = []
        for s in range(self.n_shards):
            sel = np.flatnonzero(dest == s)
            if not len(sel):
                continue
            t = shard_view(self.table, s)
            t, slots = insert_keys(t, split_rows(key_cols, sel), len(sel))
            views.append(t)
            dst = {f"r_{c}": a[s] for c, a in self.rows.items()}
            src = {name: np.asarray(value_cols[name])[sel] for name in dst}
            ones = np.ones(len(sel), np.bool_)
            dst["live"], src["live"] = t.live, ones
            dst["stored"], src["stored"] = self.stored[s], ones
            scatter_rows(dst, slots, src)
        sync_gen(self.table, views)
        for s in range(self.n_shards):
            if not (dest == s).any():
                continue
            everything = torch.ones(cap, dtype=torch.bool, device=self.device)
            in_topk, _ = group_topk_mask(shard_view(self.table, s), shard_view(self.rows, s),
                                         everything, self.limit, self.desc, self.group_by,
                                         self.order_col)
            self.emitted[s] = in_topk
        flat = _FlatStore(self)
        em = flat.emitted
        sel, _, _, _ = stage_select(em, (em,), em)
        pulled = pull_rows(dict(flat.rows), sel, {"__sel__": sel})
        mirror = flat._mirror()
        for c in self.names:
            mirror[c][pulled["__sel__"]] = pulled[c]
        self._em_vals = flat._em_vals
