"""Mesh-sharded materialized view: pk-partitioned device MV state.

Port of ``risingwave_tpu/parallel/sharded_mv.py`` (``ShardedMaterialize``
:56, its step :116, ``_host_rows`` :276, ``get_rows`` :293,
``state_digest`` :345, ``checkpoint_delta`` :360, ``restore_state``
:406). Reference roles: N parallel MaterializeExecutor actors each
owning the vnode slice of the MV's pk space
(src/stream/src/executor/mview/materialize.rs:44 behind the hash
exchange, dispatch.rs:683) and the batch table serving point and
snapshot reads over those slices (src/storage/src/table/batch_table/).

The MV's pk table and value lanes are stacked ``(n_shards, cap)``; a
chunk goes through one exchange by pk (kernel AI), then each shard
upserts its rows with the single-chip step (A, D) on views of the
stacks. Every pk lives on one shard, so a snapshot reads the flat view
``(n * cap)`` and a checkpoint stages one logical table with the
device MV's lanes (``k{j}``, ``v{j}``, ``n_{c}``); a restore routes the
rows by ``dest_shard``, at any shard count. Growth, as the sharded agg:
every shard rebuilt at one capacity (A, I) when the fullest may pass
``GROW_AT`` (the reference keeps its capacity and latches). The
exchange's bucket is the input chunk's width, not the reference's
``2 * cap / n``: an upstream shard's emission keyed like the pk routes
whole to one shard, and q5's agg flush at 20M events overflows the
reference's bucket (ROADMAP Queue 3).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk, _numpy_dtype, to_device
from risingwave_tpu_torch.executors.base import Barrier, Executor
from risingwave_tpu_torch.executors.materialize import (
    DeviceMaterializeExecutor,
    MvDeviceReadMixin,
    MvDeviceState,
    _mv_rebuild,
    mv_step_fn,
)
from risingwave_tpu_torch.ops.checkpoint import insert_keys, scatter_rows
from risingwave_tpu_torch.ops.hash_table import HashTable, lookup, plan_rehash, read_scalars
from risingwave_tpu_torch.parallel.exchange import dest_shard, exchange_chunk
from risingwave_tpu_torch.parallel.sharded_join import (
    double_bucket_cap,
    flat_view,
    restore_cap,
    route_rows,
    shard_view,
    split_rows,
    stack_for_mesh,
    stack_trees,
    sync_gen,
    track_bucket_cap,
)
from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta, pull_rows

GROW_AT = 0.5


class ShardedMaterialize(MvDeviceReadMixin, Executor, Checkpointable):
    """A vnode-partitioned device MV over a mesh.

    ``apply`` takes stacked ``(n_shards, cap)`` chunks (a sharded join's
    emission, a sharded agg's stacked flush) and passes them on
    unchanged. pk lanes are fixed-width and not NULL; NULLs of value
    columns ride per-column null lanes."""

    def __init__(self, mesh, pk: Sequence[str], columns: Sequence[str],
                 schema_dtypes: Dict[str, torch.dtype], table_id: str = "mview",
                 capacity: int = 1 << 16, nullable: Sequence[str] = (),
                 bucket_cap: Optional[int] = None):
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.device = mesh.device
        self.pk = tuple(pk)
        self.columns = tuple(columns)
        self.table_id = table_id
        self.bucket_cap = bucket_cap
        self.dtypes = {n: schema_dtypes[n] for n in self.pk + self.columns}
        self._nullable = tuple(c for c in nullable if c in self.columns)
        self._built_bucket_cap: Optional[int] = None
        self.ex_counts_last = None  # (n, n) routed-row histogram, on the device
        self._reset(capacity)

    def _reset(self, cap: int) -> None:
        dev = self.device
        self.capacity = cap
        self.table = stack_for_mesh(
            HashTable.create(cap, tuple(self.dtypes[k] for k in self.pk), device=dev), self.mesh)
        self.state = stack_for_mesh(
            MvDeviceState.create(cap, self.dtypes, self.columns, self._nullable, dev), self.mesh)
        self._bound = 0

    # -- data ---------------------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        # an MV reads a sharded executor's stacked output, which is already
        # partitioned: with the pk its key (q5's agg flush, q8's join), a
        # source shard's whole chunk routes to one destination, past the
        # default bucket of 2 * cap / n. Its bucket is the chunk's width.
        bc = self.bucket_cap or chunk.valid.shape[-1]
        track_bucket_cap(self, bc)
        self._maybe_grow(self.n_shards * bc)
        self._bound += self.n_shards * bc
        rchunk, ovf, self.ex_counts_last = exchange_chunk(
            chunk, tuple(chunk.col(k) for k in self.pk), self.n_shards, bc)
        self.state.dropped |= ovf
        views = []
        for s in range(self.n_shards):
            t = shard_view(self.table, s)
            mv_step_fn(t, shard_view(self.state, s), shard_view(rchunk, s), self.pk, self.columns)
            views.append(t)
        sync_gen(self.table, views)
        return [chunk]

    def _maybe_grow(self, incoming: int) -> None:
        cap = self.capacity
        if self._bound + incoming <= cap * GROW_AT:
            return
        st = self.state
        keep = self.table.live | st.sdirty | st.stored
        claimed, surv = read_scalars(self.table.claimed.max(), keep.sum(1).max())
        new_cap = plan_rehash(cap, incoming, claimed, surv, GROW_AT)
        if new_cap is not None:
            self.table, self.state = stack_trees([
                _mv_rebuild(shard_view(self.table, s), shard_view(self.state, s), new_cap)
                for s in range(self.n_shards)])
            self.capacity = new_cap
            claimed = surv
        self._bound = claimed

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        (dropped,) = read_scalars(self.state.dropped.any())
        if dropped:
            raise RuntimeError("sharded MV overflowed (probe chain or exchange bucket); "
                               "grow capacity/bucket_cap")
        return []

    # -- capacity escape ----------------------------------------------------
    def capacity_overflow_latched(self) -> bool:
        return bool(self.state.dropped.any())

    def grow_for_replay(self) -> None:
        double_bucket_cap(self)
        self._reset(2 * self.capacity)

    def shard_rows(self) -> List[int]:
        """Live MV rows per shard (one read)."""
        return self.table.live.sum(1).tolist()

    # -- reads --------------------------------------------------------------
    def _flat(self) -> SimpleNamespace:
        """The flat view ``(n * cap)`` as the device MV's methods read it
        (pks are unique across shards)."""
        return SimpleNamespace(table=flat_view(self.table), state=flat_view(self.state),
                               pk=self.pk, columns=self.columns, table_id=self.table_id)

    def _host_rows(self):
        """Every live row (snapshot()/to_numpy() come from
        MvDeviceReadMixin)."""
        return DeviceMaterializeExecutor._host_rows(self._flat())

    def get_rows(self, key_tuples):
        """Point reads by pk: route each key to its shard, probe that
        shard read-only (M's ``rw_lookup``) and pull only the hits."""
        if not key_tuples:
            return []
        lanes = tuple(
            to_device(np.asarray([k[j] for k in key_tuples], _numpy_dtype(self.dtypes[p])),
                      self.device)
            for j, p in enumerate(self.pk)
        )
        dest = dest_shard(lanes, self.n_shards).cpu().numpy()
        out: List[Optional[tuple]] = [None] * len(key_tuples)
        cap = self.capacity
        state = flat_view(self.state)
        values = {f"v{j}": state.values[c] for j, c in enumerate(self.columns)}
        values.update({f"n_{c}": lane for c, lane in state.vnulls.items()})
        for s in sorted(set(dest.tolist())):
            m = np.flatnonzero(dest == s)
            idx = torch.from_numpy(m).to(self.device)
            slots, found = lookup(shard_view(self.table, s), tuple(a[idx] for a in lanes),
                                  torch.ones(len(m), dtype=torch.bool, device=self.device))
            hit = (found & (slots >= 0)).cpu().numpy()
            if not hit.any():
                continue
            gsel = (s * cap + slots.to(torch.int64)).to(torch.int32)[torch.from_numpy(hit).to(
                self.device)]
            pulled = pull_rows(values, gsel)
            for r, i in enumerate(m[hit]):
                out[i] = tuple(
                    None if (f"n_{c}" in pulled and pulled[f"n_{c}"][r])
                    else pulled[f"v{j}"][r].item()
                    for j, c in enumerate(self.columns)
                )
        return out

    # -- integrity ----------------------------------------------------------
    def digest_lanes(self):
        return integrity.mv_lanes(flat_view(self.table), flat_view(self.state))

    def state_digest(self) -> int:
        """The shard-flattened MV fold: equal to the single-chip device
        MV's for the same rows."""
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore -------------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        """The device MV's staging (kernel R) over the flat view."""
        return DeviceMaterializeExecutor.checkpoint_delta(self._flat())

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """Route the recovered rows to their shards and rebuild each at
        one capacity: A inserts the pks, R lands live, the values, the
        null lanes and ``stored``."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        dtypes = [_numpy_dtype(self.dtypes[k]) for k in self.pk]
        dest = route_rows(key_cols, dtypes, self.n_shards, self.device) if n else None
        cap = restore_cap(dest, self.n_shards, self.capacity)
        self._reset(cap)
        views = []
        for s in range(self.n_shards):
            sel = np.flatnonzero(dest == s) if n else np.zeros(0, np.int64)
            if not len(sel):
                continue
            t, st = shard_view(self.table, s), shard_view(self.state, s)
            t, slots = insert_keys(t, split_rows(key_cols, sel), len(sel))
            views.append(t)
            dst, src = {}, {}
            for j, c in enumerate(self.columns):
                dst[f"v{j}"], src[f"v{j}"] = st.values[c], np.asarray(value_cols[f"v{j}"])[sel]
            for c, lane in st.vnulls.items():
                if f"n_{c}" in value_cols:
                    dst[f"n_{c}"] = lane
                    src[f"n_{c}"] = np.asarray(value_cols[f"n_{c}"])[sel].astype(bool)
            ones = np.ones(len(sel), np.bool_)
            dst["live"], src["live"] = t.live, ones
            dst["stored"], src["stored"] = st.stored, ones
            scatter_rows(dst, slots, src)
        if views:
            sync_gen(self.table, views)
        self._bound = int(np.bincount(dest, minlength=self.n_shards).max()) if n else 0
