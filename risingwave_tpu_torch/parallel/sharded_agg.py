"""Vnode-sharded HashAgg: the hash exchange and grouped state on a mesh.

Port of ``risingwave_tpu/parallel/sharded_agg.py`` (``make_mesh`` :71,
the step :157, ``apply`` :219, ``_maybe_grow`` :236,
``capacity_overflow_latched``/``grow_for_replay`` :267, ``_build_flush``
and ``on_barrier`` :317-358, ``_delta_to_chunk`` :360,
``checkpoint_delta`` :502, ``restore_state`` :540, ``state_digest``
:592, ``stack_chunks`` :615). Reference roles: HashDataDispatcher
(src/stream/src/executor/dispatch.rs:683, vnode mapping
src/common/src/hash/consistent_hash/vnode.rs:34), the exchange channel
(exchange/permit.rs:35) and N parallel HashAgg actors each owning its
vnode slice of the groups (hash_agg.rs:62).

The mesh: the reference's ``Mesh`` spans devices and its state is
sharded over them. Here ``Mesh`` holds ``n_shards`` and ONE device and
every stacked lane lives there, in the layout a multi-card mesh would
split (shard ``s`` is row ``s``); a mesh over several cards raises
(a later slice, with an NCCL all_to_all).

Per chunk: the stacked ``(n, cap)`` input goes through one exchange
(kernel AI) by the group key (a nullable key's zeroed value and its
null lane), then each shard runs the single-chip step on views of its
rows of the stacked table and state: A, then B with its ``set_live``.
Each group lives on one shard, so the barrier flush is shard-local: per
round C runs on every shard, and the shards' (taken, overflow) statuses
come back in ONE packed read. The flush is a host chunk, or with
``stacked_out`` a stacked device chunk that feeds another sharded
executor (q7's MAX side into the join). Capacity is per shard and
common: when the fullest shard may pass ``GROW_AT`` every shard is
rebuilt at the new capacity (A, I) and stacked again. A checkpoint
stages one logical table (the single-chip agg's lanes, through flat
views); a restore routes every row by ``dest_shard`` and so works at
any shard count.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import integrity, resolve_device
from risingwave_tpu_torch.array.chunk import (
    StreamChunk,
    _numpy_dtype,
    flatten_stacked,
    stack_chunks,
)
from risingwave_tpu_torch.executors.base import Barrier, Executor
from risingwave_tpu_torch.executors.hash_agg import (
    _agg_checkpoint_delta,
    _rehash,
    agg_step_fn,
    build_restored_agg,
    delta_to_chunk,
)
from risingwave_tpu_torch.ops import agg as agg_ops
from risingwave_tpu_torch.ops.agg import AggCall
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
from risingwave_tpu_torch.runtime.bucketing import flush_pad
from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta

GROW_AT = 0.5

__all__ = ["Mesh", "ShardedHashAgg", "make_mesh", "stack_chunks"]


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` shards of stacked state on one device."""

    n_shards: int
    device: torch.device


def make_mesh(n_shards: int, device="cuda", devices=None) -> Mesh:
    """A mesh of ``n_shards`` shards stacked on ``device``. ``devices``,
    if given, names the cards to spread them over: more than one
    distinct card raises, since a mesh across cards (one shard per
    card, an NCCL all_to_all between processes) is a later slice."""
    if n_shards < 1:
        raise ValueError("a mesh needs at least one shard")
    if devices is not None:
        devs = {str(torch.device(d)) for d in devices}
        if len(devs) > 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} devices: sharded state spans one device in this "
                "port; the multi-card mesh (one shard per card, NCCL all_to_all) is a later "
                "slice (ROADMAP S7)"
            )
        device = next(iter(devs))
    return Mesh(n_shards, resolve_device(device))


def _stacked_key_lanes(chunk: StreamChunk, group_keys, nullable):
    """``_build_key_lanes`` of a stacked chunk: a nullable key without a
    null lane gets an all-False one of the chunk's shape."""
    lanes = []
    for name, nb in zip(group_keys, nullable):
        col = chunk.col(name)
        if nb:
            null = chunk.nulls.get(name)
            if null is None:
                null = torch.zeros_like(chunk.valid)
            lanes.append(torch.where(null, torch.zeros_like(col), col))
            lanes.append(null)
        else:
            lanes.append(col)
    return tuple(lanes)


class ShardedHashAgg(Executor, Checkpointable):
    """Mesh-parallel HashAgg with the exchange on the device.

    ``apply`` takes a stacked ``(n_shards, chunk_cap)`` chunk (one source
    split per shard); the barrier flush is a host chunk of every shard's
    deltas, shard 0's first, or with ``stacked_out`` one stacked chunk.
    Materialized MIN/MAX and window state cleaning stay single-chip, as
    in the reference."""

    def __init__(self, mesh: Mesh, group_keys: Sequence[str], calls: Sequence[AggCall],
                 schema_dtypes: Dict[str, torch.dtype], capacity: int = 1 << 16,
                 out_cap: int = 1 << 14, bucket_cap: Optional[int] = None,
                 nullable_keys: Sequence[str] = (),
                 table_id: str = "sharded_agg", stacked_out: bool = False):
        self.table_id = table_id
        self.stacked_out = stacked_out
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.device = mesh.device
        self.group_keys = tuple(group_keys)
        self.calls = tuple(calls)
        if any(c.materialized for c in self.calls):
            raise NotImplementedError("materialized MIN/MAX is single-chip only for now")
        self.nullable = tuple(k in set(nullable_keys) for k in self.group_keys)
        self.capacity = capacity
        self.out_cap = out_cap
        self._dtypes = dict(schema_dtypes)
        self._float_extremes = agg_ops.float_extreme_meta(self.calls, self._dtypes)
        self.bucket_cap = bucket_cap
        key_dtypes = []
        for k, nb in zip(self.group_keys, self.nullable):
            key_dtypes.append(self._dtypes[k])
            if nb:
                key_dtypes.append(torch.bool)
        self._key_dtypes = tuple(key_dtypes)
        self._built_bucket_cap: Optional[int] = None
        self.ex_counts_last = None  # (n, n) routed-row histogram, on the device
        self.flush_rounds_last = 0  # rounds of the last barrier's flush
        self._reset(capacity)

    def _reset(self, cap: int) -> None:
        dev = self.device
        self.capacity = cap
        self.table = stack_for_mesh(HashTable.create(cap, self._key_dtypes, device=dev),
                                    self.mesh)
        self.state = stack_for_mesh(agg_ops.create_state(cap, self.calls, self._dtypes, dev),
                                    self.mesh)
        self.dropped = torch.zeros(self.n_shards, dtype=torch.bool, device=dev)
        self._insert_bound = 0  # per-shard upper bound of claimed slots

    # -- data ---------------------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        """``chunk`` is stacked: every lane ``(n_shards, chunk_cap)``."""
        for k, nb in zip(self.group_keys, self.nullable):
            if not nb and k in chunk.nulls:
                raise ValueError(f"group key {k!r} carries a null lane but was not declared "
                                 "in nullable_keys")
        bc = step_bucket_cap(self, chunk)
        # worst case a shard receives every row of the exchange
        self._maybe_grow(self.n_shards * bc)
        self._insert_bound += self.n_shards * bc
        keys = _stacked_key_lanes(chunk, self.group_keys, self.nullable)
        rchunk, ovf, self.ex_counts_last = exchange_chunk(chunk, keys, self.n_shards, bc)
        self.dropped |= ovf
        no_minput = torch.zeros((), dtype=torch.bool, device=self.device)
        views = []
        for s in range(self.n_shards):
            t = shard_view(self.table, s)
            agg_step_fn(t, shard_view(self.state, s), self.dropped[s], shard_view(rchunk, s),
                        self.calls, self.group_keys, self.nullable, {}, no_minput)
            views.append(t)
        sync_gen(self.table, views)
        return []

    def _maybe_grow(self, incoming: int) -> None:
        """Every shard rebuilt at one new capacity (A, I) when the
        fullest may pass ``GROW_AT``; one packed read of the fullest
        shard's claimed and surviving slots."""
        cap = self.capacity
        if self._insert_bound + incoming <= cap * GROW_AT:
            return
        st = self.state
        keep = (self.table.live | st.emitted_valid | st.dirty | st.sdirty) & (self.table.fp1 != 0)
        claimed, surv = read_scalars(self.table.claimed.max(), keep.sum(1).max())
        new_cap = plan_rehash(cap, incoming, claimed, surv, GROW_AT)
        if new_cap is not None:
            shards = [_rehash(shard_view(self.table, s), shard_view(self.state, s), {},
                              self.calls, new_cap, self._float_extremes)[:2]
                      for s in range(self.n_shards)]
            self.table, self.state = stack_trees(shards)
            self.capacity = new_cap
            claimed = surv
        self._insert_bound = claimed

    # -- capacity escape ----------------------------------------------------
    def capacity_overflow_latched(self) -> bool:
        return bool(self.dropped.any())

    def grow_for_replay(self) -> None:
        """Double the skew-sensitive capacities (the exchange bucket, the
        flush round, the table) and empty the state; a recover restores
        the durable rows before the epoch replays."""
        double_bucket_cap(self)
        self.out_cap *= 2
        self._reset(2 * self.capacity)

    # -- barrier flush ------------------------------------------------------
    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        dropped, mret = read_scalars(self.dropped.any(), self.state.minmax_retracted.any())
        if dropped:
            raise RuntimeError("sharded agg overflowed (bucket or probe); grow capacities")
        if mret:
            raise RuntimeError("row-level retraction hit an append-only MIN/MAX aggregate")
        outs: List[StreamChunk] = []
        # each round drains up to out_cap dirty groups per shard, so
        # capacity/out_cap rounds always suffice; a stuck overflow flag
        # must raise, not hang
        max_rounds = max(2, self.capacity // max(1, self.out_cap)) + 2
        for r in range(max_rounds):
            deltas = []
            for s in range(self.n_shards):
                _, d = agg_ops.flush(shard_view(self.state, s), shard_view(self.table, s).keys,
                                     self.out_cap, self._float_extremes)
                deltas.append(d)
            status = torch.stack([d["status"] for d in deltas]).tolist()  # one read a round
            outs.append(self._deltas_to_chunk(deltas, max(t for t, _ in status)))
            if not any(o for _, o in status):
                self.flush_rounds_last = r + 1
                return outs
        raise RuntimeError(f"sharded agg flush did not drain in {max_rounds} rounds: "
                           "overflow flag appears stuck")

    def _deltas_to_chunk(self, deltas, n_take: int) -> StreamChunk:
        """Every shard's delta of a round, each cut to the round's
        ``flush_pad`` rows: one host-bound chunk (shard 0's rows first),
        or one stacked chunk with ``stacked_out``."""
        pad = flush_pad(min(self.out_cap, self.capacity), n_take)
        chunks = [delta_to_chunk(d, self.group_keys, self.nullable, self.calls, pad)
                  for d in deltas]
        stacked = stack_chunks(chunks)
        return stacked if self.stacked_out else flatten_stacked(stacked)

    # -- integrity ----------------------------------------------------------
    def digest_lanes(self):
        return integrity.agg_lanes(flat_view(self.table), flat_view(self.state),
                                   self._float_extremes)

    def state_digest(self) -> int:
        """The shard-flattened agg fold: equal to the single-chip agg's
        for the same groups (slot order and shard placement cancel)."""
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore -------------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        """All shards' changed groups as ONE table (keys are unique across
        shards), with the single-chip agg's lanes: either executor
        restores the other's checkpoint."""
        flat = SimpleNamespace(table=flat_view(self.table), state=flat_view(self.state),
                               minput={}, _float_extremes=self._float_extremes,
                               table_id=self.table_id)
        return _agg_checkpoint_delta(flat)

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """Route the recovered groups to their shards (``dest_shard`` of
        the key lanes) and rebuild every shard at one capacity (A, R)."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        dtypes = [_numpy_dtype(d) for d in self._key_dtypes]
        dest = route_rows(key_cols, dtypes, self.n_shards, self.device) if n else None
        cap = restore_cap(dest, self.n_shards, self.capacity)
        shards = []
        for s in range(self.n_shards):
            sel = np.flatnonzero(dest == s) if n else np.zeros(0, np.int64)
            kc = split_rows(key_cols, sel) if len(sel) else {}
            vc = split_rows(value_cols, sel) if len(sel) else {}
            t, st, _ = build_restored_agg(cap, self.calls, self._dtypes, self._key_dtypes, kc,
                                          vc, device=self.device)
            shards.append((t, st))
        self._reset(cap)
        self.table, self.state = stack_trees(shards)
        self._insert_bound = int(np.bincount(dest, minlength=self.n_shards).max()) if n else 0

