"""Mesh-parallel HashJoin and append-only Dedup, and the stacked-state
helpers every sharded executor shares.

Port of ``risingwave_tpu/parallel/sharded_join.py`` (``stack_for_mesh``
:51, ``flatten_stacked`` :63, ``track_bucket_cap`` :69,
``double_bucket_cap`` :77, ``ShardedDedup`` :91, ``ShardedHashJoin``
:351, their checkpoints :701 and restores :750). Reference roles: N
parallel HashJoin actors each owning the vnode slice of both join
sides (src/stream/src/executor/hash_join.rs:129 behind
HashDataDispatcher, dispatch.rs:683), N parallel AppendOnlyDedup actors
(dedup/append_only_dedup.rs).

State is STACKED, as in the reference: every per-slot lane gains a
leading ``(n_shards,)`` axis, every latch becomes an ``(n_shards,)``
lane. The reference runs each arrival as one ``shard_map`` program; the
port keeps the mesh on one device, so an arrival is one exchange
(kernel AI) and then, shard by shard, the single-chip step on views
``lane[s]`` of the stacked lanes (a view of a contiguous stack is
contiguous, and the single-chip kernels update it in place): A and J
for the dedup, M, P, A and L for the join. Launches per chunk grow with
the shard count. Growth rebuilds every shard into one common capacity
chosen from the fullest shard (A and I, or A, I and L's regrow for a
join side) and stacks them again; each growth check reads the shards'
occupancy in one packed read. Checkpoints stage one logical table
through flat views ``(n * cap, ...)`` of the stacks (kernel R), keyed
as the single-chip executors' so either restores the other's; a
restore routes every row by ``dest_shard`` (AH on the card) and so
works at any shard count.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import (
    StreamChunk,
    _numpy_dtype,
    flatten_stacked,
    stack_chunks,
)
from risingwave_tpu_torch.executors.base import Barrier, Executor
from risingwave_tpu_torch.executors.dedup import KeyTableGrowth, dedup_step_fn
from risingwave_tpu_torch.executors.dedup import _rebuild as _dedup_rebuild
from risingwave_tpu_torch.executors.hash_join import (
    JOIN_TYPES,
    _side_delta,
    _side_restore,
    join_step_fn,
)
from risingwave_tpu_torch.ops.checkpoint import insert_keys, scatter_rows
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    first_scratch,
    plan_rehash,
    read_scalars,
)
from risingwave_tpu_torch.ops.join import JoinSide, regrow
from risingwave_tpu_torch.ops.join import survivors as side_survivors
from risingwave_tpu_torch.parallel.exchange import default_bucket_cap, dest_shard, exchange_chunk
from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta, grow_pow2

GROW_AT = 0.5

__all__ = [
    "ShardedDedup",
    "ShardedHashJoin",
    "double_bucket_cap",
    "flat_view",
    "flatten_stacked",
    "shard_view",
    "stack_for_mesh",
    "stack_trees",
    "track_bucket_cap",
]


# -- stacked state --------------------------------------------------------------
def _tree_map(fn, obj):
    """``fn`` over every tensor of a state tree (tensors, dicts, tuples
    and dataclasses of them); other leaves are kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_tree_map(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _tree_map(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init
        })
    return obj


def stack_trees(trees: Sequence):
    """Trees of one structure -> one tree of stacked ``(n, ...)`` tensors
    (an int leaf, a table's generation, takes the largest)."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.stack(list(trees))
    if isinstance(t0, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple):
        return tuple(stack_trees([t[i] for t in trees]) for i in range(len(t0)))
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: stack_trees([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0) if f.init
        })
    if isinstance(t0, int) and not isinstance(t0, bool):
        return max(trees)
    return t0


def stack_for_mesh(tree, mesh):
    """A single-chip state tree replicated into stacked ``(n_shards,
    ...)`` tensors, one independent copy per shard (``sharded_join.py:51``)."""
    return stack_trees([tree] * mesh.n_shards)


def shard_view(tree, s: int):
    """Shard ``s`` of a stacked tree as a single-chip tree of views: the
    single-chip functions update it in place, in the stack."""
    return _tree_map(lambda a: a[s], tree)


def flat_view(tree):
    """A stacked tree's per-slot lanes as one ``(n * cap, ...)`` table of
    views (latches, of shape ``(n,)``, stay as they are): the shards'
    key spaces are disjoint, so one logical table."""
    return _tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])) if a.dim() >= 2 else a,
                     tree)


def sync_gen(table: HashTable, views: Sequence[HashTable]) -> None:
    """Carry the per-shard views' insert generations back to the stacked
    table (the largest: a generation must exceed every stamp)."""
    table.gen = max(v.gen for v in views)


def track_bucket_cap(ex, bucket_cap: int) -> None:
    """Record the largest exchange bucket a step used: the growth escape
    never rebuilds smaller than what overflowed (``sharded_join.py:69``)."""
    ex._built_bucket_cap = max(getattr(ex, "_built_bucket_cap", None) or 0, bucket_cap)


def double_bucket_cap(ex) -> None:
    """Pin ``bucket_cap`` to twice the largest bucket in effect
    (``sharded_join.py:77``)."""
    cur = ex.bucket_cap if ex.bucket_cap is not None else getattr(ex, "_built_bucket_cap", None)
    if cur is not None:
        ex.bucket_cap = 2 * cur


def step_bucket_cap(ex, chunk: StreamChunk) -> int:
    """The exchange bucket of a stacked chunk: ``bucket_cap`` if set,
    else the reference's default from the chunk's capacity."""
    bc = ex.bucket_cap or default_bucket_cap(chunk.valid.shape[-1], ex.n_shards)
    track_bucket_cap(ex, bc)
    return bc


def route_rows(key_cols: Dict[str, np.ndarray], dtypes, n_shards: int, device) -> np.ndarray:
    """Each recovered row's shard (``dest_shard`` of its key lanes
    ``k0``, ``k1``, ... on ``device``: AH on the card), as host int32."""
    lanes = tuple(
        torch.from_numpy(np.ascontiguousarray(np.asarray(key_cols[f"k{i}"], dtype=d))).to(device)
        for i, d in enumerate(dtypes)
    )
    return dest_shard(lanes, n_shards).cpu().numpy()


def split_rows(cols: Dict[str, np.ndarray], sel: np.ndarray) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v)[sel] for k, v in cols.items()}


def restore_cap(dest: Optional[np.ndarray], n_shards: int, cap: int) -> int:
    """One capacity for every shard of a restore: the fullest shard's
    rows under ``GROW_AT``, never below ``cap``."""
    if dest is None or not len(dest):
        return cap
    return grow_pow2(int(np.bincount(dest, minlength=n_shards).max()), cap, GROW_AT)


# -- ShardedDedup ---------------------------------------------------------------
class ShardedDedup(Executor, Checkpointable):
    """Mesh-parallel DISTINCT: exchange by the dedup key, a seen-set per
    shard (kernels AI, then A and J per shard).

    ``apply`` takes a stacked ``(n_shards, cap)`` chunk and returns ONE
    stacked chunk ``(n_shards, n_shards * bucket_cap)`` of first-seen
    rows, still sharded by the dedup key's vnode."""

    def __init__(self, mesh, keys: Sequence[str], schema_dtypes: Dict[str, torch.dtype],
                 capacity: int = 1 << 16, bucket_cap: Optional[int] = None,
                 table_id: str = "sharded_dedup"):
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.device = mesh.device
        self.keys = tuple(keys)
        self.bucket_cap = bucket_cap
        self.table_id = table_id
        self._key_dtypes = tuple(schema_dtypes[k] for k in self.keys)
        self._built_bucket_cap: Optional[int] = None
        self.ex_counts_last = None  # (n, n) routed-row histogram, on the device
        self._reset(capacity)

    def _reset(self, cap: int) -> None:
        dev, n = self.device, self.n_shards
        self.table = stack_for_mesh(HashTable.create(cap, self._key_dtypes, device=dev), self.mesh)
        self.sdirty = torch.zeros((n, cap), dtype=torch.bool, device=dev)
        self.stored = torch.zeros((n, cap), dtype=torch.bool, device=dev)
        self.scratch = stack_for_mesh(first_scratch(cap, dev), self.mesh)
        self.flags = torch.zeros((n, 2), dtype=torch.bool, device=dev)  # saw_delete, dropped
        self._bound = 0

    @property
    def capacity(self) -> int:
        return self.table.fp1.shape[-1]

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        for k in self.keys:
            if k in chunk.nulls:
                raise ValueError(f"dedup key {k!r} carries a null lane (unsupported)")
        bc = step_bucket_cap(self, chunk)
        self._maybe_grow(self.n_shards * bc)
        self._bound += self.n_shards * bc
        rchunk, ovf, self.ex_counts_last = exchange_chunk(
            chunk, tuple(chunk.col(k) for k in self.keys), self.n_shards, bc)
        self.flags[:, 1] |= ovf
        views, valid = [], []
        for s in range(self.n_shards):
            t = shard_view(self.table, s)
            _, _, out = dedup_step_fn(t, self.sdirty[s], shard_view(rchunk, s), self.keys,
                                      self.scratch[s], (self.flags[s, 0], self.flags[s, 1]))
            views.append(t)
            valid.append(out.valid)
        sync_gen(self.table, views)
        return [StreamChunk(rchunk.columns, torch.stack(valid), rchunk.nulls, rchunk.ops)]

    def _maybe_grow(self, incoming: int) -> None:
        cap = self.capacity
        if self._bound + incoming <= cap * GROW_AT:
            return
        claimed, surv = read_scalars(self.table.claimed.max(),
                                     (self.table.live | self.sdirty).sum(1).max())
        new_cap = plan_rehash(cap, incoming, claimed, surv, GROW_AT)
        if new_cap is not None:
            shards = [_dedup_rebuild(shard_view(self.table, s), self.sdirty[s], self.stored[s],
                                     new_cap) for s in range(self.n_shards)]
            self.table, self.sdirty, self.stored = stack_trees(shards)
            self.scratch = stack_for_mesh(first_scratch(new_cap, self.device), self.mesh)
            claimed = surv
        self._bound = claimed

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        saw_delete, dropped = read_scalars(*self.flags.any(0))
        if saw_delete:
            raise RuntimeError("append-only sharded dedup received a DELETE")
        if dropped:
            raise RuntimeError("sharded dedup overflowed (probe chain or exchange bucket); "
                               "grow capacity/bucket_cap")
        return []

    # -- capacity escape ----------------------------------------------------
    def capacity_overflow_latched(self) -> bool:
        return bool(self.flags[:, 1].any())

    def grow_for_replay(self) -> None:
        """Double the seen-set and the exchange bucket, empty; a recover
        restores the durable keys before the epoch replays."""
        double_bucket_cap(self)
        self._reset(2 * self.capacity)

    # -- integrity ----------------------------------------------------------
    def digest_lanes(self):
        return integrity.dedup_lanes(flat_view(self.table))

    def state_digest(self) -> int:
        """The shard-flattened seen-set's fold: equal to the single-chip
        dedup's for the same keys (slot order does not enter)."""
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))


    # -- checkpoint/restore (one logical table, the single-chip lanes) ------
    def checkpoint_delta(self) -> List[StateDelta]:
        """The single-chip dedup's staging over the flat view."""
        flat = SimpleNamespace(table=flat_view(self.table), sdirty=self.sdirty.view(-1),
                               stored=self.stored.view(-1), _value_lanes=dict,
                               checkpoint_table_ids=self.checkpoint_table_ids)
        return KeyTableGrowth.checkpoint_delta(flat)

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """Route every recovered key to its shard and rebuild each shard
        at one capacity: kernel A inserts, kernel R lands live and stored."""
        n_rows = len(next(iter(key_cols.values()))) if key_cols else 0
        dtypes = [_numpy_dtype(d) for d in self._key_dtypes]
        dest = route_rows(key_cols, dtypes, self.n_shards, self.device) if n_rows else None
        cap = restore_cap(dest, self.n_shards, self.capacity)
        shards = []
        for s in range(self.n_shards):
            t = HashTable.create(cap, self._key_dtypes, device=self.device)
            stored = torch.zeros(cap, dtype=torch.bool, device=self.device)
            sel = np.flatnonzero(dest == s) if n_rows else np.zeros(0, np.int64)
            if len(sel):
                t, slots = insert_keys(t, split_rows(key_cols, sel), len(sel))
                ones = np.ones(len(sel), np.bool_)
                scatter_rows({"live": t.live, "stored": stored}, slots,
                             {"live": ones, "stored": ones})
            shards.append((t, stored))
        self._reset(cap)
        self.table, self.stored = stack_trees(shards)
        self._bound = int(np.bincount(dest, minlength=self.n_shards).max()) if n_rows else 0


# -- ShardedHashJoin --------------------------------------------------------------
class ShardedHashJoin(Executor, Checkpointable):
    """Mesh-parallel streaming equi-join, every join type.

    Both sides are stacked over the mesh; an arrival exchanges the chunk
    by its own side's join key (both sides hash positionally paired keys
    alike, so a key's left and right rows meet on one shard), then runs
    the single-chip ``join_step_fn`` per shard (M, P, A, L). Emissions
    come back stacked ``(n_shards, out_cap)``."""

    def __init__(self, mesh, left_keys: Sequence[str], right_keys: Sequence[str],
                 left_dtypes: Dict[str, torch.dtype], right_dtypes: Dict[str, torch.dtype],
                 capacity: int = 1 << 14, fanout: int = 8, out_cap: int = 1 << 12,
                 bucket_cap: Optional[int] = None, left_nullable: Sequence[str] = (),
                 right_nullable: Sequence[str] = (), join_type: str = "inner",
                 table_id: str = "sharded_join"):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        self.table_id = table_id
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.device = mesh.device
        self.join_type = join_type
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.left_names = tuple(sorted(left_dtypes))
        self.right_names = tuple(sorted(right_dtypes))
        if join_type.endswith(("semi", "anti")):
            self.out_names = self.left_names if join_type.startswith("left") else self.right_names
        else:
            self.out_names = self.left_names + self.right_names
        self.out_cap = out_cap
        self.bucket_cap = bucket_cap
        lk = tuple(left_dtypes[k] for k in self.left_keys)
        rk = tuple(right_dtypes[k] for k in self.right_keys)
        if lk != rk:
            raise ValueError(f"join key dtype mismatch: {lk} vs {rk}")
        self._protos = {
            "l": (capacity, fanout, lk, {n: left_dtypes[n] for n in self.left_names},
                  tuple(left_nullable)),
            "r": (capacity, fanout, rk, {n: right_dtypes[n] for n in self.right_names},
                  tuple(right_nullable)),
        }
        self.left = self._fresh_side("l", capacity, fanout)
        self.right = self._fresh_side("r", capacity, fanout)
        self._em_overflow = torch.zeros(self.n_shards, dtype=torch.bool, device=self.device)
        self._bound = {"l": 0, "r": 0}
        self._built_bucket_cap: Optional[int] = None
        self.ex_counts_last = None  # (n, n) routed-row histogram, on the device

    def _fresh_side(self, s: str, cap: int, fanout: int) -> JoinSide:
        _, _, keys, payload, nullable = self._protos[s]
        one = JoinSide.create(cap, fanout, keys, payload, nullable=nullable, device=self.device)
        return stack_for_mesh(one, self.mesh)

    def side(self, s: str) -> JoinSide:
        return self.left if s == "l" else self.right

    def _set_side(self, s: str, side: JoinSide) -> None:
        if s == "l":
            self.left = side
        else:
            self.right = side

    def _apply(self, s: str, chunk: StreamChunk) -> List[StreamChunk]:
        own_keys = self.left_keys if s == "l" else self.right_keys
        own_names = self.left_names if s == "l" else self.right_names
        bc = step_bucket_cap(self, chunk)
        self._maybe_grow(s, self.n_shards * bc)
        self._bound[s] += self.n_shards * bc
        rchunk, ovf, self.ex_counts_last = exchange_chunk(
            chunk, tuple(chunk.col(k) for k in own_keys), self.n_shards, bc)
        self._em_overflow |= ovf
        own, other = self.side(s), self.side("r" if s == "l" else "l")
        outs, views = [], []
        for i in range(self.n_shards):
            own_i = shard_view(own, i)
            _, _, out = join_step_fn(own_i, shard_view(other, i), shard_view(rchunk, i), own_keys,
                                     own_names, self.out_names, self.out_cap,
                                     self._em_overflow[i], self.join_type, arrival=s)
            outs.append(out)
            views.append(own_i.table)
        sync_gen(own.table, views)
        return [stack_chunks(outs)]

    def apply_left(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._apply("l", chunk)

    def apply_right(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._apply("r", chunk)

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        raise TypeError("ShardedHashJoin is two-input: use apply_left/apply_right")

    def _maybe_grow(self, s: str, incoming: int) -> None:
        """Every shard of side ``s`` regrown to one capacity (A, I, L's
        regrow) when the fullest could pass the load factor."""
        side = self.side(s)
        cap = side.row_valid.shape[1]
        if self._bound[s] + incoming <= cap * GROW_AT:
            return
        surv = torch.stack([side_survivors(shard_view(side, i)) for i in range(self.n_shards)])
        claimed, surv = read_scalars(side.table.claimed.max(), surv.max())
        new_cap = plan_rehash(cap, incoming, claimed, surv, GROW_AT)
        if new_cap is not None:
            fanout = side.row_valid.shape[2]
            self._set_side(s, stack_trees([regrow(shard_view(side, i), new_cap, fanout)
                                           for i in range(self.n_shards)]))
            claimed = surv
        self._bound[s] = claimed

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        l, r = self.left, self.right
        em, lo, li, ro, ri = read_scalars(self._em_overflow.any(), l.overflow.any(),
                                          l.inconsistent.any(), r.overflow.any(),
                                          r.inconsistent.any())
        if em:
            raise RuntimeError("sharded join emission/exchange overflowed; raise out_cap "
                               "or bucket_cap")
        for name, ovf, inc in (("left", lo, li), ("right", ro, ri)):
            if ovf:
                raise RuntimeError(f"{name} sharded join side overflowed (fanout/probe); "
                                   "grow fanout/capacity")
            if inc:
                raise RuntimeError(f"{name} sharded join side saw a DELETE matching no "
                                   "stored row")
        return []

    # -- capacity escape ----------------------------------------------------
    def capacity_overflow_latched(self) -> bool:
        return bool(self._em_overflow.any() | self.left.overflow.any()
                    | self.right.overflow.any())

    def grow_for_replay(self) -> None:
        """Double what overflowed (emission and bucket on the exchange
        latch; capacity and fanout on a side latch) and empty both sides;
        a recover restores the durable rows before the epoch replays."""
        if bool(self._em_overflow.any()):
            self.out_cap *= 2
            double_bucket_cap(self)
        f = 2 if bool(self.left.overflow.any() | self.right.overflow.any()) else 1
        for s in ("l", "r"):
            side = self.side(s)
            self._set_side(s, self._fresh_side(s, side.row_valid.shape[1] * f,
                                               side.row_valid.shape[2] * f))
        self._em_overflow.zero_()
        self._bound = {"l": 0, "r": 0}

    # -- integrity ----------------------------------------------------------
    def side_digests(self):
        return tuple(
            integrity.host_digest(*integrity.host_lanes(*integrity.join_side_lanes(
                flat_view(side))))
            for side in (self.left, self.right)
        )

    def state_digest(self) -> int:
        """The shard-flattened twin of the single-chip join's digest (the
        two sides' folds XOR)."""
        ld, rd = self.side_digests()
        return ld ^ rd


    # -- checkpoint/restore (two logical tables, the single-chip lanes) -----
    def checkpoint_table_ids(self) -> List[str]:
        return [f"{self.table_id}.left", f"{self.table_id}.right"]

    def checkpoint_delta(self) -> List[StateDelta]:
        out = []
        for name in ("left", "right"):
            got = _side_delta(flat_view(getattr(self, name)), f"{self.table_id}.{name}")
            if got is not None:
                out.append(got)
        return out

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """Route one side's recovered keys (with their whole buckets) to
        their shards and rebuild each with the single-chip
        ``_side_restore`` at one capacity."""
        s = "l" if table_id.endswith(".left") else "r"
        side = self.side(s)
        n_rows = len(next(iter(key_cols.values()))) if key_cols else 0
        dtypes = [_numpy_dtype(k.dtype) for k in side.table.keys]
        dest = route_rows(key_cols, dtypes, self.n_shards, self.device) if n_rows else None
        cap = restore_cap(dest, self.n_shards, side.row_valid.shape[1])
        template = shard_view(self._fresh_side(s, cap, side.row_valid.shape[2]), 0)
        shards = []
        for i in range(self.n_shards):
            sel = np.flatnonzero(dest == i) if n_rows else np.zeros(0, np.int64)
            if len(sel):
                shards.append(_side_restore(template, split_rows(key_cols, sel),
                                            split_rows(value_cols, sel)))
            else:
                shards.append(_side_restore(template, {}, {}))
        self._set_side(s, stack_trees(shards))
        self._em_overflow.zero_()
        self._bound[s] = int(np.bincount(dest, minlength=self.n_shards).max()) if n_rows else 0
