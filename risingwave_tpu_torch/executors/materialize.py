"""Materialized views: the host row map and the device-resident MV.

Port of ``risingwave_tpu/executors/materialize.py``: the host
``MaterializeExecutor`` (:29-520, ``_last_per_key`` :29) and the device
MV (``MvDeviceState`` :514, ``mv_step_fn`` :551, ``_mv_rebuild`` :587,
the read mixin :607, ``DeviceMaterializeExecutor`` :642). Reference:
src/stream/src/executor/mview/materialize.rs:44 with
ConflictBehavior::Overwrite (:192-230).

The host MV keeps its rows on the host behind one API with two
backends, as the reference: when every pk and value column is a
NULL-free integer, the C++ row map of ``native.py`` applies each delta
batch and the checkpoint's net effect is pure numpy over the buffered
batches; any other layout (floats, NULLs, conflict resolution) uses a
Python dict. Host code, copied with its imports rewritten; a chunk is
read back with ``to_numpy``, and a conflict-resolved emission is built
on the input chunk's device.

The device MV: a pk-keyed hash table plus slot-indexed value lanes. Per
chunk, kernel A finds or inserts the pk, then kernel D
(``csrc/mv_upsert.cu``) lets the last row per pk win: deletes clear
``live``, inserts write the values. The host reaches the device only at
the barrier (one packed latch + occupancy read) and on snapshot.
Checkpoint and restore (``materialize.py:833-916``) go through kernel
R; restored rows are stored, not sdirty.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk, to_device
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.ops.checkpoint import (
    insert_keys,
    mark_checkpointed,
    scatter_rows,
    stage_select,
)
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    _last_occurrence_torch,
    lookup_or_insert,
    move_slots,
    stage_scalars,
)
from risingwave_tpu_torch.runtime.bucketing import BucketAllocator, BucketPolicy
from risingwave_tpu_torch.types import Op
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    StateDelta,
    grow_pow2,
    pull_rows,
)

GROW_AT = 0.5
# mid-epoch rebuild only when the host insert bound nears the table
HARD_GROW_AT = 0.75
# value (and null) lanes one rw_mv_upsert call writes (csrc/mv_upsert.cu MV_MAX_LANES)
MV_LANES = 24


@dataclass
class MvDeviceState:
    """Value lanes + checkpoint marks, slot-indexed next to the pk table.

    ``scratch`` is kernel D's per-slot int32 lane (all -1 between
    calls), allocated once per table."""

    values: Dict[str, torch.Tensor]
    vnulls: Dict[str, torch.Tensor]  # SQL NULL lanes of nullable columns
    sdirty: torch.Tensor  # touched since the last checkpoint stage
    stored: torch.Tensor  # durable in the state store
    dropped: torch.Tensor  # () bool overflow latch
    scratch: torch.Tensor

    @staticmethod
    def create(capacity: int, dtypes, columns, nullable, device) -> "MvDeviceState":
        dev = resolve_device(device)
        z = lambda d: torch.zeros(capacity, dtype=d, device=dev)
        return MvDeviceState(
            values={c: z(dtypes[c]) for c in columns},
            vnulls={c: z(torch.bool) for c in nullable if c in columns},
            sdirty=z(torch.bool),
            stored=z(torch.bool),
            dropped=torch.zeros((), dtype=torch.bool, device=dev),
            scratch=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        )

    @staticmethod
    def from_reference_arrays(state, device="cuda") -> "MvDeviceState":
        """Build from the reference's MvDeviceState with numpy leaves
        (or a dict of its fields)."""
        dev = resolve_device(device)
        get = state.get if isinstance(state, dict) else lambda k: getattr(state, k)
        put = lambda a: to_device(a, dev)
        sdirty = put(np.asarray(get("sdirty")))
        return MvDeviceState(
            values={c: put(np.asarray(a)) for c, a in get("values").items()},
            vnulls={c: put(np.asarray(a)) for c, a in get("vnulls").items()},
            sdirty=sdirty,
            stored=put(np.asarray(get("stored"))),
            dropped=put(np.asarray(get("dropped"), np.bool_)),
            scratch=torch.full(sdirty.shape, -1, dtype=torch.int32, device=dev),
        )


def mv_step_fn(
    table: HashTable, state: MvDeviceState, chunk: StreamChunk, pk, cols, rows_acc=None
):
    """One chunk applied to the MV in place: find-or-insert the pk, the
    last row per pk wins (Overwrite), deletes flip live off. ``rows_acc``,
    a () int64 tensor, if given has the chunk's valid rows added to it."""
    keys = tuple(chunk.col(k) for k in pk)
    table, slots, _, _ = lookup_or_insert(table, keys, chunk.valid)
    if slots.device.type == "cpu":
        _mv_upsert_torch(table, state, chunk, slots, cols, rows_acc)
    elif slots.device.type == "cuda":
        _mv_upsert_cuda(table, state, chunk, slots, cols, rows_acc)
    else:
        raise ValueError(f"unsupported device {slots.device}")
    return table, state


def _mv_upsert_torch(table, state, chunk, slots, cols, rows_acc=None):
    if rows_acc is not None:
        rows_acc += chunk.valid.sum()
    state.dropped |= (chunk.valid & (slots < 0)).any()
    last = _last_occurrence_torch(slots, chunk.valid)
    is_del = (chunk.ops == 1) | (chunk.ops == 2)  # DELETE | UPDATE_DELETE
    lidx = slots[last].long()
    table.live[lidx] = ~is_del[last]
    ins = last & ~is_del
    uidx = slots[ins].long()
    for c in cols:
        state.values[c][uidx] = chunk.col(c)[ins].to(state.values[c].dtype)
    for c in state.vnulls:
        state.vnulls[c][uidx] = chunk.null_of(c)[ins]
    state.sdirty[lidx] = True


def _mv_upsert_cuda(table, state, chunk, slots, cols, rows_acc=None):
    n = chunk.capacity
    cap = table.capacity
    _kernels.check_cuda("mv_upsert", slots, chunk.valid, chunk.ops, n=n)
    if rows_acc is not None:
        if rows_acc.shape != () or rows_acc.dtype != torch.int64:
            raise TypeError("rows_acc must be a () int64 tensor")
        _kernels.check_cuda("mv_upsert", slots, rows_acc)
    _kernels.check_cuda(
        "mv_upsert", table.live, state.sdirty, state.scratch,
        *state.values.values(), *state.vnulls.values(), n=cap,
    )
    if chunk.ops.dtype != torch.int32:
        raise TypeError("ops must be an int32 lane")
    # keep_alive: a cast lane freed before the launch could be handed to
    # the next cast in this loop and overwritten before the kernel reads it
    values, keep_alive = [], []
    for c in cols:
        src, dst = chunk.col(c), state.values[c]
        if src.dtype != dst.dtype:
            src = src.to(dst.dtype)  # the reference's astype on write
            keep_alive.append(src)
        _kernels.check_cuda("mv_upsert", src, n=n)
        values.append((src.data_ptr(), dst.data_ptr(), dst.element_size()))
    nulls = []
    for c, dst in state.vnulls.items():
        src = chunk.nulls.get(c)
        if src is not None:
            _kernels.check_cuda("mv_upsert", src, n=n)
        nulls.append((0 if src is None else src.data_ptr(), dst.data_ptr()))
    _kernels.call(
        "mv_upsert", "rw_mv_upsert",
        _kernels.int64_rows(values, MV_LANES), len(values), _kernels.int64_rows(nulls, MV_LANES),
        len(nulls),
        n, slots.data_ptr(), chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        state.scratch.data_ptr(), table.live.data_ptr(), state.sdirty.data_ptr(),
        state.dropped.data_ptr(), 0 if rows_acc is None else rows_acc.data_ptr(),
    )


def _mv_rebuild(table: HashTable, state: MvDeviceState, new_cap: int):
    """Re-insert the surviving slots into a fresh table of ``new_cap``
    (kernel A) and move their lanes there (kernel I)."""
    keep = table.live | state.sdirty | state.stored
    dev = table.device
    new_table = HashTable.create(new_cap, tuple(k.dtype for k in table.keys), device=dev)
    new_table, slots, _, _ = lookup_or_insert(new_table, table.keys, keep)
    moves = [(table.live, new_table.live)]

    def put(a):
        out = torch.zeros(new_cap, dtype=a.dtype, device=dev)
        moves.append((a, out))
        return out

    new_state = MvDeviceState(
        values={c: put(a) for c, a in state.values.items()},
        vnulls={c: put(a) for c, a in state.vnulls.items()},
        sdirty=put(state.sdirty),
        stored=put(state.stored),
        dropped=torch.zeros((), dtype=torch.bool, device=dev),
        scratch=torch.full((new_cap,), -1, dtype=torch.int32, device=dev),
    )
    srcs, dsts = zip(*moves)
    move_slots(srcs, dsts, slots, keep)  # kernel I
    return new_table, new_state


class MvDeviceReadMixin:
    """Read surface over a ``_host_rows()`` provider (k{j}/v{j}/n_{c}
    lanes of the live rows)."""

    def snapshot(self):
        """pk tuple -> value tuple (NULL -> None). One bulk transfer."""
        rows = self._host_rows()
        n = len(rows["k0"]) if self.pk else 0
        out = {}
        for i in range(n):
            k = tuple(rows[f"k{j}"][i].item() for j in range(len(self.pk)))
            v = tuple(
                None
                if (f"n_{c}" in rows and rows[f"n_{c}"][i])
                else rows[f"v{j}"][i].item()
                for j, c in enumerate(self.columns)
            )
            out[k] = v
        return out

    def to_numpy(self):
        rows = self._host_rows()
        out = {}
        for j, name in enumerate(self.pk):
            out[name] = rows[f"k{j}"]
        for j, name in enumerate(self.columns):
            out[name] = rows[f"v{j}"]
            if f"n_{name}" in rows:
                out[name + "__null"] = rows[f"n_{name}"]
        return out


class DeviceMaterializeExecutor(MvDeviceReadMixin, Executor, Checkpointable):
    """Device-resident MV: pk-keyed hash table + value lanes.

    pk and value lanes must be fixed-width dtypes; NULLs in value
    columns ride per-column null lanes; NULL pk components are not
    supported (as in the reference's device MV).
    """

    def __init__(
        self,
        pk,
        columns,
        schema_dtypes,
        table_id: str = "mview",
        capacity: int = 1 << 16,
        nullable=(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.pk = tuple(pk)
        self.columns = tuple(columns)
        self.table_id = table_id
        self.dtypes = {n: schema_dtypes[n] for n in self.pk + self.columns}
        self.table = HashTable.create(
            capacity, tuple(self.dtypes[k] for k in self.pk), device=self.device
        )
        self.state = MvDeviceState.create(
            capacity, self.dtypes, self.columns, tuple(nullable), self.device
        )
        self._bound = 0
        self._occ_note = 0  # true claimed at the last barrier
        self._buckets = BucketAllocator(
            BucketPolicy.from_capacity(capacity, grow_at=GROW_AT)
        )

    def load_reference_state(self, np_arrays) -> None:
        """Take over the reference executor's state, given as numpy
        arrays ``{"table": ..., "state": ...}`` (the reference's
        HashTable/MvDeviceState with numpy leaves, or dicts of their
        fields). Every pk keeps its slot."""
        t = np_arrays["table"]
        get = t.get if isinstance(t, dict) else lambda k: getattr(t, k)
        self.table = HashTable.from_reference_arrays(
            get("fp1"), get("fp2"), get("keys"), get("live"), device=self.device
        )
        self.state = MvDeviceState.from_reference_arrays(np_arrays["state"], self.device)
        self._bound = self._occ_note = int(self.table.occupancy())

    # -- data -------------------------------------------------------------
    def apply(self, chunk: StreamChunk):
        self._maybe_grow(chunk.capacity)  # also advances the insert bound
        self.table, self.state = mv_step_fn(
            self.table, self.state, chunk, self.pk, self.columns
        )
        return [chunk]

    def _maybe_grow(self, incoming: int) -> None:
        """Mid-epoch overflow guard from the host insert bound alone."""
        cap = self.table.capacity
        claimed = min(self._bound, cap)
        self._bound = claimed + incoming
        if self._bound <= cap * HARD_GROW_AT:
            return
        new_cap = self._buckets.plan(cap, incoming, claimed, claimed)
        if new_cap is not None and new_cap != cap:
            self.table, self.state = _mv_rebuild(self.table, self.state, new_cap)

    # -- control ----------------------------------------------------------
    def on_barrier(self, barrier) -> list:
        self._staged_scalars = stage_scalars(self.state.dropped, self.table.occupancy())
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return []

    def _on_barrier_scalars(self, vals) -> None:
        dropped, claimed = vals
        epoch_inc = max(self._bound - self._occ_note, 0)
        self._occ_note = int(claimed)
        self._bound = int(claimed)
        cap = self.table.capacity
        self._buckets.note_barrier(cap, int(claimed))
        new_cap = self._buckets.plan(
            cap, 0, int(claimed), int(claimed), margin=max(int(claimed), epoch_inc)
        )
        if new_cap is not None and new_cap != cap:
            self.table, self.state = _mv_rebuild(self.table, self.state, new_cap)
        if dropped:
            raise RuntimeError("device MV hash table overflowed MAX_PROBE; grow capacity")

    # -- integrity --------------------------------------------------------
    def digest_lanes(self):
        return integrity.mv_lanes(self.table, self.state)

    def state_digest(self) -> int:
        """Host twin of the fused digest lane (``integrity.mv_lanes``)."""
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore -----------------------------------------------
    def checkpoint_delta(self):
        """The pk rows changed since the last checkpoint, through kernel
        R (select, one gather, one copy, then the eager mark flip)."""
        st = self.state
        sel, tomb, n, n_sdirty = stage_select(st.sdirty, (self.table.live,), st.stored)
        if not n_sdirty:
            return []
        if not n:
            st.sdirty.zero_()
            return []
        lanes = {f"k{j}": k for j, k in enumerate(self.table.keys)}
        lanes.update({f"v{j}": st.values[c] for j, c in enumerate(self.columns)})
        lanes.update({f"n_{c}": lane for c, lane in st.vnulls.items()})
        rows = pull_rows(lanes, sel, {"tombstone": tomb})
        key_cols = {f"k{j}": rows[f"k{j}"] for j in range(len(self.pk))}
        value_cols = {f"v{j}": rows[f"v{j}"] for j in range(len(self.columns))}
        for c in st.vnulls:
            value_cols[f"n_{c}"] = rows[f"n_{c}"].astype(np.uint8)
        mark_checkpointed(st.stored, st.sdirty, sel, tomb)
        return [StateDelta(self.table_id, key_cols, value_cols, rows["tombstone"],
                           tuple(f"k{j}" for j in range(len(self.pk))))]

    def restore_state(self, table_id, key_cols, value_cols):
        """A fresh table sized as a barrier sizes a growth: room under
        ``GROW_AT`` for the n rows and as many again (``on_barrier``'s
        margin), and never below the allocator's lattice. The
        reference restores at ``grow_pow2(n, 2^10)``, which the next
        epoch can load past kernel A's probe bound before the
        mid-epoch guard fires. Kernel A inserts the pks, kernel R lands
        live, the values, the null lanes and ``stored`` in one launch
        (restored rows are durable, not dirty)."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        cap = grow_pow2(2 * n, self._buckets.policy.min_cap, GROW_AT)
        dev = self.device
        self.table = HashTable.create(cap, tuple(self.dtypes[k] for k in self.pk), device=dev)
        self.state = MvDeviceState.create(cap, self.dtypes, self.columns,
                                          tuple(self.state.vnulls), dev)
        self._bound = self._occ_note = int(n)
        if n == 0:
            return
        self.table, slots = insert_keys(self.table, key_cols, n)
        dst, src = {}, {}
        for j, c in enumerate(self.columns):
            dst[f"v{j}"], src[f"v{j}"] = self.state.values[c], value_cols[f"v{j}"]
        for c, lane in self.state.vnulls.items():
            if f"n_{c}" in value_cols:
                dst[f"n_{c}"] = lane
                src[f"n_{c}"] = np.asarray(value_cols[f"n_{c}"]).astype(bool)
        dst["live"], src["live"] = self.table.live, np.ones(n, np.bool_)
        dst["stored"], src["stored"] = self.state.stored, np.ones(n, np.bool_)
        scatter_rows(dst, slots, src)

    # -- reads ------------------------------------------------------------
    def _host_rows(self):
        sel = torch.nonzero(self.table.live).flatten()
        lanes = {f"k{j}": k for j, k in enumerate(self.table.keys)}
        lanes.update({f"v{j}": self.state.values[c] for j, c in enumerate(self.columns)})
        lanes.update({f"n_{c}": lane for c, lane in self.state.vnulls.items()})
        return {name: lane[sel].cpu().numpy() for name, lane in lanes.items()}


# ---------------------------------------------------------------------------
# The host MV
# ---------------------------------------------------------------------------
def _last_per_key(keys: np.ndarray) -> np.ndarray:
    """Indices of the last occurrence of each distinct key row (a stable
    sort on the key columns, run ends kept)."""
    if keys.shape[1] == 0:
        # pk = (): a single-row table; the last op wins outright
        return np.asarray([len(keys) - 1]) if len(keys) else np.zeros(0, np.int64)
    order = np.lexsort(tuple(keys[:, j] for j in reversed(range(keys.shape[1]))))
    ks = keys[order]
    is_last = np.ones(len(order), bool)
    if len(order) > 1:
        is_last[:-1] = ~(ks[1:] == ks[:-1]).all(axis=1)
    return order[is_last]


class MaterializeExecutor(Executor, Checkpointable):
    """The MV as a host row map (pk tuple -> value tuple).

    ``conflict_resolve`` (ConflictBehavior::Overwrite with the emission
    downstream needs, materialize.rs:192-230): an insert on an existing
    pk emits UpdateDelete(stored) + UpdateInsert(new), a delete emits
    the stored row, a delete of an absent pk is dropped."""

    _force_python = False  # subclasses needing row hooks pin the dict

    def __init__(self, pk: Sequence[str], columns: Sequence[str], table_id: str = "mview",
                 conflict_resolve: bool = False):
        self.pk = tuple(pk)
        self.columns = tuple(columns)
        self.rows: Dict[Tuple, Tuple] = {}
        self.table_id = table_id
        self.conflict_resolve = bool(conflict_resolve)
        self._changed: set = set()  # Python backend: pks since the checkpoint
        self._dtypes: Dict[str, np.dtype] = {}
        self._native = None  # NativeMvMap once eligible
        self._backend: Optional[str] = None
        self._pending: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # set when a checkpoint store drains _pending every checkpoint
        self.checkpoint_enabled = False

    def state_nbytes(self) -> int:
        """No device bytes: the host row store, at 8 bytes a cell."""
        width = len(self.pk) + len(self.columns)
        n = len(self._native) if self._native is not None else len(self.rows)
        return int(n) * width * 8

    def trace_contract(self):
        return {
            "kind": "host",
            "trace_step": None,
            "state": None,
            "donate": False,
            "emission": "passthrough",
            "host_reason": "host-map materializer: the row store pulls every chunk to the "
                           "host (a device-resident MV is DeviceMaterializeExecutor)",
        }

    # -- backend selection ----------------------------------------------
    def _pick_backend(self, chunk: StreamChunk, data) -> None:
        if self._force_python or self.conflict_resolve:
            # conflict resolution reads stored rows per key: the dict
            self._backend = "python"
            return
        eligible = all(
            np.issubdtype(data[name].dtype, np.integer) and name not in chunk.nulls
            for name in self.pk + self.columns
        )
        if eligible:
            try:
                from risingwave_tpu_torch.native import NativeMvMap

                self._native = NativeMvMap(len(self.pk), len(self.columns))
                self._backend = "native"
                return
            except (RuntimeError, OSError):
                pass
        self._backend = "python"

    # -- data ------------------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        data = chunk.to_numpy(with_ops=True)
        ops = data["__op__"]
        n = len(ops)
        if n == 0:
            return [chunk]
        for name in self.pk + self.columns:
            if name not in self._dtypes:
                self._dtypes[name] = data[name].dtype
        if self._backend is None:
            self._pick_backend(chunk, data)
        if self._backend == "native" and any(nm in chunk.nulls for nm in self.pk + self.columns):
            # the int matrix holds no NULL cell: move to the dict, the
            # undrained pending deltas folded into the changed-key set
            self._demote_to_python()
        is_del = (ops == Op.DELETE) | (ops == Op.UPDATE_DELETE)
        if self._backend == "native":
            keys = (np.stack([data[nm] for nm in self.pk], axis=1).astype(np.int64)
                    if self.pk else np.zeros((n, 0), np.int64))
            vals = (np.stack([data[nm] for nm in self.columns], axis=1).astype(np.int64)
                    if self.columns else np.zeros((n, 0), np.int64))
            self._native.apply(keys, vals, is_del)
            self._pending.append((keys, vals, is_del.astype(np.uint8)))
            return [chunk]
        if self.conflict_resolve:
            return self._apply_resolve(data, ops, n, chunk.device)
        self._apply_python(data, ops, is_del, n)
        return [chunk]

    def _demote_to_python(self) -> None:
        keys, vals = self._native.dump()
        self.rows = {tuple(k): tuple(v) for k, v in zip(keys.tolist(), vals.tolist())}
        for pk_arr, _, _ in self._pending:
            self._changed.update(map(tuple, pk_arr.tolist()))
        self._pending = []
        self._native = None
        self._backend = "python"

    def _apply_resolve(self, data, ops, n, device) -> List[StreamChunk]:
        """Row-ordered conflict resolution against the stored map; returns
        what downstream must see to stay consistent with this table."""
        names = self.pk + self.columns
        cols_l = self._null_folded(data, names)
        out_rows: List[Tuple[int, Tuple, Tuple]] = []
        for i in range(n):
            k = tuple(cols_l[nm][i] for nm in self.pk)
            self._changed.add(k)
            if ops[i] in (Op.INSERT, Op.UPDATE_INSERT):
                v = tuple(cols_l[nm][i] for nm in self.columns)
                old = self.rows.get(k)
                if old is not None:
                    out_rows.append((int(Op.UPDATE_DELETE), k, old))
                    out_rows.append((int(Op.UPDATE_INSERT), k, v))
                else:
                    op = int(Op.UPDATE_INSERT) if ops[i] == Op.UPDATE_INSERT else int(Op.INSERT)
                    out_rows.append((op, k, v))
                self.rows[k] = v
            else:
                old = self.rows.pop(k, None)
                if old is None:
                    continue  # a delete of an absent pk is dropped
                op = int(Op.UPDATE_DELETE) if ops[i] == Op.UPDATE_DELETE else int(Op.DELETE)
                out_rows.append((op, k, old))
        if not out_rows:
            return []
        m = len(out_rows)
        cap = max(2, 1 << (m - 1).bit_length())
        cols: Dict[str, np.ndarray] = {}
        nulls: Dict[str, np.ndarray] = {}
        pk_n = len(self.pk)
        for j, nm in enumerate(names):
            vals = [(r[1][j] if j < pk_n else r[2][j - pk_n]) for r in out_rows]
            mask = np.asarray([v is None for v in vals], bool)
            dt = self._dtypes.get(nm, np.dtype(np.int64))
            cols[nm] = np.asarray([0 if v is None else v for v in vals], dt)
            if mask.any():
                nulls[nm] = mask
        out_ops = np.asarray([r[0] for r in out_rows], np.int32)
        return [StreamChunk.from_numpy(cols, cap, ops=out_ops, nulls=nulls or None,
                                       device=device)]

    @staticmethod
    def _null_folded(data, names):
        """{name: Python list with the NULL cells as None}: the one place
        the NULL-lane representation is read."""
        out = {}
        for name in names:
            col = data[name].tolist()
            nl = data.get(name + "__null")
            if nl is not None:
                col = [None if isnull else v for v, isnull in zip(col, nl)]
            out[name] = col
        return out

    def _apply_python(self, data, ops, is_del, n):
        # NULL pk components fold into the key tuple as None; the last
        # op per pk wins
        def tuples(names):
            if not names:
                return [()] * n
            folded = self._null_folded(data, names)
            return list(zip(*(folded[name] for name in names)))

        keys = tuples(self.pk)
        vals = tuples(self.columns)
        self._changed.update(keys)
        last = {k: i for i, k in enumerate(keys)}
        if is_del.any():
            rows = self.rows
            keys_u = list(last.keys())
            idx = np.fromiter(last.values(), dtype=np.int64, count=len(last))
            dmask = is_del[idx]
            for j in np.flatnonzero(dmask):
                rows.pop(keys_u[j], None)  # ConflictBehavior::Overwrite
            rows.update((keys_u[j], vals[idx[j]]) for j in np.flatnonzero(~dmask))
        else:
            self.rows.update((k, vals[i]) for k, i in last.items())

    # -- reads ------------------------------------------------------------
    def snapshot(self) -> Dict[Tuple, Tuple]:
        if self._backend == "native":
            keys, vals = self._native.dump()
            return {tuple(k): tuple(v) for k, v in zip(keys.tolist(), vals.tolist())}
        return dict(self.rows)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The snapshot as column arrays (pk columns, then value columns)."""
        if self._backend == "native":
            keys, vals = self._native.dump()
            out = {name: keys[:, j] for j, name in enumerate(self.pk)}
            out.update({name: vals[:, j] for j, name in enumerate(self.columns)})
            return out
        keys = list(self.rows)
        out = {name: np.array([k[j] for k in keys]) for j, name in enumerate(self.pk)}
        for j, name in enumerate(self.columns):
            out[name] = np.array([self.rows[k][j] for k in keys])
        return out

    # -- barrier ---------------------------------------------------------
    def on_barrier(self, barrier) -> List[StreamChunk]:
        """Fold the native backend's pending batches to their net effect
        per pk, so memory stays bounded by the keys touched when no
        checkpoint drains them (a checkpoint does the same fold)."""
        if not self.checkpoint_enabled and len(self._pending) > 1:
            self._pending = [self._net_pending()]
        return []

    def _net_pending(self):
        keys = np.concatenate([k for k, _, _ in self._pending])
        vals = np.concatenate([v for _, v, _ in self._pending])
        dels = np.concatenate([d for _, _, d in self._pending])
        sel = _last_per_key(keys)
        return keys[sel], vals[sel], dels[sel]

    # -- checkpoint/restore ----------------------------------------------
    def checkpoint_delta(self):
        """The rows whose pk changed since the last checkpoint; the native
        backend's is the net effect of its pending batches (the last
        occurrence per pk wins, its delete flag the tombstone)."""
        if self._backend == "native":
            return self._native_delta()
        return self._python_delta()

    def _native_delta(self):
        if not self._pending:
            return []
        keys = np.concatenate([k for k, _, _ in self._pending])
        vals = np.concatenate([v for _, v, _ in self._pending])
        dels = np.concatenate([d for _, _, d in self._pending])
        self._pending = []
        if len(keys) == 0:
            return []
        sel = _last_per_key(keys)
        key_cols = {f"k{j}": keys[sel, j].astype(self._dtypes[self.pk[j]])
                    for j in range(len(self.pk))}
        value_cols = {f"v{j}": vals[sel, j].astype(self._dtypes[self.columns[j]])
                      for j in range(len(self.columns))}
        return [StateDelta(self.table_id, key_cols, value_cols, dels[sel].astype(bool),
                           tuple(f"k{j}" for j in range(len(self.pk))))]

    def _python_delta(self):
        if not self._changed:
            return []
        ups, tombs = [], []
        for k in self._changed:
            if any(v is None for v in k):
                raise ValueError("NULL pk persistence not supported yet")
            row = self.rows.get(k)
            if row is None:
                tombs.append(k)
            else:
                ups.append((k, row))
        n = len(ups) + len(tombs)
        key_cols = {
            f"k{j}": np.array([k[j] for k, _ in ups] + [k[j] for k in tombs],
                              dtype=self._dtypes[name])
            for j, name in enumerate(self.pk)
        }
        value_cols = {}
        for j, name in enumerate(self.columns):
            pad = np.zeros(len(tombs), dtype=self._dtypes[name])
            vals = [r[j] for _, r in ups]
            value_cols[f"v{j}"] = np.concatenate([
                np.array([0 if v is None else v for v in vals], dtype=self._dtypes[name]), pad,
            ]) if ups else pad
            # NULL cells persist as a bool companion lane, in every delta
            # (SST merges of one table need one lane set)
            value_cols[f"vn{j}"] = np.array([v is None for v in vals] + [False] * len(tombs),
                                            bool)
        tombstone = np.zeros(n, bool)
        tombstone[len(ups):] = True
        self._changed.clear()
        return [StateDelta(self.table_id, key_cols, value_cols, tombstone,
                           tuple(f"k{j}" for j in range(len(self.pk))))]

    def state_digest(self) -> int:
        """The row map's digest (equal for both backends)."""
        return integrity.host_obj_digest(sorted(self.snapshot().items(), key=repr))

    def restore_state(self, table_id, key_cols, value_cols):
        self.rows = {}
        self._changed = set()
        self._pending = []
        self._native = None
        self._backend = None
        if not key_cols:
            return
        n = len(next(iter(key_cols.values())))
        ints = (
            not self._force_python
            and not self.conflict_resolve  # resolution reads the dict
            and all(np.issubdtype(np.asarray(a).dtype, np.integer)
                    for a in list(key_cols.values()) + list(value_cols.values()))
        )  # the vn{j} NULL companions are bool: the dict backend
        if ints:
            try:
                from risingwave_tpu_torch.native import NativeMvMap

                self._native = NativeMvMap(len(self.pk), len(self.columns))
                self._backend = "native"
                keys = (np.stack([key_cols[f"k{j}"] for j in range(len(self.pk))],
                                 axis=1).astype(np.int64)
                        if self.pk else np.zeros((n, 0), np.int64))
                vals = (np.stack([value_cols[f"v{j}"] for j in range(len(self.columns))],
                                 axis=1).astype(np.int64)
                        if self.columns else np.zeros((n, 0), np.int64))
                for j in range(len(self.pk)):
                    self._dtypes.setdefault(self.pk[j], np.asarray(key_cols[f"k{j}"]).dtype)
                for j in range(len(self.columns)):
                    self._dtypes.setdefault(self.columns[j],
                                            np.asarray(value_cols[f"v{j}"]).dtype)
                self._native.apply(keys, vals, np.zeros(n, np.uint8))
                return
            except (RuntimeError, OSError):
                self._backend = None
        self._backend = "python"
        nls = [value_cols.get(f"vn{j}") for j in range(len(self.columns))]
        for i in range(n):
            k = tuple(key_cols[f"k{j}"][i].item() for j in range(len(self.pk)))
            v = tuple(
                None if nls[j] is not None and bool(nls[j][i]) else value_cols[f"v{j}"][i].item()
                for j in range(len(self.columns))
            )
            self.rows[k] = v
