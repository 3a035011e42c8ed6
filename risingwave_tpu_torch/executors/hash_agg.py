"""HashAgg executor — grouped streaming aggregation with retraction.

Port of ``risingwave_tpu/executors/hash_agg.py`` (``_build_key_lanes``
:61, ``_minput_pass`` :82, ``agg_step_fn`` :108, ``_agg_scan`` :169,
``_epoch_reduced_fn`` :190, ``_rehash`` :268, ``delta_to_chunk`` :414,
``HashAggExecutor.apply`` :636, ``apply_stacked`` :678, ``_maybe_grow``
:760, the barrier latch checks :800-870, ``_flush_all`` :1029,
``cleaning_watermarks`` :1055, ``on_watermark`` :1085, ``_expire`` :393).
Reference: src/stream/src/executor/hash_agg.rs:62 — apply_chunk (:326)
updates each row's group by its sign; flush_data (:406) emits
I / (U-, U+) / D per dirty group at the barrier.

Per chunk: kernel A finds or inserts the group keys, kernel B folds the
rows into the agg state and sets group liveness. Per epoch
(``apply_stacked`` in "reduce" mode): the epoch's stacked chunks go
through the pure prefix, are flattened into one batch, pre-reduced by
key (kernel F), the table is touched once per distinct key (kernel A)
and the sums are scattered (kernel G). Per barrier: kernel C flushes
the dirty groups in rounds of ``out_cap``, one packed status read per
round (the fused program instead runs a number of rounds fixed on the
host from ``_dirty_bound``, with no read). The host grows the table
from an insert bound and the occupancy read at each barrier; a rebuild
re-inserts the kept keys (kernel A) and moves their lanes (kernel I).

A materialized MIN/MAX (``AggCall(materialized=True)``) keeps every
input value in a ``(capacity, minput_k)`` multiset per group
(``ops/minput.py``, kernel Q): after the ordinary update, the minput
pass folds the same rows (the epoch path re-probes each row's slot,
kernel M's ``rw_lookup``) into the multisets and writes each touched
group's extreme and live total into the call's lanes; an overflow or
an inconsistent retraction latches ``mi_bad``, which raises at the
barrier. A rebuild moves the multisets (kernel Q's rescatter), a
window watermark clears the closed groups' (kernel Q's clear).

A watermark on the ``window_key`` column closes the groups below it
(kernel O): emit-on-window-close (``emit_deletes=False``) flushes the
dirty groups first and then frees the closed ones silently; otherwise
they are reset and retracted at the next flush.

Checkpoint and restore (``hash_agg.py:1260-1446``): ``checkpoint_delta``
stages the groups changed since the last checkpoint through kernel R
(select on the card, one gather of every lane, the multisets' 2-D rows
included, one copy to the host, then the eager mark flip), with float
MIN/MAX lanes written in the reference's unsigned key dtypes, so either
package reads the other's store; ``restore_state`` re-inserts the keys
(kernel A) and lands every lane's rows in one scatter (kernel R).

The cold tier (``hash_agg.py:516-545, :872-1018, :1061-1083,
:1161-1258``): setting ``cold_reader`` (a ``CheckpointManager.get_rows``
of this table) arms four host hooks. ``evict_cold`` drops every durable
group (stored, not sdirty, not dirty) from the card: kernel AG's select
gives the hot mask and the durable slots in one count read, the hot
groups move into a table of ``grow_pow2(n_hot, 2^10)`` slots (kernels
A, I and Q's rescatter, as a rebuild), and with a materialized MIN/MAX
the durable keys are gathered (kernel R) into ``_evicted``. At each
barrier the groups created since the last checkpoint are looked up in
the store and a hit folds its stored state into the slot (AG's merge).
With a materialized MIN/MAX an evicted group instead faults back in
before any row lands on it (on touch, all of them before an
epoch-batched apply, or when a watermark closes it): kernel A inserts
the keys and kernel R lands every lane of the stored rows, the
multisets included, with ``stored`` and ``live`` in the same launch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk, _numpy_dtype, flatten_stacked, to_device
from risingwave_tpu_torch.executors.base import Barrier, Executor, Watermark
from risingwave_tpu_torch.ops import agg as agg_ops
from risingwave_tpu_torch.ops import minput as mi_ops
from risingwave_tpu_torch.ops.agg import (
    AggCall,
    AggState,
    order_key_from_reference,
    order_key_to_reference,
)
from risingwave_tpu_torch.ops.checkpoint import (
    insert_keys,
    mark_checkpointed,
    scatter_rows,
    stage_select,
)
from risingwave_tpu_torch.ops.cold_tier import (
    AGG,
    MERGE,
    agg_merge_lanes,
    cold_merge,
    cold_select,
    tensor_nbytes,
)
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    expired_slots,
    lookup,
    lookup_or_insert,
    move_slots,
    stage_scalars,
)
from risingwave_tpu_torch.runtime.bucketing import BucketAllocator, BucketPolicy, flush_pad
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    StateDelta,
    grow_pow2,
    host_key_value,
    host_key_view,
    lanes_from_host_keys,
    pull_rows,
)

GROW_AT = 0.5  # rehash when claimed slots may exceed this load factor
# mid-epoch rebuild only when the host insert bound nears the table
# itself; ordinary growth resolves at the barrier from true occupancy
HARD_GROW_AT = 0.75


def _build_key_lanes(
    chunk: StreamChunk, group_keys: Tuple[str, ...], nullable: Tuple[bool, ...]
):
    """Group-key lanes with SQL NULL-group semantics; nullability is
    declared up front so the lane layout never depends on a chunk."""
    lanes = []
    for name, nb in zip(group_keys, nullable):
        col = chunk.col(name)
        if nb:
            null = chunk.null_of(name)
            lanes.append(torch.where(null, torch.zeros_like(col), col))
            lanes.append(null)
        else:
            lanes.append(col)
    return tuple(lanes)


def _minput_pass(state: AggState, minput, mi_bad, calls, slots, signs, chunk) -> None:
    """Fold a row batch into every materialized MIN/MAX multiset and
    write each touched group's new extreme and live total into the
    call's accumulator and non-null lanes (so the flush is unchanged),
    all in place (kernel Q on the card); the batch's overflow and
    inconsistency latches OR into ``mi_bad``."""
    for c in calls:
        if not c.materialized:
            continue
        vals, cnt = minput[c.output]
        null = chunk.nulls.get(c.input)
        mi_ops.minput_apply(
            vals, cnt, slots, signs, chunk.col(c.input), None if null is None else ~null,
            c.kind, state.accums[c.output], state.nonnull[c.output], mi_bad, mi_bad,
        )


def agg_step_fn(
    table: HashTable,
    state: AggState,
    dropped: torch.Tensor,
    chunk: StreamChunk,
    calls: Tuple[AggCall, ...],
    group_keys: Tuple[str, ...],
    nullable: Tuple[bool, ...],
    minput,
    mi_bad: torch.Tensor,
):
    """One chunk through the group map and the agg update (in place),
    then through the materialized MIN/MAX multisets ``minput`` (empty
    without such a call) and their latch ``mi_bad``."""
    keys = _build_key_lanes(chunk, group_keys, nullable)
    table, slots, _, _ = lookup_or_insert(table, keys, chunk.valid)
    dropped |= (chunk.valid & (slots < 0)).any()
    signs = chunk.effective_signs()
    values = {c.input: chunk.col(c.input) for c in calls if c.input is not None}
    nulls = {
        c.input: chunk.nulls[c.input]
        for c in calls
        if c.input is not None and c.input in chunk.nulls
    }
    agg_ops.apply(state, calls, slots, signs, values, nulls, live=table.live)
    _minput_pass(state, minput, mi_bad, calls, slots, signs, chunk)
    return table, state, dropped


def _agg_scan(table, state, dropped, stacked, calls, group_keys, nullable, pre,
              minput, mi_bad):
    """The per-chunk step over a stacked epoch, chunk by chunk: the
    reference's ``lax.scan`` and the differential twin of the reduce
    path."""
    for i in range(stacked.valid.shape[0]):
        chunk = StreamChunk(
            {n: a[i] for n, a in stacked.columns.items()},
            stacked.valid[i],
            {n: a[i] for n, a in stacked.nulls.items()},
            stacked.ops[i],
        )
        if pre is not None:
            chunk = pre(chunk)
        table, state, dropped = agg_step_fn(
            table, state, dropped, chunk, calls, group_keys, nullable, minput, mi_bad
        )
    return table, state, dropped


def _epoch_reduced_fn(table, state, dropped, stacked, calls, group_keys, nullable, pre,
                      minput, mi_bad):
    """The epoch path: the pure prefix over the stacked chunks, flatten
    the epoch into one row batch, pre-reduce it by key (kernel F), touch
    the table once per distinct key (kernel A), scatter the sums and set
    liveness (kernel G). Exact, because every agg kind here commutes
    across one epoch's rows. With a materialized MIN/MAX every flat
    row's slot is probed again (read-only: the representatives' inserts
    guarantee a hit) and the raw rows fold into its multiset in
    ``minput``."""
    chunks = pre(stacked) if pre is not None else stacked
    flat = flatten_stacked(chunks)
    keys = _build_key_lanes(flat, group_keys, nullable)
    values = {c.input: flat.col(c.input) for c in calls if c.input is not None}
    nulls = {
        c.input: flat.nulls[c.input]
        for c in calls
        if c.input is not None and c.input in flat.nulls
    }
    sorted_keys, rep_valid, w, reduced, mret = agg_ops.reduce_by_key(
        keys, flat.effective_signs(), calls, values, nulls
    )
    table, slots, _, _ = lookup_or_insert(table, sorted_keys, rep_valid)
    dropped |= (rep_valid & (slots < 0)).any()
    agg_ops.apply_reduced(state, calls, slots, rep_valid, w, reduced, mret, live=table.live)
    if not minput:
        return table, state, dropped
    row_signs = flat.effective_signs()
    row_slots, _ = lookup(table, keys, flat.valid & (row_signs != 0))
    _minput_pass(state, minput, mi_bad, calls, row_slots, row_signs, flat)
    return table, state, dropped


def _rehash(table: HashTable, state: AggState, minput, calls, new_cap: int,
            float_extremes=(), keep: Optional[torch.Tensor] = None):
    """Rebuild into a fresh table of ``new_cap`` slots, dropping slots no
    one needs, and move every slot-indexed lane: kernel A re-inserts the
    surviving keys, kernel I moves the lanes, kernel Q's rescatter the
    ``minput`` multisets. A slot survives iff it is
    live, was emitted (a later delete must retract it), is dirty or is
    sdirty (its key must reach the next checkpoint); an eviction passes
    its hot mask as ``keep`` (the reference's ``_evict``)."""
    if keep is None:
        keep = table.live | state.emitted_valid | state.dirty | state.sdirty
        keep &= table.fp1 != 0
    dev = table.device
    new_table = HashTable.create(new_cap, tuple(k.dtype for k in table.keys), device=dev)
    new_table, new_slots, _, _ = lookup_or_insert(new_table, table.keys, keep)
    moves = [(table.live, new_table.live)]

    def rescatter(src, init=0):
        out = torch.full((new_cap,), init, dtype=src.dtype, device=dev)
        moves.append((src, out))
        return out

    fx = dict(float_extremes)
    inits = {
        c.output: agg_ops.accum_init(
            c.kind, state.accums[c.output].dtype, fx.get(c.output)
        )
        for c in calls
    }
    new_state = AggState(
        row_count=rescatter(state.row_count),
        accums={n: rescatter(a, inits[n]) for n, a in state.accums.items()},
        nonnull={n: rescatter(a) for n, a in state.nonnull.items()},
        emitted={
            n: rescatter(a, agg_ops.emitted_init(fx.get(n)))
            for n, a in state.emitted.items()
        },
        emitted_isnull={n: rescatter(a) for n, a in state.emitted_isnull.items()},
        emitted_valid=rescatter(state.emitted_valid),
        dirty=rescatter(state.dirty),
        minmax_retracted=state.minmax_retracted,
        sdirty=rescatter(state.sdirty),
        stored=rescatter(state.stored),
    )
    srcs, dsts = zip(*moves)
    move_slots(srcs, dsts, new_slots, keep)  # kernel I
    new_minput = {
        name: mi_ops.minput_rescatter(v, c, keep, new_slots, new_cap,
                                      mi_ops.vals_init(fx.get(name)))
        for name, (v, c) in minput.items()
    }
    return new_table, new_state, new_minput


def _expire(table: HashTable, state: AggState, cutoff: int, calls, key_index: int,
            emit_deletes: bool, float_extremes: tuple = ()) -> None:
    """Close every live group whose window-key lane < cutoff, in place:
    retracted (``delete_groups``) with ``emit_deletes``, else forgotten
    (``forget_groups``). Kernel O on the card."""
    agg_ops.expire_groups(table, state, calls, key_index, cutoff, emit_deletes, float_extremes)


def delta_to_chunk(
    delta: dict,
    group_keys: Tuple[str, ...],
    nullable: Tuple[bool, ...],
    calls: Tuple[AggCall, ...],
    pad: Optional[int] = None,
) -> StreamChunk:
    """``agg_ops.flush`` delta -> StreamChunk, sliced to ``pad`` rows."""
    sl = (lambda a: a[:pad]) if pad is not None else (lambda a: a)
    cols, nulls = {}, {}
    i = 0
    for name, nb in zip(group_keys, nullable):
        cols[name] = sl(delta[f"key{i}"])
        i += 1
        if nb:
            nulls[name] = sl(delta[f"key{i}"])
            i += 1
    for c in calls:
        cols[c.output] = sl(delta[c.output])
        lane = delta.get(c.output + "__isnull")
        if lane is not None:
            nulls[c.output] = sl(lane)
    return StreamChunk(
        columns=cols, valid=sl(delta["valid"]), nulls=nulls, ops=sl(delta["ops"])
    )


class HashAggExecutor(Executor, Checkpointable):
    """Streaming GROUP BY.

    Args:
      group_keys: grouping column names (re-emitted on flush).
      calls: aggregate calls.
      schema_dtypes: input column name -> torch dtype.
      capacity: initial group-table capacity (power of two; grows 2x).
      out_cap: max dirty groups emitted per flush round.
      nullable_keys: subset of group_keys that can carry SQL NULL.
      window_key: (column, retention_ms, emit_deletes) for watermark
        state cleaning.
      minput_k: distinct values a materialized MIN/MAX keeps per group.
      device: where the state lives (default "cuda").
    """

    def __init__(
        self,
        group_keys: Sequence[str],
        calls: Sequence[AggCall],
        schema_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 16,
        out_cap: int = 1 << 15,
        nullable_keys: Sequence[str] = (),
        window_key: Optional[Tuple[str, int, bool]] = None,
        table_id: str = "hash_agg",
        minput_k: int = 32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.table_id = table_id
        self.group_keys = tuple(group_keys)
        self.calls = tuple(calls)
        self.out_cap = out_cap
        self._dtypes = dict(schema_dtypes)
        self.nullable = tuple(k in set(nullable_keys) for k in self.group_keys)
        key_dtypes = []
        for k, nb in zip(self.group_keys, self.nullable):
            key_dtypes.append(self._dtypes[k])
            if nb:
                key_dtypes.append(torch.bool)
        self.table = HashTable.create(capacity, key_dtypes, device=self.device)
        self.state = agg_ops.create_state(capacity, self.calls, self._dtypes, self.device)
        self.dropped = torch.zeros((), dtype=torch.bool, device=self.device)
        # materialized-input MIN/MAX multisets (minput.rs) and their latch
        self.minput_k = minput_k
        self.minput = mi_ops.create_minput(capacity, minput_k, self.calls, self._dtypes,
                                           self.device)
        self.mi_bad = torch.zeros((), dtype=torch.bool, device=self.device)
        self._insert_bound = 0  # host-side upper bound of claimed slots
        self._occ_note = 0  # true claimed at the last barrier
        # host-side upper bound of dirty (unflushed) groups: rows absorbed
        # since the last flush; sets the fused program's flush rounds
        self._dirty_bound = 0
        self._buckets = BucketAllocator(
            BucketPolicy.from_capacity(capacity, grow_at=GROW_AT)
        )
        self.window_key = window_key
        self._float_extremes = agg_ops.float_extreme_meta(self.calls, self._dtypes)
        # the cold tier: setting ``cold_reader`` binds the four hooks;
        # while it is None the data path runs none of their host code
        self._cold_reader = None
        self._cold_apply_hook = None  # _fault_in when armed
        self._cold_stacked_hook = None  # _fault_in_all when armed
        self._cold_barrier_hook = None  # _merge_cold when armed
        self._cold_expire_hook = None  # _expire_evicted when armed
        # with a materialized MIN/MAX the multisets cannot merge at the
        # barrier (a delete before the merge would latch inconsistent):
        # evicted keys (host_key_view tuples) fault back in on touch
        self._evicted: set = set()
        # the tier's work so far, counted on the host
        self.cold_counts = {"evicted": 0, "merged": 0, "faulted_in": 0}

    @property
    def cold_reader(self):
        return self._cold_reader

    @cold_reader.setter
    def cold_reader(self, fn) -> None:
        self._cold_reader = fn
        armed = fn is not None
        self._cold_apply_hook = self._fault_in if armed else None
        self._cold_stacked_hook = self._fault_in_all if armed else None
        self._cold_barrier_hook = self._merge_cold if armed else None
        self._cold_expire_hook = self._expire_evicted if armed else None

    def load_reference_state(self, np_arrays) -> None:
        """Take over the reference executor's device state, given as
        numpy arrays: ``{"table": ..., "state": ..., "dropped": ...}``
        where table/state are the reference's HashTable/AggState with
        numpy leaves (``jax.device_get``) or dicts of their fields, and
        optionally ``"minput"`` (``{output: (vals, cnt)}``) and
        ``"mi_bad"``. Every key keeps its slot, every value its lane."""
        t, s = np_arrays["table"], np_arrays["state"]
        get = t.get if isinstance(t, dict) else lambda k: getattr(t, k)
        self.table = HashTable.from_reference_arrays(
            get("fp1"), get("fp2"), get("keys"), get("live"), device=self.device
        )
        self.state = AggState.from_reference_arrays(s, self._float_extremes, self.device)
        self.dropped = torch.tensor(
            bool(np_arrays.get("dropped", False)), device=self.device
        )
        fx = dict(self._float_extremes)
        for name, (vals, cnt) in np_arrays.get("minput", {}).items():
            vals = np.asarray(vals)
            if name in fx:
                vals = agg_ops.order_key_from_reference(vals)
            self.minput[name] = (to_device(vals, self.device),
                                 to_device(np.asarray(cnt), self.device))
        self.mi_bad = torch.tensor(bool(np_arrays.get("mi_bad", False)), device=self.device)
        claimed = int(self.table.occupancy())
        self._insert_bound = self._occ_note = claimed

    # -- data ------------------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        for k, nb in zip(self.group_keys, self.nullable):
            if not nb and k in chunk.nulls:
                raise ValueError(
                    f"group key {k!r} carries a null lane but was not "
                    "declared in nullable_keys"
                )
        if self._cold_apply_hook is not None:
            self._cold_apply_hook(chunk)
        self._maybe_grow(chunk.capacity)
        self._insert_bound += chunk.capacity
        self._dirty_bound += chunk.capacity
        self.table, self.state, self.dropped = agg_step_fn(
            self.table, self.state, self.dropped, chunk,
            self.calls, self.group_keys, self.nullable, self.minput, self.mi_bad,
        )
        return []

    def apply_stacked(self, stacked: StreamChunk, pre=None, mode: str = "reduce") -> List[StreamChunk]:
        """Apply a whole batch of chunks (lanes of shape (n_chunks, C))
        at once. ``pre`` is an optional pure step (``pure_step()`` of
        the executors upstream, e.g. the hop expansion) run on the batch
        first. ``mode`` "reduce" is the epoch path (kernels F, A, G);
        "scan" runs the per-chunk step chunk by chunk, the differential
        twin (not with a materialized MIN/MAX, as the reference)."""
        if mode not in ("reduce", "scan"):
            raise ValueError(f"unknown apply_stacked mode {mode!r}")
        if self._cold_stacked_hook is not None:
            # the batch's keys are not known before the pure prefix runs:
            # every evicted group comes back first
            self._cold_stacked_hook()
        if self.minput and mode != "reduce":
            raise ValueError(
                "materialized MIN/MAX supports apply_stacked only in "
                "'reduce' mode (use apply for per-chunk ordering)"
            )
        n_chunks, cap = stacked.valid.shape
        incoming = n_chunks * (pre.rows(cap) if pre is not None else cap)
        self._maybe_grow(incoming)
        self._insert_bound += incoming
        self._dirty_bound += incoming
        step = _epoch_reduced_fn if mode == "reduce" else _agg_scan
        self.table, self.state, self.dropped = step(
            self.table, self.state, self.dropped, stacked,
            self.calls, self.group_keys, self.nullable, pre, self.minput, self.mi_bad,
        )
        return []

    def _maybe_grow(self, incoming: int) -> None:
        """Mid-epoch overflow guard from the host insert bound alone (no
        device read): rebuild before the bound nears the table."""
        cap = self.table.capacity
        self._insert_bound = min(self._insert_bound, cap)
        if self._insert_bound + incoming <= cap * HARD_GROW_AT:
            return
        claimed = self._insert_bound
        new_cap = self._buckets.plan(cap, incoming, claimed, claimed)
        if new_cap is not None and new_cap != cap:
            self._rebuild(new_cap)
            self._insert_bound = min(claimed, new_cap)

    def _rebuild(self, new_cap: int) -> None:
        self.table, self.state, self.minput = _rehash(
            self.table, self.state, self.minput, self.calls, new_cap, self._float_extremes
        )

    # -- control ---------------------------------------------------------
    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        if self._cold_barrier_hook is not None:
            self._cold_barrier_hook()
        outs = self._flush_all()
        self._staged_scalars = stage_scalars(
            self.dropped, self.state.minmax_retracted, self.mi_bad, self.table.occupancy()
        )
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return outs

    def _on_barrier_scalars(self, vals) -> None:
        dropped, mret, mi_bad, claimed = vals
        epoch_inc = max(self._insert_bound - self._occ_note, 0)
        self._occ_note = int(claimed)
        self._insert_bound = int(claimed)
        cap = self.table.capacity
        self._buckets.note_barrier(cap, int(claimed))
        new_cap = self._buckets.plan(
            cap, 0, int(claimed), int(claimed), margin=max(int(claimed), epoch_inc)
        )
        if new_cap is not None and new_cap != cap:
            self._rebuild(new_cap)
        if dropped:
            raise RuntimeError("hash table overflowed MAX_PROBE mid-epoch; grow capacity")
        if mret:
            raise RuntimeError(
                "row-level retraction hit an append-only MIN/MAX aggregate; "
                "set AggCall(materialized=True) for materialized-input "
                "extremes"
            )
        if mi_bad:
            raise RuntimeError(
                "materialized MIN/MAX state overflowed minput_k distinct "
                "values per group, or a value was retracted that was never "
                "inserted"
            )

    def _flush_all(self) -> List[StreamChunk]:
        """Flush rounds until no dirty group is left; each round reads
        its (2,) status once (a device sync) to size the emitted chunk."""
        outs = []
        while True:
            self.state, delta = agg_ops.flush(
                self.state, self.table.keys, self.out_cap, self._float_extremes
            )
            n_take, overflow = delta["status"].tolist()
            pad = flush_pad(self.out_cap, n_take)
            outs.append(
                delta_to_chunk(delta, self.group_keys, self.nullable, self.calls, pad)
            )
            if not overflow:
                self._dirty_bound = 0
                return outs

    def on_watermark(self, watermark: Watermark):
        if self.window_key is None or watermark.column != self.window_key[0]:
            return watermark, []
        colname, retention, emit_deletes = self.window_key
        if self._cold_expire_hook is not None:
            self._cold_expire_hook(watermark)
        outs: List[StreamChunk] = []
        if not emit_deletes:
            # emit-on-window-close frees state silently: the dirty
            # groups' pending updates must reach downstream first
            outs = self._flush_all()
        cutoff = watermark.value - retention
        key_index = self._key_lane_index(colname)
        # the storage-side skip watermark (state_table.rs:1133): the
        # checkpoint's compaction drops keys below it
        self._cleaning_watermark = (f"k{key_index}", cutoff)
        if self.minput:
            expired = expired_slots(self.table, key_index, cutoff)
            slots = torch.where(
                expired,
                torch.arange(self.table.capacity, dtype=torch.int32, device=expired.device),
                -1,
            )
            for vals, cnt in self.minput.values():
                mi_ops.minput_clear(vals, cnt, slots)  # kernel Q's clear
        if emit_deletes:
            # a retracting expiry can dirty every live group; the host
            # cannot count them without a read, so bound by capacity
            self._dirty_bound = self.table.capacity
        _expire(self.table, self.state, cutoff, self.calls, key_index, emit_deletes,
                self._float_extremes)
        return watermark, outs

    # -- the cold tier -------------------------------------------------
    def state_nbytes(self) -> int:
        """Device bytes of the table, the state and the multisets (from
        the tensors' sizes, no device read)."""
        return tensor_nbytes((self.table, self.state, self.minput))

    def evict_cold(self) -> int:
        """Drop every durable group from the card (the reference's
        state-table LRU over Hummock, hash_agg.rs:49): kernel AG selects,
        the hot groups move into a table of ``grow_pow2(n_hot, 2^10)``
        slots. Returns the groups evicted (durable and live or emitted).
        Needs a ``cold_reader`` so that evicted groups can come back."""
        if self.cold_reader is None:
            raise RuntimeError("evict_cold needs a cold_reader")
        t, st = self.table, self.state
        got = cold_select(AGG, t.fp1, t.live, st.sdirty, st.stored, ev=st.emitted_valid,
                          dirty=st.dirty)
        if self.minput and got.sel.numel():
            # the multisets fault back in on touch: record the keys
            pulled = pull_rows({f"k{i}": lane for i, lane in enumerate(t.keys)}, got.sel)
            views = [host_key_view(pulled[f"k{i}"]).tolist() for i in range(len(t.keys))]
            self._evicted.update(zip(*views))
        new_cap = grow_pow2(got.n_hot, 1 << 10, GROW_AT)
        self.table, self.state, self.minput = _rehash(
            t, st, self.minput, self.calls, new_cap, self._float_extremes, keep=got.hot
        )
        self._insert_bound = int(self.table.occupancy())
        self.cold_counts["evicted"] += got.n_counted
        return got.n_counted

    def _chunk_key_tuples(self, chunk: StreamChunk) -> set:
        """The chunk's valid group keys as host tuples in the table's key
        lane layout (value, and a null flag per nullable key)."""
        sel = np.flatnonzero(chunk.valid.cpu().numpy())
        views = []
        for k, nb in zip(self.group_keys, self.nullable):
            a = chunk.col(k).cpu().numpy()
            if nb:
                nl = (chunk.nulls[k].cpu().numpy() if k in chunk.nulls
                      else np.zeros(len(a), bool))
                views.append(host_key_view(np.where(nl, np.zeros((), a.dtype), a)))
                views.append(nl.astype(np.int64))
            else:
                views.append(host_key_view(a))
        return set(zip(*(v[sel].tolist() for v in views)))

    def _fault_in(self, chunk: StreamChunk) -> None:
        if not self._evicted:
            return  # nothing evicted: the chunk stays on the card
        hits = self._chunk_key_tuples(chunk) & self._evicted
        if hits:
            self._restore_cold_groups(sorted(hits))

    def _fault_in_all(self) -> None:
        if self._evicted:
            self._restore_cold_groups(sorted(self._evicted))

    def _restore_cold_groups(self, key_tuples) -> None:
        """The evicted groups' stored state, exactly, before any new row
        lands on them: kernel A inserts the keys found in the store,
        kernel R lands every lane (the multisets too) with ``stored`` and
        ``live = row_count > 0``; a key without a slot latches
        ``dropped``."""
        dtypes = [_numpy_dtype(k.dtype) for k in self.table.keys]
        lanes_np = lanes_from_host_keys(key_tuples, dtypes)
        found, vals = self.cold_reader(lanes_np)
        self._evicted.difference_update(key_tuples)
        nt = int(found.sum())
        if not nt:
            return
        self._maybe_grow(nt)
        self._insert_bound += nt
        self.cold_counts["faulted_in"] += nt
        keys = {k: v[found] for k, v in lanes_np.items()}
        cold = {k: np.asarray(v)[found] for k, v in vals.items()}
        self.table, slots = insert_keys(self.table, keys, nt)
        self.dropped |= (slots < 0).any()
        scatter_agg_rows(self.table, self.state, self.minput, slots, cold, self.calls,
                         self._dtypes, nt)

    def _merge_cold(self) -> int:
        """Fold stored state into groups created since the last
        checkpoint (candidates sdirty & ~stored, selected by kernel AG):
        a store hit is a group evicted earlier, and AG's merge folds its
        stored lanes into what accrued since. Returns the groups
        merged."""
        t, st = self.table, self.state
        cand = cold_select(MERGE, t.fp1, t.live, st.sdirty, st.stored).sel
        if not cand.numel():
            return 0
        keys = pull_rows({f"k{i}": lane for i, lane in enumerate(t.keys)}, cand,
                         {"slot": cand})
        slot = keys.pop("slot")
        found, vals = self.cold_reader(keys)
        n = int(found.sum())
        if not n:
            return 0
        fx = _float_lanes(self._float_extremes)
        cold = {}
        for name, v in vals.items():
            v = np.asarray(v)[found]
            cold[name] = order_key_from_reference(v) if name in fx else v
        cold_merge(agg_merge_lanes(st, self.calls), to_device(slot[found], t.device), cold,
                   st.row_count, t.live)
        self._dirty_bound += n  # merged slots are dirty
        self.cold_counts["merged"] += n
        return n

    def _expire_evicted(self, watermark: Watermark) -> None:
        """An evicted group past the cutoff still closes: it faults back
        in, and the expiry below retracts or frees it. Float keys compare
        in the numeric domain (the tuples hold bit patterns)."""
        if not self._evicted:
            return
        colname, retention, _ = self.window_key
        ki = self._key_lane_index(colname)
        cut = int(watermark.value) - retention
        dt = _numpy_dtype(self.table.keys[ki].dtype)
        expiring = [t for t in self._evicted if host_key_value(t[ki], dt) < cut]
        if expiring:
            self._restore_cold_groups(sorted(expiring))

    def cleaning_watermarks(self):
        """[(table_id, storage key name, cutoff)] of the last window
        watermark (the checkpoint's skip-watermark compaction)."""
        wm = getattr(self, "_cleaning_watermark", None)
        return [(self.table_id, wm[0], wm[1])] if wm else []

    def _key_lane_index(self, name: str) -> int:
        """Index of a group key's value lane in the table's key tuple
        (null lanes of earlier nullable keys shift later lanes)."""
        i = 0
        for k, nb in zip(self.group_keys, self.nullable):
            if k == name:
                return i
            i += 2 if nb else 1
        raise KeyError(f"{name!r} is not a group key")


# -- checkpoint/restore (StateTable integration) -------------------------
def _float_lanes(float_extremes, prefixes=("acc_", "em_", "miv_")):
    """Delta lane name -> float input dtype of every lane that holds
    float MIN/MAX order keys."""
    return {p + name: dt for name, dt in float_extremes for p in prefixes}


def _agg_checkpoint_delta(self) -> List[StateDelta]:
    """Stage rows changed since the last checkpoint (device -> host).

    upsert  = sdirty & alive        (new/changed group state)
    tombstone = sdirty & stored & dead  (a persisted group died)
    with alive = live | emitted_valid | dirty. Rows carry the full slot
    state (accums, emitted snapshots, the multisets' (K,) rows), so
    restore rebuilds the operator state exactly. Kernel R selects on the
    card (the host reads one count pair), gathers every lane in one
    launch, copies once to the host, then flips the marks."""
    st = self.state
    sel, tomb, n, n_sdirty = stage_select(
        st.sdirty, (self.table.live, st.emitted_valid, st.dirty), st.stored
    )
    if not n_sdirty:
        return []
    lanes = {f"k{i}": lane for i, lane in enumerate(self.table.keys)}
    key_names = tuple(lanes)
    lanes["row_count"] = st.row_count
    for name, a in st.accums.items():
        lanes[f"acc_{name}"] = a
        lanes[f"em_{name}"] = st.emitted[name]
    for name, a in st.nonnull.items():
        lanes[f"nn_{name}"] = a
        lanes[f"ei_{name}"] = st.emitted_isnull[name]
    for name, (v, c) in self.minput.items():
        lanes[f"miv_{name}"] = v  # 2-D (rows re-land whole)
        lanes[f"mic_{name}"] = c
    lanes["ev"] = st.emitted_valid
    pulled = pull_rows(lanes, sel, {"tombstone": tomb})
    for name, fdt in _float_lanes(self._float_extremes).items():
        if name in pulled:  # the reference's uint32/uint64 order keys
            pulled[name] = order_key_to_reference(pulled[name], _numpy_dtype(fdt))
    tombstone = pulled.pop("tombstone")
    # eager flip — see StateDelta's durability contract
    mark_checkpointed(st.stored, st.sdirty, sel, tomb)
    keys = {k: pulled[k] for k in key_names}
    vals = {k: v for k, v in pulled.items() if k not in key_names}
    # positional lane order, NOT sorted() ("k10" < "k2" lexically)
    return [StateDelta(self.table_id, keys, vals, tombstone, key_names)]


def build_restored_agg(cap: int, calls, dtypes, key_dtypes, key_cols, value_cols,
                       minput_k: int = 32, device="cuda"):
    """Rebuild (table, state, minput) at capacity ``cap`` from recovered
    rows: kernel A inserts the keys, kernel R lands every lane's rows at
    their slots in one launch (``live`` = row_count > 0, ``stored`` set,
    no ``dirty`` and no ``minmax_retracted``)."""
    dev = resolve_device(device)
    n = len(next(iter(key_cols.values()))) if key_cols else 0
    table = HashTable.create(cap, key_dtypes, device=dev)
    state = agg_ops.create_state(cap, calls, dtypes, dev)
    minput = mi_ops.create_minput(cap, minput_k, calls, dtypes, dev)
    if not n:
        return table, state, minput
    table, slots = insert_keys(table, key_cols, n)
    scatter_agg_rows(table, state, minput, slots, value_cols, calls, dtypes, n)
    return table, state, minput


def scatter_agg_rows(table, state, minput, slots, value_cols, calls, dtypes, n: int) -> None:
    """Land ``n`` stored rows (the reference's dtypes) at ``slots`` in one
    launch of kernel R: every lane, the multisets' 2-D rows, ``live =
    row_count > 0`` and ``stored``. A slot < 0 drops its row."""
    fx = _float_lanes(agg_ops.float_extreme_meta(calls, dtypes))

    def rows(name):
        a = np.asarray(value_cols[name])
        return order_key_from_reference(a) if name in fx else a

    dst = {"row_count": state.row_count}
    for name, a in state.accums.items():
        dst[f"acc_{name}"] = a
        dst[f"em_{name}"] = state.emitted[name]
    for name, a in state.nonnull.items():
        dst[f"nn_{name}"] = a
        dst[f"ei_{name}"] = state.emitted_isnull[name]
    dst["ev"] = state.emitted_valid
    for name, (v, c) in minput.items():
        dst[f"miv_{name}"] = v
        dst[f"mic_{name}"] = c
    src = {name: rows(name) for name in dst}
    dst["live"], src["live"] = table.live, src["row_count"] > 0
    dst["stored"], src["stored"] = state.stored, np.ones(n, np.bool_)
    scatter_rows(dst, slots, src)


def _agg_restore_state(self, table_id, key_cols, value_cols) -> None:
    """Rebuild device table + state from recovered rows, and the host
    bounds the fused flush rounds are sized from."""
    n = len(next(iter(key_cols.values()))) if key_cols else 0
    key_dtypes = tuple(k.dtype for k in self.table.keys)
    cap = grow_pow2(n, self.table.capacity, GROW_AT)
    self.table, self.state, self.minput = build_restored_agg(
        cap, self.calls, self._dtypes, key_dtypes, key_cols, value_cols, self.minput_k,
        device=self.device,
    )
    self.dropped = torch.zeros((), dtype=torch.bool, device=self.device)
    self.mi_bad = torch.zeros((), dtype=torch.bool, device=self.device)
    self._insert_bound = self._occ_note = int(n)
    self._dirty_bound = 0  # restored groups carry no unflushed change
    self._evicted = set()  # every stored group is resident again


def _agg_digest_lanes(self):
    return integrity.agg_lanes(self.table, self.state, self._float_extremes)


def _agg_state_digest(self) -> int:
    """Host twin of the fused digest lane (``integrity.agg_lanes`` fold)."""
    return integrity.host_digest(*integrity.host_lanes(*_agg_digest_lanes(self)))


HashAggExecutor.checkpoint_delta = _agg_checkpoint_delta
HashAggExecutor.restore_state = _agg_restore_state
HashAggExecutor.digest_lanes = _agg_digest_lanes
HashAggExecutor.state_digest = _agg_state_digest
