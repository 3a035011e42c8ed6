"""HashJoin executor — streaming two-sided equi-join with retraction.

Port of ``risingwave_tpu/executors/hash_join.py`` (``JOIN_TYPES`` :79,
``join_step_fn`` :91, ``HashJoinExecutor`` :290, ``_plan_side_at_barrier``
:809, ``_on_barrier_scalars`` :832, ``on_watermark`` :858,
``_join_digest_lanes`` and ``_join_state_digest`` :1102-1130). Reference:
src/stream/src/executor/hash_join.rs:129 with the degree tables of
join/hash_join.rs:157 — INNER, LEFT/RIGHT/FULL OUTER, LEFT/RIGHT SEMI
and LEFT/RIGHT ANTI. Each arriving chunk probes the other side and
emits, then updates its own side's multiset state.

Per chunk, three emission groups in one fixed ``out_cap`` chunk, in
the reference's order: kernel M writes the pairs (one row per (probe
row, stored match), the probe row's sign) and then group 2 (the probe
rows judged by their match count: an outer join's NULL-padded rows,
semi or anti rows); kernel P bumps the other side's per-row degrees by
the chunk's net signed matches and writes group 3 (the stored rows
whose degree crossed zero: an outer join's pad retracted or revived, a
semi or anti row emitted or retracted). Then kernels A and L fold the
chunk into its own side, an inserted row's degree seeded with its
match count (``ops/join.py``). Latches (bucket overflow, inconsistent
deletes, emission overflow) stay on the device and raise at the barrier.
A watermark on a window column expires that side's closed keys (kernel
O). Checkpoint and restore (``hash_join.py:891-1130``): each side stages
its changed keys with their whole buckets as 2-D rows (``rv``, ``deg``,
``r_*``, ``n_*``) through kernel R, and a restore lands them at the
same in-bucket positions. ``load_reference_state`` takes over a
reference executor's sides.

The cold tier (``hash_join.py:400-415, :516-520, :601-791, :869-876,
:1015-1099``): setting ``cold_get_rows`` (``CheckpointManager.get_rows``)
arms the hooks. ``evict_cold`` drops each side's durable keys (stored,
not sdirty, degrees unmoved): kernel AG's select gives the hot mask and
the durable slots in one count read, the keys are gathered (kernel R)
into the side's ``_evicted`` set, and the side is rebuilt holding its
hot keys at ``grow_pow2(n_hot, 2^10)`` slots, each bucket at its
positions (kernels A and I). A chunk touching an evicted key faults the
key's stored bucket back in on both sides first (A, then R's scatter
with ``live`` and ``stored``). A watermark closing evicted keys moves
them to ``_cold_tombstones``, staged by the next checkpoint unless the
key is resident again.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.ops.checkpoint import (
    insert_keys,
    mark_checkpointed,
    scatter_rows,
    stage_select,
)
from risingwave_tpu_torch.array.chunk import _numpy_dtype
from risingwave_tpu_torch.ops.cold_tier import JOIN, cold_select, tensor_nbytes
from risingwave_tpu_torch.ops.hash_table import lookup, read_scalars, stage_scalars
from risingwave_tpu_torch.ops.join import (
    G2_ANTI,
    G2_NONE,
    G2_OUTER,
    G2_SEMI,
    G3_ANTI,
    G3_NONE,
    G3_OUTER,
    G3_SEMI,
    JoinSide,
    apply_side,
    degree_emit,
    expire_keys,
    probe_pairs,
    rebuild_side,
    regrow,
    survivors,
)
from risingwave_tpu_torch.runtime.bucketing import BucketAllocator, BucketPolicy
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    StateDelta,
    grow_pow2,
    host_key_value,
    host_key_view,
    lanes_from_host_keys,
    pull_rows,
)

GROW_AT = 0.5
# mid-epoch rebuild only when the host insert bound nears the table
HARD_GROW_AT = 0.75

JOIN_TYPES = (
    "inner", "left", "right", "full", "left_semi", "left_anti", "right_semi", "right_anti",
)


def _modes(join_type: str, arrival: str):
    """The reference's per-arrival switches (``hash_join.py:121-133``)
    as ``(pairs_on, group2, group3, need_degree, own_outer,
    other_outer)``; ``group2``/``group3`` are ``ops/join.py``'s G2_/G3_
    modes (G3_NONE: degrees only, no emission)."""
    semi, anti = join_type.endswith("semi"), join_type.endswith("anti")
    drive = "l" if join_type.startswith("left") else "r"
    own_outer = join_type == "full" or (join_type, arrival) in (("left", "l"), ("right", "r"))
    other_outer = join_type == "full" or (join_type, arrival) in (("left", "r"), ("right", "l"))
    group2 = G2_NONE
    if own_outer:
        group2 = G2_OUTER
    elif arrival == drive and (semi or anti):
        group2 = G2_SEMI if semi else G2_ANTI
    group3 = G3_NONE
    if other_outer:
        group3 = G3_OUTER
    elif arrival != drive and (semi or anti):
        group3 = G3_SEMI if semi else G3_ANTI
    return (not (semi or anti), group2, group3, join_type != "inner", own_outer, other_outer)


def join_step_fn(
    own: JoinSide,
    other: JoinSide,
    chunk: StreamChunk,
    own_keys: Tuple[str, ...],
    own_names: Tuple[str, ...],
    out_names: Tuple[str, ...],
    out_cap: int,
    em_overflow: torch.Tensor,
    join_type: str = "inner",
    join_rows: Optional[torch.Tensor] = None,
    arrival: str = "l",
):
    """One chunk arriving on side ``arrival`` ("l" or "r"): probe the
    other side and emit groups 1-2 (kernel M), update the other side's
    degrees and emit group 3 (kernel P, outer/semi/anti only), then fold
    the chunk into its own side (kernels A, L), all in place.
    ``em_overflow`` is the () bool emission-overflow latch; ``join_rows``,
    if given, a () int64 counter of the rows emitted. Returns ``(own,
    other, out)``."""
    if join_type not in JOIN_TYPES:
        raise ValueError(f"unknown join type {join_type!r}")
    pairs_on, group2, group3, need_degree, own_outer, other_outer = _modes(join_type, arrival)
    key_cols = tuple(chunk.col(k) for k in own_keys)
    # SQL equi-join: NULL keys match nothing and need no state
    valid = chunk.valid
    for k in own_keys:
        lane = chunk.nulls.get(k)
        if lane is not None:
            valid = valid & ~lane
    own_cols = {name: chunk.col(name) for name in own_names}
    own_nulls = {name: lane for name, lane in chunk.nulls.items() if name in own_names}
    # the output's null lanes: every group's, in output order
    with_null = set()
    if pairs_on:
        with_null |= set(own_nulls) | set(other.row_nulls)
    if group2 != G2_NONE:
        with_null |= set(own_nulls) | (set(other.rows) if own_outer else set())
    if group3 != G3_NONE:
        with_null |= set(other.row_nulls) | (set(own_names) if other_outer else set())
    null_names = tuple(n for n in out_names if n in with_null)
    probed = probe_pairs(
        other, key_cols, valid, chunk.ops, own_cols, own_nulls, out_names, out_cap,
        em_overflow, join_rows, null_names, pairs_on, group2,
    )
    if need_degree:
        degree_emit(other, probed, chunk.ops, out_cap, em_overflow, join_rows, group3)
    own = apply_side(own, key_cols, own_cols, own_nulls, valid, chunk.ops, own_names,
                     init_degree=probed.mc if need_degree else None)
    out = StreamChunk(columns=probed.cols, valid=probed.valid, nulls=probed.nulls,
                      ops=probed.ops)
    return own, other, out


class HashJoinExecutor(Executor, Checkpointable):
    """Streaming equi-join of two inputs, of any of ``JOIN_TYPES``.

    ``left_keys``/``right_keys`` pair positionally (equal dtypes);
    ``left_dtypes``/``right_dtypes`` list every stored and emitted
    column of a side (names disjoint across sides). ``capacity`` is each
    side's key-table capacity, ``fanout`` the per-key row bound,
    ``out_cap`` the rows of one emission chunk. A semi or anti join
    emits its driving side's columns only. Each side's capacity
    walks its own bucket lattice (the reference's unbucketed twin is not
    ported). ``window_cols`` = (left column, right column): a watermark
    on either expires that side's keys below it."""

    def __init__(
        self,
        left_keys: Sequence[str],
        right_keys: Sequence[str],
        left_dtypes: Dict[str, torch.dtype],
        right_dtypes: Dict[str, torch.dtype],
        capacity: int = 1 << 15,
        fanout: int = 16,
        out_cap: int = 1 << 14,
        left_nullable: Sequence[str] = (),
        right_nullable: Sequence[str] = (),
        window_cols: Optional[Tuple[str, str]] = None,
        join_type: str = "inner",
        table_id: str = "hash_join",
        bucket_policy: Optional[BucketPolicy] = None,
        device="cuda",
    ):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        if set(left_dtypes) & set(right_dtypes):
            raise ValueError(f"overlapping output columns: {set(left_dtypes) & set(right_dtypes)}")
        self.device = resolve_device(device)
        self.table_id = table_id
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
        self.window_cols = window_cols
        lk = tuple(left_dtypes[k] for k in self.left_keys)
        rk = tuple(right_dtypes[k] for k in self.right_keys)
        if lk != rk:
            raise ValueError(f"join key dtype mismatch: {lk} vs {rk}")
        self.left = JoinSide.create(
            capacity, fanout, lk, {n: left_dtypes[n] for n in self.left_names},
            nullable=left_nullable, device=self.device,
        )
        self.right = JoinSide.create(
            capacity, fanout, rk, {n: right_dtypes[n] for n in self.right_names},
            nullable=right_nullable, device=self.device,
        )
        policy = bucket_policy or BucketPolicy.from_capacity(capacity, grow_at=GROW_AT)
        self._buckets = {"l": BucketAllocator(policy), "r": BucketAllocator(policy)}
        self._bound = {"l": 0, "r": 0}
        self._occ_note = {"l": 0, "r": 0}  # true claimed at the last barrier
        self._grew_midepoch = {"l": False, "r": False}  # one bump per epoch
        self._em_overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        self._wm = {"l": None, "r": None, "out": None}
        # the cold tier: setting ``cold_get_rows`` binds the hooks; the
        # evicted keys of each side are host_key_view tuples
        self._evicted = {"left": set(), "right": set()}
        self._cold_tombstones: Dict[str, list] = {}
        self._cold_apply_hook = None  # _fault_in when armed
        self._cold_expire_hook = None  # _expire_evicted when armed
        self.cold_get_rows = None
        # the tier's work so far, counted on the host
        self.cold_counts = {"evicted": 0, "faulted_in": 0, "cold_tombstones": 0}

    @property
    def cold_get_rows(self):
        return self._cold_get_rows

    @cold_get_rows.setter
    def cold_get_rows(self, fn) -> None:
        self._cold_get_rows = fn
        armed = fn is not None
        self._cold_apply_hook = self._fault_in if armed else None
        self._cold_expire_hook = self._expire_evicted if armed else None

    def load_reference_state(self, np_arrays) -> None:
        """Take over the reference executor's two sides, given as numpy
        arrays ``{"left": ..., "right": ...}`` (the reference's
        ``JoinSide`` with numpy leaves, or dicts of its fields; see
        ``JoinSide.from_reference_arrays``). Every key keeps its slot,
        every row its bucket position and degree."""
        for s, name in (("l", "left"), ("r", "right")):
            side = JoinSide.from_reference_arrays(np_arrays[name], self.device)
            self._set_side(s, side)
            claimed = int(side.table.occupancy())
            self._bound[s] = self._occ_note[s] = claimed

    def side(self, s: str) -> JoinSide:
        return self.left if s == "l" else self.right

    def _set_side(self, s: str, side: JoinSide) -> None:
        if s == "l":
            self.left = side
        else:
            self.right = side

    def trace_contract(self):
        """What fusion reads of the join (reference :430): every emission
        chunk has ``out_cap`` rows, so a device MV fed by the join stacks
        them into one fused program (``fuse_chain``). The analysis
        layers' trace step is not ported (ROADMAP S8)."""
        return {
            "kind": "device",
            "state": (self.left, self.right),
            "donate": True,
            "emission": "fixed",
            "emission_caps": (self.out_cap,),
        }

    # -- data ------------------------------------------------------------
    def apply_left(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._apply("l", chunk)

    def apply_right(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._apply("r", chunk)

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        raise TypeError("HashJoin is two-input: use apply_left/apply_right")

    def _apply(self, s: str, chunk: StreamChunk) -> List[StreamChunk]:
        if self._cold_apply_hook is not None:
            # the chunk probes the other side and appends to its own: both
            # sides' evicted buckets of its keys come back first
            self._cold_apply_hook(s, chunk)
        self._maybe_grow(s, chunk.capacity)
        own, other, out = join_step_fn(
            self.side(s), self.side("r" if s == "l" else "l"), chunk,
            self.left_keys if s == "l" else self.right_keys,
            self.left_names if s == "l" else self.right_names,
            self.out_names, self.out_cap, self._em_overflow, self.join_type, arrival=s,
        )
        self._set_side(s, own)
        self._bound[s] += chunk.capacity
        return [out]

    def _grow_hint(self, s: str, incoming: int) -> None:
        """The fused program's pre-dispatch growth bookkeeping, with no
        device read: at most one one-bucket bump per side per epoch;
        ordinary growth resolves at the barrier from the staged notes."""
        own = self.side(s)
        cap = own.capacity
        bound = min(self._bound[s], cap)
        self._bound[s] = bound
        if bound + incoming > cap * HARD_GROW_AT and cap < self._buckets[s].policy.min_cap:
            # a side an eviction shrank below its lattice: one bump cannot
            # hold an epoch, so it is planned back from the host bound (the
            # reference bumps once here and the program overflows the side)
            new_cap = self._buckets[s].plan(cap, incoming, bound, bound)
            if new_cap is not None and new_cap != cap:
                self._set_side(s, regrow(own, new_cap, own.fanout))
            return
        if self._grew_midepoch[s] or bound + incoming <= cap * HARD_GROW_AT:
            return
        new_cap = self._buckets[s].bump(cap)
        if new_cap is not None:
            self._set_side(s, regrow(own, new_cap, own.fanout))
            self._bound[s] = min(bound, new_cap)
        self._grew_midepoch[s] = True

    def _maybe_grow(self, s: str, incoming: int) -> None:
        """Interpreted-path growth: when the trigger trips, one packed
        blocking read of the true occupancy, then the plan."""
        own = self.side(s)
        cap = own.capacity
        alloc = self._buckets[s]
        if not alloc.should_plan(cap, self._bound[s], incoming):
            return
        claimed, surv = read_scalars(own.table.occupancy(), survivors(own))
        new_cap = alloc.plan(cap, incoming, claimed, surv)
        if new_cap is not None:
            own = regrow(own, new_cap, own.fanout)
            self._set_side(s, own)
            claimed = int(own.table.occupancy())
        self._bound[s] = claimed

    # -- control ---------------------------------------------------------
    def on_barrier(self, barrier) -> List[StreamChunk]:
        l, r = self.left, self.right
        self._staged_scalars = stage_scalars(
            self._em_overflow, l.overflow, l.inconsistent, r.overflow, r.inconsistent,
            l.table.occupancy(), r.table.occupancy(), survivors(l), survivors(r),
        )
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return []

    def _plan_side_at_barrier(self, s: str, claimed: int, surv: int) -> None:
        """Barrier-boundary capacity planning from the true occupancy
        note: grow past the load factor, apply a pending lazy shrink."""
        own = self.side(s)
        cap = own.capacity
        epoch_inc = max(self._bound[s] - self._occ_note[s], 0)
        self._occ_note[s] = claimed
        self._bound[s] = claimed
        alloc = self._buckets[s]
        alloc.note_barrier(cap, claimed)
        new_cap = alloc.plan(cap, 0, claimed, surv, margin=max(claimed, epoch_inc))
        if new_cap is not None and new_cap != cap:
            self._set_side(s, regrow(own, new_cap, own.fanout))

    def _on_barrier_scalars(self, vals) -> None:
        em, lo, li, ro, ri, cl, cr, sl, sr = vals
        self._grew_midepoch = {"l": False, "r": False}
        self._plan_side_at_barrier("l", int(cl), int(sl))
        self._plan_side_at_barrier("r", int(cr), int(sr))
        if em:
            raise RuntimeError(
                "join emission overflowed out_cap within one chunk; "
                "raise out_cap or shrink source chunks"
            )
        for name, ovf, inc in (("left", lo, li), ("right", ro, ri)):
            if ovf:
                raise RuntimeError(
                    f"{name} join side overflowed (bucket fanout or probe chain); "
                    "grow fanout/capacity"
                )
            if inc:
                raise RuntimeError(
                    f"{name} join side saw a DELETE matching no stored row "
                    "(inconsistent input stream)"
                )

    def on_watermark(self, watermark: Watermark):
        """Expire the matching side's closed windows (kernel O); emit a
        downstream watermark on the left window column once both sides
        passed a new minimum (per-input watermark alignment: the output
        watermark is the minimum over the inputs)."""
        if self.window_cols is None or watermark.column not in self.window_cols:
            return watermark, []
        s = "l" if watermark.column == self.window_cols[0] else "r"
        pos = self._key_index(s, self.window_cols[0 if s == "l" else 1])
        self._set_side(s, expire_keys(self.side(s), pos, watermark.value))
        if self._cold_expire_hook is not None:
            self._cold_expire_hook("left" if s == "l" else "right", pos, int(watermark.value))
        self._wm[s] = watermark.value
        if self._wm["l"] is None or self._wm["r"] is None:
            return None, []
        aligned = min(self._wm["l"], self._wm["r"])
        if self._wm["out"] is not None and aligned <= self._wm["out"]:
            return None, []
        self._wm["out"] = aligned
        return Watermark(self.window_cols[0], aligned), []

    def _key_index(self, side: str, name: str) -> int:
        keys = self.left_keys if side == "l" else self.right_keys
        return keys.index(name)

    # -- the cold tier -------------------------------------------------
    def state_nbytes(self) -> int:
        """Device bytes of both sides (from the tensors' sizes)."""
        return tensor_nbytes((self.left, self.right))

    def evict_cold(self) -> int:
        """Drop every durable key's bucket from the card, each side
        rebuilt to its hot set. Returns the keys evicted."""
        if self.cold_get_rows is None:
            raise RuntimeError("evict_cold needs cold_get_rows")
        return self._evict_side("left") + self._evict_side("right")

    def _evict_side(self, name: str) -> int:
        s = "l" if name == "left" else "r"
        side = self.side(s)
        got = cold_select(JOIN, side.table.fp1, side.table.live, side.sdirty, side.stored,
                          ddirty=side.ddirty)
        if not got.n_counted:
            return 0
        keys = pull_rows({f"k{i}": lane for i, lane in enumerate(side.table.keys)}, got.sel)
        views = [host_key_view(keys[f"k{i}"]).tolist() for i in range(len(side.table.keys))]
        self._evicted[name].update(zip(*views))
        fresh = rebuild_side(side, got.hot, grow_pow2(got.n_hot, 1 << 10, GROW_AT))
        self._set_side(s, fresh)
        self._bound[s] = int(fresh.table.occupancy())
        self.cold_counts["evicted"] += got.n_counted
        return got.n_counted

    def _expire_evicted(self, name: str, pos: int, cutoff: int) -> None:
        """A watermark closes evicted keys too: they leave the evicted set
        and their stored rows get tombstones at the next checkpoint, so a
        recovery does not bring closed windows back. Float keys compare
        in the numeric domain (the tuples hold bit patterns)."""
        side = getattr(self, name)
        dt = _numpy_dtype(side.table.keys[pos].dtype)
        ev = self._evicted[name]
        closed = {t for t in ev if host_key_value(t[pos], dt) < cutoff}
        if closed:
            ev.difference_update(closed)
            self._cold_tombstones.setdefault(name, []).extend(closed)
            self.cold_counts["cold_tombstones"] += len(closed)

    def _fault_in(self, s: str, chunk: StreamChunk) -> None:
        if not (self._evicted["left"] or self._evicted["right"]):
            return  # nothing evicted: the chunk stays on the card
        own_keys = self.left_keys if s == "l" else self.right_keys
        sel = np.flatnonzero(chunk.valid.cpu().numpy())
        cols = [host_key_view(chunk.col(k).cpu().numpy())[sel].tolist() for k in own_keys]
        touched = set(zip(*cols))
        for name in ("left", "right"):
            hits = touched & self._evicted[name]
            if hits:
                self._restore_cold_keys(name, sorted(hits))

    def _restore_cold_keys(self, name: str, key_tuples) -> None:
        """The evicted keys' stored buckets back on the card: kernel A
        inserts the keys found in the store, kernel R lands their bucket
        rows, degrees, ``live`` and ``stored`` in one launch."""
        s = "l" if name == "left" else "r"
        self._maybe_grow(s, len(key_tuples))
        side = self.side(s)
        lanes_np = lanes_from_host_keys(key_tuples,
                                        [_numpy_dtype(k.dtype) for k in side.table.keys])
        found, vals = self.cold_get_rows(f"{self.table_id}.{name}", dict(lanes_np))
        nt = int(found.sum())
        if nt:
            keys = {k: v[found] for k, v in lanes_np.items()}
            side.table, slots = insert_keys(side.table, keys, nt)
            _side_scatter(side, side.table, slots,
                          {k: np.asarray(v)[found] for k, v in vals.items()}, nt)
        self._bound[s] += nt
        self.cold_counts["faulted_in"] += nt
        self._evicted[name].difference_update(key_tuples)

    # -- integrity --------------------------------------------------------
    def digest_lanes(self):
        """Both sides as one lane set (``l_``/``r_`` prefixes), with the
        two sides' live masks."""
        ll, llive = integrity.join_side_lanes(self.left)
        rl, rlive = integrity.join_side_lanes(self.right)
        lanes = {f"l_{k}": v for k, v in ll.items()}
        lanes.update({f"r_{k}": v for k, v in rl.items()})
        return lanes, llive, rlive

    def side_digests(self) -> Tuple[int, int]:
        """numpy ``host_digest`` of each side's lanes (what the fused
        program stages per side)."""
        return tuple(
            integrity.host_digest(*integrity.host_lanes(*integrity.join_side_lanes(side)))
            for side in (self.left, self.right)
        )

    def state_digest(self) -> int:
        """Host twin of the fused per-side digest lanes: the two sides'
        digests XOR together."""
        ld, rd = self.side_digests()
        return ld ^ rd


# -- checkpoint/restore (StateTable integration) -------------------------
def _side_delta(side: JoinSide, table_id: str) -> Optional[StateDelta]:
    """Stage one side's changed keys: the whole bucket rides as 2-D value
    lanes (rows re-land at the same in-bucket positions on restore, so
    emitted pair identity is stable). Kernel R selects, gathers and
    flips the marks eagerly (see StateDelta's durability contract), in
    place. A key whose stored rows' degrees moved (``ddirty``, set by
    kernel P) stages too: the reference stages only ``sdirty`` keys, so
    its recovered outer, semi and anti joins can hold stale degrees.
    Returns the delta or None."""
    sel, tomb, n, n_dirty = stage_select(side.sdirty, (side.table.live,), side.stored,
                                         side.ddirty)
    if not n_dirty:
        return None
    lanes = {f"k{i}": lane for i, lane in enumerate(side.table.keys)}
    key_names = tuple(lanes)
    lanes["rv"] = side.row_valid
    lanes["deg"] = side.degree
    for name, a in side.rows.items():
        lanes[f"r_{name}"] = a
    for name, a in side.row_nulls.items():
        lanes[f"n_{name}"] = a
    pulled = pull_rows(lanes, sel, {"tombstone": tomb})
    tombstone = pulled.pop("tombstone")
    mark_checkpointed(side.stored, side.sdirty, sel, tomb, side.ddirty)
    keys = {k: pulled[k] for k in key_names}
    vals = {k: v for k, v in pulled.items() if k not in key_names}
    return StateDelta(table_id, keys, vals, tombstone, key_names)


def _side_restore(side: JoinSide, key_cols, value_cols) -> JoinSide:
    """Rebuild a JoinSide from recovered rows (fresh table, same
    capacity and fanout unless growth is needed): kernel A inserts the
    keys, kernel R lands every bucket lane at its slot in one launch."""
    n = len(next(iter(key_cols.values()))) if key_cols else 0
    fanout = side.fanout
    if n and "rv" in value_cols and value_cols["rv"].shape[1] != fanout:
        raise ValueError(
            f"checkpoint bucket fanout {value_cols['rv'].shape[1]} != "
            f"executor fanout {fanout}: restore lands rows at their "
            "stored in-bucket positions — configure the same fanout"
        )
    cap = grow_pow2(n, side.capacity, GROW_AT)
    fresh = JoinSide.create(
        cap, fanout, tuple(k.dtype for k in side.table.keys),
        {name: a.dtype for name, a in side.rows.items()},
        nullable=tuple(side.row_nulls), device=side.device,
    )
    if not n:
        return fresh
    table, slots = insert_keys(fresh.table, key_cols, n)
    _side_scatter(fresh, table, slots, value_cols, n)
    fresh.table = table
    return fresh


def _side_scatter(side: JoinSide, table, slots, value_cols, n: int) -> None:
    """Land ``n`` stored buckets at ``slots`` of ``table`` (the side's
    table) in one launch of kernel R: the 2-D rows, their NULL flags and
    ``rv``, the degrees, ``live`` and ``stored``."""
    dst = {f"r_{name}": a for name, a in side.rows.items()}
    dst.update({f"n_{name}": a for name, a in side.row_nulls.items()})
    dst["rv"] = side.row_valid
    src = {name: value_cols[name] for name in dst}
    # older checkpoints predate the degree lane; it stays zero then
    if "deg" in value_cols:
        dst["deg"], src["deg"] = side.degree, value_cols["deg"]
    dst["live"], src["live"] = table.live, np.ones(n, np.bool_)
    dst["stored"], src["stored"] = side.stored, np.ones(n, np.bool_)
    scatter_rows(dst, slots, src)


def _join_checkpoint_table_ids(self):
    return [f"{self.table_id}.left", f"{self.table_id}.right"]


def _join_checkpoint_delta(self):
    out = []
    for name in ("left", "right"):
        got = _side_delta(getattr(self, name), f"{self.table_id}.{name}")
        if got is not None:
            out.append(got)
    # evicted keys a watermark closed live only in the store: explicit
    # tombstones keep a recovery from bringing closed windows back
    for name, tuples in self._cold_tombstones.items():
        if tuples:
            _stage_cold_tombstones(self, name, tuples, out)
    self._cold_tombstones = {}
    return out


def _stage_cold_tombstones(join, name: str, tuples, out: List[StateDelta]) -> None:
    """Append tombstones of the closed evicted keys ``tuples`` to the
    side's delta in ``out`` (or a delta of their own). A key re-created
    since (a late arrival) is resident and stages itself through
    ``_side_delta``: a tombstone beside it would make point reads and
    merge reads disagree."""
    side = getattr(join, name)
    dtypes = [_numpy_dtype(k.dtype) for k in side.table.keys]
    lanes_np = lanes_from_host_keys(tuples, dtypes)
    dev = side.device
    slots, _ = lookup(side.table, tuple(torch.from_numpy(lanes_np[f"k{i}"]).to(dev)
                                        for i in range(len(dtypes))),
                      torch.ones(len(tuples), dtype=torch.bool, device=dev))
    resident = (slots >= 0).cpu().numpy()
    tuples = [t for t, r in zip(tuples, resident) if not r]
    if not tuples:
        return
    tid = f"{join.table_id}.{name}"
    keys = lanes_from_host_keys(tuples, dtypes)
    n, k = len(tuples), side.fanout
    vals = {"rv": np.zeros((n, k), np.bool_), "deg": np.zeros((n, k), np.int32)}
    for nm, a in side.rows.items():
        vals[f"r_{nm}"] = np.zeros((n, k), _numpy_dtype(a.dtype))
    for nm in side.row_nulls:
        vals[f"n_{nm}"] = np.zeros((n, k), np.bool_)
    tomb = np.ones(n, bool)
    prev = next((d for d in out if d.table_id == tid), None)
    if prev is None:
        out.append(StateDelta(tid, keys, vals, tomb, tuple(keys)))
        return
    out[out.index(prev)] = StateDelta(
        tid,
        {c: np.concatenate([prev.key_cols[c], keys[c]]) for c in prev.key_cols},
        {c: np.concatenate([prev.value_cols[c], vals[c]]) for c in prev.value_cols},
        np.concatenate([prev.tombstone, tomb]),
        prev.key_order,
    )


def _join_restore_state(self, table_id, key_cols, value_cols):
    s = "l" if table_id.endswith(".left") else "r"
    side = _side_restore(self.side(s), key_cols, value_cols)
    self._set_side(s, side)
    self._bound[s] = self._occ_note[s] = len(next(iter(key_cols.values()))) if key_cols else 0
    # a restore brings every stored key back: none is evicted
    self._evicted = {"left": set(), "right": set()}


HashJoinExecutor.checkpoint_table_ids = _join_checkpoint_table_ids
HashJoinExecutor.checkpoint_delta = _join_checkpoint_delta
HashJoinExecutor.restore_state = _join_restore_state
