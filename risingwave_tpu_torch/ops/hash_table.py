"""Device-resident open-addressing hash table — the state substrate.

Port of ``risingwave_tpu/ops/hash_table.py``. Reference roles:
``JoinHashMap`` (src/stream/src/executor/join/hash_join.rs:157) and
HashAgg's group map (src/stream/src/executor/hash_agg.rs:49-62).

A power-of-two slot table, linear probing of at most ``MAX_PROBE``
steps, fingerprints (``hash128``: fp1 == 0 means EMPTY) plus the raw key
lanes for exact equality. Deleted keys stay claimed as tombstones
(``live`` False) until the owner rebuilds the table.

``lookup_or_insert`` is kernel A on the card (``csrc/lookup_or_insert.cu``)
and its plain PyTorch version on the CPU. Both update the table IN PLACE
(the JAX version donates the table and returns a new one); the table is
still returned so call sites read like the reference. On the card the
read-only ``lookup`` is kernel M's probe entry,
``first_occurrence_mask`` kernel J's first-occurrence entry and
``expire_table`` (watermark state cleaning) kernel O's key-table entry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, resolve_device
from risingwave_tpu_torch.array.chunk import to_device
from risingwave_tpu_torch.ops.hashing import hash128

EMPTY = 0  # fp1 value of a never-claimed slot

# Static probe bound (the reference's; load factor <= 0.5 keeps the
# expected longest probe far below it).
MAX_PROBE = 64

_GEN_LIMIT = 2**31 - 1


@dataclass
class HashTable:
    """A set of key slots; payload lanes live next to it, indexed by slot.

    Lanes (all of length capacity, a power of two):
      fp1, fp2  int32 holding the reference's uint32 fingerprints' bits
      keys      tuple of raw key lanes for exact equality
      live      bool — True once inserted, False again when deleted
      stamp     int32 claim word of kernel A: 0 = empty, -1 = being
                written, > 0 = the generation of the call that claimed
                the slot (slots imported or claimed on the CPU hold 1)
    ``claimed`` is a () int64 count of the claimed slots, kept by
    ``lookup_or_insert``; ``gen`` is the last generation handed to a
    lookup_or_insert call.
    """

    fp1: torch.Tensor
    fp2: torch.Tensor
    keys: Tuple[torch.Tensor, ...]
    live: torch.Tensor
    stamp: torch.Tensor
    claimed: torch.Tensor
    gen: int = 1

    @property
    def capacity(self) -> int:
        return self.fp1.shape[0]

    @property
    def device(self) -> torch.device:
        return self.fp1.device

    @staticmethod
    def create(capacity: int, key_dtypes: Sequence[torch.dtype], device="cuda") -> "HashTable":
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        dev = resolve_device(device)
        z = lambda d: torch.zeros(capacity, dtype=d, device=dev)
        return HashTable(
            fp1=z(torch.int32),
            fp2=z(torch.int32),
            keys=tuple(z(d) for d in key_dtypes),
            live=z(torch.bool),
            stamp=z(torch.int32),
            claimed=torch.zeros((), dtype=torch.int64, device=dev),
        )

    @staticmethod
    def from_reference_arrays(fp1, fp2, keys, live, device="cuda") -> "HashTable":
        """Build from the reference's lanes as numpy arrays (uint32
        fingerprints, key lanes, live). Keys keep their slots, so a key
        present in the reference resolves to the same slot here."""
        dev = resolve_device(device)
        put = lambda a: to_device(a, dev)
        fp1 = np.asarray(fp1, np.uint32).view(np.int32)
        return HashTable(
            fp1=put(fp1),
            fp2=put(np.asarray(fp2, np.uint32).view(np.int32)),
            keys=tuple(put(np.asarray(k)) for k in keys),
            live=put(np.asarray(live, np.bool_)),
            stamp=put((fp1 != EMPTY).astype(np.int32)),
            claimed=put(np.asarray((fp1 != EMPTY).sum(), np.int64)),
        )

    def occupancy(self) -> torch.Tensor:
        """Slots ever claimed (live + tombstones) — drives host rehash.
        The table's own () counter, not a copy: the reference's
        ``(fp1 != EMPTY).sum()`` without a pass over the table."""
        return self.claimed

    def num_live(self) -> torch.Tensor:
        return self.live.sum()


def _fingerprints(key_cols):
    h1, h2 = hash128(key_cols)
    fp1 = torch.where(h1 == 0, torch.ones_like(h1), h1)
    return h1, fp1.to(torch.int32), h2.to(torch.int32)


def _keys_match(table: HashTable, slot: torch.Tensor, key_cols) -> torch.Tensor:
    ok = torch.ones(slot.shape, dtype=torch.bool, device=slot.device)
    for tk, k in zip(table.keys, key_cols):
        stored = tk[slot]
        eq = stored == k
        if tk.dtype.is_floating_point:
            # ordered-float equality: NaN == NaN (an IEEE NaN key would
            # claim a slot, fail its own verify and re-claim forever)
            eq |= torch.isnan(stored) & torch.isnan(k)
        ok &= eq
    return ok


def lookup_or_insert(table: HashTable, key_cols, valid: torch.Tensor):
    """Batched find-or-insert. Returns ``(table, slots, found, inserted)``
    and updates ``table`` in place.

    ``slots[i]`` (int32) is -1 iff row i is invalid or its key found no
    slot within MAX_PROBE probes (the caller's overflow signal).
    ``found`` marks rows whose slot was live before the call;
    ``inserted`` marks the row that claimed a slot in this call and its
    same-key twins. A tombstoned key resolves to its slot with neither.
    """
    key_cols = tuple(key_cols)
    if len(key_cols) != len(table.keys):
        raise ValueError("key lane count differs from the table's")
    table.gen += 1
    if table.gen >= _GEN_LIMIT:  # restart generations; 1 = claimed before
        table.stamp.clamp_(max=1)
        table.gen = 2
    if valid.device.type == "cpu":
        return _lookup_or_insert_torch(table, key_cols, valid)
    if valid.device.type == "cuda":
        return _lookup_or_insert_cuda(table, key_cols, valid)
    raise ValueError(f"unsupported device {valid.device}")


def key_lane_rows(table: HashTable, key_cols, n: int, name: str):
    """Kernel descriptor rows ``(input, dtype code, table lane)`` of the
    probe key lanes, checked against the table's lanes."""
    _kernels.check_cuda(name, *key_cols, n=n)
    _kernels.check_cuda(
        name, table.fp1, table.fp2, table.live, *table.keys, n=table.capacity
    )
    rows = []
    for k, tk in zip(key_cols, table.keys):
        if k.dtype != tk.dtype:
            raise TypeError(f"key lane dtype {k.dtype} != table lane {tk.dtype}")
        rows.append((k.data_ptr(), _kernels.dtype_code(k), tk.data_ptr()))
    return rows


def _lookup_or_insert_cuda(table: HashTable, key_cols, valid):
    n = valid.shape[0]
    cap = table.capacity
    _kernels.check_cuda("lookup_or_insert", valid, n=n)
    _kernels.check_cuda("lookup_or_insert", table.stamp, n=cap)
    if table.claimed.shape != () or table.claimed.dtype != torch.int64:
        raise TypeError("claimed must be a () int64 counter")
    _kernels.check_cuda("lookup_or_insert", table.fp1, table.claimed)
    if valid.dtype != torch.bool:
        raise TypeError("valid must be a bool lane")
    lanes = key_lane_rows(table, key_cols, n, "lookup_or_insert")
    slots = torch.empty(n, dtype=torch.int32, device=valid.device)
    found = torch.empty(n, dtype=torch.bool, device=valid.device)
    inserted = torch.empty(n, dtype=torch.bool, device=valid.device)
    _kernels.call(
        "lookup_or_insert", "rw_lookup_or_insert",
        _kernels.int64_rows(lanes, 8), len(lanes), n, valid.data_ptr(),
        table.fp1.data_ptr(), table.fp2.data_ptr(), table.stamp.data_ptr(),
        table.claimed.data_ptr(), table.live.data_ptr(), cap, table.gen,
        slots.data_ptr(), found.data_ptr(), inserted.data_ptr(),
    )
    return table, slots, found, inserted


def _lookup_or_insert_torch(table: HashTable, key_cols, valid):
    """The reference's lockstep scatter-claim-verify, in plain PyTorch.

    Among rows contending for one empty slot in a probe step the one
    with the highest row index wins, as XLA's CPU scatter (last write
    wins) picks it — so on the CPU the slots equal the reference's."""
    dev = valid.device
    cap = table.capacity
    mask = cap - 1
    h1, fp1, fp2 = _fingerprints(key_cols)
    n = valid.shape[0]
    row_ids = torch.arange(n, dtype=torch.int64, device=dev)
    slots = torch.full((n,), -1, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    inserted = torch.zeros(n, dtype=torch.bool, device=dev)
    unresolved = valid.clone()
    claim = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    for t in range(MAX_PROBE):
        if not bool(unresolved.any()):
            break
        cand = (h1 + t) & mask
        slot_fp1 = table.fp1[cand]
        exact = (slot_fp1 == fp1) & (table.fp2[cand] == fp2)
        exact &= _keys_match(table, cand, key_cols)
        hit = unresolved & exact
        slots = torch.where(hit, cand, slots)
        found |= hit & table.live[cand]
        unresolved &= ~hit

        want = unresolved & (slot_fp1 == EMPTY)
        widx = cand[want]
        claim.scatter_reduce_(0, widx, row_ids[want], reduce="amax")
        won = want & (claim[cand] == row_ids)
        claim[widx] = -1
        w = cand[won]
        table.claimed += won.sum()
        table.fp1[w] = fp1[won]
        table.fp2[w] = fp2[won]
        table.stamp[w] = table.gen
        for tk, k in zip(table.keys, key_cols):
            tk[w] = k[won].to(tk.dtype)
        landed = (
            want
            & (table.fp1[cand] == fp1)
            & (table.fp2[cand] == fp2)
            & _keys_match(table, cand, key_cols)
        )
        slots = torch.where(landed, cand, slots)
        inserted |= landed
        unresolved &= ~landed
    return table, slots.to(torch.int32), found, inserted


def lookup(table: HashTable, key_cols, valid: torch.Tensor):
    """Read-only probe: ``(slots, found_live)``; slot -1 if absent (a
    probe chain ends at an EMPTY slot). Kernel M's probe entry
    (``csrc/join_probe.cu`` ``rw_lookup``) on the card, plain PyTorch on
    the CPU."""
    key_cols = tuple(key_cols)
    if len(key_cols) != len(table.keys):
        raise ValueError("key lane count differs from the table's")
    if valid.device.type == "cpu":
        return _lookup_torch(table, key_cols, valid)
    if valid.device.type == "cuda":
        return _lookup_cuda(table, key_cols, valid)
    raise ValueError(f"unsupported device {valid.device}")


def _lookup_cuda(table: HashTable, key_cols, valid):
    n = valid.shape[0]
    if valid.dtype != torch.bool:
        raise TypeError("valid must be a bool lane")
    lanes = key_lane_rows(table, key_cols, n, "lookup")
    _kernels.check_cuda("lookup", valid, table.fp1)
    slots = torch.empty(n, dtype=torch.int32, device=valid.device)
    found = torch.empty(n, dtype=torch.bool, device=valid.device)
    _kernels.call(
        "join_probe", "rw_lookup", _kernels.int64_rows(lanes, 8), len(lanes), n,
        valid.data_ptr(), table.fp1.data_ptr(), table.fp2.data_ptr(), table.live.data_ptr(),
        table.capacity, slots.data_ptr(), found.data_ptr(),
    )
    return slots, found


def _lookup_torch(table: HashTable, key_cols, valid):
    mask = table.capacity - 1
    h1, fp1, fp2 = _fingerprints(tuple(key_cols))
    n = valid.shape[0]
    slots = torch.full((n,), -1, dtype=torch.int64, device=valid.device)
    found = torch.zeros(n, dtype=torch.bool, device=valid.device)
    unresolved = valid.clone()
    for t in range(MAX_PROBE):
        if not bool(unresolved.any()):
            break
        cand = (h1 + t) & mask
        slot_fp1 = table.fp1[cand]
        exact = (slot_fp1 == fp1) & (table.fp2[cand] == fp2)
        exact &= _keys_match(table, cand, key_cols)
        hit = unresolved & exact
        slots = torch.where(hit, cand, slots)
        found |= hit & table.live[cand]
        # a probe chain ends at a truly EMPTY slot -> key absent
        unresolved &= ~hit & (slot_fp1 != EMPTY)
    return slots.to(torch.int32), found


def set_live(table: HashTable, slots: torch.Tensor, live_value) -> HashTable:
    """Mark slots live/dead in place; rows with slot -1 write nothing."""
    keep = slots >= 0
    value = torch.as_tensor(live_value, dtype=torch.bool, device=slots.device)
    if value.dim():
        value = value[keep]
    table.live[slots[keep].long()] = value
    return table


def expired_slots(table: HashTable, key_index: int, cutoff: int) -> torch.Tensor:
    """The watermark expiry's mask: live slots whose key lane
    ``key_index`` lies below ``cutoff`` (plain PyTorch)."""
    return table.live & (table.keys[key_index] < cutoff)


def expiry_key_args(name: str, table: HashTable, key_index: int, *lanes):
    """Kernel O's common arguments ``(cap, live, key lane, key code)``,
    with the table's lanes and ``lanes`` (bool sdirty-like lanes of the
    table's capacity) checked; raises on what the kernel does not take."""
    key = table.keys[key_index]
    if key.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: the window key lane must be int32 or int64, not {key.dtype}")
    _kernels.check_cuda(name, table.live, key, *lanes, n=table.capacity)
    for t in (table.live,) + lanes:
        if t.dtype != torch.bool:
            raise TypeError(f"{name}: live and mark lanes must be bool")
    return table.capacity, table.live.data_ptr(), key.data_ptr(), _kernels.dtype_code(key)


def expire_table(table: HashTable, sdirty: torch.Tensor, key_index: int, cutoff: int) -> None:
    """Watermark state cleaning of a plain key table (the dynamic
    filter's and the dedup's inline expiries), in place: every live slot
    whose key lane ``key_index`` < ``cutoff`` turns dead and sdirty.
    Kernel O's ``rw_expire_keys`` (``csrc/expire.cu``) on the card,
    plain PyTorch on the CPU."""
    dev = table.device
    if dev.type == "cpu":
        _expire_table_torch(table, sdirty, key_index, cutoff)
    elif dev.type == "cuda":
        _expire_table_cuda(table, sdirty, key_index, cutoff)
    else:
        raise ValueError(f"unsupported device {dev}")


def _expire_table_torch(table, sdirty, key_index, cutoff):
    expired = expired_slots(table, key_index, cutoff)
    table.live &= ~expired
    sdirty |= expired


def _expire_table_cuda(table, sdirty, key_index, cutoff):
    args = expiry_key_args("expire", table, key_index, sdirty)
    _kernels.call("expire", "rw_expire_keys", *args, int(cutoff), sdirty.data_ptr())


def move_slots(srcs, dsts, new_slots: torch.Tensor, keep: torch.Tensor) -> None:
    """A rebuild's lane moves, in place on ``dsts``: for every old slot
    ``i`` with ``keep[i]`` and ``new_slots[i] >= 0``, each
    ``dsts[k][new_slots[i]] = srcs[k][i]`` (the scatters of the
    reference's ``_rehash`` and ``_mv_rebuild``; ``new_slots`` from
    ``lookup_or_insert`` of the kept keys into the new table). Kernel I
    (``csrc/slot_move.cu``) on the card, plain PyTorch on the CPU."""
    if len(srcs) != len(dsts):
        raise ValueError("move_slots: one destination lane per source lane")
    if keep.device.type == "cpu":
        _move_slots_torch(srcs, dsts, new_slots, keep)
    elif keep.device.type == "cuda":
        _move_slots_cuda(srcs, dsts, new_slots, keep)
    else:
        raise ValueError(f"unsupported device {keep.device}")


def _move_slots_torch(srcs, dsts, new_slots, keep):
    ok = keep & (new_slots >= 0)
    dst = new_slots[ok].long()
    for s, d in zip(srcs, dsts):
        d[dst] = s[ok]


def _move_slots_cuda(srcs, dsts, new_slots, keep):
    n = keep.shape[0]
    if not dsts:
        return
    if keep.dtype != torch.bool or new_slots.dtype != torch.int32:
        raise TypeError("move_slots: keep must be bool and new_slots int32")
    _kernels.check_cuda("slot_move", keep, new_slots, *srcs, n=n)
    _kernels.check_cuda("slot_move", *dsts, n=dsts[0].shape[0])
    rows = []
    for s, d in zip(srcs, dsts):
        if s.dtype != d.dtype:
            raise TypeError(f"move_slots: lane dtypes differ ({s.dtype} vs {d.dtype})")
        rows.append((s.data_ptr(), d.data_ptr(), s.element_size()))
    step = _kernels.SLOT_MOVE_LANES
    for i in range(0, len(rows), step):
        part = rows[i:i + step]
        _kernels.call(
            "slot_move", "rw_slot_move", _kernels.int64_rows(part, step), len(part), n,
            new_slots.data_ptr(), keep.data_ptr(),
        )


@dataclass
class StagedScalars:
    """A packed int64 scalar lane on its way to the host: ``host`` is
    filled by an asynchronous copy that ``done`` (a CUDA event, None on
    the CPU) fences."""

    host: torch.Tensor
    done: object = None


def stage_scalars(*xs) -> StagedScalars:
    """Pack () scalars into one int64 lane and start its device->host
    copy (``ops/hash_table.py:284``); finish with ``finish_scalars``.
    On the card the copy goes into pinned memory with ``non_blocking``
    and is fenced by an event, so staging never waits for the device."""
    return stage_packed(torch.stack([torch.as_tensor(x).to(torch.int64) for x in xs]))


def stage_packed(packed: torch.Tensor) -> StagedScalars:
    """``stage_scalars`` for a lane already packed on the device."""
    if packed.device.type != "cuda":
        return StagedScalars(packed.clone())
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return StagedScalars(host, done)


def finish_scalars(staged: StagedScalars) -> list:
    """Wait for a staged lane and return it as python ints
    (``ops/hash_table.py:296``): the one sanctioned device->host read
    of a barrier."""
    if staged.done is not None:
        staged.done.synchronize()
    return staged.host.tolist()


def read_scalars(*xs) -> list:
    """ONE packed, blocking device->host read of several scalars
    (latches, occupancy counters) — stage + finish in one call."""
    return finish_scalars(stage_scalars(*xs))


def plan_rehash(
    cap: int, incoming: int, claimed: int, survivors: int, grow_at: float = 0.5
):
    """Shared growth policy: None (the next chunk still fits under the
    load factor) or the new capacity, sized from ``survivors`` so
    tombstone churn compacts in place (``new_cap == cap``)."""
    if claimed + incoming <= cap * grow_at:
        return None
    new_cap = cap
    while survivors + incoming > new_cap * grow_at:
        new_cap *= 2
    return new_cap


# kernel J's per-slot scratch value between calls (csrc/dedup_emit.cu)
FIRST_SENTINEL = 2**31 - 1


def first_scratch(capacity: int, device) -> torch.Tensor:
    """The per-slot int32 lane kernel J keeps at ``FIRST_SENTINEL``
    between calls; allocate once per table of ``capacity`` slots."""
    return torch.full((capacity,), FIRST_SENTINEL, dtype=torch.int32, device=device)


def first_occurrence_mask(
    slots: torch.Tensor, valid: torch.Tensor, scratch: torch.Tensor = None
) -> torch.Tensor:
    """True for the first valid row of each distinct slot in the batch.

    Kernel J's first-occurrence entry on the card (an atomicMin of the
    row index into ``scratch``, a ``first_scratch`` lane covering every
    slot, which the call leaves as it found it); plain PyTorch on the
    CPU, where ``scratch`` is not used."""
    if valid.device.type == "cpu":
        return _first_occurrence_torch(slots, valid)
    if valid.device.type == "cuda":
        return _first_occurrence_cuda(slots, valid, scratch)
    raise ValueError(f"unsupported device {valid.device}")


def _first_occurrence_cuda(slots, valid, scratch):
    if scratch is None:
        raise ValueError("first_occurrence_mask on the card needs a first_scratch lane")
    n = valid.shape[0]
    if valid.dtype != torch.bool or slots.dtype != torch.int32 or scratch.dtype != torch.int32:
        raise TypeError("first_occurrence_mask: bool valid, int32 slots and scratch")
    _kernels.check_cuda("first_occurrence", valid, slots, n=n)
    _kernels.check_cuda("first_occurrence", valid, scratch)
    out = torch.empty(n, dtype=torch.bool, device=valid.device)
    _kernels.call(
        "dedup_emit", "rw_first_occurrence", n, slots.data_ptr(), valid.data_ptr(),
        scratch.data_ptr(), scratch.shape[0], out.data_ptr(),
    )
    return out


def _first_occurrence_torch(slots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    ok = valid & (slots >= 0)
    key = torch.where(ok, slots.to(torch.int64), torch.full_like(slots, 2**30, dtype=torch.int64))
    order = torch.argsort(key, stable=True)
    s_sorted = key[order]
    first = ok[order].clone()
    first[1:] &= s_sorted[1:] != s_sorted[:-1]
    mask = torch.zeros_like(ok)
    mask[order] = first
    return mask


def last_occurrence_mask(slots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """True for the LAST valid row of each distinct slot in the batch —
    pk-conflict "last write wins" (materialize.rs:192 Overwrite). Plain
    PyTorch, CPU only: on the card it runs inside kernel D."""
    if valid.device.type != "cpu":
        raise NotImplementedError("last_occurrence_mask runs inside kernel D on the card")
    return _last_occurrence_torch(slots, valid)


def _last_occurrence_torch(slots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return _first_occurrence_torch(slots.flip(0), valid.flip(0)).flip(0)
