"""Two-sided streaming join state — the core of HashJoin.

Port of ``risingwave_tpu/ops/join.py`` (``JoinSide`` :54,
``_intra_chunk_rank`` :141, ``_row_fingerprint`` :178,
``_entry_matches`` :192, ``apply_side`` :215, ``gather_flat`` :394,
``probe_side`` :407, ``gather_matches`` :420, ``compact_pairs`` :429,
``regrow`` :458, ``expire_keys`` :508). Reference roles: ``JoinHashMap``
(src/stream/src/executor/join/hash_join.rs:157) and the probe/emit loop
of src/stream/src/executor/hash_join.rs:462-729.

A join side is a ``HashTable`` over the join key (slot per key) plus
row buckets: per payload column a (capacity, fanout) lane, with a
(capacity, fanout) ``row_valid`` mask and a ``degree`` lane (zeros for
an inner join; kept so the digest layout is the reference's). Inserts
fill the rank-th free bucket position, deletes clear the rank-th
exactly matching entry, probes gather the other side's bucket.

On the card: ``apply_side`` is kernel A on the key, then kernel L
(``csrc/join_apply.cu``); ``probe_pairs`` (``probe_side`` +
``gather_matches`` + ``compact_pairs``) is kernel M
(``csrc/join_probe.cu``); ``regrow`` is A, I and L's regrow entry;
``expire_keys`` (watermark state cleaning) is kernel O's join entry
(``csrc/expire.cu``). The plain PyTorch versions run on the CPU, where
``probe_side``, ``gather_matches``, ``compact_pairs`` and
``gather_flat`` exist as separate functions, as in the reference; on CUDA tensors those four
raise, since only their composition is a kernel. State is updated in
place. ``degree_apply`` (outer/semi/anti joins) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from risingwave_tpu_torch import _kernels, resolve_device
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    _lookup_torch,
    expired_slots,
    expiry_key_args,
    key_lane_rows,
    lookup_or_insert,
    move_slots,
)
from risingwave_tpu_torch.ops.hashing import hash128
from risingwave_tpu_torch.types import Op, op_sign


@dataclass
class JoinSide:
    """One side's state: key table + row buckets (see module doc).

    ``rows``/``row_nulls`` map payload column name -> (capacity, fanout)
    lanes; ``overflow`` latches bucket exhaustion or a key without a
    slot, ``inconsistent`` a delete that matched no stored row."""

    table: HashTable
    rows: Dict[str, torch.Tensor]
    row_nulls: Dict[str, torch.Tensor]
    row_valid: torch.Tensor
    overflow: torch.Tensor  # () bool
    inconsistent: torch.Tensor  # () bool
    sdirty: torch.Tensor  # (capacity,) bool
    stored: torch.Tensor  # (capacity,) bool
    degree: torch.Tensor  # (capacity, fanout) int32

    @property
    def capacity(self) -> int:
        return self.row_valid.shape[0]

    @property
    def fanout(self) -> int:
        return self.row_valid.shape[1]

    @property
    def device(self) -> torch.device:
        return self.row_valid.device

    @staticmethod
    def create(
        capacity: int,
        fanout: int,
        key_dtypes: Sequence[torch.dtype],
        payload_dtypes: Dict[str, torch.dtype],
        nullable: Sequence[str] = (),
        device="cuda",
    ) -> "JoinSide":
        dev = resolve_device(device)
        z2 = lambda d: torch.zeros((capacity, fanout), dtype=d, device=dev)
        return JoinSide(
            table=HashTable.create(capacity, key_dtypes, device=dev),
            rows={n: z2(d) for n, d in payload_dtypes.items()},
            row_nulls={n: z2(torch.bool) for n in nullable},
            row_valid=z2(torch.bool),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            inconsistent=torch.zeros((), dtype=torch.bool, device=dev),
            sdirty=torch.zeros(capacity, dtype=torch.bool, device=dev),
            stored=torch.zeros(capacity, dtype=torch.bool, device=dev),
            degree=z2(torch.int32),
        )


def survivors(side: JoinSide) -> torch.Tensor:
    """Slots a rebuild keeps (``live | sdirty``), counted on the device."""
    return (side.table.live | side.sdirty).sum()


def _cpu_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{name} is a plain PyTorch version for the CPU; on the card it runs "
            "inside kernel M (probe_pairs)"
        )


# -- plain versions of the reference's helpers ---------------------------------
def _intra_chunk_rank(slots, h1, h2, m) -> torch.Tensor:
    """rank[i] = #earlier masked rows with the same (slot, h1, h2): a
    stable lexsort by (slot << 32 | h1, h2), as the reference."""
    n = slots.shape[0]
    key = (slots.to(torch.int64) << 32) | h1.to(torch.int64)
    key = torch.where(m, key, torch.full_like(key, 1 << 62))
    h2 = h2.to(torch.int64)
    o1 = torch.argsort(h2, stable=True)
    order = o1[torch.argsort(key[o1], stable=True)]
    k_sorted, h2_sorted = key[order], h2[order]
    seq = torch.arange(n, dtype=torch.int64, device=slots.device)
    is_new = torch.ones(n, dtype=torch.bool, device=slots.device)
    is_new[1:] = (k_sorted[1:] != k_sorted[:-1]) | (h2_sorted[1:] != h2_sorted[:-1])
    start = torch.cummax(torch.where(is_new, seq, torch.zeros_like(seq)), 0).values
    rank = torch.zeros(n, dtype=torch.int64, device=slots.device)
    rank[order] = seq - start
    return rank


def _row_fingerprint(payload_cols, payload_nulls, names):
    """64 bits over the payload lanes (values zeroed under NULL), used
    only to rank same-bucket deletes; equality stays exact."""
    lanes = []
    for name in names:
        col = payload_cols[name]
        null = payload_nulls.get(name)
        if null is not None:
            col = torch.where(null, torch.zeros((), dtype=col.dtype), col)
            lanes.append(null)
        lanes.append(col)
    return hash128(tuple(lanes))


def _entry_matches(side: JoinSide, slots, payload_cols, payload_nulls, names):
    """(n, fanout) exact row equality against bucket entries (NULL == NULL)."""
    sl = slots.clamp(min=0).long()
    ok = side.row_valid[sl].clone()
    for name in names:
        stored = side.rows[name][sl]
        val = payload_cols[name][:, None]
        eq = stored == val
        if stored.dtype.is_floating_point:
            eq |= torch.isnan(stored) & torch.isnan(val)
        snull = side.row_nulls.get(name)
        if snull is not None:
            stored_null = snull[sl]
            row_null = payload_nulls.get(name)
            row_null = torch.zeros_like(val, dtype=torch.bool) if row_null is None else row_null[:, None]
            eq = torch.where(stored_null | row_null, stored_null == row_null, eq)
        ok &= eq
    return ok


# -- apply: kernel A on the key, then kernel L ----------------------------------
def apply_side(
    side: JoinSide,
    key_cols: Tuple[torch.Tensor, ...],
    payload_cols: Dict[str, torch.Tensor],
    payload_nulls: Dict[str, torch.Tensor],
    valid: torch.Tensor,
    ops: torch.Tensor,
    names: Tuple[str, ...],
) -> JoinSide:
    """Apply one chunk to its own side in place: inserts, then deletes.

    Rows are multiset entries: a valid row with op INSERT/UPDATE_INSERT
    fills the first free bucket position after the chunk's earlier
    inserts of its slot; one with DELETE/UPDATE_DELETE clears the
    matching entry after the chunk's earlier deletes of the same row, so
    an insert and a delete of one row in a chunk net out. (The
    reference takes ``signs``; a valid row's sign here is its op's.)"""
    table, slots, _, _ = lookup_or_insert(side.table, key_cols, valid)
    side.table = table
    if valid.device.type == "cpu":
        _apply_side_torch(side, slots, payload_cols, payload_nulls, valid, ops, names)
    elif valid.device.type == "cuda":
        _apply_side_cuda(side, slots, payload_cols, payload_nulls, valid, ops, names)
    else:
        raise ValueError(f"unsupported device {valid.device}")
    return side


def _apply_side_torch(side, slots, payload_cols, payload_nulls, valid, ops, names):
    signs = torch.where(valid, op_sign(ops), torch.zeros_like(ops))
    ins, dele = valid & (signs > 0), valid & (signs < 0)
    touch = ins | dele
    side.sdirty[slots[touch & (slots >= 0)].long()] = True
    side.overflow |= (touch & (slots < 0)).any()
    h1, h2 = _row_fingerprint(payload_cols, payload_nulls, names)
    fanout = side.fanout
    n = valid.shape[0]
    sl = slots.clamp(min=0).long()

    # inserts: the rank-th free position (rank by slot alone)
    zero = torch.zeros_like(h1)
    rank_i = _intra_chunk_rank(slots, zero, zero, ins)
    free = ~side.row_valid[sl]
    free_rank = torch.cumsum(free.to(torch.int64), dim=1)
    one_hot = free & (free_rank == (rank_i + 1)[:, None]) & ins[:, None]
    pos = torch.argmax(one_hot.to(torch.int8), dim=1)
    placed = one_hot.any(dim=1) & ins & (slots >= 0)
    side.overflow |= (ins & (slots >= 0) & ~placed).any()
    flat = (sl * fanout + pos)[placed]
    for name in names:
        side.rows[name].view(-1)[flat] = payload_cols[name][placed].to(side.rows[name].dtype)
    for name, lane in side.row_nulls.items():
        src = payload_nulls.get(name)
        src = torch.zeros(n, dtype=torch.bool, device=valid.device) if src is None else src
        lane.view(-1)[flat] = src[placed]
    side.row_valid.view(-1)[flat] = True
    side.degree.view(-1)[flat] = 0

    # deletes: the rank-th matching entry (rank by slot and fingerprint)
    rank_d = _intra_chunk_rank(slots, h1, h2, dele)
    match = _entry_matches(side, slots, payload_cols, payload_nulls, names)
    match &= dele[:, None] & (slots >= 0)[:, None]
    mrank = torch.cumsum(match.to(torch.int64), dim=1)
    one_hot_d = match & (mrank == (rank_d + 1)[:, None])
    dpos = torch.argmax(one_hot_d.to(torch.int8), dim=1)
    hit = one_hot_d.any(dim=1)
    side.inconsistent |= (dele & (slots >= 0) & ~hit).any()
    dflat = (sl * fanout + dpos)[hit]
    side.row_valid.view(-1)[dflat] = False
    side.degree.view(-1)[dflat] = 0

    # key liveness = bucket non-empty
    tmask = touch & (slots >= 0)
    side.table.live[slots[tmask].long()] = side.row_valid[sl].any(dim=1)[tmask]


def _payload_rows(side: JoinSide, payload_cols, payload_nulls, names, n):
    """Kernel L's payload descriptors ``(src, src_null, dtype, dst,
    dst_null)``, plus the tensors they point into."""
    rows, keep = [], []
    for name in names:
        src, dst = payload_cols[name], side.rows[name]
        if src.dtype != dst.dtype:
            src = src.to(dst.dtype)
            keep.append(src)
        snull = payload_nulls.get(name)
        dnull = side.row_nulls.get(name)
        _kernels.check_cuda("join_apply", src, *(() if snull is None else (snull,)), n=n)
        _kernels.check_cuda("join_apply", dst, *(() if dnull is None else (dnull,)))
        rows.append((
            src.data_ptr(), 0 if snull is None else snull.data_ptr(), _kernels.dtype_code(src),
            dst.data_ptr(), 0 if dnull is None else dnull.data_ptr(),
        ))
    return rows, keep


def _apply_side_cuda(side, slots, payload_cols, payload_nulls, valid, ops, names):
    n = valid.shape[0]
    dev = valid.device
    if valid.dtype != torch.bool or ops.dtype != torch.int32:
        raise TypeError("join_apply: bool valid and int32 ops lanes")
    _kernels.check_cuda("join_apply", valid, ops, slots, n=n)
    _kernels.check_cuda("join_apply", side.table.live, side.sdirty, n=side.capacity)
    _kernels.check_cuda("join_apply", side.row_valid, side.degree, side.overflow, side.inconsistent)
    pay, keep_alive = _payload_rows(side, payload_cols, payload_nulls, names, n)
    # the rank groups' table: n_groups >= 2n entries, each an owner row
    # and fanout row indices (join_apply.cu)
    n_groups = 1 << max(1, (2 * n - 1).bit_length())
    scratch = torch.empty(4 * n + n_groups * (1 + side.fanout), dtype=torch.int32, device=dev)
    fps, grp, target = scratch[:2 * n], scratch[2 * n:3 * n], scratch[3 * n:4 * n]
    owner, first = scratch[4 * n:4 * n + n_groups], scratch[4 * n + n_groups:]
    _kernels.call(
        "join_apply", "rw_join_apply", _kernels.int64_rows(pay, 8), len(pay), n,
        valid.data_ptr(), ops.data_ptr(), slots.data_ptr(), side.fanout,
        side.row_valid.data_ptr(), side.degree.data_ptr(), side.table.live.data_ptr(),
        side.sdirty.data_ptr(), side.overflow.data_ptr(), side.inconsistent.data_ptr(),
        fps.data_ptr(), grp.data_ptr(), target.data_ptr(), owner.data_ptr(), first.data_ptr(),
        n_groups,
    )
    del keep_alive  # held until the launch was enqueued


# -- probe: kernel M -------------------------------------------------------------
def gather_flat(side: JoinSide, pid: torch.Tensor, names: Sequence[str]):
    """Payload at flat (slot * fanout + pos) ids (sentinel-safe)."""
    _cpu_only("gather_flat", pid)
    safe = pid.clamp(max=side.capacity * side.fanout - 1).long()
    cols = {n: side.rows[n].reshape(-1)[safe] for n in names}
    nulls = {n: lane.reshape(-1)[safe] for n, lane in side.row_nulls.items()}
    return cols, nulls


def probe_side(other: JoinSide, key_cols, valid: torch.Tensor):
    """``(slots, match)``: each probe row's slot (clamped at 0) and the
    (n, fanout) mask of live stored rows joining it."""
    _cpu_only("probe_side", valid)
    return _probe_side_torch(other, key_cols, valid)


def _probe_side_torch(other, key_cols, valid):
    slots, found = _lookup_torch(other.table, tuple(key_cols), valid)
    sl = slots.clamp(min=0).long()
    return sl, other.row_valid[sl] & (found & valid)[:, None]


def gather_matches(other: JoinSide, sl: torch.Tensor, names: Sequence[str]):
    """(n, fanout) bucket payloads of the probed slots."""
    _cpu_only("gather_matches", sl)
    return _gather_matches_torch(other, sl, names)


def _gather_matches_torch(other, sl, names):
    cols = {n: other.rows[n][sl] for n in names}
    nulls = {n: lane[sl] for n, lane in other.row_nulls.items()}
    return cols, nulls


def compact_pairs(flat_cols, flat_nulls, flat_ops, flat_valid, out_cap: int):
    """Sparse (n * fanout) pairs into a fixed ``out_cap`` chunk, pair i
    before pair j if i < j. Returns ``(cols, nulls, ops, valid,
    overflow)``."""
    _cpu_only("compact_pairs", flat_valid)
    return _compact_pairs_torch(flat_cols, flat_nulls, flat_ops, flat_valid, out_cap)


def _compact_pairs_torch(flat_cols, flat_nulls, flat_ops, flat_valid, out_cap):
    pos = torch.cumsum(flat_valid.to(torch.int64), dim=0) - 1
    overflow = (flat_valid & (pos >= out_cap)).any()
    take = flat_valid & (pos < out_cap)
    idx = pos[take]

    def scatter(src):
        buf = torch.zeros(out_cap, dtype=src.dtype, device=src.device)
        buf[idx] = src[take]
        return buf

    cols = {n: scatter(a) for n, a in flat_cols.items()}
    nulls = {n: scatter(a) for n, a in flat_nulls.items()}
    return cols, nulls, scatter(flat_ops), scatter(flat_valid), overflow


def probe_pairs(
    other: JoinSide,
    key_cols,
    valid: torch.Tensor,
    ops: torch.Tensor,
    own_cols: Dict[str, torch.Tensor],
    own_nulls: Dict[str, torch.Tensor],
    out_names: Tuple[str, ...],
    out_cap: int,
    em_overflow: torch.Tensor,
    join_rows: Optional[torch.Tensor] = None,
):
    """The inner join's emission for one probe chunk: one row per (probe
    row, live stored match), probe row major, bucket position minor, in
    a fixed ``out_cap`` chunk. Own lanes are the probe row's, the other
    lanes the stored entry's; ops INSERT or DELETE by the probe row's
    sign. ``em_overflow`` (a () bool) latches pairs past ``out_cap``;
    ``join_rows`` (a () int64), if given, gets the pairs written added.
    Returns ``(cols, nulls, ops, valid)``; ``nulls`` has a lane for each
    output name with a null lane on either side."""
    if valid.device.type == "cpu":
        return _probe_pairs_torch(
            other, key_cols, valid, ops, own_cols, own_nulls, out_names, out_cap,
            em_overflow, join_rows,
        )
    if valid.device.type == "cuda":
        return _probe_pairs_cuda(
            other, key_cols, valid, ops, own_cols, own_nulls, out_names, out_cap,
            em_overflow, join_rows,
        )
    raise ValueError(f"unsupported device {valid.device}")


def _null_names(out_names, own_nulls, other):
    return tuple(n for n in out_names if n in own_nulls or n in other.row_nulls)


def _probe_pairs_torch(other, key_cols, valid, ops, own_cols, own_nulls, out_names, out_cap,
                       em_overflow, join_rows):
    sl, match = _probe_side_torch(other, key_cols, valid)
    other_names = tuple(n for n in out_names if n not in own_cols)
    o_cols, o_nulls = _gather_matches_torch(other, sl, other_names)
    n, fanout = match.shape
    flatm = lambda a: a.reshape(n * fanout)
    bcast = lambda a: a[:, None].expand(n, fanout)
    g_cols = {name: flatm(bcast(own_cols[name])) for name in out_names if name in own_cols}
    g_cols.update({name: flatm(o_cols[name]) for name in other_names})
    g_nulls = {name: flatm(bcast(lane)) for name, lane in own_nulls.items()}
    g_nulls.update({name: flatm(lane) for name, lane in o_nulls.items()})
    signs = op_sign(ops)
    g_ops = flatm(bcast(torch.where(signs > 0, int(Op.INSERT), int(Op.DELETE)).to(torch.int32)))
    flat_cols = {name: g_cols[name] for name in out_names}
    flat_nulls = {name: g_nulls[name] for name in _null_names(out_names, own_nulls, other)}
    cols, nulls, out_ops, out_valid, ovf = _compact_pairs_torch(
        flat_cols, flat_nulls, g_ops, flatm(match), out_cap
    )
    em_overflow |= ovf
    if join_rows is not None:
        join_rows += out_valid.sum()
    return cols, nulls, out_ops, out_valid


def _probe_pairs_cuda(other, key_cols, valid, ops, own_cols, own_nulls, out_names, out_cap,
                      em_overflow, join_rows):
    n = valid.shape[0]
    dev = valid.device
    table = other.table
    if valid.dtype != torch.bool or ops.dtype != torch.int32:
        raise TypeError("join_probe: bool valid and int32 ops lanes")
    keys = key_lane_rows(table, tuple(key_cols), n, "join_probe")
    _kernels.check_cuda("join_probe", valid, ops, n=n)
    _kernels.check_cuda("join_probe", other.row_valid, em_overflow)
    if join_rows is not None:
        if join_rows.shape != () or join_rows.dtype != torch.int64:
            raise TypeError("join_rows must be a () int64 counter")
        _kernels.check_cuda("join_probe", join_rows, em_overflow)
    cols, nulls, outs = {}, {}, []

    def out_lane(name, dst_map, own, stored, dtype):
        dst = torch.zeros(out_cap, dtype=dtype, device=dev)
        dst_map[name] = dst
        if own is not None:
            _kernels.check_cuda("join_probe", own, n=n)
            outs.append((own.data_ptr(), 0, dst.data_ptr(), dst.element_size()))
        elif stored is not None:
            _kernels.check_cuda("join_probe", stored)
            outs.append((stored.data_ptr(), 1, dst.data_ptr(), dst.element_size()))

    for name in out_names:
        own = own_cols.get(name)
        stored = other.rows[name] if own is None else None
        out_lane(name, cols, own, stored, (own if own is not None else stored).dtype)
    for name in _null_names(out_names, own_nulls, other):
        if name in own_cols:
            out_lane(name, nulls, own_nulls.get(name), None, torch.bool)
        else:
            out_lane(name, nulls, None, other.row_nulls.get(name), torch.bool)
    out_ops = torch.zeros(out_cap, dtype=torch.int32, device=dev)
    out_valid = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    tiles = -(-n // 256)
    scratch = torch.empty(2 * n + max(tiles, 1), dtype=torch.int32, device=dev)
    _kernels.call(
        "join_probe", "rw_join_probe", _kernels.int64_rows(keys, 8), len(keys), n,
        valid.data_ptr(), ops.data_ptr(), table.fp1.data_ptr(), table.fp2.data_ptr(),
        table.live.data_ptr(), table.capacity, other.row_valid.data_ptr(), other.fanout,
        _kernels.int64_rows(outs, 16), len(outs), out_cap, out_ops.data_ptr(),
        out_valid.data_ptr(), scratch[:n].data_ptr(), scratch[n:2 * n].data_ptr(),
        scratch[2 * n:].data_ptr(), em_overflow.data_ptr(),
        0 if join_rows is None else join_rows.data_ptr(),
    )
    return cols, nulls, out_ops, out_valid


# -- regrow: kernels A, I and L's move entry ----------------------------------------
def regrow(side: JoinSide, new_cap: int, new_fanout: int) -> JoinSide:
    """Rebuild into a larger table and/or wider buckets, dropping
    tombstoned keys and compacting each bucket's live entries to the
    front of the new bucket (the reference's heap growth). Returns a
    new side; the latches carry over."""
    dev = side.device
    keep = (side.table.live | side.sdirty) & (side.table.fp1 != 0)
    new = JoinSide.create(
        new_cap, new_fanout, tuple(k.dtype for k in side.table.keys),
        {n: a.dtype for n, a in side.rows.items()}, tuple(side.row_nulls), device=dev,
    )
    new.overflow.copy_(side.overflow)
    new.inconsistent.copy_(side.inconsistent)
    new.table, new_slots, _, _ = lookup_or_insert(new.table, side.table.keys, keep)
    move_slots(  # kernel I on the card
        (side.table.live, side.sdirty, side.stored),
        (new.table.live, new.sdirty, new.stored), new_slots, keep,
    )
    src = [*side.rows.values(), *side.row_nulls.values(), side.degree]
    dst = [*new.rows.values(), *new.row_nulls.values(), new.degree]
    if dev.type == "cpu":
        _regrow_entries_torch(side, new, src, dst, keep, new_slots)
    else:
        _regrow_entries_cuda(side, new, src, dst, keep, new_slots)
    return new


def _regrow_entries_torch(side, new, src, dst, keep, new_slots):
    fanout, new_fanout = side.fanout, new.fanout
    entry_pos = torch.cumsum(side.row_valid.to(torch.int64), dim=1) - 1
    entry_ok = side.row_valid & keep[:, None] & (entry_pos < new_fanout) & (new_slots >= 0)[:, None]
    dest = new_slots.to(torch.int64)[:, None].expand(-1, fanout) * new_fanout + entry_pos
    idx = dest[entry_ok]
    for s, d in zip(src, dst):
        d.view(-1)[idx] = s[entry_ok]
    new.row_valid.view(-1)[idx] = True


def _regrow_entries_cuda(side, new, src, dst, keep, new_slots):
    _kernels.check_cuda("join_apply", keep, new_slots, n=side.capacity)
    _kernels.check_cuda("join_apply", side.row_valid, new.row_valid, *src, *dst)
    rows = [(s.data_ptr(), d.data_ptr(), s.element_size()) for s, d in zip(src, dst)]
    _kernels.call(
        "join_apply", "rw_join_regrow", _kernels.int64_rows(rows, 16), len(rows),
        side.capacity, side.fanout, new.fanout, keep.data_ptr(), new_slots.data_ptr(),
        side.row_valid.data_ptr(), new.row_valid.data_ptr(),
    )


# -- watermark state cleaning: kernel O ----------------------------------------------
def expire_keys(side: JoinSide, key_index: int, cutoff: int) -> JoinSide:
    """Drop every live key whose key lane ``key_index`` < ``cutoff``, in
    place (``ops/join.py:508``): the key turns dead and sdirty, its
    bucket's ``row_valid`` entries clear and its degrees go to 0; keys
    and payload bytes stay (a tombstone keeps probe chains intact).
    Kernel O's ``rw_expire_join`` (``csrc/expire.cu``) on the card,
    plain PyTorch on the CPU."""
    dev = side.device
    if dev.type == "cpu":
        _expire_keys_torch(side, key_index, cutoff)
    elif dev.type == "cuda":
        _expire_keys_cuda(side, key_index, cutoff)
    else:
        raise ValueError(f"unsupported device {dev}")
    return side


def _expire_keys_torch(side: JoinSide, key_index: int, cutoff: int) -> None:
    expired = expired_slots(side.table, key_index, cutoff)
    side.table.live &= ~expired
    side.row_valid &= ~expired[:, None]
    side.degree.masked_fill_(expired[:, None], 0)
    side.sdirty |= expired


def _expire_keys_cuda(side: JoinSide, key_index: int, cutoff: int) -> None:
    args = expiry_key_args("expire_join", side.table, key_index, side.sdirty)
    _kernels.check_cuda("expire_join", side.row_valid, side.degree)
    if side.row_valid.dtype != torch.bool or side.degree.dtype != torch.int32:
        raise TypeError("expire_join: row_valid bool and degree int32")
    if side.row_valid.shape != side.degree.shape or side.capacity != side.table.capacity:
        raise ValueError("expire_join: row_valid and degree must be (capacity, fanout)")
    _kernels.call(
        "expire", "rw_expire_join", *args, int(cutoff), side.sdirty.data_ptr(),
        side.row_valid.data_ptr(), side.degree.data_ptr(), side.fanout,
    )
