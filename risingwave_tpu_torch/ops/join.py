"""Two-sided streaming join state — the core of HashJoin.

Port of ``risingwave_tpu/ops/join.py`` (``JoinSide`` :54,
``_intra_chunk_rank`` :141, ``_row_fingerprint`` :178,
``_entry_matches`` :192, ``apply_side`` :215, ``degree_apply`` :339,
``gather_flat`` :394, ``probe_side`` :407, ``gather_matches`` :420,
``compact_pairs`` :429, ``regrow`` :458, ``expire_keys`` :508).
Reference roles: ``JoinHashMap`` with its degree tables
(src/stream/src/executor/join/hash_join.rs:157) and the probe/emit loop
of src/stream/src/executor/hash_join.rs:462-729.

A join side is a ``HashTable`` over the join key (slot per key) plus
row buckets: per payload column a (capacity, fanout) lane, with a
(capacity, fanout) ``row_valid`` mask and a ``degree`` lane (each stored
row's match count on the other side; outer, semi and anti joins keep
it, an inner join leaves it 0). Inserts fill the rank-th free bucket
position, deletes clear the rank-th exactly matching entry, probes
gather the other side's bucket.

On the card: ``apply_side`` is kernel A on the key, then kernel L
(``csrc/join_apply.cu``; an inserted row's degree seeded from
``init_degree``); ``probe_pairs`` (``probe_side`` + ``gather_matches``
+ ``compact_pairs``: the pairs, then the own NULL-pad, semi or anti
rows) is kernel M (``csrc/join_probe.cu``); ``degree_emit``
(``degree_apply`` + ``gather_flat``: the other side's degrees, then the
zero-crossing transitions after M's rows) is kernel P
(``csrc/join_degree.cu``); ``regrow`` is A, I and L's regrow entry;
``expire_keys`` (watermark state cleaning) is kernel O's join entry
(``csrc/expire.cu``). The plain PyTorch versions run on the CPU, where
``probe_side``, ``gather_matches``, ``compact_pairs``, ``degree_apply``
and ``gather_flat`` exist as separate functions, as in the reference; on
CUDA tensors those five raise, since only their compositions are
kernels. State is updated in place.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

import numpy as np

from risingwave_tpu_torch import _kernels, resolve_device
from risingwave_tpu_torch.array.chunk import to_device
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
    # (capacity,) bool: a stored row's degree changed since the last
    # checkpoint (kernel P sets it; the reference marks nothing, so its
    # checkpoint misses those degrees); None on sides built field by field
    ddirty: Optional[torch.Tensor] = None

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
            ddirty=torch.zeros(capacity, dtype=torch.bool, device=dev),
        )

    @staticmethod
    def from_reference_arrays(side, device="cuda") -> "JoinSide":
        """Build from the reference's ``JoinSide`` with numpy leaves
        (``jax.device_get``) or a dict of its fields: ``table`` (a
        reference ``HashTable``, or a dict of ``fp1``/``fp2``/``keys``/
        ``live``), ``rows``, ``row_nulls``, ``row_valid``, ``degree``,
        ``sdirty``, ``stored`` and the ``overflow``/``inconsistent``
        latches. Every key keeps its slot and every row its position."""
        dev = resolve_device(device)
        get = side.get if isinstance(side, dict) else lambda k: getattr(side, k)
        t = get("table")
        tget = t.get if isinstance(t, dict) else lambda k: getattr(t, k)
        put = lambda a: to_device(np.array(a), dev)  # a copy; 0-d latches stay 0-d
        return JoinSide(
            table=HashTable.from_reference_arrays(
                tget("fp1"), tget("fp2"), tget("keys"), tget("live"), device=dev
            ),
            rows={n: put(np.asarray(a)) for n, a in get("rows").items()},
            row_nulls={n: put(np.asarray(a, np.bool_)) for n, a in get("row_nulls").items()},
            row_valid=put(np.asarray(get("row_valid"), np.bool_)),
            overflow=put(np.asarray(get("overflow"), np.bool_)),
            inconsistent=put(np.asarray(get("inconsistent"), np.bool_)),
            sdirty=put(np.asarray(get("sdirty"), np.bool_)),
            stored=put(np.asarray(get("stored"), np.bool_)),
            degree=put(np.asarray(get("degree"), np.int32)),
            ddirty=put(np.zeros(np.asarray(get("sdirty")).shape, np.bool_)),
        )


def survivors(side: JoinSide) -> torch.Tensor:
    """Slots a rebuild keeps (``live | sdirty``), counted on the device."""
    return (side.table.live | side.sdirty).sum()


def _cpu_only(name: str, t: torch.Tensor, kernel: str = "M (probe_pairs)") -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{name} is a plain PyTorch version for the CPU; on the card it runs "
            f"inside kernel {kernel}"
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
    init_degree: Optional[torch.Tensor] = None,
) -> JoinSide:
    """Apply one chunk to its own side in place: inserts, then deletes.

    Rows are multiset entries: a valid row with op INSERT/UPDATE_INSERT
    fills the first free bucket position after the chunk's earlier
    inserts of its slot; one with DELETE/UPDATE_DELETE clears the
    matching entry after the chunk's earlier deletes of the same row, so
    an insert and a delete of one row in a chunk net out. An inserted
    row's degree is ``init_degree`` (an (n,) int32 lane: outer, semi and
    anti joins pass each row's current match count on the other side),
    or 0 without it. (The reference takes ``signs``; a valid row's sign
    here is its op's.)"""
    table, slots, _, _ = lookup_or_insert(side.table, key_cols, valid)
    side.table = table
    args = (side, slots, payload_cols, payload_nulls, valid, ops, names, init_degree)
    if valid.device.type == "cpu":
        _apply_side_torch(*args)
    elif valid.device.type == "cuda":
        _apply_side_cuda(*args)
    else:
        raise ValueError(f"unsupported device {valid.device}")
    return side


def _apply_side_torch(side, slots, payload_cols, payload_nulls, valid, ops, names,
                      init_degree=None):
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
    side.degree.view(-1)[flat] = 0 if init_degree is None else init_degree[placed].to(torch.int32)

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


def _apply_side_cuda(side, slots, payload_cols, payload_nulls, valid, ops, names,
                     init_degree=None):
    n = valid.shape[0]
    dev = valid.device
    if valid.dtype != torch.bool or ops.dtype != torch.int32:
        raise TypeError("join_apply: bool valid and int32 ops lanes")
    _kernels.check_cuda("join_apply", valid, ops, slots, n=n)
    if init_degree is not None:
        if init_degree.dtype != torch.int32:
            raise TypeError("join_apply: init_degree must be int32")
        _kernels.check_cuda("join_apply", valid, init_degree, n=n)
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
        side.row_valid.data_ptr(), side.degree.data_ptr(),
        0 if init_degree is None else init_degree.data_ptr(), side.table.live.data_ptr(),
        side.sdirty.data_ptr(), side.overflow.data_ptr(), side.inconsistent.data_ptr(),
        fps.data_ptr(), grp.data_ptr(), target.data_ptr(), owner.data_ptr(), first.data_ptr(),
        n_groups,
    )
    del keep_alive  # held until the launch was enqueued


# -- probe: kernel M -------------------------------------------------------------
# group 2 of a probe chunk's emission (executors/hash_join.py:174-195),
# after the pairs: rows judged by their match count mc
G2_NONE, G2_OUTER, G2_SEMI, G2_ANTI = 0, 1, 2, 3
# group 3, kernel P (:197-223): the other side's zero-crossing stored rows
G3_NONE, G3_OUTER, G3_ANTI, G3_SEMI = 0, 1, 2, 3
# output lanes one rw_join_probe call writes (csrc/join_probe.cu JP_MAX_OUT)
PROBE_LANES = 32


class Probed(NamedTuple):
    """A probe chunk's emission chunk and what kernels P and L read of
    the probe: ``cols``/``nulls`` the (out_cap,) output lanes, ``ops``
    and ``valid``; ``slots`` each probe row's slot in the other side (-1
    without a live match), ``mc`` its match count (int32), ``written``
    the () int32 count of rows emitted so far (uncapped)."""

    cols: Dict[str, torch.Tensor]
    nulls: Dict[str, torch.Tensor]
    ops: torch.Tensor
    valid: torch.Tensor
    slots: torch.Tensor
    mc: torch.Tensor
    written: torch.Tensor


def gather_flat(side: JoinSide, pid: torch.Tensor, names: Sequence[str]):
    """Payload at flat (slot * fanout + pos) ids (sentinel-safe)."""
    _cpu_only("gather_flat", pid, "P (degree_emit)")
    return _gather_flat_torch(side, pid, names)


def _gather_flat_torch(side, pid, names):
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


def _sign_ops(signs: torch.Tensor) -> torch.Tensor:
    return torch.where(signs > 0, int(Op.INSERT), int(Op.DELETE)).to(torch.int32)


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
    null_names: Optional[Tuple[str, ...]] = None,
    pairs_on: bool = True,
    group2: int = G2_NONE,
) -> Probed:
    """A probe chunk's emission groups 1 and 2 in a fixed ``out_cap``
    chunk. Group 1 (``pairs_on``): one row per (probe row, live stored
    match), probe row major, bucket position minor; own lanes are the
    probe row's, the other lanes the stored entry's. Group 2 after it
    (``group2``): each valid probe row with no match (``G2_OUTER``, the
    other side's lanes NULL-padded; ``G2_ANTI``) or with one
    (``G2_SEMI``), its own lanes. Ops INSERT or DELETE by the probe
    row's sign. ``null_names`` lists the output's null lanes (default:
    the names with a null lane on either side). ``em_overflow`` (a ()
    bool) latches rows past ``out_cap``; ``join_rows`` (a () int64), if
    given, gets the rows written added."""
    if null_names is None:
        null_names = tuple(n for n in out_names if n in own_nulls or n in other.row_nulls)
    args = (other, key_cols, valid, ops, own_cols, own_nulls, out_names, null_names, out_cap,
            em_overflow, join_rows, pairs_on, group2)
    if valid.device.type == "cpu":
        return _probe_pairs_torch(*args)
    if valid.device.type == "cuda":
        return _probe_pairs_cuda(*args)
    raise ValueError(f"unsupported device {valid.device}")


def _probe_pairs_torch(other, key_cols, valid, ops, own_cols, own_nulls, out_names, null_names,
                       out_cap, em_overflow, join_rows=None, pairs_on=True, group2=G2_NONE):
    raw, found = _lookup_torch(other.table, tuple(key_cols), valid)
    found &= valid
    sl = raw.clamp(min=0).long()
    match = other.row_valid[sl] & found[:, None]
    mc = match.sum(dim=1, dtype=torch.int32)
    slots = torch.where(found, raw, torch.full_like(raw, -1))
    n, fanout = match.shape
    dev = valid.device
    other_names = tuple(nm for nm in out_names if nm not in own_cols)
    signs = op_sign(ops)
    groups = []  # (cols, nulls, ops, valid) of flat lanes
    if pairs_on:
        o_cols, o_nulls = _gather_matches_torch(other, sl, other_names)
        flatm = lambda a: a.reshape(n * fanout)
        bcast = lambda a: a[:, None].expand(n, fanout)
        g_cols = {nm: flatm(bcast(own_cols[nm])) for nm in out_names if nm in own_cols}
        g_cols.update({nm: flatm(o_cols[nm]) for nm in other_names})
        g_nulls = {nm: flatm(bcast(lane)) for nm, lane in own_nulls.items()}
        g_nulls.update({nm: flatm(lane) for nm, lane in o_nulls.items()})
        groups.append((g_cols, g_nulls, flatm(bcast(_sign_ops(signs))), flatm(match)))
    if group2 != G2_NONE:
        cond = valid & ((mc > 0) if group2 == G2_SEMI else (mc == 0))
        g_cols = {nm: own_cols[nm] for nm in out_names if nm in own_cols}
        g_nulls = dict(own_nulls)
        if group2 == G2_OUTER:  # NULL-pad the other side
            for nm in other_names:
                g_cols[nm] = torch.zeros(n, dtype=other.rows[nm].dtype, device=dev)
                g_nulls[nm] = torch.ones(n, dtype=torch.bool, device=dev)
        groups.append((g_cols, g_nulls, _sign_ops(signs), cond))

    def cat(parts, dtype):  # the groups' lanes in order; a group without the lane: zeros
        return torch.cat([torch.zeros(g[3].shape[0], dtype=dtype, device=dev)
                          if p is None else p for g, p in zip(groups, parts)]
                         + [torch.zeros(0, dtype=dtype, device=dev)])

    flat_cols = {}
    for name in out_names:
        dtype = own_cols[name].dtype if name in own_cols else other.rows[name].dtype
        flat_cols[name] = cat([g[0].get(name) for g in groups], dtype)
    flat_nulls = {name: cat([g[1].get(name) for g in groups], torch.bool) for name in null_names}
    flat_ops = cat([g[2] for g in groups], torch.int32)
    flat_valid = cat([g[3] for g in groups], torch.bool)
    cols, nulls, out_ops, out_valid, ovf = _compact_pairs_torch(
        flat_cols, flat_nulls, flat_ops, flat_valid, out_cap
    )
    total = flat_valid.sum()
    em_overflow |= ovf
    if join_rows is not None:
        join_rows += out_valid.sum()
    return Probed(cols, nulls, out_ops, out_valid, slots, mc, total.to(torch.int32))


@functools.lru_cache(maxsize=256)
def _probe_layout(dtypes: Tuple[torch.dtype, ...], out_cap: int, n: int):
    """Kernel M's one output buffer, none of it filled (the kernel writes
    every row): the look-back words (``ceil(n / 256) + 1`` int64), each
    dtype's output lanes together, 8-byte lanes first, then the int32
    lanes out_ops, slots, mc and written, then the bool lane valid.
    Returns per dtype ``(dtype, byte offset, its lanes' places in
    dtypes)``, the offset of out_ops and that of valid (the buffer's
    size less ``out_cap``)."""
    at = 8 * (max(-(-n // 256), 1) + 1)
    groups, at_ops = [], 0
    for size in (8, 4, 1):
        for dt in dict.fromkeys(d for d in dtypes if d.itemsize == size):
            js = tuple(j for j, d in enumerate(dtypes) if d == dt)
            groups.append((dt, at, js))
            at += size * out_cap * len(js)
        if size == 4:
            at_ops = at
            at += 4 * (out_cap + 2 * n + 1)
    return tuple(groups), at_ops, at


def _probe_pairs_cuda(other, key_cols, valid, ops, own_cols, own_nulls, out_names, null_names,
                      out_cap, em_overflow, join_rows=None, pairs_on=True, group2=G2_NONE):
    n = valid.shape[0]
    table = other.table
    if valid.dtype != torch.bool or ops.dtype != torch.int32:
        raise TypeError("join_probe: bool valid and int32 ops lanes")
    if join_rows is not None and (join_rows.shape != () or join_rows.dtype != torch.int64):
        raise TypeError("join_rows must be a () int64 counter")
    keys = key_lane_rows(table, tuple(key_cols), n, "join_probe")
    # every output lane: (name, null lane, source or None, read at the
    # matched entry, dtype, 1 on a group-2 row); the sources checked with
    # the lanes they go with
    lanes, own, stored = [], [valid, ops], [other.row_valid, em_overflow]
    for name in out_names:
        src = own_cols.get(name)
        if src is not None:
            lanes.append((name, False, src, 0, src.dtype, 0))
            own.append(src)
        else:
            src = other.rows[name]
            lanes.append((name, False, src if pairs_on else None, 1, src.dtype, 0))
    g2_pad = 1 if group2 == G2_OUTER else 0
    for name in null_names:
        if name in own_cols:
            src = own_nulls.get(name)
            lanes.append((name, True, src, 0, torch.bool, 0))
        else:
            src = other.row_nulls.get(name) if pairs_on else None
            lanes.append((name, True, src, 1, torch.bool, g2_pad))
        if src is not None:
            (stored if lanes[-1][3] else own).append(src)
    if pairs_on:
        stored += [lane[2] for lane in lanes if lane[3] and not lane[1]]
    if join_rows is not None:
        stored.append(join_rows)
    _kernels.check_cuda("join_probe", *own, n=n)
    _kernels.check_cuda("join_probe", *stored)
    if len(lanes) > PROBE_LANES:
        raise ValueError(f"{len(lanes)} output lanes exceed the kernel's {PROBE_LANES}")
    groups, at_ops, at_valid = _probe_layout(tuple(lane[4] for lane in lanes), out_cap, n)
    buf = torch.empty(at_valid + out_cap, dtype=torch.uint8, device=valid.device)
    base = buf.data_ptr()
    cols, nulls, outs = {}, {}, []
    for dt, at, js in groups:  # a dtype's lanes: one view, split
        part = buf[at:at + len(js) * out_cap * dt.itemsize].view(dt)
        for j, lane in zip(js, part.view(len(js), out_cap).unbind(0) if len(js) > 1 else (part,)):
            name, is_null, src, is_other, _, g2_one = lanes[j]
            (nulls if is_null else cols)[name] = lane
            outs.append((0 if src is None else src.data_ptr(), is_other, lane.data_ptr(),
                         dt.itemsize, g2_one))
    ints = buf[at_ops:at_ops + 4 * (out_cap + 2 * n + 1)].view(torch.int32)
    at_slots = at_ops + 4 * out_cap
    _kernels.call(
        "join_probe", "rw_join_probe", _kernels.int64_rows(keys, 8), len(keys), n,
        valid.data_ptr(), ops.data_ptr(), table.fp1.data_ptr(), table.fp2.data_ptr(),
        table.live.data_ptr(), table.capacity, other.row_valid.data_ptr(), other.fanout,
        _kernels.int64_rows(outs, PROBE_LANES), len(outs), out_cap, base + at_ops,
        base + at_valid, base + at_slots, base + at_slots + 4 * n, base,
        base + at_slots + 8 * n, em_overflow.data_ptr(),
        0 if join_rows is None else join_rows.data_ptr(), int(pairs_on), int(group2),
    )
    return Probed(cols, nulls, ints[:out_cap], buf[at_valid:].view(torch.bool),
                  ints[out_cap:out_cap + n], ints[out_cap + n:out_cap + 2 * n], ints[-1])


# -- degrees and transitions: kernel P --------------------------------------------
def degree_apply(other: JoinSide, match: torch.Tensor, sl: torch.Tensor, signs: torch.Tensor):
    """Bump the OTHER side's per-row degrees in place by this chunk's
    net effect and report the transitions, as the reference
    (``ops/join.py:339``): ``(trans_pid, went_pos, went_zero)`` over the
    (n * fanout) lanes sorted by stored row id ``pid = slot * fanout +
    pos``; each distinct matched pid's first lane carries it, with
    went_pos = degree 0 -> > 0 and went_zero = > 0 -> <= 0 over the
    chunk's net signed count; other lanes hold the sentinel
    ``capacity * fanout``."""
    _cpu_only("degree_apply", match, "P (degree_emit)")
    return _degree_apply_torch(other, match, sl, signs)


def _degree_apply_torch(other, match, sl, signs):
    cap, fanout = other.capacity, other.fanout
    n = match.shape[0]
    dev = match.device
    sent = cap * fanout
    pos_j = torch.arange(fanout, dtype=torch.int64, device=dev)[None, :]
    pid = torch.where(match, sl.to(torch.int64)[:, None] * fanout + pos_j,
                      torch.full((), sent, dtype=torch.int64, device=dev)).reshape(-1)
    delta = signs.to(torch.int32)[:, None].expand(n, fanout).reshape(-1)
    delta = torch.where(pid != sent, delta, torch.zeros_like(delta))
    # distinct pids by a stable sort and a segment sum: the transition is
    # per stored row, over the chunk's net delta
    order = torch.argsort(pid, stable=True)
    spid, sdelta = pid[order], delta[order]
    boundary = torch.ones_like(spid, dtype=torch.bool)
    boundary[1:] = spid[1:] != spid[:-1]
    seg_id = torch.cumsum(boundary.to(torch.int64), 0) - 1
    net = torch.zeros_like(sdelta).index_add_(0, seg_id, sdelta)[seg_id]
    rep = boundary & (spid != sent)
    flat = other.degree.view(-1)
    old = flat[spid.clamp(max=sent - 1)]
    flat.index_add_(0, spid[rep], net[rep])  # distinct ids; updates at sent dropped
    if other.ddirty is not None:
        other.ddirty[spid[rep & (net != 0)] // fanout] = True
    new = old + net
    went_pos = rep & (old == 0) & (new > 0)
    went_zero = rep & (old > 0) & (new <= 0)
    trans_pid = torch.where(rep, spid, torch.full_like(spid, sent)).to(torch.int32)
    return trans_pid, went_pos, went_zero


def degree_emit(other: JoinSide, probed: Probed, ops: torch.Tensor, out_cap: int,
                em_overflow: torch.Tensor, join_rows: Optional[torch.Tensor] = None,
                group3: int = G3_NONE) -> None:
    """The other side's degrees, then group 3 of the emission, in place:
    ``degree_apply`` over the matches kernel M found (``probed.slots``,
    the probe rows' signs from ``ops``), then, with ``group3`` set, one
    row per transition appended to ``probed``'s chunk after its
    ``written`` rows: the stored row's lanes (``gather_flat``), with
    ``G3_OUTER`` the arrival side's lanes NULL-padded; op DELETE on
    went_pos, INSERT on went_zero (``G3_OUTER``, ``G3_ANTI``), the
    reverse for ``G3_SEMI``. ``written``, ``em_overflow`` and
    ``join_rows`` advance as in ``probe_pairs``. The plain version
    writes group 3 in pid order, as the reference; kernel P in the order
    of each pid's first match in the chunk (``csrc/join_degree.cu``)."""
    args = (other, probed, ops, out_cap, em_overflow, join_rows, group3)
    if ops.device.type == "cpu":
        _degree_emit_torch(*args)
    elif ops.device.type == "cuda":
        _degree_emit_cuda(*args)
    else:
        raise ValueError(f"unsupported device {ops.device}")


def _degree_emit_torch(other, probed, ops, out_cap, em_overflow, join_rows=None,
                       group3=G3_NONE):
    hit = probed.slots >= 0
    sl = probed.slots.clamp(min=0).long()
    match = other.row_valid[sl] & hit[:, None]
    signs = torch.where(hit, op_sign(ops), torch.zeros_like(ops))
    trans_pid, went_pos, went_zero = _degree_apply_torch(other, match, sl, signs)
    if group3 == G3_NONE:
        return
    emit = went_pos | went_zero
    base = probed.written.to(torch.int64)
    pos = base + torch.cumsum(emit.to(torch.int64), 0) - 1
    end = base + emit.sum()
    em_overflow |= end > out_cap
    if join_rows is not None:
        join_rows += end.clamp(max=out_cap) - base.clamp(max=out_cap)
    probed.written.copy_(end)
    take = emit & (pos < out_cap)
    idx = pos[take]
    src = trans_pid[take].long()
    t_cols, t_nulls = _gather_flat_torch(other, src, [n for n in probed.cols if n in other.rows])
    for name, lane in t_cols.items():
        probed.cols[name][idx] = lane
    for name, dst in probed.nulls.items():
        if name in t_nulls:
            dst[idx] = t_nulls[name]
        elif name not in other.rows and group3 == G3_OUTER:
            dst[idx] = True  # NULL-pad the arrival side
    pos_op, zero_op = (Op.INSERT, Op.DELETE) if group3 == G3_SEMI else (Op.DELETE, Op.INSERT)
    probed.ops[idx] = torch.where(went_pos[take], int(pos_op), int(zero_op)).to(torch.int32)
    probed.valid[idx] = True


def _degree_emit_cuda(other, probed, ops, out_cap, em_overflow, join_rows=None,
                      group3=G3_NONE):
    n = ops.shape[0]
    dev = ops.device
    fanout = other.fanout
    if ops.dtype != torch.int32 or probed.slots.dtype != torch.int32:
        raise TypeError("join_degree: int32 ops and slots")
    if other.degree.dtype != torch.int32 or other.row_valid.shape != other.degree.shape:
        raise TypeError("join_degree: (capacity, fanout) int32 degree lane")
    _kernels.check_cuda("join_degree", ops, probed.slots, n=n)
    _kernels.check_cuda("join_degree", other.row_valid, other.degree, probed.written,
                        probed.ops, probed.valid, em_overflow)
    if other.ddirty is not None:
        _kernels.check_cuda("join_degree", other.ddirty, n=other.capacity)
    if join_rows is not None:
        if join_rows.shape != () or join_rows.dtype != torch.int64:
            raise TypeError("join_rows must be a () int64 counter")
        _kernels.check_cuda("join_degree", join_rows, em_overflow)
    outs = []
    for name, dst in probed.cols.items():
        src = other.rows.get(name)
        if src is not None:
            _kernels.check_cuda("join_degree", src, dst)
            outs.append((src.data_ptr(), dst.data_ptr(), dst.element_size(), 0))
    for name, dst in probed.nulls.items():
        src = other.row_nulls.get(name)
        if src is not None:
            _kernels.check_cuda("join_degree", src, dst)
            outs.append((src.data_ptr(), dst.data_ptr(), 1, 0))
        elif name not in other.rows and group3 == G3_OUTER:
            _kernels.check_cuda("join_degree", dst)
            outs.append((0, dst.data_ptr(), 1, 1))
    m = n * fanout
    h_size = 1 << max(1, (2 * m - 1).bit_length())
    tiles = max(-(-m // 256), 1)
    scratch = torch.empty(4 * h_size + 2 * m + tiles, dtype=torch.int32, device=dev)
    _kernels.call(
        "join_degree", "rw_join_degree", n, probed.slots.data_ptr(), ops.data_ptr(),
        other.row_valid.data_ptr(), fanout, other.capacity, other.degree.data_ptr(),
        _kernels.int64_rows(outs, 16), len(outs), int(group3), out_cap, probed.ops.data_ptr(),
        probed.valid.data_ptr(), probed.written.data_ptr(), em_overflow.data_ptr(),
        0 if join_rows is None else join_rows.data_ptr(), scratch.data_ptr(), h_size,
        0 if other.ddirty is None else other.ddirty.data_ptr(),
    )


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
    srcs = (side.table.live, side.sdirty, side.stored)
    dsts = (new.table.live, new.sdirty, new.stored)
    if side.ddirty is not None:
        srcs, dsts = srcs + (side.ddirty,), dsts + (new.ddirty,)
    move_slots(srcs, dsts, new_slots, keep)  # kernel I on the card
    src = [*side.rows.values(), *side.row_nulls.values(), side.degree]
    dst = [*new.rows.values(), *new.row_nulls.values(), new.degree]
    if dev.type == "cpu":
        _regrow_entries_torch(side, new, src, dst, keep, new_slots)
    else:
        _regrow_entries_cuda(side, new, src, dst, keep, new_slots)
    return new


def rebuild_side(side: JoinSide, keep: torch.Tensor, new_cap: int) -> JoinSide:
    """A fresh side of ``new_cap`` keys holding the ``keep`` keys, each
    bucket at its old in-bucket positions (the reference's
    ``_evict_side`` rebuild, hash_join.py:650-693): kernel A inserts the
    keys, kernel I moves the slot lanes and, a bucket row as ``fanout``
    elements, the 2-D lanes. The latches carry over."""
    dev = side.device
    k = side.fanout
    if new_cap * k >= 2**31:
        raise ValueError(f"rebuild_side: ({new_cap}, {k}) buckets exceed int32 positions")
    new = JoinSide.create(
        new_cap, k, tuple(t.dtype for t in side.table.keys),
        {n: a.dtype for n, a in side.rows.items()}, tuple(side.row_nulls), device=dev,
    )
    new.overflow.copy_(side.overflow)
    new.inconsistent.copy_(side.inconsistent)
    new.table, slots, _, _ = lookup_or_insert(new.table, side.table.keys, keep)
    srcs = (side.table.live, side.sdirty, side.stored)
    dsts = (new.table.live, new.sdirty, new.stored)
    if side.ddirty is not None:
        srcs, dsts = srcs + (side.ddirty,), dsts + (new.ddirty,)
    move_slots(srcs, dsts, slots, keep)
    flat = slots.to(torch.int64)[:, None] * k + torch.arange(k, device=dev)
    flat_slots = torch.where(slots[:, None] >= 0, flat, -1).reshape(-1).to(torch.int32)
    del flat
    src = [*side.rows.values(), *side.row_nulls.values(), side.row_valid, side.degree]
    dst = [*new.rows.values(), *new.row_nulls.values(), new.row_valid, new.degree]
    move_slots([a.reshape(-1) for a in src], [a.view(-1) for a in dst], flat_slots,
               keep.repeat_interleave(k))
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
