"""Plain TopN and retractable GroupTopN — ORDER BY ... LIMIT with
retractions.

Port of ``risingwave_tpu/executors/top_n_plain.py``: ``_upsert_step``
:53, ``_order_key_u64`` :68 (as ``ops.agg.topn_order_key``),
``_rank_top`` :86, ``TopNExecutor`` :103, ``_upsert_step_ed`` :367,
``_group_topk_mask`` :390, ``_diff_touched_groups`` :439, ``_emit_diffs``
:476 and ``RetractableGroupTopNExecutor`` :501. Reference:
src/stream/src/executor/top_n/top_n_plain.rs:77 and group_top_n.rs:63.

Both executors keep every input row in a pk-keyed row store (a
``HashTable`` plus one lane per column). Per chunk, kernel A finds or
inserts the pks and kernel V (``csrc/topn_upsert.cu``, ``topn_upsert``)
lets the last row per pk write every lane (a delete too, so a
checkpoint stages a tombstone's lanes), set liveness by its sign and
mark ``sdirty`` (and ``epoch_dirty``). At the barrier the store is
ranked on the card by a stable multi-lane key (``csrc/topn_rank.cu``):

- ``TopNExecutor``: kernel W (``rank_top``) gives the slots of the top
  n rows by (live first, order key, pk lanes, slot); one gather of n
  rows (kernel R) reaches the host, which diffs them against the
  mirror of what it emitted (a dict of n rows, as the reference).
- ``RetractableGroupTopNExecutor``: kernel X (``group_topk_mask``)
  gives per slot whether the row is live and within its group's top k
  (by group lanes, live first, order key, pk lanes, slot) and whether
  its group holds an epoch-dirty row.

The retractable executor's diff is the reference's (one DELETE chunk
of the rows that left or changed, then one INSERT chunk of the rows
that entered or changed, each a multiset equal to the reference's,
padded to ``emission_bucket``), but not row by row: the reference keeps
a per-group dict mirror and walks every pulled row with ``.item()``
(about 0.9M rows a barrier on q19). Here the mirror is kept by slot
(a slot is one (group, pk) for as long as the store is not rebuilt): a
bool lane ``emitted`` on the card and the emitted rows' values in host
numpy lanes indexed by slot. The pull selects, through kernel R's
select and gather (one launch and one copy, not a host read of the
whole mask), the rows of every group with an epoch-dirty row that are
in its top k now or were emitted before (the rows of a group that
emptied are among the emitted); numpy compares each pulled row with
its mirror value. A
rebuild moves ``emitted`` with the other lanes (kernel I) and the host
values to the new slots; a restore rebuilds both from the restored
top k, as the reference rebuilds its mirror.

The reference's unbucketed twins (``bucketed=False``) and the analysis
hooks (``lint_info``, ``pin_max_bucket``, ``padding_stats``) are not
ported. Order lanes may be any numeric dtype; pk and group lanes must
be integer or bool lanes (a float key lane raises).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk, _numpy_dtype
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.executors.over_window import _s64, window_pack_plan
from risingwave_tpu_torch.ops.agg import topn_order_key
from risingwave_tpu_torch.ops.checkpoint import (
    insert_keys,
    mark_checkpointed,
    scatter_rows,
    stage_select,
)
from risingwave_tpu_torch.ops.hash_table import (
    HashTable,
    _last_occurrence_torch,
    expire_table,
    lookup_or_insert,
    move_slots,
    read_scalars,
)
from risingwave_tpu_torch.runtime.bucketing import (
    BucketAllocator,
    BucketPolicy,
    emission_bucket,
    lattice_between,
    pow2_at_least,
)
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    StateDelta,
    grow_pow2,
    pull_rows,
)
from risingwave_tpu_torch.types import Op

GROW_AT = 0.5
# lanes one rw_topn_upsert call writes (csrc/topn_upsert.cu TU_MAX_LANES)
UPSERT_LANES = 16
# key lanes one rw_rank_top / rw_group_topk_mask call takes
# (csrc/topn_rank.cu TR_MAX_KEYS)
RANK_KEYS = 12
# a run of tied rows across a group's k-th place longer than this is
# sorted by rw_group_topk_long; a shorter one is ranked by one warp
# (csrc/topn_rank.cu xk_resolve_kernel)
TOPK_LONG_RUN = 256
# digit bits of one round of kernel W's select (csrc/topn_rank.cu TR_SEL_BITS)
SELECT_BITS = 11
# a key lane's role in csrc/topn_rank.cu (TrMode)
_KEY_PLAIN, _KEY_ASC, _KEY_DESC, _KEY_LIVE_LAST = 0, 1, 2, 3


# -- kernel V: the row store's upsert ----------------------------------------------
def last_scratch(capacity: int, device) -> torch.Tensor:
    """The per-slot int32 lane kernel V keeps at -1 between calls."""
    return torch.full((capacity,), -1, dtype=torch.int32, device=device)


def upsert_step(table: HashTable, rows, sdirty, chunk: StreamChunk, pk, names, scratch,
                dropped, epoch_dirty=None):
    """``_upsert_step`` (and, with ``epoch_dirty``, ``_upsert_step_ed``)
    in place: kernel A finds or inserts each valid row's pk, then
    ``topn_upsert``. ``dropped`` is a () bool latch."""
    keys = tuple(chunk.col(k) for k in pk)
    table, slots, _, _ = lookup_or_insert(table, keys, chunk.valid)
    topn_upsert(table, rows, sdirty, epoch_dirty, chunk, slots, names, scratch, dropped)
    return table


def topn_upsert(table, rows, sdirty, epoch_dirty, chunk, slots, names, scratch, dropped) -> None:
    """Kernel V: for the LAST valid row of each slot, write every lane of
    ``names`` (on a delete too), set ``live`` to its sign and mark
    ``sdirty`` (and ``epoch_dirty``, unless None); a valid row without
    a slot latches ``dropped``. ``scratch`` is the store's
    ``last_scratch`` lane (the card's last-row rule). Plain PyTorch on
    the CPU."""
    if slots.device.type == "cpu":
        _topn_upsert_torch(table, rows, sdirty, epoch_dirty, chunk, slots, names, dropped)
    elif slots.device.type == "cuda":
        _topn_upsert_cuda(table, rows, sdirty, epoch_dirty, chunk, slots, names, scratch,
                          dropped)
    else:
        raise ValueError(f"unsupported device {slots.device}")


def _topn_upsert_torch(table, rows, sdirty, epoch_dirty, chunk, slots, names, dropped):
    active = chunk.valid
    dropped |= (active & (slots < 0)).any()
    last = _last_occurrence_torch(slots, active)
    idx = slots[last].long()
    for n in names:
        rows[n][idx] = chunk.col(n)[last].to(rows[n].dtype)
    table.live[idx] = chunk.signs()[last] > 0
    sdirty[idx] = True
    if epoch_dirty is not None:
        epoch_dirty[idx] = True


def _topn_upsert_cuda(table, rows, sdirty, epoch_dirty, chunk, slots, names, scratch, dropped):
    n = chunk.capacity
    cap = table.capacity
    marks = (sdirty,) if epoch_dirty is None else (sdirty, epoch_dirty)
    _kernels.check_cuda("topn_upsert", slots, chunk.valid, chunk.ops, n=n)
    _kernels.check_cuda("topn_upsert", table.live, scratch, *marks, n=cap)
    _kernels.check_cuda("topn_upsert", slots, dropped)
    if chunk.ops.dtype != torch.int32 or scratch.dtype != torch.int32:
        raise TypeError("topn_upsert: int32 ops and scratch lanes")
    if dropped.dtype != torch.bool or dropped.shape != ():
        raise TypeError("topn_upsert: dropped must be a () bool latch")
    lanes, keep_alive = [], []  # a cast lane must outlive the launch (_kernels.call)
    for name in names:
        src, dst = chunk.col(name), rows[name]
        if src.dtype != dst.dtype:
            src = src.to(dst.dtype)
            keep_alive.append(src)
        _kernels.check_cuda("topn_upsert", src, n=n)
        _kernels.check_cuda("topn_upsert", dst, n=cap)
        if dst.element_size() not in (1, 4, 8):
            raise TypeError(f"topn_upsert: lane {name!r} of dtype {dst.dtype}")
        lanes.append((src.data_ptr(), dst.data_ptr(), dst.element_size()))
    _kernels.call(
        "topn_upsert", "rw_topn_upsert", _kernels.int64_rows(lanes, UPSERT_LANES), len(lanes),
        n, slots.data_ptr(), chunk.valid.data_ptr(), chunk.ops.data_ptr(), scratch.data_ptr(),
        table.live.data_ptr(), sdirty.data_ptr(),
        0 if epoch_dirty is None else epoch_dirty.data_ptr(), dropped.data_ptr(),
    )


# -- kernels W and X: ranking the store ---------------------------------------------
def _check_key_lane(t: torch.Tensor) -> None:
    if t.is_floating_point():
        raise TypeError("TopN pk and group lanes must be integer or bool lanes, not "
                        f"{t.dtype}")


def _lexsort_torch(keys) -> torch.Tensor:
    """Slots in the stable lexicographic order of ``keys`` (most
    significant first), ties by slot: the reference's ``lax.sort``."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        if key.dtype == torch.bool:
            key = key.to(torch.int32)
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def rank_top(table: HashTable, order_lane: torch.Tensor, n: int, desc: bool):
    """Kernel W: ``(idx, alive)``, the slots of the first ``n`` rows of
    the store (fewer if the store is smaller) by (live first, order key,
    pk lanes, slot), and their liveness. Liveness is its own leading
    key: a dead row never displaces a live one, whatever its order
    value. Plain PyTorch on the CPU."""
    for k in table.keys:
        _check_key_lane(k)
    n = min(int(n), table.capacity)
    if order_lane.device.type == "cpu":
        return _rank_top_torch(table, order_lane, n, desc)
    if order_lane.device.type == "cuda":
        return _rank_top_cuda(table, order_lane, n, desc)
    raise ValueError(f"unsupported device {order_lane.device}")


def _rank_top_torch(table, order_lane, n, desc):
    perm = _lexsort_torch((~table.live, topn_order_key(order_lane, desc), *table.keys))
    idx = perm[:n].to(torch.int32)
    return idx, table.live[idx.long()]


def _key_rows(lanes):
    """Descriptor rows ``(lane, dtype code, mode)`` of sort-key lanes,
    most significant first."""
    if len(lanes) > RANK_KEYS:
        raise ValueError(f"{len(lanes)} sort keys exceed the kernel's {RANK_KEYS}")
    return [(t.data_ptr(), _kernels.dtype_code(t), mode) for t, mode in lanes]


class RankSelect(NamedTuple):
    """Kernel W's select (``rank_select_plan``): ``cls`` the class whose
    first ``m`` rows are selected (1 live, 0 dead, -1 none), ``take_live``
    and ``take_dead`` the classes the first n rows hold whole; the
    selected class's field ``(encoded order key - min) >> lo`` and its
    ``rounds`` of digits, top first: ``(shift, bits)``, the digit
    ``(field >> shift) & (2**bits - 1)``."""

    cls: int
    take_live: bool
    take_dead: bool
    m: int
    min: int
    lo: int
    rounds: Tuple[Tuple[int, int], ...]

    def rows(self) -> List[int]:
        """The select as ``rw_rank_select`` and ``rw_rank_top`` read it."""
        return [self.cls, int(self.take_live), int(self.take_dead), self.m, _s64(self.min),
                self.lo, len(self.rounds)] + [v for r in self.rounds for v in r]


def rank_select_plan(n: int, n_live: int, cap: int, live_fold, dead_fold) -> RankSelect:
    """Kernel W's select from its fold: ``live_fold``/``dead_fold`` the OR,
    AND, MIN and MAX of the encoded order keys (unsigned words) over the
    live and the dead rows. The first ``n`` rows are the first ``min(n,
    n_live)`` live rows, then the first dead ones: only the class the n-th
    row falls in is selected, a class held whole is taken whole. The
    selected field is exact (``lo`` its lowest varying bit: every row of
    the class has the same bits below it) and as wide as ``(MAX - MIN) >>
    lo`` needs, cut into rounds of at most ``SELECT_BITS`` bits of nearly
    equal widths; a class whose keys are all equal needs no round."""
    m_live = min(n, n_live)
    m_dead = n - m_live
    take_live = n_live > 0 and m_live == n_live
    take_dead = m_dead > 0 and m_dead == cap - n_live
    if 0 < m_live < n_live:
        cls, m, fold = 1, m_live, live_fold
    elif 0 < m_dead < cap - n_live:
        cls, m, fold = 0, m_dead, dead_fold
    else:
        return RankSelect(-1, take_live, take_dead, 0, 0, 0, ())
    o, a, lo_key, hi_key = fold
    v = (o ^ a) & _MASK64
    if not v:
        return RankSelect(cls, take_live, take_dead, m, lo_key, 0, ())
    lo = (v & -v).bit_length() - 1
    width = ((hi_key - lo_key) >> lo).bit_length()
    k = -(-width // SELECT_BITS)
    rounds, top = [], width
    for r in range(k):
        bits = width // k + (1 if r < width % k else 0)
        top -= bits
        rounds.append((top, bits))
    return RankSelect(cls, take_live, take_dead, m, lo_key, lo, tuple(rounds))


def _rank_top_cuda(table, order_lane, n, desc):
    cap = table.capacity
    _kernels.check_cuda("topn_rank", table.live, order_lane, *table.keys, n=cap)
    if table.live.dtype != torch.bool:
        raise TypeError("rank_top: live must be a bool lane")
    dev = order_lane.device
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return idx, alive
    keys = [(table.live, _KEY_LIVE_LAST), (order_lane, _KEY_DESC if desc else _KEY_ASC)]
    keys += [(k, _KEY_PLAIN) for k in table.keys]
    key_rows = _kernels.int64_rows(_key_rows(keys), RANK_KEYS)
    nk = len(keys)
    # the fold (9 words), the select's prefix and rows to take (2), its
    # digit counts (2^11 int32), the candidates' fold (4 a key lane), the
    # compaction's look-back words (a tile each, its counter, the count)
    # and the candidates' slots (cap int32)
    tiles = -(-cap // _kernels.COMPACT_TILE)
    ws = torch.empty(11 + (1 << SELECT_BITS) // 2 + 4 * nk + tiles + 2 + (cap + 1) // 2,
                     dtype=torch.int64, device=dev)
    fold, sel = ws.data_ptr(), ws.data_ptr() + 8 * 9
    hist = sel + 8 * 2
    cfold = hist + 4 * (1 << SELECT_BITS)
    status = cfold + 8 * 4 * nk
    ent = status + 8 * (tiles + 2)
    host = (ctypes.c_int64 * 9)()
    _kernels.call("topn_rank", "rw_rank_fold", key_rows, nk, cap, fold, host)
    u = [v & _MASK64 for v in host]
    select = _kernels.int64_rows([rank_select_plan(n, u[0], cap, u[1:5], u[5:9]).rows()], 1)
    got = (ctypes.c_int64 * (1 + 4 * nk))()
    _kernels.call("topn_rank", "rw_rank_select", key_rows, nk, cap, select, sel, hist, status,
                  ent, cfold, got)
    m = got[0]
    u = [v & _MASK64 for v in got[1:]]
    plan = window_pack_plan([u[4 * i:4 * i + 4] for i in range(nk)], 0, 0)
    # the sort's scratch: the packed words, ka, kb, the digit counts
    # (2^11 int32), then pa, pb and the look-back words (int32)
    c, words = max(m, 1), max(plan.words, 1)
    sort_ws = torch.empty((words + 2) * c + 1024 + c + 128 * -(-c // _kernels.OS_TILE) + 1,
                          dtype=torch.int64, device=dev)
    ka = sort_ws.data_ptr() + 8 * words * c
    pa = ka + 16 * c + 8 * 1024
    bufs = [sort_ws.data_ptr(), pa, pa + 4 * c, ka, ka + 8 * c, ka + 16 * c, pa + 8 * c]
    _kernels.call("topn_rank", "rw_rank_top", key_rows, nk, cap,
                  _kernels.int64_rows([plan.rows()], 1), ent, m,
                  _kernels.int64_rows([bufs], 1), n, idx.data_ptr(), alive.data_ptr())
    return idx, alive


def group_topk_mask(table: HashTable, rows: Dict[str, torch.Tensor], epoch_dirty: torch.Tensor,
                    k: int, desc: bool, group_names: Tuple[str, ...], order_col: str):
    """Kernel X: per slot, ``in_topk`` (the row is live and among its
    group's first k by (live first, order key, pk lanes, slot)) and
    ``gdirty`` (its group, by the group lanes' values, holds an
    epoch-dirty slot). The store's keys are the group lanes, then the pk
    lanes that are not group lanes (``store_keys``), so only those follow
    the order key: a live row's group keys equal its group lanes. On the
    card the live rows are ranked on one packed key
    (``csrc/topn_rank.cu``); plain PyTorch on the CPU, one sort of the
    whole store by (group lanes, live first, order key, pk lanes, slot)."""
    glanes = tuple(rows[g] for g in group_names)
    for lane in glanes + tuple(table.keys):
        _check_key_lane(lane)
    dev = table.live.device
    if dev.type == "cpu":
        return _group_topk_mask_torch(table, rows, epoch_dirty, k, desc, glanes, order_col)
    if dev.type == "cuda":
        return _group_topk_mask_cuda(table, rows, epoch_dirty, k, desc, glanes, order_col)
    raise ValueError(f"unsupported device {dev}")


def _group_topk_mask_torch(table, rows, epoch_dirty, k, desc, glanes, order_col):
    cap = table.capacity
    okey = topn_order_key(rows[order_col], desc)
    perm = _lexsort_torch(glanes + (~table.live, okey) + tuple(table.keys[len(glanes):]))
    dev = perm.device
    boundary = torch.zeros(cap, dtype=torch.bool, device=dev)
    boundary[0] = True
    for lane in glanes:
        s = lane[perm]
        boundary[1:] |= s[1:] != s[:-1]
    idx = torch.arange(cap, device=dev)
    seg_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    seg_dirty = torch.zeros(cap, dtype=torch.bool, device=dev)
    seg_dirty[gid[epoch_dirty[perm]]] = True
    in_topk = torch.zeros(cap, dtype=torch.bool, device=dev)
    gdirty = torch.zeros(cap, dtype=torch.bool, device=dev)
    in_topk[perm] = table.live[perm] & ((idx - seg_start) < k)
    gdirty[perm] = seg_dirty[gid]
    return in_topk, gdirty


_MASK64 = (1 << 64) - 1


class TopkPlan(NamedTuple):
    """Kernel X's packed sort key, from the fold of its key lanes over the
    live rows (``topk_pack_plan``). ``fields``: per packed lane ``(lane,
    lo, width, pos)``, bits ``[lo, lo + width)`` of the lane's encoded key
    with their lowest bit at ``pos`` of the packed key (a negative
    ``pos`` cuts that many low bits: past 64 bits the key keeps its top
    64). ``exact``: the group lanes' bits all fit, so a group is a run of
    equal ``key >> gshift``. ``pass_mask``: bit b set where byte b of the
    packed key varies (one radix pass each)."""

    fields: Tuple[Tuple[int, int, int, int], ...]
    bits: int
    exact: bool
    gshift: int
    pass_mask: int

    def pack(self, words: Sequence[int]) -> int:
        """The packed key of one row, ``words`` its lanes' encoded keys."""
        key = 0
        for lane, lo, width, pos in self.fields:
            v = (words[lane] >> lo) & ((1 << width) - 1)
            key |= v << pos if pos >= 0 else v >> -pos
        return key


def topk_pack_plan(ors: Sequence[int], ands: Sequence[int], n_group: int) -> TopkPlan:
    """Kernel X's packing plan from the OR and AND of each key lane's
    encoded keys over the live rows (the group lanes, then the order key):
    each lane's bits from its highest to its lowest varying bit, group
    lanes first, most significant lane first. A bit above a lane's
    highest varying bit (or below its lowest) is the same in every live
    row, so the packed key orders the rows as the lanes do; a key past 64
    bits keeps its top 64 and the kernel resolves the rows it ties."""
    widths = []
    for lane, (o, a) in enumerate(zip(ors, ands)):
        v = (o ^ a) & _MASK64
        if v:
            lo = (v & -v).bit_length() - 1
            widths.append((lane, lo, v.bit_length() - lo))
    total = sum(w for _, _, w in widths)
    group_bits = sum(w for lane, _, w in widths if lane < n_group)
    bits = min(total, 64)
    fields, end = [], bits
    for lane, lo, width in widths:
        end -= width
        if end + width <= 0:
            break
        fields.append((lane, lo, width, end))
    plan = TopkPlan(tuple(fields), bits, group_bits <= 64,
                    bits - group_bits if group_bits <= 64 else 0, 0)
    varying = plan.pack([(o ^ a) & _MASK64 for o, a in zip(ors, ands)])
    mask = sum(1 << b for b in range(8) if (varying >> (8 * b)) & 0xFF)
    return plan._replace(pass_mask=mask)


def _group_topk_mask_cuda(table, rows, epoch_dirty, k, desc, glanes, order_col):
    cap = table.capacity
    order_lane = rows[order_col]
    _kernels.check_cuda("group_topk", table.live, epoch_dirty, order_lane, *glanes, *table.keys,
                        n=cap)
    if epoch_dirty.dtype != torch.bool:
        raise TypeError("group_topk_mask: epoch_dirty must be a bool lane")
    n_group = len(glanes)
    keys = [(g, _KEY_PLAIN) for g in glanes]
    keys += [(order_lane, _KEY_DESC if desc else _KEY_ASC)]
    keys += [(key, _KEY_PLAIN) for key in table.keys[n_group:]]
    key_rows = _kernels.int64_rows(_key_rows(keys), RANK_KEYS)
    dev = table.live.device
    part = _kernels.compact_scratch(cap, dev)
    fold = torch.empty(2 * n_group + 3, dtype=torch.int64, device=dev)
    host = (ctypes.c_int64 * (2 * n_group + 4))()
    _kernels.call("topn_rank", "rw_group_topk_fold", key_rows, len(keys), n_group, cap,
                  table.live.data_ptr(), epoch_dirty.data_ptr(), part.data_ptr(),
                  fold.data_ptr(), host)
    n_live, n_dirty = host[0], host[1]
    plan = topk_pack_plan(host[2:n_group + 3], host[n_group + 3:2 * n_group + 4], n_group)
    # the sort's scratch is sized from the capacity, not the live count,
    # so every call on a store asks the allocator for the same blocks
    max_items = cap // (int(k) + 1) + 1
    max_long = cap // (TOPK_LONG_RUN + 1) + 1
    plan_rows = [n_live, n_dirty, int(plan.exact), plan.gshift, plan.pass_mask, max_items,
                 max_long, TOPK_LONG_RUN, len(plan.fields)] + [v for f in plan.fields for v in f]
    keys_buf = torch.empty(2 * cap, dtype=torch.int64, device=dev)
    idx_buf = torch.empty(2 * cap, dtype=torch.int32, device=dev)
    hist = torch.empty(256 * -(-cap // _kernels.RBK_TILE) + 256, dtype=torch.int32, device=dev)
    work = torch.empty(3 + max_items + 4 * max_long, dtype=torch.int64, device=dev)
    # the set of the dirty groups: at least twice their count, unless no
    # slot or every slot is dirty
    set_cap, set_lanes = 0, []
    if 0 < n_dirty < cap:
        set_cap = 1 << max(10, (2 * n_dirty - 1).bit_length())
        set_lanes = [torch.empty(set_cap, dtype=torch.int32, device=dev) for _ in range(3)]
        set_lanes += [torch.empty(set_cap, dtype=g.dtype, device=dev) for g in glanes]
    in_topk = torch.empty(cap, dtype=torch.bool, device=dev)
    gdirty = torch.empty(cap, dtype=torch.bool, device=dev)
    runs = (ctypes.c_int64 * 3)()
    _kernels.call(
        "topn_rank", "rw_group_topk_mask", key_rows, len(keys), n_group, cap,
        table.live.data_ptr(), epoch_dirty.data_ptr(), int(k),
        _kernels.int64_rows([plan_rows], 1),
        _kernels.int64_rows([[t.data_ptr() for t in set_lanes]], 1), set_cap, part.data_ptr(),
        keys_buf.data_ptr(), idx_buf.data_ptr(), hist.data_ptr(), work.data_ptr(),
        in_topk.data_ptr(), gdirty.data_ptr(), runs,
    )
    n_long, n_rows, cur = runs[0], runs[1], runs[2]
    if n_rows:  # ties across the k-th place longer than TOPK_LONG_RUN: sort those rows
        ekeys = torch.empty(2 * n_rows, dtype=torch.int64, device=dev)
        eidx = torch.empty(2 * n_rows, dtype=torch.int32, device=dev)
        eslot = torch.empty(n_rows, dtype=torch.int32, device=dev)
        erun = torch.empty(n_rows, dtype=torch.int32, device=dev)
        ehist = torch.empty(256 * -(-n_rows // _kernels.RBK_TILE) + 256, dtype=torch.int32,
                            device=dev)
        bits = torch.empty(2 * RANK_KEYS, dtype=torch.int64, device=dev)
        _kernels.call(
            "topn_rank", "rw_group_topk_long", key_rows, len(keys), n_group, int(plan.exact),
            int(k), idx_buf.data_ptr() + cur * n_live * idx_buf.element_size(), work.data_ptr(),
            max_items, n_long, n_rows, ekeys.data_ptr(), eidx.data_ptr(), eslot.data_ptr(),
            erun.data_ptr(), ehist.data_ptr(), bits.data_ptr(), in_topk.data_ptr(),
        )
    return in_topk, gdirty


# -- the host side ---------------------------------------------------------------
def emit_diffs(dels: Dict[str, np.ndarray], ins: Dict[str, np.ndarray], names, dtypes,
               device) -> List[StreamChunk]:
    """``_emit_diffs``: one DELETE chunk, then one INSERT chunk, each
    padded to ``emission_bucket`` rows; an empty side emits nothing."""
    outs = []
    for cols, op in ((dels, Op.DELETE), (ins, Op.INSERT)):
        n = len(cols[names[0]])
        if not n:
            continue
        outs.append(StreamChunk.from_numpy(
            {c: np.asarray(cols[c], _numpy_dtype(dtypes[c])) for c in names},
            emission_bucket(n), ops=np.full(n, int(op), np.int32), device=device,
        ))
    return outs


def _rows_of(top: Dict[Tuple, Tuple], names) -> Dict[str, list]:
    return {c: [r[j] for r in top] for j, c in enumerate(names)}


def _move_store(table: HashTable, lanes: Dict[str, torch.Tensor], new_cap: int):
    """A rebuild of the row store: the kept pks (``live | sdirty``) into
    a fresh table of ``new_cap`` (kernel A), ``live`` and every lane of
    ``lanes`` moved to their new slots (kernel I). Returns the new
    table, the new lanes and each old slot's new one."""
    dev = table.device
    keep = table.live | lanes["sdirty"]
    new = HashTable.create(new_cap, tuple(k.dtype for k in table.keys), device=dev)
    new, slots, _, _ = lookup_or_insert(new, table.keys, keep)
    out = {n: torch.zeros(new_cap, dtype=a.dtype, device=dev) for n, a in lanes.items()}
    move_slots((table.live,) + tuple(lanes.values()), (new.live,) + tuple(out.values()),
               slots, keep)
    return new, out, slots


class _RowStore(Executor, Checkpointable):
    """What the two retractable executors share: the pk-keyed row store
    (``store_keys``, one lane per name), its growth, digest, checkpoint
    and restore (``top_n_plain.py:205-239, 282-356, 653-686, 750-809``)."""

    def _init_store(self, capacity: int, schema_dtypes, store_keys, bucket_policy, device):
        self.device = resolve_device(device)
        self._buckets = BucketAllocator(
            bucket_policy or BucketPolicy.from_capacity(capacity, grow_at=GROW_AT)
        )
        self.store_keys = tuple(store_keys)
        self.names = tuple(sorted(schema_dtypes))
        self._dtypes = {n: schema_dtypes[n] for n in self.names}
        self._reset_store(capacity)
        self._bound = 0

    def _reset_store(self, cap: int) -> None:
        dev = self.device
        self.table = HashTable.create(cap, tuple(self._dtypes[c] for c in self.store_keys),
                                      device=dev)
        self.rows = {n: torch.zeros(cap, dtype=self._dtypes[n], device=dev) for n in self.names}
        self.sdirty = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.stored = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.scratch = last_scratch(cap, dev)
        self._dropped = torch.zeros((), dtype=torch.bool, device=dev)

    def _aux_lanes(self) -> Dict[str, torch.Tensor]:
        """Slot lanes beside the rows that a rebuild moves."""
        return {"sdirty": self.sdirty, "stored": self.stored}

    def _check_nulls(self, chunk: StreamChunk, cols) -> None:
        for c in cols:
            if c in chunk.nulls:
                raise ValueError(f"TopN key column {c!r} cannot be NULL")

    def _maybe_grow(self, incoming: int) -> None:
        cap = self.table.capacity
        if not self._buckets.should_plan(cap, self._bound, incoming):
            return
        claimed, surv = read_scalars(self.table.occupancy(),
                                     (self.table.live | self.sdirty).sum())
        new_cap = self._buckets.plan(cap, incoming, claimed, surv)
        if new_cap is not None:
            aux = self._aux_lanes()
            lanes = {f"r_{n}": a for n, a in self.rows.items()}
            lanes.update(aux)
            self.table, moved, slots = _move_store(self.table, lanes, new_cap)
            self.rows = {n: moved[f"r_{n}"] for n in self.names}
            for name in aux:
                setattr(self, name, moved[name])
            self.scratch = last_scratch(new_cap, self.device)
            self._after_move(aux, slots)
            claimed = int(self.table.occupancy())
        self._bound = claimed

    def _after_move(self, old: Dict[str, torch.Tensor], slots: torch.Tensor) -> None:
        """Host bookkeeping that follows the slots of a rebuild (``old``:
        the aux lanes before it, ``slots``: each old slot's new one)."""
        return None

    # -- integrity ----------------------------------------------------------
    def digest_lanes(self):
        lanes = {f"k{i}": k for i, k in enumerate(self.table.keys)}
        for n in self.names:
            lanes[f"r_{n}"] = self.rows[n]
        return lanes, self.table.live

    def state_digest(self) -> int:
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint/restore -------------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        """The pks changed since the last checkpoint (tombstones with the
        lanes the delete wrote) through kernel R; the marks flip eagerly."""
        sel, tomb, _, n_sdirty = stage_select(self.sdirty, (self.table.live,), self.stored)
        if not n_sdirty:
            return []
        lanes = {f"k{i}": k for i, k in enumerate(self.table.keys)}
        key_names = tuple(lanes)
        for name in self.names:
            lanes[f"r_{name}"] = self.rows[name]
        pulled = pull_rows(lanes, sel, {"tombstone": tomb})
        tombstone = pulled.pop("tombstone")
        mark_checkpointed(self.stored, self.sdirty, sel, tomb)
        keys = {k: pulled[k] for k in key_names}
        vals = {k: v for k, v in pulled.items() if k not in key_names}
        return [StateDelta(self.table_id, keys, vals, tombstone, key_names)]

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """A store of ``grow_pow2(n, capacity)`` slots; kernel A inserts
        the pks, kernel R lands live, stored and every row lane in one
        launch."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        self._reset_store(grow_pow2(n, self.table.capacity, GROW_AT))
        self._bound = int(n)
        if n:
            self.table, slots = insert_keys(self.table, key_cols, n)
            dst = {f"r_{nm}": a for nm, a in self.rows.items()}
            src = {name: value_cols[name] for name in dst}
            dst["live"], src["live"] = self.table.live, np.ones(n, np.bool_)
            dst["stored"], src["stored"] = self.stored, np.ones(n, np.bool_)
            scatter_rows(dst, slots, src)


class TopNExecutor(_RowStore):
    """ORDER BY order_col [DESC] LIMIT n with full retraction support.

    ``apply`` folds each chunk into the row store and emits nothing; the
    barrier ranks the store (kernel W), pulls the n top rows and emits
    the diff against what it emitted before: a DELETE chunk, then an
    INSERT chunk, padded to pow2 buckets. The store walks the bucket
    lattice."""

    def __init__(
        self,
        order_col: str,
        limit: int,
        pk: Sequence[str],
        schema_dtypes: Dict[str, torch.dtype],
        desc: bool = False,
        capacity: int = 1 << 14,
        table_id: str = "top_n",
        bucket_policy: Optional[BucketPolicy] = None,
        device="cuda",
    ):
        self.order_col = order_col
        self.limit = int(limit)
        self.desc = desc
        self.pk = tuple(pk)
        self.table_id = table_id
        self._init_store(capacity, schema_dtypes, self.pk, bucket_policy, device)
        self._emitted: Dict[Tuple, Tuple] = {}  # pk -> full row

    def trace_contract(self):
        """The barrier diff pads its emissions to pow2 buckets of at most
        ``limit`` rows a chunk: a closed emission family, so a device MV
        behind it fuses (reference :153)."""
        return {
            "kind": "device",
            "state": (self.table, self.rows),
            "donate": True,
            "emission": "bucketed",
            "emission_caps": lattice_between(2, pow2_at_least(max(self.limit, 2))),
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        self._check_nulls(chunk, self.pk + (self.order_col,))
        self._maybe_grow(chunk.capacity)
        self._bound += chunk.capacity
        self.table = upsert_step(self.table, self.rows, self.sdirty, chunk, self.pk, self.names,
                                 self.scratch, self._dropped)
        return []

    def on_barrier(self, barrier) -> List[StreamChunk]:
        self._buckets.note_barrier(self.table.capacity, self._bound)
        (dropped,) = read_scalars(self._dropped)
        if dropped:
            raise RuntimeError("TopN row store overflowed; grow capacity")
        top = self._top()
        dels = [v for k, v in self._emitted.items() if top.get(k) != v]
        ins = [v for k, v in top.items() if self._emitted.get(k) != v]
        self._emitted = top
        return emit_diffs(_rows_of(dels, self.names), _rows_of(ins, self.names), self.names,
                          self._dtypes, self.device)

    def _top(self) -> Dict[Tuple, Tuple]:
        """The live top n rows, pk -> row: kernel W, then one gather of n
        rows and one copy (kernel R)."""
        idx, alive = rank_top(self.table, self.rows[self.order_col], self.limit, self.desc)
        pulled = pull_rows(dict(self.rows), idx, {"__alive__": alive})
        m = int(np.argmin(pulled["__alive__"])) if not pulled["__alive__"].all() else len(idx)
        cols = {n: pulled[n][:m].tolist() for n in self.names}
        pks = list(zip(*(cols[k] for k in self.pk)))
        return dict(zip(pks, zip(*(cols[n] for n in self.names))))

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        super().restore_state(table_id, key_cols, value_cols)
        # the downstream MV was restored to this view: recompute it
        self._emitted = self._top()


class RetractableGroupTopNExecutor(_RowStore):
    """GROUP BY g ORDER BY o LIMIT k with full retraction support
    (group_top_n.rs:63): deletes and updates that cross a group's top-k
    boundary re-emit the displaced or promoted rows. The store's rows are
    keyed by group + pk (a row "moving" groups is two rows, so the old
    group's retraction is never lost). ``window_key`` (a group column,
    retention): a watermark expires the rows of closed groups and drops
    them from the mirror without retractions (EOWC-final)."""

    def __init__(
        self,
        group_by: Sequence[str],
        order_col: str,
        limit: int,
        pk: Sequence[str],
        schema_dtypes: Dict[str, torch.dtype],
        desc: bool = False,
        capacity: int = 1 << 14,
        window_key: Optional[Tuple[str, int]] = None,
        table_id: str = "group_top_n",
        bucket_policy: Optional[BucketPolicy] = None,
        device="cuda",
    ):
        self.group_by = tuple(group_by)
        self.order_col = order_col
        self.limit = int(limit)
        self.desc = desc
        self.pk = tuple(pk)
        if window_key is not None and window_key[0] not in self.group_by:
            raise ValueError("window_key must be one of the group columns (a closed window "
                             "bounds its groups)")
        self.window_key = window_key
        self.table_id = table_id
        store_keys = self.group_by + tuple(c for c in self.pk if c not in self.group_by)
        self._init_store(capacity, schema_dtypes, store_keys, bucket_policy, device)

    def _reset_store(self, cap: int) -> None:
        super()._reset_store(cap)
        self.epoch_dirty = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self.emitted = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self._em_vals: Dict[str, np.ndarray] = {}  # host mirror by slot, made on first use

    def _aux_lanes(self) -> Dict[str, torch.Tensor]:
        return {"sdirty": self.sdirty, "stored": self.stored, "epoch_dirty": self.epoch_dirty,
                "emitted": self.emitted}

    def _mirror(self) -> Dict[str, np.ndarray]:
        if not self._em_vals:
            cap = self.table.capacity
            self._em_vals = {n: np.zeros(cap, _numpy_dtype(self._dtypes[n])) for n in self.names}
        return self._em_vals

    def _after_move(self, old, slots) -> None:
        """The host mirror's values follow their slots to the new store."""
        if not self._em_vals:
            return
        vals = self._em_vals
        self._em_vals = {}
        sel, _, n, _ = stage_select(old["emitted"], (old["emitted"],), old["emitted"])
        if not n:
            return
        pulled = pull_rows({"to": slots}, sel, {"at": sel})
        ok = pulled["to"] >= 0
        for name, lane in self._mirror().items():
            lane[pulled["to"][ok]] = vals[name][pulled["at"][ok]]

    def trace_contract(self):
        """Emissions are pow2-padded host diffs and the store walks the
        allocator's lattice (reference :579)."""
        return {
            "kind": "device",
            "state": (self.table, self.rows),
            "donate": True,
            "emission": "bucketed",
            "emission_caps": lattice_between(2, self._buckets.policy.max_cap),
            "window_buckets": self._buckets.lattice,
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        self._check_nulls(chunk, self.pk + self.group_by + (self.order_col,))
        self._maybe_grow(chunk.capacity)
        self._bound += chunk.capacity
        self.table = upsert_step(self.table, self.rows, self.sdirty, chunk, self.store_keys,
                                 self.names, self.scratch, self._dropped, self.epoch_dirty)
        return []

    def on_barrier(self, barrier) -> List[StreamChunk]:
        # one packed read: the latch, the dirty short-circuit, occupancy
        dropped, any_dirty, claimed = read_scalars(
            self._dropped, self.epoch_dirty.any(), self.table.occupancy())
        self._bound = int(claimed)
        self._buckets.note_barrier(self.table.capacity, int(claimed))
        if dropped:
            raise RuntimeError("GroupTopN row store overflowed; grow capacity")
        if not any_dirty:
            return []
        in_topk, gdirty = group_topk_mask(self.table, self.rows, self.epoch_dirty, self.limit,
                                          self.desc, self.group_by, self.order_col)
        dels, ins = self._diff(in_topk, gdirty)
        self.epoch_dirty.zero_()
        return emit_diffs(dels, ins, self.names, self._dtypes, self.device)

    def _diff(self, in_topk, gdirty):
        """``_diff_touched_groups`` over the slot mirror: the rows of every
        group with an epoch-dirty row that are in its top k now or were
        emitted, pulled in one gather; a row
        leaves (DELETE, with its emitted values) if it was emitted and is
        no longer in the top k or changed, enters (INSERT) if it is in
        the top k and was not emitted or changed. ``emitted`` becomes
        ``in_topk`` over those groups."""
        pull = gdirty & (in_topk | self.emitted)
        sel, _, _, _ = stage_select(pull, (pull,), pull)
        lanes = dict(self.rows)
        lanes["__topk__"] = in_topk
        lanes["__emitted__"] = self.emitted
        pulled = pull_rows(lanes, sel, {"__sel__": sel})
        self.emitted = torch.where(gdirty, in_topk, self.emitted)
        mirror = self._mirror()
        at = pulled["__sel__"]
        old, new = pulled["__emitted__"], pulled["__topk__"]
        same = old & new
        for name in self.names:
            same &= mirror[name][at] == pulled[name]
        gone, came = old & ~same, new & ~same
        dels = {name: mirror[name][at[gone]] for name in self.names}
        ins = {name: pulled[name][came] for name in self.names}
        for name in self.names:
            mirror[name][at[came]] = ins[name]
        return dels, ins

    def on_watermark(self, watermark: Watermark):
        """Rows of groups below the watermark expire silently: they turn
        dead and sdirty (kernel O) and leave the mirror without emitting
        retractions (EOWC-final: the MV keeps the closed window's top k)."""
        if self.window_key is None or watermark.column != self.window_key[0]:
            return watermark, []
        gi = self.group_by.index(self.window_key[0])
        cut = int(watermark.value - self.window_key[1])
        expire_table(self.table, self.sdirty, gi, cut)
        self.emitted &= ~(self.table.keys[gi] < cut)
        return watermark, []

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """The store through kernels A and R, then the mirror: every
        group's current top k, as emitted (the downstream MV was restored
        to exactly this view)."""
        super().restore_state(table_id, key_cols, value_cols)
        if not self._bound:
            return
        everything = torch.ones(self.table.capacity, dtype=torch.bool, device=self.device)
        in_topk, _ = group_topk_mask(self.table, self.rows, everything, self.limit, self.desc,
                                     self.group_by, self.order_col)
        self.emitted.copy_(in_topk)
        sel, _, _, _ = stage_select(in_topk, (in_topk,), in_topk)
        pulled = pull_rows(dict(self.rows), sel, {"__sel__": sel})
        mirror = self._mirror()
        for name in self.names:
            mirror[name][pulled["__sel__"]] = pulled[name]
