"""Materialized-input MIN/MAX — retractable extremes.

Port of ``risingwave_tpu/ops/minput.py`` (``create_minput`` :49,
``minput_apply`` :65, ``minput_clear`` :172, ``minput_rescatter``
:179). Reference: src/stream/src/executor/aggregation/minput.rs, which
keeps every input value of a MIN/MAX in a sorted per-group state table
so that a retraction of the current extreme falls back to the next
value.

Each materialized call owns a ``(capacity, K)`` multiset of DISTINCT
values per group slot: ``vals[slot, lane]`` a value (a float as the
port's int64 total-order key, ``ops/agg.py:_float_to_order_key``) and
``cnt[slot, lane]`` its multiplicity (0 = a free lane). One row batch
updates it in one pass: the net signed weight per distinct (group,
value) pair; each pair with a nonzero net takes its value's lane, or a
new value the j-th lane that was free before the batch (a lane freed
by the same batch is not reused); then each touched group's extreme
and live total go into the call's ordinary accumulator and non-null
lanes, so the flush machinery is unchanged. More new values than the
group's free lanes latch ``overflow``; a retraction of a value with no
lane, or one that drives a count below zero, latches ``inconsistent``.

Kernel Q (``csrc/minput.cu``) on the card; on the CPU the plain
PyTorch version follows the reference step by step and places every
value in the reference's lane. Everything here updates the multiset IN
PLACE (``minput_rescatter`` returns new tensors, as a rebuild does).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from risingwave_tpu_torch import _kernels, resolve_device
from risingwave_tpu_torch.ops.agg import (
    AggCall,
    _accum_dtype,
    _float_to_order_key,
    accum_init,
    emitted_init,
)
from risingwave_tpu_torch.runtime.bucketing import pow2_at_least


def create_minput(capacity: int, k: int, calls: Tuple[AggCall, ...], input_dtypes,
                  device="cuda") -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """``(vals, cnt)`` per materialized MIN/MAX call output; ``vals`` in
    the call's accumulator dtype, ``cnt`` int32. Unwritten value lanes
    hold the reference's zero (for a float64 input, the port's key of
    the reference's zero key, ``vals_init``), so a checkpoint's rows are
    the reference's byte for byte."""
    dev = resolve_device(device)
    out = {}
    for c in calls:
        if not c.materialized:
            continue
        in_dt = input_dtypes[c.input]
        dt = _accum_dtype(c, in_dt)
        out[c.output] = (
            torch.full((capacity, k), vals_init(in_dt), dtype=dt, device=dev),
            torch.zeros((capacity, k), dtype=torch.int32, device=dev),
        )
    return out


def vals_init(input_dtype) -> int:
    """An unwritten value lane: 0, or for a float64 input the port's key
    of the reference's zero key (``ops/agg.emitted_init``)."""
    return emitted_init(input_dtype if input_dtype == torch.float64 else None)


def minput_apply(vals: torch.Tensor, cnt: torch.Tensor, slots: torch.Tensor,
                 signs: torch.Tensor, v: torch.Tensor, notnull: Optional[torch.Tensor],
                 kind: str, accum: torch.Tensor, nonnull: torch.Tensor,
                 overflow: torch.Tensor, inconsistent: torch.Tensor) -> None:
    """Fold one row batch into the multiset ``(vals, cnt)`` in place and
    write each touched group's new extreme (the kind's sentinel when the
    group holds no value) into ``accum[slot]`` and its live total into
    ``nonnull[slot]``; OR the batch's latches into the () bool tensors
    ``overflow`` and ``inconsistent`` (they may be one tensor).

    ``slots`` (n,) the group slot per row (-1 skips the row), ``signs``
    (n,) in {-1, 0, +1}, ``v`` (n,) the raw input values, ``notnull``
    (n,) bool or None (no NULL input). A row takes part iff slot >= 0,
    sign != 0 and its value is not NULL."""
    if kind not in ("min", "max"):
        raise ValueError(f"minput_apply: kind {kind!r} is not min or max")
    dev = v.device
    if dev.type == "cpu":
        _minput_fold_torch(vals, cnt, slots, signs, v, notnull, kind, accum, nonnull, overflow,
                           inconsistent)
    elif dev.type == "cuda":
        _minput_apply_cuda(vals, cnt, slots, signs, v, notnull, kind, accum, nonnull, overflow,
                           inconsistent)
    else:
        raise ValueError(f"unsupported device {dev}")


def _minput_fold_torch(vals, cnt, slots, signs, v, notnull, kind, accum, nonnull, overflow,
                       inconsistent) -> None:
    """``minput_apply`` in plain PyTorch: the plain version and the
    reference's scatter of each representative's extreme and total."""
    if notnull is None:
        notnull = torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
    _, _, rep, extreme, total, ovf, inc = _minput_apply_torch(
        vals, cnt, slots, signs, v, notnull, kind
    )
    take = rep >= 0
    at = rep[take].long()
    accum[at] = extreme[take].to(accum.dtype)
    nonnull[at] = total[take]
    overflow |= ovf
    inconsistent |= inc


def _set_last_wins(flat: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> None:
    """``flat[idx] = src`` where, among rows with one index, the last row
    wins (as the reference's scatter on the CPU)."""
    if idx.numel() == 0:
        return
    pos = torch.arange(idx.numel(), device=idx.device)
    u, inv = torch.unique(idx, return_inverse=True)
    last = torch.zeros(u.numel(), dtype=pos.dtype, device=idx.device).scatter_reduce_(
        0, inv, pos, reduce="amax", include_self=False
    )
    win = pos == last[inv]
    flat[idx[win]] = src[win]


def _minput_apply_torch(vals, cnt, slots, signs, v, notnull, kind):
    """The plain version, step for step the reference's: returns
    ``(vals, cnt, rep_slots, extreme, total, overflow, inconsistent)``
    with ``vals``/``cnt`` updated in place and every other lane in the
    reference's sorted row order: ``rep_slots`` (n,) int32 the group
    slot on one representative row per touched group (-1 elsewhere),
    ``extreme`` (n,) in the accumulator dtype and ``total`` (n,) int64
    the post-batch extreme and live total of each row's group."""
    n = v.shape[0]
    capacity, K = cnt.shape
    dev = v.device
    fx = v.dtype if v.dtype.is_floating_point else None
    if fx is not None:
        v = _float_to_order_key(v)
    v = v.to(vals.dtype)

    active = (slots >= 0) & (signs != 0) & notnull
    # inactive rows sort last (slot = capacity); sort by (slot, value)
    s_key = torch.where(active, slots.to(torch.int64), capacity)
    order = torch.argsort(v, stable=True)
    order = order[torch.argsort(s_key[order], stable=True)]
    sl, sv = s_key[order], v[order]
    sw, sa = signs[order].to(torch.int32), active[order]

    def lane_change(lane):
        out = torch.ones(n, dtype=torch.bool, device=dev)
        out[1:] = lane[1:] != lane[:-1]
        return out

    group_b = lane_change(sl)
    pair_b = group_b | lane_change(sv)
    pair_id = torch.cumsum(pair_b.to(torch.int64), 0) - 1
    dw = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, pair_id, torch.where(sa, sw, 0)
    )[pair_id]
    pair_rep = pair_b & sa

    # pre-state per pair: does the value already hold a lane?
    gslot = torch.where(sa, sl, 0)
    row_cnt = cnt[gslot]  # (n, K)
    row_vals = vals[gslot]
    match = (row_cnt > 0) & (row_vals == sv[:, None])
    exists = match.any(1)
    match_lane = torch.argmax(match.to(torch.uint8), 1)  # the first matching lane

    # the j-th NEW pair of a group claims the j-th lane free before the
    # batch (a stable argsort of the occupied flags lists the free lanes
    # first); j = the pair's rank among its group's new pairs
    is_new = pair_rep & ~exists & (dw > 0)
    gid = torch.cumsum(group_b.to(torch.int64), 0) - 1
    c = torch.cumsum(is_new.to(torch.int64), 0)
    base = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, gid, torch.where(group_b, c - is_new.to(torch.int64), 0), reduce="amax",
        include_self=False,
    )[gid]
    new_rank = c - 1 - base
    free_order = torch.argsort((row_cnt > 0).to(torch.uint8), dim=1, stable=True)
    j = new_rank.clamp(0, K - 1)
    claim_lane = torch.gather(free_order, 1, j[:, None])[:, 0]
    claim_free = torch.gather(row_cnt, 1, claim_lane[:, None])[:, 0] == 0
    overflow = (is_new & ((new_rank >= K) | ~claim_free)).any()

    lane = torch.where(exists, match_lane, claim_lane)
    touch = pair_rep & (dw != 0) & (exists | (is_new & claim_free))
    # a negative net on a value with no lane, or one driving a count
    # below zero, is an inconsistent stream
    old_c = torch.gather(row_cnt, 1, lane[:, None])[:, 0]
    new_c = torch.where(exists, old_c, 0) + dw
    inconsistent = (pair_rep & (dw < 0) & ~exists).any() | (touch & (new_c < 0)).any()
    new_c = new_c.clamp_min(0)

    flat_at = (gslot * K + lane)[touch]
    _set_last_wins(cnt.view(-1), flat_at, new_c[touch].to(cnt.dtype))
    _set_last_wins(vals.view(-1), flat_at, sv[touch])

    # re-reduce each touched group from the POST state
    grp_rep = group_b & sa
    g_cnt = cnt[gslot]
    sentinel = accum_init(kind, vals.dtype, fx)
    masked = torch.where(g_cnt > 0, vals[gslot], torch.full((), sentinel, dtype=vals.dtype,
                                                            device=dev))
    extreme = masked.amin(1) if kind == "min" else masked.amax(1)
    total = g_cnt.sum(1, dtype=torch.int64)
    rep_slots = torch.where(grp_rep, sl, -1).to(torch.int32)
    return vals, cnt, rep_slots, extreme, total, overflow, inconsistent


def _minput_apply_cuda(vals, cnt, slots, signs, v, notnull, kind, accum, nonnull, overflow,
                       inconsistent):
    n = v.shape[0]
    cap, k = cnt.shape
    if slots.dtype != torch.int32 or signs.dtype != torch.int32:
        raise TypeError("minput_apply: slots and signs must be int32")
    if cnt.dtype != torch.int32 or vals.dtype not in (torch.int32, torch.int64):
        raise TypeError("minput_apply: cnt int32, vals int32 or int64")
    if vals.shape != (cap, k) or accum.dtype != vals.dtype or nonnull.dtype != torch.int64:
        raise TypeError("minput_apply: accum in vals' dtype, nonnull int64, vals as cnt")
    if v.dtype == torch.bool:
        raise TypeError("minput_apply: a bool input has no extreme")
    for latch in (overflow, inconsistent):
        if latch.shape != () or latch.dtype != torch.bool:
            raise TypeError("minput_apply: latches are () bool tensors")
    lanes = (slots, signs, v) + (() if notnull is None else (notnull,))
    _kernels.check_cuda("minput", *lanes, n=n)
    if notnull is not None and notnull.dtype != torch.bool:
        raise TypeError("minput_apply: notnull must be bool")
    _kernels.check_cuda("minput", accum, nonnull, n=cap)
    _kernels.check_cuda("minput", vals, cnt, overflow, inconsistent, v)
    fx = v.dtype if v.dtype.is_floating_point else None
    h = pow2_at_least(max(2 * n, 64))
    scratch = torch.empty(6 * h + 2 * max(n, 1) + 2, dtype=torch.int32, device=v.device)
    _kernels.call(
        "minput", "rw_minput_apply", n, slots.data_ptr(), signs.data_ptr(), v.data_ptr(),
        _kernels.dtype_code(v), 0 if notnull is None else notnull.data_ptr(),
        int(kind == "max"), vals.data_ptr(), _kernels.dtype_code(vals), cnt.data_ptr(), cap, k,
        accum.data_ptr(), nonnull.data_ptr(), overflow.data_ptr(), inconsistent.data_ptr(),
        accum_init(kind, vals.dtype, fx), scratch.data_ptr(), h,
    )


def minput_clear(vals: torch.Tensor, cnt: torch.Tensor, slots: torch.Tensor) -> None:
    """Free whole groups in place (window expiry): every lane of each
    slot in ``slots`` (-1 skips) gets count 0."""
    if cnt.device.type == "cpu":
        _minput_clear_torch(cnt, slots)
    elif cnt.device.type == "cuda":
        _minput_clear_cuda(cnt, slots)
    else:
        raise ValueError(f"unsupported device {cnt.device}")


def _minput_clear_torch(cnt, slots):
    cnt[slots[slots >= 0].long()] = 0


def _minput_clear_cuda(cnt, slots):
    n, k = slots.shape[0], cnt.shape[1]
    if slots.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError("minput_clear: slots and cnt must be int32")
    _kernels.check_cuda("minput_clear", slots, n=n)
    _kernels.check_cuda("minput_clear", cnt, slots)
    _kernels.call("minput", "rw_minput_clear", n, slots.data_ptr(), cnt.data_ptr(),
                  cnt.shape[0], k)


def minput_rescatter(vals: torch.Tensor, cnt: torch.Tensor, keep: torch.Tensor,
                     new_slots: torch.Tensor, new_cap: int, init: int = 0):
    """Rehash support: a fresh ``(new_cap, K)`` pair with row i of every
    kept old slot at ``new_slots[i]``; a kept slot without a new slot
    (-1) moves nothing, as kernel I. Unmoved value lanes hold ``init``
    (``vals_init`` of the call's input)."""
    k = cnt.shape[1]
    nv = torch.full((new_cap, k), init, dtype=vals.dtype, device=vals.device)
    nc = torch.zeros((new_cap, k), dtype=cnt.dtype, device=cnt.device)
    if cnt.device.type == "cpu":
        _minput_rescatter_torch(vals, cnt, keep, new_slots, nv, nc)
    elif cnt.device.type == "cuda":
        _minput_rescatter_cuda(vals, cnt, keep, new_slots, nv, nc)
    else:
        raise ValueError(f"unsupported device {cnt.device}")
    return nv, nc


def _minput_rescatter_torch(vals, cnt, keep, new_slots, nv, nc):
    move = keep & (new_slots >= 0)
    at = new_slots[move].long()
    nv[at] = vals[move]
    nc[at] = cnt[move]


def _minput_rescatter_cuda(vals, cnt, keep, new_slots, nv, nc):
    n, k = cnt.shape
    if new_slots.dtype != torch.int32 or keep.dtype != torch.bool:
        raise TypeError("minput_rescatter: new_slots int32, keep bool")
    if vals.shape != (n, k) or nv.shape[1] != k or nc.shape != nv.shape:
        raise ValueError("minput_rescatter: lanes of one K")
    _kernels.check_cuda("minput_rescatter", keep, new_slots, n=n)
    _kernels.check_cuda("minput_rescatter", vals, cnt, nv, nc, keep)
    _kernels.call(
        "minput", "rw_minput_rescatter", n, k, keep.data_ptr(), new_slots.data_ptr(),
        vals.data_ptr(), nv.data_ptr(), vals.element_size(), cnt.data_ptr(), nc.data_ptr(),
    )
