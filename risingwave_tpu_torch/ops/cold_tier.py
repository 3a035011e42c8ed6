"""The cold tier's device half (kernel AG, K30's cold half).

Replaces the jitted eviction and merge of the reference's cold tier:
the hot mask, the evicted count and the durable keys of
``risingwave_tpu/executors/hash_agg.py`` ``_evict`` (:330) and
``evict_cold`` (:879-931), the durable mask of ``hash_join.py``
``_evict_side`` (:617), the merge candidates of ``_merge_cold``
(:989, ``sdirty & ~stored`` pulled whole in the reference) and
``_cold_merge`` (:1217) with the ``set_live`` after it.

Two functions, each a plain PyTorch version on CPU tensors and an entry
of ``csrc/cold_tier.cu`` on CUDA tensors (no fallback):

- ``cold_select``: per slot the durable and hot masks of an agg state
  (``AGG``), a join side (``JOIN``) or the merge candidates
  (``MERGE``); the durable (or candidate) slots ascending, the hot
  mask, and the counts, read by the host once;
- ``cold_merge``: stored rows folded into distinct hit slots lane by
  lane (add, min, max, replace, set true), then ``live = row_count >
  0``; on the card the rows are packed on the host, copied once, and
  folded by one launch.

Faulting evicted keys back in needs no entry of its own: it is a
restore, kernel A's insert and kernel R's scatter
(``ops/checkpoint.insert_keys``, ``scatter_rows``), which sets ``live``
and ``stored`` from host rows in the same launch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import _numpy_dtype
from risingwave_tpu_torch.ops.checkpoint import _pack_host

AGG, JOIN, MERGE = 0, 1, 2  # cold_select modes (csrc/cold_tier.cu)
SET, ADD, MIN, MAX, TRUE = 0, 1, 2, 3, 4  # cold_merge ops (csrc/cold_tier.cu ColdOp)
# lanes one rw_cold_merge launch folds (csrc/cold_tier.cu CT_MAX_LANES)
MERGE_LANES = 40


def tensor_nbytes(obj) -> int:
    """Bytes of every tensor reachable from ``obj`` (dataclass fields,
    dicts, tuples, lists), from their sizes: no device read."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_nbytes(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return sum(tensor_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


class ColdSelect(NamedTuple):
    """``sel``: the durable slots (``MERGE``: the candidates), int32
    ascending; ``hot``: the hot mask (None for ``MERGE``); ``n_counted``:
    the agg's evicted count (durable and live or emitted), a join's
    durable count; ``n_hot``: the hot slots."""

    sel: torch.Tensor
    hot: Optional[torch.Tensor]
    n_counted: int
    n_hot: int


def cold_select(mode: int, fp1: torch.Tensor, live: torch.Tensor, sdirty: torch.Tensor,
                stored: torch.Tensor, ev: Optional[torch.Tensor] = None,
                dirty: Optional[torch.Tensor] = None,
                ddirty: Optional[torch.Tensor] = None) -> ColdSelect:
    """Per slot, with claimed = ``fp1 != 0``:

    - ``AGG``: durable = claimed & stored & ~sdirty & ~dirty, hot =
      (live | ev | dirty | sdirty) & claimed & ~durable, counted =
      durable & (live | ev) (the reference's ``(live | ev) & ~hot``);
    - ``JOIN``: durable = claimed & stored & ~sdirty & ~ddirty (a key
      whose stored rows' degrees moved is not durable), hot = claimed &
      ~durable, counted = durable;
    - ``MERGE``: the candidates sdirty & ~stored (groups created since
      the last checkpoint), counted = their number; no hot mask."""
    if mode not in (AGG, JOIN, MERGE):
        raise ValueError(f"cold_select: unknown mode {mode}")
    if mode == AGG and (ev is None or dirty is None):
        raise ValueError("cold_select: an agg state needs its ev and dirty lanes")
    dev = fp1.device
    if dev.type == "cpu":
        return _cold_select_torch(mode, fp1, live, sdirty, stored, ev, dirty, ddirty)
    if dev.type == "cuda":
        return _cold_select_cuda(mode, fp1, live, sdirty, stored, ev, dirty, ddirty)
    raise ValueError(f"unsupported device {dev}")


def _cold_select_torch(mode, fp1, live, sdirty, stored, ev, dirty, ddirty):
    if mode == MERGE:
        cand = sdirty & ~stored
        sel = torch.nonzero(cand).flatten().to(torch.int32)
        return ColdSelect(sel, None, int(sel.numel()), 0)
    claimed = fp1 != 0
    if mode == AGG:
        alive = live | ev
        durable = claimed & stored & ~sdirty & ~dirty
        hot = (alive | dirty | sdirty) & claimed & ~durable
        counted = durable & alive
    else:
        durable = claimed & stored & ~sdirty
        if ddirty is not None:
            durable &= ~ddirty
        hot = claimed & ~durable
        counted = durable
    sel = torch.nonzero(durable).flatten().to(torch.int32)
    return ColdSelect(sel, hot, int(counted.sum()), int(hot.sum()))


def _cold_select_cuda(mode, fp1, live, sdirty, stored, ev, dirty, ddirty):
    sel, hot, status = _cold_select_launch(mode, fp1, live, sdirty, stored, ev, dirty, ddirty)
    n, counted, n_hot = status.tolist()  # the one scalar read
    return ColdSelect(sel[:n], hot, int(counted), int(n_hot))


def _cold_select_launch(mode, fp1, live, sdirty, stored, ev=None, dirty=None, ddirty=None):
    """The select's launch: ``(sel, hot, status)`` on the card, sel of
    capacity length, its first ``status[0]`` entries written."""
    cap = fp1.shape[0]
    if mode != AGG:
        ev = dirty = None
    if mode != JOIN:
        ddirty = None
    marks = [live, sdirty, stored] + [t for t in (ev, dirty, ddirty) if t is not None]
    _kernels.check_cuda("cold_tier", fp1, *marks, n=cap)
    if fp1.dtype != torch.int32 or any(t.dtype != torch.bool for t in marks):
        raise TypeError("cold_select: int32 fp1 and bool marks")
    dev = fp1.device
    tile_counts = _kernels.compact_scratch(cap, dev)
    sel = torch.empty(cap, dtype=torch.int32, device=dev)
    payload = torch.empty(cap, dtype=torch.uint8, device=dev)
    hot = None if mode == MERGE else torch.empty(cap, dtype=torch.bool, device=dev)
    status = torch.empty(3, dtype=torch.int64, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _kernels.call(
        "cold_tier", "rw_cold_select", mode, cap, fp1.data_ptr(), live.data_ptr(), ptr(ev),
        ptr(dirty), sdirty.data_ptr(), stored.data_ptr(), ptr(ddirty), ptr(hot),
        tile_counts.data_ptr(), sel.data_ptr(), payload.data_ptr(), status.data_ptr(),
    )
    return sel, hot, status


class MergeLane(NamedTuple):
    """One lane of a merge: ``rows[name]`` folded into ``dst`` by ``op``
    (``TRUE`` takes no rows)."""

    name: str
    dst: torch.Tensor
    op: int


def cold_merge(lanes: Sequence[MergeLane], slots: torch.Tensor, rows: Dict[str, np.ndarray],
               row_count: torch.Tensor, live: torch.Tensor) -> None:
    """For each distinct hit slot ``slots[r]`` (int32, >= 0) and each
    lane: ``dst[s] = dst[s] + row`` (``ADD``), ``min``/``max`` of the
    two (``MIN``/``MAX``, integer lanes: float extremes are order keys),
    ``row`` (``SET``) or True (``TRUE``), rows cast to the lane's dtype;
    then ``live[s] = row_count[s] > 0``, with ``row_count`` among the
    lanes. In place."""
    n = slots.shape[0]
    host = {}
    for ln in lanes:
        if ln.op == TRUE:
            continue
        if ln.op in (MIN, MAX) and (ln.dst.is_floating_point() or ln.dst.dtype == torch.bool):
            raise TypeError(f"cold_merge: {ln.name}: min/max take integer lanes")
        if ln.op == ADD and ln.dst.dtype == torch.bool:
            raise TypeError(f"cold_merge: {ln.name}: add takes numeric lanes")
        r = np.ascontiguousarray(np.asarray(rows[ln.name]), dtype=_numpy_dtype(ln.dst.dtype))
        if r.shape != (n,):
            raise ValueError(f"cold_merge: rows of {ln.name!r} are {r.shape}, want {(n,)}")
        host[ln.name] = r
    dev = slots.device
    if dev.type == "cpu":
        _cold_merge_torch(lanes, slots, host, row_count, live)
    elif dev.type == "cuda":
        _cold_merge_cuda(lanes, slots, host, row_count, live)
    else:
        raise ValueError(f"unsupported device {dev}")


def _cold_merge_torch(lanes, slots, host, row_count, live):
    idx = slots.long()
    for ln in lanes:
        d = ln.dst
        if ln.op == TRUE:
            d[idx] = True
            continue
        v = torch.from_numpy(host[ln.name]).to(d.device)
        if ln.op == ADD:
            d[idx] = d[idx] + v
        elif ln.op == MIN:
            d[idx] = torch.minimum(d[idx], v)
        elif ln.op == MAX:
            d[idx] = torch.maximum(d[idx], v)
        else:
            d[idx] = v
    live[idx] = row_count[idx] > 0


def _cold_merge_cuda(lanes, slots, host, row_count, live):
    n = slots.shape[0]
    if n == 0:
        return
    with_rows = {ln.name: ln.dst for ln in lanes if ln.op != TRUE}
    packed, layout = None, []
    if with_rows:
        staged, layout = _pack_host(with_rows, host, n)
        packed = staged.to(slots.device, non_blocking=True)  # the one copy to the card
    _cold_merge_launch(lanes, slots, packed, layout, row_count, live)


def _cold_merge_launch(lanes, slots, packed, layout, row_count, live) -> None:
    """The merge's launch: every lane folded from its block of the packed
    device buffer (``layout`` as ``ops/checkpoint._layout`` gives it)."""
    n = slots.shape[0]
    if len(lanes) > MERGE_LANES:
        raise ValueError(f"cold_merge: {len(lanes)} lanes exceed kernel AG's {MERGE_LANES}")
    if slots.dtype != torch.int32 or row_count.dtype != torch.int64 or live.dtype != torch.bool:
        raise TypeError("cold_merge: int32 slots, int64 row_count and bool live")
    cap = live.shape[0]
    _kernels.check_cuda("cold_tier", slots, n=n)
    _kernels.check_cuda("cold_tier", row_count, live, *(ln.dst for ln in lanes), n=cap)
    at = {name: off for name, off, _ in layout}
    rows = [
        (ln.dst.data_ptr(), 0 if ln.op == TRUE else packed.data_ptr() + at[ln.name], ln.op,
         _kernels.dtype_code(ln.dst))
        for ln in lanes
    ]
    _kernels.call(
        "cold_tier", "rw_cold_merge", _kernels.int64_rows(rows, MERGE_LANES), len(rows),
        slots.data_ptr(), n, row_count.data_ptr(), live.data_ptr(),
    )


def agg_merge_lanes(state, calls) -> List[MergeLane]:
    """The lanes of an agg state's merge, as the reference's
    ``_cold_merge``: counts and sums add, MIN/MAX fold, the non-null
    counts add, the emitted snapshots and ``ev`` replace, ``dirty``,
    ``sdirty`` and ``stored`` set."""
    out = [MergeLane("row_count", state.row_count, ADD)]
    for c in calls:
        op = {"min": MIN, "max": MAX}.get(c.kind, ADD)
        out.append(MergeLane(f"acc_{c.output}", state.accums[c.output], op))
        if c.output in state.nonnull:
            out.append(MergeLane(f"nn_{c.output}", state.nonnull[c.output], ADD))
    out += [MergeLane(f"em_{n}", a, SET) for n, a in state.emitted.items()]
    out += [MergeLane(f"ei_{n}", a, SET) for n, a in state.emitted_isnull.items()]
    out += [MergeLane("ev", state.emitted_valid, SET), MergeLane("dirty", state.dirty, TRUE),
            MergeLane("sdirty", state.sdirty, TRUE), MergeLane("stored", state.stored, TRUE)]
    return out
