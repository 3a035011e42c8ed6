"""Checkpoint staging and restore of slot-indexed state (kernel R).

Replaces the device half of the reference's checkpoint pull and
restore: the staging marks every Checkpointable executor computes from
its ``sdirty``/alive/``stored`` lanes pulled to the host in full
(``risingwave_tpu/storage/state_table.py:stage_marks`` :102, used at
``executors/hash_agg.py:1289``, ``hash_join.py:915``, ``dedup.py:315``,
``dynamic_filter.py:361``, ``materialize.py:841``), K32's ``_gather``
(``state_table.py:165``), K30's checkpoint half (``hash_agg.py:1262``
``_mark_checkpointed``, ``hash_join.py:893`` ``_side_mark_checkpointed``
and the same flips of dedup, the filter and the MV), and the restores'
per-lane ``.at[slots].set``.

Four functions, each a plain PyTorch version on CPU tensors and an
entry of ``csrc/checkpoint.cu`` on CUDA tensors (no fallback):

- ``stage_select``: the selected slots (upsert = sdirty & alive, tomb =
  sdirty & stored & ~alive), ascending, with ``tomb[sel]``; on the card
  the count is one device scalar pair, read once by the host;
- ``gather_rows``: every lane's rows at ``sel`` as numpy arrays; on the
  card one launch packs all lanes into one device buffer, copied once
  to pinned host memory;
- ``mark_checkpointed``: ``stored[sel] = ~tomb``, every ``sdirty``
  cleared, in place;
- ``scatter_rows``: the inverse of the gather for a restore; on the card
  the rows are packed on the host, copied once, and landed by one
  launch (a slot < 0 drops its row). ``insert_keys`` gives a restore
  the slots (kernel A).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import _numpy_dtype, to_device
from risingwave_tpu_torch.ops.hash_table import HashTable, lookup_or_insert

_ALIGN = 16  # byte alignment of each lane's block in a packed buffer


def stage_select(
    sdirty: torch.Tensor, alive: Sequence[torch.Tensor], stored: torch.Tensor,
    ddirty: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """``(sel, tomb, n, n_dirty)``: the ``n`` slots to stage (int32,
    ascending) and their tombstone flags, and the number of dirty
    slots, dirty = ``sdirty`` (or ``sdirty | ddirty``, a join side's
    moved degrees). ``alive`` is one to three bool lanes whose OR is the
    alive mask. The host reads the two counts once."""
    alive = tuple(alive)
    if not 1 <= len(alive) <= 3:
        raise ValueError("stage_select takes one to three alive lanes")
    dev = sdirty.device
    if dev.type == "cpu":
        return _stage_select_torch(sdirty, alive, stored, ddirty)
    if dev.type == "cuda":
        return _stage_select_cuda(sdirty, alive, stored, ddirty)
    raise ValueError(f"unsupported device {dev}")


def _stage_select_torch(sdirty, alive, stored, ddirty=None):
    live = alive[0].clone()
    for a in alive[1:]:
        live |= a
    dirty = sdirty if ddirty is None else sdirty | ddirty
    upsert = dirty & live
    tomb = dirty & stored & ~live
    sel = torch.nonzero(upsert | tomb).flatten()
    return sel.to(torch.int32), tomb[sel], int(sel.numel()), int(dirty.sum())


def _stage_select_cuda(sdirty, alive, stored, ddirty=None):
    sel, tomb, status = _stage_select_launch(sdirty, alive, stored, ddirty)
    n, n_dirty = status.tolist()  # the one scalar read of a checkpoint
    return sel[:n], tomb[:n], int(n), int(n_dirty)


def _stage_select_launch(sdirty, alive, stored, ddirty=None):
    """The select's launch: ``(sel, tomb, status)`` on the card, sel and
    tomb of capacity length, their first ``status[0]`` entries written."""
    cap = sdirty.shape[0]
    lanes = (sdirty, stored, *alive) + (() if ddirty is None else (ddirty,))
    _kernels.check_cuda("checkpoint", *lanes, n=cap)
    for t in lanes:
        if t.dtype != torch.bool or t.data_ptr() % _ALIGN:
            raise ValueError("checkpoint: select lanes must be 16-byte aligned bool lanes")
    dev = sdirty.device
    tile_counts = _kernels.compact_scratch(cap, dev)
    sel = torch.empty(cap, dtype=torch.int32, device=dev)
    tomb = torch.empty(cap, dtype=torch.bool, device=dev)
    status = torch.empty(2, dtype=torch.int64, device=dev)
    ptrs = [a.data_ptr() for a in alive] + [0] * (3 - len(alive))
    _kernels.call(
        "checkpoint", "rw_stage_select", sdirty.data_ptr(),
        0 if ddirty is None else ddirty.data_ptr(), *ptrs, len(alive),
        stored.data_ptr(), cap, tile_counts.data_ptr(), sel.data_ptr(), tomb.data_ptr(),
        status.data_ptr(),
    )
    return sel, tomb, status


def _row_bytes(t: torch.Tensor) -> int:
    return t[0].numel() * t.element_size() if t.dim() > 1 else t.element_size()


def _unit(row_bytes: int, *ptrs: int) -> int:
    """Largest move width that divides the row and every base address."""
    for u in (16, 8, 4, 2):
        if row_bytes % u == 0 and all(p % u == 0 for p in ptrs):
            return u
    return 1


def _layout(lanes: Dict[str, torch.Tensor], n: int):
    """(name, offset, row_bytes) of each lane's block in a packed buffer
    of n rows per lane, and the buffer's size."""
    out, off = [], 0
    for name, t in lanes.items():
        rb = _row_bytes(t)
        out.append((name, off, rb))
        off += -(-(n * rb) // _ALIGN) * _ALIGN
    return out, off


def gather_rows(lanes: Dict[str, torch.Tensor], sel: torch.Tensor,
                compacted: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """Every lane's rows at the slots ``sel`` (int32), as numpy arrays of
    the lanes' dtypes, rows ``(n,) + lane.shape[1:]``, and each
    ``compacted`` tensor (already ``n`` rows, e.g. the select's tomb)
    as it is, in the same copy. Reads no row past ``len(sel)``."""
    compacted = dict(compacted or {})
    dev = sel.device
    if dev.type == "cpu":
        idx = sel.long()
        out = {k: a[idx].numpy() for k, a in lanes.items()}
        out.update({k: a.numpy() for k, a in compacted.items()})
        return out
    if dev.type == "cuda":
        return _gather_rows_cuda(lanes, sel, compacted)
    raise ValueError(f"unsupported device {dev}")


def _gather_rows_cuda(lanes, sel, compacted):
    n = sel.shape[0]
    every = {**lanes, **compacted}
    if n == 0:
        return {k: np.zeros((0,) + tuple(a.shape[1:]), _numpy_dtype(a.dtype)) for k, a in every.items()}
    packed, layout = _gather_packed(every, sel, set(compacted))
    host = torch.empty(packed.shape[0], dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)  # the one copy to the host
    torch.cuda.current_stream(sel.device).synchronize()
    return _unpack(host.numpy(), layout, every, n)


def _gather_packed(every, sel, compacted_names):
    """The gather's launch: every lane's rows at ``sel`` (a lane named in
    ``compacted_names`` as it is) packed into one device buffer;
    returns it and its layout."""
    n = sel.shape[0]
    if sel.dtype != torch.int32:
        raise TypeError("gather_rows: sel must be int32")
    _kernels.check_cuda("checkpoint", sel, n=n)
    layout, total = _layout(every, n)
    packed = torch.empty(total, dtype=torch.uint8, device=sel.device)
    rows = []
    for name, off, rb in layout:
        a = every[name]
        _kernels.check_cuda("checkpoint", a, sel)
        direct = name in compacted_names
        if direct and a.shape[0] != n:
            raise ValueError(f"gather_rows: compacted {name!r} holds {a.shape[0]} rows, not {n}")
        ptr = packed.data_ptr() + off
        rows.append((a.data_ptr(), ptr, rb, _unit(rb, a.data_ptr(), ptr), int(direct)))
    for at in range(0, len(rows), _kernels.CHECKPOINT_LANES):
        part = rows[at:at + _kernels.CHECKPOINT_LANES]
        _kernels.call(
            "checkpoint", "rw_gather_rows", _kernels.int64_rows(part, _kernels.CHECKPOINT_LANES),
            len(part), sel.data_ptr(), n,
        )
    return packed, layout


def _unpack(buf: np.ndarray, layout, every, n: int) -> Dict[str, np.ndarray]:
    """Numpy views of each lane's rows in a packed host buffer."""
    return {
        name: buf[off:off + n * rb].view(_numpy_dtype(every[name].dtype))
        .reshape((n,) + tuple(every[name].shape[1:]))
        for name, off, rb in layout
    }


def mark_checkpointed(stored: torch.Tensor, sdirty: torch.Tensor, sel: torch.Tensor,
                      tomb: torch.Tensor, ddirty: Optional[torch.Tensor] = None) -> None:
    """After staging ``sel``: ``stored[sel] = ~tomb`` and every sdirty
    (and ``ddirty``) slot clears, in place."""
    dev = stored.device
    if dev.type == "cpu":
        stored[sel.long()] = ~tomb
        sdirty.zero_()
        if ddirty is not None:
            ddirty.zero_()
    elif dev.type == "cuda":
        _mark_checkpointed_cuda(stored, sdirty, sel, tomb, ddirty)
    else:
        raise ValueError(f"unsupported device {dev}")


def _mark_checkpointed_cuda(stored, sdirty, sel, tomb, ddirty=None):
    cap, n = stored.shape[0], sel.shape[0]
    _kernels.check_cuda("checkpoint", stored, sdirty, n=cap)
    if ddirty is not None:
        _kernels.check_cuda("checkpoint", ddirty, n=cap)
    if n:
        _kernels.check_cuda("checkpoint", sel, tomb, n=n)
    if sel.dtype != torch.int32 or tomb.dtype != torch.bool:
        raise TypeError("mark_checkpointed: int32 sel and bool tomb")
    _kernels.call(
        "checkpoint", "rw_mark_checkpointed", sel.data_ptr(), tomb.data_ptr(), n,
        stored.data_ptr(), sdirty.data_ptr(), 0 if ddirty is None else ddirty.data_ptr(), cap,
    )


def insert_keys(table: HashTable, key_cols: Dict[str, np.ndarray], n: int):
    """A restore's first step: the ``n`` recovered keys (``k0``, ``k1``,
    ... in the table's key dtypes) into ``table`` (kernel A on the
    card); returns ``(table, slots)``."""
    dev = table.device
    lanes = tuple(
        to_device(np.asarray(key_cols[f"k{i}"], dtype=_numpy_dtype(k.dtype)), dev)
        for i, k in enumerate(table.keys)
    )
    table, slots, _, _ = lookup_or_insert(table, lanes, torch.ones(n, dtype=torch.bool, device=dev))
    return table, slots


def scatter_rows(lanes: Dict[str, torch.Tensor], slots: torch.Tensor,
                 rows: Dict[str, np.ndarray]) -> None:
    """``lane[slots[r]] = rows[name][r]`` for every lane, in place; rows
    are cast to the lane's dtype, and a slot < 0 drops its row."""
    if not lanes:
        return
    n = slots.shape[0]
    host = {}
    for name, a in lanes.items():
        r = np.ascontiguousarray(np.asarray(rows[name]), dtype=_numpy_dtype(a.dtype))
        if r.shape != (n,) + tuple(a.shape[1:]):
            raise ValueError(f"scatter_rows: rows of {name!r} are {r.shape}, want "
                             f"{(n,) + tuple(a.shape[1:])}")
        host[name] = r
    dev = slots.device
    if dev.type == "cpu":
        ok = slots >= 0
        idx = slots[ok].long()
        for name, a in lanes.items():
            a[idx] = torch.from_numpy(host[name])[ok]
    elif dev.type == "cuda":
        _scatter_rows_cuda(lanes, slots, host)
    else:
        raise ValueError(f"unsupported device {dev}")


def _scatter_rows_cuda(lanes, slots, host):
    n = slots.shape[0]
    if n == 0:
        return
    staged, layout = _pack_host(lanes, host, n)
    packed = staged.to(slots.device, non_blocking=True)  # the one copy to the card
    _scatter_packed(lanes, slots, packed, layout)


def _pack_host(lanes, host, n: int):
    """Every lane's rows packed into one pinned host buffer; returns it
    and its layout."""
    layout, total = _layout(lanes, n)
    staged = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    buf = staged.numpy()
    for name, off, rb in layout:
        buf[off:off + n * rb] = host[name].reshape(-1).view(np.uint8)
    return staged, layout


def _scatter_packed(lanes, slots, packed, layout) -> None:
    """The scatter's launch: every lane's rows from the packed device
    buffer to their slots."""
    n = slots.shape[0]
    if slots.dtype != torch.int32:
        raise TypeError("scatter_rows: slots must be int32")
    _kernels.check_cuda("checkpoint", slots, n=n)
    rows = []
    for name, off, rb in layout:
        a = lanes[name]
        _kernels.check_cuda("checkpoint", a, slots)
        ptr = packed.data_ptr() + off
        rows.append((a.data_ptr(), ptr, rb, _unit(rb, a.data_ptr(), ptr), 0))
    for at in range(0, len(rows), _kernels.CHECKPOINT_LANES):
        part = rows[at:at + _kernels.CHECKPOINT_LANES]
        _kernels.call(
            "checkpoint", "rw_scatter_rows", _kernels.int64_rows(part, _kernels.CHECKPOINT_LANES),
            len(part), slots.data_ptr(), n,
        )
