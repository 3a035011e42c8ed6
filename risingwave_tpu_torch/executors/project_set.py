"""ProjectSet executor — table-function row expansion.

Port of ``risingwave_tpu/executors/project_set.py`` (``_unnest_step``
:31, ``_series_step`` :54, ``ProjectSetExecutor`` :75). Reference:
src/stream/src/executor/project_set.rs — each input row expands into
the rows its table function yields (unnest, generate_series), tagged
with a ``projected_row_id`` ordinal; scalar select items repeat per
produced row.

The expansion factor is static — ``list_cap`` for unnest over a LIST
column, ``max_steps`` for generate_series — so a chunk of capacity C
becomes one chunk of capacity C * k with copy i forming the i-th
contiguous block of C rows (U-/U+ pairs stay adjacent, as the hop
window's); copies past a row's yield are masked invalid. On the card
one launch of kernel AA (``csrc/tile_expand.cu``: ``rw_unnest``,
``rw_series``) writes every output lane; on the CPU it is the plain
PyTorch version. The truncation latch stays on the card (set by the
same launch, or on the CPU by ``truncated``) and is read in one pinned
copy at the barrier.

Like the reference, the executor has no pure step and its own
``on_barrier``, so ``fuse_chain`` leaves it interpreted and closes the
fusible run in front of it.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.array.composite import LIST_LEN_SUFFIX
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.ops.hash_table import stage_scalars

# the most copies of a row one launch of kernel AA makes
# (csrc/tile_expand.cu TE_MAX_COPIES)
TILE_COPIES = 64


def _tile(a: torch.Tensor, k: int) -> torch.Tensor:
    return a.repeat(k)


def _copy_index(k: int, cap: int, device) -> torch.Tensor:
    """Copy i of every row: ``i`` repeated over its block of ``cap`` rows."""
    return torch.arange(k, dtype=torch.int64, device=device).repeat_interleave(cap)


def unnest_step(chunk: StreamChunk, col: str, out: str, k: int, ordinal: bool,
                latch: Optional[torch.Tensor] = None) -> StreamChunk:
    """Expand a LIST column's element lanes (array/composite layout:
    ``col.0`` .. ``col.<k-1>`` + ``col.#`` length); copy i carries
    element i, valid where i < the length. The list's own lanes go.
    ``latch`` (a () bool), where given, is set where a valid list is
    longer than k."""
    if chunk.valid.device.type == "cpu":
        if latch is not None:
            latch |= truncated(chunk, "unnest", col, None, k)
        return _unnest_torch(chunk, col, out, k, ordinal)
    if chunk.valid.device.type == "cuda":
        return _unnest_cuda(chunk, col, out, k, ordinal, latch)
    raise ValueError(f"unsupported device {chunk.valid.device}")


def series_step(chunk: StreamChunk, start_col: str, stop_col: str, out: str, k: int,
                ordinal: bool, latch: Optional[torch.Tensor] = None) -> StreamChunk:
    """generate_series(start, stop) inclusive, step 1, capped at k. A
    NULL bound yields an EMPTY series (the reference's table-function
    NULL semantics). ``latch`` (a () bool), where given, is set where a
    valid row's non-NULL bounds span more than k."""
    if chunk.valid.device.type == "cpu":
        if latch is not None:
            latch |= truncated(chunk, "series", start_col, stop_col, k)
        return _series_torch(chunk, start_col, stop_col, out, k, ordinal)
    if chunk.valid.device.type == "cuda":
        return _series_cuda(chunk, start_col, stop_col, out, k, ordinal, latch)
    raise ValueError(f"unsupported device {chunk.valid.device}")


def _list_lanes(chunk: StreamChunk, col: str) -> set:
    return {n for n in chunk.columns if n.startswith(col + ".") or n == col + LIST_LEN_SUFFIX}


def _unnest_torch(chunk, col, out, k, ordinal):
    cap = chunk.capacity
    idx = _copy_index(k, cap, chunk.device)
    lens = chunk.col(col + LIST_LEN_SUFFIX)
    elem = torch.cat([chunk.col(f"{col}.{i}") for i in range(k)])
    in_list = idx < _tile(lens, k).to(idx.dtype)
    drop = _list_lanes(chunk, col)
    cols = {n: _tile(a, k) for n, a in chunk.columns.items() if n not in drop}
    cols[out] = elem
    if ordinal:
        cols["projected_row_id"] = idx
    nulls = {n: _tile(a, k) for n, a in chunk.nulls.items() if n in cols}
    valid = _tile(chunk.valid, k) & in_list
    return StreamChunk(cols, valid, nulls, _tile(chunk.ops, k))


def _series_torch(chunk, start_col, stop_col, out, k, ordinal):
    cap = chunk.capacity
    idx = _copy_index(k, cap, chunk.device)
    bounds_ok = ~chunk.null_of(start_col) & ~chunk.null_of(stop_col)
    start = _tile(chunk.col(start_col).to(torch.int64), k)
    stop = _tile(chunk.col(stop_col).to(torch.int64), k)
    val = start + idx
    in_series = (val <= stop) & _tile(bounds_ok, k)
    cols = {n: _tile(a, k) for n, a in chunk.columns.items()}
    cols[out] = val
    if ordinal:
        cols["projected_row_id"] = idx
    nulls = {n: _tile(a, k) for n, a in chunk.nulls.items() if n != out}
    valid = _tile(chunk.valid, k) & in_series
    return StreamChunk(cols, valid, nulls, _tile(chunk.ops, k))


def tile_lanes(pairs, what: str):
    """Kernel AA's lane rows ``(src, dst, esize, mode, keep)`` of
    ``(src, dst)`` pairs tiled as they are (mode 0)."""
    rows = []
    for src, dst in pairs:
        rows.append((src.data_ptr(), dst.data_ptr(), src.element_size(), 0, 0))
    if len(rows) > _kernels.TILE_LANES:
        raise ValueError(f"{what}: {len(rows)} lanes exceed kernel AA's {_kernels.TILE_LANES}")
    return rows


def _check_chunk(name: str, chunk: StreamChunk, k: int) -> None:
    if not 1 <= k <= TILE_COPIES:
        raise ValueError(f"{name}: {k} copies; kernel AA takes 1 to {TILE_COPIES}")
    if chunk.valid.dim() != 1:
        raise ValueError(f"{name}: lanes must be 1-D")
    if chunk.ops.dtype != torch.int32 or chunk.valid.dtype != torch.bool:
        raise TypeError(f"{name}: ops must be int32 and valid bool")
    _kernels.check_cuda(name, chunk.valid, chunk.ops, *chunk.columns.values(),
                        *chunk.nulls.values(), n=chunk.capacity)


def _int_lane(name: str, t: torch.Tensor, what: str) -> int:
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: {what} must be an int32 or int64 lane")
    return t.element_size()


def _latch_ptr(name: str, latch: Optional[torch.Tensor], chunk: StreamChunk) -> int:
    if latch is None:
        return 0
    if latch.dtype != torch.bool or latch.numel() != 1:
        raise TypeError(f"{name}: the latch must be one bool")
    _kernels.check_cuda(name, chunk.valid, latch)
    return latch.data_ptr()


def _unnest_cuda(chunk, col, out, k, ordinal, latch=None):
    _check_chunk("unnest", chunk, k)
    cap, dev = chunk.capacity, chunk.device
    lens = chunk.col(col + LIST_LEN_SUFFIX)
    elems = [chunk.col(f"{col}.{i}") for i in range(k)]
    if any(e.dtype != elems[0].dtype for e in elems):
        raise TypeError("unnest: element lanes of one dtype")
    drop = _list_lanes(chunk, col)
    empty = lambda t: torch.empty(cap * k, dtype=t.dtype, device=dev)
    value = empty(elems[0])
    cols, pairs = {}, []
    for n, a in chunk.columns.items():
        if n in drop:
            continue
        if n == out:
            cols[n] = value
        else:
            cols[n] = empty(a)
            pairs.append((a, cols[n]))
    cols[out] = value
    index = None
    if ordinal:
        cols["projected_row_id"] = index = torch.empty(cap * k, dtype=torch.int64, device=dev)
    nulls = {}
    for n, a in chunk.nulls.items():
        if n in cols:
            nulls[n] = empty(a)
            pairs.append((a, nulls[n]))
    valid, ops = empty(chunk.valid), empty(chunk.ops)
    lanes = tile_lanes(pairs, "unnest")
    _kernels.call(
        "tile_expand", "rw_unnest",
        _kernels.int64_rows(lanes, _kernels.TILE_LANES), len(lanes),
        _kernels.int64_rows([(e.data_ptr(),) for e in elems], TILE_COPIES), k,
        elems[0].element_size(), cap, chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        lens.data_ptr(), _int_lane("unnest", lens, "the length lane"), value.data_ptr(),
        0 if index is None else index.data_ptr(), valid.data_ptr(), ops.data_ptr(),
        _latch_ptr("unnest", latch, chunk),
    )
    return StreamChunk(cols, valid, nulls, ops)


def _series_cuda(chunk, start_col, stop_col, out, k, ordinal, latch=None):
    _check_chunk("series", chunk, k)
    cap, dev = chunk.capacity, chunk.device
    start, stop = chunk.col(start_col), chunk.col(stop_col)
    empty = lambda t: torch.empty(cap * k, dtype=t.dtype, device=dev)
    cols, pairs = {}, []
    value = torch.empty(cap * k, dtype=torch.int64, device=dev)
    for n, a in chunk.columns.items():
        if n == out:
            cols[n] = value
        else:
            cols[n] = empty(a)
            pairs.append((a, cols[n]))
    cols[out] = value
    index = None
    if ordinal:
        cols["projected_row_id"] = index = torch.empty(cap * k, dtype=torch.int64, device=dev)
    nulls = {}
    for n, a in chunk.nulls.items():
        if n != out:
            nulls[n] = empty(a)
            pairs.append((a, nulls[n]))
    valid, ops = empty(chunk.valid), empty(chunk.ops)
    lanes = tile_lanes(pairs, "series")
    s_null, t_null = chunk.nulls.get(start_col), chunk.nulls.get(stop_col)
    _kernels.call(
        "tile_expand", "rw_series",
        _kernels.int64_rows(lanes, _kernels.TILE_LANES), len(lanes), k, cap,
        chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        start.data_ptr(), _int_lane("series", start, "start"),
        stop.data_ptr(), _int_lane("series", stop, "stop"),
        0 if s_null is None else s_null.data_ptr(), 0 if t_null is None else t_null.data_ptr(),
        value.data_ptr(), 0 if index is None else index.data_ptr(), valid.data_ptr(),
        ops.data_ptr(), _latch_ptr("series", latch, chunk),
    )
    return StreamChunk(cols, valid, nulls, ops)


def truncated(chunk: StreamChunk, fn: str, col_a: str, col_b: Optional[str], cap: int):
    """Whether a valid row of ``chunk`` yields more than the static cap
    (a () bool on the chunk's device): a list longer than ``list_cap``,
    or a series with both bounds non-NULL spanning more than
    ``max_steps``. The CPU path's latch; on the card kernel AA sets it."""
    if fn == "unnest":
        return (chunk.valid & (chunk.col(col_a + LIST_LEN_SUFFIX) > cap)).any()
    bounds_ok = ~chunk.null_of(col_a) & ~chunk.null_of(col_b)
    span = chunk.col(col_b).to(torch.int64) - chunk.col(col_a).to(torch.int64) + 1
    return (chunk.valid & bounds_ok & (span > cap)).any()


class ProjectSetExecutor(Executor):
    """Table-function expansion. ``fn`` is "unnest" (over a LIST column
    laid out by array/composite) or "generate_series" (int bounds, step
    1, ``max_steps`` static cap — rows needing more raise via the
    overflow latch at the barrier)."""

    def __init__(
        self,
        fn: str,
        out: str = "value",
        list_col: Optional[str] = None,
        list_cap: Optional[int] = None,
        start_col: Optional[str] = None,
        stop_col: Optional[str] = None,
        max_steps: int = 64,
        ordinal: bool = True,
    ):
        if fn not in ("unnest", "generate_series"):
            raise ValueError(f"unknown table function {fn!r}")
        self.fn = fn
        self.out = out
        self.list_col = list_col
        self.list_cap = list_cap
        self.start_col = start_col
        self.stop_col = stop_col
        self.max_steps = max_steps
        self.ordinal = ordinal
        self._truncated = None  # () bool on the chunks' device, from the first chunk

    def _step(self, chunk: StreamChunk, latch: Optional[torch.Tensor] = None) -> StreamChunk:
        if self.fn == "unnest":
            return unnest_step(chunk, self.list_col, self.out, self.list_cap, self.ordinal,
                               latch)
        return series_step(chunk, self.start_col, self.stop_col, self.out, self.max_steps,
                           self.ordinal, latch)

    def trace_contract(self):
        return {
            "kind": "device",
            "trace_step": self._step,
            "state": None,
            "donate": True,
            # static expansion factor: the output capacity is a pure
            # function of the input's
            "emission": "passthrough",
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        if self._truncated is None or self._truncated.device != chunk.device:
            self._truncated = torch.zeros((), dtype=torch.bool, device=chunk.device)
        return [self._step(chunk, self._truncated)]

    def on_barrier(self, barrier) -> List[StreamChunk]:
        if self._truncated is not None:
            self._staged_scalars = stage_scalars(self._truncated)
        if barrier is None:  # direct drive: the check fires inline
            self.finish_barrier()
        return []

    def _on_barrier_scalars(self, vals) -> None:
        (hit,) = vals
        if hit:
            what = (
                "generate_series exceeded max_steps"
                if self.fn == "generate_series"
                else "unnest list exceeded list_cap"
            )
            raise RuntimeError(f"{what}; raise the cap")
