"""Hop (sliding) window executor — row expansion.

Port of ``risingwave_tpu/executors/hop_window.py:27-114``. Reference:
src/stream/src/executor/hop_window.rs — each row falls into size/slide
overlapping windows and is emitted once per window with its start.

A chunk of capacity C becomes one of capacity C * factor in block
layout (copy k of every row forms one contiguous C-row block), so
adjacent U-/U+ rows stay adjacent. A stacked epoch (lanes of shape
(n_chunks, C)) expands chunk by chunk, as the reference's ``vmap``
does, into (n_chunks, C * factor) lanes whose row-major flatten is
chunk 0's block layout, then chunk 1's, and so on. On the card the
expansion is kernel E (``csrc/hop_expand.cu``); on the CPU it is the
plain PyTorch version below.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark


def hop_factor(size_ms: int, slide_ms: int) -> int:
    return -(-size_ms // slide_ms)  # ceil


def hop_step_fn(
    chunk: StreamChunk, ts_col: str, size_ms: int, slide_ms: int, out_start: str
) -> StreamChunk:
    """Expand every row into its windows; ``out_start`` gets the window
    start and ``valid`` keeps only rows inside their window. Lanes of
    shape (C,) or stacked (n_chunks, C)."""
    if chunk.valid.device.type == "cpu":
        return _hop_torch(chunk, ts_col, size_ms, slide_ms, out_start)
    if chunk.valid.device.type == "cuda":
        return _hop_cuda(chunk, ts_col, size_ms, slide_ms, out_start)
    raise ValueError(f"unsupported device {chunk.valid.device}")


def _hop_torch(chunk, ts_col, size_ms, slide_ms, out_start):
    factor = hop_factor(size_ms, slide_ms)
    cap = chunk.valid.shape[-1]

    def tile(a):  # along the row axis, whole lane per copy
        return a.repeat(*([1] * (a.dim() - 1)), factor)

    ts = chunk.col(ts_col)
    # earliest aligned window start strictly greater than ts - size
    first = (torch.div(ts - size_ms, slide_ms, rounding_mode="floor") + 1) * slide_ms
    k = torch.arange(factor, dtype=ts.dtype, device=ts.device).repeat_interleave(cap)
    starts = tile(first) + k * slide_ms
    in_window = starts <= tile(ts)  # start + size > ts holds by choice of first

    cols = {n: tile(a) for n, a in chunk.columns.items()}
    cols[out_start] = starts
    # a null lane on the output column must not survive the replacement
    nulls = {n: tile(a) for n, a in chunk.nulls.items() if n != out_start}
    return StreamChunk(cols, tile(chunk.valid) & in_window, nulls, tile(chunk.ops))


def _hop_cuda(chunk, ts_col, size_ms, slide_ms, out_start):
    factor = hop_factor(size_ms, slide_ms)
    cap = chunk.valid.shape[-1]
    lead = tuple(chunk.valid.shape[:-1])
    n_chunks = chunk.valid.numel() // cap if cap else 0
    ts = chunk.col(ts_col)
    if ts.dtype != torch.int64:
        raise TypeError(f"hop: {ts_col!r} must be an int64 timestamp lane")
    if chunk.ops.dtype != torch.int32:
        raise TypeError("hop: ops must be an int32 lane")
    lanes = [ts, chunk.valid, chunk.ops, *chunk.columns.values(), *chunk.nulls.values()]
    _kernels.check_cuda("hop_expand", *lanes)
    for t in lanes:
        if t.shape != chunk.valid.shape:
            raise ValueError("hop: every lane must have the valid lane's shape")
    out_shape = lead + (cap * factor,)
    dev = chunk.valid.device
    cols, nulls, copies = {}, {}, []
    for src, dst in ((chunk.columns, cols), (chunk.nulls, nulls)):
        for name, a in src.items():
            if name != out_start:  # the window start replaces a same-named lane
                dst[name] = torch.empty(out_shape, dtype=a.dtype, device=dev)
                copies.append((a.data_ptr(), dst[name].data_ptr(), a.element_size()))
    starts = torch.empty(out_shape, dtype=torch.int64, device=dev)
    valid = torch.empty(out_shape, dtype=torch.bool, device=dev)
    ops = torch.empty(out_shape, dtype=torch.int32, device=dev)
    _kernels.call(
        "hop_expand", "rw_hop_expand",
        _kernels.int64_rows(copies, _kernels.TILE_LANES), len(copies), n_chunks, cap, factor,
        size_ms, slide_ms,
        ts.data_ptr(), chunk.valid.data_ptr(), chunk.ops.data_ptr(),
        starts.data_ptr(), valid.data_ptr(), ops.data_ptr(),
    )
    # the plain version's column order: the input's, the window start
    # last unless it replaced an input column
    out_cols = {n: starts if n == out_start else cols[n] for n in chunk.columns}
    out_cols[out_start] = starts
    return StreamChunk(out_cols, valid, nulls, ops)


@dataclass(frozen=True)
class HopStep:
    """``hop_step_fn`` with its arguments bound: the executor's pure
    step (see ``Executor.pure_step``)."""

    ts_col: str
    size_ms: int
    slide_ms: int
    out_start: str

    def __call__(self, chunk: StreamChunk) -> StreamChunk:
        return hop_step_fn(chunk, self.ts_col, self.size_ms, self.slide_ms, self.out_start)

    def rows(self, capacity: int) -> int:
        return capacity * hop_factor(self.size_ms, self.slide_ms)

    def signature(self, sig: dict) -> dict:
        """Output ``{column: (dtype, nullable)}`` of an input signature."""
        out = {n: t for n, t in sig.items() if n != self.out_start}
        out[self.out_start] = (torch.int64, False)
        return out


class HopWindowExecutor(Executor):
    def __init__(
        self,
        ts_col: str,
        size_ms: int,
        slide_ms: int,
        out_start: str = "window_start",
    ):
        if size_ms % slide_ms:
            raise ValueError("size must be a multiple of slide")
        self.ts_col = ts_col
        self.size_ms = size_ms
        self.slide_ms = slide_ms
        self.out_start = out_start

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        return [self.pure_step()(chunk)]

    def pure_step(self) -> HopStep:
        return HopStep(self.ts_col, self.size_ms, self.slide_ms, self.out_start)

    def on_watermark(self, watermark: Watermark):
        """Event-time watermark -> window_start watermark: a future row
        (ts >= wm) lands only in windows with start >= first_start(wm)."""
        if watermark.column != self.ts_col:
            return watermark, []
        first = ((watermark.value - self.size_ms) // self.slide_ms + 1) * self.slide_ms
        return Watermark(self.out_start, first), []
