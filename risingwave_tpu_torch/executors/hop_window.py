"""Hop (sliding) window executor — row expansion.

Port of ``risingwave_tpu/executors/hop_window.py:27-114``. Reference:
src/stream/src/executor/hop_window.rs — each row falls into size/slide
overlapping windows and is emitted once per window with its start.

A chunk of capacity C becomes one of capacity C * factor in block
layout (copy k of every row forms one contiguous C-row block), so
adjacent U-/U+ rows stay adjacent. Plain PyTorch for now: fusing this
expansion with the key hash (K8 + K1) is a later kernel.
"""

from __future__ import annotations

from typing import List

import torch

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark


def hop_step_fn(
    chunk: StreamChunk, ts_col: str, size_ms: int, slide_ms: int, out_start: str
) -> StreamChunk:
    factor = -(-size_ms // slide_ms)  # ceil
    cap = chunk.capacity

    def tile(a):
        return a.repeat(factor)

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
        return [
            hop_step_fn(chunk, self.ts_col, self.size_ms, self.slide_ms, self.out_start)
        ]

    def on_watermark(self, watermark: Watermark):
        """Event-time watermark -> window_start watermark: a future row
        (ts >= wm) lands only in windows with start >= first_start(wm)."""
        if watermark.column != self.ts_col:
            return watermark, []
        first = ((watermark.value - self.size_ms) // self.slide_ms + 1) * self.slide_ms
        return Watermark(self.out_start, first), []
