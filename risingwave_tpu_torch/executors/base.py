"""Executor protocol + control messages.

Port of ``risingwave_tpu/executors/base.py``. Reference:
src/stream/src/executor/mod.rs — the ``Execute`` trait (:180), barriers
with epoch pairs (:276) and per-column watermarks (:871).

The host drives the chain: ``apply(chunk)`` for data, ``on_barrier`` /
``on_watermark`` for control, each returning chunks for the next
executor. Device state lives in each executor as torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from risingwave_tpu_torch.array.chunk import StreamChunk


@dataclass(frozen=True)
class Epoch:
    """EpochPair analogue (reference: src/common/src/util/epoch.rs:31)."""

    prev: int
    curr: int


@dataclass(frozen=True)
class Barrier:
    """A barrier message (reference: executor/mod.rs:276)."""

    epoch: Epoch
    checkpoint: bool = True


@dataclass(frozen=True)
class Watermark:
    """Monotonic per-column lower bound: no future row carries
    ``column < value`` (reference: executor/mod.rs:871)."""

    column: str
    value: int


class Executor:
    """Base executor. Subclasses override what they react to."""

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        return [chunk]

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        return []

    def on_watermark(self, watermark: Watermark):
        """Returns ``(downstream_watermark | None, output_chunks)``."""
        return watermark, []

    def emit_watermark(self):
        """A watermark this executor generates itself, or None; the
        pipeline polls it after every barrier (the watermark filter
        generates one)."""
        return None

    def pure_step(self):
        """A pure callable chunk -> chunk equivalent to ``apply``
        (exactly one output chunk, no state), or None. The port's pure
        steps are frozen dataclasses, so two equal plans compare equal,
        and also map a stacked chunk (lanes of shape (n_chunks, C))
        chunk by chunk, the reference's ``vmap``. ``step.rows(C)`` is
        the output capacity of one C-row chunk. An epoch-batching
        wrapper runs the step inside the fused per-barrier program
        (reference: ``executors/base.py:176``)."""
        return None

    # -- barrier scalar reads -------------------------------------------
    # An executor that checks device scalars at the barrier (overflow
    # latches, occupancy) stages one packed lane in ``on_barrier``
    # (``ops.hash_table.stage_scalars``: an asynchronous copy into
    # pinned host memory); the pipeline calls ``finish_barrier`` on
    # every executor after the walk, which waits for each copy and runs
    # ``_on_barrier_scalars``.

    _staged_scalars = None

    def finish_barrier(self) -> None:
        if self._staged_scalars is None:
            return
        from risingwave_tpu_torch.ops.hash_table import finish_scalars

        vals = finish_scalars(self._staged_scalars)
        self._staged_scalars = None
        self._on_barrier_scalars(vals)

    def _on_barrier_scalars(self, vals) -> None:
        return None
