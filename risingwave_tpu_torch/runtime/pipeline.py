"""Single-fragment pipeline: an ordered executor chain + epoch loop.

Port of ``risingwave_tpu/runtime/pipeline.py:79-208`` (``walk_chain``,
``Pipeline``) without the profiler, signature watch, transfer guard and
fused overlay. Reference: the actor's executor chain
(src/stream/src/executor/mod.rs:180) and barrier flow-through
(src/stream/src/task/barrier_manager.rs:634): a barrier flushes each
executor in turn, and a flush's output is data for the rest of the
chain. Epochs follow the reference encoding (physical ms << 16,
src/common/src/util/epoch.rs:36).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Barrier, Epoch, Executor, Watermark


def walk_chain(chain: Sequence[Executor], chunks, barrier=None):
    """Feed chunks (then optionally a barrier) down an executor chain;
    every executor's output — its barrier flush included — is data for
    the executors below it."""
    pending = list(chunks)
    for ex in chain:
        nxt: List[StreamChunk] = []
        for c in pending:
            nxt.extend(ex.apply(c))
        if barrier is not None:
            nxt.extend(ex.on_barrier(barrier))
        pending = nxt
    return pending


def _walk_watermark(chain: Sequence[Executor], wm: Optional[Watermark]):
    """Walk a watermark down a chain, feeding each executor's flushed
    chunks through the rest of it. Returns (watermark | None, chunks)."""
    pending: List[StreamChunk] = []
    for ex in chain:
        nxt: List[StreamChunk] = []
        for c in pending:
            nxt.extend(ex.apply(c))
        if wm is not None:
            wm, outs = ex.on_watermark(wm)
            nxt.extend(outs)
        pending = nxt
    return wm, pending


class Pipeline:
    """An ordered chain of executors driven by the host epoch loop."""

    def __init__(self, executors: Sequence[Executor]):
        self.executors = list(executors)
        self._epoch = 0

    def push(self, chunk: StreamChunk) -> List[StreamChunk]:
        """Feed one data chunk into the chain; returns what falls out."""
        return walk_chain(self.executors, [chunk])

    def barrier(self, checkpoint: bool = True) -> List[StreamChunk]:
        """Inject a barrier; each executor's flush output becomes data
        for the rest of the chain. Every executor's staged barrier
        scalars are read after the walk, so their checks raise before
        the barrier returns."""
        prev = self._epoch
        self._epoch = max(int(time.time() * 1000) << 16, prev + 1)
        pending = walk_chain(
            self.executors, [], barrier=Barrier(Epoch(prev, self._epoch), checkpoint)
        )
        for ex in self.executors:
            ex.finish_barrier()
        return pending

    def watermark(self, column: str, value: int) -> List[StreamChunk]:
        """Propagate a watermark; executors may transform or consume it,
        and their flush outputs flow downstream as data."""
        _, pending = _walk_watermark(self.executors, Watermark(column, value))
        return pending
