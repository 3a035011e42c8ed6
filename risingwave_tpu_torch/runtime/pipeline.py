"""Single-fragment pipeline: an ordered executor chain + epoch loop.

Port of ``risingwave_tpu/runtime/pipeline.py:79-208`` (``walk_chain``,
``Pipeline``) and :228-410 (``TwoInputPipeline``, with its ``_fused``
overlay and its executor-generated watermarks) without the profiler,
signature watch, transfer guard and freshness tracking. Reference: the actor's executor chain
(src/stream/src/executor/mod.rs:180) and barrier flow-through
(src/stream/src/task/barrier_manager.rs:634): a barrier flushes each
executor in turn, and a flush's output is data for the rest of the
chain. Epochs follow the reference encoding (physical ms << 16,
src/common/src/util/epoch.rs:36).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

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


def _epoch_after(prev: int) -> int:
    return max(int(time.time() * 1000) << 16, prev + 1)


class Pipeline:
    """An ordered chain of executors driven by the host epoch loop."""

    def __init__(self, executors: Sequence[Executor]):
        self.executors = list(executors)
        self._epoch = 0

    def push(self, chunk: StreamChunk) -> List[StreamChunk]:
        """Feed one data chunk into the chain; returns what falls out."""
        return walk_chain(self.executors, [chunk])

    def barrier(self, checkpoint: bool = True, epoch: Optional[int] = None) -> List[StreamChunk]:
        """Inject a barrier; each executor's flush output becomes data
        for the rest of the chain. A watermark an executor generates
        (``emit_watermark``, the watermark filter) then walks the rest of
        the chain. Every executor's staged barrier scalars are read after
        the walk, so their checks raise before the barrier returns.
        ``epoch`` pins the barrier's curr epoch (``NowExecutor`` reads
        it); by default it comes from the wall clock."""
        prev = self._epoch
        self._epoch = _epoch_after(prev) if epoch is None else epoch
        pending = walk_chain(
            self.executors, [], barrier=Barrier(Epoch(prev, self._epoch), checkpoint)
        )
        for i, ex in enumerate(self.executors):
            wm = ex.emit_watermark()
            if wm is not None:
                _, outs = _walk_watermark(self.executors[i + 1:], wm)
                pending.extend(outs)
        for ex in self.executors:
            ex.finish_barrier()
        return pending

    def watermark(self, column: str, value: int) -> List[StreamChunk]:
        """Propagate a watermark; executors may transform or consume it,
        and their flush outputs flow downstream as data."""
        _, pending = _walk_watermark(self.executors, Watermark(column, value))
        return pending

    @property
    def epoch(self) -> int:
        """The epoch the last barrier closed (what a checkpoint commits)."""
        return self._epoch


class TwoInputPipeline:
    """Two input chains joined by a two-input executor, then a tail.

    Reference shape: a join actor's two inputs aligned on barriers
    (executor/barrier_align.rs); the host loop is the aligner: it feeds
    each side's chunks in arrival order and calls ``barrier`` once both
    sides reached it. With the ``_fused`` overlay set
    (``runtime.fused_step.fuse_pipeline``), pushes buffer into the
    wrapper and the barrier runs one program; the member chains stay the
    state's system of record."""

    def __init__(self, left: Sequence[Executor], right: Sequence[Executor], join,
                 tail: Sequence[Executor]):
        self.left = list(left)
        self.right = list(right)
        self.join = join
        self.tail = list(tail)
        self._epoch = 0
        self._fused = None

    def _sides(self) -> Tuple[tuple, tuple]:
        return (self.left, self.join.apply_left), (self.right, self.join.apply_right)

    def push_left(self, chunk: StreamChunk) -> List[StreamChunk]:
        if self._fused is not None:
            return self._fused.buffer_left(chunk)
        outs = []
        for c in walk_chain(self.left, [chunk]):
            outs.extend(self.join.apply_left(c))
        return walk_chain(self.tail, outs)

    def push_right(self, chunk: StreamChunk) -> List[StreamChunk]:
        if self._fused is not None:
            return self._fused.buffer_right(chunk)
        outs = []
        for c in walk_chain(self.right, [chunk]):
            outs.extend(self.join.apply_right(c))
        return walk_chain(self.tail, outs)

    def barrier(self, checkpoint: bool = True) -> List[StreamChunk]:
        """Flush both input chains (left first) into the join, the join's
        own flush and the tail; then read every staged barrier scalar,
        so the checks raise before the barrier returns."""
        prev = self._epoch
        self._epoch = _epoch_after(prev)
        b = Barrier(Epoch(prev, self._epoch), checkpoint)
        if self._fused is not None:
            outs = self._fused.on_barrier(b)
            outs.extend(self._generated_watermarks())
            self._fused.finish_barrier()
            return outs
        joined: List[StreamChunk] = []
        for chain, feed in self._sides():
            for c in walk_chain(chain, [], barrier=b):
                joined.extend(feed(c))
        joined.extend(self.join.on_barrier(b))
        outs = walk_chain(self.tail, joined, barrier=b)
        outs.extend(self._generated_watermarks())
        for ex in self.executors:
            ex.finish_barrier()
        return outs

    def _generated_watermarks(self) -> List[StreamChunk]:
        """Poll ``emit_watermark`` on every executor: a side-chain
        watermark walks the rest of its chain, through the join's
        alignment, then the tail (the route an injected one takes);
        a tail executor's walks the rest of the tail."""
        outs: List[StreamChunk] = []
        aligned: Optional[Watermark] = None
        for chain, feed in self._sides():
            for i, ex in enumerate(chain):
                wm = ex.emit_watermark()
                if wm is None:
                    continue
                wm, pending = _walk_watermark(chain[i + 1:], wm)
                for c in pending:
                    outs.extend(feed(c))
                if wm is not None:
                    down, flushed = self.join.on_watermark(wm)
                    outs.extend(flushed)
                    if down is not None:
                        aligned = down
        outs = walk_chain(self.tail, outs)
        _, tail_outs = _walk_watermark(self.tail, aligned)
        outs.extend(tail_outs)
        for i, ex in enumerate(self.tail):
            wm = ex.emit_watermark()
            if wm is not None:
                _, touts = _walk_watermark(self.tail[i + 1:], wm)
                outs.extend(touts)
        return outs

    def watermark(self, column: str, value: int) -> List[StreamChunk]:
        """A watermark down both input chains; each side's (possibly
        transformed) watermark reaches the join, whose aligned
        watermark then walks the tail."""
        if self._fused is not None:
            # buffered rows precede the watermark: apply them first, then
            # walk the members interpreted (their state is the record)
            self._fused.flush_data()
        outs: List[StreamChunk] = []
        aligned: Optional[Watermark] = None
        for chain, feed in self._sides():
            wm, pending = _walk_watermark(chain, Watermark(column, value))
            for c in pending:
                outs.extend(feed(c))
            if wm is not None:
                down, flushed = self.join.on_watermark(wm)
                outs.extend(flushed)
                if down is not None:
                    aligned = down
        data_outs = walk_chain(self.tail, outs)
        _, tail_outs = _walk_watermark(self.tail, aligned)
        return data_outs + tail_outs

    @property
    def executors(self) -> List[Executor]:
        """Every executor of the fragment."""
        return self.left + self.right + [self.join] + self.tail

    @property
    def epoch(self) -> int:
        return self._epoch
