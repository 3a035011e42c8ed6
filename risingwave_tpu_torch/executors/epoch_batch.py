"""Per-epoch chunk batching: a stateless prefix and a HashAgg applied
once per epoch.

Port of ``risingwave_tpu/executors/epoch_batch.py`` (``ComposedSteps``
:44, ``EpochBatchedAggExecutor`` :100, ``fuse_epoch_batch`` :309).
The wrapper buffers the epoch's chunks and hands them to
``HashAggExecutor.apply_stacked`` as one stacked batch, the prefix's
pure steps run on it first; the agg still flushes interpreted, with
exact slices, at the barrier. It is the fallback of ``fuse_chain`` for
an agg whose flush leaves the fused run (no device MV after it).
Emission is unchanged: HashAgg emits only at barriers and watermarks,
and the wrapper applies its buffer before delegating either. The
stacked axis is padded to a power of two with empty chunks, as in the
reference.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from risingwave_tpu_torch.array.chunk import StreamChunk, stack_chunks
from risingwave_tpu_torch.executors.base import Barrier, Executor, Watermark
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor


class ComposedSteps:
    """A chunk -> chunk composition of pure steps with VALUE equality
    (reference :44): two compositions of equal steps are equal, so a
    lifted plan's segments of two parameter variants compare equal.
    ``rows(C)`` is the output capacity of a C-row input chunk and
    ``signature(sig)`` the output ``{column: (dtype, nullable)}`` of an
    input signature.

    The reference's ``__call__`` inlines its steps under an active
    lifted-literal scope, since a nested jit would cache the ambient
    parameters into its jaxpr (:66-80); the port runs its steps eagerly
    and each lifted step reads the scope when it runs, so nothing here
    changes under a scope."""

    __slots__ = ("steps", "_hash")

    def __init__(self, steps):
        self.steps = tuple(steps)
        self._hash = hash(self.steps)

    def __call__(self, chunk: StreamChunk) -> StreamChunk:
        for f in self.steps:
            chunk = f(chunk)
        return chunk

    def rows(self, capacity: int) -> int:
        for f in self.steps:
            capacity = f.rows(capacity)
        return capacity

    def signature(self, sig: dict) -> dict:
        for f in self.steps:
            sig = f.signature(sig)
        return sig

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, ComposedSteps) and self.steps == other.steps


def is_pure(ex: Executor) -> bool:
    """A stateless member a batched or fused run can absorb: a pure
    step, no generated watermarks, no barrier behaviour (an absorbed
    member's own ``on_barrier`` is never called)."""
    return (
        ex.pure_step() is not None
        and type(ex).emit_watermark is Executor.emit_watermark
        and type(ex).on_barrier is Executor.on_barrier
    )


def chunk_signature(c: StreamChunk):
    """Chunks stack only if capacity, columns, null lanes and dtypes
    agree; a change of signature flushes the buffer."""
    return (
        c.capacity,
        tuple(sorted((k, str(v.dtype)) for k, v in c.columns.items())),
        tuple(sorted(c.nulls)),
    )


def stack_padded(buf: List[StreamChunk]) -> StreamChunk:
    """Stack the buffered chunks, padded with empty chunks to a power
    of two."""
    n = len(buf)
    target = 1 << (n - 1).bit_length() if n > 1 else 1
    if target > n:
        c0 = buf[0]
        empty = StreamChunk(c0.columns, torch.zeros_like(c0.valid), c0.nulls, c0.ops)
        buf = buf + [empty] * (target - n)
    return stack_chunks(buf)


class EpochBatchedAggExecutor(Executor):
    """[stateless-pure*, HashAgg] applied as one batch per epoch. The
    wrapped ``agg`` stays the system of record for its state."""

    def __init__(self, prefix: Sequence[Executor], agg: HashAggExecutor):
        self.prefix = list(prefix)
        self.agg = agg
        if not all(is_pure(p) for p in self.prefix):
            raise ValueError("prefix executors must be pure (is_pure)")
        pures = tuple(p.pure_step() for p in self.prefix)
        self._pre = ComposedSteps(pures) if pures else None
        self._buf: List[StreamChunk] = []
        self._sig = None

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        sig = chunk_signature(chunk)
        if self._sig is not None and sig != self._sig:
            self.flush()
        self._sig = sig
        self._buf.append(chunk)
        return []

    def flush(self) -> None:
        """Apply everything buffered as one batch."""
        buf, self._buf, self._sig = self._buf, [], None
        if buf:
            self.agg.apply_stacked(stack_padded(buf), pre=self._pre)

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        self.flush()
        return self.agg.on_barrier(barrier)

    def on_watermark(self, watermark: Watermark):
        # buffered rows precede the watermark in stream order
        self.flush()
        outs: List[StreamChunk] = []
        wm = watermark
        for p in self.prefix:
            wm, o = p.on_watermark(wm)
            outs.extend(o)
            if wm is None:
                return None, outs
        wm, o = self.agg.on_watermark(wm)
        outs.extend(o)
        return wm, outs

    def emit_watermark(self):
        return self.agg.emit_watermark()

    def finish_barrier(self) -> None:
        for p in self.prefix:
            p.finish_barrier()
        self.agg.finish_barrier()


def fuse_epoch_batch(chain: Sequence[Executor]) -> List[Executor]:
    """Rewrite every ``[stateless-pure*, HashAgg]`` run of a chain into
    an EpochBatchedAggExecutor; everything else passes through."""
    out: List[Executor] = []
    run: List[Executor] = []
    for ex in chain:
        if type(ex) is HashAggExecutor:
            out.append(EpochBatchedAggExecutor(run, ex))
            run = []
        elif is_pure(ex):
            run.append(ex)
        else:
            out.extend(run)
            run = []
            out.append(ex)
    out.extend(run)
    return out
