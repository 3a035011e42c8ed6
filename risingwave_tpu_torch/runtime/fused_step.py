"""The fused per-barrier program: a fragment's fusible executor run
executed as one program per barrier with no device read inside it.

Port of the single-input half of ``risingwave_tpu/runtime/fused_step.py``
(``AggStatics`` :200, ``FusedPlan`` :212, ``_delta_chunk`` :232,
``_fused_barrier_fn``/``_fused_barrier_body`` :239-382, ``_is_pure``
:465 (as ``epoch_batch.is_pure``), ``FusedChainExecutor`` :476,
``fuse_chain`` :2165, ``fuse_pipeline`` :2303, ``expand_fused`` :2355).

- ``fuse_chain`` rewrites an actor chain's maximal fusible run
  ``pure* HashAgg pure* DeviceMaterialize pure*`` into a
  ``FusedChainExecutor``; an agg with no device MV after it becomes an
  ``EpochBatchedAggExecutor`` (its flush leaves the run, so it keeps
  the interpreted flush with exact slices); everything else passes
  through interpreted.
- ``FusedChainExecutor`` buffers the epoch's chunks and at the barrier
  runs ``_fused_barrier_fn``: the stacked chunks through the pure
  prefix into the agg's epoch path (kernels E, F, A, G), then a
  number of flush rounds fixed on the host, each delta through
  the device MV (kernels C, A, D), then the members' latches,
  occupancies, three telemetry counters and two state digests
  (kernel H) packed into one int64 lane whose copy to pinned host
  memory is the barrier's only device->host read.
- The members stay the system of record: their state is updated in
  place, so snapshots, growth and the barrier checks work on the
  original objects.

On the card the program part of ``_run`` runs under
``torch.cuda.set_sync_debug_mode("error")`` (``no_device_reads``), the
counterpart of the reference's ``jax.transfer_guard("disallow")``: an
operation that waits for the device there raises.

Not ported yet: the two-input half (S2), literal lifting
(``lift_plan``/``param_scope``; the port has no expressions), the
device profiler and flight-recorder hooks (S8), the K-barrier pipeline
depth and join-fed MV tails (no port executor declares a closed
emission family yet, so an MV without an agg before it stays
interpreted).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk, flatten_stacked
from risingwave_tpu_torch.executors.base import Barrier, Executor, Watermark
from risingwave_tpu_torch.executors.epoch_batch import (
    ComposedSteps,
    EpochBatchedAggExecutor,
    chunk_signature,
    is_pure,
    stack_padded,
)
from risingwave_tpu_torch.executors.hash_agg import (
    HashAggExecutor,
    _epoch_reduced_fn,
    delta_to_chunk,
)
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor, mv_step_fn
from risingwave_tpu_torch.ops import agg as agg_ops
from risingwave_tpu_torch.ops.hash_table import stage_packed
from risingwave_tpu_torch.runtime.bucketing import flush_pad_schedule

__all__ = ["FusedChainExecutor", "expand_fused", "fuse_chain", "fuse_pipeline"]


@dataclass(frozen=True)
class AggStatics:
    """What the program needs of the HashAgg member."""

    calls: tuple
    group_keys: tuple
    nullable: tuple
    out_cap: int
    float_extremes: tuple


@dataclass(frozen=True)
class FusedPlan:
    """The program's shape: pure-step segments around at most one
    HashAgg and at most one device MV (agg before MV)."""

    pre: Optional[ComposedSteps]
    agg: Optional[AggStatics]
    mid: Optional[ComposedSteps]
    mv_pk: Optional[tuple]
    mv_cols: Optional[tuple]
    post: Optional[ComposedSteps]

    @property
    def has_mv(self) -> bool:
        return self.mv_pk is not None


def _delta_chunk(delta: dict, a: AggStatics, pad: Optional[int]) -> StreamChunk:
    return delta_to_chunk(delta, a.group_keys, a.nullable, a.calls, pad)


@contextmanager
def no_device_reads(device: torch.device):
    """Raise on any operation that waits for the card (a device->host
    read, a synchronize) inside the block; a no-op on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _fused_barrier_fn(states, stacked, plan: FusedPlan, pads, has_data: bool):
    """The fragment's barrier over ``states = (agg_state, mv_state)``
    (``(table, state, dropped, mi_bad)`` and ``(table, state)``, each
    empty without that member), updated in place:

    data phase   the stacked chunks through the pure prefix into the
                 agg's epoch path, or, without an agg, flattened into
                 the device MV as one batch;
    flush phase  ``len(pads)`` flushes of the agg's dirty groups,
                 round r's delta sliced to ``pads[r]`` rows and walked
                 through mid-steps -> device MV -> post-steps;
    scalars      agg latches + occupancy (dropped, minmax_retracted,
                 mi_bad, occupancy), MV latch + occupancy, the
                 telemetry counters rows_in, dirty_groups, mv_rows,
                 then the agg and MV state digests, packed in one
                 int64 lane. The occupancies are the tables' claimed
                 counters (kept by kernel A), dirty_groups comes from
                 the first flush round's kernel C and mv_rows from
                 kernel D, so none of them takes a pass of its own.

    Returns ``(states, outs, packed)``."""
    agg_st, mv_st = states
    dev = (agg_st[0] if agg_st else mv_st[0]).device
    zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    outs: List[StreamChunk] = []
    mv_rows = zero()

    def through_mv(chunk):
        nonlocal mv_st
        if plan.mid is not None:
            chunk = plan.mid(chunk)
        if plan.has_mv:
            mtable, mstate = mv_st
            # kernel D adds the chunk's valid rows to mv_rows
            mv_st = mv_step_fn(
                mtable, mstate, chunk, plan.mv_pk, plan.mv_cols, rows_acc=mv_rows
            )
        if plan.post is not None:
            chunk = plan.post(chunk)
        return chunk

    rows_in = zero()
    if has_data:
        # one reduction per barrier over the stacked valid lanes
        rows_in = stacked.valid.sum()
        if plan.agg is not None:
            a = plan.agg
            table, st, dropped, mi_bad = agg_st
            table, st, dropped = _epoch_reduced_fn(
                table, st, dropped, stacked, a.calls, a.group_keys, a.nullable, plan.pre
            )
            agg_st = (table, st, dropped, mi_bad)
        else:
            # the MV's last-row-per-pk rule makes one flat step equal to
            # applying the chunks in order
            chunks = plan.pre(stacked) if plan.pre is not None else stacked
            outs.append(through_mv(flatten_stacked(chunks)))

    # dirty groups after the epoch's applies, before the flush drains
    # them: written by the first round's kernel C (0 without a flush)
    dirty_groups = zero()
    if plan.agg is not None and pads:
        a = plan.agg
        table, st, dropped, mi_bad = agg_st
        for r, pad in enumerate(pads):
            st, delta = agg_ops.flush(
                st, table.keys, a.out_cap, a.float_extremes,
                dirty_total=dirty_groups if r == 0 else None,
            )
            outs.append(through_mv(_delta_chunk(delta, a, pad)))
        agg_st = (table, st, dropped, mi_bad)

    scal = []
    if plan.agg is not None:
        table, st, dropped, mi_bad = agg_st
        scal += [dropped, st.minmax_retracted, mi_bad, table.occupancy()]
    if plan.has_mv:
        mtable, mstate = mv_st
        scal += [mstate.dropped, mtable.occupancy()]
    packed = None
    if scal:
        scal += [rows_in, dirty_groups, mv_rows]
        if plan.agg is not None:
            lanes, live = integrity.agg_lanes(agg_st[0], agg_st[1], plan.agg.float_extremes)
            scal.append(integrity.device_digest(lanes, live))
        if plan.has_mv:
            scal.append(integrity.device_digest(*integrity.mv_lanes(*mv_st)))
        packed = torch.stack([x.to(torch.int64) for x in scal])
    return (agg_st, mv_st), outs, packed


class FusedChainExecutor(Executor):
    """One fusible run ``[pure*, HashAgg?, pure*, DeviceMaterialize?,
    pure*]`` run as one program per barrier. ``apply`` buffers (a
    change of chunk signature runs the buffer first), ``on_barrier``
    runs the program and returns the fragment's emission,
    ``finish_barrier`` reads the packed scalars and runs each member's
    barrier checks. ``last_digests`` holds the state digests of the
    last barrier (``{"agg": ..., "mv": ...}``, uint64 ints) and
    ``last_telemetry`` its counters."""

    def __init__(self, members: Sequence[Executor], label: str = "fragment"):
        self.members = list(members)
        self.label = label
        self.covers_whole_chain = False  # fuse_chain sets it
        self.agg: Optional[HashAggExecutor] = None
        self.mv: Optional[DeviceMaterializeExecutor] = None
        pre: List[Executor] = []
        mid: List[Executor] = []
        post: List[Executor] = []
        for ex in self.members:
            if type(ex) is HashAggExecutor:
                if self.agg is not None or self.mv is not None:
                    raise ValueError("fused run supports one HashAgg, before the MV")
                self.agg = ex
            elif type(ex) is DeviceMaterializeExecutor:
                if self.mv is not None:
                    raise ValueError("fused run supports one device MV")
                self.mv = ex
            elif is_pure(ex):
                (post if self.mv is not None else mid if self.agg is not None else pre).append(ex)
            else:
                raise ValueError(f"{type(ex).__name__} is not fusible")
        if self.agg is None and self.mv is None:
            raise ValueError("fused run needs a HashAgg or a device MV")
        steps = lambda exs: ComposedSteps([e.pure_step() for e in exs]) if exs else None
        agg_statics = None
        if self.agg is not None:
            agg_statics = AggStatics(
                calls=self.agg.calls,
                group_keys=self.agg.group_keys,
                nullable=self.agg.nullable,
                out_cap=self.agg.out_cap,
                float_extremes=self.agg._float_extremes,
            )
        self.plan = FusedPlan(
            pre=steps(pre),
            agg=agg_statics,
            mid=steps(mid),
            mv_pk=self.mv.pk if self.mv is not None else None,
            mv_cols=self.mv.columns if self.mv is not None else None,
            post=steps(post),
        )
        self._buf: List[StreamChunk] = []
        self._sig = None
        self.last_digests: dict = {}
        self.last_telemetry: dict = {}

    # -- data path --------------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        outs: List[StreamChunk] = []
        sig = chunk_signature(chunk)
        if self._sig is not None and sig != self._sig:
            outs = self._run(flush=False, stage=False)
        self._sig = sig
        self._buf.append(chunk)
        return outs

    # -- control path -----------------------------------------------------
    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        outs = self._run(flush=True, stage=True)
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return outs

    def on_watermark(self, watermark: Watermark):
        # buffered rows precede the watermark; the watermark itself walks
        # the members interpreted (their state is the system of record)
        from risingwave_tpu_torch.runtime.pipeline import _walk_watermark

        outs: List[StreamChunk] = []
        if self._buf:
            outs = self._run(flush=False, stage=False)
        wm, o = _walk_watermark(self.members, watermark)
        return wm, outs + o

    def finish_barrier(self) -> None:
        super().finish_barrier()
        for m in self.members:
            m.finish_barrier()  # no-op: members never stage under fusion

    def _on_barrier_scalars(self, vals) -> None:
        base = (4 if self.agg is not None else 0) + (2 if self.mv is not None else 0)
        rows_in, dirty_groups, mv_rows = vals[base:base + 3]
        self.last_telemetry = {"rows_in": rows_in, "dirty_groups": dirty_groups, "mv_rows": mv_rows}
        digs = {}
        j = base + 3
        if self.agg is not None:
            digs["agg"] = integrity.digest_from_scalar(vals[j])
            j += 1
        if self.mv is not None:
            digs["mv"] = integrity.digest_from_scalar(vals[j])
        self.last_digests = digs
        i = 0
        if self.agg is not None:
            self.agg._on_barrier_scalars(tuple(vals[0:4]))
            i = 4
        if self.mv is not None:
            self.mv._on_barrier_scalars(tuple(vals[i:i + 2]))

    # -- the program ------------------------------------------------------
    def _run(self, flush: bool, stage: bool) -> List[StreamChunk]:
        buf, self._buf, self._sig = self._buf, [], None
        has_data = bool(buf)
        stacked = None
        if has_data:
            stacked = stack_padded(buf)
            n_chunks, cap = stacked.valid.shape
            incoming = n_chunks * (self.plan.pre.rows(cap) if self.plan.pre is not None else cap)
            # host bookkeeping before the program: growth may rebuild
            # member state, and the program must see the final tensors
            if self.agg is not None:
                self.agg._maybe_grow(incoming)
                self.agg._insert_bound += incoming
                self.agg._dirty_bound += incoming
            elif self.mv is not None:
                self.mv._maybe_grow(incoming)
        # rounds and pads come from the dirty bound after this epoch's
        # rows landed in it, and from the plan's out_cap (the one the
        # program drains per round)
        pads: Tuple[int, ...] = ()
        if flush and self.agg is not None:
            # the interpreted flush's two-bucket slice, from the host bound
            pads = flush_pad_schedule(
                self.agg._dirty_bound, self.agg.table.capacity, self.plan.agg.out_cap
            )
            if self.mv is not None:
                for p in pads:
                    self.mv._maybe_grow(p)
        if not has_data and not pads and not stage:
            return []  # nothing to run, nothing to stage
        states = (self._agg_state(), self._mv_state())
        member = self.agg if self.agg is not None else self.mv
        with no_device_reads(member.table.device):
            (agg_st, mv_st), outs, packed = _fused_barrier_fn(
                states, stacked, self.plan, pads, has_data
            )
            if self.agg is not None:
                self.agg.table, self.agg.state, self.agg.dropped, self.agg.mi_bad = agg_st
            if self.mv is not None:
                self.mv.table, self.mv.state = mv_st
            if stage:
                self._staged_scalars = stage_packed(packed)
        if self.agg is not None and pads:
            self.agg._dirty_bound = 0
        return outs

    def _agg_state(self):
        if self.agg is None:
            return ()
        return (self.agg.table, self.agg.state, self.agg.dropped, self.agg.mi_bad)

    def _mv_state(self):
        if self.mv is None:
            return ()
        return (self.mv.table, self.mv.state)


def fuse_chain(chain: Sequence[Executor], label: str = "fragment") -> List[Executor]:
    """Rewrite every maximal fusible run of an actor chain: a run with a
    device MV after its agg becomes a FusedChainExecutor; an agg without
    one becomes an EpochBatchedAggExecutor over ``[pure*, agg]`` (its
    flush leaves the run to an interpreted consumer, which wants the
    interpreted flush's exact slices), with the run's tail passed
    through; everything else stays interpreted."""
    out: List[Executor] = []
    run: List[Executor] = []

    def close() -> None:
        nonlocal run
        if not run:
            return
        agg_idx = next((i for i, m in enumerate(run) if type(m) is HashAggExecutor), None)
        has_mv_after_agg = agg_idx is not None and any(
            type(m) is DeviceMaterializeExecutor for m in run[agg_idx:]
        )
        if has_mv_after_agg:
            out.append(FusedChainExecutor(run, label=label))
        elif agg_idx is not None:
            out.append(EpochBatchedAggExecutor(run[:agg_idx], run[agg_idx]))
            out.extend(run[agg_idx + 1:])
        else:
            out.extend(run)
        run = []

    for ex in chain:
        if type(ex) is HashAggExecutor:
            if any(type(m) in (HashAggExecutor, DeviceMaterializeExecutor) for m in run):
                close()
            run.append(ex)
        elif type(ex) is DeviceMaterializeExecutor:
            if any(type(m) is DeviceMaterializeExecutor for m in run):
                close()
            run.append(ex)
        elif is_pure(ex):
            run.append(ex)
        else:
            close()
            out.append(ex)
    close()
    if (
        len(out) == 1
        and isinstance(out[0], FusedChainExecutor)
        and len(out[0].members) == len(list(chain))
    ):
        out[0].covers_whole_chain = True
    return out


def fuse_pipeline(pipeline, label: str = "mv") -> List[FusedChainExecutor]:
    """Fuse a serial Pipeline's chain in place; returns the wrappers
    created. The pipeline's ``executors`` then lists the wrappers, not
    the members (``expand_fused`` gives the members back)."""
    pipeline.executors = fuse_chain(pipeline.executors, label)
    return [e for e in pipeline.executors if isinstance(e, FusedChainExecutor)]


def expand_fused(executors) -> List[Executor]:
    """Fused wrappers flattened back to their member executors."""
    out: List[Executor] = []
    for ex in executors or ():
        if isinstance(ex, FusedChainExecutor):
            out.extend(ex.members)
        else:
            out.append(ex)
    return out
