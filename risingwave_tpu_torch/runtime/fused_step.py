"""The fused per-barrier program: a fragment's fusible executor run
executed as one program per barrier with no device read inside it.

Port of ``risingwave_tpu/runtime/fused_step.py``: the single-input half
(``AggStatics`` :200, ``FusedPlan`` :212, ``_delta_chunk`` :232,
``_fused_barrier_fn``/``_fused_barrier_body`` :239-382, ``_is_pure``
:465 (as ``epoch_batch.is_pure``), ``FusedChainExecutor`` :476,
``fuse_chain`` :2165) and the two-input half (``SidePlan`` :993,
``TwoInputPlan`` :1006, ``_two_input_side_scan`` :1037,
``_fused_two_input_body`` :1147, ``_pad_segment`` :1366 (its count
only, as ``_padded_len``), ``FusedTwoInputExecutor`` :1381,
``_parse_side`` :1984, ``_side_plan`` :2024, ``fuse_two_input`` :2052),
with ``fuse_pipeline`` :2303 and ``expand_fused`` :2355.

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
  place, so snapshots, growth, the barrier checks and checkpoints
  (``CheckpointManager.commit_epoch`` over ``expand_fused`` of the
  executors, or each wrapper's ``capture_checkpoint``) work on the
  original objects, and a recovered pipeline re-fuses.
- ``fuse_two_input`` runs a ``TwoInputPipeline`` (q8: ``hop -> dedup``
  per side; q7: ``hop -> DynamicMaxFilter`` left, ``hop -> HashAgg``
  right; q101: a plain left input, ``HashAgg`` right; a HashJoin of any
  type, a device MV) as one
  ``FusedTwoInputExecutor`` program per barrier: the host bookkeeping
  first (each side member's and join side's growth hint, the agg's
  flush rounds from its dirty bound, the MV's growth bound), then each
  filter or dedup side's buffered chunks in arrival order through
  E -> A -> N (filter) or J (dedup) -> M (probe) -> P (the other side's
  degrees, outer, semi and anti joins) -> A -> L (own side),
  each segment's emission through A -> D into the MV, left side first;
  an agg side's segments through its epoch path (E, F, A, G); then the
  agg's flush rounds, each C -> M [-> P] -> A -> L as a right arrival at the
  join and A -> D into the MV; then the scalar pack with five digests
  (kernel H) and one staged copy. A watermark stays outside the
  program: ``flush_data`` applies the buffer, then the members take
  the watermark interpreted (their state is the system of record).

On the card the program part of ``_run`` runs under
``torch.cuda.set_sync_debug_mode("error")`` (``no_device_reads``), the
counterpart of the reference's ``jax.transfer_guard("disallow")``: an
operation that waits for the device there raises.

Literal lifting (``lift_plan``, reference :398): a single-input
wrapper rewrites its segments' numeric literals into parameter slots
(``expr.LiftedLit``) and, once its first data barrier proves the lifted
plan's column types equal to the baked plan's, runs the lifted plan
with the parameter vectors bound by ``param_scope``; kernel S then
reads them as an operand, so plans that differ only in literal values
run one compiled program (``fused_cache_stats``). The two-input program
binds no parameters, as the reference's (``fused_step.py:1891``).

A two-input pipeline whose two-input executor is not a HashJoin (q102's
second stage: the general dynamic filter) is refused whole, as the
reference refuses it; its chains then fall back to the per-chain policy
(an epoch-batched agg before the SimpleAgg; the MV after the filter
stays interpreted, the filter declaring no closed emission family).

Not ported yet: the device profiler and flight-recorder hooks (S8), the
K-barrier pipeline depth, the ``RW_FUSED_TWO_INPUT`` and
``RW_FUSED_LIFT`` switches (fusion is the call to ``fuse_pipeline``;
lifting is always on), and ``defer_pure``.
"""

from __future__ import annotations

import dataclasses as _dc
import os
import threading
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from risingwave_tpu_torch import integrity
from risingwave_tpu_torch.array.chunk import StreamChunk, flatten_stacked, stack_chunks
from risingwave_tpu_torch.executors.base import Barrier, Executor, Watermark
from risingwave_tpu_torch.executors.dedup import AppendOnlyDedupExecutor, dedup_step_fn
from risingwave_tpu_torch.executors.dynamic_filter import (
    DynamicMaxFilterExecutor,
    filter_step_fn,
)
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
from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor, join_step_fn
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor, mv_step_fn
from risingwave_tpu_torch.expr.expr import StaticTree, lift_literals, param_scope
from risingwave_tpu_torch.ops import agg as agg_ops
from risingwave_tpu_torch.ops import expr_vm
from risingwave_tpu_torch.ops.hash_table import stage_packed
from risingwave_tpu_torch.runtime.bucketing import flush_pad_schedule

__all__ = [
    "FusedChainExecutor", "FusedTwoInputExecutor", "checkpointed_executors", "cold_executors",
    "expand_fused", "fuse_chain",
    "fuse_pipeline", "fuse_two_input", "fused_cache_stats", "fusion_refusals", "lift_plan",
]

_REFUSALS: List[dict] = []


def _refuse(label: str, reason: str, executor: Optional[str] = None):
    """Record why a pipeline was left to the per-chain policy (the
    reference's RW-E807 provenance) and return None."""
    _REFUSALS.append({"code": "RW-E807", "fragment": label, "executor": executor,
                      "message": reason})
    del _REFUSALS[:-256]
    return None


def fusion_refusals(clear: bool = False) -> List[dict]:
    """Every recorded fusion refusal since process start (or the last
    ``clear=True`` call)."""
    out = list(_REFUSALS)
    if clear:
        _REFUSALS.clear()
    return out


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


def _land_then_merge(wrapper) -> List[StreamChunk]:
    """An armed cold tier merges the epoch's re-created groups at the
    barrier: the epoch's rows land first (one program without the
    flush), then the merge raises the dirty bound the host sizes the
    flush rounds from. The reference runs the merge before its program,
    when the epoch's groups are not in the table yet, and so merges
    nothing on this path (ROADMAP Queue 3). Returns what the first
    program emitted."""
    agg = wrapper.agg
    if agg is None or agg._cold_barrier_hook is None:
        return []
    outs = wrapper._run(flush=False, stage=False)
    agg._cold_barrier_hook()
    return outs


def _delta_chunk(delta: dict, a: AggStatics, pad: Optional[int]) -> StreamChunk:
    return delta_to_chunk(delta, a.group_keys, a.nullable, a.calls, pad)


def fused_enabled() -> bool:
    """The fused per-barrier program is on unless ``RW_FUSED_STEP=0``;
    then an actor falls back to the epoch-batched interpreted chain
    (reference :102-109, read by the actor graph)."""
    return os.environ.get("RW_FUSED_STEP", "1") != "0"


# -- the read guard ----------------------------------------------------------
# torch's sync debug mode is process-global, and parallel actors run fused
# programs in several threads at once. With no actor thread alive the guard
# is what it always was: mode "error" for the block. While actor threads
# share the card, the first guarded thread sets mode "warn" and a
# warnings hook sorts each synchronizing call by its thread: inside a
# guarded block it raises, outside (another actor's barrier read) it is
# dropped. The last guarded thread to leave restores the mode.
_SYNC_MESSAGE = "called a synchronizing CUDA operation"
_GUARD_LOCK = threading.Lock()
_GUARD = {"depth": 0, "prev": None, "shared": 0, "hooked": False}
_GUARD_LOCAL = threading.local()


class DeviceReadInFusedProgram(RuntimeError):
    """A fused program waited for the card inside its read guard."""


def _sorting_showwarning(message, category, filename, lineno, file=None, line=None):
    if _SYNC_MESSAGE in str(message):
        if getattr(_GUARD_LOCAL, "depth", 0):
            raise DeviceReadInFusedProgram(str(message))
        return  # another thread's legitimate read
    _GUARD["showwarning"](message, category, filename, lineno, file, line)


def _hook_sync_warnings() -> None:
    if not _GUARD["hooked"]:
        _GUARD["showwarning"] = warnings.showwarning
        warnings.showwarning = _sorting_showwarning
        warnings.filterwarnings("always", message=_SYNC_MESSAGE)
        _GUARD["hooked"] = True


@contextmanager
def shared_device_thread():
    """Marks the calling thread as one of several sharing the card (an
    actor's run loop) for as long as the block lasts."""
    with _GUARD_LOCK:
        _GUARD["shared"] += 1
    try:
        yield
    finally:
        with _GUARD_LOCK:
            _GUARD["shared"] -= 1


@contextmanager
def no_device_reads(device: torch.device):
    """Raise on any operation that waits for the card (a device->host
    read, a synchronize) inside the block; a no-op on the CPU. Safe when
    several actor threads hold it at once (see above)."""
    if device.type != "cuda":
        yield
        return
    with _GUARD_LOCK:
        if _GUARD["depth"] == 0:
            _GUARD["prev"] = torch.cuda.get_sync_debug_mode()
            if _GUARD["shared"]:
                _hook_sync_warnings()
                torch.cuda.set_sync_debug_mode("warn")
            else:
                torch.cuda.set_sync_debug_mode("error")
        _GUARD["depth"] += 1
    _GUARD_LOCAL.depth = getattr(_GUARD_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _GUARD_LOCAL.depth -= 1
        with _GUARD_LOCK:
            _GUARD["depth"] -= 1
            if _GUARD["depth"] == 0:
                torch.cuda.set_sync_debug_mode(_GUARD["prev"])


def _fused_barrier_fn(states, stacked, params, plan: FusedPlan, pads, has_data: bool):
    """The fragment's barrier with the lifted-literal parameter vectors
    ``params`` (or None) bound for every step it runs (reference :239)."""
    with param_scope(params):
        return _fused_barrier_body(states, stacked, plan, pads, has_data)


def _fused_barrier_body(states, stacked, plan: FusedPlan, pads, has_data: bool):
    """The fragment's barrier over ``states = (agg_state, mv_state)``
    (``(table, state, dropped, minput, mi_bad)`` and ``(table,
    state)``, each empty without that member), updated in place:

    data phase   the stacked chunks through the pure prefix into the
                 agg's epoch path (with a materialized MIN/MAX also the
                 row re-probe and kernel Q), or, without an agg,
                 flattened into the device MV as one batch;
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
            table, st, dropped, minput, mi_bad = agg_st
            table, st, dropped = _epoch_reduced_fn(
                table, st, dropped, stacked, a.calls, a.group_keys, a.nullable, plan.pre,
                minput, mi_bad,
            )
            agg_st = (table, st, dropped, minput, mi_bad)
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
        table, st, dropped, minput, mi_bad = agg_st
        for r, pad in enumerate(pads):
            st, delta = agg_ops.flush(
                st, table.keys, a.out_cap, a.float_extremes,
                dirty_total=dirty_groups if r == 0 else None,
            )
            outs.append(through_mv(_delta_chunk(delta, a, pad)))
        agg_st = (table, st, dropped, minput, mi_bad)

    scal = []
    if plan.agg is not None:
        table, st, dropped, _minput, mi_bad = agg_st
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


# -- multi-tenant compile sharing: lift per-MV constants to runtime operands --
_LIFT_STATS = {"lifted": 0, "rejected": 0}
_LIFT_LOCK = threading.Lock()


def _lift_step(step, ints: list, floats: list):
    """A pure step with the numeric literals of its expression fields
    (``StaticTree``s) lifted into parameter slots."""
    if not _dc.is_dataclass(step):
        return step
    changes = {
        f.name: StaticTree(lift_literals(getattr(step, f.name).value, ints, floats))
        for f in _dc.fields(step) if isinstance(getattr(step, f.name), StaticTree)
    }
    return _dc.replace(step, **changes) if changes else step


def lift_plan(plan: FusedPlan, device):
    """Rewrite the plan's pure segments with numeric literals lifted into
    parameter slots. Returns ``(lifted_plan, params)`` -- params being the
    ``{"i": int64, "f": float64}`` tensors on ``device`` that kernel S
    reads -- or ``(None, None)`` when the plan carries no liftable
    constants. Two plans that differ only in literal VALUES give EQUAL
    lifted plans, whose steps compile to one program."""
    ints: List[int] = []
    floats: List[float] = []

    def lift_steps(cs: Optional[ComposedSteps]) -> Optional[ComposedSteps]:
        if cs is None:
            return None
        return ComposedSteps([_lift_step(s, ints, floats) for s in cs.steps])

    lifted = _dc.replace(plan, pre=lift_steps(plan.pre), mid=lift_steps(plan.mid),
                         post=lift_steps(plan.post))
    if not ints and not floats:
        return None, None
    params = {
        "i": torch.tensor(ints, dtype=torch.int64, device=device),
        "f": torch.tensor(floats, dtype=torch.float64, device=device),
    }
    return lifted, params


def fused_cache_stats() -> dict:
    """The compile-sharing evidence: how many distinct kernel-S programs
    the process compiled, and how many wrappers lifted their constants
    into a shared shape (or were refused the lift)."""
    return {
        "compiled_programs": expr_vm.cache_stats()["programs"],
        "plans_lifted": _LIFT_STATS["lifted"],
        "plans_lift_rejected": _LIFT_STATS["rejected"],
    }


def _chunk_sig(chunk: StreamChunk) -> dict:
    return {n: (a.dtype, n in chunk.nulls) for n, a in chunk.columns.items()}


def _delta_sig(agg: HashAggExecutor) -> dict:
    """The column signature of the agg's flush deltas (``delta_to_chunk``)."""
    sig = {k: (agg._dtypes[k], nb) for k, nb in zip(agg.group_keys, agg.nullable)}
    fx = dict(agg._float_extremes)
    for c in agg.calls:
        sig[c.output] = (fx.get(c.output, agg.state.accums[c.output].dtype),
                         c.output in agg.state.nonnull)
    return sig


def _plan_signatures(plan: FusedPlan, in_sig: dict, agg) -> list:
    """The column signature after each of the plan's segments."""
    out, sig = [], in_sig
    if plan.pre is not None:
        sig = plan.pre.signature(sig)
        out.append(sig)
    if agg is not None:
        sig = _delta_sig(agg)
    for seg in (plan.mid, plan.post):
        if seg is not None:
            sig = seg.signature(sig)
            out.append(sig)
    return out


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
        # literals lifted to runtime operands, accepted only after the
        # first data barrier proves the lifted plan's column types equal
        # to the baked plan's (a weak literal promotes otherwise than its
        # strong int64/float64 slot; correctness beats sharing)
        self._exec_plan, self._params = self.plan, None
        self._lift_state = "off"
        member = self.agg if self.agg is not None else self.mv
        lifted, params = lift_plan(self.plan, member.table.device)
        if lifted is not None:
            self._lift_candidate = (lifted, params)
            self._lift_state = "pending"
        self._buf: List[StreamChunk] = []
        self._sig = None
        self.last_digests: dict = {}
        self.last_telemetry: dict = {}

    def _prove_lift(self, stacked: StreamChunk) -> None:
        """Accept the lifted plan only when every segment's output column
        types equal the baked plan's over this input signature (the
        reference's ``eval_shape`` comparison, :727); else keep the
        baked plan for good."""
        lifted, params = self._lift_candidate
        try:
            sig = _chunk_sig(stacked)
            ok = _plan_signatures(self.plan, sig, self.agg) == _plan_signatures(
                lifted, sig, self.agg)
        except Exception:  # noqa: BLE001 -- any surprise keeps the baked plan
            ok = False
        if ok:
            self._exec_plan, self._params = lifted, params
            self._lift_state = "on"
            with _LIFT_LOCK:
                _LIFT_STATS["lifted"] += 1
        else:
            self._lift_state = "off"
            with _LIFT_LOCK:
                _LIFT_STATS["rejected"] += 1

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
        outs = _land_then_merge(self)
        outs += self._run(flush=True, stage=True)
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

    def capture_checkpoint(self) -> None:
        """The members stay the system of record: each Checkpointable
        member captures its own delta."""
        for m in self.members:
            cap = getattr(m, "capture_checkpoint", None)
            if cap is not None:
                cap()

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
                if self.agg._cold_stacked_hook is not None:
                    self.agg._cold_stacked_hook()
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
        if self._lift_state == "pending" and has_data:
            self._prove_lift(stacked)
        with no_device_reads(member.table.device):
            (agg_st, mv_st), outs, packed = _fused_barrier_fn(
                states, stacked, self._params, self._exec_plan, pads, has_data
            )
            if self.agg is not None:
                (self.agg.table, self.agg.state, self.agg.dropped, self.agg.minput,
                 self.agg.mi_bad) = agg_st
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
        return (self.agg.table, self.agg.state, self.agg.dropped, self.agg.minput,
                self.agg.mi_bad)

    def _mv_state(self):
        if self.mv is None:
            return ()
        return (self.mv.table, self.mv.state)


def fuse_chain(chain: Sequence[Executor], label: str = "fragment",
               upstream: Optional[Executor] = None) -> List[Executor]:
    """Rewrite every maximal fusible run of an actor chain: a run with a
    device MV after its agg becomes a FusedChainExecutor; an agg without
    one becomes an EpochBatchedAggExecutor over ``[pure*, agg]`` (its
    flush leaves the run to an interpreted consumer, which wants the
    interpreted flush's exact slices), with the run's tail passed
    through; a device MV without an agg (a join-fed tail) fuses iff its
    feeder -- the nearest unfused executor upstream in the chain, or
    ``upstream`` for the chain's head -- declares a closed emission shape
    family ("fixed" or "bucketed" in its ``trace_contract``), else the
    refusal is recorded; everything else stays interpreted (reference
    :2165)."""
    out: List[Executor] = []
    run: List[Executor] = []
    feeder = upstream

    def feeder_emission() -> str:
        fn = getattr(feeder, "trace_contract", None)
        contract = fn() if fn is not None else None
        return "unknown" if contract is None else contract.get("emission", "unknown")

    def close() -> None:
        nonlocal run
        if not run:
            return
        agg_idx = next((i for i, m in enumerate(run) if type(m) is HashAggExecutor), None)
        has_mv_after_agg = agg_idx is not None and any(
            type(m) is DeviceMaterializeExecutor for m in run[agg_idx:]
        )
        has_mv = any(type(m) is DeviceMaterializeExecutor for m in run)
        if has_mv_after_agg:
            out.append(FusedChainExecutor(run, label=label))
        elif agg_idx is not None:
            out.append(EpochBatchedAggExecutor(run[:agg_idx], run[agg_idx]))
            out.extend(run[agg_idx + 1:])
        elif has_mv:
            em = feeder_emission()
            if em in ("fixed", "bucketed"):
                out.append(FusedChainExecutor(run, label=label))
            else:
                _refuse(label, "join-fed MV tail left interpreted: feeder emission shape "
                        f"family is {em!r}, not a closed fixed/bucketed lattice (stacking "
                        "would mint one program per distinct batch shape)",
                        type(feeder).__name__ if feeder is not None else None)
                out.extend(run)
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
            feeder = ex
    close()
    if (
        len(out) == 1
        and isinstance(out[0], FusedChainExecutor)
        and len(out[0].members) == len(list(chain))
    ):
        out[0].covers_whole_chain = True
    return out


# -- the two-input program ---------------------------------------------------------
@dataclass(frozen=True)
class SidePlan:
    """One input side: a pure prefix feeding at most one stateful member
    (q7: ``hop -> DynamicMaxFilter`` left, ``hop -> HashAgg`` right; q8:
    ``hop -> dedup`` both)."""

    pre: Optional[ComposedSteps]
    kind: Optional[str]  # None | "filter" | "dedup" | "agg"
    keys: tuple = ()  # filter: (group_col, value_col); dedup: key names
    agg: Optional[AggStatics] = None


@dataclass(frozen=True)
class TwoInputPlan:
    """The two-input program's shape: two side plans around one hash
    join (any of ``JOIN_TYPES``), then a ``pure* [device MV] pure*``
    tail."""

    left: SidePlan
    right: SidePlan
    j_left_keys: tuple
    j_right_keys: tuple
    j_left_names: tuple
    j_right_names: tuple
    j_out_names: tuple
    j_out_cap: int
    j_type: str
    tail_pre: Optional[ComposedSteps]
    mv_pk: Optional[tuple]
    mv_cols: Optional[tuple]
    tail_post: Optional[ComposedSteps]


def _concat(chunks: Sequence[StreamChunk]) -> StreamChunk:
    """Chunks of one schema as one (a segment's emissions, in order)."""
    if len(chunks) == 1:
        return chunks[0]
    cat = lambda get: torch.cat([get(c) for c in chunks])
    c0 = chunks[0]
    return StreamChunk(
        {n: cat(lambda c, n=n: c.columns[n]) for n in c0.columns},
        cat(lambda c: c.valid),
        {n: cat(lambda c, n=n: c.nulls[n]) for n in c0.nulls},
        cat(lambda c: c.ops),
    )


def _two_input_side_scan(ex, join, seg, side_plan: SidePlan, plan: TwoInputPlan, arrival: str,
                         join_rows) -> StreamChunk:
    """One side's segment through its stateful step (if any) and the
    join's arrival step, chunk by chunk in arrival order (the per-chunk
    ``out_cap`` compaction depends on it), all in place. Returns the
    segment's emissions as one chunk."""
    own_keys = plan.j_left_keys if arrival == "l" else plan.j_right_keys
    own_names = plan.j_left_names if arrival == "l" else plan.j_right_names
    other = "r" if arrival == "l" else "l"
    ems = []
    for chunk in seg:
        if side_plan.pre is not None:
            chunk = side_plan.pre(chunk)
        if side_plan.kind == "filter":
            ex.table, ex.maxes, ex.sdirty, chunk = filter_step_fn(
                ex.table, ex.maxes, ex.sdirty, chunk, side_plan.keys[0], side_plan.keys[1],
                (ex._saw_delete, ex._dropped),
            )
        elif side_plan.kind == "dedup":
            ex.table, ex.sdirty, chunk = dedup_step_fn(
                ex.table, ex.sdirty, chunk, side_plan.keys, ex.scratch,
                (ex._saw_delete, ex._dropped),
            )
        own, _, em = join_step_fn(
            join.side(arrival), join.side(other), chunk, own_keys, own_names,
            plan.j_out_names, plan.j_out_cap, join._em_overflow, plan.j_type, join_rows,
            arrival,
        )
        join._set_side(arrival, own)
        ems.append(em)
    return _concat(ems)


def _fused_two_input_body(w: "FusedTwoInputExecutor", left_batches, right_batches,
                          pads: Tuple[int, ...]):
    """The fragment's barrier over the members, in place:

    apply phase  the left segments, then the right ones, each through
                 its side's stateful step and the join's arrival step
                 chunk by chunk, each segment's emission through the
                 tail; an agg side instead takes each segment as one
                 stacked batch into its epoch path (kernels E, F, A, G;
                 with a materialized MIN/MAX the re-probe and Q);
    flush phase  ``len(pads)`` flushes of the agg side's dirty groups
                 (kernel C), round r's delta sliced to ``pads[r]`` rows,
                 each a right arrival at the join (M, P for an outer,
                 semi or anti join, then A + L) whose emission walks the
                 tail;
    scalars      in the reference's order: each stateful side's four
                 lanes (filter and dedup: saw_delete, dropped,
                 occupancy, survivors; agg: dropped, minmax_retracted,
                 mi_bad, occupancy), the join's nine, the MV's two, the
                 five telemetry counters (rows_left, rows_right,
                 join_rows, dirty_groups, mv_rows) and the digests (left
                 side, right side, the two join sides, the MV).

    join_rows (every emitted row, all three groups) is kept by kernels M
    and P, mv_rows by kernel D, dirty_groups by
    the first flush round's kernel C and each filter's or dedup's
    survivor count by the pass of kernel H that digests its table.
    Returns ``(outs, packed)``."""
    plan, join, mv = w.plan, w.join, w.mv
    dev = join.left.device
    zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    rows = {"l": zero(), "r": zero()}
    join_rows, mv_rows, dirty_groups = zero(), zero(), zero()
    outs: List[StreamChunk] = []

    def through_tail(chunk):
        if plan.tail_pre is not None:
            chunk = plan.tail_pre(chunk)
        if mv is not None:
            mv.table, mv.state = mv_step_fn(
                mv.table, mv.state, chunk, plan.mv_pk, plan.mv_cols, rows_acc=mv_rows
            )
        if plan.tail_post is not None:
            chunk = plan.tail_post(chunk)
        return chunk

    for side, batches, ex, side_plan in (
        ("l", left_batches, w.l_stateful, plan.left),
        ("r", right_batches, w.r_stateful, plan.right),
    ):
        for seg in batches:
            for c in seg:
                rows[side] += c.valid.sum()
            if side_plan.kind == "agg":
                a = side_plan.agg
                ex.table, ex.state, ex.dropped = _epoch_reduced_fn(
                    ex.table, ex.state, ex.dropped, stack_chunks(seg), a.calls, a.group_keys,
                    a.nullable, side_plan.pre, ex.minput, ex.mi_bad,
                )
            else:
                flat = _two_input_side_scan(ex, join, seg, side_plan, plan, side, join_rows)
                outs.append(through_tail(flat))

    if pads:
        a, agg = plan.right.agg, w.agg
        for r, pad in enumerate(pads):
            agg.state, delta = agg_ops.flush(
                agg.state, agg.table.keys, a.out_cap, a.float_extremes,
                dirty_total=dirty_groups if r == 0 else None,
            )
            own, _, em = join_step_fn(
                join.right, join.left, _delta_chunk(delta, a, pad), plan.j_right_keys,
                plan.j_right_names, plan.j_out_names, plan.j_out_cap, join._em_overflow,
                plan.j_type, join_rows, "r",
            )
            join._set_side("r", own)
            outs.append(through_tail(em))

    scal, digs = [], []
    for ex, side_plan in ((w.l_stateful, plan.left), (w.r_stateful, plan.right)):
        if ex is None:
            continue
        if side_plan.kind == "agg":
            scal += [ex.dropped, ex.state.minmax_retracted, ex.mi_bad, ex.table.occupancy()]
            digs.append(integrity.device_digest(
                *integrity.agg_lanes(ex.table, ex.state, side_plan.agg.float_extremes)
            ))
            continue
        if side_plan.kind == "filter":
            lanes, live = integrity.filter_lanes(ex.table, ex.maxes)
        else:
            lanes, live = integrity.dedup_lanes(ex.table)
        dig, surv = integrity.digest_with_survivors(lanes, live, ex.sdirty)
        scal += [ex._saw_delete, ex._dropped, ex.table.occupancy(), surv]
        digs.append(dig)
    l, r = join.left, join.right
    (l_dig, l_surv), (r_dig, r_surv) = (
        integrity.digest_with_survivors(*integrity.join_side_lanes(s), s.sdirty) for s in (l, r)
    )
    scal += [join._em_overflow, l.overflow, l.inconsistent, r.overflow, r.inconsistent,
             l.table.occupancy(), r.table.occupancy(), l_surv, r_surv]
    digs += [l_dig, r_dig]
    if mv is not None:
        scal += [mv.state.dropped, mv.table.occupancy()]
        digs.append(integrity.device_digest(*integrity.mv_lanes(mv.table, mv.state)))
    scal += [rows["l"], rows["r"], join_rows, dirty_groups, mv_rows] + digs
    packed = torch.stack([x.to(torch.int64) for x in scal])
    return outs, packed


def _padded_len(n: int) -> int:
    """A segment's chunk count padded to a power of two, as the reference
    pads its stacked batches for ``lax.scan``. The host bounds count the
    pads; the program runs only the real chunks (a pad is all-invalid
    and changes no state)."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


class FusedTwoInputExecutor(Executor):
    """A whole two-input pipeline — ``pure* [filter | dedup]`` left,
    ``pure* [filter | dedup | HashAgg]`` right, a HashJoin,
    ``pure* [device MV] pure*`` tail — run as one program per barrier.
    ``buffer_left``/``buffer_right`` stage chunks,
    ``on_barrier`` runs the program and returns the fragment's
    emission, ``finish_barrier`` reads the packed scalars and runs each
    member's barrier checks. The members stay the system of record.
    ``last_digests`` holds the last barrier's staged digests
    (``left``, ``right``, ``join_left``, ``join_right``, ``mv``, uint64
    ints) and ``last_telemetry`` its counters."""

    def __init__(self, members, plan: TwoInputPlan, l_stateful, r_stateful, join, mv,
                 label: str = "fragment"):
        self.members = list(members)
        self.plan = plan
        self.l_stateful = l_stateful
        self.r_stateful = r_stateful
        self.agg = r_stateful if type(r_stateful) is HashAggExecutor else None
        self.join = join
        self.mv = mv
        self.label = label
        self.covers_whole_chain = True
        self._segs = {"l": [], "r": []}  # homogeneous chunk segments
        self._sig = {"l": None, "r": None}
        self.last_digests: dict = {}
        self.last_telemetry: dict = {}

    # -- data path --------------------------------------------------------
    def buffer_left(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._buffer("l", chunk)

    def buffer_right(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._buffer("r", chunk)

    def _buffer(self, side: str, chunk: StreamChunk) -> List[StreamChunk]:
        sig = chunk_signature(chunk)
        segs = self._segs[side]
        if not segs or self._sig[side] != sig:
            segs.append([])
            self._sig[side] = sig
        segs[-1].append(chunk)
        return []

    def flush_data(self) -> List[StreamChunk]:
        """Apply everything buffered without the agg side's flush,
        staging nothing (buffered rows precede a watermark in stream
        order; the watermark then walks the members interpreted)."""
        if not self._segs["l"] and not self._segs["r"]:
            return []
        return self._run(flush=False, stage=False)

    # -- control path -----------------------------------------------------
    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        outs = _land_then_merge(self)
        outs += self._run(flush=True, stage=True)
        if barrier is None:  # direct drive: checks fire inline
            self.finish_barrier()
        return outs

    def on_watermark(self, watermark: Watermark):
        return watermark, self.flush_data()

    def finish_barrier(self) -> None:
        super().finish_barrier()
        for m in self.members:
            m.finish_barrier()  # no-op: members never stage under fusion

    def capture_checkpoint(self) -> None:
        """The members stay the system of record: each Checkpointable
        member captures its own delta."""
        for m in self.members:
            cap = getattr(m, "capture_checkpoint", None)
            if cap is not None:
                cap()

    def _scalar_layout(self):
        layout = []
        if self.l_stateful is not None:
            layout.append(("l", 4))
        if self.r_stateful is not None:
            layout.append(("r", 4))
        layout.append(("join", 9))
        if self.mv is not None:
            layout.append(("mv", 2))
        layout.append(("tel", 5))
        names = [n for n, ex in (("left", self.l_stateful), ("right", self.r_stateful))
                 if ex is not None]
        names += ["join_left", "join_right"] + (["mv"] if self.mv is not None else [])
        layout.append(("dig", len(names)))
        return layout, names

    def _on_barrier_scalars(self, vals) -> None:
        layout, dig_names = self._scalar_layout()
        slices, i = {}, 0
        for name, width in layout:
            slices[name] = tuple(vals[i:i + width])
            i += width
        rows_l, rows_r, join_rows, dirty_groups, mv_rows = slices["tel"]
        self.last_telemetry = {
            "rows_in": rows_l + rows_r, "rows_left": rows_l, "rows_right": rows_r,
            "join_rows": join_rows, "dirty_groups": dirty_groups, "mv_rows": mv_rows,
        }
        self._note_digests(dig_names, slices["dig"])
        if self.l_stateful is not None:
            self.l_stateful._on_barrier_scalars(slices["l"])
        if self.r_stateful is not None:
            self.r_stateful._on_barrier_scalars(slices["r"])
        self.join._on_barrier_scalars(slices["join"])
        if self.mv is not None:
            self.mv._on_barrier_scalars(slices["mv"])

    def _note_digests(self, names, dig) -> None:
        self.last_digests = {n: integrity.digest_from_scalar(v) for n, v in zip(names, dig)}

    # -- the program ------------------------------------------------------
    def _prepare_side(self, side: str, side_plan: SidePlan):
        """Take the side's buffered segments and run its member's host
        growth bookkeeping (a rebuild must land before the program
        reads the state), counting each segment at its padded length
        as the reference does. Returns ``(batches, post_pre_rows,
        padded_chunks)``."""
        segs, self._segs[side] = self._segs[side], []
        self._sig[side] = None
        rows = chunks = 0
        for seg in segs:
            cap = seg[0].capacity
            padded = _padded_len(len(seg))
            rows += padded * (side_plan.pre.rows(cap) if side_plan.pre is not None else cap)
            chunks += padded
        ex = self.l_stateful if side == "l" else self.r_stateful
        if ex is not None and rows:
            if ex is self.agg:
                if ex._cold_stacked_hook is not None:
                    ex._cold_stacked_hook()
                ex._maybe_grow(rows)
                ex._insert_bound += rows
                ex._dirty_bound += rows
            else:
                ex._grow_hint(rows)
                ex._bound += rows
        return tuple(tuple(seg) for seg in segs), rows, chunks

    def _run(self, flush: bool, stage: bool) -> List[StreamChunk]:
        if self.join._cold_apply_hook is not None:
            # the program probes both sides as they are: every evicted
            # bucket comes back before it is dispatched
            for name in ("left", "right"):
                if self.join._evicted[name]:
                    self.join._restore_cold_keys(name, sorted(self.join._evicted[name]))
        left_batches, l_rows, l_chunks = self._prepare_side("l", self.plan.left)
        right_batches, r_rows, r_chunks = self._prepare_side("r", self.plan.right)
        agg = self.agg
        pads: Tuple[int, ...] = ()
        if flush and agg is not None:
            # rounds and pads from the dirty bound after this epoch's rows
            # landed in it, and the plan's out_cap (what a round drains)
            pads = flush_pad_schedule(
                agg._dirty_bound, agg.table.capacity, self.plan.right.agg.out_cap
            )
        if not (left_batches or right_batches) and not pads and not stage:
            return []
        join = self.join
        # right arrivals at the join: the scanned side's rows, or the
        # flush rounds' deltas of an agg side
        r_join_rows = sum(pads) if agg is not None else r_rows
        for side, rows in (("l", l_rows), ("r", r_join_rows)):
            if rows:
                join._grow_hint(side, rows)
                join._bound[side] += rows
        if self.mv is not None:
            # every emission chunk reaching the MV has out_cap rows, a
            # flush round's too
            em_chunks = l_chunks + (len(pads) if agg is not None else r_chunks)
            em_rows = em_chunks * self.plan.j_out_cap
            if em_rows:
                self.mv._maybe_grow(em_rows)
        # the two-input program binds no lifted parameters, as the
        # reference's (it passes params=None, fused_step.py:1891)
        with no_device_reads(join.left.device), param_scope(None):
            outs, packed = _fused_two_input_body(self, left_batches, right_batches, pads)
            if stage:
                self._staged_scalars = stage_packed(packed)
        if agg is not None and pads:
            agg._dirty_bound = 0
        return outs


def _parse_side(chain, label: str, side: str):
    """One input chain as ``(pure prefix, stateful member)``, or None
    (with the refusal recorded) when the program cannot absorb it."""
    pres: List[Executor] = []
    stateful = None
    for ex in chain:
        if stateful is not None:
            return _refuse(f"{label}/{side}", "executors after the side's stateful member "
                           "are not absorbable by the two-input program", type(ex).__name__)
        if is_pure(ex):
            pres.append(ex)
        elif type(ex) in (DynamicMaxFilterExecutor, AppendOnlyDedupExecutor) or (
            type(ex) is HashAggExecutor and side == "right"
        ):
            stateful = ex
        else:
            return _refuse(f"{label}/{side}", "not fusible in a two-input side chain (a "
                           "HashAgg only on the right side: its flush feeds the join's right "
                           "arrival)", type(ex).__name__)
    return pres, stateful


def _side_plan(pres, stateful) -> SidePlan:
    pre = ComposedSteps([p.pure_step() for p in pres]) if pres else None
    if stateful is None:
        return SidePlan(pre=pre, kind=None)
    if type(stateful) is DynamicMaxFilterExecutor:
        return SidePlan(pre=pre, kind="filter", keys=(stateful.group_col, stateful.value_col))
    if type(stateful) is AppendOnlyDedupExecutor:
        return SidePlan(pre=pre, kind="dedup", keys=stateful.keys)
    return SidePlan(pre=pre, kind="agg", agg=AggStatics(
        calls=stateful.calls,
        group_keys=stateful.group_keys,
        nullable=stateful.nullable,
        out_cap=stateful.out_cap,
        float_extremes=stateful._float_extremes,
    ))


def fuse_two_input(pipeline, label: str = "mv") -> Optional[FusedTwoInputExecutor]:
    """Plan whole-pipeline fusion of a ``TwoInputPipeline`` (q7's
    ``filter x agg-flush -> join -> MV`` and q8's ``dedup x join -> MV``
    shapes), or None with the refusal recorded: the join must be a
    HashJoin, the left side ``pure* [filter | dedup]``, the right side
    ``pure* [filter | dedup | HashAgg]``, the tail ``pure*
    [DeviceMaterialize] pure*``."""
    join = getattr(pipeline, "join", None)
    if type(join) is not HashJoinExecutor:
        return _refuse(label, "two-input executor is not a HashJoin", type(join).__name__)
    left = _parse_side(pipeline.left, label, "left")
    if left is None:
        return None
    right = _parse_side(pipeline.right, label, "right")
    if right is None:
        return None
    tail_pre: List[Executor] = []
    tail_post: List[Executor] = []
    mv = None
    for ex in pipeline.tail:
        if type(ex) is DeviceMaterializeExecutor and mv is None:
            mv = ex
        elif is_pure(ex):
            (tail_post if mv is not None else tail_pre).append(ex)
        else:
            return _refuse(f"{label}/tail", "not fusible in the two-input tail", type(ex).__name__)
    steps = lambda exs: ComposedSteps([e.pure_step() for e in exs]) if exs else None
    plan = TwoInputPlan(
        left=_side_plan(*left),
        right=_side_plan(*right),
        j_left_keys=join.left_keys,
        j_right_keys=join.right_keys,
        j_left_names=join.left_names,
        j_right_names=join.right_names,
        j_out_names=join.out_names,
        j_out_cap=join.out_cap,
        j_type=join.join_type,
        tail_pre=steps(tail_pre),
        mv_pk=mv.pk if mv is not None else None,
        mv_cols=mv.columns if mv is not None else None,
        tail_post=steps(tail_post),
    )
    members = list(pipeline.left) + list(pipeline.right) + [join] + list(pipeline.tail)
    return FusedTwoInputExecutor(members, plan, left[1], right[1], join, mv, label=label)


def fuse_pipeline(pipeline, label: str = "mv") -> List[Executor]:
    """Arm fusion on a ``Pipeline`` or ``TwoInputPipeline`` in place;
    returns the wrappers created.

    A two-input pipeline fuses whole (``fuse_two_input``: one program
    per barrier on ``pipeline._fused``, the chains left as they are);
    when that is refused, each of its chains falls back to the
    per-chain policy, the join passed as the tail's upstream (so a
    join-fed MV tail still fuses). A serial pipeline's ``executors`` then lists the
    wrappers, not the members (``expand_fused`` gives the members
    back)."""
    if hasattr(pipeline, "join") and hasattr(pipeline, "left"):
        w = fuse_two_input(pipeline, label=label)
        if w is not None:
            pipeline._fused = w
            return [w]
        created: List[Executor] = []
        for attr in ("left", "right", "tail"):
            upstream = pipeline.join if attr == "tail" else None
            chain = fuse_chain(getattr(pipeline, attr), f"{label}/{attr}", upstream)
            setattr(pipeline, attr, chain)
            created += [e for e in chain if isinstance(e, FusedChainExecutor)]
        return created
    pipeline.executors = fuse_chain(pipeline.executors, label)
    return [e for e in pipeline.executors if isinstance(e, FusedChainExecutor)]


def expand_fused(executors) -> List[Executor]:
    """Fused wrappers flattened back to their member executors."""
    out: List[Executor] = []
    for ex in executors or ():
        if isinstance(ex, (FusedChainExecutor, FusedTwoInputExecutor)):
            out.extend(ex.members)
        else:
            out.append(ex)
    return out


def checkpointed_executors(executors) -> List[Executor]:
    """What a checkpoint stages: ``expand_fused``'s members, an
    epoch-batched agg's agg in its place."""
    return [ex.agg if isinstance(ex, EpochBatchedAggExecutor) else ex
            for ex in expand_fused(executors)]


def cold_executors(executors) -> List[Executor]:
    """The checkpointed executors the cold tier can evict (the hash aggs
    and hash joins)."""
    return [ex for ex in checkpointed_executors(executors) if hasattr(ex, "evict_cold")]
