"""SimpleAgg -- global (ungrouped) streaming aggregation.

Port of ``risingwave_tpu/executors/simple_agg.py`` (``_simple_step``
:37, ``SimpleAggExecutor`` :50). Reference:
src/stream/src/executor/simple_agg.rs. SQL ``SELECT count(*), sum(x)
FROM t`` with no GROUP BY: exactly one output row, present before any
input (count 0, NULL sums), updated with U-/U+ pairs.

The state is slot 0 of a 2-slot ``AggState`` (``ops/agg.py``), with no
hash table: every active row folds into slot 0. On the card kernel Y
(``csrc/simple_agg.cu``) reduces the chunk inside each block and adds
one atomic per block and lane; on the CPU ``ops.agg.apply`` scatters
into slot 0, as the reference. The barrier reads the one row in one
pinned copy and diffs it against the row downstream last saw.
Checkpoint and restore (``:207``, ``:227``) stage and land that row
through kernel R.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels, integrity, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk, _numpy_dtype, to_device
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.ops import agg as agg_ops
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.ops.checkpoint import mark_checkpointed, scatter_rows, stage_select
from risingwave_tpu_torch.ops.hash_table import finish_scalars, stage_packed
from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta, pull_rows
from risingwave_tpu_torch.types import Op


def simple_step(state: agg_ops.AggState, chunk: StreamChunk, calls) -> agg_ops.AggState:
    """Fold one chunk into slot 0 of ``state``, in place: kernel Y on
    CUDA tensors, the plain version on the CPU."""
    dev = chunk.valid.device
    if dev.type == "cpu":
        return _simple_step_torch(state, chunk, calls)
    if dev.type == "cuda":
        return _simple_step_cuda(state, chunk, calls)
    raise ValueError(f"unsupported device {dev}")


def _step_inputs(chunk: StreamChunk, calls):
    values = {c.input: chunk.col(c.input) for c in calls if c.input is not None}
    nulls = {c.input: chunk.nulls[c.input] for c in calls
             if c.input is not None and c.input in chunk.nulls}
    return values, nulls


def _simple_step_torch(state, chunk, calls):
    """The reference's step: every active row's slot is 0, then the
    grouped apply's scatter (``ops.agg._apply_torch``, which also runs
    on CUDA tensors)."""
    signs = chunk.effective_signs()
    active = chunk.valid & (signs != 0)
    slots = torch.where(active, torch.zeros_like(signs), torch.full_like(signs, -1))
    values, nulls = _step_inputs(chunk, calls)
    agg_ops._apply_torch(state, calls, slots, signs, values, nulls, None)
    return state


def _simple_step_cuda(state, chunk, calls):
    n = chunk.capacity
    _kernels.check_cuda("simple_agg", chunk.valid, chunk.ops, n=n)
    _kernels.check_cuda("simple_agg", state.row_count, state.dirty, state.sdirty, n=2)
    _kernels.check_cuda("simple_agg", chunk.valid, state.minmax_retracted)
    if chunk.ops.dtype != torch.int32:
        raise TypeError("simple_agg: ops must be an int32 lane")
    values, nulls = _step_inputs(chunk, calls)
    rows = agg_ops.call_rows("simple_agg", state, calls, values, nulls, n)
    _kernels.call(
        "simple_agg", "rw_simple_apply", _kernels.int64_rows(rows, 8), len(rows), n,
        chunk.valid.data_ptr(), chunk.ops.data_ptr(), state.row_count.data_ptr(),
        state.dirty.data_ptr(), state.sdirty.data_ptr(), state.minmax_retracted.data_ptr(),
    )
    return state


def _slot0_bits(a: torch.Tensor) -> torch.Tensor:
    """Slot 0 of a lane as one int64 holding its bits (a float64 lane
    bitcast, a float32 or narrower lane widened from its own bits)."""
    x = a[:1]
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64)
    return x.to(torch.int64)


def _from_bits(bits: int, dtype: torch.dtype):
    """A python scalar of ``dtype`` from ``_slot0_bits``'s int64."""
    if dtype == torch.float64:
        return float(np.int64(bits).view(np.float64))
    if dtype == torch.float32:
        return float(np.int32(bits).view(np.float32))
    return int(bits)


class SimpleAggExecutor(Executor, Checkpointable):
    """Global aggregation: one always-present output row (pk = ())."""

    def __init__(
        self,
        calls: Sequence[AggCall],
        schema_dtypes: Dict[str, torch.dtype],
        table_id: str = "simple_agg",
        device="cuda",
    ):
        if any(c.materialized for c in calls):
            raise NotImplementedError(
                "materialized global MIN/MAX not wired yet (grouped HashAgg supports it)"
            )
        self.device = resolve_device(device)
        self.table_id = table_id
        self.calls = tuple(calls)
        self._dtypes = dict(schema_dtypes)
        self.state = agg_ops.create_state(2, self.calls, self._dtypes, self.device)
        self._float_decode = dict(agg_ops.float_extreme_meta(self.calls, self._dtypes))
        self._last: Optional[Tuple] = None  # what downstream has

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        self.state = simple_step(self.state, chunk, self.calls)
        return []

    def _current_row(self) -> Tuple:
        """(value | None per call): the latch, each accumulator and
        non-null count at slot 0 packed into one int64 lane, read in one
        pinned copy."""
        st = self.state
        parts = [st.minmax_retracted.reshape(1).to(torch.int64)]
        for c in self.calls:
            parts.append(_slot0_bits(st.accums[c.output]))
            if c.output in st.nonnull:
                parts.append(st.nonnull[c.output][:1])
        vals = iter(finish_scalars(stage_packed(torch.cat(parts))))
        if next(vals):
            raise RuntimeError(
                "retraction hit an append-only global MIN/MAX; use the grouped "
                "executor's materialized extremes"
            )
        row = []
        for c in self.calls:
            acc = st.accums[c.output]
            v = _from_bits(next(vals), acc.dtype)
            if c.output in st.nonnull:
                if next(vals) == 0:
                    row.append(None)
                    continue
                if c.output in self._float_decode:
                    key = torch.tensor([v], dtype=torch.int64)
                    v = float(agg_ops._order_key_to_float(key, self._float_decode[c.output])[0])
            row.append(v)
        return tuple(row)

    def _row_chunk(self, rows_ops) -> StreamChunk:
        cols = {c.output: [] for c in self.calls}
        nulls = {c.output: [] for c in self.calls if c.output in self.state.nonnull}
        ops = []
        for row, op in rows_ops:
            ops.append(op)
            for c, v in zip(self.calls, row):
                cols[c.output].append(0 if v is None else v)
                if c.output in nulls:
                    nulls[c.output].append(v is None)
        np_cols = {}
        for c in self.calls:
            dt = self._float_decode.get(c.output, self.state.accums[c.output].dtype)
            np_cols[c.output] = np.asarray(cols[c.output], _numpy_dtype(dt))
        return StreamChunk.from_numpy(
            np_cols,
            max(2, len(ops)),
            ops=np.asarray(ops, np.int32),
            nulls={k: np.asarray(v, bool) for k, v in nulls.items()},
            device=self.device,
        )

    def on_barrier(self, barrier) -> List[StreamChunk]:
        cur = self._current_row()
        if self._last is None:
            self._last = cur
            return [self._row_chunk([(cur, Op.INSERT)])]
        if cur == self._last:
            return []
        out = self._row_chunk([(self._last, Op.UPDATE_DELETE), (cur, Op.UPDATE_INSERT)])
        self._last = cur
        return [out]

    # -- integrity --------------------------------------------------------
    def _value_lanes(self) -> Dict[str, torch.Tensor]:
        """row_count, ``acc_<out>`` and ``nn_<out>``: the lanes the digest
        folds and a checkpoint stages (float MIN/MAX keys as the port
        holds them)."""
        lanes = {"row_count": self.state.row_count}
        for n, a in self.state.accums.items():
            lanes[f"acc_{n}"] = a
        for n, a in self.state.nonnull.items():
            lanes[f"nn_{n}"] = a
        return lanes

    def digest_lanes(self):
        """Both slots, unmasked, as the reference folds them; float
        MIN/MAX lanes in the reference's unsigned key representation."""
        lanes = self._value_lanes()
        for n, fdt in self._float_decode.items():
            lanes[f"acc_{n}"] = agg_ops.order_key_to_reference_lane(lanes[f"acc_{n}"], fdt)
        return lanes, None

    def state_digest(self) -> int:
        return integrity.host_digest(*integrity.host_lanes(*self.digest_lanes()))

    # -- checkpoint -------------------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        """Slot 0's row when it changed since the last checkpoint: kernel
        R selects it (sdirty is the whole selection: the row is never a
        tombstone), gathers its lanes in one copy and clears the mark.
        Float MIN/MAX keys are staged as the reference's."""
        st = self.state
        sel, tomb, _, n_sdirty = stage_select(st.sdirty, (st.sdirty,), st.stored)
        if not n_sdirty:
            return []
        pulled = pull_rows(self._value_lanes(), sel)
        for n, fdt in self._float_decode.items():
            pulled[f"acc_{n}"] = agg_ops.order_key_to_reference(pulled[f"acc_{n}"],
                                                                _numpy_dtype(fdt))
        mark_checkpointed(st.stored, st.sdirty, sel, tomb)
        return [StateDelta(self.table_id, {"k0": np.zeros(1, np.int64)}, pulled,
                           np.zeros(1, bool), ("k0",))]

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        """A fresh state with the recovered row landed at slot 0 by
        kernel R; downstream (the restored MV) already holds that row,
        so it is what downstream last saw."""
        self.state = agg_ops.create_state(2, self.calls, self._dtypes, self.device)
        self._last = None
        if not key_cols or not len(key_cols["k0"]):
            return
        dst = self._value_lanes()
        src = {k: np.asarray(value_cols[k])[:1] for k in dst}
        for n, fdt in self._float_decode.items():
            src[f"acc_{n}"] = agg_ops.order_key_from_reference(src[f"acc_{n}"])
        scatter_rows(dst, to_device(np.zeros(1, np.int32), self.device), src)
        self._last = self._current_row()
