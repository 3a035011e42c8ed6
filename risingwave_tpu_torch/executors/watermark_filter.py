"""WatermarkFilter -- generates event-time watermarks and drops late
rows.

Port of ``risingwave_tpu/executors/watermark_filter.py``. Reference:
src/stream/src/executor/watermark_filter.rs:39 -- tracks the maximum
observed event time, emits ``wm = max_event_time - lag`` into the
stream, filters rows whose event time is already below the current
watermark.

The running maximum is a device scalar folded per chunk inside the same
step that masks late rows, so nothing waits for the card on the hot
path; the host reads it once per barrier, in ``emit_watermark``, which
the pipeline calls after every barrier. On the card the step is one
launch of kernel T (``csrc/wm_filter.cu``); on the CPU it is the plain
version below.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from risingwave_tpu_torch import _kernels, resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor, Watermark
from risingwave_tpu_torch.ops.expr_vm import torn_pair_ops
from risingwave_tpu_torch.types import Op

INT64_MIN = -(2**63)


def wm_step_fn(chunk: StreamChunk, running_max: torch.Tensor, col: str, floor: int) -> StreamChunk:
    """``_wm_step`` (reference :31): fold the chunk's maximum active event
    time into ``running_max`` (a () int64 tensor, updated in place; the
    reference donates it), drop inserts below ``floor`` (the host's
    watermark), pass retractions, and turn a surviving U- whose U+ was
    dropped into a Delete."""
    if chunk.valid.device.type == "cpu":
        return _wm_torch(chunk, running_max, col, floor)
    if chunk.valid.device.type == "cuda":
        return _wm_cuda(chunk, running_max, col, floor)
    raise ValueError(f"unsupported device {chunk.valid.device}")


def _wm_torch(chunk, running_max, col, floor):
    ts = chunk.col(col)
    active = chunk.valid & (chunk.effective_signs() != 0)
    null = chunk.nulls.get(col)
    if null is not None:
        active = active & ~null
    if ts.numel():
        cmax = torch.where(active, ts, torch.full_like(ts, INT64_MIN)).max()
        running_max.copy_(torch.maximum(running_max, cmax))
    # INSERT rows strictly below the current watermark are late; a
    # retraction passes regardless (its target may already be cleaned
    # downstream, where it no-ops)
    retract = (chunk.ops == Op.DELETE) | (chunk.ops == Op.UPDATE_DELETE)
    valid = chunk.valid & ((ts >= floor) | retract)
    ops = torn_pair_ops(valid, chunk.ops, fix_insert=False)
    return StreamChunk(chunk.columns, valid, chunk.nulls, ops)


def _wm_cuda(chunk, running_max, col, floor):
    ts = chunk.col(col)
    if ts.dtype != torch.int64 or ts.dim() != 1:
        raise TypeError(f"watermark filter: {col!r} must be a (C,) int64 event-time lane")
    if chunk.ops.dtype != torch.int32 or running_max.dtype != torch.int64:
        raise TypeError("watermark filter: ops must be int32 and the running max int64")
    null = chunk.nulls.get(col)
    lanes = [ts, chunk.valid, chunk.ops, running_max] + ([null] if null is not None else [])
    _kernels.check_cuda("wm_filter", *lanes)
    n = chunk.valid.shape[0]
    for t in (ts, chunk.ops) + ((null,) if null is not None else ()):
        if t.shape != (n,):
            raise ValueError("watermark filter: every lane must have the valid lane's shape")
    valid = torch.empty_like(chunk.valid)
    ops = torch.empty_like(chunk.ops)
    _kernels.call(
        "wm_filter", "rw_wm_step", n, ts.data_ptr(), 0 if null is None else null.data_ptr(),
        chunk.valid.data_ptr(), chunk.ops.data_ptr(), int(floor), running_max.data_ptr(),
        valid.data_ptr(), ops.data_ptr(),
    )
    return StreamChunk(chunk.columns, valid, chunk.nulls, ops)


class WatermarkFilterExecutor(Executor):
    """Emit ``wm = max(event_time) - lag_ms`` and drop late rows.

    The pipeline calls ``emit_watermark()`` after each barrier; the
    returned watermark walks the downstream chain (and, through a
    join's alignment, cleans both sides) without anyone having to
    inject one.
    """

    def __init__(self, column: str, lag_ms: int, device="cuda"):
        self.device = resolve_device(device)
        self.column = column
        self.lag_ms = int(lag_ms)
        self._running_max = torch.full((), INT64_MIN, dtype=torch.int64, device=self.device)
        self._wm: Optional[int] = None  # host copy, refreshed per barrier

    def lint_info(self):
        return {
            "requires": (self.column,),
            "watermark_src": self.column,
        }

    def trace_contract(self):
        return {
            "kind": "device",
            # the step on a copy of the running max: tracing must not
            # move the executor's state
            "trace_step": lambda c: wm_step_fn(
                c, self._running_max.clone(), self.column, INT64_MIN
            ),
            "state": self._running_max,
            "donate": True,
            "emission": "passthrough",
            # watermark generation reads the running max once per
            # barrier -- a real (if small) host sync
            "hot_methods": ("emit_watermark",),
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        floor = self._wm if self._wm is not None else INT64_MIN
        return [wm_step_fn(chunk, self._running_max, self.column, floor)]

    def emit_watermark(self) -> Optional[Watermark]:
        mx = int(self._running_max)
        if mx == INT64_MIN:
            return None
        wm = mx - self.lag_ms
        if self._wm is not None and wm <= self._wm:
            return None
        self._wm = wm
        return Watermark(self.column, wm)

    def on_watermark(self, watermark: Watermark):
        # an upstream watermark on our column advances ours too
        if watermark.column == self.column and (
            self._wm is None or watermark.value > self._wm
        ):
            self._wm = watermark.value
        return watermark, []
