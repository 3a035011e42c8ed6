"""Generator executors: VALUES and NOW().

Port of ``risingwave_tpu/executors/generators.py``. Reference:
- src/stream/src/executor/values.rs — emits a literal row set exactly
  once (the first barrier after creation), then only barriers;
- src/stream/src/executor/now.rs — maintains a single row holding the
  current barrier timestamp, updated with U-/U+ per epoch (drives
  temporal filters like ``ts > NOW() - INTERVAL ...``).

Both are control-plane-paced (rows appear at barriers, not between),
which is how the host epoch loop drives executors. Host code: each
builds its chunk with numpy and puts it on the executor's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from risingwave_tpu_torch import resolve_device
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Barrier, Executor
from risingwave_tpu_torch.types import Op


class ValuesExecutor(Executor):
    """Emit a fixed row set once, at the first barrier."""

    def __init__(self, columns: Dict[str, np.ndarray], row_id_col: str = "_row_id",
                 device="cuda"):
        self.device = resolve_device(device)
        n = len(next(iter(columns.values()))) if columns else 0
        self._cols = {k: np.asarray(v) for k, v in columns.items()}
        self._cols[row_id_col] = np.arange(n, dtype=np.int64)
        self._emitted = False

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        raise TypeError("ValuesExecutor is a source; nothing flows into it")

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        if self._emitted:
            return []
        self._emitted = True
        n = len(next(iter(self._cols.values())))
        cap = max(2, 1 << (max(1, n) - 1).bit_length())
        return [StreamChunk.from_numpy(self._cols, cap, device=self.device)]


class NowExecutor(Executor):
    """One row carrying the barrier's timestamp, U-/U+ per epoch."""

    def __init__(self, out_col: str = "now", device="cuda"):
        self.device = resolve_device(device)
        self.out_col = out_col
        self._last: Optional[int] = None

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        raise TypeError("NowExecutor is a source; nothing flows into it")

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        # epoch encodes physical ms << 16 (epoch.rs:36)
        now_ms = barrier.epoch.curr >> 16
        if self._last == now_ms:
            return []
        if self._last is None:
            ops = np.asarray([Op.INSERT], np.int32)
            vals = [now_ms]
        else:
            ops = np.asarray([Op.UPDATE_DELETE, Op.UPDATE_INSERT], np.int32)
            vals = [self._last, now_ms]
        self._last = now_ms
        return [
            StreamChunk.from_numpy(
                {self.out_col: np.asarray(vals, np.int64)}, 2, ops=ops, device=self.device
            )
        ]
