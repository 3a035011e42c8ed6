"""RowIdGen executor -- hidden serial pk for pk-less streams.

Port of ``risingwave_tpu/executors/row_id_gen.py``. Reference:
src/stream/src/executor/row_id_gen.rs -- assigns a serial row id so
append-only tables without a user pk still have a stable one. Here: ids
are ``base + lane`` per chunk with a host-side base counter, made on
the chunk's device by one ``torch.arange``. The counter checkpoints (the
reference persists row-id state the same way): a recovered pipeline
continues the id sequence instead of colliding with restored MV pks.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.storage.state_table import Checkpointable, StateDelta


class RowIdGenExecutor(Executor, Checkpointable):
    def __init__(self, out_col: str = "_row_id", table_id: str = "row_id_gen"):
        self.out_col = out_col
        self.table_id = table_id
        self._base = 0
        self._committed = -1

    def lint_info(self):
        return {
            "adds": {self.out_col: torch.int64},
            "table_ids": (self.table_id,),
        }

    def state_nbytes(self) -> int:
        """The only state is two host counters."""
        return 16

    def trace_contract(self):
        return {
            "kind": "device",
            "trace_step": lambda c: c.with_columns(
                **{self.out_col: torch.arange(c.capacity, dtype=torch.int64, device=c.device)}
            ),
            "state": None,
            "donate": True,
            "emission": "passthrough",
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        if self.out_col in chunk.columns:
            # DML deletes/updates address existing rows BY id -- never
            # reassign (the reference only fills fresh inserts)
            return [chunk]
        cap = chunk.capacity
        ids = torch.arange(self._base, self._base + cap, dtype=torch.int64, device=chunk.device)
        self._base += cap
        return [chunk.with_columns(**{self.out_col: ids})]

    # -- integrity --------------------------------------------------------
    def state_digest(self) -> int:
        """Durable logical state is the id watermark (one counter)."""
        from risingwave_tpu_torch.integrity import host_obj_digest

        return host_obj_digest({"base": int(self._base)})

    # -- checkpoint/restore ----------------------------------------------
    def checkpoint_delta(self) -> List[StateDelta]:
        if self._base == self._committed:
            return []
        self._committed = self._base
        return [
            StateDelta(
                self.table_id,
                {"k": np.zeros(1, np.int64)},
                {"base": np.asarray([self._base], np.int64)},
                np.zeros(1, bool),
                ("k",),
            )
        ]

    def restore_state(self, table_id, key_cols, value_cols) -> None:
        if key_cols:
            self._base = int(value_cols["base"][0])
            self._committed = self._base
