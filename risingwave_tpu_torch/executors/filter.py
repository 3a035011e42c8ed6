"""Filter executor -- predicate over visibility, zero data movement.

Port of ``risingwave_tpu/executors/filter.py``. Reference:
src/stream/src/executor/filter.rs. The reference also downgrades
broken UpdateDelete/UpdateInsert pairs (where only one half passes) to
plain Delete/Insert; with columnar ops that is an elementwise rewrite
of the op lane, done in the same step.

On the card the whole step -- the predicate's program, the mask and the
torn-pair rewrite -- is one launch of kernel S's ``rw_filter``
(``ops/expr_vm.py``, ``csrc/expr_eval.cu``); on the CPU it is the plain
tree walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.expr import Expr
from risingwave_tpu_torch.expr.expr import StaticTree, collect_columns
from risingwave_tpu_torch.ops import expr_vm


def filter_step_fn(chunk: StreamChunk, pred: StaticTree) -> StreamChunk:
    """``_filter_step`` (reference :25): keep the rows whose predicate is
    TRUE (NULL drops), then fix torn update pairs. Lanes of shape (C,)
    or stacked (n_chunks, C); pairs never cross chunks."""
    valid, ops = expr_vm.filter_chunk(chunk, pred.value, pred)
    return StreamChunk(chunk.columns, valid, chunk.nulls, ops)


@dataclass(frozen=True)
class FilterStep:
    """``filter_step_fn`` with its predicate bound: the executor's pure
    step (see ``Executor.pure_step``). The predicate rides as a
    structurally keyed ``StaticTree``, so equal plans compare equal."""

    pred: StaticTree

    def __call__(self, chunk: StreamChunk) -> StreamChunk:
        return filter_step_fn(chunk, self.pred)

    def rows(self, capacity: int) -> int:
        return capacity

    def signature(self, sig: dict) -> dict:
        """Output ``{column: (dtype, nullable)}`` of an input signature."""
        return dict(sig)


class FilterExecutor(Executor):
    def __init__(self, pred: Expr):
        self._spred = StaticTree(pred)
        self.pred = pred

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        return [filter_step_fn(chunk, self._spred)]

    def lint_info(self):
        return {"requires": tuple(sorted(collect_columns(self.pred)))}

    def pure_step(self) -> FilterStep:
        return FilterStep(self._spred)
