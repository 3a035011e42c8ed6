"""Project executor -- computed columns.

Port of ``risingwave_tpu/executors/project.py``. Reference:
src/stream/src/executor/project.rs (non-strict expression evaluation
over whole chunks). Output columns replace the chunk's column set;
ops/visibility pass through untouched.

On the card every computed output of the projection comes from one
launch of kernel S's ``rw_project`` (``ops/expr_vm.py``); a bare column
passes through as the same tensor, as in the reference. On the CPU it
is the plain tree walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.expr import Expr
from risingwave_tpu_torch.expr.expr import Cast, Col, StaticTree, collect_columns
from risingwave_tpu_torch.ops import expr_vm


def project_step_fn(chunk: StreamChunk, outputs: StaticTree) -> StreamChunk:
    """``_project_step`` (reference :22) over ``outputs``, a StaticTree
    of ``(name, Expr)`` pairs. Lanes of shape (C,) or stacked."""
    cols, nulls = expr_vm.project(chunk, outputs.value, outputs)
    return StreamChunk(cols, chunk.valid, nulls, chunk.ops)


@dataclass(frozen=True)
class ProjectStep:
    """``project_step_fn`` with its outputs bound: the executor's pure
    step (see ``Executor.pure_step``)."""

    outputs: StaticTree

    def __call__(self, chunk: StreamChunk) -> StreamChunk:
        return project_step_fn(chunk, self.outputs)

    def rows(self, capacity: int) -> int:
        return capacity

    def signature(self, sig: dict) -> dict:
        """Output ``{column: (dtype, nullable)}`` of an input signature."""
        return expr_vm.output_types(self.outputs.value, sig)


class ProjectExecutor(Executor):
    """``outputs`` maps output column name -> expression."""

    def __init__(self, outputs: Dict[str, Expr]):
        self.outputs = tuple(outputs.items())
        self._souts = StaticTree(self.outputs)

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        return [project_step_fn(chunk, self._souts)]

    def lint_info(self):
        requires = set()
        emits, renames = {}, {}
        for name, e in self.outputs:
            requires |= collect_columns(e)
            renames[name] = e.name if isinstance(e, Col) else None
            emits[name] = e.dtype if isinstance(e, Cast) else None
        return {
            "requires": tuple(sorted(requires)),
            "emits": emits,
            "renames": renames,
        }

    def pure_step(self) -> ProjectStep:
        return ProjectStep(self._souts)
