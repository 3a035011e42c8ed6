"""Expression mini-framework.

Port of ``risingwave_tpu/expr/``. Reference: src/expr/core/src/expr/ --
the ``Expression`` trait whose impls evaluate over a whole
``DataChunk`` at once, plus the non-strict NULL semantics of the
#[function] codegen (src/expr/macro/).

An expression is a small AST of node objects. ``Expr.eval(chunk) ->
(values, nulls)`` returns a value lane and a bool NULL lane (or None);
on CPU tensors it is a plain PyTorch tree walk, on CUDA tensors a
program of kernel S (``ops/expr_vm.py``). Three-valued logic
(AND/OR/NOT over NULL) follows SQL; arithmetic and comparison are
NULL-strict.
"""

from risingwave_tpu_torch.expr.expr import (
    And,
    Between,
    BinOp,
    Case,
    Cast,
    Col,
    Expr,
    InList,
    IsNull,
    Lit,
    Not,
    Or,
    TumbleStart,
    col,
    lit,
)

__all__ = [
    "Expr",
    "Col",
    "Lit",
    "BinOp",
    "Cast",
    "And",
    "Or",
    "Not",
    "IsNull",
    "Case",
    "Between",
    "InList",
    "TumbleStart",
    "col",
    "lit",
]
