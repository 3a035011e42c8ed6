"""Expression AST evaluated column-at-a-time on DataChunks.

Port of ``risingwave_tpu/expr/expr.py``. Reference: the
``Expression`` trait (src/expr/core/src/expr/) evaluates on a whole
DataChunk; scalar kernels come from the #[function] macro
(src/expr/macro/src/).

NULL semantics, as in the reference:
- arithmetic / comparison are NULL-strict: any NULL input -> NULL out;
- AND / OR implement SQL three-valued logic
  (TRUE OR NULL = TRUE, FALSE AND NULL = FALSE, else NULL);
- predicates used by Filter keep only rows that are TRUE (NULL drops).

Every node's ``_build(b)`` traces it into typed operations of a tracer
(``ops/expr_vm.py``): the plain PyTorch tree walk runs them on whole
lanes, the compiler records them as kernel S's program. ``eval(chunk)``
takes the tree walk on CPU tensors and kernel S on CUDA tensors, and
returns ``(values, nulls)`` (``nulls`` None when the value has no NULL
lane). Result types follow the reference's ``jnp`` promotion with weak
literals (``expr/dtypes.py``).
"""

from __future__ import annotations

import dataclasses as _dc
import threading as _threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as _np
import torch

from risingwave_tpu_torch.expr import dtypes as D

# (values, null_lane) -- null lane may be None meaning "no NULLs"
EvalResult = Tuple[torch.Tensor, Optional[torch.Tensor]]


class Expr:
    """Base node. Subclasses implement ``_build(tracer) -> value``."""

    def eval(self, chunk) -> EvalResult:
        from risingwave_tpu_torch.ops import expr_vm

        cols, nulls = expr_vm.project(chunk, (("v", self),))
        return cols["v"], nulls.get("v")

    def _build(self, b):  # pragma: no cover
        raise NotImplementedError(f"{type(self).__name__} cannot be evaluated")

    # -- operator sugar --------------------------------------------------
    def __add__(self, o):
        return BinOp("+", self, _wrap(o))

    def __sub__(self, o):
        return BinOp("-", self, _wrap(o))

    def __mul__(self, o):
        return BinOp("*", self, _wrap(o))

    def __floordiv__(self, o):
        return BinOp("//", self, _wrap(o))

    def __mod__(self, o):
        return BinOp("%", self, _wrap(o))

    def __eq__(self, o):  # type: ignore[override]
        return BinOp("==", self, _wrap(o))

    def __ne__(self, o):  # type: ignore[override]
        return BinOp("!=", self, _wrap(o))

    def __lt__(self, o):
        return BinOp("<", self, _wrap(o))

    def __le__(self, o):
        return BinOp("<=", self, _wrap(o))

    def __gt__(self, o):
        return BinOp(">", self, _wrap(o))

    def __ge__(self, o):
        return BinOp(">=", self, _wrap(o))

    def __and__(self, o):
        return And(self, _wrap(o))

    def __or__(self, o):
        return Or(self, _wrap(o))

    def __invert__(self):
        return Not(self)

    __hash__ = object.__hash__  # __eq__ override would otherwise kill it


def structural_key(v) -> tuple:
    """Hashable STRUCTURAL identity of an expression tree.

    ``Expr.__eq__`` is operator sugar -- ``a == b`` BUILDS a ``BinOp``
    (always truthy) -- so Exprs must never be compared with ``==`` for
    caching: kernel S's program cache and the fused plans key on this
    instead (``StaticTree``)."""
    if isinstance(v, Expr):
        return (type(v).__name__,) + tuple(
            structural_key(getattr(v, f.name)) for f in _dc.fields(v)
        )
    if isinstance(v, (tuple, list)):
        return ("#seq",) + tuple(structural_key(x) for x in v)
    if isinstance(v, dict):
        return ("#map",) + tuple(
            (structural_key(k), structural_key(x))
            for k, x in sorted(v.items(), key=lambda kv: repr(kv[0]))
        )
    return ("#leaf", type(v).__name__, v)


def collect_columns(node) -> frozenset:
    """Every input column name an expression tree reads (the lint
    surface behind ``Executor.lint_info`` requires-sets)."""
    out = set()

    def walk(x):
        if isinstance(x, Col):
            out.add(x.name)
            return
        if isinstance(x, Expr):
            if _dc.is_dataclass(x):
                for f in _dc.fields(x):
                    walk(getattr(x, f.name))
            return
        if isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(node)
    return frozenset(out)


class StaticTree:
    """A wrapper giving an Expr-bearing value structural eq/hash (see
    structural_key): the pure steps hold their trees in one, so two
    equal plans compare equal."""

    __slots__ = ("value", "_key", "_memo")

    def __init__(self, value):
        self.value = value
        self._key = structural_key(value)
        self._memo = {}

    @property
    def key(self) -> tuple:
        return self._key

    def derived(self, name: str, make):
        """A value derived from the tree, made once (kernel S looks its
        program up through these on every call)."""
        if name not in self._memo:
            self._memo[name] = make()
        return self._memo[name]

    def columns(self) -> tuple:
        """The sorted input columns the tree reads."""
        return self.derived("columns", lambda: tuple(sorted(collect_columns(self.value))))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, StaticTree) and self._key == other._key

    def __ne__(self, other):
        return not self.__eq__(other)


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> "Col":
    return Col(name)


def lit(v) -> "Lit":
    return Lit(v)


# -- typed building blocks shared by the nodes ------------------------------


def cast(b, v, dtype):
    """``v.astype(dtype)``: a strong value of ``dtype``."""
    if v.dtype == dtype:
        return v.retag(False)
    return b.op("cast", [v], dtype, attr=(0, 0, v.dtype))


def to_bool(b, v):
    return cast(b, v, torch.bool)


_ARITH = {"+": "add", "-": "sub", "*": "mul"}
_CMP = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}


def binary(b, op: str, lv, rv):
    """One ``jnp`` binary operator over two values, the operands cast to
    its promoted type (``_BIN_FNS``, reference :318)."""
    t = D.result_type((lv.dtype, lv.weak), (rv.dtype, rv.weak))
    if op in _CMP:
        dt = t[0]
        return b.op(_CMP[op], [cast(b, lv, dt), cast(b, rv, dt)], dt, out=torch.bool)
    if op in _ARITH:
        dt, weak = t
        if dt == torch.bool:  # jnp.add / jnp.multiply of bools: OR / AND
            if op == "-":
                raise TypeError("boolean subtract is not supported")
            return b.op("bor" if op == "+" else "band", [lv.retag(False), rv.retag(False)], dt)
        name = _ARITH[op]
    elif op == "//":
        (dt, weak), name = D.to_numeric(t), "floordiv"
    elif op == "%":
        (dt, weak), name = D.to_numeric(t), "rem"
    elif op == "/":
        (dt, weak), name = D.to_inexact(t), "truediv"
    else:
        raise ValueError(f"unknown operator {op!r}")
    return b.op(name, [cast(b, lv, dt), cast(b, rv, dt)], dt, weak=weak)


def const(b, value):
    """A Python or numpy scalar as ``jnp.full`` makes it (weak ints and
    floats)."""
    dt, weak = D.literal_type(value)
    return b.const(value, dt, weak)


@dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def _build(self, b):
        return b.col(self.name)


@dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: object  # python scalar; None = SQL NULL literal

    def _build(self, b):
        if self.value is None:  # an int32 zero lane, all NULL
            return b.null_const()
        return const(b, self.value)


# -- lifted literals (multi-tenant compile sharing) ---------------------
#
# Two structurally-identical plans that differ ONLY in literal values
# would compile two kernel-S programs -- a baked literal is part of the
# program's key and literal pool. ``lift_literals`` rewrites numeric
# Lits into slot references against an ambient parameter vector that
# kernel S reads as an operand, so K parameter variants share ONE
# compiled program. The fused program proves the lifted plan's types
# equal to the baked one's before trusting it (a weak literal promotes
# otherwise than its strong int64/float64 slot).

_PARAM_ENV = _threading.local()


def params_active() -> bool:
    """True while a (non-empty) lifted-literal param scope is bound."""
    return getattr(_PARAM_ENV, "params", None) is not None


def current_params():
    """The bound parameter vectors (``{"i": int64, "f": float64}``
    tensors), or None."""
    return getattr(_PARAM_ENV, "params", None)


@contextmanager
def param_scope(params):
    """Bind the lifted-literal parameter vectors while a fused program
    runs; the lifted steps inside read them."""
    prev = getattr(_PARAM_ENV, "params", None)
    _PARAM_ENV.params = params
    try:
        yield
    finally:
        _PARAM_ENV.params = prev


@dataclass(frozen=True, eq=False)
class LiftedLit(Expr):
    """A literal lifted to ``params[lane][slot]``: structurally equal
    across plans regardless of the VALUE, which rides in the parameter
    operand."""

    slot: int
    lane: str  # "i" (int64) | "f" (float64)

    def _build(self, b):
        return b.param(self.lane, self.slot)


def lift_literals(value, ints: list, floats: list):
    """Rebuild an Expr-bearing structure with numeric Lits replaced by
    LiftedLit slots, appending the values to ``ints``/``floats`` in
    traversal order (the order is part of the structure, so equal
    shapes assign equal slots). Non-numeric literals (None/str/bool)
    stay baked."""

    def walk(v):
        if isinstance(v, LiftedLit):
            return v  # idempotent
        if isinstance(v, Lit):
            x = v.value
            if isinstance(x, bool) or isinstance(x, _np.bool_):
                return v
            if isinstance(x, (int, _np.integer)):
                ints.append(int(x))
                return LiftedLit(len(ints) - 1, "i")
            if isinstance(x, (float, _np.floating)):
                floats.append(float(x))
                return LiftedLit(len(floats) - 1, "f")
            return v
        if isinstance(v, Expr) and _dc.is_dataclass(v):
            return type(v)(*(walk(getattr(v, f.name)) for f in _dc.fields(v)))
        if isinstance(v, (tuple, list)):
            return tuple(walk(x) for x in v)
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return v

    return walk(value)


@dataclass(frozen=True, eq=False)
class AssumeNotNull(Expr):
    """Drop the NULL lane (the planner inserts it only after a
    NULL-filter on the column)."""

    inner: Expr

    def _build(self, b):
        v = self.inner._build(b)
        return b.op("notnull", [v], v.dtype, weak=v.weak)


@dataclass(frozen=True, eq=False)
class Cast(Expr):
    """Device dtype cast (CAST(x AS t) on fixed-width lanes). ``dtype``
    is a torch or numpy dtype."""

    inner: Expr
    dtype: object

    def _build(self, b):
        return cast(b, self.inner._build(b), D.torch_dtype(self.dtype))


@dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def _build(self, b):
        lv = self.left._build(b)
        rv = self.right._build(b)
        if self.op in ("//", "%", "/"):
            # a zero divisor gives NULL, never a trap (non-strict eval,
            # reference src/expr/core/src/expr/non_strict.rs)
            rv = b.op("guardz", [rv], rv.dtype)
        return binary(b, self.op, lv, rv)


@dataclass(frozen=True, eq=False)
class And(Expr):
    left: Expr
    right: Expr

    def _build(self, b):
        lv = to_bool(b, self.left._build(b))
        rv = to_bool(b, self.right._build(b))
        return b.op("and3", [lv, rv], torch.bool)


@dataclass(frozen=True, eq=False)
class Or(Expr):
    left: Expr
    right: Expr

    def _build(self, b):
        lv = to_bool(b, self.left._build(b))
        rv = to_bool(b, self.right._build(b))
        return b.op("or3", [lv, rv], torch.bool)


@dataclass(frozen=True, eq=False)
class Not(Expr):
    inner: Expr

    def _build(self, b):
        return b.op("not", [to_bool(b, self.inner._build(b))], torch.bool)


@dataclass(frozen=True, eq=False)
class IsNull(Expr):
    inner: Expr
    negate: bool = False

    def _build(self, b):
        v = self.inner._build(b)
        return b.op("isnull", [v], torch.bool, attr=(int(self.negate), 0, None))


@dataclass(frozen=True, eq=False)
class Between(Expr):
    """lo <= v <= hi (inclusive, SQL BETWEEN)."""

    inner: Expr
    lo: Expr
    hi: Expr

    def _build(self, b):
        v = self.inner._build(b)
        lo = self.lo._build(b)
        hi = self.hi._build(b)
        return b.op("band", [binary(b, ">=", v, lo), binary(b, "<=", v, hi)], torch.bool)


@dataclass(frozen=True, eq=False)
class InList(Expr):
    inner: Expr
    values: Tuple

    def _build(self, b):
        v = self.inner._build(b)
        if not self.values:
            return b.op("false", [v], torch.bool)
        hit = None
        for item in self.values:
            eq = binary(b, "==", v, const(b, item))
            hit = eq if hit is None else b.op("bor", [hit, eq], torch.bool)
        return hit


@dataclass(frozen=True, eq=False)
class Case(Expr):
    """CASE WHEN cond THEN val ... ELSE default END."""

    branches: Tuple[Tuple[Expr, Expr], ...]
    default: Expr

    def _build(self, b):
        evaluated = [(c._build(b), o._build(b)) for c, o in self.branches]
        val = self.default._build(b)
        # the result type is promoted across ALL branches and the default
        rdtype, _ = D.result_type((val.dtype, val.weak),
                                  *((o.dtype, o.weak) for _, o in evaluated))
        val = cast(b, val, rdtype)
        # in reverse so earlier branches win
        for c, o in reversed(evaluated):
            val = b.op("select", [to_bool(b, c), cast(b, o, rdtype), val], rdtype)
        return val


@dataclass(frozen=True, eq=False)
class TumbleStart(Expr):
    """Tumbling-window bucket start: (ts // size) * size."""

    ts: Expr
    size_ms: int

    def _build(self, b):
        v = self.ts._build(b)
        size = const(b, self.size_ms)
        dt, weak = D.to_numeric(D.result_type((v.dtype, v.weak), (size.dtype, size.weak)))
        q = b.op("floordiv", [cast(b, v, dt), cast(b, size, dt)], dt, weak=weak)
        return binary(b, "*", q, size)
