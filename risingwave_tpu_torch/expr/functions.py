"""Scalar function library + registry.

Port of ``risingwave_tpu/expr/functions.py`` up to its UDF half.
Reference: src/expr/impl/src/scalar/ (the #[function] kernels in a
global FUNCTION_REGISTRY the binder resolves against). Each registered
function builds its result from the typed operations of
``ops/expr_vm.py``, so it runs in the plain tree walk on CPU tensors
and inside kernel S's program on the card.

NULL policy mirrors the reference: strict by default (any NULL input
-> NULL output); COALESCE/NULLIF handle NULLs explicitly; domain errors
(div 0, sqrt(-x), log(0)) go NULL in non-strict stream eval.

Temporal kernels treat TIMESTAMP as int64 ms since the Unix epoch and
use the classic civil-from-days integer algorithm
(``expr_vm.civil_from_days``), so EXTRACT / DATE_TRUNC run on the
device.

Not ported: Python and external UDFs (``register_py_udf``,
``register_external_udf``, ``drop_function``; reference :540-778). They
need ``udf_server.py`` (ROADMAP S8); calling one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from risingwave_tpu_torch.expr import dtypes as D
from risingwave_tpu_torch.expr.expr import Expr, binary, cast
from risingwave_tpu_torch.ops import expr_vm

# name -> (min_arity, max_arity, impl(tracer, *values) -> value)
_REGISTRY: Dict[str, Tuple[int, int, Callable]] = {}

_F64 = torch.float64
_I64 = torch.int64


def register(name, min_arity, max_arity=None):
    def deco(fn):
        _REGISTRY[name] = (min_arity, max_arity or min_arity, fn)
        return fn

    return deco


def lookup(name: str) -> Optional[Tuple[int, int, Callable]]:
    return _REGISTRY.get(name)


def registry_names():
    return sorted(_REGISTRY)


def _math1(b, fn: str, v):
    return b.op("math1", [cast(b, v, _F64)], _F64, attr=(0, 0, fn))


def _math2(b, fn: str, x, y):
    return b.op("math2", [cast(b, x, _F64), cast(b, y, _F64)], _F64, attr=(0, 0, fn))


# -- numeric --------------------------------------------------------------
@register("abs", 1)
def _abs(b, v):
    return b.op("abs", [v], v.dtype, weak=v.weak)


@register("sign", 1)
def _sign(b, v):
    return b.op("sign", [v], v.dtype, weak=v.weak)


def _float_only(name):
    def impl(b, v):
        if not v.dtype.is_floating_point:
            return v
        return b.op(name, [v], v.dtype, weak=v.weak)

    return impl


register("ceil", 1)(_float_only("ceil"))
register("floor", 1)(_float_only("floor"))


def _scaled(name):
    """round / trunc with an optional digit count:
    ``op(v * 10.0 ** digits) / 10.0 ** digits`` for floats."""

    def impl(b, v, digits=None):
        if not v.dtype.is_floating_point:
            return v if digits is None else _strict_pass(b, v, digits)
        if digits is None:
            return b.op(name, [v], v.dtype, weak=v.weak)
        # 10.0 ** digits: float32 digits give float32, ints float64
        sdt = digits.dtype if digits.dtype.is_floating_point else _F64
        scale = b.op("pow10", [cast(b, digits, sdt)], sdt, weak=digits.weak)
        x = binary(b, "*", v, scale)
        r = b.op(name, [x], x.dtype, weak=x.weak)
        return binary(b, "/", r, scale)

    return impl


def _strict_pass(b, v, other):
    """``v`` unchanged, NULL where ``v`` or ``other`` is."""
    if not other.nullable:
        return v
    return b.op("first", [v, other], v.dtype, weak=v.weak)


register("round", 1, 2)(_scaled("round"))
register("trunc", 1, 2)(_scaled("trunc"))


@register("mod", 2)
def _mod(b, x, y):
    safe = b.op("guardz", [y], y.dtype)
    return binary(b, "%", x, safe)


@register("pow", 2)
@register("power", 2)
def _pow(b, x, y):
    return _math2(b, "pow", x, y)


for _name in ("sqrt", "exp", "ln", "log10", "cbrt", "log2", "sin", "cos", "tan", "cot", "asin",
              "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "degrees",
              "radians"):
    register(_name, 1)(lambda b, v, _fn=_name: _math1(b, _fn, v))


@register("log", 2)
def _log(b, base, x):
    return _math2(b, "log", base, x)


@register("atan2", 2)
def _atan2(b, y, x):
    return _math2(b, "atan2", y, x)


@register("hypot", 2)
def _hypot(b, x, y):
    return _math2(b, "hypot", x, y)


@register("factorial", 1)
def _factorial(b, v):
    return b.op("factorial", [cast(b, v, _I64)], _I64)


def _int64_op(name):
    def impl(b, *vs):
        return b.op(name, [cast(b, v, _I64) for v in vs], _I64)

    return impl


register("gcd", 2)(_int64_op("gcd"))
register("lcm", 2)(_int64_op("lcm"))
register("bit_and", 2)(_int64_op("bitand"))
register("bit_or", 2)(_int64_op("bitor"))
register("bit_xor", 2)(_int64_op("bitxor"))
register("bit_not", 1)(_int64_op("bitnot"))
register("bit_shift_left", 2)(_int64_op("shl"))
register("bit_shift_right", 2)(_int64_op("shr"))


def _fold(name):
    def impl(b, *vs):
        out = vs[0]
        for v in vs[1:]:
            dt, weak = D.result_type((out.dtype, out.weak), (v.dtype, v.weak))
            out = b.op(name, [cast(b, out, dt), cast(b, v, dt)], dt, weak=weak)
        return out

    return impl


register("greatest", 2, 8)(_fold("max"))
register("least", 2, 8)(_fold("min"))


# -- temporal (int64 ms since epoch): the lane forms live with the opcodes --
extract_field = expr_vm.extract_field
date_trunc_field = expr_vm.date_trunc_field


# -- expr nodes -------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class Func(Expr):
    """Registry-dispatched scalar function, NULL-strict."""

    name: str
    args: Tuple[Expr, ...]

    def _build(self, b):
        entry = lookup(self.name)
        if entry is None:
            raise KeyError(f"unknown function {self.name!r}")
        lo, hi, impl = entry
        if not (lo <= len(self.args) <= hi):
            raise TypeError(f"{self.name}() takes {lo}..{hi} args, got {len(self.args)}")
        return impl(b, *(a._build(b) for a in self.args))


@dataclass(frozen=True, eq=False)
class Extract(Expr):
    field: str
    ts: Expr

    def _build(self, b):
        if self.field not in expr_vm.EXTRACT_FIELDS:
            raise ValueError(f"unknown EXTRACT field {self.field!r}")
        v = cast(b, self.ts._build(b), _I64)
        return b.op("extract", [v], _I64, attr=(0, 0, self.field))


@dataclass(frozen=True, eq=False)
class DateTrunc(Expr):
    field: str
    ts: Expr

    def _build(self, b):
        if self.field not in expr_vm.TRUNC_FIELDS:
            raise ValueError(f"unknown date_trunc field {self.field!r}")
        v = cast(b, self.ts._build(b), _I64)
        return b.op("datetrunc", [v], _I64, attr=(0, 0, self.field))


@dataclass(frozen=True, eq=False)
class Coalesce(Expr):
    args: Tuple[Expr, ...]

    def _build(self, b):
        val = self.args[0]._build(b)
        for a in self.args[1:]:
            if not val.nullable:
                break
            v = a._build(b)
            rd, _ = D.result_type((val.dtype, val.weak), (v.dtype, v.weak))
            val = b.op("coalesce2", [cast(b, val, rd), cast(b, v, rd)], rd)
        return val


@dataclass(frozen=True, eq=False)
class NullIf(Expr):
    a: Expr
    b: Expr

    def _build(self, bld):
        av = self.a._build(bld)
        bv = self.b._build(bld)
        eq = binary(bld, "==", av, bv)
        return bld.op("nullif", [av, eq], av.dtype, weak=av.weak)


# -- dictionary-backed string functions ------------------------------------
@dataclass(frozen=True, eq=False)
class StringFunc(Expr):
    """VARCHAR function over dictionary codes (array/dictionary.py):
    the host maps the (small) dictionary once -- upper/lower yield a
    code->code table, length a code->int table -- and the device applies
    it as one gather."""

    name: str  # upper | lower | length
    inner: Expr
    dictionary: object  # StringDictionary

    def _table(self) -> np.ndarray:
        d = self.dictionary
        strings = [d.decode_one(i) for i in range(len(d))]
        if self.name == "length":
            return np.fromiter((len(s) for s in strings), np.int64, count=len(strings))
        fn = str.upper if self.name == "upper" else str.lower
        return d.encode([fn(s) for s in strings])

    def _build(self, b):
        return b.gather(self.inner._build(b), self._table())


# -- user-defined functions (not ported) -------------------------------------
def register_py_udf(*args, **kwargs):
    raise NotImplementedError("Python UDFs need udf_server.py, which is not ported yet")


def register_external_udf(*args, **kwargs):
    raise NotImplementedError("external UDFs need udf_server.py, which is not ported yet")


def drop_function(name: str) -> bool:
    raise NotImplementedError("UDFs are not ported yet")


def is_protected(name: str) -> bool:
    """Whether ``name`` is a UDF the session may not drop or replace
    (reference :771). No UDF can be registered yet, so none is."""
    return False


def udf_signature(name: str):
    """(out_field, arg_fields) of a registered UDF, else None (reference
    :775; the SQL typing pass reads it). No UDF can be registered yet."""
    return None
