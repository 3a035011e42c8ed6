"""Kernel S: expressions compiled to a flat register program and run
row by row on the card (``rw_project``, ``rw_filter``).

Replaces the reference's expression evaluation inside the jitted
steps: ``risingwave_tpu/expr/expr.py`` (K23, every node's ``eval``),
``expr/functions.py`` (``Func`` and the registry, ``Extract``,
``DateTrunc``, ``Coalesce``, ``NullIf``, ``StringFunc``),
``executors/project.py:_project_step`` (K24b) and
``executors/filter.py:_filter_step`` (K24a, with the torn
update-pair rewrite).

An expression tree is traced once per (tree, input signature) by its
nodes' ``_build`` methods into macro operations over typed values, each
value a (64-bit value, NULL bit) pair. Two tracers take the trace:

- ``TorchTracer`` runs each operation at once on whole lanes with
  PyTorch: the plain version (``project_torch``, ``filter_torch``), the
  tree walk that ``Expr.eval`` takes on CPU tensors;
- ``Compiler`` records the operations as a ``Program``: typed opcodes,
  input lanes, a literal pool and registers allocated by a linear scan.
  A lifted literal (``expr.LiftedLit``) becomes a read of the parameter
  operand, so two plans that differ only in literal values compile to
  one program run with two parameter vectors.

``run_program_torch`` interprets a ``Program`` with the same opcode
semantics (``OPS``) on whole lanes, so the CPU tests check the compiler
without a card. On CUDA tensors ``project``/``filter_chunk`` launch
kernel S (``csrc/expr_eval.cu``): every thread runs the same
instruction stream for its row, so dispatch is warp-uniform. A node or
dtype the program cannot express raises ``NotImplementedError`` there;
nothing falls back to the plain version.

Types follow the reference's ``jnp`` promotion (``expr/dtypes.py``):
every operand is cast to the operation's type by an explicit ``cast``
operation. Integer arithmetic wraps at its width; ``//`` floors and
``%`` takes the divisor's sign, both as ``jnp.floor_divide`` and
``jnp.remainder`` compute them; float casts to integers saturate (NaN
gives 0), as XLA's do.
"""

from __future__ import annotations

import ctypes
import math
import struct
import threading
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.expr import dtypes as D
from risingwave_tpu_torch.types import Op

_LN10 = math.log(10.0)
_LN2 = math.log(2.0)

# ---------------------------------------------------------------------------
# opcode semantics on whole lanes (the plain version of every opcode)
# ---------------------------------------------------------------------------


def _full(like: torch.Tensor, value, dtype=None) -> torch.Tensor:
    return torch.full_like(like, value, dtype=dtype or like.dtype)


def _sgn(x: torch.Tensor) -> torch.Tensor:
    """``lax.sign``: -1, 0, 1 for ints; floats keep +-0 and NaN."""
    if x.dtype.is_floating_point:
        return torch.where(x > 0, _full(x, 1.0), torch.where(x < 0, _full(x, -1.0), x))
    return torch.sign(x)


def _int_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's truncating integer division: x / -1 wraps, x / 0 is -1."""
    neg1, zero = b == -1, b == 0
    safe = torch.where(neg1 | zero, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    q = torch.where(neg1, torch.neg(a), q)
    return torch.where(zero, _full(q, -1), q)


def _int_rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's truncating integer remainder: x % -1 is 0, x % 0 is x."""
    neg1, zero = b == -1, b == 0
    safe = torch.where(neg1 | zero, torch.ones_like(b), b)
    r = torch.fmod(a, safe)
    r = torch.where(neg1, torch.zeros_like(r), r)
    return torch.where(zero, a, r)


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round`` (half away from zero)."""
    t = torch.trunc(x)
    away = torch.where(x < 0, t - 1, t + 1)
    return torch.where((x - t).abs() >= 0.5, away, t)


def _floordiv(a, b):
    if a.dtype.is_floating_point:  # jnp's _float_divmod
        mod = torch.fmod(a, b)
        div = (a - mod) / b
        ind = (mod != 0) & (_sgn(b) != _sgn(mod))
        return _round_away(torch.where(ind, div - 1, div))
    q = _int_div(a, b)
    sel = (_sgn(a) != _sgn(b)) & (_int_rem(a, b) != 0)
    return torch.where(sel, q - 1, q)


def _remainder(a, b):
    if a.dtype.is_floating_point:
        tm = torch.fmod(a, b)
    else:
        b = torch.where(b == 0, torch.ones_like(b), b)
        tm = _int_rem(a, b)
    plus = ((tm < 0) != (b < 0)) & (tm != 0)
    return torch.where(plus, tm + b, tm)


def _cast(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``astype`` as XLA converts: float -> int saturates, NaN gives 0."""
    if v.dtype == dt:
        return v
    if dt == torch.bool:
        return v != 0
    if v.dtype.is_floating_point and not dt.is_floating_point:
        info = torch.iinfo(dt)
        hi = 2.0 ** (info.bits - 1)
        nan, over, under = v != v, v >= hi, v < -hi
        safe = torch.where(nan | over | under, torch.zeros_like(v), v).to(dt)
        safe = torch.where(over, _full(safe, info.max), safe)
        return torch.where(under, _full(safe, info.min), safe)
    return v.to(dt)


def _cbrt(f: torch.Tensor) -> torch.Tensor:
    y = torch.sign(f) * f.abs().pow(1.0 / 3.0)
    ok = (y != 0) & torch.isfinite(y)
    y2 = torch.where(ok, y, torch.ones_like(y))
    return torch.where(ok, y2 - (y2 * y2 * y2 - f) / (3.0 * y2 * y2), y)  # one Newton step


def _hypot(a, b):  # jnp.hypot, step for step
    x1, x2 = a.abs(), b.abs()
    idx_inf = torch.isposinf(x1) | torch.isposinf(x2)
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    q = lo / safe
    x = torch.where(hi == 0, hi, hi * torch.sqrt(1 + q * q))
    return torch.where(idx_inf, _full(x, math.inf), x)


def _gcd(a, b):  # jnp.gcd's loop, every row until all remainders are 0
    x1, x2 = a.abs(), b.abs()
    while bool((x2 != 0).any()):
        nz = x2 != 0
        safe = torch.where(nz, x2, torch.ones_like(x2))
        x1, x2 = torch.where(nz, x2, x1), torch.where(nz, _int_rem(x1, safe), torch.zeros_like(x2))
        swap = x1 < x2
        x1, x2 = torch.where(swap, x2, x1), torch.where(swap, x1, x2)
    return x1


def _lcm(a, b):
    d = _gcd(a, b)
    safe = torch.where(d == 0, torch.ones_like(d), d)
    return torch.where(d == 0, torch.zeros_like(d), (a * _floordiv(b, safe)).abs())


_FACT = [math.factorial(i) for i in range(21)]


def _factorial(n):
    bad = (n < 0) | (n > 20)
    table = torch.tensor(_FACT, dtype=torch.int64, device=n.device)
    return table[n.clamp(0, 20)], bad


def _shl(v, n):
    oob = (n < 0) | (n >= 64)
    return torch.where(oob, torch.zeros_like(v), v << torch.where(oob, torch.zeros_like(n), n))


def _shr(v, n):
    oob = (n < 0) | (n >= 64)
    fill = torch.where(v < 0, _full(v, -1), torch.zeros_like(v))
    return torch.where(oob, fill, v >> torch.where(oob, torch.zeros_like(n), n))


def _guard(bad_fn, fn, safe_val):
    def run(f):
        bad = bad_fn(f)
        return fn(torch.where(bad, _full(f, safe_val), f)), bad
    return run


# MATH1: float64 -> float64, (value, extra NULL lane or None); the order
# is the function numbering of csrc/expr_vm.cuh (vm_math1, vm_math2)
MATH1 = {
    "sqrt": _guard(lambda f: f < 0, torch.sqrt, 0.0),
    "exp": lambda f: (torch.exp(f), None),
    "ln": _guard(lambda f: f <= 0, torch.log, 1.0),
    "log10": _guard(lambda f: f <= 0, lambda f: torch.log(f) / _LN10, 1.0),
    "cbrt": lambda f: (_cbrt(f), None),
    "log2": lambda f: (torch.log(f) / _LN2, f <= 0),
    "sin": lambda f: (torch.sin(f), None),
    "cos": lambda f: (torch.cos(f), None),
    "tan": lambda f: (torch.tan(f), None),
    "cot": lambda f: (torch.cos(f) / torch.sin(f), None),
    "asin": lambda f: (torch.asin(f), f.abs() > 1),
    "acos": lambda f: (torch.acos(f), f.abs() > 1),
    "atan": lambda f: (torch.atan(f), None),
    "sinh": lambda f: (torch.sinh(f), None),
    "cosh": lambda f: (torch.cosh(f), None),
    "tanh": lambda f: (torch.tanh(f), None),
    "asinh": lambda f: (torch.asinh(f), None),
    "acosh": _guard(lambda f: f < 1, torch.acosh, 1.0),
    # XLA computes atanh as 0.5 * log1p(x) - 0.5 * log1p(-x)
    "atanh": _guard(lambda f: f.abs() >= 1,
                    lambda f: 0.5 * torch.log1p(f) - 0.5 * torch.log1p(-f), 0.0),
    "degrees": lambda f: (f * (180 / np.pi), None),
    "radians": lambda f: (f * (np.pi / 180), None),
}
MATH2 = {
    "pow": lambda a, b: (torch.pow(a, b), None),
    "atan2": lambda a, b: (torch.atan2(a, b), None),
    "hypot": lambda a, b: (_hypot(a, b), None),
    "log": lambda b, x: (torch.log(x) / torch.log(b), (x <= 0) | (b <= 0) | (b == 1)),
}
_MS_DAY, _MS_HOUR, _MS_MIN, _MS_SEC = 86_400_000, 3_600_000, 60_000, 1_000
EXTRACT_FIELDS = ("epoch", "millisecond", "second", "minute", "hour", "day", "month", "year",
                  "dow", "doy")
TRUNC_FIELDS = ("second", "minute", "hour", "day", "week", "month", "year")


def _fdiv(a, k: int):
    return torch.div(a, k, rounding_mode="floor")


def civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day), the reference's
    integer civil-calendar algorithm (``functions.py:330``)."""
    z = days + 719_468
    era = _fdiv(torch.where(z >= 0, z, z - 146_096), 146_097)
    doe = z - era * 146_097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36_524) - _fdiv(doe, 146_096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def days_from_civil(y, m, d):
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146_097 + doe - 719_468


def extract_field(field: str, ts: torch.Tensor) -> torch.Tensor:
    if field not in EXTRACT_FIELDS:
        raise ValueError(f"unknown EXTRACT field {field!r}")
    ts = ts.to(torch.int64)
    days = _fdiv(ts, _MS_DAY)
    ms_of_day = ts - days * _MS_DAY
    if field == "epoch":
        return _fdiv(ts, _MS_SEC)
    if field == "millisecond":
        return torch.remainder(ms_of_day, _MS_SEC)
    if field == "second":
        return torch.remainder(_fdiv(ms_of_day, _MS_SEC), 60)
    if field == "minute":
        return torch.remainder(_fdiv(ms_of_day, _MS_MIN), 60)
    if field == "hour":
        return _fdiv(ms_of_day, _MS_HOUR)
    if field == "dow":
        return torch.remainder(days + 4, 7)
    y, m, d = civil_from_days(days)
    if field == "year":
        return y
    if field == "month":
        return m
    if field == "day":
        return d
    return days - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1


def date_trunc_field(field: str, ts: torch.Tensor) -> torch.Tensor:
    if field not in TRUNC_FIELDS:
        raise ValueError(f"unknown date_trunc field {field!r}")
    ts = ts.to(torch.int64)
    unit = {"second": _MS_SEC, "minute": _MS_MIN, "hour": _MS_HOUR, "day": _MS_DAY}.get(field)
    if unit is not None:
        return _fdiv(ts, unit) * unit
    days = _fdiv(ts, _MS_DAY)
    if field == "week":
        return (days - torch.remainder(days + 3, 7)) * _MS_DAY
    y, m, d = civil_from_days(days)
    one = torch.ones_like(d)
    return days_from_civil(y, m if field == "month" else one, one) * _MS_DAY


def _pow10(d: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return torch.pow(torch.tensor(10.0, dtype=dt, device=d.device), d.to(dt))


@dataclass(frozen=True)
class OpDef:
    """One opcode: its number in ``csrc/expr_vm.cuh`` and its semantics
    on whole lanes. A strict op's ``fn(dt, attr, *values)`` returns
    ``(value, extra NULL lane or None)`` and its NULL lane is the OR of
    its operands' and the extra one; a non-strict op's ``fn(dt, attr,
    *(value, null-or-None))`` returns ``(value, null-or-None)``."""

    code: int
    strict: bool
    fn: Optional[Callable]
    extra_null: bool = False  # a strict op that adds NULLs of its own


def _strict(code, fn, extra=False):
    return OpDef(code, True, fn, extra)


def _and3(dt, attr, l, r):
    (lv, ln), (rv, rn) = l, r
    val = lv & rv
    if ln is None and rn is None:
        return val, None
    ldf = ~lv & ~(ln if ln is not None else torch.zeros_like(lv))
    rdf = ~rv & ~(rn if rn is not None else torch.zeros_like(rv))
    nulls = _null_or(ln, rn) & ~ldf & ~rdf
    return val & ~nulls, nulls


def _or3(dt, attr, l, r):
    (lv, ln), (rv, rn) = l, r
    val = lv | rv
    if ln is None and rn is None:
        return val, None
    ldt = lv & ~(ln if ln is not None else torch.zeros_like(lv))
    rdt = rv & ~(rn if rn is not None else torch.zeros_like(rv))
    nulls = _null_or(ln, rn) & ~ldt & ~rdt
    return (val | ldt | rdt) & ~nulls, nulls


def _isnull(dt, attr, x):
    v, n = x
    isnull = n if n is not None else torch.zeros(v.shape, dtype=torch.bool, device=v.device)
    return (~isnull if attr[0] else isnull), None


def _select(dt, attr, c, a, b):
    (cv, cn), (av, an), (bv, bn) = c, a, b
    if cn is not None:
        cv = cv & ~cn  # a NULL condition does not fire its branch
    val = torch.where(cv, av, bv)
    if an is None and bn is None:
        return val, None
    base = bn if bn is not None else torch.zeros_like(cv)
    branch = an if an is not None else torch.zeros_like(cv)
    return val, torch.where(cv, branch, base)


def _coalesce2(dt, attr, a, b):
    (av, an), (bv, bn) = a, b
    return torch.where(an, bv, av), (an & bn if bn is not None else torch.zeros_like(an))


def _nullif(dt, attr, a, eq):
    (av, an), (ev, en) = a, eq
    if en is not None:
        ev = ev & ~en  # NULL never equals
    return av, _null_or(an, ev)


def _null_or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


# opcode numbers are csrc/expr_vm.cuh's VmOp; COL, LIT, NULL_LIT,
# PARAM_I, PARAM_F and GATHER are run by the tracers themselves
OPS: Dict[str, OpDef] = {
    "col": OpDef(1, True, None),
    "lit": OpDef(2, True, None),
    "null_lit": OpDef(3, False, None),
    "param_i": OpDef(4, True, None),
    "param_f": OpDef(5, True, None),
    "cast": _strict(6, lambda dt, attr, v: (_cast(v, dt), None)),
    "guardz": _strict(7, lambda dt, attr, v: (torch.where(v == 0, _full(v, 1), v), v == 0), True),
    "add": _strict(8, lambda dt, attr, a, b: (a + b, None)),
    "sub": _strict(9, lambda dt, attr, a, b: (a - b, None)),
    "mul": _strict(10, lambda dt, attr, a, b: (a * b, None)),
    "floordiv": _strict(11, lambda dt, attr, a, b: (_floordiv(a, b), None)),
    "truediv": _strict(12, lambda dt, attr, a, b: (a / b, None)),
    "rem": _strict(13, lambda dt, attr, a, b: (_remainder(a, b), None)),
    "eq": _strict(14, lambda dt, attr, a, b: (a == b, None)),
    "ne": _strict(15, lambda dt, attr, a, b: (a != b, None)),
    "lt": _strict(16, lambda dt, attr, a, b: (a < b, None)),
    "le": _strict(17, lambda dt, attr, a, b: (a <= b, None)),
    "gt": _strict(18, lambda dt, attr, a, b: (a > b, None)),
    "ge": _strict(19, lambda dt, attr, a, b: (a >= b, None)),
    "band": _strict(20, lambda dt, attr, a, b: (a & b, None)),
    "bor": _strict(21, lambda dt, attr, a, b: (a | b, None)),
    "not": _strict(22, lambda dt, attr, a: (~a, None)),
    "and3": OpDef(23, False, _and3),
    "or3": OpDef(24, False, _or3),
    "isnull": OpDef(25, False, _isnull),
    "select": OpDef(26, False, _select),
    "coalesce2": OpDef(27, False, _coalesce2),
    "nullif": OpDef(28, False, _nullif),
    "notnull": OpDef(29, False, lambda dt, attr, a: (a[0], None)),
    "false": _strict(30, lambda dt, attr, a: (torch.zeros(a.shape, dtype=torch.bool,
                                                          device=a.device), None)),
    "abs": _strict(31, lambda dt, attr, a: (a.abs(), None)),
    "sign": _strict(32, lambda dt, attr, a: (_sgn(a), None)),
    "ceil": _strict(33, lambda dt, attr, a: (torch.ceil(a), None)),
    "floor": _strict(34, lambda dt, attr, a: (torch.floor(a), None)),
    "round": _strict(35, lambda dt, attr, a: (torch.round(a), None)),
    "trunc": _strict(36, lambda dt, attr, a: (torch.trunc(a), None)),
    "pow10": _strict(37, lambda dt, attr, d: (_pow10(d, dt), None)),
    "math1": _strict(38, lambda dt, attr, f: MATH1[attr[2]](f), True),
    "math2": _strict(39, lambda dt, attr, a, b: MATH2[attr[2]](a, b), True),
    "factorial": _strict(40, lambda dt, attr, n: _factorial(n), True),
    "gcd": _strict(41, lambda dt, attr, a, b: (_gcd(a, b), None)),
    "lcm": _strict(42, lambda dt, attr, a, b: (_lcm(a, b), None)),
    "bitand": _strict(43, lambda dt, attr, a, b: (a & b, None)),
    "bitor": _strict(44, lambda dt, attr, a, b: (a | b, None)),
    "bitxor": _strict(45, lambda dt, attr, a, b: (a ^ b, None)),
    "bitnot": _strict(46, lambda dt, attr, a: (~a, None)),
    "shl": _strict(47, lambda dt, attr, a, b: (_shl(a, b), None)),
    "shr": _strict(48, lambda dt, attr, a, b: (_shr(a, b), None)),
    "max": _strict(49, lambda dt, attr, a, b: (torch.maximum(a, b), None)),
    "min": _strict(50, lambda dt, attr, a, b: (torch.minimum(a, b), None)),
    "extract": _strict(51, lambda dt, attr, a: (extract_field(attr[2], a), None)),
    "datetrunc": _strict(52, lambda dt, attr, a: (date_trunc_field(attr[2], a), None)),
    "gather": OpDef(53, True, None),
    "first": _strict(55, lambda dt, attr, a, b: (a, None)),
}
_MATH1_CODE = {n: i for i, n in enumerate(MATH1)}
_MATH2_CODE = {n: i for i, n in enumerate(MATH2)}
_EXTRA_NULL_MATH1 = frozenset({"sqrt", "ln", "log10", "log2", "asin", "acos", "acosh", "atanh"})


def op_adds_nulls(name: str, attr) -> bool:
    """Whether a strict op's result may be NULL where no operand is (the
    reference's ``extra`` lane is not None)."""
    if name == "math1":
        return attr[2] in _EXTRA_NULL_MATH1
    if name == "math2":
        return attr[2] == "log"
    return OPS[name].extra_null


def attr_codes(name: str, attr) -> Tuple[int, int]:
    """The two int32 attribute words an instruction carries."""
    a0, a1, sym = attr
    if name == "cast":  # the source dtype
        return _code(sym), 0
    if name == "math1":
        return _MATH1_CODE[sym], 0
    if name == "math2":
        return _MATH2_CODE[sym], 0
    if name == "extract":
        return EXTRACT_FIELDS.index(sym), 0
    if name == "datetrunc":
        return TRUNC_FIELDS.index(sym), 0
    return a0, a1


# ---------------------------------------------------------------------------
# the tracers
# ---------------------------------------------------------------------------


class TVal:
    """A traced value of the plain version: lanes and a static type."""

    __slots__ = ("v", "n", "dtype", "weak")

    def __init__(self, v, n, dtype, weak):
        self.v, self.n, self.dtype, self.weak = v, n, dtype, weak

    @property
    def nullable(self) -> bool:
        return self.n is not None

    def retag(self, weak: bool) -> "TVal":
        return TVal(self.v, self.n, self.dtype, weak)


class TorchTracer:
    """Runs each traced operation at once on whole lanes (the tree
    walk). Lanes may be stacked (n_chunks, C): every op is elementwise."""

    def __init__(self, chunk, params=None):
        self.chunk = chunk
        self.shape = chunk.valid.shape
        self.device = chunk.valid.device
        self.params = params

    def col(self, name):
        v = self.chunk.col(name)
        return TVal(v, self.chunk.nulls.get(name), v.dtype, False)

    def const(self, value, dtype, weak):
        return TVal(torch.full(self.shape, value, dtype=dtype, device=self.device), None,
                    dtype, weak)

    def null_const(self):
        return TVal(torch.zeros(self.shape, dtype=torch.int32, device=self.device),
                    torch.ones(self.shape, dtype=torch.bool, device=self.device),
                    torch.int32, False)

    def param(self, lane: str, slot: int):
        if self.params is None:
            raise RuntimeError("LiftedLit evaluated outside a param_scope (lifted plans only run "
                               "inside the fused barrier program)")
        p = self.params[lane]
        v = p[slot:slot + 1].to(self.device).expand(self.shape).contiguous()
        return TVal(v, None, v.dtype, False)

    def gather(self, v: TVal, table: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(table)).to(self.device)
        safe = v.v.clamp(0, t.shape[0] - 1).to(torch.int64)
        return TVal(t[safe], v.n, t.dtype, False)

    def op(self, name: str, args: Sequence[TVal], dt: torch.dtype, out=None, weak=False,
           attr=(0, 0, None)):
        d = OPS[name]
        if d.strict:
            val, extra = d.fn(dt, attr, *[a.v for a in args])
            n = None
            for a in args:
                n = _null_or(n, a.n)
            n = _null_or(n, extra)
        else:
            val, n = d.fn(dt, attr, *[(a.v, a.n) for a in args])
        return TVal(val, n, out or dt, weak)


class CVal:
    """A traced value of the compiler: an SSA number and a static type."""

    __slots__ = ("id", "dtype", "weak", "nullable")

    def __init__(self, id_, dtype, weak, nullable):
        self.id, self.dtype, self.weak, self.nullable = id_, dtype, weak, nullable

    def retag(self, weak: bool) -> "CVal":
        return CVal(self.id, self.dtype, weak, self.nullable)


# lane dtypes the kernel takes (csrc/common.cuh RwDType)
KERNEL_DTYPES = dict(_kernels.DTYPE_CODES)


def _code(dtype: torch.dtype) -> int:
    """A dtype's kernel code; 7 marks one the kernel cannot take (the
    program then refuses to run on the card)."""
    return KERNEL_DTYPES.get(dtype, 7)


def _rep(value, dtype: torch.dtype) -> int:
    """A literal as the kernel's 64-bit register word: ints and bools
    sign-extended, floats (float32 ones too) as float64 bits."""
    if dtype.is_floating_point:
        x = float(np.asarray(value).astype(D_NP[dtype]))
        return struct.unpack("<q", struct.pack("<d", x))[0]
    return int(np.asarray(value).astype(np.int64))


D_NP = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


class Compiler:
    """Records traced operations as SSA instructions over a chunk
    signature ``{column: (dtype, nullable)}``."""

    def __init__(self, signature: Dict[str, Tuple[torch.dtype, bool]]):
        self.signature = signature
        self.insns: List[list] = []  # [name, dt, out, dst, srcs, attr]
        self.vals: List[CVal] = []
        self.inputs: Dict[str, int] = {}
        self.col_vals: Dict[str, CVal] = {}
        self.lits: List[int] = []
        self.lit_index: Dict[tuple, int] = {}
        self.uses_params = False

    def _emit(self, name, dt, out, srcs, attr, weak, nullable) -> CVal:
        v = CVal(len(self.vals), out, weak, nullable)
        self.vals.append(v)
        self.insns.append([name, dt, out, v.id, [s.id for s in srcs], attr])
        return v

    def col(self, name):
        if name in self.col_vals:
            return self.col_vals[name]
        dtype, nullable = self.signature[name]
        idx = self.inputs.setdefault(name, len(self.inputs))
        v = self._emit("col", dtype, dtype, [], (idx, 0, None), False, nullable)
        self.col_vals[name] = v
        return v

    def _pool(self, words: Tuple[int, ...]) -> int:
        base = self.lit_index.get(words)
        if base is None:
            base = len(self.lits)
            self.lits.extend(words)
            self.lit_index[words] = base
        return base

    def const(self, value, dtype, weak):
        base = self._pool((_rep(value, dtype),))
        return self._emit("lit", dtype, dtype, [], (base, 0, None), weak, False)

    def null_const(self):
        return self._emit("null_lit", torch.int32, torch.int32, [], (0, 0, None), False, True)

    def param(self, lane: str, slot: int):
        self.uses_params = True
        dtype = torch.int64 if lane == "i" else torch.float64
        return self._emit("param_" + lane, dtype, dtype, [], (slot, 0, None), False, False)

    def gather(self, v: CVal, table: np.ndarray):
        dtype = D.torch_dtype(table.dtype)
        base = self._pool(tuple(_rep(x, dtype) for x in table.tolist()))
        return self._emit("gather", v.dtype, dtype, [v], (base, len(table), None), False,
                          v.nullable)

    def op(self, name, args, dt, out=None, weak=False, attr=(0, 0, None)):
        d = OPS[name]
        if d.strict:
            nullable = any(a.nullable for a in args) or op_adds_nulls(name, attr)
        elif name in ("and3", "or3"):
            nullable = args[0].nullable or args[1].nullable
        elif name == "select":
            nullable = args[1].nullable or args[2].nullable
        elif name == "coalesce2":
            nullable = True  # an all-False lane once the first operand had one
        elif name == "nullif":
            nullable = True
        else:  # isnull, notnull
            nullable = False
        return self._emit(name, dt, out or dt, args, attr, weak, nullable)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

VM_MAX_INSN = 128
VM_MAX_REGS = 32
VM_MAX_IN = 16
VM_MAX_OUT = 16
VM_MAX_LITS = 128


@dataclass(frozen=True)
class Program:
    """A compiled expression program. ``insns`` rows are ``(name, dt,
    out, dst, srcs, attr)`` over physical registers; ``outputs`` are
    ``(name, dtype, nullable, reg)`` for a projection, ``keep`` the
    register of a filter's predicate."""

    insns: tuple
    n_regs: int
    inputs: tuple  # (column, dtype, nullable)
    outputs: tuple
    keep: Optional[int]
    lits: tuple
    uses_params: bool

    @cached_property
    def static_words(self) -> tuple:
        """The kernel descriptor's header and instruction words (the
        lanes' pointers are the only words a call changes); raises
        ``NotImplementedError`` for a program kernel S cannot run."""
        problem = self.kernel_problem()
        if problem is not None:
            raise NotImplementedError(f"kernel S cannot run this expression: {problem}")
        words = [len(self.insns), len(self.inputs), len(self.outputs), len(self.lits),
                 -1 if self.keep is None else self.keep]
        for name, dt, out, dst, srcs, attr in self.insns:
            regs = list(srcs) + [0] * (3 - len(srcs))
            a0, a1 = attr_codes(name, attr)
            words += [OPS[name].code | _code(dt) << 8 | _code(out) << 12,
                      dst | regs[0] << 8 | regs[1] << 16 | regs[2] << 24, a0, a1]
        return tuple(words)

    def kernel_problem(self) -> Optional[str]:
        """Why kernel S cannot run this program, or None."""
        if len(self.insns) > VM_MAX_INSN:
            return f"{len(self.insns)} instructions exceed {VM_MAX_INSN}"
        if self.n_regs > VM_MAX_REGS:
            return f"{self.n_regs} registers exceed {VM_MAX_REGS}"
        if len(self.inputs) > VM_MAX_IN or len(self.outputs) > VM_MAX_OUT:
            return "too many input or output lanes"
        if len(self.lits) > VM_MAX_LITS:
            return f"{len(self.lits)} literal words exceed {VM_MAX_LITS}"
        for ins in self.insns:
            if _code(ins[1]) == 7 or _code(ins[2]) == 7:
                return f"dtype {ins[1]} / {ins[2]} of {ins[0]!r}"
        return None


def _allocate(c: Compiler, keep_vals: Sequence[CVal]) -> Tuple[list, int, dict]:
    """Linear-scan register allocation over the SSA instructions; a
    value's register frees after its last use (a destination may reuse
    an operand's register: the kernel reads operands first)."""
    last = {}
    for i, ins in enumerate(c.insns):
        for s in ins[4]:
            last[s] = i
    end = len(c.insns)
    for v in keep_vals:
        last[v.id] = end
    free = list(range(VM_MAX_REGS * 4))
    phys, out, n_regs = {}, [], 0
    for i, (name, dt, odt, dst, srcs, attr) in enumerate(c.insns):
        regs = [phys[s] for s in srcs]
        for s in set(srcs):
            if last.get(s) == i:
                free.append(phys[s])
        free.sort()
        r = free.pop(0)
        phys[dst] = r
        n_regs = max(n_regs, r + 1)
        if dst not in last:
            free.append(r)
        out.append((name, dt, odt, r, tuple(regs), attr))
    return out, n_regs, phys


def compile_program(exprs: Sequence[Tuple[str, object]], signature, filter_: bool) -> Program:
    """Trace ``exprs`` (``(name, Expr)`` pairs; one pair, the predicate,
    for a filter) over ``signature`` into a ``Program``."""
    c = Compiler(signature)
    results = []
    for name, e in exprs:
        v = e._build(c)
        if filter_:
            from risingwave_tpu_torch.expr.expr import to_bool

            v = to_bool(c, v)
        results.append((name, v))
    insns, n_regs, phys = _allocate(c, [v for _, v in results])
    inputs = tuple((n, *signature[n]) for n in sorted(c.inputs, key=c.inputs.get))
    if filter_:
        outputs, keep = (), phys[results[0][1].id]
    else:
        outputs = tuple((n, v.dtype, v.nullable, phys[v.id]) for n, v in results)
        keep = None
    return Program(tuple(insns), n_regs, inputs, outputs, keep, tuple(c.lits), c.uses_params)


def output_types(exprs, signature) -> Dict[str, Tuple[torch.dtype, bool]]:
    """``{name: (dtype, nullable)}`` of a projection over an input
    signature ``{column: (dtype, nullable)}``, traced, not run."""
    c = Compiler(signature)
    return {n: (v.dtype, v.nullable) for n, v in ((n, e._build(c)) for n, e in exprs)}


_PROGRAMS: Dict[tuple, Program] = {}
_STATS = {"hits": 0, "compiled": 0}
_PROGRAMS_LOCK = threading.Lock()  # parallel actors compile and count at once


def cache_stats() -> dict:
    """Programs compiled by this process, and how often a compiled one
    was reused (a lifted plan's parameter variants share one)."""
    return {"programs": len(_PROGRAMS), "compiled": _STATS["compiled"], "hits": _STATS["hits"]}


def chunk_signature_of(chunk, names) -> Dict[str, Tuple[torch.dtype, bool]]:
    return {n: (chunk.col(n).dtype, n in chunk.nulls) for n in names}


def program_for(exprs, chunk, filter_: bool, tree=None) -> Program:
    """The cached program of ``exprs`` over this chunk's signature.
    ``tree``, the ``StaticTree`` of ``tuple(exprs)`` where the caller
    holds one, saves re-keying the tree on every call."""
    from risingwave_tpu_torch.expr.expr import StaticTree

    if tree is None:
        tree = StaticTree(tuple(exprs))
    cols = tree.columns()
    sig = tuple((n, chunk.col(n).dtype, n in chunk.nulls) for n in cols)
    key = (filter_, tree.key, sig)
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = compile_program(exprs, {n: (d, nb) for n, d, nb in sig}, filter_)
            _PROGRAMS[key] = prog
            _STATS["compiled"] += 1
        else:
            _STATS["hits"] += 1
    return prog


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _current_params():
    from risingwave_tpu_torch.expr.expr import current_params

    return current_params()


def project_torch(chunk, outputs) -> Tuple[dict, dict]:
    """The tree walk of every ``(name, Expr)``: ``(columns, nulls)``."""
    b = TorchTracer(chunk, _current_params())
    cols, nulls = {}, {}
    for name, e in outputs:
        v = e._build(b)
        cols[name] = v.v
        if v.n is not None:
            nulls[name] = v.n
    return cols, nulls


def torn_pair_ops(valid: torch.Tensor, ops: torch.Tensor, fix_insert: bool = True):
    """Downgrade torn U-/U+ halves (filter.py:33-46): a surviving U-
    whose next row is not a surviving U+ becomes a Delete, a surviving
    U+ whose previous row is not a surviving U- an Insert (with
    ``fix_insert``). Rows wrap around each chunk as ``jnp.roll`` does;
    stacked lanes roll along their last axis."""
    is_ud = ops == Op.UPDATE_DELETE
    is_ui = ops == Op.UPDATE_INSERT
    alive_next = torch.roll(valid, -1, -1) & torch.roll(is_ui, -1, -1)
    new_ops = torch.where(is_ud & valid & ~alive_next, _full(ops, int(Op.DELETE)), ops)
    if fix_insert:
        alive_prev = torch.roll(valid, 1, -1) & torch.roll(is_ud, 1, -1)
        new_ops = torch.where(is_ui & valid & ~alive_prev, _full(ops, int(Op.INSERT)), new_ops)
    return new_ops


def filter_torch(chunk, pred):
    """``_filter_step`` on lanes: ``(valid, ops)`` after the predicate and
    the torn-pair rewrite."""
    b = TorchTracer(chunk, _current_params())
    from risingwave_tpu_torch.expr.expr import to_bool

    keep = to_bool(b, pred._build(b))
    k = keep.v if keep.n is None else keep.v & ~keep.n  # NULL drops the row
    valid = chunk.valid & k
    return valid, torn_pair_ops(valid, chunk.ops)


def run_program_torch(prog: Program, chunk, params=None):
    """Interpret a compiled program on whole lanes with the opcode
    semantics of ``OPS`` (the compiler's check without a card). Returns
    ``(columns, nulls)`` for a projection, the keep lane for a filter."""
    b = TorchTracer(chunk, params)
    regs: List[Optional[TVal]] = [None] * max(1, prog.n_regs)
    in_names = [n for n, _, _ in prog.inputs]
    cols, nulls = {}, {}
    for name, dt, out, dst, srcs, attr in prog.insns:
        args = [regs[s] for s in srcs]
        if name == "col":
            val = b.col(in_names[attr[0]])
        elif name == "lit":
            word = prog.lits[attr[0]]
            val = b.const(_unrep(word, dt), dt, False)
        elif name == "null_lit":
            val = b.null_const()
        elif name in ("param_i", "param_f"):
            val = b.param(name[-1], attr[0])
        elif name == "gather":
            table = np.asarray([_unrep(w, out) for w in prog.lits[attr[0]:attr[0] + attr[1]]],
                               dtype=torch.empty(0, dtype=out).numpy().dtype)
            val = b.gather(args[0], table)
        else:
            val = b.op(name, args, dt, out, False, attr)
        regs[dst] = val
    if prog.keep is not None:
        keep = regs[prog.keep]
        return keep.v if keep.n is None else keep.v & ~keep.n
    for name, dtype, nullable, reg in prog.outputs:
        cols[name] = regs[reg].v
        if nullable:
            nulls[name] = regs[reg].n
    return cols, nulls


def _unrep(word: int, dtype: torch.dtype):
    if dtype.is_floating_point:
        return struct.unpack("<d", struct.pack("<q", word))[0]
    if dtype == torch.bool:
        return bool(word)
    return int(word)


# ---------------------------------------------------------------------------
# kernel S on the card
# ---------------------------------------------------------------------------

# instruction word 0: op | dt << 8 | out << 12; word 1: dst | a << 8 |
# b << 16 | c << 24; words 2, 3: the attributes (csrc/expr_vm.cuh)


def pack_program(prog: Program, in_lanes, out_lanes):
    """The flat int64 descriptor ``rw_project``/``rw_filter`` copy into
    the kernel's by-value program: a header (instructions, inputs,
    outputs, literals, keep register), the instructions, the input
    lanes (value, null, dtype), the output lanes (value, null, dtype |
    register << 8), the literal pool."""
    words = list(prog.static_words)
    if len(out_lanes) != len(prog.outputs):
        raise ValueError("expr_eval: one output lane per program output")
    for v, n in in_lanes:
        words += [v.data_ptr(), 0 if n is None else n.data_ptr(), _code(v.dtype)]
    for (v, n), (_, _, _, reg) in zip(out_lanes, prog.outputs):
        words += [v.data_ptr(), 0 if n is None else n.data_ptr(), _code(v.dtype) | reg << 8]
    words += list(prog.lits)
    return (ctypes.c_int64 * len(words))(*words)


def _input_lanes(prog: Program, chunk):
    lanes = []
    for name, dtype, nullable in prog.inputs:
        v = chunk.col(name)
        n = chunk.nulls.get(name) if nullable else None
        lanes.append((v, n))
    return lanes


def _param_ptrs(prog: Program, dev):
    if not prog.uses_params:
        return 0, 0, ()
    params = _current_params()
    if params is None:
        raise RuntimeError("LiftedLit evaluated outside a param_scope (lifted plans only run "
                           "inside the fused barrier program)")
    pi, pf = params["i"], params["f"]
    if pi.dtype != torch.int64 or pf.dtype != torch.float64:
        raise TypeError("lifted parameters must be int64 and float64 lanes")
    _kernels.check_cuda("expr_eval", pi, pf)
    if pi.device != dev or pf.device != dev:
        raise ValueError("expr_eval: parameters must be on the chunk's device")
    return pi.data_ptr(), pf.data_ptr(), (pi, pf)


def _check_lanes(chunk, lanes):
    flat = [chunk.valid] + [t for pair in lanes for t in pair if t is not None]
    _kernels.check_cuda("expr_eval", *flat)
    for t in flat:
        if t.shape != chunk.valid.shape:
            raise ValueError("expr_eval: every lane must have the valid lane's shape")


def _project_cuda(chunk, outputs, tree=None) -> Tuple[dict, dict]:
    from risingwave_tpu_torch.expr.expr import Col, StaticTree

    cols, nulls = {}, {}
    computed = tuple((n, e) for n, e in outputs if not isinstance(e, Col))
    prog = None
    if computed:
        if tree is not None:
            tree = tree.derived("computed", lambda: StaticTree(computed))
        prog = program_for(computed, chunk, False, tree)
    produced = {}
    if prog is not None:
        in_lanes = _input_lanes(prog, chunk)
        _check_lanes(chunk, in_lanes)
        dev, shape = chunk.valid.device, chunk.valid.shape
        out_lanes = []
        for name, dtype, nullable, _ in prog.outputs:
            v = torch.empty(shape, dtype=dtype, device=dev)
            n = torch.empty(shape, dtype=torch.bool, device=dev) if nullable else None
            out_lanes.append((v, n))
            produced[name] = (v, n)
        pi, pf, keep_alive = _param_ptrs(prog, dev)
        desc = pack_program(prog, in_lanes, out_lanes)
        _kernels.call("expr_eval", "rw_project", desc, len(desc), chunk.valid.numel(), pi, pf)
        del keep_alive
    for name, e in outputs:
        if isinstance(e, Col):  # a column passes through as it is
            cols[name] = chunk.col(e.name)
            if e.name in chunk.nulls:
                nulls[name] = chunk.nulls[e.name]
        else:
            v, n = produced[name]
            cols[name] = v
            if n is not None:
                nulls[name] = n
    return cols, nulls


def _filter_cuda(chunk, pred, tree=None):
    from risingwave_tpu_torch.expr.expr import StaticTree

    exprs = (("keep", pred),)
    if tree is not None:
        tree = tree.derived("keep", lambda: StaticTree(exprs))
    prog = program_for(exprs, chunk, True, tree)
    in_lanes = _input_lanes(prog, chunk)
    _check_lanes(chunk, in_lanes + [(chunk.ops, None)])
    if chunk.ops.dtype != torch.int32 or chunk.valid.dtype != torch.bool:
        raise TypeError("filter: ops must be int32 and valid bool lanes")
    cap = chunk.valid.shape[-1]
    n_chunks = chunk.valid.numel() // cap if cap else 0
    valid = torch.empty_like(chunk.valid)
    ops = torch.empty_like(chunk.ops)
    pi, pf, keep_alive = _param_ptrs(prog, chunk.valid.device)
    desc = pack_program(prog, in_lanes, [])
    _kernels.call("expr_eval", "rw_filter", desc, len(desc), n_chunks, cap,
                  chunk.valid.data_ptr(), chunk.ops.data_ptr(), valid.data_ptr(), ops.data_ptr(),
                  pi, pf)
    del keep_alive
    return valid, ops


def project(chunk, outputs, tree=None) -> Tuple[dict, dict]:
    """Evaluate every ``(name, Expr)`` of a projection over the chunk:
    ``(columns, nulls)``. CPU tensors take the tree walk; CUDA tensors
    kernel S's ``rw_project`` (one launch for every computed output).
    ``tree``: the outputs' ``StaticTree``, where the caller holds one."""
    dev = chunk.valid.device.type
    if dev == "cpu":
        return project_torch(chunk, outputs)
    if dev == "cuda":
        return _project_cuda(chunk, outputs, tree)
    raise ValueError(f"unsupported device {chunk.valid.device}")


def filter_chunk(chunk, pred, tree=None):
    """The filter step's ``(valid, ops)``: CPU tensors take the plain
    version, CUDA tensors kernel S's ``rw_filter`` (predicate, mask and
    torn-pair rewrite in one launch). ``tree``: the predicate's
    ``StaticTree``, where the caller holds one."""
    dev = chunk.valid.device.type
    if dev == "cpu":
        return filter_torch(chunk, pred)
    if dev == "cuda":
        return _filter_cuda(chunk, pred, tree)
    raise ValueError(f"unsupported device {chunk.valid.device}")
