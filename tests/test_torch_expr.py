"""Kernel S's expression layer: the port's plain PyTorch tree walk
(``risingwave_tpu_torch/expr``) against ``risingwave_tpu.expr`` on
JAX-CPU, node by node and function by function, on the same seeded
NULL-bearing lanes; the compiled program's plain interpreter against
the tree walk; literal lifting and structural keys.

Tolerance: none (dtypes, NULL lanes and values bit for bit, NaN equal to
NaN), except for the transcendental functions (every ``expr_vm.MATH1``
function but degrees and radians, every ``MATH2`` one, and round/trunc
of a float to a digit count, whose 10 ** digits is a ``pow``):
libm, PyTorch and XLA each approximate those their own way, so a value
may differ by ``ULPS`` units in the last place of max(|value|, 1).
XLA's float64 atanh, 0.5 * log1p(x) - 0.5 * log1p(-x) with XLA's own
log1p, is up to 115 ulp off near |x| = 0.4, so atanh has ``ATANH_ULPS``.
PyTorch's CPU sqrt is 1 ulp off correct rounding on some inputs, so
sqrt is in the set too.)
"""

import types

import numpy as np
import pytest
import torch

import risingwave_tpu.expr.expr as RE
import risingwave_tpu.expr.functions as RF
from risingwave_tpu.array.chunk import DataChunk as RefChunk
from risingwave_tpu.array.dictionary import StringDictionary as RefDict
from risingwave_tpu_torch.array.chunk import DataChunk, StreamChunk
from risingwave_tpu_torch.array.dictionary import StringDictionary
from risingwave_tpu_torch.expr import expr as PE
from risingwave_tpu_torch.expr import functions as PF
from risingwave_tpu_torch.ops import expr_vm

ULPS = 4
ATANH_ULPS = 128
CAP = 256
N = 240
CHANNELS = ("Google", "Facebook", "Baidu", "Apple")


def _ns(E, F, dictionary):
    return types.SimpleNamespace(
        col=E.col, lit=E.lit, BinOp=E.BinOp, Cast=E.Cast, And=E.And, Or=E.Or, Not=E.Not,
        IsNull=E.IsNull, Between=E.Between, InList=E.InList, Case=E.Case,
        TumbleStart=E.TumbleStart, AssumeNotNull=E.AssumeNotNull, Func=F.Func,
        Extract=F.Extract, DateTrunc=F.DateTrunc, Coalesce=F.Coalesce, NullIf=F.NullIf,
        StringFunc=F.StringFunc, dictionary=dictionary,
    )


def _lanes(seed=7):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1000, 1000, N).astype(np.int64)
    a[:4] = [0, 1, -1, 7]
    b = rng.integers(-6, 7, N).astype(np.int32)  # zeros: division by zero
    c = rng.integers(-10**6, 10**6, N).astype(np.int64)
    f = (rng.standard_normal(N) * 3).round(2)
    f[:6] = [0.0, -0.0, 1.0, -2.5, 2.5, 0.5]
    g = (rng.standard_normal(N) * 2).astype(np.float32)
    g[:3] = [0.0, 1.5, -1.5]
    p = rng.random(N) < 0.5
    # timestamps 1900..2100 in ms, some on day boundaries
    ts = rng.integers(-2_208_988_800_000, 4_102_444_800_000, N).astype(np.int64)
    ts[:3] = [0, -1, 86_400_000 * 365]
    ch = rng.integers(0, len(CHANNELS), N).astype(np.int32)
    cols = {"a": a, "b": b, "c": c, "f": f, "g": g, "p": p, "ts": ts, "ch": ch}
    nulls = {n: rng.random(N) < 0.2 for n in ("a", "b", "f", "p")}
    return cols, nulls


def _battery(ns):
    """(name, tree, transcendental) over the lanes of ``_lanes``."""
    col, lit, B, Fn = ns.col, ns.lit, ns.BinOp, ns.Func
    a, b, c, f, g, p, ts = (col(n) for n in ("a", "b", "c", "f", "g", "p", "ts"))
    out = [
        # arithmetic on each dtype, with weak literals
        ("a+b", a + b, False), ("b+5", b + 5, False), ("b*3", b * 3, False),
        ("a-c", a - c, False), ("f*g", f * g, False), ("g*0.5", g * 0.5, False),
        ("f+1", f + 1, False), ("a*0.908", a * 0.908, False), ("0.908*a", lit(0.908) * a, False),
        ("b-b", b - b, False), ("p+p", p + p, False), ("p*p", p * p, False),
        ("b*b*b*b*b*b", b * b * b * b * b * b * b * b * b * b * b * b, False),
        ("c*c*c", c * c * c * c, False),
        # division family, zero divisors give NULL
        ("a//b", a // b, False), ("a%b", a % b, False), ("b//2", b // 2, False),
        ("a/b", B("/", a, b), False), ("b/b", B("/", b, b), False), ("c/a", B("/", c, a), False),
        ("f//g", f // g, False), ("f%g", f % g, False), ("g//2.5", g // 2.5, False),
        ("f/f", B("/", f, f), False), ("a//0", a // 0, False), ("g%b", g % b, False),
        ("c%a", c % a, False), ("p//p", B("//", p, p), False),
        # comparisons
        ("a<b", a < b, False), ("f>=g", f >= g, False), ("b==3", b == 3, False),
        ("f!=f", f != f, False), ("g>0.5", g > 0.5, False), ("a<=c", a <= c, False),
        # three-valued logic
        ("and", (a > 0) & (b < 0), False), ("or", (a > 0) | (b < 0), False),
        ("not", ns.Not(p), False), ("and_p", ns.And(p, f > 0), False),
        ("or_p", ns.Or(p, ns.Not(p)), False), ("and_int", ns.And(a, b), False),
        ("and_strict", (c > 0) & (c < 500), False),
        ("isnull", ns.IsNull(b), False), ("notnull", ns.IsNull(b, True), False),
        ("isnull_c", ns.IsNull(c), False), ("isnull_nulllit", ns.IsNull(lit(None)), False),
        ("between", ns.Between(a, b, c), False),
        ("between_f", ns.Between(f, lit(-1.0), lit(1.0)), False),
        ("in", ns.InList(b, (1, 2, 3)), False), ("in_f", ns.InList(f, (0.5, 2)), False),
        ("in_empty", ns.InList(a, ()), False),
        ("case", ns.Case(((a > 0, f), (b < 0, g)), lit(None)), False),
        ("case_b", ns.Case(((p, lit(1)),), b), False),
        ("case_f", ns.Case(((a > 0, lit(2.5)),), lit(1)), False),
        ("case_c", ns.Case(((c > 0, c), (c < -10, lit(3))), c), False),
        ("coalesce", ns.Coalesce((b, a)), False),
        ("coalesce3", ns.Coalesce((f, g, lit(0.0))), False),
        ("coalesce_c", ns.Coalesce((c, a)), False),
        ("nullif", ns.NullIf(a, lit(3)), False), ("nullif_bc", ns.NullIf(b, c), False),
        ("cast_f_i32", ns.Cast(f * 1e9, np.int32), False),
        ("cast_f_i64", ns.Cast(f, np.int64), False),
        ("cast_a_f32", ns.Cast(a, np.float32), False), ("cast_b_bool", ns.Cast(b, np.bool_), False),
        ("cast_f_f32", ns.Cast(f, np.float32), False), ("cast_p_i64", ns.Cast(p, np.int64), False),
        ("cast_nan", ns.Cast(B("/", f, f) * 1e300 * 1e300, np.int64), False),
        ("tumble", ns.TumbleStart(ts, 10_000), False), ("tumble_b", ns.TumbleStart(b, 7), False),
        ("tumble_f", ns.TumbleStart(f, 2), False),
        ("assume", ns.AssumeNotNull(b), False), ("null", lit(None), False),
        ("lit_bool", lit(True), False), ("lit_np", lit(np.int32(4)) + b, False),
    ]
    out += [(f"extract_{fld}", ns.Extract(fld, ts), False) for fld in (
        "epoch", "millisecond", "second", "minute", "hour", "day", "month", "year", "dow", "doy")]
    out += [("extract_b", ns.Extract("hour", b * 1_000_000), False)]
    out += [(f"trunc_{fld}", ns.DateTrunc(fld, ts), False) for fld in (
        "second", "minute", "hour", "day", "week", "month", "year")]
    funcs = [
        ("abs", (a,), False), ("abs", (f,), False), ("sign", (f,), False),
        ("sign", (b,), False), ("ceil", (f,), False), ("floor", (g,), False),
        ("ceil", (a,), False), ("round", (f,), False), ("round", (g,), False),
        ("round", (f, lit(1)), True), ("round", (g, lit(1)), True), ("round", (a, b), False),
        ("round", (f, b), True), ("trunc", (f,), False), ("trunc", (f, lit(1)), True),
        ("mod", (a, b), False), ("mod", (f, g), False), ("mod", (b, lit(3)), False),
        ("pow", (f, lit(2)), True), ("power", (g, b), True), ("sqrt", (f,), True),
        ("exp", (f,), True), ("ln", (f,), True), ("log10", (f,), True), ("cbrt", (f,), True),
        ("log2", (g,), True), ("sin", (f,), True), ("cos", (f,), True), ("tan", (f,), True),
        ("cot", (f,), True), ("asin", (B("/", f, lit(4.0)),), True),
        ("acos", (B("/", f, lit(4.0)),), True), ("atan", (f,), True), ("sinh", (f,), True),
        ("cosh", (f,), True), ("tanh", (f,), True), ("asinh", (f,), True),
        ("acosh", (f,), True), ("atanh", (B("/", f, lit(4.0)),), True),
        ("degrees", (f,), False), ("radians", (a,), False), ("log", (g, f), True),
        ("atan2", (f, g), True), ("hypot", (f, g), True), ("factorial", (b,), False),
        ("factorial", (a,), False), ("gcd", (a, c), False), ("lcm", (a, b), False),
        ("bit_and", (a, c), False), ("bit_or", (a, b), False), ("bit_xor", (c, b), False),
        ("bit_not", (a,), False), ("bit_shift_left", (a, b * 11), False),
        ("bit_shift_right", (c, b * 11), False), ("greatest", (a, b, f), False),
        ("least", (b, lit(3)), False), ("greatest", (f, g), False),
        ("least", (a, c, b, lit(0)), False),
    ]
    out += [(f"fn_{n}_{i}", Fn(n, args), t) for i, (n, args, t) in enumerate(funcs)]
    out += [(f"str_{n}", ns.StringFunc(n, col("ch"), ns.dictionary), False)
            for n in ("upper", "lower", "length")]
    return out


def _dict(cls):
    d = cls()
    d.encode(list(CHANNELS))
    return d


@pytest.fixture(scope="module")
def setup():
    cols, nulls = _lanes()
    ref_chunk = RefChunk.from_numpy(cols, CAP, nulls=nulls)
    port_chunk = DataChunk.from_numpy(cols, CAP, nulls=nulls, device="cpu")
    ref = _battery(_ns(RE, RF, _dict(RefDict)))
    port = _battery(_ns(PE, PF, _dict(StringDictionary)))
    return ref_chunk, port_chunk, ref, port


def _np(t):
    return None if t is None else (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t))


def assert_ulp_close(want, got, ulps=ULPS, what=""):
    want, got = np.asarray(want), np.asarray(got)
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got), err_msg=what)
    fin = np.isfinite(want) & np.isfinite(got)
    np.testing.assert_array_equal(want[~fin & ~np.isnan(want)], got[~fin & ~np.isnan(got)],
                                  err_msg=what)
    one = np.ones((), want.dtype)
    mag = np.maximum(np.maximum(np.abs(want[fin]), np.abs(got[fin])), one)
    bad = np.abs(want[fin].astype(np.float64) - got[fin]) > ulps * np.spacing(mag)
    assert not bad.any(), (what, want[fin][bad][:5], got[fin][bad][:5])


def assert_same(want, got, transcendental: bool, what: str, ulps: int = ULPS):
    (wv, wn), (gv, gn) = want, got
    wv, gv = _np(wv), _np(gv)
    assert wv.dtype == gv.dtype, (what, wv.dtype, gv.dtype)
    assert (wn is None) == (gn is None), (what, "null lane presence")
    if wn is not None:
        np.testing.assert_array_equal(_np(wn), _np(gn), err_msg=what)
    if transcendental and wv.dtype.kind == "f":
        assert_ulp_close(wv, gv, ulps, what=what)
    else:
        np.testing.assert_array_equal(wv, gv, err_msg=what)


def test_battery_covers_every_registered_function(setup):
    _, _, _, port = setup
    used = {e.name for _, e, _ in port if isinstance(e, PF.Func)}
    assert used == set(PF.registry_names())
    assert set(PF.registry_names()) == set(RF.registry_names())


@pytest.mark.parametrize("i", range(len(_battery(_ns(PE, PF, None)))))
def test_node_against_reference(setup, i):
    ref_chunk, port_chunk, ref, port = setup
    name, rexpr, trans = ref[i]
    _, pexpr, _ = port[i]
    ulps = ATANH_ULPS if name.startswith("fn_atanh") else ULPS
    assert_same(rexpr.eval(ref_chunk), pexpr.eval(port_chunk), trans, name, ulps)


def test_program_interpreter_equals_tree_walk(setup):
    """Every battery tree compiled into one projection program: the plain
    interpreter of the program gives the tree walk's lanes exactly."""
    _, port_chunk, _, port = setup
    exprs = [(n, e) for n, e, _ in port]
    want_cols, want_nulls = expr_vm.project_torch(port_chunk, exprs)
    for lo in range(0, len(exprs), 12):  # programs within the kernel's limits
        part = exprs[lo:lo + 12]
        prog = expr_vm.compile_program(
            part, expr_vm.chunk_signature_of(port_chunk, PE.collect_columns(
                tuple(e for _, e in part))), False)
        assert prog.kernel_problem() is None, prog.kernel_problem()
        cols, nulls = expr_vm.run_program_torch(prog, port_chunk)
        for n, _ in part:
            assert cols[n].dtype == want_cols[n].dtype, n
            np.testing.assert_array_equal(cols[n].numpy(), want_cols[n].numpy(), err_msg=n)
            assert (n in nulls) == (n in want_nulls), n
            if n in nulls:
                assert torch.equal(nulls[n], want_nulls[n]), n


def test_program_cache_shares_a_program_across_literal_values(setup):
    _, port_chunk, _, _ = setup
    before = expr_vm.cache_stats()["programs"]
    progs = []
    for t in (20, 25):
        lifted = PE.lift_literals(PE.col("a") >= t, ints := [], [])
        progs.append(expr_vm.program_for((("keep", lifted),), port_chunk, True))
        assert ints == [t]
    assert progs[0] is progs[1]
    assert expr_vm.cache_stats()["programs"] == before + 1
    baked = [expr_vm.program_for((("keep", PE.col("a") >= t),), port_chunk, True)
             for t in (20, 25)]
    assert baked[0] is not baked[1] and baked[0].lits != baked[1].lits


@pytest.mark.parametrize("threshold", [20, 25])
def test_lifted_program_reads_its_parameters(setup, threshold):
    cols, nulls = _lanes()
    port_chunk = StreamChunk.from_numpy(cols, CAP, nulls=nulls, device="cpu")
    lifted = PE.lift_literals((PE.col("a") >= threshold) & (PE.col("f") < 1.5), ints := [],
                              floats := [])
    params = {"i": torch.tensor(ints, dtype=torch.int64),
              "f": torch.tensor(floats, dtype=torch.float64)}
    prog = expr_vm.program_for((("keep", lifted),), port_chunk, True)
    with PE.param_scope(params):
        keep = expr_vm.run_program_torch(prog, port_chunk, params)
        walked, _ = expr_vm.filter_torch(port_chunk, lifted)
    a, f = port_chunk.col("a"), port_chunk.col("f")
    an, fn = port_chunk.nulls["a"], port_chunk.nulls["f"]
    want = (a >= threshold) & ~an & (f < 1.5) & ~fn
    assert torch.equal(keep, want)
    assert torch.equal(walked, want & port_chunk.valid)
    with pytest.raises(RuntimeError, match="param_scope"):
        expr_vm.run_program_torch(prog, port_chunk, None)


def test_lift_literals_and_structural_keys_match_reference():
    def tree(E, t, s):
        return E.And(E.col("num") >= t, E.BinOp("*", E.col("price"), E.lit(s)) > E.lit(True))

    for t, s in ((20, 0.908), (25, 1.5)):
        ri, rf, pi, pf = [], [], [], []
        rl = RE.lift_literals(tree(RE, t, s), ri, rf)
        pl = PE.lift_literals(tree(PE, t, s), pi, pf)
        assert RE.structural_key(rl) == PE.structural_key(pl)
        assert (ri, rf) == (pi, pf) == ([t], [s])
        assert RE.structural_key(tree(RE, t, s)) == PE.structural_key(tree(PE, t, s))
    # two thresholds: equal lifted structures, unequal baked ones
    a, b = (PE.lift_literals(PE.col("num") >= t, [], []) for t in (20, 25))
    assert PE.StaticTree(a) == PE.StaticTree(b)
    assert PE.StaticTree(PE.col("num") >= 20) != PE.StaticTree(PE.col("num") >= 25)
    assert PE.collect_columns(tree(PE, 1, 2.0)) == RE.collect_columns(tree(RE, 1, 2.0))


def test_udfs_and_unknown_nodes_raise():
    with pytest.raises(NotImplementedError):
        PF.register_py_udf("f", lambda x: x)
    chunk = DataChunk.from_numpy({"a": np.arange(3)}, 4, device="cpu")
    with pytest.raises(KeyError):
        PF.Func("no_such_fn", (PE.col("a"),)).eval(chunk)
    with pytest.raises(ValueError):
        PF.Extract("century", PE.col("a")).eval(chunk)


def test_kernel_refuses_what_it_cannot_run():
    """Dtypes outside the kernel's five raise NotImplementedError when a
    program is packed for the card; the plain version takes them."""
    chunk = DataChunk.from_numpy({"s": np.arange(4, dtype=np.int16)}, 4, device="cpu")
    v, _ = (PE.col("s") + 1).eval(chunk)
    assert v.dtype == torch.int16
    prog = expr_vm.program_for((("x", PE.col("s") + 1),), chunk, False)
    with pytest.raises(NotImplementedError, match="kernel S"):
        expr_vm.pack_program(prog, [], [])
