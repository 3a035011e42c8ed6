"""Kernels L and M and the inner hash join: the port's plain PyTorch
versions (``ops/join.py``, ``executors/hash_join.py``) against
``risingwave_tpu`` on JAX-CPU, on the same seeded inputs.

On the CPU the port's hash table places keys in the reference's slots,
so every lane must be equal, bucket positions included. Tolerance: none
(NaN payloads compare as NaN).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors import Barrier
from risingwave_tpu.executors import HashJoinExecutor as RefJoin
from risingwave_tpu.executors.base import Epoch
from risingwave_tpu.executors.hash_join import join_step_fn as ref_join_step
from risingwave_tpu.ops import join as rj
from risingwave_tpu.types import Op
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor, join_step_fn
from risingwave_tpu_torch.ops import join as pj
from test_hash_join import _collect, _oracle

NAMES = ("k", "v", "w")  # payload: k (join key, int64), v float64, w int32 (nullable)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sides(cap, fanout):
    dt = {"k": jnp.int64, "v": jnp.float64, "w": jnp.int32}
    ref = rj.JoinSide.create(cap, fanout, (jnp.int64,), dt, nullable=("w",))
    port = pj.JoinSide.create(
        cap, fanout, (torch.int64,),
        {"k": torch.int64, "v": torch.float64, "w": torch.int32}, nullable=("w",), device="cpu",
    )
    return ref, port


def _batch(rng, n, n_keys, stored, p_del=0.3, nan=True):
    """n rows: inserts of random (k, v, w) rows (NaN v, NULL w), and
    deletes of stored rows (their exact values), some twice. Returns
    numpy lanes and updates ``stored``."""
    k = np.zeros(n, np.int64)
    v = np.zeros(n, np.float64)
    w = np.zeros(n, np.int32)
    wn = np.zeros(n, bool)
    ops = np.zeros(n, np.int32)
    for i in range(n):
        if stored and rng.random() < p_del:
            row = stored[int(rng.integers(len(stored)))]
            if rng.random() < 0.8:
                stored.remove(row)
            k[i], v[i], w[i], wn[i] = row
            ops[i] = Op.DELETE
        else:
            row = (int(rng.integers(0, n_keys)), float(rng.integers(0, 4)), int(rng.integers(0, 3)),
                   bool(rng.random() < 0.3))
            if nan and rng.random() < 0.1:
                row = (row[0], float("nan"), row[2], row[3])
            if row[3]:
                row = (row[0], row[1], 0, True)
            stored.append(row)
            k[i], v[i], w[i], wn[i] = row
    return k, v, w, wn, ops


def _apply_both(ref, port, lanes, valid):
    k, v, w, wn, ops = lanes
    signs = np.where(ops == Op.DELETE, -1, 1).astype(np.int32)
    ref = rj.apply_side(
        ref, (jnp.asarray(k),), {"k": jnp.asarray(k), "v": jnp.asarray(v), "w": jnp.asarray(w)},
        {"w": jnp.asarray(wn)}, jnp.asarray(valid), jnp.asarray(signs), NAMES,
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pj.apply_side(
        port, (t(k),), {"k": t(k), "v": t(v), "w": t(w)}, {"w": t(wn)}, t(valid), t(ops), NAMES,
    )
    return ref


def _side_lanes_equal(ref, port):
    a = lambda x: np.asarray(x)
    pairs = {
        "fp1": (a(ref.table.fp1), port.table.fp1.numpy().view(np.uint32)),
        "fp2": (a(ref.table.fp2), port.table.fp2.numpy().view(np.uint32)),
        "key": (a(ref.table.keys[0]), port.table.keys[0].numpy()),
        "live": (a(ref.table.live), port.table.live.numpy()),
        "row_valid": (a(ref.row_valid), port.row_valid.numpy()),
        "degree": (a(ref.degree), port.degree.numpy()),
        "sdirty": (a(ref.sdirty), port.sdirty.numpy()),
        "overflow": (a(ref.overflow), port.overflow.numpy()),
        "inconsistent": (a(ref.inconsistent), port.inconsistent.numpy()),
        "null_w": (a(ref.row_nulls["w"]), port.row_nulls["w"].numpy()),
    }
    for name in NAMES:
        pairs[f"row_{name}"] = (a(ref.rows[name]), port.rows[name].numpy())
    for name, (x, y) in pairs.items():
        np.testing.assert_array_equal(y, x, err_msg=name)


@pytest.mark.parametrize(
    "cap,fanout,n_keys,seed",
    [(256, 8, 40, 0), (256, 2, 20, 1), (16, 4, 200, 2)],
    ids=["roomy", "full_buckets", "no_slot"],
)
def test_apply_side_matches_reference_lane_for_lane(cap, fanout, n_keys, seed):
    """Inserts into the rank-th free position, deletes of the rank-th
    matching entry (duplicates, NaN, NULL), invalid rows; full buckets
    latch overflow, a 16-slot table drops rows (slot -1), deletes of
    rows never stored latch inconsistent."""
    rng = np.random.default_rng(seed)
    ref, port = _sides(cap, fanout)
    stored = []
    for step in range(5):
        lanes = _batch(rng, 48, n_keys, stored)
        valid = rng.random(48) > 0.1
        if step == 3:  # a delete of a row that was never stored
            lanes[0][0], lanes[1][0], lanes[4][0] = 10**6, 1.5, Op.DELETE
            valid[0] = True
        ref = _apply_both(ref, port, lanes, valid)
        _side_lanes_equal(ref, port)
    assert bool(port.inconsistent)
    if fanout == 2 or cap == 16:
        assert bool(port.overflow)


def test_insert_and_delete_of_one_row_in_a_chunk_net_out():
    ref, port = _sides(64, 4)
    row = (np.array([5, 5], np.int64), np.array([1.0, 1.0]), np.array([2, 2], np.int32),
           np.zeros(2, bool), np.array([Op.INSERT, Op.DELETE], np.int32))
    ref = _apply_both(ref, port, row, np.ones(2, bool))
    _side_lanes_equal(ref, port)
    assert not bool(port.row_valid.any()) and not bool(port.inconsistent)


def _probe_inputs(rng, n, n_keys):
    k = rng.integers(0, n_keys, n).astype(np.int64)
    x = rng.integers(0, 100, n).astype(np.int64)
    ops = np.where(rng.random(n) < 0.3, Op.DELETE, Op.INSERT).astype(np.int32)
    valid = rng.random(n) > 0.1
    return k, x, ops, valid


M_MODES = {"inner": (True, pj.G2_NONE), "outer": (True, pj.G2_OUTER),
           "semi": (False, pj.G2_SEMI), "anti": (False, pj.G2_ANTI)}


def _ref_emission(ref, k, x, ops, valid, out_cap, pairs_on, group2):
    """The reference's emission groups 1 and 2 of a probe chunk
    (``executors/hash_join.py:join_step_fn`` :156-195: ``probe_side``,
    ``gather_matches``, the groups' flat lanes, ``compact_pairs``): the
    output lanes by name (own ``x`` beside the stored ``NAMES``), ops,
    valid, the uncapped total and the overflow."""
    sl, match = rj.probe_side(ref, (jnp.asarray(k),), jnp.asarray(valid))
    o_cols, o_nulls = rj.gather_matches(ref, sl, NAMES)
    match = np.asarray(match)
    n, fanout = match.shape
    mc = match.sum(1)
    out_ops = np.where(np.isin(ops, (Op.DELETE, Op.UPDATE_DELETE)), Op.DELETE,
                       Op.INSERT).astype(np.int32)
    cols, nulls, f_ops, f_valid = collections.defaultdict(list), collections.defaultdict(list), [], []
    names = ("x",) + NAMES if pairs_on else ("x",)
    null_names = (("k", "v", "w") if group2 == pj.G2_OUTER else ("w",)) if pairs_on else ()
    if pairs_on:
        cols["x"].append(np.repeat(x, fanout))
        for nm in NAMES:
            cols[nm].append(np.asarray(o_cols[nm]).reshape(-1))
        for nm in null_names:
            nulls[nm].append(np.asarray(o_nulls[nm]).reshape(-1) if nm in o_nulls
                             else np.zeros(n * fanout, bool))
        f_ops.append(np.repeat(out_ops, fanout))
        f_valid.append(match.reshape(-1))
    if group2 != pj.G2_NONE:
        cond = np.asarray(valid) & ((mc > 0) if group2 == pj.G2_SEMI else (mc == 0))
        cols["x"].append(x)
        for nm in names[1:]:
            cols[nm].append(np.zeros(n, np.asarray(o_cols[nm]).dtype))
        for nm in null_names:
            nulls[nm].append(np.ones(n, bool))
        f_ops.append(out_ops)
        f_valid.append(cond)
    cat = lambda parts: jnp.asarray(np.concatenate(parts))
    r_cols, r_nulls, r_ops, r_valid, ovf = rj.compact_pairs(
        {nm: cat(v) for nm, v in cols.items()}, {nm: cat(v) for nm, v in nulls.items()},
        cat(f_ops), cat(f_valid), out_cap)
    lanes = {**{f"col.{nm}": r_cols[nm] for nm in names},
             **{f"null.{nm}": r_nulls[nm] for nm in null_names}, "ops": r_ops, "valid": r_valid}
    return lanes, int(np.concatenate(f_valid).sum()), bool(ovf), names, null_names


def _probe_case(case, rng):
    """The side, the probe chunk's lanes and the output capacity of a case
    of ``test_probe_gather_compact_match_reference``."""
    cap, fanout, n_keys, n = 128, 4, 30, 64
    if case == "full_buckets":  # ten keys: every bucket fills and the side latches overflow
        cap, fanout, n_keys = 64, 2, 10
    ref, port = _sides(cap, fanout)
    stored = []
    for _ in range(3):
        ref = _apply_both(ref, port, _batch(rng, 40, n_keys, stored, p_del=0.1),
                          np.ones(40, bool))
    k, x, ops, valid = _probe_inputs(rng, 0 if case == "n0" else n, n_keys + 10)
    return ref, port, k, x, ops, valid


@pytest.mark.parametrize("case", ["fits", "em_overflow", "cut_in_pairs", "cut_in_group2", "n0",
                                  "full_buckets"])
def test_probe_gather_compact_match_reference(case):
    """The plain probe, gather and compaction against the reference's;
    then ``probe_pairs`` (kernel M's plain version) in each mode (inner
    pairs; the outer arrival's pairs then NULL pads; semi; anti) against
    the reference's groups 1 and 2 compacted (``join_step_fn``'s
    composition), every output row: into an output that holds them all,
    one of 16 rows, one cut inside the pairs, one cut inside group 2; an
    empty chunk; full buckets."""
    rng = np.random.default_rng(7)
    ref, port, k, x, ops, valid = _probe_case(case, rng)
    out_cap = {"em_overflow": 16}.get(case, 512)
    t = lambda a: torch.from_numpy(np.array(a))
    r_sl, r_match = rj.probe_side(ref, (jnp.asarray(k),), jnp.asarray(valid))
    p_sl, p_match = pj.probe_side(port, (t(k),), t(valid))
    np.testing.assert_array_equal(p_sl.numpy(), np.asarray(r_sl))
    np.testing.assert_array_equal(p_match.numpy(), np.asarray(r_match))
    r_cols, r_nulls = rj.gather_matches(ref, r_sl, NAMES)
    p_cols, p_nulls = pj.gather_matches(port, p_sl, NAMES)
    for name in NAMES:
        np.testing.assert_array_equal(p_cols[name].numpy(), np.asarray(r_cols[name]))
    np.testing.assert_array_equal(p_nulls["w"].numpy(), np.asarray(r_nulls["w"]))
    fanout = port.fanout
    flat = {n: np.asarray(r_cols[n]).reshape(-1) for n in NAMES}
    fops = np.repeat(ops, fanout)
    fvalid = np.asarray(r_match).reshape(-1)
    r = rj.compact_pairs({n: jnp.asarray(a) for n, a in flat.items()}, {},
                         jnp.asarray(fops), jnp.asarray(fvalid), out_cap)
    p = pj.compact_pairs({n: t(a) for n, a in flat.items()}, {}, t(fops), t(fvalid), out_cap)
    for name in NAMES:
        np.testing.assert_array_equal(p[0][name].numpy(), np.asarray(r[0][name]))
    for i in (2, 3, 4):
        np.testing.assert_array_equal(p[i].numpy(), np.asarray(r[i]))
    assert bool(p[4]) == (case == "em_overflow")
    if case == "fits":
        g_cols, g_nulls = pj.gather_flat(port, t(np.array([0, 5, 128 * 4 + 9], np.int32)), NAMES)
        gr_cols, _ = rj.gather_flat(ref, jnp.array([0, 5, 128 * 4 + 9], jnp.int32), NAMES)
        for name in NAMES:
            np.testing.assert_array_equal(g_cols[name].numpy(), np.asarray(gr_cols[name]))
    if case == "full_buckets":
        assert bool(port.overflow) and bool((port.row_valid.sum(1) == fanout).any())
    pairs = int(fvalid.sum())
    for mode, (pairs_on, group2) in M_MODES.items():
        cap_out = out_cap
        if case in ("cut_in_pairs", "cut_in_group2"):
            _, total, _, _, _ = _ref_emission(ref, k, x, ops, valid, 1 << 12, pairs_on, group2)
            before = pairs if pairs_on else 0
            cap_out = (before // 2 if case == "cut_in_pairs"
                       else before + max(total - before, 1) // 2)
        want, total, ovf, names, null_names = _ref_emission(ref, k, x, ops, valid, cap_out,
                                                            pairs_on, group2)
        em = torch.zeros((), dtype=torch.bool)
        rows = torch.zeros((), dtype=torch.int64)
        got = pj.probe_pairs(port, (t(k),), t(valid), t(ops), {"x": t(x)}, {}, names, cap_out,
                             em, rows, null_names, pairs_on, group2)
        lanes = {**{f"col.{nm}": got.cols[nm] for nm in names},
                 **{f"null.{nm}": got.nulls[nm] for nm in null_names}, "ops": got.ops,
                 "valid": got.valid}
        assert lanes.keys() == want.keys(), mode
        for name, lane in want.items():
            np.testing.assert_array_equal(lanes[name].numpy(), np.asarray(lane),
                                          err_msg=f"{mode} {name}")
        assert int(got.written) == total and bool(em) == ovf == (total > cap_out), mode
        assert int(rows) == min(total, cap_out), mode
        np.testing.assert_array_equal(got.mc.numpy(), np.asarray(r_match).sum(1), err_msg=mode)
        if case == "cut_in_group2" and group2 != pj.G2_NONE:
            assert before < cap_out < total, mode  # the cut falls inside group 2


def test_regrow_matches_reference():
    rng = np.random.default_rng(3)
    ref, port = _sides(64, 4)
    stored = []
    for _ in range(4):
        ref = _apply_both(ref, port, _batch(rng, 32, 25, stored, p_del=0.4), np.ones(32, bool))
    for new_cap, new_fanout in ((256, 4), (128, 8), (64, 2)):
        r = rj.regrow(ref, new_cap, new_fanout)
        p = pj.regrow(port, new_cap, new_fanout)
        _side_lanes_equal(r, p)
        np.testing.assert_array_equal(p.stored.numpy(), np.asarray(r.stored))


def _chunk_pair(cols, ops, cap, nulls=None):
    ref = RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls)
    port = StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu")
    return ref, port


@pytest.mark.parametrize("out_cap", [256, 8], ids=["fits", "em_overflow"])
def test_join_step_inner_matches_reference(out_cap):
    """Alternating left/right chunks through both join_step_fns: the
    emitted chunks (lanes, null lanes, ops, valid), both sides' lanes
    and the emission latch stay equal."""
    rng = np.random.default_rng(11)
    ldt = {"lk": jnp.int64, "lv": jnp.float64}
    rdt = {"rk": jnp.int64, "rv": jnp.int32}
    rl = rj.JoinSide.create(128, 4, (jnp.int64,), ldt)
    rr = rj.JoinSide.create(128, 4, (jnp.int64,), rdt, nullable=("rv",))
    pl = pj.JoinSide.create(128, 4, (torch.int64,), {"lk": torch.int64, "lv": torch.float64},
                            device="cpu")
    pr = pj.JoinSide.create(128, 4, (torch.int64,), {"rk": torch.int64, "rv": torch.int32},
                            nullable=("rv",), device="cpu")
    out_names = ("lk", "lv", "rk", "rv")
    em = torch.zeros((), dtype=torch.bool)
    r_em = False
    for step in range(6):
        n = 40
        keys = rng.integers(0, 12, n)
        ops = np.where(rng.random(n) < 0.2 * (step > 1), Op.DELETE, Op.INSERT).astype(np.int32)
        if step % 2 == 0:
            cols = {"lk": keys, "lv": rng.integers(0, 3, n).astype(np.float64)}
            rc, pc = _chunk_pair(cols, ops, 48)
            rl, rr, cols_r, nulls_r, ops_r, valid_r, o = ref_join_step(
                rl, rr, rc, ("lk",), ("rk",), ("lk", "lv"), ("rk", "rv"), out_cap, "inner", "l",
                out_names,
            )
            pl, pr, out = join_step_fn(pl, pr, pc, ("lk",), ("lk", "lv"), out_names, out_cap, em)
        else:
            cols = {"rk": keys, "rv": rng.integers(0, 3, n).astype(np.int32)}
            rc, pc = _chunk_pair(cols, ops, 48, nulls={"rv": rng.random(n) < 0.3})
            rr, rl, cols_r, nulls_r, ops_r, valid_r, o = ref_join_step(
                rr, rl, rc, ("rk",), ("lk",), ("rk", "rv"), ("lk", "lv"), out_cap, "inner", "r",
                out_names,
            )
            pr, pl, out = join_step_fn(pr, pl, pc, ("rk",), ("rk", "rv"), out_names, out_cap, em)
        r_em = r_em or bool(o)
        for name in out_names:
            np.testing.assert_array_equal(out.col(name).numpy(), np.asarray(cols_r[name]))
        assert set(out.nulls) == set(nulls_r)
        for name in nulls_r:
            np.testing.assert_array_equal(out.nulls[name].numpy(), np.asarray(nulls_r[name]))
        np.testing.assert_array_equal(out.ops.numpy(), np.asarray(ops_r))
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(valid_r))
        assert bool(em) == r_em
        for a, b in ((rl, pl), (rr, pr)):
            np.testing.assert_array_equal(b.row_valid.numpy(), np.asarray(a.row_valid))
            np.testing.assert_array_equal(b.table.live.numpy(), np.asarray(a.table.live))
    assert r_em == (out_cap == 8)


def test_non_inner_join_types_raise():
    """Every type of JOIN_TYPES constructs (semi and anti emit their
    driving side only); an unknown type still raises ValueError, in the
    executor and in the step function."""
    from risingwave_tpu_torch.executors.hash_join import JOIN_TYPES

    for jt in JOIN_TYPES:
        ex = HashJoinExecutor(("a",), ("b",), {"a": torch.int64}, {"b": torch.int64},
                              join_type=jt, device="cpu")
        want = {"left_semi": ("a",), "left_anti": ("a",), "right_semi": ("b",),
                "right_anti": ("b",)}.get(jt, ("a", "b"))
        assert ex.join_type == jt and ex.out_names == want
    with pytest.raises(ValueError):
        HashJoinExecutor(("a",), ("b",), {"a": torch.int64}, {"b": torch.int64},
                         join_type="cross", device="cpu")
    with pytest.raises(ValueError):
        join_step_fn(None, None, None, (), (), (), 8, None, join_type="cross")


# -- executor mirrors of tests/test_hash_join.py's inner cases ---------------------
def _executors(lk, rk, ldt, rdt, **kw):
    to_t = {jnp.int64: torch.int64}
    ref = RefJoin(lk, rk, ldt, rdt, **kw)
    port = HashJoinExecutor(lk, rk, {n: to_t[d] for n, d in ldt.items()},
                            {n: to_t[d] for n, d in rdt.items()}, device="cpu", **kw)
    return ref, port


def _drive(ref, port, steps, names, cap=128):
    """Feed (side, cols, ops, nulls) steps to both; return both
    emission multisets and check the sides' digests agree."""
    got_r, got_p = collections.Counter(), collections.Counter()
    for side, cols, ops, nulls in steps:
        cols = {k: np.asarray(v) for k, v in cols.items()}
        ops = None if ops is None else np.asarray(ops, np.int32)
        rc, pc = _chunk_pair(cols, ops, cap, nulls)
        _collect(ref.apply_left(rc) if side == "l" else ref.apply_right(rc), got_r, names)
        _collect(port.apply_left(pc) if side == "l" else port.apply_right(pc), got_p, names)
    ref.on_barrier(Barrier(Epoch(0, 1)))
    port.on_barrier(None)
    assert port.state_digest() == ref.state_digest()
    assert got_p == got_r
    return got_p


KV = dict(capacity=1 << 10, fanout=8, out_cap=1 << 10)


def test_join_basic_insert_probe():
    ref, port = _executors(("seller",), ("pid",), {"seller": jnp.int64, "aid": jnp.int64},
                           {"pid": jnp.int64, "pname": jnp.int64}, **KV)
    got = _drive(ref, port, [
        ("r", {"pid": [1, 2, 3, 4], "pname": [10, 20, 30, 40]}, None, None),
        ("l", {"seller": [2, 2, 3, 9], "aid": [100, 101, 102, 103]}, None, None),
    ], ("seller", "aid", "pid", "pname"))
    assert got == collections.Counter({(2, 100, 2, 20): 1, (2, 101, 2, 20): 1, (3, 102, 3, 30): 1})


def test_join_retraction_both_sides():
    ref, port = _executors(("lk",), ("rk",), {"lk": jnp.int64, "lv": jnp.int64},
                           {"rk": jnp.int64, "rv": jnp.int64}, **KV)
    got = _drive(ref, port, [
        ("l", {"lk": [1, 1], "lv": [5, 6]}, None, None),
        ("r", {"rk": [1], "rv": [7]}, None, None),
        ("l", {"lk": [1], "lv": [5]}, [Op.DELETE], None),
        ("r", {"rk": [1], "rv": [7]}, [Op.DELETE], None),
    ], ("lk", "lv", "rk", "rv"))
    assert got == collections.Counter()


def test_join_null_keys_never_match():
    ref, port = _executors(("lk",), ("rk",), {"lk": jnp.int64, "lv": jnp.int64},
                           {"rk": jnp.int64, "rv": jnp.int64}, **KV)
    got = _drive(ref, port, [
        ("r", {"rk": [0, 2], "rv": [70, 71]}, None, {"rk": np.array([True, False])}),
        ("l", {"lk": [0, 0, 2], "lv": [50, 51, 52]}, None,
         {"lk": np.array([True, False, False])}),
    ], ("lk", "lv", "rk", "rv"))
    assert got == collections.Counter({(2, 52, 2, 71): 1})


def test_join_random_stream_vs_reference_and_pandas():
    rng = np.random.default_rng(17)
    ref, port = _executors(("lk",), ("rk",), {"lk": jnp.int64, "lv": jnp.int64},
                           {"rk": jnp.int64, "rv": jnp.int64}, capacity=1 << 12, fanout=16,
                           out_cap=1 << 12)
    live = {"l": [], "r": []}
    steps = []
    for _ in range(10):
        side = "l" if rng.random() < 0.5 else "r"
        n = int(rng.integers(8, 60))
        kcol, vcol = ("lk", "lv") if side == "l" else ("rk", "rv")
        keys, vals, ops = [], [], []
        for _ in range(n):
            if live[side] and rng.random() < 0.35:
                k, v = live[side].pop(int(rng.integers(len(live[side]))))
                ops.append(Op.DELETE)
            else:
                k, v = int(rng.integers(0, 25)), int(rng.integers(0, 1000))
                live[side].append((k, v))
                ops.append(Op.INSERT)
            keys.append(k)
            vals.append(v)
        steps.append((side, {kcol: keys, vcol: vals}, ops, None))
    names = ("lk", "lv", "rk", "rv")
    got = _drive(ref, port, steps, names)
    want = _oracle([{"lk": k, "lv": v} for k, v in live["l"]],
                   [{"rk": k, "rv": v} for k, v in live["r"]], ("lk",), ("rk",), names)
    assert got == want and len(want) > 10


def test_join_duplicate_rows_same_chunk():
    ref, port = _executors(("lk",), ("rk",), {"lk": jnp.int64, "lv": jnp.int64},
                           {"rk": jnp.int64, "rv": jnp.int64}, capacity=1 << 8, fanout=8,
                           out_cap=1 << 10)
    got = _drive(ref, port, [
        ("r", {"rk": [7], "rv": [1]}, None, None),
        ("l", {"lk": [7, 7, 7, 7], "lv": [5, 5, 5, 8]}, None, None),
        ("l", {"lk": [7, 7], "lv": [5, 5]}, [Op.DELETE, Op.DELETE], None),
        ("r", {"rk": [7], "rv": [2]}, None, None),
    ], ("lk", "lv", "rk", "rv"))
    assert got == collections.Counter({(7, 5, 7, 1): 1, (7, 8, 7, 1): 1, (7, 5, 7, 2): 1,
                                       (7, 8, 7, 2): 1})


def test_join_growth():
    """The growth half of test_join_growth_and_watermark_expiry: a
    64-slot side regrows several times; every key joins once and both
    sides' capacities follow the reference's."""
    ref, port = _executors(("lk", "lw"), ("rk", "rw"),
                           {"lk": jnp.int64, "lw": jnp.int64, "lv": jnp.int64},
                           {"rk": jnp.int64, "rw": jnp.int64, "rv": jnp.int64},
                           capacity=1 << 6, fanout=4, out_cap=1 << 12)
    steps = []
    for start in range(0, 300, 50):
        ks = np.arange(start, start + 50, dtype=np.int64)
        win = ks % 4
        steps.append(("l", {"lk": ks, "lw": win, "lv": ks * 2}, None, None))
        steps.append(("r", {"rk": ks, "rw": win, "rv": ks * 3}, None, None))
    got = _drive(ref, port, steps, ("lk", "lw", "lv", "rk", "rw", "rv"), cap=64)
    assert len(got) == 300
    assert port.left.capacity == ref.left.capacity >= 300
    assert port.right.capacity == ref.right.capacity
