"""The join-type matrix: kernels M (group 2), P (degrees and group 3)
and L (``init_degree``) through the port's plain PyTorch versions
(``ops/join.py``, ``executors/hash_join.py``) against ``risingwave_tpu``
on JAX-CPU, on the same seeded inputs, for every type of ``JOIN_TYPES``
(mirrors of ``tests/test_join_types.py``).

On the CPU the port's hash table places keys in the reference's slots
and its plain ``degree_apply`` sorts pids as the reference does, so
emitted lanes, side lanes and degree lanes compare exactly. Tolerance:
none (integer lanes only).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref_integrity
from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors.hash_join import JOIN_TYPES
from risingwave_tpu.executors.hash_join import HashJoinExecutor as RefJoin
from risingwave_tpu.executors.hash_join import join_step_fn as ref_join_step
from risingwave_tpu.ops import join as rj
from risingwave_tpu.types import Op
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.hash_join import JOIN_TYPES as PORT_JOIN_TYPES
from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor, _modes, join_step_fn
from risingwave_tpu_torch.ops import join as pj
from test_join_types import _oracle, _project_oracle

CAP = 16  # chunk capacity, as test_join_types.py
L_DT = {"lk": torch.int64, "lv": torch.int64}
R_DT = {"rk": torch.int64, "rv": torch.int64}
REF_DT = {torch.int64: np.int64}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_join_types_are_the_reference_matrix():
    assert PORT_JOIN_TYPES == JOIN_TYPES


def _executors(join_type, **kw):
    ref = RefJoin(["lk"], ["rk"], {k: REF_DT[v] for k, v in L_DT.items()},
                  {k: REF_DT[v] for k, v in R_DT.items()}, join_type=join_type, **kw)
    port = HashJoinExecutor(["lk"], ["rk"], L_DT, R_DT, join_type=join_type, device="cpu", **kw)
    assert port.out_names == ref.out_names
    return ref, port


def _chunks(rows, side):
    """rows: (key, val, op) -> the reference's and the port's chunk."""
    names = ("lk", "lv") if side == "l" else ("rk", "rv")
    cols = {names[0]: np.array([r[0] for r in rows], np.int64),
            names[1]: np.array([r[1] for r in rows], np.int64)}
    ops = np.array([r[2] for r in rows], np.int32)
    return (RefChunk.from_numpy(cols, CAP, ops=ops),
            StreamChunk.from_numpy(cols, CAP, ops=ops, device="cpu"))


def _emitted(outs, names):
    """A chunk list's rows as a multiset of (row, sign)."""
    got = collections.Counter()
    for c in outs:
        d = c.to_numpy(with_ops=True)
        for i in range(len(d["__op__"])):
            row = tuple(None if d.get(n + "__null") is not None and d[n + "__null"][i]
                        else int(d[n][i]) for n in names)
            got[(row, 1 if d["__op__"][i] in (Op.INSERT, Op.UPDATE_INSERT) else -1)] += 1
    return got


def _ref_side_digests(ref):
    return tuple(ref_integrity.host_digest(*ref_integrity.join_side_lanes(s, np.where))
                 for s in (ref.left, ref.right))


def _apply(ex, side, chunk):
    return (ex.apply_left if side == "l" else ex.apply_right)(chunk)


def _run_stream(join_type, seed, n_steps=40):
    """test_join_types.py's random insert/delete stream through both
    executors: per chunk the emission multisets and both sides' digests
    equal; at the end the port's net emission equals the oracle join of
    the final side multisets."""
    rng = np.random.default_rng(seed)
    ref, port = _executors(join_type, capacity=256, fanout=32, out_cap=1 << 12)
    left_rows, right_rows = collections.Counter(), collections.Counter()
    acc = collections.Counter()
    for step in range(n_steps):
        side = "l" if rng.random() < 0.5 else "r"
        mult = left_rows if side == "l" else right_rows
        rows = []
        for _ in range(int(rng.integers(1, 6))):
            if mult and rng.random() < 0.35:
                k, v = list(mult.keys())[int(rng.integers(len(mult)))]
                rows.append((k, v, Op.DELETE))
                mult[(k, v)] -= 1
                if mult[(k, v)] == 0:
                    del mult[(k, v)]
            else:
                k, v = int(rng.integers(0, 6)), int(rng.integers(0, 4))
                rows.append((k, v, Op.INSERT))
                mult[(k, v)] += 1
        rc, pc = _chunks(rows, side)
        want = _emitted(_apply(ref, side, rc), ref.out_names)
        got = _emitted(_apply(port, side, pc), port.out_names)
        assert got == want, f"{join_type} seed={seed} step={step}"
        assert port.side_digests() == _ref_side_digests(ref), f"{join_type} step={step}"
        for (row, sign), c in got.items():
            acc[row] += sign * c
    ref.on_barrier(None)
    port.on_barrier(None)  # raises on overflow or inconsistency
    got = {k: v for k, v in acc.items() if v != 0}
    return got, _project_oracle(join_type, _oracle(join_type, left_rows, right_rows))


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_join_type_stream_parity(join_type):
    for seed in (1, 2):
        got, want = _run_stream(join_type, seed)
        assert got == want, f"{join_type} seed={seed}: {len(got)} vs {len(want)} rows"


def _drain(ex, outs, acc):
    for (row, sign), c in _emitted(outs, ex.out_names).items():
        acc[row] += sign * c
    return collections.Counter({k: v for k, v in acc.items() if v != 0})


def test_left_join_nullpad_transitions_minimal():
    """Unmatched -> NULL pad, a match arrives -> pad retracted and the
    pair emitted, the match leaves -> the pad is back; the reference
    emits the same rows at every step."""
    ref, port = _executors("left", capacity=64, fanout=4, out_cap=256)
    acc_r, acc_p = collections.Counter(), collections.Counter()
    for side, rows, want in (
        ("l", [(1, 10, Op.INSERT)], {(1, 10, None, None): 1}),
        ("r", [(1, 77, Op.INSERT)], {(1, 10, 1, 77): 1}),
        ("r", [(1, 77, Op.DELETE)], {(1, 10, None, None): 1}),
    ):
        rc, pc = _chunks(rows, side)
        acc_r = _drain(ref, _apply(ref, side, rc), acc_r)
        acc_p = _drain(port, _apply(port, side, pc), acc_p)
        assert dict(acc_p) == want and acc_p == acc_r
    assert port.side_digests() == _ref_side_digests(ref)


def test_semi_anti_multiplicity():
    """Duplicate left rows each count once per stored copy; extra right
    matches do not multiply the semi output; the anti join retracts
    both copies."""
    for jt, want in (("left_semi", {(1, 10): 2}), ("left_anti", {})):
        ref, port = _executors(jt, capacity=64, fanout=4, out_cap=256)
        acc_r, acc_p = collections.Counter(), collections.Counter()
        for side, rows in (("l", [(1, 10, Op.INSERT), (1, 10, Op.INSERT)]),
                           ("r", [(1, 1, Op.INSERT), (1, 2, Op.INSERT)])):
            rc, pc = _chunks(rows, side)
            acc_r = _drain(ref, _apply(ref, side, rc), acc_r)
            acc_p = _drain(port, _apply(port, side, pc), acc_p)
            assert acc_p == acc_r
        assert dict(acc_p) == want
        assert port.side_digests() == _ref_side_digests(ref)


# -- the step function lane for lane -------------------------------------------------
def _step_sides(fanout=4):
    ldt = {"lk": jnp.int64, "lv": jnp.float64}
    rdt = {"rk": jnp.int64, "rv": jnp.int32}
    ref = (rj.JoinSide.create(128, fanout, (jnp.int64,), ldt),
           rj.JoinSide.create(128, fanout, (jnp.int64,), rdt, nullable=("rv",)))
    port = (pj.JoinSide.create(128, fanout, (torch.int64,),
                               {"lk": torch.int64, "lv": torch.float64}, device="cpu"),
            pj.JoinSide.create(128, fanout, (torch.int64,),
                               {"rk": torch.int64, "rv": torch.int32}, nullable=("rv",),
                               device="cpu"))
    return ref, port


def _assert_sides_equal(ref, port):
    for a, b in zip(ref, port):
        for name in ("row_valid", "degree", "sdirty", "overflow", "inconsistent"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(b.table.live.numpy(), np.asarray(a.table.live))
        for name in a.rows:
            np.testing.assert_array_equal(b.rows[name].numpy(), np.asarray(a.rows[name]))


# (out_cap, key range, fanout) of each case of the step test
STEP_CASES = {"fits": (256, 12, 4), "em_overflow": (8, 12, 4), "cut_in_pairs": (32, 60, 4),
              "cut_in_group2": (40, 60, 4), "n0": (256, 12, 4), "full_buckets": (256, 6, 2)}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_join_step_matches_reference_lane_for_lane(join_type, case):
    """Alternating left/right chunks (deletes, NULL payloads, invalid
    rows) through both join_step_fns: every emitted lane (the three
    groups in the reference's order), the null-lane set, ops, valid,
    the emission latch, and both sides' lanes, degrees included. Cases:
    an output that holds every row; one of 8 rows; one cut inside the
    pairs and one inside group 2 (sparser keys: matched and unmatched
    probe rows in one chunk); chunks of no row (n = 0) among the steps;
    buckets of 2 rows that fill."""
    out_cap, key_range, fanout = STEP_CASES[case]
    rng = np.random.default_rng(11)
    (rl, rr), (pl, pr) = _step_sides(fanout)
    names = ("lk", "lv", "rk", "rv")
    semi_anti = join_type.endswith(("semi", "anti"))
    out_names = (names[:2] if join_type.startswith("left") else names[2:]) if semi_anti else names
    em = torch.zeros((), dtype=torch.bool)
    r_em = False
    cuts = set()
    for step in range(8):
        n = 0 if case == "n0" and step % 3 == 2 else 40
        cap = 48 if n else 8  # no row: only padding (the reference refuses a 0-row chunk)
        keys = rng.integers(0, key_range, n)
        ops = np.where(rng.random(n) < 0.25 * (step > 1), Op.DELETE, Op.INSERT).astype(np.int32)
        arrival = "l" if step % 2 == 0 else "r"
        pairs_on, group2 = _modes(join_type, arrival)[:2]
        other = pr if arrival == "l" else pl
        _, match = pj.probe_side(other, (torch.from_numpy(keys),), torch.ones(n, dtype=torch.bool))
        mc = match.sum(1)
        n_pairs = int(mc.sum()) if pairs_on else 0
        n_g2 = 0 if group2 == pj.G2_NONE else int(((mc > 0) if group2 == pj.G2_SEMI
                                                   else (mc == 0)).sum())
        if n_pairs > out_cap:
            cuts.add("pairs")
        if n_pairs < out_cap < n_pairs + n_g2:
            cuts.add("group2")
        if arrival == "l":
            cols = {"lk": keys, "lv": rng.integers(0, 3, n).astype(np.float64)}
            rc = RefChunk.from_numpy(cols, cap, ops=ops)
            pc = StreamChunk.from_numpy(cols, cap, ops=ops, device="cpu")
            rl, rr, cols_r, nulls_r, ops_r, valid_r, o = ref_join_step(
                rl, rr, rc, ("lk",), ("rk",), ("lk", "lv"), ("rk", "rv"), out_cap, join_type,
                "l", out_names,
            )
            pl, pr, out = join_step_fn(pl, pr, pc, ("lk",), ("lk", "lv"), out_names, out_cap, em,
                                       join_type, arrival="l")
        else:
            cols = {"rk": keys, "rv": rng.integers(0, 3, n).astype(np.int32)}
            nulls = {"rv": rng.random(n) < 0.3}
            rc = RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls)
            pc = StreamChunk.from_numpy(cols, cap, ops=ops, nulls=nulls, device="cpu")
            rr, rl, cols_r, nulls_r, ops_r, valid_r, o = ref_join_step(
                rr, rl, rc, ("rk",), ("lk",), ("rk", "rv"), ("lk", "lv"), out_cap, join_type,
                "r", out_names,
            )
            pr, pl, out = join_step_fn(pr, pl, pc, ("rk",), ("rk", "rv"), out_names, out_cap, em,
                                       join_type, arrival="r")
        r_em = r_em or bool(o)
        for name in out_names:
            np.testing.assert_array_equal(out.col(name).numpy(), np.asarray(cols_r[name]))
        assert set(out.nulls) == set(nulls_r), (set(out.nulls), set(nulls_r))
        for name in nulls_r:
            np.testing.assert_array_equal(out.nulls[name].numpy(), np.asarray(nulls_r[name]))
        np.testing.assert_array_equal(out.ops.numpy(), np.asarray(ops_r))
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(valid_r))
        assert bool(em) == r_em
        _assert_sides_equal((rl, rr), (pl, pr))
    if not semi_anti and case in ("fits", "em_overflow"):  # pairs alone pass 8 rows
        assert r_em == (out_cap == 8)
    if case == "cut_in_pairs" and not semi_anti:
        assert "pairs" in cuts
    if case == "cut_in_group2" and join_type in ("left", "right", "full"):
        assert "group2" in cuts  # pairs, then NULL pads cut by out_cap
    if case == "full_buckets":
        assert bool(pl.overflow) and bool(pr.overflow)
    if join_type != "inner":
        assert bool((pl.degree != 0).any() or (pr.degree != 0).any())


# -- degree_apply lane for lane ----------------------------------------------------------
def test_degree_apply_matches_reference_lane_for_lane():
    """The plain degree_apply against the reference: several probe rows
    on one stored row, U-/U+ netting to zero, a probe key with no slot
    and an invalid row (both dropped), a degree going to 0 and one going
    below 0. trans_pid, went_pos, went_zero and the new degree lane
    equal."""
    cap, fanout = 64, 4
    ref = rj.JoinSide.create(cap, fanout, (jnp.int64,), {"k": jnp.int64, "v": jnp.int64})
    port = pj.JoinSide.create(cap, fanout, (torch.int64,), {"k": torch.int64, "v": torch.int64},
                              device="cpu")
    # stored: key 1 x3, key 2 x1, key 3 x2, key 4 x1
    k = np.array([1, 1, 1, 2, 3, 3, 4], np.int64)
    v = np.arange(7, dtype=np.int64)
    ins = np.ones(7, np.int32)
    ref = rj.apply_side(ref, (jnp.asarray(k),), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, {},
                        jnp.ones(7, bool), jnp.asarray(ins), ("k", "v"))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pj.apply_side(port, (t(k),), {"k": t(k), "v": t(v)}, {}, torch.ones(7, dtype=torch.bool),
                  torch.zeros(7, dtype=torch.int32), ("k", "v"))
    # degrees before the chunk: key 1's rows 0, 1, 2; key 2's 1; key 3's
    # 0 and 3; key 4's 1
    deg = np.zeros((cap, fanout), np.int32)
    for key, degs in ((1, [0, 1, 2]), (2, [1]), (3, [0, 3]), (4, [1])):
        (slot,) = np.flatnonzero((np.asarray(ref.table.keys[0]) == key) & np.asarray(
            ref.table.live))
        deg[slot, :len(degs)] = degs
    ref = rj.JoinSide(ref.table, ref.rows, ref.row_nulls, ref.row_valid, ref.overflow,
                      ref.inconsistent, ref.sdirty, ref.stored, jnp.asarray(deg))
    port.degree.copy_(t(deg))
    # probe rows: key 1 twice (+2: row 0 went_pos), key 2 twice deleted
    # (1 -> -1: went_zero), key 3 U-/U+ (net 0), key 99 (no slot), an
    # invalid key-1 row, key 4 deleted (1 -> 0: went_zero)
    pk = np.array([1, 1, 2, 2, 3, 3, 99, 1, 4], np.int64)
    signs = np.array([1, 1, -1, -1, -1, 1, 1, 1, -1], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0, 1], bool)
    r_sl, r_match = rj.probe_side(ref, (jnp.asarray(pk),), jnp.asarray(valid))
    p_sl, p_match = pj.probe_side(port, (t(pk),), t(valid))
    np.testing.assert_array_equal(p_match.numpy(), np.asarray(r_match))
    eff = np.where(valid, signs, 0).astype(np.int32)
    ref2, r_pid, r_pos, r_zero = rj.degree_apply(ref, r_match, r_sl, jnp.asarray(eff))
    p_pid, p_pos, p_zero = pj.degree_apply(port, p_match, p_sl, t(eff))
    np.testing.assert_array_equal(p_pid.numpy(), np.asarray(r_pid))
    np.testing.assert_array_equal(p_pos.numpy(), np.asarray(r_pos))
    np.testing.assert_array_equal(p_zero.numpy(), np.asarray(r_zero))
    np.testing.assert_array_equal(port.degree.numpy(), np.asarray(ref2.degree))
    assert int(p_pos.sum()) == 1 and int(p_zero.sum()) == 2
    assert int(port.degree.min()) == -1
    sent = cap * fanout
    assert int((p_pid != sent).sum()) == 3 + 1 + 2 + 1  # one lane per distinct matched row


def test_degree_emit_appends_group_three_after_group_two():
    """degree_emit (P's plain version) after probe_pairs (M's): group 3
    starts at M's ``written`` count, the em_overflow latch and the
    join_rows counter cover all three groups, and a capped chunk keeps
    its first out_cap rows."""
    ref_side = pj.JoinSide.create(64, 4, (torch.int64,), {"k": torch.int64, "v": torch.int64},
                                  device="cpu")
    k = torch.tensor([1, 2, 3], dtype=torch.int64)
    pj.apply_side(ref_side, (k,), {"k": k, "v": k * 10}, {}, torch.ones(3, dtype=torch.bool),
                  torch.zeros(3, dtype=torch.int32), ("k", "v"))
    for out_cap, want_ovf in ((16, False), (4, True)):
        other = pj.JoinSide(ref_side.table, {n: a.clone() for n, a in ref_side.rows.items()},
                            {}, ref_side.row_valid.clone(), ref_side.overflow.clone(),
                            ref_side.inconsistent.clone(), ref_side.sdirty.clone(),
                            ref_side.stored.clone(), ref_side.degree.clone())
        pk = torch.tensor([1, 2, 3, 7], dtype=torch.int64)  # three matches, one pad
        ops = torch.zeros(4, dtype=torch.int32)
        em, rows = torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.int64)
        probed = pj.probe_pairs(other, (pk,), torch.ones(4, dtype=torch.bool), ops,
                                {"x": pk}, {}, ("x", "k", "v"), out_cap, em, rows,
                                ("x", "k", "v"), True, pj.G2_OUTER)
        assert int(probed.written) == 4  # 3 pairs + 1 pad
        pj.degree_emit(other, probed, ops, out_cap, em, rows, pj.G3_OUTER)
        assert int(probed.written) == 7 and bool(em) == want_ovf
        assert int(rows) == min(7, out_cap) == int(probed.valid.sum())
        assert other.degree.sum() == 3
        if not want_ovf:  # rows 4..6: each stored row's pad retracted (went_pos -> DELETE)
            np.testing.assert_array_equal(probed.ops[4:7].numpy(), [Op.DELETE] * 3)
            assert bool(probed.nulls["x"][4:7].all()) and not bool(probed.nulls["x"][:3].any())
            assert bool(probed.nulls["k"][3]) and not bool(probed.nulls["k"][4:7].any())


# -- state carried across, and the digest's degree lane -----------------------------------
def _ref_left_join_with_degrees(seed=5):
    """A reference left join after a few chunks of both sides: nonzero
    degrees on both sides. Returns it and the rng."""
    rng = np.random.default_rng(seed)
    ref = RefJoin(["lk"], ["rk"], {"lk": np.int64, "lv": np.int64},
                  {"rk": np.int64, "rv": np.int64}, capacity=64, fanout=8, out_cap=512,
                  join_type="left")
    for side in "lrlr":
        rows = [(int(rng.integers(0, 8)), int(rng.integers(0, 3)), Op.INSERT) for _ in range(10)]
        _apply(ref, side, _chunks(rows, side)[0])
    assert int(np.asarray(ref.left.degree).max()) > 0 and int(np.asarray(ref.right.degree).max()) > 0
    return ref, rng


def test_join_state_carried_across_matches_lane_for_lane():
    """A reference left join with nonzero degrees, carried into the port
    through ``load_reference_state`` (every key in its slot, every row
    at its position with its degree); then the same chunks, inserts and
    deletes of stored rows, through both: the same rows emitted, chunk
    by chunk and lane for lane, and equal sides at the end."""
    import jax

    ref, rng = _ref_left_join_with_degrees()
    port = HashJoinExecutor(["lk"], ["rk"], L_DT, R_DT, capacity=64, fanout=8, out_cap=512,
                            join_type="left", device="cpu")
    port.load_reference_state({"left": jax.device_get(ref.left),
                               "right": jax.device_get(ref.right)})
    _assert_sides_equal((ref.left, ref.right), (port.left, port.right))
    assert port.side_digests() == _ref_side_digests(ref)
    for side in "rlrl":
        keys = rng.integers(0, 8, 10)
        rows = [(int(k), int(rng.integers(0, 3)), Op.DELETE if rng.random() < 0.3 else Op.INSERT)
                for k in keys]
        # deletes only of stored rows: the reference's side as the record
        s = ref.left if side == "l" else ref.right
        name = "lv" if side == "l" else "rv"
        stored = {(int(k), int(v)) for k, v, ok in zip(
            np.asarray(s.rows["lk" if side == "l" else "rk"]).ravel(),
            np.asarray(s.rows[name]).ravel(), np.asarray(s.row_valid).ravel()) if ok}
        rows = [r for r in rows if r[2] == Op.INSERT or (r[0], r[1]) in stored]
        rc, pc = _chunks(rows, side)
        (r_out,), (p_out,) = _apply(ref, side, rc), _apply(port, side, pc)
        for name in ref.out_names:
            np.testing.assert_array_equal(p_out.col(name).numpy(), np.asarray(r_out.col(name)))
        assert set(p_out.nulls) == set(r_out.nulls)
        for name in r_out.nulls:
            np.testing.assert_array_equal(p_out.nulls[name].numpy(),
                                          np.asarray(r_out.nulls[name]))
        np.testing.assert_array_equal(p_out.ops.numpy(), np.asarray(r_out.ops))
        np.testing.assert_array_equal(p_out.valid.numpy(), np.asarray(r_out.valid))
    _assert_sides_equal((ref.left, ref.right), (port.left, port.right))
    ref.on_barrier(None)
    port.on_barrier(None)


def test_join_side_digest_folds_nonzero_degrees_as_the_reference():
    """``integrity.join_side_lanes`` folds the degree lane: with nonzero
    degrees both sides' digests equal the reference's, and a changed
    degree of a live row changes the digest (a dead entry's does not)."""
    import jax

    ref, _ = _ref_left_join_with_degrees(seed=9)
    port = HashJoinExecutor(["lk"], ["rk"], L_DT, R_DT, capacity=64, fanout=8, out_cap=512,
                            join_type="left", device="cpu")
    port.load_reference_state({"left": jax.device_get(ref.left),
                               "right": jax.device_get(ref.right)})
    before = port.side_digests()
    assert before == _ref_side_digests(ref)
    live = torch.nonzero(port.left.row_valid.view(-1)).flatten()
    dead = torch.nonzero(~port.left.row_valid.view(-1)).flatten()
    port.left.degree.view(-1)[dead[0]] += 5
    assert port.side_digests() == before
    port.left.degree.view(-1)[live[0]] += 1
    assert port.side_digests()[0] != before[0] and port.side_digests()[1] == before[1]


# -- the fused two-input program over the join types that ran only per step ----------
FUSED_TYPES = ("right", "full", "left_semi", "left_anti", "right_semi", "right_anti")


def _q101_shape(port: bool, join_type: str, cap: int = 1 << 10, big: int = 1 << 14):
    """q101's plan shape with another join type: auctions (id,
    item_name) left with no executor, a HashAgg MAX(price) by auction
    right, the join on id = auction, a device MV keyed on the emitted
    stream key (both sides' keys, or the driving side's key of a semi
    or anti join). Returns (pipeline, agg, join, mview)."""
    if port:
        from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor as Agg
        from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor as MV
        from risingwave_tpu_torch.ops.agg import AggCall as Call
        from risingwave_tpu_torch.runtime.pipeline import TwoInputPipeline as P2

        i32, i64, dev, join_cls = torch.int32, torch.int64, {"device": "cpu"}, HashJoinExecutor
    else:
        from risingwave_tpu.executors.hash_agg import HashAggExecutor as Agg
        from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor as MV
        from risingwave_tpu.ops.agg import AggCall as Call
        from risingwave_tpu.runtime import TwoInputPipeline as P2

        i32, i64, dev, join_cls = jnp.int32, jnp.int64, {}, RefJoin
    dts = {"id": i64, "item_name": i32, "auction": i64, "max_price": i64}
    agg = Call("max", "price", "max_price")
    agg = Agg(group_keys=("auction",), calls=(agg,), schema_dtypes={"auction": i64, "price": i64},
              capacity=cap, out_cap=cap >> 1, table_id="jt.maxbid", **dev)
    join = join_cls(("id",), ("auction",), {"id": i64, "item_name": i32},
                    {"auction": i64, "max_price": i64}, capacity=big >> 1, fanout=4,
                    out_cap=1 << 10,
                    right_nullable=("max_price",), join_type=join_type, table_id="jt.join", **dev)
    if join_type.endswith(("semi", "anti")):
        pk = ("id",) if join_type.startswith("left") else ("auction",)
    else:
        pk = ("id", "auction")
    cols = tuple(c for c in join.out_names if c not in pk)
    mview = MV(pk=pk, columns=cols, schema_dtypes={c: dts[c] for c in pk + cols},
               nullable=tuple(c for c in cols if c in ("item_name", "max_price")),
               capacity=big, table_id="jt.mview", **dev)
    return P2([], [agg], join, [mview]), agg, join, mview


def _auction_bid_stream(epochs=3, events=2000, seed=5):
    """Per epoch the auctions and bids of ``events`` generated events,
    every fifth auction withheld: its bids find no auction, so the
    right-driven types (right, full, right_anti) emit unmatched rows."""
    from risingwave_tpu.connectors.nexmark import NexmarkConfig, NexmarkGenerator

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=seed)
    out = []
    for _ in range(epochs):
        ev = gen.next_events(events)
        keep = ev["auction"]["id"] % 5 != 0
        out.append(({k: ev["auction"][k][keep] for k in ("id", "item_name")},
                    {k: ev["bid"][k] for k in ("auction", "price")}))
    return out


def _drive_q101_shape(pipeline, epoch, port: bool, a_cap: int = 512, b_cap: int = 1024):
    mk = (lambda c, cap: StreamChunk.from_numpy(c, cap, device="cpu")) if port else (
        lambda c, cap: RefChunk.from_numpy(c, cap))
    auctions, bids = epoch
    pipeline.push_left(mk(auctions, a_cap))
    for lo in range(0, len(bids["auction"]), b_cap):
        pipeline.push_right(mk({k: v[lo:lo + b_cap] for k, v in bids.items()}, b_cap))
    pipeline.barrier()


def _digests(agg, join, mview, port: bool):
    if port:
        from risingwave_tpu_torch import integrity

        host = lambda ll: integrity.host_digest(*integrity.host_lanes(*ll))
        jl, jr = join.side_digests()
        return (host(integrity.agg_lanes(agg.table, agg.state, ())), jl, jr,
                host(integrity.mv_lanes(mview.table, mview.state)))
    np_lanes = lambda lanes, live: ({k: np.asarray(v) for k, v in lanes.items()},
                                    np.asarray(live))
    host = lambda ll: ref_integrity.host_digest(*np_lanes(*ll))
    return (host(ref_integrity.agg_lanes(agg.table, agg.state)), *_ref_side_digests(join),
            host(ref_integrity.mv_lanes(mview.table, mview.state)))


@pytest.mark.parametrize("join_type", FUSED_TYPES)
def test_fused_two_input_join_type_matches_reference(join_type):
    """q101's plan shape under each join type that ran only per step,
    both packages through their fused two-input program: MV snapshot,
    the agg, join-side and MV digests, the staged digests and the
    telemetry counters equal at every barrier; the port's fused MV
    equals its interpreted MV; the stream makes every type emit rows
    (right_anti: the bids of withheld auctions)."""
    from risingwave_tpu.runtime.fused_step import fuse_pipeline as ref_fuse
    from risingwave_tpu_torch.runtime.fused_step import FusedTwoInputExecutor, fuse_pipeline

    ref, port, interp = (_q101_shape(False, join_type), _q101_shape(True, join_type),
                         _q101_shape(True, join_type))
    (rw,) = ref_fuse(ref[0], label="jt")
    (pw,) = fuse_pipeline(port[0], label="jt")
    assert isinstance(pw, FusedTwoInputExecutor) and pw.plan.j_type == join_type
    for epoch in _auction_bid_stream():
        _drive_q101_shape(ref[0], epoch, port=False)
        _drive_q101_shape(port[0], epoch, port=True)
        _drive_q101_shape(interp[0], epoch, port=True)
        assert port[3].snapshot() == ref[3].snapshot() == interp[3].snapshot()
        assert _digests(*port[1:], port=True) == _digests(*ref[1:], port=False)
        assert pw.last_digests == rw.last_digests
        tel = {k: rw._telemetry[k]
               for k in ("rows_left", "rows_right", "join_rows", "dirty_groups", "mv_rows")}
        assert {k: pw.last_telemetry[k] for k in tel} == tel
    assert len(port[3].snapshot()) > 0
