"""Kernels F and G parity: the epoch path's ``reduce_by_key`` and
``apply_reduced`` against ``risingwave_tpu.ops.agg``, and the epoch path
of the port's HashAgg (``apply_stacked``) against its scan twin, the
reference and a python oracle (mirrors ``test_agg_reduce_path.py``).

The port runs its plain PyTorch versions. Tolerance: every integer lane,
fingerprint order and flag is exact (both sorts are stable, so the
permutation is the reference's); a float64 SUM lane agrees to a
relative 1e-12, because XLA and torch add a segment's rows in another
order; a float32 SUM lane (the hard cases) to 4 sqrt(n) 2^-24 of the
segment's sum of magnitudes, the size of n float32 roundings in either
order (``chip_smoke.py``'s rule for kernels Y and F).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors.hash_agg import HashAggExecutor as RefHashAgg
from risingwave_tpu.ops import agg as ref
from risingwave_tpu.parallel.sharded_agg import stack_chunks as ref_stack
from risingwave_tpu_torch.array.chunk import StreamChunk, stack_chunks
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.ops import agg as port
from risingwave_tpu_torch.types import Op
from test_torch_agg import _port_lanes_as_reference, _ref_lanes

CAP = 1 << 10
CALLS = (
    ("count_star", None, "n"),
    ("count", "v", "cv"),
    ("sum", "v", "sv"),
    ("sum", "w", "sw"),
    ("sum", "f", "sf"),
    ("min", "v", "mnv"),
    ("max", "w", "mxw"),
    ("min", "f", "mnf"),
    ("max", "g", "mxg"),
)
REF_DTYPES = {"v": jnp.int64, "w": jnp.int32, "f": jnp.float64, "g": jnp.float32}
PORT_DTYPES = {"v": torch.int64, "w": torch.int32, "f": torch.float64, "g": torch.float32}
FLOAT_SUMS = ("sum_sf", "accums.sf")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _calls(kinds):
    return tuple(ref.AggCall(*c) for c in kinds), tuple(port.AggCall(*c) for c in kinds)


def _keys(rng, n, kind):
    if kind == "int64":
        return (rng.integers(0, 40, n).astype(np.int64),)
    if kind == "int32_int64":
        return (rng.integers(-4, 4, n).astype(np.int32), rng.integers(0, 6, n).astype(np.int64))
    f = rng.integers(-6, 6, n) / 2.0
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.1] = 0.0
    return (f, rng.integers(0, 3, n).astype(np.int64))


def _rows(rng, n):
    signs = np.where(rng.random(n) < 0.75, 1, -1).astype(np.int32)
    signs[rng.random(n) < 0.15] = 0  # invisible rows
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.05] = np.nan
    values = {
        "v": rng.integers(-(10**9), 10**9, n).astype(np.int64),
        "w": rng.integers(-1000, 1000, n).astype(np.int32),
        "f": f,
        "g": rng.standard_normal(n).astype(np.float32),
    }
    nulls = {"v": rng.random(n) < 0.15, "f": rng.random(n) < 0.15}
    return signs, values, nulls


def _port_reduce(keys, signs, calls, values, nulls):
    t = torch.from_numpy
    return port.reduce_by_key(
        tuple(t(k) for k in keys), t(signs), calls,
        {k: t(v) for k, v in values.items()}, {k: t(v) for k, v in nulls.items()},
    )


def _ref_reduce(keys, signs, calls, values, nulls):
    j = jnp.asarray
    out = ref.reduce_by_key(
        tuple(j(k) for k in keys), j(signs), calls,
        {k: j(v) for k, v in values.items()}, {k: j(v) for k, v in nulls.items()},
    )
    return jax.device_get(out)


def _assert_lane(name, p, r):
    if name in FLOAT_SUMS:
        np.testing.assert_allclose(p, r, rtol=1e-12, atol=0, equal_nan=True, err_msg=name)
    else:
        np.testing.assert_array_equal(p, r, err_msg=name)


@pytest.mark.parametrize("key_kind", ["int64", "int32_int64", "float64_nan"])
def test_reduce_by_key_matches_reference_lane_for_lane(key_kind):
    rng = np.random.default_rng({"int64": 1, "int32_int64": 2, "float64_nan": 3}[key_kind])
    rcalls, pcalls = _calls(CALLS)
    fx = dict(port.float_extreme_meta(pcalls, PORT_DTYPES))
    n = 1500
    keys = _keys(rng, n, key_kind)
    signs, values, nulls = _rows(rng, n)
    r_keys, r_rep, r_w, r_red, r_mret = _ref_reduce(keys, signs, rcalls, values, nulls)
    p_keys, p_rep, p_w, p_red, p_mret = _port_reduce(keys, signs, pcalls, values, nulls)
    for i, (pk, rk) in enumerate(zip(p_keys, r_keys)):
        np.testing.assert_array_equal(pk.numpy(), np.asarray(rk), err_msg=f"key{i}")
        # the same rows in the same order: bit for bit, -0.0 and NaN included
        assert pk.numpy().tobytes() == np.asarray(rk).tobytes()
    np.testing.assert_array_equal(p_rep.numpy(), np.asarray(r_rep))
    np.testing.assert_array_equal(p_w.numpy(), np.asarray(r_w))
    assert p_red.keys() == r_red.keys()
    for name, lane in p_red.items():
        out = name.split("_", 1)[1]
        a = lane.numpy()
        if name.startswith("ext_") and out in fx:
            a = port.order_key_to_reference(a, np.dtype(str(fx[out]).split(".")[1]))
        _assert_lane(name, a, np.asarray(r_red[name]))
    assert bool(p_mret) == bool(r_mret) is True
    assert 0 < int(p_rep.sum()) < n  # segments merged rows; invisible rows are no reps


def _reference_state(rng, rcalls):
    """A reference state with some history, and its port copy."""
    rs = ref.create_state(CAP, rcalls, REF_DTYPES)
    n = 400
    slots = rng.integers(0, CAP // 2, n).astype(np.int32)
    signs, values, nulls = _rows(rng, n)
    signs = np.abs(signs)  # history without retractions
    rs = ref.apply(
        rs, rcalls, jnp.asarray(slots), jnp.asarray(signs),
        {k: jnp.asarray(v) for k, v in values.items()},
        {k: jnp.asarray(v) for k, v in nulls.items()},
    )
    return rs


def test_apply_reduced_matches_reference_on_carried_state():
    rng = np.random.default_rng(5)
    rcalls, pcalls = _calls(CALLS)
    pfx = port.float_extreme_meta(pcalls, PORT_DTYPES)
    fx = dict(pfx)
    rs = _reference_state(rng, rcalls)
    ps = port.AggState.from_reference_arrays(jax.device_get(rs), pfx, device="cpu")
    n = 900
    keys = _keys(rng, n, "int64")
    signs, values, nulls = _rows(rng, n)
    r_keys, r_rep, r_w, r_red, r_mret = _ref_reduce(keys, signs, rcalls, values, nulls)
    # slots: a few representatives share a slot, some rows have none (-1)
    slots = rng.integers(0, CAP // 2, n).astype(np.int32)
    slots[np.flatnonzero(np.asarray(r_rep))[::25]] = -1
    p_red = {}
    for name, lane in r_red.items():
        out = name.split("_", 1)[1]
        a = np.asarray(lane)
        if name.startswith("ext_") and out in fx:
            a = port.order_key_from_reference(a)
        p_red[name] = torch.from_numpy(np.array(a))
    rs = ref.apply_reduced(
        rs, rcalls, jnp.asarray(slots), jnp.asarray(r_rep), jnp.asarray(r_w),
        {k: jnp.asarray(v) for k, v in r_red.items()}, jnp.asarray(r_mret),
    )
    before = {k: np.array(v) for k, v in _port_lanes_as_reference(ps, fx).items()}
    port.apply_reduced(
        ps, pcalls, torch.from_numpy(slots), torch.from_numpy(np.array(r_rep)),
        torch.from_numpy(np.array(r_w)), p_red, torch.tensor(bool(r_mret)),
    )
    r, p = _ref_lanes(rs), _port_lanes_as_reference(ps, fx)
    assert r.keys() == p.keys()
    for k in r:
        _assert_lane(k, p[k], np.asarray(r[k]))
    # a dropped representative (slot -1) and a non-representative write
    # nothing: untouched slots keep every lane
    touched = np.zeros(CAP, bool)
    act = np.asarray(r_rep) & (slots >= 0)
    touched[slots[act]] = True
    for k, lane in before.items():
        if lane.shape == (CAP,):
            np.testing.assert_array_equal(p[k][~touched], lane[~touched], err_msg=k)
    assert (slots[np.asarray(r_rep)] < 0).any()


def test_apply_reduced_sets_live_from_row_count():
    _, pcalls = _calls((("count_star", None, "n"),))
    ps = port.create_state(16, pcalls, {}, device="cpu")
    live = torch.zeros(16, dtype=torch.bool)
    slots = torch.tensor([3, 3, 5, -1, 7], dtype=torch.int32)
    rep = torch.tensor([True, True, True, True, False])
    w = torch.tensor([2, -1, -1, 4, 9])
    port.apply_reduced(ps, pcalls, slots, rep, w, {}, torch.tensor(False), live=live)
    assert ps.row_count[[3, 5, 7]].tolist() == [1, -1, 0]
    assert live.nonzero().flatten().tolist() == [3]
    assert ps.dirty.nonzero().flatten().tolist() == [3, 5]


# -- the epoch path of the executor (mirrors test_agg_reduce_path.py) --------
AGG_CALLS = (
    ("count_star", None, "cnt"),
    ("count", "v", "cv"),
    ("sum", "v", "s"),
    ("min", "v", "mn"),
    ("max", "f", "mx"),
)


def _mk_chunks(rng, n_chunks, cap, nkeys=40):
    out = []
    for _ in range(n_chunks):
        n = int(rng.integers(cap // 2, cap + 1))
        cols = {
            "k": rng.integers(0, nkeys, n).astype(np.int64),
            "v": rng.integers(-50, 100, n).astype(np.int64),
            "f": rng.normal(size=n),
        }
        nulls = {"v": rng.random(n) < 0.2, "f": rng.random(n) < 0.2}
        out.append((cols, nulls, cap))
    return out


def _port_agg(calls=AGG_CALLS, dtypes=None):
    dtypes = dtypes or {"k": torch.int64, "v": torch.int64, "f": torch.float64}
    return HashAggExecutor(
        ["k"], tuple(port.AggCall(*c) for c in calls), dtypes,
        capacity=1 << 10, out_cap=1 << 9, device="cpu",
    )


def _port_stack(raw):
    return stack_chunks([
        StreamChunk.from_numpy(c, cap, nulls=nl, device="cpu") for c, nl, cap in raw
    ])


def _snapshot(ex):
    live = ex.table.live.numpy()
    k = ex.table.keys[0].numpy()[live].tolist()
    out = {}
    for name, lane in ex.state.accums.items():
        out[name] = dict(zip(k, lane.numpy()[live].tolist()))
    for name, lane in ex.state.nonnull.items():
        out[f"nn_{name}"] = dict(zip(k, lane.numpy()[live].tolist()))
    return out


def _run(mode, seed, epochs=3):
    rng = np.random.default_rng(seed)
    ex = _port_agg()
    for _ in range(epochs):
        ex.apply_stacked(_port_stack(_mk_chunks(rng, 4, 128)), mode=mode)
        ex.on_barrier(None)
    return _snapshot(ex)


def test_reduce_matches_scan():
    assert _run("reduce", 3) == _run("scan", 3)


def test_epoch_path_matches_reference_executor():
    """The same stacked epochs through both executors' reduce path: the
    live groups' accumulators and the agg state digests agree."""
    from risingwave_tpu import integrity as ref_integrity
    from risingwave_tpu_torch import integrity

    rng = np.random.default_rng(9)
    ex = _port_agg()
    rx = RefHashAgg(
        ["k"], tuple(ref.AggCall(*c) for c in AGG_CALLS),
        {"k": np.int64, "v": np.int64, "f": np.float64}, capacity=1 << 10, out_cap=1 << 9,
    )
    for _ in range(2):
        raw = _mk_chunks(rng, 4, 128)
        ex.apply_stacked(_port_stack(raw), mode="reduce")
        rx.apply_stacked(
            ref_stack([RefChunk.from_numpy(c, cap, nulls=nl) for c, nl, cap in raw]), mode="reduce"
        )
        ex.on_barrier(None)
        rx.on_barrier(None)
        rx.finish_barrier()
        rl, rlive = ref_integrity.agg_lanes(rx.table, rx.state)
        r_dig = ref_integrity.host_digest(
            {k: np.asarray(v) for k, v in rl.items()}, np.asarray(rlive)
        )
        pl, plive = integrity.agg_lanes(ex.table, ex.state, ex._float_extremes)
        assert integrity.host_digest(*integrity.host_lanes(pl, plive)) == r_dig
    live = np.asarray(rx.table.live)
    rk = np.asarray(rx.table.keys[0])[live].tolist()
    ref_cnt = dict(zip(rk, np.asarray(rx.state.accums["cnt"])[live].tolist()))
    assert _snapshot(ex)["cnt"] == ref_cnt


def test_reduce_matches_oracle_append_only():
    rng = np.random.default_rng(11)
    ex = _port_agg()
    cnt, cv, s = {}, {}, {}
    for _ in range(2):
        raw = _mk_chunks(rng, 3, 64)
        ex.apply_stacked(_port_stack(raw), mode="reduce")
        ex.on_barrier(None)
        for cols, nulls, _ in raw:
            for i, key in enumerate(cols["k"].tolist()):
                cnt[key] = cnt.get(key, 0) + 1
                if not nulls["v"][i]:
                    cv[key] = cv.get(key, 0) + 1
                    s[key] = s.get(key, 0) + int(cols["v"][i])
    got = _snapshot(ex)
    assert got["cnt"] == cnt
    assert got["cv"] == cv
    assert got["s"] == s


def test_reduce_with_retractions_sum_count():
    ex = _port_agg(
        calls=(("count_star", None, "cnt"), ("sum", "v", "s")),
        dtypes={"k": torch.int64, "v": torch.int64},
    )
    cols = {"k": np.array([1, 1, 2, 2, 1], np.int64), "v": np.array([10, 20, 5, 7, 10], np.int64)}
    ops = np.array([Op.INSERT, Op.INSERT, Op.INSERT, Op.DELETE, Op.DELETE], np.int32)
    c = StreamChunk.from_numpy(cols, 8, ops=ops, device="cpu")
    ex.apply_stacked(stack_chunks([c]), mode="reduce")
    ex.on_barrier(None)
    live = ex.table.live.numpy()
    got = dict(zip(
        ex.table.keys[0].numpy()[live].tolist(),
        zip(ex.state.accums["cnt"].numpy()[live].tolist(), ex.state.accums["s"].numpy()[live].tolist()),
    ))
    assert got == {1: (1, 20)}  # k=2 netted to zero rows -> dead group


def test_reduce_minmax_retraction_latches():
    ex = _port_agg(calls=(("min", "v", "mn"),), dtypes={"k": torch.int64, "v": torch.int64})
    c = StreamChunk.from_numpy(
        {"k": np.array([1, 1], np.int64), "v": np.array([5, 5], np.int64)}, 4,
        ops=np.array([Op.INSERT, Op.DELETE], np.int32), device="cpu",
    )
    ex.apply_stacked(stack_chunks([c]), mode="reduce")
    with pytest.raises(RuntimeError, match="retraction hit an append-only MIN/MAX"):
        ex.on_barrier(None)


def test_fingerprint_collision_keys_not_merged(monkeypatch):
    """Different keys forced onto one fingerprint stay separate groups:
    the raw key lanes split the sorted segment. The stable sort keeps
    colliding rows in row order, so one key may split into several
    segments; per-key sums still come out right."""
    from risingwave_tpu_torch.ops import hashing

    real = hashing.hash128

    def colliding(key_cols):
        h1, _ = real(key_cols)
        return torch.full_like(h1, 7), torch.full_like(h1, 9)

    monkeypatch.setattr(hashing, "hash128", colliding)
    keys = (torch.tensor([3, 5, 3, 5, 5], dtype=torch.int64),)
    signs = torch.ones(5, dtype=torch.int32)
    sorted_keys, rep_valid, w, _, _ = port.reduce_by_key(
        keys, signs, (port.AggCall("count_star", None, "c"),), {}, {}
    )
    reps = sorted_keys[0][rep_valid].tolist()
    assert reps == [3, 5, 3, 5]  # row order kept under the collision
    got = {}
    for k, v in zip(reps, w[rep_valid].tolist()):
        got[k] = got.get(k, 0) + v
    assert got == {3: 2, 5: 3}


# -- F's hard cases: the plain version against the reference on the shapes
# chip_smoke.py's phase 3 holds kernel F to (a hot key across many
# 2048-row tiles of F's reduce, one key, no visible row, forced fingerprint
# collisions, n of 0, 1 and one past a tile)
HARD_ROWS = 5 * 2048 + 17
HARD_CALLS = CALLS + (("sum", "g", "sg"),)


def _hard_rows(rng, n, k=None, f=None, signs=None):
    keys = (rng.integers(0, 300, n).astype(np.int64) if k is None else k,
            rng.choice(np.array([0.0, -0.0, 1.5, np.nan]), n) if f is None else f)
    if signs is None:
        signs, values, nulls = _rows(rng, n)
    else:
        _, values, nulls = _rows(rng, n)
    values["f"] = np.abs(values["f"]) + 1.0  # no NaN: every float sum compares
    return keys, signs, values, nulls


def _hard_case(case, rng):
    n = HARD_ROWS
    if case == "hot_key_across_tiles":
        k = rng.integers(0, 300, n).astype(np.int64)
        f = rng.choice(np.array([0.0, 1.5]), n)
        hot = rng.random(n) < 0.7
        k[hot] = 7
        f[hot] = np.where(rng.random(int(hot.sum())) < 0.5, 0.0, -0.0)
        return _hard_rows(rng, n, k, f)
    if case == "one_key":
        return _hard_rows(rng, n, np.full(n, 5, np.int64), np.full(n, np.nan),
                          np.ones(n, np.int32))
    if case == "every_row_invisible":
        return _hard_rows(rng, n, signs=np.zeros(n, np.int32))
    return _hard_rows(rng, {"n_1": 1, "n_2049": 2049, "collisions": n}[case])


def _colliding(xp):
    """A hash128 whose fingerprints collide across keys, some visible rows
    on the all-ones pair (they sort among the invisible rows)."""
    def fingerprints(key_lanes):
        k = key_lanes[0]
        h1 = xp.where(k % 3 == 0, 3, xp.where(k % 3 == 1, 9, 0xFFFFFFFF))
        h2 = xp.where(k % 2 == 0, 1, 0xFFFFFFFF)
        if xp is jnp:
            return h1.astype(jnp.uint32), h2.astype(jnp.uint32)
        return h1.to(torch.int64), h2.to(torch.int64)
    return fingerprints


@pytest.mark.parametrize("case", ["hot_key_across_tiles", "one_key", "every_row_invisible",
                                  "collisions", "n_1", "n_2049"])
def test_reduce_by_key_hard_cases_match_reference(case, monkeypatch):
    from risingwave_tpu.ops import hashing as ref_hashing
    from risingwave_tpu_torch.ops import hashing as port_hashing

    rng = np.random.default_rng(len(case))
    keys, signs, values, nulls = _hard_case(case, rng)
    if case == "collisions":
        monkeypatch.setattr(ref_hashing, "hash128", _colliding(jnp))
        monkeypatch.setattr(port_hashing, "hash128", _colliding(torch))
    rcalls, pcalls = _calls(HARD_CALLS)
    fx = dict(port.float_extreme_meta(pcalls, PORT_DTYPES))
    n = len(signs)
    r_keys, r_rep, r_w, r_red, r_mret = _ref_reduce(keys, signs, rcalls, values, nulls)
    p_out = _port_reduce(keys, signs, pcalls, values, nulls)
    again = _port_reduce(keys, signs, pcalls, values, nulls)
    p_keys, p_rep, p_w, p_red, p_mret = p_out
    for a, b in zip(p_keys + (p_rep, p_w, p_mret) + tuple(p_red.values()),
                    again[0] + (again[1], again[2], again[4]) + tuple(again[3].values())):
        assert a.numpy().tobytes() == b.numpy().tobytes()  # the same bits twice
    for pk, rk in zip(p_keys, r_keys):
        assert pk.numpy().tobytes() == np.asarray(rk).tobytes()
    np.testing.assert_array_equal(p_rep.numpy(), np.asarray(r_rep))
    np.testing.assert_array_equal(p_w.numpy(), np.asarray(r_w))
    assert bool(p_mret) == bool(r_mret)
    mags = _port_reduce(keys, np.abs(signs), pcalls,
                        dict(values, f=np.abs(values["f"]), g=np.abs(values["g"]).astype(np.float64)),
                        nulls)[3]
    assert p_red.keys() == r_red.keys()
    for name, lane in p_red.items():
        a, b = lane.numpy(), np.asarray(r_red[name])
        out = name.split("_", 1)[1]
        if name.startswith("ext_") and out in fx:
            a = port.order_key_to_reference(a, np.dtype(str(fx[out]).split(".")[1]))
        if name == "sum_sg":
            tol = 4 * n ** 0.5 * 2.0**-24 * mags[name].numpy()
            assert (np.abs(a.astype(np.float64) - b.astype(np.float64)) <= tol).all(), name
        else:
            _assert_lane(name, a, b)
    if case == "one_key":
        assert int(p_rep.sum()) == 1
    if case == "every_row_invisible":
        assert not p_rep.any() and not bool(p_mret)
    if case == "hot_key_across_tiles":  # one segment over more than two tiles
        assert int(((keys[0] == 7) & (signs != 0)).sum()) > 2 * 2048
        assert int(p_rep[(p_keys[0] == 7) & (p_keys[1] == 0)].sum()) == 1


def test_reduce_by_key_of_no_rows():
    """n = 0 (the reference's boundary concat needs a row): empty lanes of
    the right dtypes, no representative, the latch clear."""
    _, pcalls = _calls(HARD_CALLS)
    keys, signs, values, nulls = _hard_rows(np.random.default_rng(0), 0)
    p_keys, p_rep, p_w, p_red, p_mret = _port_reduce(keys, signs, pcalls, values, nulls)
    assert [k.dtype for k in p_keys] == [torch.int64, torch.float64]
    assert p_rep.shape == p_w.shape == (0,) and not bool(p_mret)
    assert all(v.shape == (0,) for v in p_red.values())
