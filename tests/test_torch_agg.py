"""Kernels B and C parity: agg ``apply`` + ``flush`` against ``risingwave_tpu.ops.agg``.

Same numpy-seeded slots, signs, values and NULLs into both; the port runs
its plain PyTorch versions. Every comparison is exact: the lanes are
integers (float MIN/MAX are exact total-order keys, and the port's int64
key lanes are mapped back to the reference's unsigned ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.ops import agg as ref
from risingwave_tpu_torch.ops import agg as port

CAP = 1 << 10

CALLS = (
    ("count_star", None, "n"),
    ("count", "v", "cv"),
    ("sum", "v", "sv"),
    ("sum", "w", "sw"),
    ("min", "v", "mnv"),
    ("max", "w", "mxw"),
    ("min", "f", "mnf"),
    ("max", "g", "mxg"),
)
REF_DTYPES = {"v": jnp.int64, "w": jnp.int32, "f": jnp.float64, "g": jnp.float32}
PORT_DTYPES = {"v": torch.int64, "w": torch.int32, "f": torch.float64, "g": torch.float32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _calls(kinds):
    return (
        tuple(ref.AggCall(*c) for c in kinds),
        tuple(port.AggCall(*c) for c in kinds),
    )


def _batch(rng, n, retract):
    slots = rng.integers(-1, CAP // 4, n).astype(np.int32)  # -1: dropped rows
    signs = np.where(rng.random(n) < 0.9, 1, 0).astype(np.int32)
    if retract:
        signs[rng.random(n) < 0.25] = -1
    f = rng.standard_normal(n)
    f[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
    values = {
        "v": rng.integers(-(10**9), 10**9, n).astype(np.int64),
        "w": rng.integers(-1000, 1000, n).astype(np.int32),
        "f": f,
        "g": rng.standard_normal(n).astype(np.float32),
    }
    nulls = {k: rng.random(n) < 0.15 for k in ("v", "f")}
    return slots, signs, values, nulls


def _port_lanes_as_reference(state, fx):
    """The port's state lanes in the reference's representation."""
    out = {"row_count": state.row_count.numpy()}
    for group in ("accums", "emitted"):
        for name, lane in getattr(state, group).items():
            a = lane.numpy()
            out[f"{group}.{name}"] = (
                port.order_key_to_reference(a, np.dtype(str(fx[name]).split(".")[1]))
                if name in fx
                else a
            )
    for group in ("nonnull", "emitted_isnull"):
        for name, lane in getattr(state, group).items():
            out[f"{group}.{name}"] = lane.numpy()
    for name in ("emitted_valid", "dirty", "minmax_retracted", "sdirty", "stored"):
        out[name] = getattr(state, name).numpy()
    return out


def _ref_lanes(state):
    s = jax.device_get(state)
    out = {"row_count": s.row_count}
    for group in ("accums", "emitted", "nonnull", "emitted_isnull"):
        for name, lane in getattr(s, group).items():
            out[f"{group}.{name}"] = lane
    for name in ("emitted_valid", "dirty", "minmax_retracted", "sdirty", "stored"):
        out[name] = getattr(s, name)
    return out


def _assert_states_equal(rs, ps, fx):
    r, p = _ref_lanes(rs), _port_lanes_as_reference(ps, fx)
    assert r.keys() == p.keys()
    for k in r:
        np.testing.assert_array_equal(p[k], np.asarray(r[k]), err_msg=k)


def _apply_both(rs, ps, rcalls, pcalls, slots, signs, values, nulls):
    rs = ref.apply(
        rs, rcalls, jnp.asarray(slots), jnp.asarray(signs),
        {k: jnp.asarray(v) for k, v in values.items()},
        {k: jnp.asarray(v) for k, v in nulls.items()},
    )
    port.apply(
        ps, pcalls, torch.from_numpy(slots), torch.from_numpy(signs),
        {k: torch.from_numpy(v) for k, v in values.items()},
        {k: torch.from_numpy(v) for k, v in nulls.items()},
    )
    return rs, ps


def _delta_rows(delta, n_take, names):
    """The valid rows of a delta, as sorted tuples (a multiset)."""
    rows = []
    ops = np.asarray(delta["ops"])[: 2 * n_take]
    valid = np.asarray(delta["valid"])[: 2 * n_take]
    lanes = [np.asarray(delta[n])[: 2 * n_take] for n in names]
    for i in np.flatnonzero(valid):
        rows.append((int(ops[i]),) + tuple(
            "nan" if isinstance(x, float) and np.isnan(x) else x
            for x in (lane[i].item() for lane in lanes)
        ))
    return rows


def _flush_both(rs, ps, keys, out_cap, rfx, pfx, names):
    """Flush rounds until no overflow; deltas equal per round (as
    multisets and in order), status equal."""
    rounds = 0
    while True:
        rs, rd = ref.flush(rs, tuple(jnp.asarray(k) for k in keys), out_cap, rfx)
        ps, pd = port.flush(ps, tuple(torch.from_numpy(k) for k in keys), out_cap, pfx)
        r_status = np.asarray(rd["status"]).tolist()
        assert pd["status"].tolist() == r_status
        n_take, overflow = r_status
        r_rows = _delta_rows(rd, n_take, names)
        p_rows = _delta_rows(pd, n_take, names)
        assert p_rows == r_rows  # ascending slot order in both
        assert sorted(map(str, p_rows)) == sorted(map(str, r_rows))
        rounds += 1
        if not overflow:
            return rs, ps, rounds


@pytest.mark.parametrize("retract", [False, True])
def test_apply_and_flush_all_kinds(retract):
    rng = np.random.default_rng(21 + retract)
    rcalls, pcalls = _calls(CALLS)
    rs = ref.create_state(CAP, rcalls, REF_DTYPES)
    ps = port.create_state(CAP, pcalls, PORT_DTYPES, device="cpu")
    rfx = ref.float_extreme_meta(rcalls, REF_DTYPES)
    pfx = port.float_extreme_meta(pcalls, PORT_DTYPES)
    fx = dict(pfx)
    keys = (np.arange(CAP, dtype=np.int64) * 7, np.arange(CAP, dtype=np.int32) % 5)
    names = ["key0", "key1"] + [c[2] for c in CALLS]
    names += [c[2] + "__isnull" for c in CALLS if c[0] in ("sum", "min", "max")]
    for epoch in range(3):
        slots, signs, values, nulls = _batch(rng, 400, retract)
        rs, ps = _apply_both(rs, ps, rcalls, pcalls, slots, signs, values, nulls)
        _assert_states_equal(rs, ps, fx)
        # a small out_cap forces overflow rounds
        rs, ps, rounds = _flush_both(rs, ps, keys, 64, rfx, pfx, names)
        assert rounds > 1
        _assert_states_equal(rs, ps, fx)
    assert bool(ps.minmax_retracted) == retract


def test_count_and_sum_retractions_without_extremes():
    """Retractions through COUNT/SUM only: groups go to zero and emit
    deletes; no MIN/MAX latch."""
    rng = np.random.default_rng(4)
    kinds = (("count_star", None, "n"), ("count", "v", "cv"), ("sum", "v", "sv"))
    rcalls, pcalls = _calls(kinds)
    rs = ref.create_state(CAP, rcalls, REF_DTYPES)
    ps = port.create_state(CAP, pcalls, PORT_DTYPES, device="cpu")
    keys = (np.arange(CAP, dtype=np.int64),)
    names = ["key0", "n", "cv", "sv", "sv__isnull"]
    slots, signs, values, nulls = _batch(rng, 300, False)
    rs, ps = _apply_both(rs, ps, rcalls, pcalls, slots, signs, values, nulls)
    rs, ps, _ = _flush_both(rs, ps, keys, 1 << 9, (), (), names)
    # retract everything that went in: every group dies and emits D
    rs, ps = _apply_both(rs, ps, rcalls, pcalls, slots, -signs, values, nulls)
    _assert_states_equal(rs, ps, {})
    rs, rd = ref.flush(rs, tuple(jnp.asarray(k) for k in keys), 1 << 9)
    ps, pd = port.flush(ps, tuple(torch.from_numpy(k) for k in keys), 1 << 9)
    n_take = int(pd["status"][0])
    rows = _delta_rows(pd, n_take, names)
    assert rows == _delta_rows(rd, n_take, names)
    assert rows and all(r[0] == 1 for r in rows)  # Op.DELETE only
    assert not bool(ps.minmax_retracted)


def test_state_from_reference_arrays_roundtrip():
    rng = np.random.default_rng(8)
    rcalls, pcalls = _calls(CALLS)
    rs = ref.create_state(CAP, rcalls, REF_DTYPES)
    slots, signs, values, nulls = _batch(rng, 300, False)
    rs = ref.apply(
        rs, rcalls, jnp.asarray(slots), jnp.asarray(signs),
        {k: jnp.asarray(v) for k, v in values.items()},
        {k: jnp.asarray(v) for k, v in nulls.items()},
    )
    pfx = port.float_extreme_meta(pcalls, PORT_DTYPES)
    ps = port.AggState.from_reference_arrays(jax.device_get(rs), pfx, device="cpu")
    _assert_states_equal(rs, ps, dict(pfx))
    # and the empty-group sentinels agree with a fresh port state
    fresh = port.create_state(CAP, pcalls, PORT_DTYPES, device="cpu")
    untouched = ~ps.dirty
    for name, lane in fresh.accums.items():
        assert torch.equal(lane[untouched], ps.accums[name][untouched]), name


def test_order_key_maps_match_reference():
    vals = np.array([-np.inf, -2.5, -0.0, 0.0, 1e-300, 3.0, np.inf, np.nan])
    for fdt in (np.float32, np.float64):
        v = vals.astype(fdt)
        r = np.asarray(ref._float_to_order_key(jnp.asarray(v)))
        p = port._float_to_order_key(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(port.order_key_to_reference(p, fdt), r)
        np.testing.assert_array_equal(port.order_key_from_reference(r), p)
        assert (np.diff(p) >= 0).all()  # the total order survives in int64
        back = port._order_key_to_float(torch.from_numpy(p), getattr(torch, np.dtype(fdt).name))
        np.testing.assert_array_equal(back.numpy(), np.asarray(ref._order_key_to_float(jnp.asarray(r), fdt)))
