"""Kernel H parity: the port's state digest (plain ``device_digest``)
and its numpy ``host_digest`` copy against ``risingwave_tpu.integrity``'s
``host_digest`` and ``device_digest``, on the same seeded lanes.

Tolerance: none — every digest is the same uint64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu import integrity as ref
from risingwave_tpu.ops import agg as ref_agg
from risingwave_tpu_torch import integrity as port
from risingwave_tpu_torch.ops import agg as port_agg


def _lanes(rng, cap):
    f = rng.standard_normal(cap)
    f[rng.random(cap) < 0.1] = np.nan
    f[rng.random(cap) < 0.1] = -0.0
    return {
        "k0": rng.integers(-(2**62), 2**62, cap).astype(np.int64),
        "k1": rng.integers(-(2**31), 2**31 - 1, cap).astype(np.int32),
        "flag": rng.random(cap) < 0.5,
        "val": f,
        "pair": rng.integers(-99, 99, (cap, 3)).astype(np.int32),
        "f32": rng.standard_normal(cap).astype(np.float32),
    }


def _four(lanes, live):
    """(port plain, port host, reference host, reference device)."""
    t_lanes = {k: torch.from_numpy(v) for k, v in lanes.items()}
    t_live = None if live is None else torch.from_numpy(live)
    return (
        port.digest_from_scalar(port.device_digest(t_lanes, t_live)),
        port.host_digest(lanes, live),
        ref.host_digest(lanes, live),
        ref.digest_from_scalar(ref.device_digest(
            {k: jnp.asarray(v) for k, v in lanes.items()},
            None if live is None else jnp.asarray(live),
        )),
    )


@pytest.mark.parametrize("cap,live_share", [(1024, 0.6), (1024, None), (37, 0.6), (64, 0.0)])
def test_digest_matches_reference(cap, live_share):
    """Every lane type, a 2-D lane, a live mask, no mask, and an empty
    table (no live slot: the digest is 0)."""
    rng = np.random.default_rng(cap)
    lanes = _lanes(rng, cap)
    live = None if live_share is None else rng.random(cap) < live_share
    got = _four(lanes, live)
    assert len(set(got)) == 1, got
    if live_share == 0.0:
        assert got[0] == 0


def test_digest_is_invariant_under_slot_order_and_sees_a_flip():
    rng = np.random.default_rng(3)
    lanes = _lanes(rng, 512)
    live = rng.random(512) < 0.5
    perm = rng.permutation(512)
    a = _four(lanes, live)[0]
    b = _four({k: v[perm] for k, v in lanes.items()}, live[perm])[0]
    assert a == b
    lanes["k0"][np.flatnonzero(live)[0]] ^= 1
    assert _four(lanes, live)[0] != a
    lanes["k0"][np.flatnonzero(~live)[0]] ^= 1  # a dead slot does not count
    c = _four(lanes, live)[0]
    assert c == _four(lanes, live)[1] != a


def test_two_masks_or_together():
    rng = np.random.default_rng(4)
    lanes = {k: torch.from_numpy(v) for k, v in _lanes(rng, 300).items()}
    m1 = torch.from_numpy(rng.random(300) < 0.3)
    m2 = torch.from_numpy(rng.random(300) < 0.3)
    assert int(port.device_digest(lanes, (m1, m2))) == int(port.device_digest(lanes, m1 | m2))


def test_agg_lanes_fold_float_extremes_as_the_reference():
    """Float MIN/MAX accumulators live as int64 keys in the port; the
    digest folds them in the reference's uint32/uint64 representation."""
    rng = np.random.default_rng(6)
    kinds = (("count_star", None, "n"), ("min", "f", "mn"), ("max", "g", "mx"), ("sum", "v", "s"))
    rcalls = tuple(ref_agg.AggCall(*c) for c in kinds)
    pcalls = tuple(port_agg.AggCall(*c) for c in kinds)
    rs = ref_agg.create_state(256, rcalls, {"f": jnp.float64, "g": jnp.float32, "v": jnp.int64})
    n = 300
    slots = rng.integers(0, 256, n).astype(np.int32)
    rs = ref_agg.apply(
        rs, rcalls, jnp.asarray(slots), jnp.ones(n, jnp.int32),
        {"f": jnp.asarray(rng.standard_normal(n)),
         "g": jnp.asarray(rng.standard_normal(n).astype(np.float32)),
         "v": jnp.asarray(rng.integers(0, 9, n))},
        {},
    )
    pfx = port_agg.float_extreme_meta(pcalls, {"f": torch.float64, "g": torch.float32, "v": torch.int64})
    ps = port_agg.AggState.from_reference_arrays(jax.device_get(rs), pfx, device="cpu")

    class Table:  # the lanes agg_lanes reads of a table
        keys = (torch.arange(256),)
        live = torch.from_numpy(rng.random(256) < 0.5)

    rtable = type("T", (), {"keys": (jnp.arange(256),), "live": jnp.asarray(Table.live.numpy())})
    r_lanes, r_live = ref.agg_lanes(rtable, rs)
    want = ref.host_digest({k: np.asarray(v) for k, v in r_lanes.items()}, np.asarray(r_live))
    p_lanes, p_live = port.agg_lanes(Table, ps, pfx)
    assert port.digest_from_scalar(port.device_digest(p_lanes, p_live)) == want
    assert port.host_digest(*port.host_lanes(p_lanes, p_live)) == want


def test_dedup_and_join_side_lanes_match_reference():
    """q8's state lanes: the seen-set's keys (dedup_lanes) and a join
    side's bucket lanes masked by row_valid (join_side_lanes, NaN and
    NULL payloads, deleted entries leaving stale bytes behind), through
    the port's plain fold (with and without the survivor count) and its
    numpy host_digest, against the reference's device_digest."""
    from risingwave_tpu.ops import hash_table as rht
    from risingwave_tpu_torch.ops import hash_table as pht
    from test_torch_join import _apply_both, _batch, _sides

    rng = np.random.default_rng(21)
    ref_side, port_side = _sides(128, 4)
    stored = []
    for _ in range(4):
        ref_side = _apply_both(ref_side, port_side, _batch(rng, 40, 30, stored, p_del=0.4),
                               np.ones(40, bool))
    assert not bool(port_side.row_valid.all())  # vacated entries hold stale bytes
    ref_lanes, ref_live = ref.join_side_lanes(ref_side, jnp.where)
    want = ref.digest_from_scalar(ref.device_digest(ref_lanes, ref_live))
    lanes, live = port.join_side_lanes(port_side)
    got = port.digest_from_scalar(port.device_digest(lanes, live))
    dig, surv = port.digest_with_survivors(lanes, live, port_side.sdirty)
    assert got == want == port.host_digest(*port.host_lanes(lanes, live))
    assert port.digest_from_scalar(dig) == want
    assert int(surv) == int(np.sum(np.asarray(ref_side.table.live | ref_side.sdirty)))

    keys = rng.integers(0, 50, 60).astype(np.int64)
    rt = rht.HashTable.create(64, (jnp.int64,))
    rt, slots, _, _ = rht.lookup_or_insert(rt, (jnp.asarray(keys),), jnp.ones(60, jnp.bool_))
    rt = rht.set_live(rt, jnp.where(jnp.asarray(keys) % 3 > 0, slots, -1), True)
    pt = pht.HashTable.from_reference_arrays(rt.fp1, rt.fp2, rt.keys, rt.live, device="cpu")
    want = ref.digest_from_scalar(ref.device_digest(*ref.dedup_lanes(rt)))
    assert port.digest_from_scalar(port.device_digest(*port.dedup_lanes(pt))) == want
    assert port.host_digest(*port.host_lanes(*port.dedup_lanes(pt))) == want
