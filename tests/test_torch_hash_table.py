"""Kernel A parity: the port's hash table against ``risingwave_tpu.ops.hash_table``.

The port runs its plain PyTorch version here (CPU tensors). Every
comparison is exact: slots are integers, and on the CPU the plain
version elects the same claim winner as XLA's CPU scatter, so even the
slots of newly inserted keys equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.ops import hash_table as ref
from risingwave_tpu_torch.ops import hash_table as port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tables(cap, dtypes):
    r = ref.HashTable.create(cap, tuple(jnp.dtype(d) for d in dtypes))
    p = port.HashTable.create(
        cap, tuple(getattr(torch, np.dtype(d).name) for d in dtypes), device="cpu"
    )
    return r, p


def _both(r, p, cols, valid):
    r, rs, rf, ri = ref.lookup_or_insert(
        r, tuple(jnp.asarray(c) for c in cols), jnp.asarray(valid)
    )
    p, ps, pf, pi = port.lookup_or_insert(
        p, tuple(torch.from_numpy(c) for c in cols), torch.from_numpy(valid)
    )
    return r, p, (np.asarray(rs), np.asarray(rf), np.asarray(ri)), (
        ps.numpy(), pf.numpy(), pi.numpy(),
    )


def _assert_same_calls(rout, pout, cols, valid):
    rs, rf, ri = rout
    ps, pf, pi = pout
    np.testing.assert_array_equal(ps >= 0, rs >= 0)
    np.testing.assert_array_equal(pf, rf)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(ps, rs)
    # rows share a slot iff they share a key
    placed = ps >= 0
    keys = np.stack([c[placed] for c in cols], 1)
    pairs = {tuple(k) + (s,) for k, s in zip(keys.tolist(), ps[placed].tolist())}
    assert len(pairs) == len({tuple(k) for k in keys.tolist()}) == len(set(ps[placed]))
    assert (ps[~valid] == -1).all()


def _assert_same_tables(r, p):
    r = jax.device_get(r)
    np.testing.assert_array_equal(p.fp1.numpy().view(np.uint32), r.fp1)
    np.testing.assert_array_equal(p.fp2.numpy().view(np.uint32), r.fp2)
    np.testing.assert_array_equal(p.live.numpy(), r.live)
    for pk, rk in zip(p.keys, r.keys):
        np.testing.assert_array_equal(pk.numpy(), rk)
    np.testing.assert_array_equal(p.stamp.numpy() != 0, r.fp1 != 0)


def test_duplicates_tombstones_and_invalid_rows():
    rng = np.random.default_rng(11)
    r, p = _tables(1 << 10, (np.int64, np.int32))
    n = 400
    a = rng.integers(0, 60, n).astype(np.int64)  # many duplicate keys
    b = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    r, p, rout, pout = _both(r, p, (a, b), valid)
    _assert_same_calls(rout, pout, (a, b), valid)
    assert pout[2][valid].all() and not pout[1].any()  # all new: inserted, not found
    # mark half the claimed slots live, the rest stay tombstones
    slots = rout[0][valid]
    live_slots = np.unique(slots)[::2]
    r = ref.set_live(r, jnp.asarray(live_slots.astype(np.int32)), True)
    port.set_live(p, torch.from_numpy(live_slots.astype(np.int32)), True)
    # second batch: old keys (live and tombstoned) and new ones
    a2 = rng.integers(0, 90, n).astype(np.int64)
    b2 = rng.integers(0, 3, n).astype(np.int32)
    valid2 = rng.random(n) > 0.1
    r, p, rout, pout = _both(r, p, (a2, b2), valid2)
    _assert_same_calls(rout, pout, (a2, b2), valid2)
    found, inserted = pout[1], pout[2]
    assert found.any() and inserted.any() and (valid2 & ~found & ~inserted).any()
    _assert_same_tables(r, p)


def test_h1_colliding_keys_stay_apart():
    """Keys whose hash128 h1 agree (the same home slot and fp1) but whose
    keys differ, found by a search with the plain hash128 over 2^17
    random keys: inserted together, repeated and interleaved within
    32-row warps, then found again, each keeps a slot of its own, equal
    to the reference's."""
    from risingwave_tpu_torch.ops.hashing import hash128

    rng = np.random.default_rng(0)
    cand = rng.choice(1 << 50, 1 << 17, replace=False).astype(np.int64)
    h1, _ = hash128((torch.from_numpy(cand),))
    h1 = h1.numpy()
    order = np.argsort(h1, kind="stable")
    same = np.flatnonzero(h1[order][1:] == h1[order][:-1])
    assert len(same) >= 2
    a, b = cand[order[same]], cand[order[same + 1]]
    assert (a != b).all()
    pair = np.stack([a, b], 1)
    lane = np.arange(32)
    keys = np.concatenate([pair[:, lane % 2], pair[:, (lane >= 16).astype(int)]], 1).reshape(-1)
    keys = np.concatenate([keys, rng.integers(0, 1 << 50, 64)]).astype(np.int64)
    valid = rng.random(len(keys)) > 0.05
    r, p = _tables(1 << 12, (np.int64,))
    for _ in range(2):  # new, then found
        r, p, rout, pout = _both(r, p, (keys,), valid)
        _assert_same_calls(rout, pout, (keys,), valid)
        _assert_same_tables(r, p)
        slot_of = {}
        for k, s in zip(keys[valid].tolist(), pout[0][valid].tolist()):
            assert slot_of.setdefault(k, s) == s
        assert len(set(slot_of.values())) == len(slot_of)


def test_float_keys_nan_and_signed_zero():
    vals = np.array([0.0, -0.0, np.nan, np.nan, 1.5, -1.5, np.inf, 0.0], np.float64)
    valid = np.ones(len(vals), bool)
    r, p = _tables(64, (np.float64,))
    r, p, rout, pout = _both(r, p, (vals,), valid)
    np.testing.assert_array_equal(pout[0], rout[0])
    assert pout[0][0] == pout[0][1] == pout[0][7]  # -0.0 == 0.0
    assert pout[0][2] == pout[0][3]  # NaN == NaN
    # the NaN key resolves again on a second call
    r, p, rout, pout = _both(r, p, (vals,), valid)
    np.testing.assert_array_equal(pout[0], rout[0])
    assert not pout[2].any()


def test_overflow_at_tiny_capacity():
    rng = np.random.default_rng(5)
    keys = rng.choice(10_000, 40, replace=False).astype(np.int64)
    valid = np.ones(40, bool)
    r, p = _tables(16, (np.int64,))
    r, p, rout, pout = _both(r, p, (keys,), valid)
    _assert_same_calls(rout, pout, (keys,), valid)
    assert (pout[0] == -1).sum() == 40 - 16  # a full table: the rest overflow
    _assert_same_tables(r, p)


def test_dropped_index_writes_nothing():
    """Slot -1 is the reference's drop sentinel (mode="drop"): set_live
    must write nothing for it (torch indexing would write slot cap-1)."""
    r, p = _tables(16, (np.int64,))
    slots = np.array([3, -1, 5], np.int32)
    r = ref.set_live(r, jnp.asarray(slots), jnp.asarray([True, True, True]))
    port.set_live(p, torch.from_numpy(slots), torch.tensor([True, True, True]))
    np.testing.assert_array_equal(p.live.numpy(), np.asarray(r.live))
    assert not p.live[-1] and p.live.sum() == 2


def test_from_reference_arrays_keeps_slots_and_lookup():
    rng = np.random.default_rng(2)
    r, _ = _tables(1 << 9, (np.int64, np.int64))
    a = rng.integers(0, 1000, 150).astype(np.int64)
    b = rng.integers(0, 5, 150).astype(np.int64)
    valid = np.ones(150, bool)
    r, rs, _, _ = ref.lookup_or_insert(r, (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(valid))
    r = ref.set_live(r, rs, True)
    host = jax.device_get(r)
    p = port.HashTable.from_reference_arrays(host.fp1, host.fp2, host.keys, host.live, device="cpu")
    _assert_same_tables(r, p)
    # a read-only probe over present and absent keys
    qa = np.concatenate([a[:50], rng.integers(2000, 3000, 50)]).astype(np.int64)
    qb = np.concatenate([b[:50], np.zeros(50, np.int64)])
    qv = np.ones(100, bool)
    r_slots, r_found = ref.lookup(r, (jnp.asarray(qa), jnp.asarray(qb)), jnp.asarray(qv))
    p_slots, p_found = port.lookup(p, (torch.from_numpy(qa), torch.from_numpy(qb)), torch.from_numpy(qv))
    np.testing.assert_array_equal(p_slots.numpy(), np.asarray(r_slots))
    np.testing.assert_array_equal(p_found.numpy(), np.asarray(r_found))
    # an import resolves existing keys to the reference's slots
    r, p, rout, pout = _both(r, p, (qa, qb), qv)
    _assert_same_calls(rout, pout, (qa, qb), qv)
    assert pout[1][:50].all()


def test_claim_generations_wrap_without_changing_results():
    """Kernel A tells this call's claims from older ones by the stamp's
    generation; when generations run out they restart, every claimed
    slot keeping a positive stamp older than any new call's."""
    rng = np.random.default_rng(13)
    r, p = _tables(1 << 8, (np.int64,))
    p.gen = port._GEN_LIMIT - 2
    for _ in range(3):
        keys = rng.integers(0, 120, 50).astype(np.int64)
        valid = np.ones(50, bool)
        r, p, rout, pout = _both(r, p, (keys,), valid)
        _assert_same_calls(rout, pout, (keys,), valid)
    assert p.gen < port._GEN_LIMIT
    claimed = p.fp1 != 0
    assert (p.stamp[claimed] > 0).all() and (p.stamp[claimed] <= p.gen).all()
    assert (p.stamp[~claimed] == 0).all()
    _assert_same_tables(r, p)


def test_occurrence_masks_and_plan_rehash():
    rng = np.random.default_rng(9)
    slots = rng.integers(-1, 12, 200).astype(np.int32)
    valid = rng.random(200) > 0.2
    for rf, pf in (
        (ref.first_occurrence_mask, port.first_occurrence_mask),
        (ref.last_occurrence_mask, port.last_occurrence_mask),
    ):
        np.testing.assert_array_equal(
            pf(torch.from_numpy(slots), torch.from_numpy(valid)).numpy(),
            np.asarray(rf(jnp.asarray(slots), jnp.asarray(valid))),
        )
    for args in ((1024, 100, 300, 300), (1024, 300, 300, 100), (1024, 600, 500, 900)):
        assert port.plan_rehash(*args) == ref.plan_rehash(*args)
    assert port.read_scalars(torch.tensor(True), torch.tensor(7)) == [1, 7]
