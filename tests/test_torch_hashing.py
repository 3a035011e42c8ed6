"""K1 parity: the port's key hashing against ``risingwave_tpu.ops.hashing``.

Same numpy-seeded inputs through both; every comparison is exact (the
hash is integer arithmetic, and the port must be bit-exact because the
fingerprints and the vnode decide slots and shards).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.ops import hashing as ref
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.ops import hashing as port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _columns(n=512, seed=7):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal(n).astype(np.float32)
    f64 = rng.standard_normal(n)
    specials = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    f32[: len(specials)] = specials
    f64[: len(specials)] = specials
    # a NaN with a non-canonical payload must hash like every other NaN
    f32[6] = np.array(0x7FC00123, np.uint32).view(np.float32)
    f64[6] = np.array(0x7FF0000000000ABC, np.uint64).view(np.float64)
    return {
        "int32": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "int64": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        "bool": rng.random(n) < 0.5,
        "float32": f32,
        "float64": f64,
    }


def _ref_hash(cols, seed):
    return np.asarray(ref.hash_columns([jnp.asarray(c) for c in cols], seed))


def _port_hash(cols, seed):
    out = port.hash_columns([torch.from_numpy(c) for c in cols], seed)
    assert out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < 2**32
    return out.numpy().astype(np.uint32)


@pytest.mark.parametrize("dtype", ["int32", "int64", "bool", "float32", "float64"])
@pytest.mark.parametrize("seed", [0, port.SEED_FP2, port.SEED_VNODE])
def test_hash_columns_bit_exact_per_dtype(dtype, seed):
    col = _columns()[dtype]
    np.testing.assert_array_equal(_port_hash([col], seed), _ref_hash([col], seed))


def test_float_canonicalisation_matches():
    """-0.0 hashes as +0.0 and every NaN as one NaN, in both."""
    cols = _columns()
    for name in ("float32", "float64"):
        h = _port_hash([cols[name]], 0)
        assert h[0] == h[1]  # 0.0, -0.0
        assert h[2] == h[3] == h[6]  # NaN payloads


def test_multi_column_keys_and_hash128():
    cols = list(_columns().values())
    r1, r2 = ref.hash128([jnp.asarray(c) for c in cols])
    p1, p2 = port.hash128([torch.from_numpy(c) for c in cols])
    np.testing.assert_array_equal(p1.numpy().astype(np.uint32), np.asarray(r1))
    np.testing.assert_array_equal(p2.numpy().astype(np.uint32), np.asarray(r2))


def test_vnode_of_matches():
    cols = _columns()
    for names in (["int64"], ["int64", "int32"], ["float64", "bool"]):
        r = np.asarray(ref.vnode_of([jnp.asarray(cols[n]) for n in names]))
        p = port.vnode_of([torch.from_numpy(cols[n]) for n in names])
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), r)
        assert p.min() >= 0 and p.max() < port.VNODE_COUNT


def test_group_key_lanes_with_nulls():
    rng = np.random.default_rng(3)
    n = 300
    cols = {
        "a": rng.integers(-50, 50, n).astype(np.int64),
        "b": rng.integers(0, 4, n).astype(np.int32),
    }
    nulls = {"a": rng.random(n) < 0.2}
    rc = RefChunk.from_numpy(cols, 512, nulls=nulls)
    pc = StreamChunk.from_numpy(cols, 512, nulls=nulls, device="cpu")
    rl = ref.group_key_lanes(rc, ["a", "b"])
    pl = port.group_key_lanes(pc, ["a", "b"])
    assert len(rl) == len(pl) == 3  # a value, a null flag, b
    for r, p in zip(rl, pl):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        port.hash_columns(pl).numpy().astype(np.uint32),
        np.asarray(ref.hash_columns(rl)),
    )
