"""Kernel AI's plain version (``risingwave_tpu_torch/parallel/exchange.py``)
against the reference's ``exchange_chunk`` under ``shard_map`` on its
virtual CPU devices, bit for bit: every received lane, ``valid``, the
per-source routing counts and overflow flags, for 2, 4 and 8 shards,
each key dtype (float keys with -0.0 and NaNs), nullable keys built as
the agg builds them, a broadcast (stride 0) lane, and a skewed chunk
past the bucket. ``dest_shard`` against the reference's, and
``pack_buckets`` alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.parallel import exchange as ref_ex
from risingwave_tpu.parallel.sharded_agg import make_mesh as ref_make_mesh
from risingwave_tpu_torch.array.chunk import StreamChunk, stack_chunks
from risingwave_tpu_torch.parallel import exchange
from risingwave_tpu_torch.parallel.sharded_agg import _stacked_key_lanes, make_mesh

CAP = 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _values(rng, dtype: str, n: int) -> np.ndarray:
    if dtype == "int64":
        return rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    if dtype in ("float64", "float32"):
        v = rng.standard_normal(n).astype(dtype)
        v[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
        return v
    return rng.random(n) < 0.5


def _shard_inputs(rng, n_shards, key_dtype, nullable=False, skew=False, cap=CAP, full=False):
    """Per source shard: columns (a key, an int32 and a float64 payload),
    a valid prefix (every row with ``full``), NULL lanes of the payload
    (and the key)."""
    out = []
    for s in range(n_shards):
        rows = cap if full else int(rng.integers(cap // 2, cap + 1))
        key = _values(rng, key_dtype, rows)
        if skew:
            key = np.full(rows, key[0])
        cols = {"k": key, "a": rng.integers(0, 1000, rows).astype(np.int32),
                "f": rng.standard_normal(rows)}
        nulls = {"f": rng.random(rows) < 0.3}
        if nullable:
            nulls["k"] = rng.random(rows) < 0.25
        ops = rng.integers(0, 4, rows).astype(np.int32)
        out.append((cols, nulls, ops))
    return out


def _reference(inputs, n_shards, bucket_cap, nullable, cap=CAP):
    mesh = ref_make_mesh(n_shards)
    chunks = [RefChunk.from_numpy(c, cap, ops=o, nulls=nl) for c, nl, o in inputs]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *chunks)

    def local(ch):
        ch = jax.tree.map(lambda a: a[0], ch)
        if nullable:
            null = ch.nulls["k"]
            keys = (jnp.where(null, jnp.zeros_like(ch.col("k")), ch.col("k")), null)
        else:
            keys = (ch.col("k"),)
        got = ref_ex.exchange_chunk(ch, keys, n_shards, bucket_cap, "shard")
        return jax.tree.map(lambda a: a[None], got)

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("shard"),), out_specs=P("shard"),
                               check_vma=False))
    return fn(stacked)


def _port(inputs, n_shards, bucket_cap, nullable, cap=CAP):
    chunks = [StreamChunk.from_numpy(c, cap, ops=o, nulls=nl, device="cpu")
              for c, nl, o in inputs]
    st = stack_chunks(chunks)
    keys = _stacked_key_lanes(st, ("k",), (nullable,))
    return exchange.exchange_chunk(st, keys, n_shards, bucket_cap)


def _assert_same(ref, port):
    (rr, ro, rc), (pr, po, pc) = ref, port
    for name, a in rr.columns.items():
        want, got = np.asarray(a), pr.columns[name].numpy()
        assert want.dtype == got.dtype, name
        assert np.array_equal(want.view(np.uint8), got.view(np.uint8)), name  # bit for bit
    assert set(pr.columns) == set(rr.columns)
    for name, a in rr.nulls.items():
        assert np.array_equal(np.asarray(a), pr.nulls[name].numpy()), name
    assert set(pr.nulls) == set(rr.nulls)
    assert np.array_equal(np.asarray(rr.ops).astype(np.int32), pr.ops.numpy())
    assert np.array_equal(np.asarray(rr.valid), pr.valid.numpy())
    assert np.array_equal(np.asarray(rc), pc.numpy())
    assert pc.dtype == torch.int32
    assert np.array_equal(np.asarray(ro), po.numpy())


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("key_dtype", ["int64", "int32", "float64", "float32"])
def test_exchange_matches_reference(n_shards, key_dtype):
    rng = np.random.default_rng(n_shards * 10 + len(key_dtype))
    inputs = _shard_inputs(rng, n_shards, key_dtype)
    bc = exchange.default_bucket_cap(CAP, n_shards)
    port = _port(inputs, n_shards, bc, False)
    _assert_same(_reference(inputs, n_shards, bc, False), port)
    received, _, counts = port
    assert int(received.valid.sum()) == int(counts.sum())


@pytest.mark.parametrize("n_shards", [2, 8])
def test_exchange_nullable_key_matches_reference(n_shards):
    rng = np.random.default_rng(31 + n_shards)
    inputs = _shard_inputs(rng, n_shards, "int64", nullable=True)
    bc = exchange.default_bucket_cap(CAP, n_shards)
    _assert_same(_reference(inputs, n_shards, bc, True), _port(inputs, n_shards, bc, True))


def test_exchange_overflow_matches_reference():
    """Every row of every shard under one key: its destination's bucket
    overflows, the flag is set per source, nothing lands past the bucket."""
    n = 4
    rng = np.random.default_rng(77)
    inputs = _shard_inputs(rng, n, "int64", skew=True)
    for cols, _, _ in inputs:
        cols["k"][:] = 12345
    bc = 16
    port = _port(inputs, n, bc, False)
    _assert_same(_reference(inputs, n, bc, False), port)
    received, overflow, counts = port
    assert overflow.all()
    dest = int(exchange.dest_shard((torch.tensor([12345]),), n)[0])
    assert int(received.valid[dest].sum()) == n * bc
    assert not received.valid[torch.arange(n) != dest].any()


def _reference_per_source(inputs, n_shards, bucket_cap, cap):
    """The reference's algorithm without a mesh, for more shards than the
    virtual devices: ``dest_shard`` and ``pack_buckets`` per source shard,
    then the all_to_all as a transpose of the (source, destination) axes."""
    per = []
    for cols, nulls, ops in inputs:
        ch = RefChunk.from_numpy(cols, cap, ops=ops, nulls=nulls)
        dest = ref_ex.dest_shard((ch.col("k"),), n_shards)
        per.append(jax.device_get(ref_ex.pack_buckets(ref_ex.exchange_cols(ch), ch.valid, dest,
                                                      n_shards, bucket_cap)))
    a2a = lambda bufs: np.stack(bufs).transpose(1, 0, 2).reshape(n_shards, -1)
    cols = {nm: a2a([p[0][nm] for p in per]) for nm in per[0][0]}
    received = RefChunk({nm: a for nm, a in cols.items()
                         if nm != "__ops__" and not nm.startswith("__null__")},
                        a2a([p[1] for p in per]),
                        {nm[len("__null__"):]: a for nm, a in cols.items()
                         if nm.startswith("__null__")}, cols["__ops__"])
    return received, np.stack([p[2] for p in per]), np.stack([p[3] for p in per])


# AI's hard cases (chip_smoke.py's phase 3 holds kernel AI against the
# plain version on the card on the same kinds): (shards, rows a source,
# bucket_cap or None for the default, one key for every row, every row valid)
HARD_CASES = {
    "one_shard": (1, CAP, None, None, False),
    "three_shards": (3, CAP, None, None, False),
    "sixty_four_shards": (64, CAP, None, None, False),
    "one_destination_takes_every_row": (8, CAP, CAP, 4242, False),
    "a_bucket_exactly_full": (4, CAP, CAP, 99, True),
    "cap_0": (4, 0, None, None, False),
}


@pytest.mark.parametrize("case", sorted(HARD_CASES))
def test_exchange_hard_cases_match_reference(case):
    n, cap, bc, key, full = HARD_CASES[case]
    rng = np.random.default_rng(len(case))
    inputs = _shard_inputs(rng, n, "int64", cap=cap, full=full)
    if key is not None:
        for cols, _, _ in inputs:
            cols["k"][:] = key
    bc = exchange.default_bucket_cap(cap, n) if bc is None else bc
    port = _port(inputs, n, bc, False, cap=cap)
    if n <= len(jax.devices()) and cap > 0:
        ref = _reference(inputs, n, bc, False, cap=cap)
    else:  # more shards than devices, or a zero-row chunk XLA's shard_map refuses
        ref = _reference_per_source(inputs, n, bc, cap)
    _assert_same(ref, port)
    received, overflow, counts = port
    assert int(received.valid.sum()) == int(counts.clamp(max=bc).sum())
    if key is not None:
        dest = int(exchange.dest_shard((torch.tensor([key]),), n)[0])
        assert int(counts[:, dest].sum()) == int(counts.sum()) > 0
        assert not overflow.any()
    if full:
        assert int(counts.max()) == bc
    if cap == 0:
        assert int(counts.sum()) == 0 and not received.valid.any()
        assert all(not a.any() for a in received.columns.values())


def test_exchange_reads_a_broadcast_lane():
    """A lane broadcast to every shard (StackSplit's stride-0 view)
    exchanges as its copy does."""
    n = 4
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.integers(0, 50, CAP).astype(np.int64))
    cols = {"k": k.unsqueeze(0).expand(n, CAP)}
    valid = torch.from_numpy(rng.random((n, CAP)) < 0.5)
    ops = torch.zeros(CAP, dtype=torch.int32).unsqueeze(0).expand(n, CAP)
    a = StreamChunk(cols, valid, {}, ops)
    b = StreamChunk({"k": cols["k"].contiguous()}, valid, {}, ops.contiguous())
    ra = exchange.exchange_chunk(a, (a.col("k"),), n, 64)
    rb = exchange.exchange_chunk(b, (b.col("k"),), n, 64)
    assert torch.equal(ra[0].columns["k"], rb[0].columns["k"])
    assert torch.equal(ra[0].valid, rb[0].valid) and torch.equal(ra[2], rb[2])


@pytest.mark.parametrize("key_dtype", ["int64", "int32", "float64", "float32", "bool"])
def test_dest_shard_matches_reference(key_dtype):
    rng = np.random.default_rng(3)
    v = _values(rng, key_dtype, 4096)
    w = rng.integers(0, 1 << 40, 4096, dtype=np.int64)
    for n in (1, 3, 8):
        want = np.asarray(ref_ex.dest_shard((jnp.asarray(v), jnp.asarray(w)), n))
        got = exchange.dest_shard((torch.from_numpy(v), torch.from_numpy(w)), n)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    # stacked lanes route as their rows do
    st = exchange.dest_shard((torch.from_numpy(v).reshape(4, -1),), 8)
    assert np.array_equal(st.reshape(-1).numpy(),
                          np.asarray(ref_ex.dest_shard((jnp.asarray(v),), 8)))


def test_pack_buckets_matches_reference():
    rng = np.random.default_rng(9)
    n = 200
    cols = {"x": rng.integers(0, 99, n).astype(np.int64), "y": rng.random(n) < 0.5}
    valid = rng.random(n) < 0.8
    dest = rng.integers(0, 3, n).astype(np.int32)
    want = ref_ex.pack_buckets({k: jnp.asarray(v) for k, v in cols.items()},
                               jnp.asarray(valid), jnp.asarray(dest), 3, 48)
    got = exchange.pack_buckets({k: torch.from_numpy(v) for k, v in cols.items()},
                                torch.from_numpy(valid), torch.from_numpy(dest), 3, 48)
    for k in cols:
        assert np.array_equal(np.asarray(want[0][k]), got[0][k].numpy())
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    assert bool(want[2]) == bool(got[2])
    assert np.array_equal(np.asarray(want[3]), got[3].numpy())


def test_exchange_cols_and_contract_match_reference():
    assert exchange.EXCHANGE_MESH_CONTRACT == ref_ex.EXCHANGE_MESH_CONTRACT
    c = StreamChunk.from_numpy({"a": np.arange(4)}, 4, nulls={"a": np.array([1, 0, 0, 1])},
                               device="cpu")
    assert sorted(exchange.exchange_cols(c)) == ["__null__a", "__ops__", "a"]


def test_mesh_refuses_several_cards():
    assert make_mesh(4, device="cpu").n_shards == 4
    assert make_mesh(2, devices=["cpu", "cpu"]).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="later"):
        make_mesh(2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
