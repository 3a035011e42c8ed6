"""Expand (kernel AA's expand entry on the card) on the CPU: the port's
plain ``expand_step`` held lane for lane against the reference's
``_expand_step`` (columns with and without null lanes inside and
outside the grouping sets, random ops), the executor's errors (a flag
column that collides, a missing subset column, no subset), the
reference's own Expand tests on the port, an Expand -> HashAgg -> MV
chain equal to the reference's composition with nullable group keys,
and ``fuse_chain`` leaving the Expand interpreted as the reference's
does. Exact: every lane is an integer or a bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.executors import expand as ref_ex
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import expand as ex_mod
from test_torch_project_set import assert_chunks_equal, both

SETS = [(("k", "city"), ("k",), ()), (("city",),), (("k",), ("k", "city"), ("x",), ())]


@pytest.mark.parametrize("sets", SETS)
@pytest.mark.parametrize("seed", [7, 8])
def test_expand_step_equals_reference(sets, seed):
    rng = np.random.default_rng(seed)
    n, cap = 29, 32
    cols = {"k": rng.integers(0, 5, n).astype(np.int64),
            "city": rng.integers(0, 3, n).astype(np.int32),
            "x": rng.integers(-9, 9, n).astype(np.int64),
            "y": rng.integers(0, 2, n).astype(np.bool_)}
    nulls = {"city": rng.random(n) < 0.3, "y": rng.random(n) < 0.3}
    ops = rng.integers(0, 4, n).astype(np.int32)
    c, r = both(cols, cap, ops, nulls)
    ex = ex_mod.ExpandExecutor(sets)
    rex = ref_ex.ExpandExecutor(sets)
    assert ex.names == rex.names
    got = ex_mod._expand_torch(c, ex.subsets, ex.names, "flag")
    want = ref_ex._expand_step(r, rex.subsets, rex.names, "flag")
    assert_chunks_equal(got, want, f"expand {sets}")
    (out,) = ex.apply(c)
    assert_chunks_equal(out, want, "executor")


def test_expand_errors_as_reference():
    c, r = both({"k": np.arange(3), "flag": np.arange(3)}, 4)
    for mod in (ex_mod, ref_ex):
        with pytest.raises(ValueError, match="at least one subset"):
            mod.ExpandExecutor([])
    ours, theirs = ex_mod.ExpandExecutor([("k",)]), ref_ex.ExpandExecutor([("k",)])
    with pytest.raises(ValueError) as a:
        ours.apply(c)
    with pytest.raises(ValueError) as b:
        theirs.apply(r)
    assert str(a.value) == str(b.value)
    ours, theirs = ex_mod.ExpandExecutor([("k", "zz")]), ref_ex.ExpandExecutor([("k", "zz")])
    with pytest.raises(KeyError) as a:
        ours.apply(c)
    with pytest.raises(KeyError) as b:
        theirs.apply(r)
    assert str(a.value) == str(b.value)
    assert ex_mod.ExpandExecutor([("b", "a"), ("c",)]).names == ("a", "b", "c")


def _chunk(ks, cities, xs, cap=8):
    return StreamChunk.from_numpy({"k": np.asarray(ks), "city": np.asarray(cities),
                                   "x": np.asarray(xs)}, cap, device="cpu")


def test_reference_expand_tests_on_the_port():
    """``tests/test_expand.py``'s two tests, on the port."""
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.ops.agg import AggCall

    ex = ex_mod.ExpandExecutor([("k", "city"), ("k",), ()])
    (out,) = ex.apply(_chunk([1, 2], [10, 20], [5, 6]))
    d = out.to_numpy()
    rows = sorted(zip(
        d["flag"].tolist(),
        [None if m else v for v, m in zip(d["k"].tolist(), d["k__null"])],
        [None if m else v for v, m in zip(d["city"].tolist(), d["city__null"])],
        d["x"].tolist()))
    assert rows == [(0, 1, 10, 5), (0, 2, 20, 6), (1, 1, None, 5), (1, 2, None, 6),
                    (2, None, None, 5), (2, None, None, 6)]

    i64 = torch.int64
    agg = HashAggExecutor(("k", "city", "flag"), (AggCall("sum", "x", "sx"),),
                          {"k": i64, "city": i64, "flag": i64, "x": i64}, capacity=1 << 8,
                          nullable_keys=("k", "city"), device="cpu")
    for c in ex.apply(_chunk([1, 1, 2], [10, 11, 10], [5, 6, 7])):
        agg.apply(c)
    outs = agg.on_barrier(None)
    agg.finish_barrier()
    snap = {}
    for c in outs:
        d = c.to_numpy()
        for i in range(len(d["sx"])):
            key = (None if d["k__null"][i] else int(d["k"][i]),
                   None if d["city__null"][i] else int(d["city"][i]), int(d["flag"][i]))
            snap[key] = int(d["sx"][i])
    assert snap == {(1, 10, 0): 5, (1, 11, 0): 6, (2, 10, 0): 7, (1, None, 1): 11,
                    (2, None, 1): 7, (None, None, 2): 18}


def test_fuse_chain_leaves_expand_interpreted_as_the_reference():
    from risingwave_tpu.executors.hash_agg import HashAggExecutor as RefAgg
    from risingwave_tpu.executors.materialize import DeviceMaterializeExecutor as RefMv
    from risingwave_tpu.ops.agg import AggCall as RefCall
    from risingwave_tpu.runtime.fused_step import fuse_chain as ref_fuse
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.fused_step import fuse_chain

    keys = ("auction", "bidder", "flag")
    ours = fuse_chain([
        ex_mod.ExpandExecutor([("auction",), ("bidder",), ()]),
        HashAggExecutor(keys, (AggCall("count_star", None, "n"),), dict.fromkeys(keys, torch.int64),
                        capacity=64, nullable_keys=keys[:2], device="cpu"),
        DeviceMaterializeExecutor(keys, ("n",), dict.fromkeys(keys + ("n",), torch.int64),
                                  capacity=64, device="cpu")])
    theirs = ref_fuse([
        ref_ex.ExpandExecutor([("auction",), ("bidder",), ()]),
        RefAgg(keys, (RefCall("count_star", None, "n"),), dict.fromkeys(keys, jnp.int64),
               capacity=64, nullable_keys=keys[:2]),
        RefMv(keys, ("n",), dict.fromkeys(keys + ("n",), jnp.int64), capacity=64)])
    names = lambda out: [type(e).__name__ for e in out]
    assert names(ours) == names(theirs) == ["ExpandExecutor", "FusedChainExecutor"]
