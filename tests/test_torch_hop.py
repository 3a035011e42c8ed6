"""Kernel E parity: the hop expansion of a stacked epoch (the port's
plain ``hop_step_fn`` on (n_chunks, C) lanes) against
``jax.vmap(risingwave_tpu hop_step_fn)`` then a flatten, row for row.
Exact: the lanes are integers and bools.
"""

import functools

import jax
import numpy as np
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors.hop_window import hop_step_fn as ref_hop
from risingwave_tpu.parallel.sharded_agg import stack_chunks as ref_stack
from risingwave_tpu_torch.array.chunk import StreamChunk, flatten_stacked, stack_chunks
from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor, hop_step_fn


def test_stacked_hop_matches_vmapped_reference():
    rng = np.random.default_rng(12)
    n_chunks, cap = 4, 300
    raw = []
    for c in range(n_chunks):
        n = int(rng.integers(cap // 2, cap + 1))
        cols = {
            "auction": rng.integers(0, 1000, n).astype(np.int64),
            "date_time": rng.integers(-30_000, 90_000, n).astype(np.int64),  # negative: floor division
            "price": rng.integers(0, 99, n).astype(np.int32),
        }
        ops = rng.integers(0, 4, n).astype(np.int32)
        nulls = {"price": rng.random(n) < 0.2}
        raw.append((cols, ops, nulls))
    ref_stacked = ref_stack([RefChunk.from_numpy(c, cap, ops=o, nulls=nl) for c, o, nl in raw])
    stacked = stack_chunks(
        [StreamChunk.from_numpy(c, cap, ops=o, nulls=nl, device="cpu") for c, o, nl in raw]
    )
    step = functools.partial(
        ref_hop, ts_col="date_time", size_ms=10_000, slide_ms=2_000, out_start="window_start"
    )
    r = jax.tree.map(lambda a: np.asarray(a).reshape(-1), jax.vmap(step)(ref_stacked))
    pure = HopWindowExecutor("date_time", 10_000, 2_000).pure_step()
    assert pure.rows(cap) == 5 * cap
    p = flatten_stacked(pure(stacked))
    assert p.valid.shape == (n_chunks * 5 * cap,)
    assert list(p.columns) == list(r.columns)
    for name in r.columns:
        np.testing.assert_array_equal(p.col(name).numpy(), r.col(name), err_msg=name)
    assert p.nulls.keys() == r.nulls.keys()
    np.testing.assert_array_equal(p.nulls["price"].numpy(), r.nulls["price"])
    np.testing.assert_array_equal(p.valid.numpy(), r.valid)
    np.testing.assert_array_equal(p.ops.numpy(), r.ops)
    # one chunk at a time gives the same rows, chunk after chunk
    for i, (c, o, nl) in enumerate(raw):
        one = hop_step_fn(StreamChunk.from_numpy(c, cap, ops=o, nulls=nl, device="cpu"),
                          "date_time", 10_000, 2_000, "window_start")
        blk = slice(i * 5 * cap, (i + 1) * 5 * cap)
        np.testing.assert_array_equal(one.col("window_start").numpy(), r.col("window_start")[blk])
        np.testing.assert_array_equal(one.valid.numpy(), r.valid[blk])
    assert torch.equal(stacked.valid, stack_chunks([stacked]).valid[0])
