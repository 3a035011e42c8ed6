"""The generators (``ValuesExecutor``, ``NowExecutor``) and the
``TroublemakerExecutor`` on the CPU against the reference: VALUES emits
its rows once, at the first barrier; NOW an INSERT, then a U-/U+ pair
per new epoch; the troublemaker with one seed injects the same faults
(its ``log``) and emits the same chunks as the reference's, and the
reference's own troublemaker tests run on the port.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu.array.chunk import StreamChunk as RefChunk
from risingwave_tpu.executors.base import Barrier as RefBarrier
from risingwave_tpu.executors.base import Epoch as RefEpoch
from risingwave_tpu.executors.generators import NowExecutor as RefNow
from risingwave_tpu.executors.generators import ValuesExecutor as RefValues
from risingwave_tpu.executors.troublemaker import TroublemakerExecutor as RefTm
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import NowExecutor, TroublemakerExecutor, ValuesExecutor
from risingwave_tpu_torch.executors.base import Barrier, Epoch
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
from risingwave_tpu_torch.runtime.pipeline import Pipeline
from risingwave_tpu_torch.types import Op


def same_rows(got, want):
    g, w = got.to_numpy(with_ops=True), want.to_numpy(with_ops=True)
    assert set(g) == set(w) and got.capacity == want.capacity
    for k in w:
        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def test_values_emits_once_as_the_reference():
    cols = {"x": np.asarray([3, 1, 4], np.int64), "y": np.asarray([1, 0, 1], np.int32)}
    ours, theirs = ValuesExecutor(cols, device="cpu"), RefValues(cols)
    b, rb = Barrier(Epoch(0, 1 << 16)), RefBarrier(RefEpoch(0, 1 << 16))
    (got,), (want,) = ours.on_barrier(b), theirs.on_barrier(rb)
    same_rows(got, want)
    assert ours.on_barrier(b) == [] and theirs.on_barrier(rb) == []
    with pytest.raises(TypeError, match="source"):
        ours.apply(got)


def test_values_through_an_mv():
    """``tests/test_dml_union_generators.py``'s VALUES half, on the
    port's device MV."""
    vals = ValuesExecutor({"x": np.asarray([3, 1, 4], np.int64)}, device="cpu")
    mv = DeviceMaterializeExecutor(("_row_id",), ("x",), {"_row_id": torch.int64,
                                                          "x": torch.int64},
                                   capacity=16, device="cpu")
    pipe = Pipeline([vals, mv])
    pipe.barrier()
    assert {v[0] for v in mv.snapshot().values()} == {3, 1, 4}
    pipe.barrier()  # emits once, not per barrier
    assert len(mv.snapshot()) == 3


def test_now_emits_insert_then_update_pairs_as_the_reference():
    """NOW's half of that test: the port's MV keyed on the value holds
    one row, the barrier's ms (the U- retires the old row); each epoch's
    chunk equals the reference's, a repeated epoch emits nothing."""
    now, rnow = NowExecutor(device="cpu"), RefNow()
    mvn = DeviceMaterializeExecutor(("now",), (), {"now": torch.int64}, capacity=16,
                                    device="cpu")
    pipe = Pipeline([now, mvn])
    for ms in (1000, 2000, 2000, 3500):
        pipe.barrier(epoch=ms << 16)
        assert mvn.snapshot() == {(ms,): ()}
    ours, theirs = NowExecutor(device="cpu"), RefNow()
    for ms, rows in ((5, 1), (9, 2), (9, 0)):
        got = ours.on_barrier(Barrier(Epoch(0, ms << 16)))
        want = theirs.on_barrier(RefBarrier(RefEpoch(0, ms << 16)))
        assert len(got) == len(want) == (1 if rows else 0)
        if rows:
            same_rows(got[0], want[0])
            assert len(got[0].to_numpy()["now"]) == rows
    ops = ours.on_barrier(Barrier(Epoch(0, 12 << 16)))[0].to_numpy()["__op__"]
    assert ops.tolist() == [int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)]


def _chunk(mod, vals, cap=8):
    cols = {"k": np.asarray(vals, np.int64), "v": np.asarray(vals, np.int64)}
    if mod == "ref":
        return RefChunk.from_numpy(cols, cap)
    return StreamChunk.from_numpy(cols, cap, device="cpu")


@pytest.mark.parametrize("seed,rate", [(3, 1.0), (9, 1.0), (4, 0.5)])
def test_troublemaker_same_seed_same_faults(seed, rate):
    ours, theirs = TroublemakerExecutor(seed=seed, rate=rate), RefTm(seed=seed, rate=rate)
    for i in range(30):
        vals = [i * 3, i * 3 + 1, i * 3 + 2]
        (got,), (want,) = ours.apply(_chunk("port", vals)), theirs.apply(_chunk("ref", vals))
        same_rows(got, want)
    assert ours.log == theirs.log and len(ours.log) > 0


def test_troublemaker_faults_are_logged_and_visible():
    """``tests/test_troublemaker.py``'s tests, on the port."""
    tm = TroublemakerExecutor(seed=3, rate=1.0)
    out = []
    for i in range(30):
        out.extend(tm.apply(_chunk("port", [i * 3, i * 3 + 1, i * 3 + 2])))
    assert len(tm.log) == 30
    assert {m for m, _, _ in tm.log} == {"corrupt_value", "flip_op", "dup_row"}
    diffs = 0
    for i, c in enumerate(out):
        got = c.to_numpy(with_ops=True)
        want = [i * 3, i * 3 + 1, i * 3 + 2]
        if ([int(x) for x in got["k"]] != want or any(int(o) != int(Op.INSERT)
                                                        for o in got["__op__"])
                or sorted(int(x) for x in got["v"]) != want):
            diffs += 1
    assert diffs == 30
    tm = TroublemakerExecutor(seed=1, rate=0.0)
    c = _chunk("port", [1, 2, 3])
    (same,) = tm.apply(c)
    assert same is c and tm.log == []
