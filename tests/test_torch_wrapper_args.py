"""The CUDA wrappers of kernels H, J, L and M marshal their arguments as
their C entry points declare them (``_kernels.SIGNATURES``), checked on
the CPU: each wrapper runs on CPU tensors while ``_kernels.call`` is
replaced by a ``ctypes.CFUNCTYPE`` callback of the entry point's
signature, so a wrong argument count or type raises here, not on the
card. The kernels themselves are held against their plain versions by
``chip_smoke.py`` on the card.
"""

import ctypes

import pytest
import torch

from risingwave_tpu_torch import _kernels, integrity
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors import dedup
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops import join


@pytest.fixture
def calls(monkeypatch):
    """Route every launch through a callback of its C signature and
    record (library, entry point, argument count)."""
    log = []

    def call(name, fn, *args):
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *_kernels.SIGNATURES[name][fn])
        assert proto(lambda *a: 0)(*args, None) == 0
        log.append((name, fn))
        _kernels.LAUNCHES[_kernels.ENTRY_KEYS.get(fn, name)] += 1

    def check_cpu(name, *tensors, n=None):
        for t in tensors:
            assert t.is_contiguous(), name
            if n is not None:
                assert t.shape == (n,), name

    monkeypatch.setattr(_kernels, "call", call)
    monkeypatch.setattr(_kernels, "check_cuda", check_cpu)
    _kernels.reset_launches()
    return log


def _side(cap=64, fanout=4):
    return join.JoinSide.create(
        cap, fanout, (torch.int64,), {"k": torch.int64, "v": torch.int32}, nullable=("v",),
        device="cpu",
    )


def test_j_entries_marshal(calls):
    table = ht.HashTable.create(64, (torch.int64,), device="cpu")
    n = 16
    chunk = StreamChunk.from_numpy({"k": torch.arange(n).numpy()}, n, device="cpu")
    slots = torch.arange(n, dtype=torch.int32)
    inserted = torch.ones(n, dtype=torch.bool)
    scratch = ht.first_scratch(64, "cpu")
    latches = (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    emit = dedup._dedup_emit_cuda(table, torch.zeros(64, dtype=torch.bool), chunk, slots,
                                  inserted, scratch, latches)
    assert emit.shape == (n,) and emit.dtype == torch.bool
    ht._first_occurrence_cuda(slots, inserted, scratch)
    with pytest.raises(ValueError, match="first_scratch"):
        ht._first_occurrence_cuda(slots, inserted, None)
    assert calls == [("dedup_emit", "rw_dedup_emit"), ("dedup_emit", "rw_first_occurrence")]
    assert _kernels.LAUNCHES["dedup_emit"] == 1 and _kernels.LAUNCHES["first_occurrence"] == 1


def test_l_entries_marshal(calls):
    side = _side()
    n = 8
    k = torch.arange(n, dtype=torch.int64)
    pay = {"k": k, "v": torch.arange(n, dtype=torch.int32)}
    nulls = {"v": torch.zeros(n, dtype=torch.bool)}
    valid = torch.ones(n, dtype=torch.bool)
    ops = torch.zeros(n, dtype=torch.int32)
    join._apply_side_cuda(side, torch.arange(n, dtype=torch.int32), pay, nulls, valid, ops,
                          ("k", "v"))
    new = _side(cap=128)
    keep = torch.ones(64, dtype=torch.bool)
    src = [*side.rows.values(), *side.row_nulls.values(), side.degree]
    dst = [*new.rows.values(), *new.row_nulls.values(), new.degree]
    join._regrow_entries_cuda(side, new, src, dst, keep, torch.arange(64, dtype=torch.int32))
    assert calls == [("join_apply", "rw_join_apply"), ("join_apply", "rw_join_regrow")]
    assert _kernels.LAUNCHES["join_apply"] == 1 and _kernels.LAUNCHES["join_regrow"] == 1


def test_m_entries_marshal(calls):
    side = _side()
    n = 8
    keys = (torch.arange(n, dtype=torch.int64),)
    valid = torch.ones(n, dtype=torch.bool)
    ops = torch.zeros(n, dtype=torch.int32)
    own = {"x": torch.arange(n, dtype=torch.float64)}
    em = torch.zeros((), dtype=torch.bool)
    rows = torch.zeros((), dtype=torch.int64)
    cols, nulls, out_ops, out_valid = join._probe_pairs_cuda(
        side, keys, valid, ops, own, {}, ("k", "v", "x"), 32, em, rows,
    )
    assert set(cols) == {"k", "v", "x"} and set(nulls) == {"v"}
    assert cols["x"].dtype == torch.float64 and out_valid.shape == (32,)
    ht._lookup_cuda(side.table, keys, valid)
    assert calls == [("join_probe", "rw_join_probe"), ("join_probe", "rw_lookup")]
    assert _kernels.LAUNCHES["join_probe"] == 1 and _kernels.LAUNCHES["lookup"] == 1


def test_h_entry_marshals_masked_lanes_and_survivor_count(calls):
    side = _side()
    lanes, live = integrity.join_side_lanes(side)
    integrity._device_digest_cuda(lanes, sorted(lanes), (live,))
    count = torch.zeros((), dtype=torch.int64)
    integrity._device_digest_cuda(lanes, sorted(lanes), (live,), side.sdirty, count)
    assert calls == [("state_digest", "rw_state_digest")] * 2
