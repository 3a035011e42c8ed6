"""The CUDA wrappers of kernels A, F, H, J, L, M, N, O, P, Q, S, T, U, V, W, X,
Y, Z, AA-AF, AG, AH and AI marshal their arguments as their C entry points
declare them (``_kernels.SIGNATURES``), checked on the CPU: each
wrapper runs on CPU tensors while ``_kernels.call`` is replaced by a
``ctypes.CFUNCTYPE`` callback of the entry point's signature, so a
wrong argument count or type raises here, not on the card. The kernels
themselves are held against their plain versions by ``chip_smoke.py``
on the card.
"""

import ctypes

import numpy as np
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
    monkeypatch.setattr(_kernels, "check_device", lambda name, *tensors: None)
    _kernels.reset_launches()
    return log


def _side(cap=64, fanout=4):
    return join.JoinSide.create(
        cap, fanout, (torch.int64,), {"k": torch.int64, "v": torch.int32}, nullable=("v",),
        device="cpu",
    )


def test_a_entry_marshals(calls):
    """Kernel A: the key descriptor rows and its three output lanes,
    written apart; a valid lane that is not bool and a key lane of
    another dtype are refused."""
    t = ht.HashTable.create(64, (torch.int64, torch.int32), device="cpu")
    n = 10
    keys = (torch.arange(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int32))
    valid = torch.ones(n, dtype=torch.bool)
    gen = t.gen
    _, slots, found, inserted = ht._lookup_or_insert_cuda(t, keys, valid)
    assert slots.shape == found.shape == inserted.shape == (n,)
    assert (slots.dtype, found.dtype, inserted.dtype) == (torch.int32, torch.bool, torch.bool)
    slots.fill_(-1)
    found.fill_(True)
    inserted.fill_(False)
    assert (slots == -1).all() and found.all() and not inserted.any()
    assert t.gen == gen  # the wrapper leaves generations to lookup_or_insert
    with pytest.raises(TypeError, match="bool"):
        ht._lookup_or_insert_cuda(t, keys, valid.to(torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        ht._lookup_or_insert_cuda(t, (keys[0], keys[1].long()), valid)
    assert calls == [("lookup_or_insert", "rw_lookup_or_insert")]
    assert _kernels.LAUNCHES["lookup_or_insert"] == 1


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
    join._apply_side_cuda(side, torch.arange(n, dtype=torch.int32), pay, nulls, valid, ops,
                          ("k", "v"), init_degree=torch.ones(n, dtype=torch.int32))
    with pytest.raises(TypeError):
        join._apply_side_cuda(side, torch.arange(n, dtype=torch.int32), pay, nulls, valid, ops,
                              ("k", "v"), init_degree=torch.ones(n, dtype=torch.int64))
    new = _side(cap=128)
    keep = torch.ones(64, dtype=torch.bool)
    src = [*side.rows.values(), *side.row_nulls.values(), side.degree]
    dst = [*new.rows.values(), *new.row_nulls.values(), new.degree]
    join._regrow_entries_cuda(side, new, src, dst, keep, torch.arange(64, dtype=torch.int32))
    assert calls == [("join_apply", "rw_join_apply")] * 2 + [("join_apply", "rw_join_regrow")]
    assert _kernels.LAUNCHES["join_apply"] == 2 and _kernels.LAUNCHES["join_regrow"] == 1


def test_m_entries_marshal(calls, monkeypatch):
    """Kernel M: every output lane (values, nulls, ops, valid) and slots,
    mc and written are views of one buffer the kernel writes in full, at
    the places the entry is handed, none overlapping; the outer, semi and
    empty (n = 0) arrivals marshal alike; M's lookup entry counts under
    its own key."""
    seen = []
    counted = _kernels.call
    monkeypatch.setattr(_kernels, "call", lambda name, fn, *a: (seen.append(a),
                                                               counted(name, fn, *a)))
    side = _side()
    n = 8
    keys = (torch.arange(n, dtype=torch.int64),)
    valid = torch.ones(n, dtype=torch.bool)
    ops = torch.zeros(n, dtype=torch.int32)
    own = {"x": torch.arange(n, dtype=torch.float64)}
    em = torch.zeros((), dtype=torch.bool)
    rows = torch.zeros((), dtype=torch.int64)
    probed = join._probe_pairs_cuda(side, keys, valid, ops, own, {}, ("k", "v", "x"), ("v",),
                                    32, em, rows)
    assert set(probed.cols) == {"k", "v", "x"} and set(probed.nulls) == {"v"}
    assert probed.cols["x"].dtype == torch.float64 and probed.valid.shape == (32,)
    assert probed.slots.shape == probed.mc.shape == (n,) and probed.written.shape == ()
    lanes = [*probed.cols.values(), *probed.nulls.values(), probed.ops, probed.valid,
             probed.slots, probed.mc, probed.written]
    assert len({t.untyped_storage().data_ptr() for t in lanes}) == 1
    assert probed.cols["v"].dtype == torch.int32 and probed.nulls["v"].dtype == torch.bool
    # an outer arrival: the pairs, then the NULL-padded rows (k, v written 1)
    probed = join._probe_pairs_cuda(side, keys, valid, ops, own, {}, ("k", "v", "x"),
                                    ("k", "v", "x"), 32, em, None, True, join.G2_OUTER)
    assert set(probed.nulls) == {"k", "v", "x"}
    args = seen[-1]
    lanes = [*probed.cols.values(), *probed.nulls.values()]
    outs = list(args[11])[:5 * args[12]]
    assert sorted(outs[2::5]) == sorted(t.data_ptr() for t in lanes)
    assert [args[i] for i in (14, 15, 16, 17, 19)] == [
        t.data_ptr() for t in (probed.ops, probed.valid, probed.slots, probed.mc, probed.written)]
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in lanes + [probed.ops, probed.valid, probed.slots, probed.mc,
                                     probed.written])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and args[18] < spans[0][0]
    # a semi arrival: no pairs, group 2 only
    join._probe_pairs_cuda(side, keys, valid, ops, own, {}, ("x",), (), 32, em, rows, False,
                           join.G2_SEMI)
    empty = join._probe_pairs_cuda(side, (keys[0][:0],), valid[:0], ops[:0], {"x": own["x"][:0]},
                                   {}, ("k", "x"), (), 32, em, rows)
    assert empty.slots.shape == (0,) and empty.valid.shape == (32,)
    ht._lookup_cuda(side.table, keys, valid)
    assert calls == [("join_probe", "rw_join_probe")] * 4 + [("join_probe", "rw_lookup")]
    assert _kernels.LAUNCHES["join_probe"] == 4 and _kernels.LAUNCHES["lookup"] == 1


def test_p_entry_marshals(calls):
    side = _side()
    n = 8
    keys = (torch.arange(n, dtype=torch.int64),)
    valid = torch.ones(n, dtype=torch.bool)
    ops = torch.zeros(n, dtype=torch.int32)
    own = {"x": torch.arange(n, dtype=torch.float64)}
    em = torch.zeros((), dtype=torch.bool)
    rows = torch.zeros((), dtype=torch.int64)
    probed = join._probe_pairs_torch(side, keys, valid, ops, own, {}, ("k", "v", "x"),
                                     ("k", "v", "x"), 32, em, rows, True, join.G2_OUTER)
    for mode in (join.G3_NONE, join.G3_OUTER, join.G3_ANTI, join.G3_SEMI):
        join._degree_emit_cuda(side, probed, ops, 32, em, rows, mode)
    join._degree_emit_cuda(side, probed, ops, 32, em, None, join.G3_OUTER)
    with pytest.raises(TypeError):
        join._degree_emit_cuda(side, probed, ops.to(torch.int64), 32, em, rows, join.G3_OUTER)
    assert calls == [("join_degree", "rw_join_degree")] * 5
    assert _kernels.LAUNCHES["join_degree"] == 5


def test_h_entry_marshals_masked_lanes_and_survivor_count(calls):
    side = _side()
    lanes, live = integrity.join_side_lanes(side)
    integrity._device_digest_cuda(lanes, sorted(lanes), (live,))
    count = torch.zeros((), dtype=torch.int64)
    integrity._device_digest_cuda(lanes, sorted(lanes), (live,), side.sdirty, count)
    assert calls == [("state_digest", "rw_state_digest")] * 2


def test_n_entry_marshals(calls):
    from risingwave_tpu_torch.executors import dynamic_filter as df

    table = ht.HashTable.create(64, (torch.int64,), device="cpu")
    n = 16
    chunk = StreamChunk.from_numpy({"w": torch.arange(n).numpy(), "p": torch.arange(n).numpy()},
                                   n, device="cpu")
    maxes = torch.zeros(64, dtype=torch.int64)
    sdirty = torch.zeros(64, dtype=torch.bool)
    latches = (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    slots = torch.arange(n, dtype=torch.int32)
    inserted = torch.ones(n, dtype=torch.bool)
    ok = df._filter_cuda(table, maxes, sdirty, chunk, chunk.col("p"), slots, inserted, latches)
    assert ok.shape == (n,) and ok.dtype == torch.bool
    with pytest.raises(TypeError, match="one int32 or int64 dtype"):
        df._filter_cuda(table, maxes, sdirty, chunk, chunk.col("p").to(torch.int32), slots,
                        inserted, latches)
    assert calls == [("dyn_filter", "rw_dyn_filter")]
    assert _kernels.LAUNCHES["dyn_filter"] == 1


def test_o_entries_marshal(calls):
    from risingwave_tpu_torch.ops import agg

    table = ht.HashTable.create(64, (torch.int64,), device="cpu")
    ht._expire_table_cuda(table, torch.zeros(64, dtype=torch.bool), 0, 5)
    join._expire_keys_cuda(_side(), 0, 5)
    calls_ = (agg.AggCall("max", "x", "mx"), agg.AggCall("sum", "y", "s"),
              agg.AggCall("count_star", None, "n"))
    dtypes = {"x": torch.float32, "y": torch.float64}
    state = agg.create_state(64, calls_, dtypes, "cpu")
    fx = agg.float_extreme_meta(calls_, dtypes)
    for mark_dirty in (False, True):
        agg._expire_groups_cuda(table, state, calls_, 0, 5, mark_dirty, fx)
    with pytest.raises(TypeError, match="int32 or int64"):
        ht._expire_table_cuda(ht.HashTable.create(64, (torch.float64,), device="cpu"),
                              torch.zeros(64, dtype=torch.bool), 0, 5)
    assert calls == [("expire", "rw_expire_keys"), ("expire", "rw_expire_join")] + [
        ("expire", "rw_expire_agg")] * 2
    assert (_kernels.LAUNCHES["expire"], _kernels.LAUNCHES["expire_join"],
            _kernels.LAUNCHES["expire_agg"]) == (1, 1, 2)
    assert agg._init_bits(0xFFFFFFFF, torch.int64) == 0xFFFFFFFF
    assert agg._init_bits(-(2**63), torch.int64) == -(2**63)


def test_q_entries_marshal(calls):
    from risingwave_tpu_torch.ops import minput as mi

    cap, k, n = 16, 8, 32
    for vals_dt, v in ((torch.int64, torch.arange(n, dtype=torch.int64)),
                       (torch.int64, torch.rand(n, dtype=torch.float64)),
                       (torch.int32, torch.arange(n, dtype=torch.int32))):
        vals = torch.zeros((cap, k), dtype=vals_dt)
        cnt = torch.zeros((cap, k), dtype=torch.int32)
        latch = torch.zeros((), dtype=torch.bool)
        mi._minput_apply_cuda(
            vals, cnt, torch.arange(n, dtype=torch.int32) % cap, torch.ones(n, dtype=torch.int32),
            v, torch.ones(n, dtype=torch.bool), "max", torch.zeros(cap, dtype=vals_dt),
            torch.zeros(cap, dtype=torch.int64), latch, latch,
        )
    with pytest.raises(TypeError, match="int32"):
        mi._minput_apply_cuda(vals, cnt, torch.zeros(n, dtype=torch.int64),
                              torch.ones(n, dtype=torch.int32), v, None, "min",
                              torch.zeros(cap, dtype=vals_dt), torch.zeros(cap, dtype=torch.int64),
                              latch, latch)
    mi._minput_clear_cuda(cnt, torch.full((cap,), -1, dtype=torch.int32))
    nv, nc = torch.zeros((2 * cap, k), dtype=vals_dt), torch.zeros((2 * cap, k), dtype=torch.int32)
    mi._minput_rescatter_cuda(vals, cnt, torch.ones(cap, dtype=torch.bool),
                              torch.arange(cap, dtype=torch.int32), nv, nc)
    assert calls == [("minput", "rw_minput_apply")] * 3 + [
        ("minput", "rw_minput_clear"), ("minput", "rw_minput_rescatter")]
    assert _kernels.LAUNCHES["minput"] == 3 and _kernels.LAUNCHES["minput_clear"] == 1
    assert _kernels.LAUNCHES["minput_rescatter"] == 1


def test_s_entries_marshal(calls):
    """Kernel S: a projection with computed outputs is one rw_project, a
    bare column launches nothing, a filter is one rw_filter (counted as
    expr_filter); a lifted literal needs the parameter operand; a dtype
    the kernel does not take raises, and nothing falls back."""
    from risingwave_tpu_torch.expr.expr import col, lift_literals, lit, param_scope
    from risingwave_tpu_torch.expr.functions import Func
    from risingwave_tpu_torch.ops import expr_vm

    n = 16
    chunk = StreamChunk.from_numpy(
        {"a": torch.arange(n).numpy(), "b": torch.arange(n, dtype=torch.int32).numpy()}, n,
        nulls={"b": (torch.arange(n) % 3 == 0).numpy()}, device="cpu")
    cols, nulls = expr_vm._project_cuda(chunk, (("x", col("a") * 0.5 + col("b")), ("a", col("a")),
                                                ("y", Func("mod", (col("a"), lit(3))))))
    assert cols["a"] is chunk.col("a") and cols["x"].dtype == torch.float64
    assert set(nulls) == {"x", "y"}
    assert expr_vm._project_cuda(chunk, (("a", col("a")),))[0]["a"] is chunk.col("a")
    valid, ops = expr_vm._filter_cuda(chunk, col("b") > 3)
    assert valid.shape == (n,) and ops.dtype == torch.int32
    lifted = lift_literals(col("a") >= 5, ints := [], [])
    with pytest.raises(RuntimeError, match="param_scope"):
        expr_vm._filter_cuda(chunk, lifted)
    with param_scope({"i": torch.tensor(ints), "f": torch.zeros(0, dtype=torch.float64)}):
        expr_vm._filter_cuda(chunk, lifted)
    assert calls == [("expr_eval", "rw_project"), ("expr_eval", "rw_filter"),
                     ("expr_eval", "rw_filter")]
    assert _kernels.LAUNCHES["expr_eval"] == 1 and _kernels.LAUNCHES["expr_filter"] == 2
    odd = StreamChunk.from_numpy({"s": torch.arange(n, dtype=torch.int16).numpy()}, n,
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="kernel S"):
        expr_vm._project_cuda(odd, (("t", col("s") + 1),))


def test_s_descriptor_matches_the_header():
    """The opcode numbers and limits of ops/expr_vm.py are those of
    csrc/expr_vm.cuh, and a packed descriptor has the length rw_project's
    parser checks."""
    import re
    from pathlib import Path

    from risingwave_tpu_torch.expr.expr import col
    from risingwave_tpu_torch.ops import expr_vm

    text = (Path(_kernels.CSRC) / "expr_vm.cuh").read_text()
    enum = dict(re.findall(r"VM_([A-Z0-9_]+) = (\d+)", text))
    assert {k.lower(): int(v) for k, v in enum.items()} == {
        n: d.code for n, d in expr_vm.OPS.items()}
    for name in ("INSN", "REGS", "IN", "OUT", "LITS"):
        got = re.search(rf"#define VM_MAX_{name} (\d+)", text).group(1)
        assert int(got) == getattr(expr_vm, f"VM_MAX_{name}"), name
    chunk = StreamChunk.from_numpy({"a": torch.arange(4).numpy()}, 4, device="cpu")
    prog = expr_vm.program_for((("x", col("a") * 3 + 1), ("y", col("a") > 2)), chunk, False)
    outs = [(torch.empty(4, dtype=dt), None) for _, dt, _, _ in prog.outputs]
    desc = expr_vm.pack_program(prog, expr_vm._input_lanes(prog, chunk), outs)
    assert len(desc) == 5 + 4 * len(prog.insns) + 3 * len(prog.inputs) + 3 * 2 + len(prog.lits)


def test_t_entry_marshals(calls):
    from risingwave_tpu_torch.executors import watermark_filter as wf

    n = 8
    chunk = StreamChunk.from_numpy({"ts": torch.arange(n).numpy() * 10}, n,
                                   ops=[0, 2, 3, 0, 1, 0, 2, 3], device="cpu")
    rmax = torch.full((), wf.INT64_MIN, dtype=torch.int64)
    out = wf._wm_cuda(chunk, rmax, "ts", 25)
    assert out.valid.shape == (n,) and out.ops.dtype == torch.int32
    with pytest.raises(TypeError, match="int64"):
        wf._wm_cuda(StreamChunk.from_numpy({"ts": torch.arange(n, dtype=torch.int32).numpy()},
                                           n, device="cpu"), rmax, "ts", 0)
    assert calls == [("wm_filter", "rw_wm_step")] and _kernels.LAUNCHES["wm_filter"] == 1


def test_s_entries_reuse_the_callers_tree(calls):
    """The executors pass their StaticTree: the program is looked up by
    its memoized key, giving the same program as a lookup by value."""
    from risingwave_tpu_torch.expr.expr import StaticTree, col
    from risingwave_tpu_torch.ops import expr_vm

    n = 8
    chunk = StreamChunk.from_numpy({"a": torch.arange(n).numpy()}, n, device="cpu")
    outs = (("x", col("a") * 2), ("a", col("a")))
    tree = StaticTree(outs)
    for _ in range(2):
        cols, _ = expr_vm._project_cuda(chunk, outs, tree)
    assert cols["a"] is chunk.col("a") and "computed" in tree._memo
    assert expr_vm.program_for(tree._memo["computed"].value, chunk, False) is \
        expr_vm.program_for((("x", col("a") * 2),), chunk, False)
    ptree = StaticTree(col("a") > 1)
    expr_vm._filter_cuda(chunk, ptree.value, ptree)
    assert "keep" in ptree._memo
    assert calls == [("expr_eval", "rw_project")] * 2 + [("expr_eval", "rw_filter")]


def test_u_entry_marshals(calls):
    """Kernel U: group key and payload descriptor rows, the chunk's lanes,
    the bands, the emission columns, three latches and the scratch."""
    from risingwave_tpu_torch.executors import top_n as tn

    g = tn.GroupTopNExecutor(("g",), "v", 3, {"g": torch.int64, "v": torch.int32,
                                             "p": torch.int32, "q": torch.bool},
                             payload=("p", "q"), capacity=32, out_cap=16, device="cpu")
    n = 8
    chunk = StreamChunk.from_numpy({"g": torch.arange(n).numpy() % 3,
                                    "v": torch.arange(n, dtype=torch.int32).numpy(),
                                    "p": torch.arange(n, dtype=torch.int32).numpy(),
                                    "q": (torch.arange(n) % 2 == 0).numpy()}, n, device="cpu")
    slots = torch.arange(n, dtype=torch.int32) % 3
    out = tn._topn_band_cuda(g.table, g.state, chunk, slots, chunk.valid, ("g",), "v", True, 3,
                             ("p", "q"), 16, g.scratch, g._latches)
    assert set(out.columns) == {"g", "v", "p", "q"} and out.columns["v"].dtype == torch.int64
    assert out.valid.shape == (16,) and out.ops.dtype == torch.int32
    with pytest.raises(ValueError, match="k = 65"):
        tn._topn_band_cuda(g.table, g.state, chunk, slots, chunk.valid, ("g",), "v", True, 65,
                           ("p",), 16, g.scratch, g._latches)
    assert calls == [("topn_band", "rw_topn_step")] and _kernels.LAUNCHES["topn_band"] == 1


def test_v_entry_marshals(calls):
    """Kernel V with and without epoch_dirty; a cast lane for a chunk
    column of another dtype."""
    from risingwave_tpu_torch.executors import top_n_plain as tp

    ex = tp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",),
                                         {"g": torch.int64, "id": torch.int64,
                                          "v": torch.float64}, capacity=32, device="cpu")
    n = 8
    chunk = StreamChunk.from_numpy({"g": torch.zeros(n, dtype=torch.int32).numpy(),
                                    "id": torch.arange(n).numpy(),
                                    "v": torch.arange(n, dtype=torch.float64).numpy()}, n,
                                   device="cpu")
    slots = torch.arange(n, dtype=torch.int32)
    for ed in (ex.epoch_dirty, None):
        tp._topn_upsert_cuda(ex.table, ex.rows, ex.sdirty, ed, chunk, slots, ex.names,
                             ex.scratch, ex._dropped)
    assert calls == [("topn_upsert", "rw_topn_upsert")] * 2
    assert _kernels.LAUNCHES["topn_upsert"] == 2


def test_w_and_x_entries_marshal(calls):
    """Kernels W and X: key descriptor rows (lane, dtype code, mode); W's
    fold and select (each reading into a host array), then its sort of
    the candidates (the select's and the packing plan's rows, the sort's
    buffers as one row of pointers), n = 0 launching nothing; X's fold
    (its live count and lanes' bits read into a host array) and its mask
    (the packing plan, the dirty groups' set), each counted under its own
    key."""
    from risingwave_tpu_torch.executors import top_n_plain as tp

    ex = tp.RetractableGroupTopNExecutor(("g",), "v", 2, ("id",),
                                         {"g": torch.int32, "id": torch.int64,
                                          "v": torch.float32}, capacity=64, device="cpu")
    idx, alive = tp._rank_top_cuda(ex.table, ex.rows["v"], 10, True)
    assert idx.shape == (10,) and idx.dtype == torch.int32 and alive.dtype == torch.bool
    assert tp._rank_top_cuda(ex.table, ex.rows["v"], 0, True)[0].shape == (0,)
    in_topk, gdirty = tp._group_topk_mask_cuda(ex.table, ex.rows, ex.epoch_dirty, 2, False,
                                               (ex.rows["g"],), "v")
    assert in_topk.shape == gdirty.shape == (64,)
    with pytest.raises(ValueError, match="sort keys"):
        tp._key_rows([(ex.table.live, 0)] * (tp.RANK_KEYS + 1))
    assert calls == [("topn_rank", "rw_rank_fold"), ("topn_rank", "rw_rank_select"),
                     ("topn_rank", "rw_rank_top"), ("topn_rank", "rw_group_topk_fold"),
                     ("topn_rank", "rw_group_topk_mask")]
    assert _kernels.LAUNCHES["topn_rank"] == 1 and _kernels.LAUNCHES["group_topk"] == 1
    assert _kernels.LAUNCHES["group_topk_fold"] == 1
    assert _kernels.LAUNCHES["rank_fold"] == _kernels.LAUNCHES["rank_select"] == 1


def test_x_long_runs_and_wide_groups_marshal(monkeypatch):
    """Kernel X over ten group lanes and a pk (twelve sort keys, its
    limit; its set of dirty groups takes one key lane per group lane):
    when the mask reads back tie runs longer than ``TOPK_LONG_RUN``, the
    wrapper sorts them with ``rw_group_topk_long``, handing it the
    mask's half of the sorted slots and the runs' count and rows. An
    eleventh group lane is refused."""
    from risingwave_tpu_torch.executors import top_n_plain as tp
    from risingwave_tpu_torch.ops.hash_table import HashTable

    log = []

    def call(name, fn, *args):
        def body(*a):
            if fn == "rw_group_topk_fold":  # n_live 40, n_dirty 3
                host = ctypes.cast(a[8], ctypes.POINTER(ctypes.c_int64))
                host[0], host[1] = 40, 3
            if fn == "rw_group_topk_mask":  # 2 long runs of 30 rows, half 1
                host = ctypes.cast(a[17], ctypes.POINTER(ctypes.c_int64))
                host[0], host[1], host[2] = 2, 30, 1
            log.append((fn, a))
            return 0

        proto = ctypes.CFUNCTYPE(ctypes.c_int, *_kernels.SIGNATURES[name][fn])
        assert proto(body)(*args, None) == 0
        _kernels.LAUNCHES[_kernels.ENTRY_KEYS.get(fn, name)] += 1

    monkeypatch.setattr(_kernels, "call", call)
    monkeypatch.setattr(_kernels, "check_cuda", lambda name, *t, n=None: None)
    _kernels.reset_launches()
    cap = 64
    for n_group in (10, 11):
        table = HashTable.create(cap, (torch.int64,) * (n_group + 1), device="cpu")
        glanes = tuple(torch.zeros(cap, dtype=torch.int64) for _ in range(n_group))
        rows = {"v": torch.zeros(cap, dtype=torch.float64)}
        dirty = torch.zeros(cap, dtype=torch.bool)
        if n_group == 11:
            with pytest.raises(ValueError, match="sort keys"):
                tp._group_topk_mask_cuda(table, rows, dirty, 3, True, glanes, "v")
            continue
        in_topk, gdirty = tp._group_topk_mask_cuda(table, rows, dirty, 3, True, glanes, "v")
        assert in_topk.shape == gdirty.shape == (cap,)
    assert [fn for fn, _ in log] == ["rw_group_topk_fold", "rw_group_topk_mask",
                                     "rw_group_topk_long"]
    mask, long = log[1][1], log[2][1]
    assert mask[1] == 12 and mask[2] == 10 and mask[9] > 0  # keys, group lanes, the set
    assert long[1:5] == (12, 10, 1, 3)  # keys, group lanes, exact (no varying bit), k
    assert long[5] == mask[12] + 1 * 40 * 4  # the sorted slots: half 1 of idx_buf
    assert long[6] == mask[14] and long[8:10] == (2, 30)  # work, the runs and their rows
    assert long[16] == mask[15]  # in_topk
    assert _kernels.LAUNCHES["group_topk_long"] == 1 and _kernels.LAUNCHES["group_topk"] == 1


def test_y_entry_marshals(calls):
    """Kernel Y: kernel B's call rows (a COUNT(*), a nullable int32 SUM,
    a float64 MIN, a float32 SUM) over the chunk's valid and ops lanes."""
    from risingwave_tpu_torch.executors import simple_agg as sa
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops.agg import AggCall

    agg_calls = (AggCall("count_star", None, "c"), AggCall("sum", "i", "s"),
                 AggCall("min", "f", "m"), AggCall("sum", "g", "sg"))
    dtypes = {"i": torch.int32, "f": torch.float64, "g": torch.float32}
    st = agg_ops.create_state(2, agg_calls, dtypes, "cpu")
    n = 8
    cols = {"i": torch.arange(n, dtype=torch.int32).numpy(),
            "f": torch.arange(n, dtype=torch.float64).numpy(),
            "g": torch.arange(n, dtype=torch.float32).numpy()}
    chunk = StreamChunk.from_numpy(cols, n, nulls={"i": (torch.arange(n) % 2 == 0).numpy()},
                                   device="cpu")
    sa._simple_step_cuda(st, chunk, agg_calls)
    assert calls == [("simple_agg", "rw_simple_apply")]
    assert _kernels.LAUNCHES["simple_agg"] == 1


def test_z_entries_marshal(calls):
    """Kernel Z's left step (row lanes of 8 and 4 bytes, a cast lane) and
    its diff, each counted under its own key."""
    from risingwave_tpu_torch.executors import dynamic_filter as df

    ex = df.DynamicFilterExecutor("v", ">=", ("id",),
                                  {"id": torch.int64, "name": torch.int32, "v": torch.int64},
                                  capacity=64, device="cpu")
    n = 8
    chunk = StreamChunk.from_numpy({"id": torch.arange(n).numpy(),
                                    "name": torch.arange(n).numpy(),  # int64: cast on write
                                    "v": torch.arange(n).numpy()}, n, device="cpu")
    slots = torch.arange(n, dtype=torch.int32)
    ok = df._dyn_left_cuda(ex.table, ex.rows, ex.passing, ex.sdirty, ex.scratch, chunk, slots,
                           ex.rv, ex.rv_valid, ex.op, ex.value_col, ex._dropped)
    assert ok.shape == (n,) and ok.dtype == torch.bool
    sel, now, _, _ = df._dyn_rv_diff_cuda(ex.table, ex.rows["v"], ex.passing, ex.sdirty, ex.rv,
                                          ex.rv_valid, ex.op, ex._dropped)
    assert sel.dtype == torch.int32 and now.dtype == torch.bool
    assert calls == [("dyn_general", "rw_dyn_left_step"), ("dyn_general", "rw_dyn_rv_diff")]
    assert _kernels.LAUNCHES["dyn_general"] == 1 and _kernels.LAUNCHES["dyn_rv_diff"] == 1


def test_aa_entries_marshal(calls):
    """Kernel AA's three entries: lanes of 8, 4 and 1 bytes in one table
    (a bid-like chunk with an int32 dictionary lane and a null lane), the
    element pointers of unnest, the series' int32 and int64 bounds with
    their null lanes, the truncation latch of both, and Expand's subset
    null lanes (mode 1) beside the tiled ones; each counted under its own
    key."""
    import numpy as np

    from risingwave_tpu_torch.array.composite import encode_column
    from risingwave_tpu_torch.executors import expand as ex_mod
    from risingwave_tpu_torch.executors import project_set as ps
    from risingwave_tpu_torch.types import DataType, Field

    n = 8
    lanes, nulls = encode_column(Field("xs", DataType.LIST, elem=DataType.INT64, list_cap=4),
                                 [[1, 2], [], None, [3, 4, 5, 6], [7], [8], [9], [1, 1, 1]])
    lanes.update(k=np.arange(n, dtype=np.int64), ch=np.arange(n, dtype=np.int32),
                 lo=np.arange(n, dtype=np.int32), hi=np.arange(n, dtype=np.int64) + 2)
    nulls = {**nulls, "ch": np.arange(n) % 3 == 0, "lo": np.arange(n) % 4 == 1}
    chunk = StreamChunk.from_numpy(lanes, n, nulls=nulls, device="cpu")
    latch = torch.zeros((), dtype=torch.bool)
    out = ps._unnest_cuda(chunk, "xs", "x", 4, True, latch)
    assert out.capacity == 4 * n and "xs.0" not in out.columns and "xs.#" not in out.nulls
    assert out.col("x").dtype == torch.int64 and out.col("projected_row_id").dtype == torch.int64
    assert out.col("ch").dtype == torch.int32 and set(out.nulls) == {"ch", "lo"}
    out = ps._series_cuda(chunk, "lo", "hi", "v", 3, False, latch)
    assert out.capacity == 3 * n and out.col("v").dtype == torch.int64
    assert "projected_row_id" not in out.columns
    out = ex_mod._expand_cuda(chunk, (("k", "ch"), ("k",), ()), ("ch", "k"), "flag")
    assert out.capacity == 3 * n and out.col("flag").dtype == torch.int64
    assert set(out.nulls) == {"ch", "k", "lo", "xs.#"}
    with pytest.raises(ValueError, match="copies"):
        ps._series_cuda(chunk, "lo", "hi", "v", ps.TILE_COPIES + 1, False)
    with pytest.raises(TypeError, match="latch"):
        ps._series_cuda(chunk, "lo", "hi", "v", 3, False, torch.zeros(2, dtype=torch.bool))
    assert calls == [("tile_expand", "rw_unnest"), ("tile_expand", "rw_series"),
                     ("tile_expand", "rw_expand")]
    assert [_kernels.LAUNCHES[k] for k in ("unnest", "series", "expand")] == [1, 1, 1]


def test_ab_entry_marshals(calls):
    """Kernel AB: an int64 and an int32 key lane, value lanes of 8, 4 and
    1 bytes, one with the MV's null lane and one without, both join
    types."""
    from risingwave_tpu_torch.executors import temporal_join as tj

    cap, n = 64, 8
    table = ht.HashTable.create(cap, (torch.int64, torch.int32), device="cpu")
    values = {"a": torch.zeros(cap, dtype=torch.int64), "b": torch.zeros(cap, dtype=torch.int32),
              "c": torch.zeros(cap, dtype=torch.bool)}
    vnulls = {"b": torch.zeros(cap, dtype=torch.bool)}
    chunk = StreamChunk.from_numpy({"k": torch.arange(n).numpy()}, n, device="cpu")
    keys = (torch.arange(n, dtype=torch.int64), torch.arange(n, dtype=torch.int32))
    key_ok = torch.ones(n, dtype=torch.bool)
    for jt in ("inner", "left"):
        out = tj._probe_cuda(table, values, vnulls, chunk, keys, key_ok, ("a", "b", "c"), jt)
        assert {c: out.col(c).dtype for c in "abc"} == {c: values[c].dtype for c in "abc"}
        assert set(out.nulls) == {"a", "b", "c"} and out.ops is chunk.ops
    with pytest.raises(TypeError, match="dtype"):
        tj._probe_cuda(table, values, vnulls, chunk, (keys[0], keys[0]), key_ok, ("a",), "left")
    assert calls == [("temporal_probe", "rw_temporal_probe")] * 2
    assert _kernels.LAUNCHES["temporal_probe"] == 2


def test_ac_entries_marshal(calls):
    """Kernel AC: an append of int64, int32-cast and bool lanes with a
    null lane, and an emit (its count written through a host pointer)."""
    from risingwave_tpu_torch.executors import sort as so

    cap, n = 64, 16
    buf = {"ts": torch.zeros(cap, dtype=torch.int64), "v": torch.zeros(cap, dtype=torch.int64)}
    bnulls = {"v": torch.zeros(cap, dtype=torch.bool)}
    valid = torch.zeros(cap, dtype=torch.bool)
    seq = torch.zeros(cap, dtype=torch.int64)
    nxt = torch.zeros((), dtype=torch.int64)
    ovf, dele = torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool)
    chunk = StreamChunk.from_numpy({"ts": torch.arange(n).numpy(),
                                    "v": torch.arange(n, dtype=torch.int32).numpy()}, n,
                                   device="cpu")
    scratch = so.arena_scratch(cap, n, "cpu")
    so._arena_append_cuda(buf, bnulls, valid, seq, nxt, chunk, ("ts", "v"), ovf, dele, scratch)
    cols, nulls, out_valid, m = so._arena_emit_cuda(buf, bnulls, valid, seq, 5, ("ts", "v"), "ts",
                                                    scratch)
    assert m == 0 and set(cols) == {"ts", "v"} and set(nulls) == {"v"}
    assert out_valid.shape == (cap,)
    with pytest.raises(ValueError, match="arena_scratch"):
        so._arena_append_cuda(buf, bnulls, valid, seq, nxt, chunk, ("ts",), ovf, dele, None)
    assert calls == [("arena", "rw_arena_append"), ("arena", "rw_arena_emit")]
    assert _kernels.LAUNCHES["arena"] == 1 and _kernels.LAUNCHES["arena_emit"] == 1


def _ow_calls():
    from risingwave_tpu_torch.executors import over_window as ow

    return ow, (ow.WindowCall("row_number", None, "rn"), ow.WindowCall("sum", "x", "sx"),
                ow.WindowCall("min", "x", "mn"), ow.WindowCall("lag", "x", "lg"),
                ow.WindowCall("rank", "o", "rk"))


def test_ad_entry_marshals(calls):
    """Kernel AD: five calls (an int32 input cast to int64, a null lane),
    each call's accumulator lanes in ``_accum_names`` order."""
    ow, wc = _ow_calls()
    cap, n = 64, 16
    ex = ow.OverWindowExecutor(("p",), wc, {"p": torch.int64, "x": torch.int32,
                                            "o": torch.int64}, capacity=cap, device="cpu")
    chunk = StreamChunk.from_numpy({"p": torch.arange(n).numpy(),
                                    "x": torch.arange(n, dtype=torch.int32).numpy(),
                                    "o": torch.arange(n).numpy()}, n,
                                   nulls={"x": torch.zeros(n, dtype=torch.bool).numpy()},
                                   device="cpu")
    slots = torch.arange(n, dtype=torch.int32)
    lat = tuple(torch.zeros((), dtype=torch.bool) for _ in range(3))
    outs, nulls = ow._over_step_cuda(ex.table, ex.accums, ex.sdirty, chunk, slots, wc, lat, None)
    assert set(outs) == {"rn", "sx", "mn", "lg", "rk"} and set(nulls) == {"mn", "lg"}
    assert calls == [("over_step", "rw_over_step")] and _kernels.LAUNCHES["over_step"] == 1


def test_ae_and_af_entries_marshal(calls):
    """Kernels AE and AF: the EOWC emit's order and calls (an int32 order
    lane, a gathered null lane), and the general step's apply, order,
    calls and diff (key lanes with their emitted fallbacks, the ABSENT
    key, ghost entries)."""
    ow, wc = _ow_calls()
    cap, n = 64, 16
    dt = {"p": torch.int64, "o": torch.int32, "x": torch.int64}
    ex = ow.EowcOverWindowExecutor(("p",), "o", wc, dt, capacity=cap, nullable=("x",),
                                   device="cpu")
    scr = ow.window_scratch(cap, ow._window_scan_lanes(wc), "cpu")
    out = ow._eowc_emit_cuda(ex.buf, ex.bnulls, ex.valid, ex.seq, 3, ex.names, wc, ("p",), "o",
                             "p", scr)
    assert out[3] == 0  # the callback closes nothing
    g = ow.GeneralOverWindowExecutor(("p",), "o", ("id",), wc,
                                     {"id": torch.int64, **dt}, capacity=cap, nullable=("x",),
                                     device="cpu")
    chunk = StreamChunk.from_numpy({"id": torch.arange(n).numpy(), "p": torch.arange(n).numpy(),
                                    "o": torch.arange(n, dtype=torch.int32).numpy(),
                                    "x": torch.arange(n).numpy()}, n, device="cpu")
    slots = torch.arange(n, dtype=torch.int32)
    st = g._state()
    lat = (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    touched, ghost, gslots = ow._over_apply_cuda(g.table, slots, torch.zeros(n, dtype=torch.bool),
                                                 st, chunk, ("p",), g.lane_names, 0, lat,
                                                 ow.apply_scratch(cap, "cpu"))
    assert touched.shape == (cap,) and ghost.shape == gslots.shape == (n,)
    new_out, new_nulls, dirty = ow._general_recompute_cuda(st, touched, ghost, gslots, wc, ("p",),
                                                           "o", None)
    assert set(new_out) == set(new_nulls) == {c.output for c in wc} and dirty.shape == (cap,)
    ops = (torch.ones(cap, dtype=torch.int32), torch.zeros(cap, dtype=torch.int32))
    ret, ins = ow._over_diff_cuda(st, g.emnulls, new_out, new_nulls, dirty, g.lane_names,
                                  g.out_names, *ops, None)
    assert set(ret.nulls) == set() and set(ins.nulls) == {"x", *new_out}
    assert set(g.emnulls) == set(g.lane_names + g.out_names)
    assert calls == [("window_calls", "rw_window_fold"), ("over_diff", "rw_over_apply"),
                     ("window_calls", "rw_window_fold"), ("window_calls", "rw_window_calls"),
                     ("over_diff", "rw_over_diff")]
    assert [_kernels.LAUNCHES[k] for k in ("window_fold", "window_order", "window_calls",
                                           "over_apply", "over_diff")] == [2, 0, 1, 1, 1]


def test_ae_order_and_calls_marshal_past_64_bits(monkeypatch):
    """Kernel AE when the fold reads back members: the plan from the fold
    (two 40-bit partition lanes, the order lane and seq: 118 bits, two
    words) goes to ``rw_window_order``, and where the sort left its words
    and places, with each word's partition and order masks, to
    ``rw_window_calls``; a second input lane (``o`` for lag) widens the
    laid-out inputs. Then the sort alone (``onesweep_sort``)."""
    from risingwave_tpu_torch.executors import over_window as ow

    log = []
    span = (1 << 40) - 1
    # per key lane: OR, AND, MIN, MAX of the encoded keys (bit 63 flipped)
    fold = [(span | 1 << 63, 1 << 63, 1 << 63, span | 1 << 63)] * 2
    fold += [(255 | 1 << 63, 1 << 63, 1 << 63, 255 | 1 << 63)] * 2

    def call(name, fn, *args):
        def body(*a):
            if fn == "rw_window_fold":
                host = ctypes.cast(a[13], ctypes.POINTER(ctypes.c_int64))
                host[0] = 20
                for i, w in enumerate(v for f in fold for v in f):
                    host[1 + i] = w - (1 << 64) if w >> 63 else w
            if fn in ("rw_window_order", "rw_onesweep_sort"):
                host = ctypes.cast(a[-2], ctypes.POINTER(ctypes.c_int64))
                host[0], host[1] = 1 << 20, 1 << 21
            log.append((fn, a))
            return 0

        proto = ctypes.CFUNCTYPE(ctypes.c_int, *_kernels.SIGNATURES[name][fn])
        assert proto(body)(*args, None) == 0
        _kernels.LAUNCHES[_kernels.ENTRY_KEYS.get(fn, name)] += 1

    monkeypatch.setattr(_kernels, "call", call)
    monkeypatch.setattr(_kernels, "check_cuda", lambda name, *t, n=None: None)
    _kernels.reset_launches()
    cap = 64
    wc = (ow.WindowCall("row_number", None, "rn"), ow.WindowCall("sum", "x", "sx"),
          ow.WindowCall("lag", "o", "lg"), ow.WindowCall("max", "x", "mx"))
    dt = {"p": torch.int64, "q": torch.int64, "o": torch.int64, "x": torch.int64}
    ex = ow.EowcOverWindowExecutor(("p", "q"), "o", wc, dt, win_col="p", capacity=cap,
                                   nullable=("x",), device="cpu")
    scr = ow.window_scratch(cap, ow._window_scan_lanes(wc), "cpu")
    out = ow._eowc_emit_cuda(ex.buf, ex.bnulls, ex.valid, ex.seq, 3, ex.names, wc, ("p", "q"),
                             "o", "p", scr)
    assert out[3] == 20 and out[2].shape == (cap,)
    assert [fn for fn, _ in log] == ["rw_window_fold", "rw_window_order", "rw_window_calls"]
    order, calls_args = log[1][1], log[2][1]
    plan = ow.window_pack_plan(fold, 2, 2)
    assert plan.words == 2 and plan.bits == 40 + 40 + 8 + 8
    assert order[12] == 20 and order[14] == scr["words"].data_ptr()
    assert scr["words"].numel() >= 2 * cap  # grown once for the second word
    assert calls_args[6] == 20 and calls_args[7] == 0 and calls_args[9] == 2  # m, sorted, words
    assert calls_args[14] == 2 and scr["sv"].numel() == 2 * cap  # inputs x and o, made once
    keys, places = ow.onesweep_sort(torch.arange(20, dtype=torch.int64) << 30, scr, 0b11000)
    assert log[-1][0] == "rw_onesweep_sort" and log[-1][1][3] == 0b11000  # bytes 3, 4
    assert keys.shape == places.shape == (20,)
    assert [_kernels.LAUNCHES[k] for k in ("window_fold", "window_order", "window_calls",
                                           "onesweep")] == [1, 1, 1, 1]


def test_ag_entries_marshal(calls):
    """Kernel AG: the select in its three modes (an agg state's marks, a
    join side's with and without ``ddirty``, the merge candidates) and
    the merge over an agg state's lanes, every op and dtype, the
    parameters counted by the callback."""
    from risingwave_tpu_torch.ops import agg
    from risingwave_tpu_torch.ops import checkpoint as ck
    from risingwave_tpu_torch.ops import cold_tier as ct

    cap, n = 4096, 24
    table = ht.HashTable.create(cap, (torch.int64,), device="cpu")
    z = lambda: torch.zeros(cap, dtype=torch.bool)
    sel, hot, status = ct._cold_select_launch(ct.AGG, table.fp1, table.live, z(), z(), z(), z())
    assert sel.shape == hot.shape == (cap,) and status.shape == (3,)
    ct._cold_select_launch(ct.JOIN, table.fp1, table.live, z(), z(), ddirty=z())
    ct._cold_select_launch(ct.JOIN, table.fp1, table.live, z(), z())
    sel, hot, _ = ct._cold_select_launch(ct.MERGE, table.fp1, table.live, z(), z())
    assert hot is None
    with pytest.raises(TypeError, match="bool marks"):
        ct._cold_select_launch(ct.JOIN, table.fp1, table.live, z(), z().to(torch.int8))
    calls_ = (agg.AggCall("count_star", None, "n"), agg.AggCall("sum", "f", "sf"),
              agg.AggCall("sum", "h", "sh"), agg.AggCall("min", "f", "mnf"),
              agg.AggCall("max", "w", "mxw"))
    st = agg.create_state(cap, calls_, {"f": torch.float64, "h": torch.float32,
                                        "w": torch.int32}, device="cpu")
    lanes = ct.agg_merge_lanes(st, calls_)
    assert {ln.op for ln in lanes} == {ct.SET, ct.ADD, ct.MIN, ct.MAX, ct.TRUE}
    with_rows = {ln.name: ln.dst for ln in lanes if ln.op != ct.TRUE}
    layout, total = ck._layout(with_rows, n)
    packed = torch.zeros(total, dtype=torch.uint8)
    ct._cold_merge_launch(lanes, torch.arange(n, dtype=torch.int32), packed, layout,
                          st.row_count, table.live)
    with pytest.raises(TypeError, match="int32 slots"):
        ct._cold_merge_launch(lanes, torch.arange(n), packed, layout, st.row_count, table.live)
    assert calls == [("cold_tier", "rw_cold_select")] * 4 + [("cold_tier", "rw_cold_merge")]
    assert _kernels.LAUNCHES["cold_select"] == 4 and _kernels.LAUNCHES["cold_merge"] == 1
    with pytest.raises(TypeError, match="integer lanes"):
        ct.cold_merge([ct.MergeLane("x", torch.zeros(cap), ct.MIN)],
                      torch.arange(2, dtype=torch.int32), {"x": np.zeros(2)}, st.row_count,
                      table.live)


def test_ah_entries_marshal(calls):
    from risingwave_tpu_torch.ops import hashing

    n = 16
    k64 = torch.arange(n, dtype=torch.int64)
    wide = torch.zeros((n, 3), dtype=torch.float64)  # a strided lane
    valid = torch.ones(n, dtype=torch.bool)
    vn = hashing._vnode_of_cuda([k64, wide[:, 1]])
    assert vn.shape == (n,) and vn.dtype == torch.int32
    masks = hashing._vnode_dispatch_cuda([k64, torch.zeros(n, dtype=torch.bool)], valid, 4)
    assert masks.shape == (4, n) and masks.dtype == torch.bool
    with pytest.raises(TypeError):  # no plain fallback for a lane AH does not take
        hashing._vnode_of_cuda([torch.zeros(n, dtype=torch.int16)])
    with pytest.raises(ValueError):
        hashing._vnode_dispatch_cuda([k64[:8]], valid, 2)
    assert calls == [("vnode_dispatch", "rw_vnode_of"), ("vnode_dispatch", "rw_vnode_dispatch")]
    assert _kernels.LAUNCHES["vnode_of"] == 1 and _kernels.LAUNCHES["vnode_dispatch"] == 1


def test_ai_entry_marshals(calls):
    from risingwave_tpu_torch.parallel import exchange

    n, cap = 4, 40
    key = torch.arange(n * cap, dtype=torch.int64).reshape(n, cap)
    f32 = torch.zeros(cap, dtype=torch.float32).unsqueeze(0).expand(n, cap)  # a broadcast lane
    valid = torch.ones((n, cap), dtype=torch.bool)
    chunk = StreamChunk({"k": key, "f": f32}, valid, {"f": torch.zeros_like(valid)},
                        torch.zeros((n, cap), dtype=torch.int32))
    got, vbuf, overflow, counts = exchange._exchange_cuda(
        exchange.exchange_cols(chunk), valid, (key, f32), n, 16)
    assert got["k"].shape == vbuf.shape == (n, n * 16) and got["__ops__"].dtype == torch.int32
    assert overflow.shape == (n,) and counts.shape == (n, n) and counts.dtype == torch.int32
    with pytest.raises(TypeError):  # no plain fallback for a key lane AI does not take
        exchange._exchange_cuda({"k": key}, valid, (key.to(torch.int16),), n, 16)
    with pytest.raises(ValueError):
        exchange._exchange_cuda({"k": key}, valid, (key[:, :8],), n, 16)
    with pytest.raises(ValueError):
        exchange._exchange_cuda({"k": key}, valid, (key,), exchange.MAX_SHARDS + 1, 16)
    assert calls == [("exchange", "rw_exchange")]
    assert _kernels.LAUNCHES["exchange"] == 1


def test_ai_checks_every_lane(calls, monkeypatch):
    """AI's wrapper hands ``check_device`` every lane it passes by pointer
    (valid, each key, each source lane), so a chunk that mixes devices
    raises before the launch; the outputs are views of the one buffer it
    allocates there."""
    from risingwave_tpu_torch.parallel import exchange

    seen = []
    monkeypatch.setattr(_kernels, "check_device", lambda name, *ts: seen.extend(ts))
    n, cap = 2, 8
    key = torch.arange(n * cap, dtype=torch.int64).reshape(n, cap)
    lanes = {"k": key, "v": torch.ones((n, cap), dtype=torch.int32)}
    valid = torch.ones((n, cap), dtype=torch.bool)
    got, vbuf, overflow, counts = exchange._exchange_cuda(lanes, valid, (key, lanes["v"]), n, 8)
    assert len(seen) == 1 + 2 + len(lanes)
    ptrs = {t.data_ptr() for t in seen}
    for t in (valid, key, lanes["v"]):
        assert t.data_ptr() in ptrs
    base = vbuf.untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base for o in got.values())
    # the counts and flags, which callers keep, hold no lane alive
    assert counts.untyped_storage().data_ptr() == overflow.untyped_storage().data_ptr() != base
    assert counts.untyped_storage().nbytes() == 4 * n * n + n
    with pytest.raises(ValueError, match="one CUDA device"):
        monkeypatch.undo()
        exchange._exchange_cuda(lanes, valid, (key,), n, 8)


def _recorded(monkeypatch):
    """Record each launch's arguments on top of the ``calls`` fixture."""
    args = []
    inner = _kernels.call

    def call(name, fn, *a):
        args.append(a)
        inner(name, fn, *a)

    monkeypatch.setattr(_kernels, "call", call)
    return args


@pytest.mark.parametrize("n", [0, 1, 2049])
def test_f_entry_marshals(calls, monkeypatch, n):
    """Kernel F: the key rows, the lane rows (w first), rep_valid, the
    latch and one scratch buffer of ``reduce_scratch_bytes`` bytes with its
    size beside it; the stream last (the fixture's callback has the
    signature's every argument)."""
    from risingwave_tpu_torch.ops import agg

    args = _recorded(monkeypatch)
    keys = (torch.arange(n, dtype=torch.int64), torch.zeros(n, dtype=torch.float64))
    signs = torch.ones(n, dtype=torch.int32)
    calls_ = (agg.AggCall("count_star", None, "c"), agg.AggCall("sum", "v", "s"),
              agg.AggCall("max", "f", "m"))
    values = {"v": torch.arange(n, dtype=torch.int32), "f": torch.zeros(n, dtype=torch.float32)}
    sk, rep, w, red, mret = agg._reduce_by_key_cuda(keys, signs, calls_, values, {})
    assert [k.dtype for k in sk] == [torch.int64, torch.float64] and sk[0].shape == (n,)
    assert rep.dtype == torch.bool and w.dtype == torch.int64 and mret.shape == ()
    assert sorted(red) == ["ext_m", "nn_s", "nnp_m", "sum_s"]
    (a,) = args
    n_lanes = a[7]
    assert n_lanes == 1 + len(red)
    assert a[-1] == agg.reduce_scratch_bytes(n, n_lanes)
    assert calls == [("reduce_by_key", "rw_reduce_by_key")]
    assert _kernels.LAUNCHES["reduce_by_key"] == 1


def test_f_scratch_holds_every_region():
    """``reduce_scratch_bytes`` counts what ``rw_reduce_by_key`` carves:
    two (key, row) sort buffers, 8 x 256 digit counts, eight passes'
    look-back words and counters, and per reduce tile a flag, three int32
    records and three int64 records a lane, each region 256-aligned."""
    from risingwave_tpu_torch.ops import agg

    for n in (0, 1, 2048, 2049, 5 * 2048 + 3):
        tiles = -(-n // 2048)
        least = 24 * n + 4 * 8 * 256 + 4 * 8 * (256 * tiles + 1) + 4 * (tiles + 1) + 12 * tiles
        for lanes in (1, 20):
            got = agg.reduce_scratch_bytes(n, lanes)
            assert least + 24 * tiles * lanes <= got <= least + 24 * tiles * lanes + 13 * 256


def test_ai_entry_passes_one_buffer(calls, monkeypatch):
    """Kernel AI: the output lanes, valid and the scratch are 16-aligned,
    disjoint regions of one buffer whose size is passed for the one
    memset; the scratch holds a word per (source, tile, destination) and
    the counter; the counts and flags are views of a small buffer of
    their own."""
    from risingwave_tpu_torch.parallel import exchange

    args = _recorded(monkeypatch)
    n, cap, bc = 3, 2 * 2048 + 5, 7
    lanes = {"a": torch.zeros((n, cap), dtype=torch.int64),
             "b": torch.zeros((n, cap), dtype=torch.bool),
             "c": torch.zeros((n, cap), dtype=torch.float32)}
    valid = torch.ones((n, cap), dtype=torch.bool)
    got, vbuf, overflow, counts = exchange._exchange_cuda(lanes, valid, (lanes["a"],), n, bc)
    (a,) = args
    base, total = a[-2], a[-1]
    offs, v_at, s_at, size = exchange.exchange_buffer_layout([8, 1, 4], n, n * bc, cap)
    assert total == size == s_at + 4 * exchange.exchange_scratch_words(n, cap)
    assert exchange.exchange_scratch_words(n, cap) == n * 3 * n + 1
    assert (a[9], a[10], a[11], a[12]) == (base + v_at, counts.data_ptr(), overflow.data_ptr(),
                                           base + s_at)
    assert overflow.data_ptr() == counts.data_ptr() + 4 * n * n
    regions = [(at, at + n * n * bc * es) for at, es in zip(offs, (8, 1, 4))]
    regions += [(v_at, v_at + n * n * bc), (s_at, total)]
    assert all(lo % 16 == 0 for lo, _ in regions)
    assert all(hi <= lo2 for (_, hi), (lo2, _) in zip(regions, regions[1:]))
    assert [o.data_ptr() - base for o in got.values()] == offs
    assert vbuf.data_ptr() - base == v_at
    assert counts.shape == (n, n) and overflow.shape == (n,) and vbuf.shape == (n, n * bc)
