"""Kernel AE's packed sort key, checked on the CPU.

``over_window.window_pack_plan`` plans one key from the fold of each key
lane over a domain's members (OR, AND, MIN, MAX of the encoded keys);
kernel AE writes it once per member in entry order and sorts it with
stable single-sweep LSD radix passes over the bytes the plan marks, least
significant word first. Here that sort is emulated in plain Python on
lanes made with numpy from a seed, the members' keys read as the kernel
reads them (a slot that is not present and a ghost read the emitted
lane), and held against the order the plain versions take
(``over_window._lexsort``, most significant key first, ties by entry);
segment heads and value-group starts from the plan's masks against the
lanes themselves.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu_torch.executors import over_window as ow

M64 = (1 << 64) - 1
I64_MIN, I64_MAX = -(2**63), 2**63 - 1


def _enc(v: int) -> int:
    """A signed key as the kernel encodes it: bit 63 flipped."""
    return (int(v) & M64) ^ (1 << 63)


def _fold(rows):
    """Per lane: OR, AND, MIN, MAX of the members' encoded keys."""
    out = []
    for lane in zip(*rows):
        o, a = 0, M64
        for v in lane:
            o |= v
            a &= v
        out.append((o, a, min(lane), max(lane)))
    return out


def _kernel_order(plan, rows):
    """The kernel's order of the members (entry order in, stable LSD
    byte passes over each word's marked bytes, last word first)."""
    keys = [plan.split(plan.pack(r)) for r in rows]
    perm = list(range(len(rows)))
    for w in reversed(range(plan.words)):
        for b in range(8):
            if (plan.pass_masks[w] >> b) & 1:
                perm.sort(key=lambda i: (keys[i][w] >> (8 * b)) & 0xFF)
    return perm


def _check(rows, n_part, order_lane, want):
    """``rows``: each member's encoded keys in entry order; ``want``: the
    plain versions' order of the members."""
    plan = ow.window_pack_plan(_fold(rows), n_part, order_lane)
    assert plan.bits == sum(f[2] for f in plan.fields)
    assert plan.words == -(-plan.bits // 64)
    fold = _fold(rows)
    for lane, lo, width, _, lo_key in plan.fields:
        o, a, mn, mx = fold[lane]
        span = (o ^ a) & M64
        assert lo_key == mn and (mx - mn) >> lo < 1 << width
        assert width <= span.bit_length() - lo  # no wider than the varying bits
    got = _kernel_order(plan, rows)
    assert got == want
    # heads and value-group starts from neighbouring keys
    for i, j in zip(got, got[1:]):
        x = [a ^ b for a, b in zip(plan.split(plan.pack(rows[i])), plan.split(plan.pack(rows[j])))]
        head = any(v & m for v, m in zip(x, plan.part_masks))
        vb = any(v & m for v, m in zip(x, plan.order_masks))
        assert head == (rows[i][:n_part] != rows[j][:n_part])
        assert vb == (rows[i][order_lane] != rows[j][order_lane])
    return plan


def _lexsort_rows(lanes):
    """The plain versions' order: ``_lexsort`` of int64 lanes."""
    return ow._lexsort([torch.as_tensor(np.asarray(v, np.int64)) for v in lanes]).tolist()


def _eowc_case(rng, n, part_vals, order_vals):
    parts = [rng.choice(np.asarray(p, np.int64), n) for p in part_vals]
    order = rng.choice(np.asarray(order_vals, np.int64), n)
    seq = rng.permutation(np.arange(5 * n, dtype=np.int64))[:n] + 1_000
    lanes = parts + [order, seq]
    rows = [tuple(_enc(v[i]) for v in lanes) for i in range(n)]
    return rows, _lexsort_rows(lanes)


EOWC_CASES = {
    # (window_start, auction) partitions, negative order keys
    "negative_order": ([np.arange(5) * 10_000 + 10**12, np.arange(-40, 40)],
                       np.arange(-500, 20)),
    # int64 extremes in a partition lane and in the order lane
    "extremes": ([[I64_MIN, I64_MIN + 1, -1, 0, 1, I64_MAX - 1, I64_MAX]],
                 [I64_MIN, I64_MIN + 1, -3, -1, 0, 2, I64_MAX - 1, I64_MAX]),
    # a range across zero: (MAX - MIN) >> lo is far narrower than the varying bits
    "across_zero": ([np.arange(-6, 6)], np.arange(-9, 9)),
    # every member in one partition
    "one_partition": ([[77]], np.arange(0, 3_000, 7)),
    # two wide partition lanes: the key passes 64 bits
    "wide": ([np.random.default_rng(3).integers(I64_MIN, I64_MAX, 9, dtype=np.int64),
              np.random.default_rng(4).integers(I64_MIN, I64_MAX, 9, dtype=np.int64)],
             np.arange(-50, 50)),
}


@pytest.mark.parametrize("case", sorted(EOWC_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_key_sorts_as_the_lanes_eowc(case, seed):
    """The EOWC emit's key (partition lanes, order, seq): the packed sort
    is ``_lexsort``'s order, its masks tell partitions and order values
    apart; past 64 bits the plan takes more words."""
    part_vals, order_vals = EOWC_CASES[case]
    rng = np.random.default_rng(100 + seed)
    rows, want = _eowc_case(rng, 400, part_vals, order_vals)
    plan = _check(rows, len(part_vals), len(part_vals), want)
    assert (plan.words > 1) == (case in ("extremes", "wide"))  # 64-bit ranges
    if case == "across_zero":
        assert plan.fields[0][2] == 4  # 12 values across zero: 4 bits, not 64


def _general_case(rng, cap, n, n_part, wide=False):
    """A general step's domain: present, emitted-only (absent) and free
    slots, and ghost entries of same-chunk partition moves; the members'
    keys (partition lanes, absent, order, seq) read as the kernel reads
    them, and the order ``_general_recompute_torch`` takes."""
    present = rng.random(cap) < 0.6
    em_valid = rng.random(cap) < 0.5
    if wide:
        pool = rng.integers(I64_MIN, I64_MAX, (n_part, 7), dtype=np.int64)
        buf = [rng.choice(pool[k], cap) for k in range(n_part)]
        em = [rng.choice(pool[k], cap) for k in range(n_part)]
    else:
        buf = [rng.integers(-4, 5, cap) for _ in range(n_part)]
        em = [rng.integers(-4, 5, cap) for _ in range(n_part)]
    order, em_order = rng.integers(-30, 30, cap), rng.integers(-30, 30, cap)
    seq = rng.permutation(cap).astype(np.int64)
    ghost = rng.random(n) < 0.5
    gslot = rng.integers(0, cap, n)
    member = np.concatenate([present | em_valid, ghost])
    present_e = np.concatenate([present, np.zeros(n, bool)])

    def entry(v_buf, v_em):
        return np.concatenate([np.where(present, v_buf, v_em), v_em[gslot]])

    planes = [entry(b, e) for b, e in zip(buf, em)]
    order_e = entry(order, em_order)
    seq_e = entry(seq, seq)
    t = lambda a: torch.as_tensor(a)
    s_idx = ow._lexsort([t(~member)] + [t(p) for p in planes]
                        + [t(~present_e), t(order_e), t(seq_e)]).tolist()
    members = np.flatnonzero(member)
    rank = {e: i for i, e in enumerate(members)}
    want = [rank[e] for e in s_idx[:len(members)]]
    lanes = planes + [(~present_e).astype(np.int64), order_e, seq_e]
    rows = [tuple(_enc(v[e]) for v in lanes) for e in members]
    return rows, want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_part,wide", [(1, False), (2, False), (2, True)])
def test_packed_key_sorts_as_the_lanes_general(seed, n_part, wide):
    """The general step's key (partition lanes, the absent bit, order,
    seq) over present slots, emitted-only slots and ghosts (both read the
    emitted lanes, a ghost at its slot): the packed sort is the order of
    ``_general_recompute_torch``; two wide partition lanes pass 64 bits."""
    rng = np.random.default_rng(7 + seed)
    rows, want = _general_case(rng, 300, 40, n_part, wide)
    plan = _check(rows, n_part, n_part + 1, want)
    assert (plan.words > 1) == wide
    lanes = [f[0] for f in plan.fields]
    assert n_part in lanes  # the absent bit varies: it has a field


def test_plan_edges():
    """One member, and members that differ only in seq: no partition or
    order field, no head after the first; a plan with no varying lane
    has no word. The plan's rows are what ``rw_window_order`` reads."""
    plan = ow.window_pack_plan(_fold([(_enc(3), _enc(-1), _enc(9))]), 1, 1)
    assert (plan.words, plan.bits, plan.fields) == (0, 0, ())
    assert plan.rows() == [0, 0]
    rows = [(_enc(5), _enc(-2), _enc(s)) for s in (4, 1, 3, 2)]
    plan = _check(rows, 1, 1, [1, 3, 2, 0])
    assert plan.part_masks == plan.order_masks == (0,)
    assert plan.rows()[:3] == [1, 1, 0x80]  # one field, one word, its top byte to sort
    lo_key = plan.fields[0][4]
    assert plan.rows()[-1] == (lo_key - (1 << 64) if lo_key >> 63 else lo_key)
