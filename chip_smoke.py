#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``risingwave_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card: name, power limit;
  2. build: compile kernels A-I from ``risingwave_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, on the
     same seeded inputs at the main paths' shapes (A-D: about 300k rows
     per apply, tables of 2^24 slots; E-H: a 16-chunk epoch of 65,536
     bid rows, 5,242,880 hopped rows, tables of 2^24 slots; I: a
     2^24-slot table rebuilt to 2^25 slots), with times;
  4. the interpreted path: Nexmark q5 (hop -> HashAgg -> device MV)
     through ``build_q5_lite(state_cleaning=False)``, chunk by chunk,
     over 20 epochs of 1M events, its final MV held against a numpy
     oracle, and the launch count of each kernel during that run;
  5. with ``--profile N`` only: N of phase 4's epochs again, on fresh
     tables, under ``torch.profiler`` (where the time goes), for the
     interpreted path and, after phase 6, for the fused one;
  6. the fused path: the same q5 through ``fuse_pipeline`` (one program
     per barrier, no device read inside it) over phase 4's chunks, its
     MV held against the oracle and phase 4's MV, its staged state
     digests against ``host_digest`` of the lanes read back and of
     phase 4's state, and the launch count of each kernel.
Then a ``{"kernels": [...]}`` line, the nvidia-smi name/power line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result. Without a
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
ROWS = 5 * 65_536  # hopped rows per apply: 65,536-row bid chunks x 5 windows
TABLE_CAP = 1 << 24
MID_KEYS = 3_000_000  # occupied slots kernel A meets: the main path's mean
END_KEYS = 6_000_000  # and its last barrier's (6,075,748 groups)
OUT_CAP = 1 << 15  # HashAgg's default flush round
EPOCHS = 20
EVENTS_PER_EPOCH = 1_000_000
CHUNK_EVENTS = 65_536
EVENT_RATE = 10_000  # events/s of event time, as the repo's q5 benchmark


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, each between its
    own CUDA events; ``setup`` (untimed) restores state before each."""
    if setup is not None:
        setup()
    fn()  # warm-up
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def clone_table(t):
    from risingwave_tpu_torch.ops.hash_table import HashTable

    return HashTable(
        t.fp1.clone(), t.fp2.clone(), tuple(k.clone() for k in t.keys),
        t.live.clone(), t.stamp.clone(), t.claimed.clone(), t.gen,
    )


def restore_table(dst, src) -> None:
    dst.fp1.copy_(src.fp1)
    dst.fp2.copy_(src.fp2)
    dst.stamp.copy_(src.stamp)
    dst.claimed.copy_(src.claimed)
    dst.live.copy_(src.live)
    for a, b in zip(dst.keys, src.keys):
        a.copy_(b)


def state_lanes(state) -> dict:
    """Every tensor lane of an AggState or MvDeviceState, by name."""
    out = {}
    for name, v in vars(state).items():
        if isinstance(v, dict):
            out.update({f"{name}.{k}": t for k, t in v.items()})
        else:
            out[name] = v
    return out


def max_abs_diff(torch, a: dict, b: dict) -> float:
    """Largest |a - b| over lanes of equal names (bool as 0/1)."""
    worst = 0.0
    for k in a:
        x, y = a[k], b[k]
        if x.dtype == torch.bool:
            x, y = x.to(torch.int8), y.to(torch.int8)
        if x.is_floating_point():
            d = (x.double() - y.double()).abs().nan_to_num(0.0)
        else:
            d = (x.long() - y.long()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def assert_lanes_equal(torch, a: dict, b: dict, what: str) -> None:
    check(a.keys() == b.keys(), f"{what}: lane names")
    for k in a:
        x, y = a[k], b[k]
        same = torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(torch.isnan(x), torch.isnan(y))
            and torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0))
        )
        check(same, f"{what}: lane {k}")


# -- phase 3: each kernel against its plain version ------------------------
def kernel_a(torch, dev, rng):
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops.hashing import hash128

    # The main path's tables fill from empty to about 6M groups, about
    # linearly: the batch meets MID_KEYS occupied slots (the run's mean)
    # and is timed again at END_KEYS (its last barrier).
    pool = rng.choice(1 << 40, size=END_KEYS + 250_000, replace=False).astype(np.int64)
    split = lambda raw: (torch.from_numpy(raw >> 11).to(dev),
                         torch.from_numpy((raw & 2047) * 2000).to(dev))
    pre, extra, new = pool[:MID_KEYS], pool[MID_KEYS:END_KEYS], pool[END_KEYS:]
    base = ht.HashTable.create(TABLE_CAP, (torch.int64, torch.int64), device=dev)
    ones = torch.ones(MID_KEYS, dtype=torch.bool, device=dev)
    _, pre_slots, _, _ = ht._lookup_or_insert_torch(base, split(pre), ones)
    base.live[pre_slots[: MID_KEYS * 7 // 10].long()] = True  # the rest: tombstones
    # the batch: live keys, tombstoned keys, new keys with repeats, invalid rows
    kind = rng.random(ROWS)
    pick_pre = rng.integers(0, MID_KEYS, ROWS)
    pick_new = rng.integers(0, len(new), ROWS)
    raw = np.where(kind < 0.45, pre[pick_pre], new[pick_new])
    k0, k1 = split(raw)
    valid = torch.from_numpy(rng.random(ROWS) > 0.05).to(dev)

    ta, tp = clone_table(base), clone_table(base)
    _, sa, fa, ia = ht.lookup_or_insert(ta, (k0, k1), valid)
    _, sp, fp, ip = ht._lookup_or_insert_torch(tp, (k0, k1), valid)
    torch.cuda.synchronize()
    # slots of new keys may differ (which contender claims a slot is a
    # race); slots of keys that existed may not
    old = torch.from_numpy(kind < 0.45).to(dev) & valid
    err = max(
        int((fa ^ fp).any()), int((ia ^ ip).any()), int(((sa >= 0) ^ (sp >= 0)).any()),
        int((sa[old] - sp[old]).abs().max()) if bool(old.any()) else 0,
    )
    check(torch.equal(sa >= 0, sp >= 0), "A: slots >= 0 per row")
    check(torch.equal(fa, fp), "A: found per row")
    check(torch.equal(ia, ip), "A: inserted per row")
    check(bool((sa[valid] >= 0).all()), "A: every valid row placed")
    # same key <-> same slot
    keys = torch.stack([k0, k1], 1)[valid]
    _, key_id = torch.unique(keys, dim=0, return_inverse=True)
    s = sa[valid].long()
    pairs = torch.unique(torch.stack([key_id, s], 1), dim=0)
    check(
        pairs.shape[0] == int(key_id.max()) + 1 == torch.unique(s).numel(),
        "A: rows share a slot iff they share a key",
    )
    check(torch.equal(sa[old], sp[old]), "A: existing keys resolve to their slot")

    def stored(t):
        c = t.fp1 != 0
        return torch.unique(torch.stack([t.keys[0][c], t.keys[1][c]], 1), dim=0)

    check(torch.equal(stored(ta), stored(tp)), "A: same stored key set")
    c = ta.fp1 != 0
    h1, h2 = hash128((ta.keys[0][c], ta.keys[1][c]))
    h1 = torch.where(h1 == 0, torch.ones_like(h1), h1)
    check(torch.equal(ta.fp1[c], h1.to(torch.int32)), "A: device fp1 = hash128")
    check(torch.equal(ta.fp2[c], h2.to(torch.int32)), "A: device fp2 = hash128")
    check(bool((ta.stamp[c] > 0).all()) and not bool((ta.stamp[~c] != 0).any()),
          "A: stamps published")
    check(int(ta.claimed) == int(c.sum()) == int(tp.claimed), "A: claimed-slot counter")

    # a too-small table overflows: rows without a slot hold keys it lacks
    small_k = torch.from_numpy(rng.choice(1 << 30, 600, replace=False)).to(dev)
    sk = (small_k, small_k * 3)
    for fn in (ht.lookup_or_insert, ht._lookup_or_insert_torch):
        t = ht.HashTable.create(256, (torch.int64, torch.int64), device=dev)
        _, ss, _, _ = fn(t, sk, torch.ones(600, dtype=torch.bool, device=dev))
        check(bool((ss < 0).any()), "A: small table overflows")
        placed = torch.unique(ss[ss >= 0])
        check(placed.numel() == int((ss >= 0).sum()), "A: distinct keys, distinct slots")
        check(placed.numel() == int((t.fp1 != 0).sum()), "A: one slot per placed key")
        lost = set(small_k[ss < 0].tolist())
        check(not lost & set(t.keys[0][t.fp1 != 0].tolist()), "A: overflowed keys absent")

    n_valid = int(valid.sum())
    n_new = int((c.sum() - (base.fp1 != 0).sum()))
    nbytes = ROWS * (16 + 1 + 4 + 1 + 1) + n_valid * (4 + 4 + 4 + 16 + 1) + n_new * 28
    setup = lambda: restore_table(ta, base)
    ms = time_ms(torch, lambda: ht.lookup_or_insert(ta, (k0, k1), valid), 5, setup)
    setup_p = lambda: restore_table(tp, base)
    plain = time_ms(torch, lambda: ht._lookup_or_insert_torch(tp, (k0, k1), valid), 3, setup_p)
    # the same batch at the last barrier's load
    end = clone_table(base)
    _, extra_slots, _, _ = ht._lookup_or_insert_torch(
        end, split(extra), torch.ones(len(extra), dtype=torch.bool, device=dev))
    end.live[extra_slots.long()] = True
    te = clone_table(end)
    ms_end = time_ms(torch, lambda: ht.lookup_or_insert(te, (k0, k1), valid), 5,
                     lambda: restore_table(te, end))
    del end, te
    return {
        "name": "A lookup_or_insert", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/lookup_or_insert.cu",
        "replaces": "risingwave_tpu/ops/hash_table.py:119",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None, "ms_at_end_load": ms_end,
        "shape": {"rows": ROWS, "capacity": TABLE_CAP, "new_slots": n_new,
                  "occupied_before": MID_KEYS, "occupied_before_end_load": END_KEYS},
    }, (ta, sa, k0, k1, valid)


def kernel_b(torch, dev, rng, a_out):
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops.agg import AggCall

    table, slots, _, _, valid = a_out
    signs = torch.where(valid, 1, 0).to(torch.int32)
    signs[torch.from_numpy(rng.random(ROWS) < 0.1).to(dev) & valid] = -1
    v = torch.from_numpy(rng.integers(-10**12, 10**12, ROWS)).to(dev)
    f = torch.from_numpy(rng.standard_normal(ROWS)).to(dev)
    f[:64] = float("nan")
    f[64:128] = -0.0
    nulls = {"v": torch.from_numpy(rng.random(ROWS) < 0.1).to(dev)}
    full = (
        AggCall("count_star", None, "n"), AggCall("count", "v", "cv"),
        AggCall("sum", "v", "sv"), AggCall("min", "v", "mnv"),
        AggCall("max", "v", "mxv"), AggCall("min", "f", "mnf"),
        AggCall("max", "f", "mxf"),
    )
    dtypes = {"v": torch.int64, "f": torch.float64}
    results = {}
    for calls in (full, (AggCall("count_star", None, "num"),)):
        sa = agg_ops.create_state(TABLE_CAP, calls, dtypes, dev)
        sp = agg_ops.create_state(TABLE_CAP, calls, dtypes, dev)
        la, lp = table.live.clone(), table.live.clone()
        vals = {"v": v, "f": f}
        agg_ops.apply(sa, calls, slots, signs, vals, nulls, live=la)
        agg_ops._apply_torch(sp, calls, slots, signs, vals, nulls, lp)
        torch.cuda.synchronize()
        assert_lanes_equal(torch, state_lanes(sa), state_lanes(sp), f"B {len(calls)} calls")
        check(torch.equal(la, lp), "B: live = row_count > 0")
        results[len(calls)] = (calls, sa, sp)
    check(bool(results[7][1].minmax_retracted), "B: retraction latched on MIN/MAX")
    calls = results[1][0]
    err = max_abs_diff(torch, state_lanes(results[7][1]), state_lanes(results[7][2]))
    # timing mutates state: time on states of its own
    sa = agg_ops.create_state(TABLE_CAP, calls, dtypes, dev)
    sp = agg_ops.create_state(TABLE_CAP, calls, dtypes, dev)
    ms = time_ms(torch, lambda: agg_ops.apply(sa, calls, slots, signs, {}, {}, live=table.live), 10)
    plain = time_ms(torch, lambda: agg_ops._apply_torch(sp, calls, slots, signs, {}, {}, table.live), 5)
    active = (slots >= 0) & (signs != 0)
    idx, w = slots[active].long(), signs[active].long()
    lib = time_ms(torch, lambda: sa.row_count.index_add_(0, idx, w), 10)
    touched = int(torch.unique(idx).numel())
    # rows: slot + sign in; per touched slot: row_count and num read and
    # written, dirty, sdirty and live written
    nbytes = ROWS * 8 + touched * (16 + 16 + 3)
    return {
        "name": "B agg apply", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/agg_apply.cu",
        "replaces": "risingwave_tpu/ops/agg.py:257",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lib,
        "library_call": "index_add_ of the signs into row_count (one of its lanes)",
        "shape": {"rows": ROWS, "capacity": TABLE_CAP, "touched_slots": touched},
    }, results


def run_flush_rounds(torch, flush_fn, state, keys, fx):
    rounds = []
    while True:
        before = int(state.dirty.sum())
        total = torch.full((), -1, dtype=torch.int64, device=state.dirty.device)
        delta = flush_fn(state, keys, OUT_CAP, fx, total)
        n_take, overflow = delta["status"].tolist()
        check(int(total) == before, "C: dirty_total = dirty groups before the round")
        rounds.append((n_take, overflow, delta))
        if not overflow:
            return rounds


def flush_rows(torch, delta, names) -> np.ndarray:
    """The valid rows of a delta as one float64 matrix (NaN-safe ids)."""
    v = delta["valid"]
    cols = [delta["ops"][v].double()]
    for n in names:
        lane = delta[n][v]
        cols.append(lane.double().nan_to_num(1e300))
    return torch.stack(cols, 1).cpu().numpy()


def kernel_c(torch, dev, rng, b_results, table):
    from risingwave_tpu_torch.ops import agg as agg_ops

    keys = table.keys
    worst = 0.0
    # the full-call state (float MIN/MAX decode, NULL lanes) after B
    calls, sa, sp = b_results[7]
    fx = agg_ops.float_extreme_meta(calls, {"v": torch.int64, "f": torch.float64})
    for (calls, sa, sp), fxx in ((b_results[7], fx), (b_results[1], ())):
        ra = run_flush_rounds(torch, agg_ops._flush_cuda, sa, keys, fxx)
        rp = run_flush_rounds(torch, agg_ops._flush_torch, sp, keys, fxx)
        check(len(ra) == len(rp) and len(ra) > 1, "C: same number of rounds, overflow hit")
        names = [n for n in ra[0][2] if n not in ("ops", "valid", "status")]
        for (na, oa, da), (np_, op_, dp) in zip(ra, rp):
            check((na, oa) == (np_, op_), "C: status per round")
            xa, xp = flush_rows(torch, da, names), flush_rows(torch, dp, names)
            check(np.array_equal(xa, xp), "C: delta rows (ascending slot order)")
            check(np.array_equal(np.sort(xa, 0), np.sort(xp, 0)), "C: delta multiset")
        assert_lanes_equal(torch, state_lanes(sa), state_lanes(sp), "C: state after rounds")
        worst = max(worst, max_abs_diff(torch, state_lanes(sa), state_lanes(sp)))

    # timing at the main path's shape: 2^24 slots, ~300k dirty groups
    calls, sa, sp = b_results[1]
    saved = {
        "dirty": sa.dirty.clone(),
        "ev": sa.emitted_valid.clone(),
        "em": sa.emitted["num"].clone(),
    }
    n_dirty = ROWS
    pick = torch.from_numpy(rng.choice(TABLE_CAP, n_dirty, replace=False)).to(dev)
    saved["dirty"].zero_()[pick] = True

    def setup(s):
        s.dirty.copy_(saved["dirty"])
        s.emitted_valid.copy_(saved["ev"])
        s.emitted["num"].copy_(saved["em"])

    ms = time_ms(torch, lambda: agg_ops._flush_cuda(sa, keys, OUT_CAP, ()), 10, lambda: setup(sa))
    plain = time_ms(torch, lambda: agg_ops._flush_torch(sp, keys, OUT_CAP, ()), 5, lambda: setup(sp))
    lib = time_ms(torch, lambda: torch.nonzero(sa.dirty), 10, lambda: setup(sa))
    # dirty lane read; per taken slot: row_count, emitted_valid, 2 keys,
    # num and its snapshot read, snapshot/emitted_valid/dirty written;
    # 2*out_cap delta rows of ops, valid, 2 keys, num written
    nbytes = TABLE_CAP + OUT_CAP * (8 + 1 + 16 + 8 + 8 + 8 + 1 + 1) + 2 * OUT_CAP * (4 + 1 + 16 + 8)
    return {
        "name": "C agg flush", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/agg_flush.cu",
        "replaces": "risingwave_tpu/ops/agg.py:600",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lib,
        "library_call": "torch.nonzero of the dirty lane (its compaction step)",
        "shape": {"capacity": TABLE_CAP, "dirty": n_dirty, "out_cap": OUT_CAP},
    }


def kernel_d(torch, dev, rng):
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import materialize as mv
    from risingwave_tpu_torch.ops import hash_table as ht

    n = 2 * OUT_CAP  # one full flush chunk
    pk = ("auction", "window_start")
    dtypes = {"auction": torch.int64, "window_start": torch.int64, "num": torch.int64}
    base_t = ht.HashTable.create(TABLE_CAP, (torch.int64, torch.int64), device=dev)
    base_s = mv.MvDeviceState.create(TABLE_CAP, dtypes, ("num",), (), dev)
    n_pre = TABLE_CAP // 16
    pre_a = torch.from_numpy(rng.integers(0, 1 << 40, n_pre)).to(dev)
    pre_w = torch.from_numpy(rng.integers(0, 50, n_pre) * 2000).to(dev)
    pre = StreamChunk(
        {"auction": pre_a, "window_start": pre_w, "num": torch.ones_like(pre_a)},
        torch.ones(n_pre, dtype=torch.bool, device=dev), {},
        torch.zeros(n_pre, dtype=torch.int32, device=dev),
    )
    mv.mv_step_fn(base_t, base_s, pre, pk, ("num",))
    # a chunk with repeated pks (last write wins), deletes, invalid rows
    pick = torch.from_numpy(rng.integers(0, n_pre, n)).to(dev)
    fresh = torch.from_numpy(rng.random(n) < 0.4).to(dev)
    a = torch.where(fresh, torch.from_numpy(rng.integers(0, 4096, n)).to(dev) + (1 << 41), pre_a[pick])
    w = torch.where(fresh, torch.zeros_like(a), pre_w[pick])
    ops = torch.from_numpy(rng.choice([0, 1, 2, 3], n, p=[0.5, 0.15, 0.15, 0.2]).astype(np.int32)).to(dev)
    chunk = StreamChunk(
        {"auction": a, "window_start": w,
         "num": torch.from_numpy(rng.integers(1, 10**6, n)).to(dev)},
        torch.from_numpy(rng.random(n) > 0.03).to(dev), {}, ops,
    )

    def clone_state(s):
        return mv.MvDeviceState(
            {k: t.clone() for k, t in s.values.items()}, {}, s.sdirty.clone(),
            s.stored.clone(), s.dropped.clone(), s.scratch.clone(),
        )

    # end to end (A then D) on both paths: equal snapshots
    snaps = []
    for step in ("cuda", "torch"):
        t, s = clone_table(base_t), clone_state(base_s)
        if step == "cuda":
            mv.mv_step_fn(t, s, chunk, pk, ("num",))
        else:
            _, slots, _, _ = ht._lookup_or_insert_torch(t, tuple(chunk.col(k) for k in pk), chunk.valid)
            mv._mv_upsert_torch(t, s, chunk, slots, ("num",))
        live = t.live
        rows = torch.stack([t.keys[0][live], t.keys[1][live], s.values["num"][live]], 1)
        snaps.append((rows[torch.argsort(rows[:, 0] * 64 + rows[:, 1] // 2000)], s, t))
    check(torch.equal(snaps[0][0], snaps[1][0]), "D: MV snapshots equal")
    check(bool((snaps[0][1].scratch == -1).all()), "D: scratch reset")
    check(not bool(snaps[0][1].dropped), "D: nothing dropped")

    # D alone on the same slots
    t = clone_table(base_t)
    _, slots, _, _ = ht._lookup_or_insert_torch(t, tuple(chunk.col(k) for k in pk), chunk.valid)
    ta, sa = clone_table(t), clone_state(base_s)
    tp, sp = clone_table(t), clone_state(base_s)
    rows_a = torch.zeros((), dtype=torch.int64, device=dev)
    rows_p = torch.zeros((), dtype=torch.int64, device=dev)
    mv._mv_upsert_cuda(ta, sa, chunk, slots, ("num",), rows_a)
    mv._mv_upsert_torch(tp, sp, chunk, slots, ("num",), rows_p)
    torch.cuda.synchronize()
    check(int(rows_a) == int(rows_p) == int(chunk.valid.sum()), "D: valid-row counter")
    check(torch.equal(ta.live, tp.live), "D: live lanes")
    lanes_a, lanes_p = state_lanes(sa), state_lanes(sp)
    check(torch.equal(lanes_a["sdirty"], lanes_p["sdirty"]), "D: sdirty lanes")
    check(torch.equal(lanes_a["values.num"], lanes_p["values.num"]), "D: value lanes")
    err = max_abs_diff(torch, {"num": sa.values["num"]}, {"num": sp.values["num"]})
    ms = time_ms(torch, lambda: mv._mv_upsert_cuda(ta, sa, chunk, slots, ("num",)), 10)
    plain = time_ms(torch, lambda: mv._mv_upsert_torch(tp, sp, chunk, slots, ("num",)), 5)
    n_valid = int(chunk.valid.sum())
    winners = int(torch.unique(slots[chunk.valid]).numel())
    nbytes = n * (4 + 1 + 4 + 8) + n_valid * 4 + winners * (1 + 1 + 8 + 4)
    return {
        "name": "D mv upsert", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/mv_upsert.cu",
        "replaces": "risingwave_tpu/executors/materialize.py:551",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"rows": n, "capacity": TABLE_CAP, "winners": winners},
    }


def kernel_dtypes(torch, dev, rng):
    """The kernels' other lane types at a small size, each against its
    plain version: A over int32/bool/float32/float64 keys (NaN, -0.0,
    repeats, invalid rows); B over int32 SUM/MIN/MAX, float32 MIN/MAX
    and float64 SUM; C over those and a bool key lane; D over an int32
    nullable and a float64 value lane. Exact, except the float64 SUM,
    whose atomics add in another order than the plain version
    (tolerance: 1e-9 relative)."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import materialize as mv
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops.agg import AggCall

    n, cap = 20_000, 1 << 16
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    f32 = rng.integers(-50, 50, n).astype(np.float32) / 4
    f64 = rng.integers(-50, 50, n) / 8.0
    f32[:300] = np.nan
    f32[300:600] = -0.0
    f64[600:900] = np.nan
    keys = (put(rng.integers(-40, 40, n).astype(np.int32)), put(rng.random(n) < 0.5),
            put(f32), put(f64))
    valid = put(rng.random(n) > 0.05)
    dtypes = (torch.int32, torch.bool, torch.float32, torch.float64)
    ta = ht.HashTable.create(cap, dtypes, device=dev)
    tp = ht.HashTable.create(cap, dtypes, device=dev)
    _, sa, fa, ia = ht.lookup_or_insert(ta, keys, valid)
    _, sp, fp, ip = ht._lookup_or_insert_torch(tp, keys, valid)
    check(torch.equal(fa, fp) and torch.equal(ia, ip), "A dtypes: found/inserted")
    # again, with half the keys live: found vs tombstoned, nothing new
    ta.live[sa[valid][::2].long()] = True
    tp.live[sp[valid][::2].long()] = True
    _, sa, fa, ia = ht.lookup_or_insert(ta, keys, valid)
    _, sp, fp, ip = ht._lookup_or_insert_torch(tp, keys, valid)
    check(torch.equal(fa, fp) and torch.equal(ia, ip), "A dtypes: found/inserted again")
    check(bool(fa.any()) and not bool(ia.any()), "A dtypes: second call finds, inserts nothing")
    check(torch.equal(sa >= 0, sp >= 0), "A dtypes: placed rows")
    pairs = torch.unique(torch.stack([sa[valid], sp[valid]], 1), dim=0)
    check(
        pairs.shape[0] == torch.unique(sa[valid]).numel() == torch.unique(sp[valid]).numel(),
        "A dtypes: same rows share a slot (NaN == NaN, -0.0 == 0.0)",
    )
    check(int((ta.fp1 != 0).sum()) == int((tp.fp1 != 0).sum()), "A dtypes: key count")

    slots = torch.from_numpy(rng.integers(-1, cap // 8, n).astype(np.int32)).to(dev)
    signs = put(np.where(rng.random(n) < 0.8, 1, -1).astype(np.int32))
    vals = {"w": put(rng.integers(-10**6, 10**6, n).astype(np.int32)),
            "g": put(rng.standard_normal(n).astype(np.float32)),
            "f": put(rng.standard_normal(n))}
    nulls = {"w": put(rng.random(n) < 0.1), "g": put(rng.random(n) < 0.1)}
    calls = (AggCall("sum", "w", "sw"), AggCall("min", "w", "mnw"),
             AggCall("max", "w", "mxw"), AggCall("min", "g", "mng"),
             AggCall("max", "g", "mxg"), AggCall("sum", "f", "sf"))
    in_dt = {"w": torch.int32, "g": torch.float32, "f": torch.float64}
    fx = agg_ops.float_extreme_meta(calls, in_dt)
    sa_, sp_ = (agg_ops.create_state(cap, calls, in_dt, dev) for _ in range(2))
    agg_ops.apply(sa_, calls, slots, signs, vals, nulls)
    agg_ops._apply_torch(sp_, calls, slots, signs, vals, nulls, None)
    la, lp = state_lanes(sa_), state_lanes(sp_)
    sf_a, sf_p = la.pop("accums.sf"), lp.pop("accums.sf")
    assert_lanes_equal(torch, la, lp, "B dtypes")
    check(torch.allclose(sf_a, sf_p, rtol=1e-9, atol=1e-9), "B dtypes: float64 SUM")
    sf_err = float((sf_a - sf_p).abs().max())
    # C over these lanes with an int32 and a bool key lane; the float64
    # SUM lane is set equal first so the deltas compare exactly
    sa_.accums["sf"].copy_(sp_.accums["sf"])
    fkeys = (torch.arange(cap, dtype=torch.int32, device=dev), torch.arange(cap, device=dev) % 3 == 0)
    ra = run_flush_rounds(torch, agg_ops._flush_cuda, sa_, fkeys, fx)
    rp = run_flush_rounds(torch, agg_ops._flush_torch, sp_, fkeys, fx)
    check(len(ra) == len(rp), "C dtypes: rounds")
    names = [k for k in ra[0][2] if k not in ("ops", "valid", "status")]
    for (na, oa, da), (np_, op_, dp) in zip(ra, rp):
        check((na, oa) == (np_, op_), "C dtypes: status")
        check(np.array_equal(flush_rows(torch, da, names), flush_rows(torch, dp, names)),
              "C dtypes: delta rows")
    assert_lanes_equal(torch, state_lanes(sa_), state_lanes(sp_), "C dtypes: state")

    m = 4096
    dt = {"k": torch.int64, "y": torch.int32, "z": torch.float64}
    chunk = StreamChunk(
        {"k": put(rng.integers(0, 900, m)), "y": put(rng.integers(0, 99, m).astype(np.int32)),
         "z": put(rng.standard_normal(m))},
        put(rng.random(m) > 0.05), {"y": put(rng.random(m) < 0.3)},
        put(rng.choice([0, 1, 2, 3], m).astype(np.int32)),
    )
    snaps = []
    for upsert in (mv._mv_upsert_cuda, mv._mv_upsert_torch):
        t = ht.HashTable.create(1 << 12, (torch.int64,), device=dev)
        s = mv.MvDeviceState.create(1 << 12, dt, ("y", "z"), ("y",), dev)
        _, sl, _, _ = ht._lookup_or_insert_torch(t, (chunk.col("k"),), chunk.valid)
        upsert(t, s, chunk, sl, ("y", "z"))
        snaps.append({"live": t.live, **state_lanes(s)})
    assert_lanes_equal(torch, snaps[0], snaps[1], "D dtypes")
    return {"phase": "kernel_dtypes", "rows": n, "float64_sum_max_abs_err": sf_err,
            "checks": "A int32/bool/float32/float64 keys, B int32/float32/float64, "
                      "C bool key lane + float decode, D int32 nullable + float64: equal"}


# -- phase 3, the epoch path's kernels (E, F, G, H) ---------------------------
EPOCH_CHUNKS = 16  # 65,536-row bid chunks per 1M-event epoch


def epoch_chunks(torch, dev, seed: int):
    """One epoch's bid chunks at phase 4's settings, stacked as the fused
    program stacks them."""
    from risingwave_tpu_torch.array.chunk import stack_chunks
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=EVENT_RATE), seed=seed)
    chunks = []
    while len(chunks) < EPOCH_CHUNKS:
        bid = gen.next_chunks(CHUNK_EVENTS, CHUNK_EVENTS, device=dev)["bid"]
        if bid is not None:
            chunks.append(bid)
    return stack_chunks(chunks)


def chunk_lanes(chunk) -> dict:
    out = {f"col.{n}": a for n, a in chunk.columns.items()}
    out.update({f"null.{n}": a for n, a in chunk.nulls.items()})
    out["valid"], out["ops"] = chunk.valid, chunk.ops
    return out


def kernel_e(torch, dev):
    from risingwave_tpu_torch.array.chunk import flatten_stacked
    from risingwave_tpu_torch.executors import hop_window as hw

    stacked = epoch_chunks(torch, dev, SEED + 1)
    args = ("date_time", 10_000, 2_000, "window_start")
    ea = flatten_stacked(hw.hop_step_fn(stacked, *args))
    ep = flatten_stacked(hw._hop_torch(stacked, *args))
    torch.cuda.synchronize()
    la, lp = chunk_lanes(ea), chunk_lanes(ep)
    assert_lanes_equal(torch, la, lp, "E")
    check(list(ea.columns) == list(ep.columns), "E: column order")
    err = max_abs_diff(torch, la, lp)
    ms = time_ms(torch, lambda: hw.hop_step_fn(stacked, *args), 10)
    plain = time_ms(torch, lambda: hw._hop_torch(stacked, *args), 5)
    n_in = stacked.valid.numel()
    row_in = sum(a.element_size() for a in stacked.columns.values()) + 1 + 4
    row_out = sum(a.element_size() for a in ea.columns.values()) + 1 + 4
    nbytes = n_in * row_in + ea.valid.numel() * row_out
    return {
        "name": "E hop expand", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/hop_expand.cu",
        "replaces": "risingwave_tpu/executors/hop_window.py:27",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"chunks": EPOCH_CHUNKS, "chunk_rows": CHUNK_EVENTS, "rows_out": int(ea.valid.numel())},
    }, ea


def reduce_outputs(torch, out) -> dict:
    keys, rep, w, red, mret = out
    lanes = {f"key{i}": k for i, k in enumerate(keys)}
    lanes.update({"rep_valid": rep, "w": w, "minmax_ret": mret})
    lanes.update({f"red.{k}": v for k, v in red.items()})
    return lanes


def kernel_f(torch, dev, flat):
    from risingwave_tpu_torch.executors.hash_agg import _build_key_lanes
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.ops.hashing import hash128

    calls = (AggCall("count_star", None, "num"),)  # q5's
    keys = _build_key_lanes(flat, ("auction", "window_start"), (False, False))
    signs = flat.effective_signs()
    n = signs.numel()
    fa = agg_ops.reduce_by_key(keys, signs, calls, {}, {})
    fp = agg_ops._reduce_by_key_torch(keys, signs, calls, {}, {})
    torch.cuda.synchronize()
    la, lp = reduce_outputs(torch, fa), reduce_outputs(torch, fp)
    assert_lanes_equal(torch, la, lp, "F")
    err = max_abs_diff(torch, la, lp)
    n_invisible = int((signs == 0).sum())
    check(n_invisible > 0, "F: the epoch has invisible rows")
    # a forced fingerprint collision: pairs of different keys share one
    # fingerprint pair, and some visible rows take the invisible rows'
    # 0xFFFFFFFF fingerprints (they sort among them and split)
    h1, h2 = hash128(keys)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    pick = torch.randperm(n, generator=g)[:20_000].to(dev)
    src = torch.randperm(n, generator=g)[:20_000].to(dev)
    h1c, h2c = h1.clone(), h2.clone()
    h1c[pick], h2c[pick] = h1[src], h2[src]
    ones = torch.randperm(n, generator=g)[:2_000].to(dev)
    h1c[ones] = 0xFFFFFFFF
    h2c[ones] = 0xFFFFFFFF
    ca = agg_ops._reduce_by_key_cuda(keys, signs, calls, {}, {}, fingerprints=(h1c, h2c))
    cp = agg_ops._reduce_by_key_torch(keys, signs, calls, {}, {}, fingerprints=(h1c, h2c))
    torch.cuda.synchronize()
    lca, lcp = reduce_outputs(torch, ca), reduce_outputs(torch, cp)
    assert_lanes_equal(torch, lca, lcp, "F with a forced collision")
    err = max(err, max_abs_diff(torch, lca, lcp))
    # per-key totals do not depend on the collision
    rep_keys = lambda out: torch.stack([out[0][0][out[1]], out[0][1][out[1]], out[2][out[1]]], 1)
    tot = lambda m: torch.unique(m[:, :2], dim=0, return_inverse=True)
    ka, ia = tot(rep_keys(fa))
    kc, ic = tot(rep_keys(ca))
    sa = torch.zeros(len(ka), dtype=torch.int64, device=dev).index_add_(0, ia, rep_keys(fa)[:, 2])
    sc = torch.zeros(len(kc), dtype=torch.int64, device=dev).index_add_(0, ic, rep_keys(ca)[:, 2])
    check(torch.equal(ka, kc) and torch.equal(sa, sc), "F: per-key sums survive the collision")
    ms = time_ms(torch, lambda: agg_ops.reduce_by_key(keys, signs, calls, {}, {}), 5)
    plain = time_ms(torch, lambda: agg_ops._reduce_by_key_torch(keys, signs, calls, {}, {}), 3)
    key64 = ((h1 << 32) | h2) ^ (-(2**63))  # the unsigned order as int64
    lib = time_ms(torch, lambda: torch.sort(key64, stable=True), 5)
    # key lanes and signs read once; sorted keys, rep_valid and w written
    nbytes = n * (8 + 8 + 4) + n * (8 + 8 + 1 + 8)
    reps = int(fa[1].sum())
    return {
        "name": "F reduce_by_key", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/reduce_by_key.cu",
        "replaces": "risingwave_tpu/ops/agg.py:334",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lib,
        "library_call": "torch.sort(stable=True) of the 64-bit fingerprint key (the sort alone)",
        "shape": {"rows": n, "invisible": n_invisible, "representatives": reps,
                  "collided_rows": 20_000, "all_ones_rows": 2_000},
    }, (keys, fa)


def kernel_g(torch, dev, rng, f_out):
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops.agg import AggCall

    keys, (sorted_keys, rep_valid, w, reduced, mret) = f_out
    calls = (AggCall("count_star", None, "num"),)
    # a table at the main path's mean load: MID_KEYS occupied slots, 70 %
    # of them live, plus the epoch's own keys
    pool = rng.choice(1 << 40, size=MID_KEYS, replace=False).astype(np.int64)
    pre = (torch.from_numpy(pool >> 11).to(dev), torch.from_numpy((pool & 2047) * 2000).to(dev))
    table = ht.HashTable.create(TABLE_CAP, (torch.int64, torch.int64), device=dev)
    ones = torch.ones(MID_KEYS, dtype=torch.bool, device=dev)
    _, pre_slots, _, _ = ht._lookup_or_insert_torch(table, pre, ones)
    live_pre = pre_slots[: MID_KEYS * 7 // 10].long()
    table.live[live_pre] = True
    base = agg_ops.create_state(TABLE_CAP, calls, {}, dev)
    counts = torch.from_numpy(rng.integers(1, 50, len(live_pre))).to(dev)
    base.row_count[live_pre] = counts
    base.accums["num"][live_pre] = counts
    _, slots, _, _ = ht.lookup_or_insert(table, sorted_keys, rep_valid)
    torch.cuda.synchronize()
    check(bool((slots[rep_valid] >= 0).all()), "G: every representative has a slot")

    def clone_state(s):
        return agg_ops.AggState(
            s.row_count.clone(), {k: v.clone() for k, v in s.accums.items()}, {}, {
                k: v.clone() for k, v in s.emitted.items()}, {}, s.emitted_valid.clone(),
            s.dirty.clone(), s.minmax_retracted.clone(), s.sdirty.clone(), s.stored.clone(),
        )

    sa, sp = clone_state(base), clone_state(base)
    la, lp = table.live.clone(), table.live.clone()
    agg_ops.apply_reduced(sa, calls, slots, rep_valid, w, reduced, mret, live=la)
    agg_ops._apply_reduced_torch(sp, calls, slots, rep_valid, w, reduced, mret, lp)
    torch.cuda.synchronize()
    assert_lanes_equal(torch, state_lanes(sa), state_lanes(sp), "G")
    check(torch.equal(la, lp), "G: live = row_count > 0")
    err = max_abs_diff(torch, state_lanes(sa), state_lanes(sp))
    st, sp2 = clone_state(base), clone_state(base)
    lt = table.live.clone()
    ms = time_ms(torch, lambda: agg_ops.apply_reduced(st, calls, slots, rep_valid, w, reduced, mret, live=lt), 10)
    plain = time_ms(torch, lambda: agg_ops._apply_reduced_torch(sp2, calls, slots, rep_valid, w, reduced, mret, lt), 5)
    active = rep_valid & (slots >= 0)
    idx, ww = slots[active].long(), w[active]
    lib = time_ms(torch, lambda: st.row_count.index_add_(0, idx, ww), 10)
    n = slots.numel()
    n_active = int(active.sum())
    touched = int(torch.unique(idx).numel())
    # rep_valid + slot per row; w per representative; per touched slot
    # row_count and num read and written, row_count read again for live,
    # dirty, sdirty and live written
    nbytes = n * (1 + 4) + n_active * 8 + touched * (16 + 16 + 8 + 3)
    return {
        "name": "G apply_reduced", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/apply_reduced.cu",
        "replaces": "risingwave_tpu/ops/agg.py:464",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lib,
        "library_call": "index_add_ of w into row_count at the representatives' slots",
        "shape": {"rows": n, "representatives": n_active, "capacity": TABLE_CAP,
                  "occupied_before": MID_KEYS},
    }, (table, sa)


def kernel_h(torch, dev, g_out):
    from types import SimpleNamespace

    from risingwave_tpu_torch import integrity

    table, state = g_out
    agg = integrity.agg_lanes(table, state)
    mv_state = SimpleNamespace(values={"num": state.row_count}, vnulls={})
    mv = integrity.mv_lanes(table, mv_state)
    worst = 0.0
    for what, (lanes, live) in (("agg", agg), ("mv", mv)):
        got = integrity.digest_from_scalar(integrity.device_digest(lanes, live))
        plain = integrity.digest_from_scalar(integrity._device_digest_torch(
            lanes, sorted(lanes), integrity._masks(live)))
        host = integrity.host_digest(*integrity.host_lanes(lanes, live))
        check(got == plain == host, f"H {what}: kernel {got:x}, plain {plain:x}, numpy {host:x}")
        worst = max(worst, float(abs(got - plain)), float(abs(got - host)))

    def both(fn):
        fn(*agg)
        fn(*mv)

    ms = time_ms(torch, lambda: both(integrity.device_digest), 10)
    plain_fn = lambda lanes, live: integrity._device_digest_torch(lanes, sorted(lanes), integrity._masks(live))
    plain = time_ms(torch, lambda: both(plain_fn), 3)
    per_slot = lambda lanes, live: sum(
        a.element_size() * (a.numel() // TABLE_CAP) for a in lanes.values()
    ) + len(integrity._masks(live))
    nbytes = TABLE_CAP * (per_slot(*agg) + per_slot(*mv))
    return {
        "name": "H state digest", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/state_digest.cu",
        "replaces": "risingwave_tpu/integrity.py:329",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"capacity": TABLE_CAP, "calls": "agg lanes + MV lanes (one barrier's two digests)",
                  "bytes_per_slot": nbytes / TABLE_CAP},
    }


def kernel_i(torch, dev, g_out):
    """I against its plain version on G's 2^24-slot table (MID_KEYS
    occupied slots plus the epoch's keys) rebuilt to 2^25 slots, as phase
    6 rebuilds the MV: kernel A re-inserts the kept keys once, then both
    versions move the same lanes to the same new slots. Timed on the
    MV's lanes (live, num, sdirty, stored); the agg's lanes are checked
    too."""
    from risingwave_tpu_torch.ops import hash_table as ht

    table, state = g_out
    new_cap = 2 * TABLE_CAP
    keep = table.live | state.sdirty | state.stored  # the MV rebuild's rule
    new_table = ht.HashTable.create(new_cap, tuple(k.dtype for k in table.keys), device=dev)
    _, new_slots, _, _ = ht.lookup_or_insert(new_table, table.keys, keep)
    mv_src = [table.live, state.row_count, state.sdirty, state.stored]
    agg_src = [table.live, state.row_count, *state.accums.values(), *state.nonnull.values(),
               *state.emitted.values(), *state.emitted_isnull.values(), state.emitted_valid,
               state.dirty, state.sdirty, state.stored]
    fresh = lambda srcs: [torch.zeros(new_cap, dtype=a.dtype, device=dev) for a in srcs]
    worst = 0.0
    for what, srcs in (("MV", mv_src), ("agg", agg_src)):
        got, want = fresh(srcs), fresh(srcs)
        ht.move_slots(srcs, got, new_slots, keep)
        ht._move_slots_torch(srcs, want, new_slots, keep)
        torch.cuda.synchronize()
        ga = {str(i): t for i, t in enumerate(got)}
        wa = {str(i): t for i, t in enumerate(want)}
        assert_lanes_equal(torch, ga, wa, f"I {what} lanes")
        worst = max(worst, max_abs_diff(torch, ga, wa))
    ok = keep & (new_slots >= 0)
    n_kept = int(ok.sum())
    check(n_kept == int(keep.sum()) == int(new_table.claimed), "I: every kept key re-inserted")
    dst = fresh(mv_src)
    ms = time_ms(torch, lambda: ht.move_slots(mv_src, dst, new_slots, keep), 10)
    plain = time_ms(torch, lambda: ht._move_slots_torch(mv_src, dst, new_slots, keep), 5)
    idx, vals = new_slots[ok].long(), state.row_count[ok]
    lib = time_ms(torch, lambda: dst[1].index_copy_(0, idx, vals), 10)
    # keep and new_slots read over the old table; per kept slot each
    # lane read once and written once
    row_bytes = sum(a.element_size() for a in mv_src)
    nbytes = TABLE_CAP * (1 + 4) + n_kept * 2 * row_bytes
    return {
        "name": "I slot move", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/slot_move.cu",
        "replaces": "risingwave_tpu/executors/materialize.py:587 (and hash_agg.py:268)",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lib,
        "library_call": "index_copy_ of the num lane's kept values to their new slots",
        "shape": {"capacity": TABLE_CAP, "new_capacity": new_cap, "kept": n_kept,
                  "lanes": "MV: live, num, sdirty, stored"},
    }


def kernel_epoch_dtypes(torch, dev, rng):
    """E, F, G and H over their other lane types at a small size, each
    against its plain version: E with a null lane and negative
    timestamps; F over int32 + float64 keys (NaN, -0.0), retractions,
    invisible rows and every call kind (int64/int32/float64 SUM, int and
    float MIN/MAX); G on those lanes; H over bool, int32, float32 and a
    2-D lane. Exact, except the float64 SUM lanes, whose rows are added
    in another order (tolerance: 1e-12 relative)."""
    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.array.chunk import StreamChunk, flatten_stacked, stack_chunks
    from risingwave_tpu_torch.executors import hop_window as hw
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops.agg import AggCall

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cap, nch = 3000, 3
    chunks = []
    for _ in range(nch):
        m = int(rng.integers(cap // 2, cap))
        chunks.append(StreamChunk.from_numpy(
            {"t": rng.integers(-50_000, 50_000, m), "p": rng.integers(0, 9, m).astype(np.int32)},
            cap, ops=rng.integers(0, 4, m).astype(np.int32), nulls={"p": rng.random(m) < 0.3},
            device=dev,
        ))
    st = stack_chunks(chunks)
    ea = flatten_stacked(hw.hop_step_fn(st, "t", 9_000, 3_000, "w"))
    ep = flatten_stacked(hw._hop_torch(st, "t", 9_000, 3_000, "w"))
    assert_lanes_equal(torch, chunk_lanes(ea), chunk_lanes(ep), "E dtypes")

    n = 40_000
    f = rng.integers(-8, 8, n) / 4.0
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.1] = -0.0
    keys = (put(rng.integers(-20, 20, n).astype(np.int32)), put(f))
    signs = put(rng.choice([1, 1, 1, -1, 0], n).astype(np.int32))
    vals = {"v": put(rng.integers(-10**6, 10**6, n)), "w": put(rng.integers(-99, 99, n).astype(np.int32)),
            "x": put(rng.standard_normal(n)), "g": put(rng.standard_normal(n).astype(np.float32))}
    nulls = {"v": put(rng.random(n) < 0.1), "x": put(rng.random(n) < 0.1)}
    calls = (AggCall("count_star", None, "n"), AggCall("count", "v", "cv"), AggCall("sum", "v", "sv"),
             AggCall("sum", "w", "sw"), AggCall("sum", "x", "sx"), AggCall("min", "w", "mnw"),
             AggCall("max", "v", "mxv"), AggCall("min", "x", "mnx"), AggCall("max", "g", "mxg"))
    fa = agg_ops.reduce_by_key(keys, signs, calls, vals, nulls)
    fp = agg_ops._reduce_by_key_torch(keys, signs, calls, vals, nulls)
    la, lp = reduce_outputs(torch, fa), reduce_outputs(torch, fp)
    sx_a, sx_p = la.pop("red.sum_sx"), lp.pop("red.sum_sx")
    assert_lanes_equal(torch, la, lp, "F dtypes")
    check(torch.allclose(sx_a, sx_p, rtol=1e-12, atol=0, equal_nan=True), "F dtypes: float64 SUM")
    f_err = float((sx_a - sx_p).abs().nan_to_num(0.0).max())
    check(bool(fa[4]), "F dtypes: the MIN/MAX retraction latched")

    cap2 = 1 << 12
    in_dt = {"v": torch.int64, "w": torch.int32, "x": torch.float64, "g": torch.float32}
    slots = put(rng.integers(-1, cap2, n).astype(np.int32))
    sa, sp = (agg_ops.create_state(cap2, calls, in_dt, dev) for _ in range(2))
    live_a, live_p = (torch.zeros(cap2, dtype=torch.bool, device=dev) for _ in range(2))
    agg_ops.apply_reduced(sa, calls, slots, fa[1], fa[2], fa[3], fa[4], live=live_a)
    agg_ops._apply_reduced_torch(sp, calls, slots, fp[1], fp[2], fp[3], fp[4], live_p)
    ga, gp = state_lanes(sa), state_lanes(sp)
    acc_a, acc_p = ga.pop("accums.sx"), gp.pop("accums.sx")
    assert_lanes_equal(torch, ga, gp, "G dtypes")
    check(torch.equal(live_a, live_p), "G dtypes: live")
    check(torch.allclose(acc_a, acc_p, rtol=1e-12, atol=0, equal_nan=True), "G dtypes: float64 SUM")
    g_err = float((acc_a - acc_p).abs().nan_to_num(0.0).max())

    m = 5000
    lanes = {"b": put(rng.random(m) < 0.5), "i": put(rng.integers(-9, 9, m).astype(np.int32)),
             "f": put(rng.standard_normal(m).astype(np.float32)),
             "pair": put(rng.integers(-9, 9, (m, 3))), "d": put(rng.standard_normal(m))}
    live = put(rng.random(m) < 0.5)
    for mask in (None, live, (live, put(rng.random(m) < 0.2))):
        got = integrity.digest_from_scalar(integrity.device_digest(lanes, mask))
        host = integrity.host_digest(*integrity.host_lanes(lanes, mask)) if mask is not None else \
            integrity.host_digest({k: v.cpu().numpy() for k, v in lanes.items()})
        check(got == host, "H dtypes: kernel = numpy host_digest")
    return {"phase": "kernel_epoch_dtypes", "float64_sum_max_abs_err": max(f_err, g_err),
            "checks": "E null lane + negative ts; F int32/float64(NaN, -0.0) keys, retractions, "
                      "every call kind; G on those; H bool/int32/float32/float64/2-D lanes: equal"}


# -- phase 4: the interpreted path --------------------------------------------
def state_cap(expected_rows: int, floor: int) -> int:
    """Capacity whose growth margin covers the expected volume (the
    repo benchmark's ``_state_cap`` rule)."""
    cap = floor
    while expected_rows * 2.5 > cap:
        cap *= 2
    return cap


def q5_oracle(auction: np.ndarray, ts: np.ndarray, size: int, slide: int):
    """(auction, window_start, count) of the hop expansion, sorted."""
    first = ((ts - size) // slide + 1) * slide
    a_lo, w_lo = auction.min(), first.min()
    factor = size // slide
    n_w = int((first.max() - w_lo) // slide) + factor + 1
    packed = []
    for k in range(factor):
        ws = first + k * slide
        ok = ws <= ts
        packed.append((auction[ok] - a_lo) * n_w + (ws[ok] - w_lo) // slide)
    keys, counts = np.unique(np.concatenate(packed), return_counts=True)
    return keys // n_w + a_lo, (keys % n_w) * slide + w_lo, counts


def main_path(torch, dev, epochs: int):
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS, build_q5_lite

    t0 = time.perf_counter()
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=EVENT_RATE), seed=SEED)
    chunks, auctions, stamps = [], [], []
    for _ in range(epochs):
        per_epoch, done = [], 0
        while done < EVENTS_PER_EPOCH:
            n = min(CHUNK_EVENTS, EVENTS_PER_EPOCH - done)
            done += n
            bid = gen.next_chunks(n, CHUNK_EVENTS, device=dev)["bid"]
            if bid is not None:
                per_epoch.append(bid)
        chunks.append(per_epoch)
    for c in (c for ep in chunks for c in ep):
        v = c.valid.cpu().numpy()
        auctions.append(c.col("auction").cpu().numpy()[v])
        stamps.append(c.col("date_time").cpu().numpy()[v])
    n_bids = sum(len(a) for a in auctions)
    total_events = epochs * EVENTS_PER_EPOCH
    # about 0.3 (auction, window_start) groups per event at this rate
    cap = state_cap(int(0.3 * total_events), 1 << 16)
    q5 = build_q5_lite(capacity=cap, state_cleaning=False, device=dev)
    setup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    barrier_ms = []
    t_run = time.perf_counter()
    for per_epoch in chunks:
        for c in per_epoch:
            q5.pipeline.push(c)
        tb = time.perf_counter()
        q5.pipeline.barrier()
        torch.cuda.synchronize()
        barrier_ms.append((time.perf_counter() - tb) * 1e3)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    got = q5.mview.to_numpy()
    a, w, c = q5_oracle(
        np.concatenate(auctions), np.concatenate(stamps), Q5_WINDOW_MS, Q5_SLIDE_MS
    )
    order = np.lexsort((got["window_start"], got["auction"]))
    check(len(order) == len(a), f"q5: group count {len(order)} vs oracle {len(a)}")
    check(np.array_equal(got["auction"][order], a), "q5: auction lane vs oracle")
    check(np.array_equal(got["window_start"][order], w), "q5: window_start lane vs oracle")
    check(np.array_equal(got["num"][order], c), "q5: counts vs oracle")
    for name in ("lookup_or_insert", "agg_apply", "agg_flush", "mv_upsert", "hop_expand"):
        check(launches[name] > 0, f"kernel {name} launched on the interpreted path")
    check_claimed(q5, "q5")
    return {
        "phase": "q5", "epochs": epochs, "events": total_events, "bids": n_bids,
        "hopped_rows": int(5 * n_bids), "chunk_capacity": CHUNK_EVENTS,
        "bids_per_s": n_bids / run_s, "run_s": run_s, "setup_s": setup_s,
        "barrier_ms_p50": float(np.percentile(barrier_ms, 50)),
        "barrier_ms_p99": float(np.percentile(barrier_ms, 99)),
        "barrier_ms": barrier_ms, "groups": int(len(a)),
        "agg_capacity": q5.agg.table.capacity, "mv_capacity": q5.mview.table.capacity,
        "max_memory_allocated": int(peak), "launches": launches,
        "oracle": "numpy hop expansion + np.unique count: equal",
    }, launches, (chunks, cap, q5, (a, w, c))


def profile_q5(torch, dev, chunks, cap, epochs: int, fused: bool):
    """Where the time goes in phase 4's (or, ``fused``, phase 6's) run: a
    fresh q5-lite over the same chunks, one warm-up epoch, then
    ``epochs`` under ``torch.profiler``. Wall time of the window, device
    time summed over its kernels and copies, the device's idle share,
    the host time of the pushes and barriers, and the device time by
    kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    check(len(chunks) > epochs, "profile: more epochs than phase 4 ran")
    q5 = build_q5_lite(capacity=cap, state_cleaning=False, device=dev)
    if fused:
        fuse_pipeline(q5.pipeline, label="q5")
    host = {"push_s": 0.0, "barrier_s": 0.0}

    def run(per_epoch):
        t0 = time.perf_counter()
        for c in per_epoch:
            q5.pipeline.push(c)
        t1 = time.perf_counter()
        q5.pipeline.barrier()
        host["push_s"] += t1 - t0
        host["barrier_s"] += time.perf_counter() - t1

    run(chunks[0])
    torch.cuda.synchronize()
    host.update(push_s=0.0, barrier_s=0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for per_epoch in chunks[1 : 1 + epochs]:
            run(per_epoch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only: the host ops that launched them carry the
    # same time again
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    device_ms = sum(by_name.values())
    measured = bool(by_name)
    return {
        "phase": "q5_fused_profile" if fused else "q5_profile", "epochs": epochs,
        "bids": sum(int(c.valid.sum()) for ep in chunks[1 : 1 + epochs] for c in ep),
        "wall_ms": wall_s * 1e3,
        "device_ms": device_ms if measured else "not measured",
        "device_idle_share": 1 - device_ms / (wall_s * 1e3) if measured else "not measured",
        "host_push_ms": host["push_s"] * 1e3, "host_barrier_ms": host["barrier_s"] * 1e3,
        "device_ms_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15]),
    }


# -- phase 6: the fused per-barrier program ------------------------------------
FUSED_KERNELS = ("lookup_or_insert", "agg_flush", "mv_upsert", "hop_expand",
                 "reduce_by_key", "apply_reduced", "state_digest", "slot_move")


def mv_rows_sorted(mview) -> dict:
    got = mview.to_numpy()
    order = np.lexsort((got["window_start"], got["auction"]))
    return {k: v[order] for k, v in got.items()}


def state_digests(q5) -> dict:
    """The numpy host_digest of an executor pair's lanes, read back."""
    from risingwave_tpu_torch import integrity

    agg = integrity.agg_lanes(q5.agg.table, q5.agg.state, q5.agg._float_extremes)
    mv = integrity.mv_lanes(q5.mview.table, q5.mview.state)
    return {"agg": integrity.host_digest(*integrity.host_lanes(*agg)),
            "mv": integrity.host_digest(*integrity.host_lanes(*mv))}


def check_claimed(q5, what: str) -> None:
    """Each table's claimed-slot counter (kept by kernel A, read as the
    occupancy at every barrier) equals its claimed slots."""
    for name, table in (("agg", q5.agg.table), ("mv", q5.mview.table)):
        check(int(table.claimed) == int((table.fp1 != 0).sum()),
              f"{what}: {name} table's claimed counter")


def check_sync_guard(torch, dev) -> None:
    """The fused program's guard is armed: a device read inside it raises."""
    from risingwave_tpu_torch.runtime.fused_step import no_device_reads

    probe = torch.zeros(1, device=dev)
    try:
        with no_device_reads(dev):
            probe.item()
    except RuntimeError:
        return
    raise AssertionError("check failed: no_device_reads let a device read through")


def fused_path(torch, dev, chunks, cap, interp_q5, oracle):
    """q5 through ``fuse_pipeline`` over phase 4's chunks: one program per
    barrier (kernels E, F, A, G, then per flush round C, A, D, then H
    twice), run under ``no_device_reads`` (set_sync_debug_mode "error")
    from the end of the host bookkeeping to the staged scalar copy."""
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    check_sync_guard(torch, dev)
    q5 = build_q5_lite(capacity=cap, state_cleaning=False, device=dev)
    (wrapper,) = fuse_pipeline(q5.pipeline, label="q5")
    check(wrapper.covers_whole_chain, "fused: one program covers hop -> agg -> MV")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    barrier_ms, rounds, rebuilds, mv_caps = [], [], [], []
    t_run = time.perf_counter()
    for e, per_epoch in enumerate(chunks):
        for c in per_epoch:
            q5.pipeline.push(c)
        flush_before = _kernels.LAUNCHES["agg_flush"]
        mv_table = q5.mview.table
        tb = time.perf_counter()
        q5.pipeline.barrier()
        torch.cuda.synchronize()
        barrier_ms.append((time.perf_counter() - tb) * 1e3)
        rounds.append(_kernels.LAUNCHES["agg_flush"] - flush_before)
        mv_caps.append(q5.mview.table.capacity)
        if q5.mview.table is not mv_table:
            rebuilds.append({"barrier": e, "mv_capacity": q5.mview.table.capacity})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    got = mv_rows_sorted(q5.mview)
    a, w, c = oracle
    check(len(got["auction"]) == len(a), "fused: group count vs oracle")
    check(np.array_equal(got["auction"], a) and np.array_equal(got["window_start"], w)
          and np.array_equal(got["num"], c), "fused: MV vs oracle")
    interp = mv_rows_sorted(interp_q5.mview)
    check(all(np.array_equal(got[k], interp[k]) for k in got), "fused: MV vs phase 4's MV")
    lane_digests = state_digests(q5)
    interp_digests = state_digests(interp_q5)
    check(wrapper.last_digests == lane_digests,
          f"fused: staged digests {wrapper.last_digests} vs host_digest {lane_digests}")
    check(lane_digests == interp_digests, "fused: digests vs phase 4's interpreted state")
    for name in FUSED_KERNELS:
        check(launches[name] > 0, f"kernel {name} launched on the fused path")
    check_claimed(q5, "fused")
    tel = wrapper.last_telemetry
    check(tel["rows_in"] == sum(int(c.valid.sum()) for c in chunks[-1]),
          "fused: rows_in = the last epoch's bids")
    check(0 < tel["dirty_groups"] <= tel["mv_rows"] <= 2 * tel["dirty_groups"],
          "fused: dirty_groups and mv_rows (1 or 2 delta rows per group)")
    n_bids = sum(int(c.valid.sum()) for ep in chunks for c in ep)
    return {
        "phase": "q5_fused", "epochs": len(chunks), "bids": n_bids,
        "bids_per_s": n_bids / run_s, "run_s": run_s,
        "barrier_ms_p50": float(np.percentile(barrier_ms, 50)),
        "barrier_ms_p99": float(np.percentile(barrier_ms, 99)),
        "barrier_ms": barrier_ms, "flush_rounds": rounds, "mv_rebuilds": rebuilds,
        "mv_capacity_by_barrier": mv_caps,
        "agg_capacity": q5.agg.table.capacity, "mv_capacity": q5.mview.table.capacity,
        "max_memory_allocated": int(peak), "launches": launches,
        "digests": {k: f"{v:016x}" for k, v in lane_digests.items()},
        "last_telemetry": wrapper.last_telemetry,
        "sync_guard": "set_sync_debug_mode('error') over the program part of every barrier: held",
        "oracle": "numpy oracle and phase 4's MV: equal; staged digests = host_digest of "
                  "the lanes read back = host_digest of phase 4's state",
    }, launches


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--profile", type=int, default=0, metavar="EPOCHS",
                    help="profile this many of phase 4's epochs again, on each path")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from risingwave_tpu_torch import _kernels

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    emit({"phase": "build", "seconds": _kernels.build_all(),
          "libraries": sorted(_kernels.SOURCES)})

    rng = np.random.default_rng(SEED)
    a_row, a_out = kernel_a(torch, dev, rng)
    emit({"phase": "kernel", **a_row})
    b_row, b_results = kernel_b(torch, dev, rng, a_out)
    emit({"phase": "kernel", **b_row})
    c_row = kernel_c(torch, dev, rng, b_results, a_out[0])
    emit({"phase": "kernel", **c_row})
    del a_out, b_results
    d_row = kernel_d(torch, dev, rng)
    emit({"phase": "kernel", **d_row})
    emit(kernel_dtypes(torch, dev, rng))
    torch.cuda.empty_cache()
    e_row, flat = kernel_e(torch, dev)
    emit({"phase": "kernel", **e_row})
    f_row, f_out = kernel_f(torch, dev, flat)
    emit({"phase": "kernel", **f_row})
    del flat
    g_row, g_out = kernel_g(torch, dev, rng, f_out)
    emit({"phase": "kernel", **g_row})
    del f_out
    h_row = kernel_h(torch, dev, g_out)
    emit({"phase": "kernel", **h_row})
    i_row = kernel_i(torch, dev, g_out)
    emit({"phase": "kernel", **i_row})
    del g_out
    emit(kernel_epoch_dtypes(torch, dev, rng))
    torch.cuda.empty_cache()

    q5_row, launches, (chunks, cap, interp_q5, oracle) = main_path(torch, dev, EPOCHS)
    emit(q5_row)
    if args.profile:
        emit(profile_q5(torch, dev, chunks, cap, args.profile, fused=False))
    torch.cuda.empty_cache()
    fused_row, fused_launches = fused_path(torch, dev, chunks, cap, interp_q5, oracle)
    emit(fused_row)
    del interp_q5
    if args.profile:
        torch.cuda.empty_cache()
        emit(profile_q5(torch, dev, chunks, cap, args.profile, fused=True))
    del chunks

    rows = [a_row, b_row, c_row, d_row, e_row, f_row, g_row, h_row, i_row]
    keys = ("lookup_or_insert", "agg_apply", "agg_flush", "mv_upsert",
            "hop_expand", "reduce_by_key", "apply_reduced", "state_digest", "slot_move")
    for row, key in zip(rows, keys):
        # each main path's run counts from zero: phase 4 (interpreted)
        # and phase 6 (fused)
        row["launches_interpreted"] = launches[key]
        row["launches_fused"] = fused_launches[key]
        row["launches"] = launches[key] + fused_launches[key]
    keep = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_interpreted",
            "launches_fused")
    emit({"kernels": [{k: r[k] for k in keep} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
