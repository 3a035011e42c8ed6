#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``risingwave_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card: name, power limit;
  2. build: compile every kernel library from ``risingwave_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, on the
     same seeded inputs at the main paths' shapes (A-D: about 300k rows
     per apply, tables of 2^24 slots, and A on warps of one repeated new
     key and on keys whose hash128 h1 collide; E-H: a 16-chunk epoch of
     65,536 bid rows, 5,242,880 hopped rows, tables of 2^24 slots; I: a
     2^24-slot table rebuilt to 2^25 slots; J: a 65,536-row auction
     chunk on a 2^23-slot seen-set; L: a 32,768-row person chunk into a
     (2^23, 8) join side, and L's regrow entry from 2^20 to 2^21 slots;
     M: 65,536 probe rows against that side; H over q8's two join sides
     after phase 8; N: an 8,192-row and a 65,536-row bid chunk into a
     2^22-slot filter table; O: each state kind's expiry at q7's sizes, filter and agg
     2^22 slots, join side (2^22, 16); P: a 65,536-row U-/U+ flush chunk
     against a (2^22, 4) side of 1.2M auctions, M's group 2 and L's
     init_degree on a 65,536-row auction chunk at q101's sizes; Q: (a)
     one barrier's flush of q5's count agg, about 300,000 Insert/U-/U+
     rows, into the MAX agg's multisets of K = 256 lanes, (b) 2^20 rows
     of inserts and deletes (current extremes among them, NULLs, slot
     -1) over 2^20 groups of K = 32, float64 and int32 MIN, int64 and
     float32 MAX, (c) an
     overflow and an inconsistency, each latch, (d) Q's clear of half of
     (b)'s groups, (e) its rescatter from 2^20 to 2^21 slots), with
     times; K3, M's rw_lookup entry alone, re-probing (a)'s batch; R,
     each of its four entries (stage select, gather of every lane with
     one copy to the host, mark, scatter) on q5's agg at 2^24 slots (3M
     live, a third sdirty, 100,000 tombstones), a q8 join side (2^23, 8)
     with degrees and moved-degree marks, q5-max's MAX agg with its
     (2^14, 256) multisets, and an empty selection, with the host link's
     measured rate; then all eight join types at a small shape, the
     card's executor against one on the CPU; S, the expression kernel:
     ``rw_project`` over a battery of 133 trees reaching every opcode
     (arithmetic on each dtype, ``//``, ``%`` and ``/`` by zero,
     three-valued logic, IS NULL, BETWEEN, IN, CASE, COALESCE, NULLIF,
     CAST, TumbleStart, every EXTRACT and DATE_TRUNC field, every
     registered function, StringFunc over the generator's channel
     dictionary, a lifted literal) on 2^20 bid-shaped rows with NULL
     lanes, bit for bit but transcendental functions within 4 ulp, and
     ``rw_filter`` on agg-flush chunks with torn pairs (across a tile
     boundary and the wraparound; 1-D, stacked and 1,000-row chunks),
     timed on a 65,536-row bid chunk with q1's projection and q2's
     predicate; T, the watermark filter, on 65,536-row chunks with late
     inserts, retractions below the floor and torn pairs, mask, ops and
     running max exact; U, V, W and X at the TopN paths' shapes (run
     beside phases 18, 19 and 23, while their streams are on the card),
     and X on small stores built to reach each of its branches (ties
     across the k-th place, groups of k and k + 1 rows, dead-only
     groups, float and INT64-extreme keys, keys past 64 bits), W on
     small stores likewise (ties across the n-th place, n past the live
     count, all dead, NaN and -0.0, pk lanes past 64 bits, n of 0 and
     the capacity) and M on a small side in each mode with its output
     cut inside the pairs and inside group 2 and an empty chunk; A's,
     M's, W's and X's rows also give their device-only time
     (``torch.profiler``);
     Y, the SimpleAgg fold, on a 2^17-row U-/U+ flush chunk of q102's
     second count (COUNT(*), SUM(bid_count), a COUNT and float64 and
     float32 SUMs) and an append-only chunk through MIN/MAX calls, then a
     retraction of the MIN that must latch; Z, the general dynamic
     filter, its left step on a 2^17-row chunk of U-/U+ pairs into a
     2^22-slot store of 1.2M rows and its diff over that store with the
     right value moved up and down (run beside phase 24); AA, the tiled
     expansion, bit for bit: unnest on a 65,536-row auction chunk with
     LIST<int64> tags of cap 8 (lists of length 0, 8 and NULL), the
     series on phase 25's projection of a bid chunk and on NULL bounds,
     Expand's three grouping sets on a bid chunk and on null lanes, and
     both latches; AB, the temporal probe, bit for bit, both join types,
     against phase 28's auctions MV with NULL keys, after deletes and on
     an MV that grew (run beside phase 28);
  4. the interpreted path: Nexmark q5 (hop -> HashAgg -> device MV)
     through ``build_q5_lite(state_cleaning=False)``, chunk by chunk,
     over 20 epochs of 1M events, its final MV held against a numpy
     oracle, and the launch count of each kernel during that run;
  5. with ``--profile N`` only: N epochs of a path again, on fresh
     tables, under ``torch.profiler`` (where the time goes), after each
     of phases 4, 6, 7, 8, 9, 10, 11, 12, 13 and 14;
  6. the fused path: the same q5 through ``fuse_pipeline`` (one program
     per barrier, no device read inside it) over phase 4's chunks, its
     MV held against the oracle and phase 4's MV, its staged state
     digests against ``host_digest`` of the lanes read back and of
     phase 4's state, and the launch count of each kernel;
  7. Nexmark q8 interpreted: ``build_q8`` (tables of 2^23 slots, join
     fanout 8, out_cap 2^14) over the same 20 epochs of 1M events, one
     person chunk pushed left and one auction chunk pushed right per
     epoch, its final MV held against a copy of ``bench.py``'s q8 actor;
  8. q8 fused: ``fuse_pipeline`` on a fresh ``build_q8`` over the same
     chunks (one ``FusedTwoInputExecutor`` program per barrier), its MV
     held against the actor and phase 7's MV, its five staged digests
     against ``host_digest`` of the lanes read back and of phase 7's
     state;
  9. Nexmark q7 interpreted: ``build_q7`` at ``bench_q7``'s sizes
     (tables of 2^22 slots, join fanout 16, out_cap 2^14) over 20
     epochs of 1M events, each 8,192-event piece's bids one chunk
     pushed to both sides, ``watermark("date_time", max event time)``
     after every barrier; its final MV held against a copy of
     ``bench.py``'s q7 actor, and the watermarks' state cleaning
     checked (no live key below the last watermark);
  10. q7 fused: the same stream through ``fuse_pipeline`` (one
     ``FusedTwoInputExecutor`` program per barrier, the agg's flush
     rounds feeding the join; the watermark outside the program), its
     MV held against phase 9's at every barrier and the actor, its five
     staged digests against ``host_digest`` of the lanes read back and
     of phase 9's state;
  11. Nexmark q101 interpreted (each auction LEFT OUTER JOIN its
     maximum bid: a HashAgg MAX on the right whose flush feeds the
     join, a device MV keyed on the join's stream key (id, auction);
     agg 2^22 slots, join sides (2^22, 4), MV 2^23, out_cap 2^17) over
     20 epochs of 1M events, one auction chunk left and 65,536-event bid
     chunks right per epoch, its final MV held against a numpy oracle;
  12. q101 fused: the same stream through ``fuse_pipeline`` (one
     ``FusedTwoInputExecutor`` program per barrier, the agg's flush
     rounds feeding the join's degree kernel P), its MV held against
     phase 11's at every barrier and the oracle, its four staged digests
     against ``host_digest`` of the lanes read back and of phase 11's
     state;
  13. the MAX half of Nexmark q5 (``build_q5_max``: hop, COUNT(*) per
     (auction, window_start), a materialized MAX(num) per window_start
     with 256 distinct counts per window, a device MV on window_start)
     interpreted over phase 4's chunks (run right after phase 6, while
     they are on the card), a watermark after every barrier, its final
     MV held against a numpy oracle, mi_bad clear;
  14. q5-max fused: ``fuse_pipeline`` splits it into the hop and count
     agg as one epoch batch and the MAX agg and MV as one program per
     barrier (the row re-probe and kernel Q inside it), its MV held
     against phase 13's at every barrier and the oracle, its staged
     digests against ``host_digest`` of the lanes read back and of
     phase 13's state;
  15. q101 with its MAX materialized (the two-input program's agg side
     with kernel Q), interpreted and fused over phase 11's first three
     epochs, each MV against the q101 oracle of those epochs;
  16. kill and recover, for q5 and q5-max (after phase 14), q8 (after
     phase 8), q7 (after phase 10) and q101 (after phase 15): the
     query's first 10 epochs at its phase's table sizes, run A
     committing after every barrier into a LocalFsObjectStore under a
     temporary directory (the watermark where the query has one), run B
     uninterrupted beside it; after barrier 6 every object of A goes and
     the cache empties, a fresh build recovers (q5 and q8 also a second
     one that re-fuses through ``fuse_pipeline``), its MV and every
     table's kernel-H digest held against A's before the kill, then the
     recovered runs and B over the remaining epochs, MV and digests
     equal at every barrier, B's MV against the oracle at the end; the
     commit's stage and SST times, rows and bytes staged, the recovery's
     read and restore seconds and the peak memory.
  17. Nexmark q1 (``build_q1``: RowIdGen, a Project with ``0.908 *
     price``, a device MV on ``_row_id`` holding every bid) and q2
     (``build_q2``: a Filter ``MOD(auction, 123) = 0``, RowIdGen, an
     all-column Project, an MV) interpreted over phase 4's chunks (run
     after phase 16's q5 kills, while they are on the card), each MV
     against a numpy oracle of the same rows and expressions;
  18. q103's subquery (``build_hot_auctions``: a count per auction, a
     HAVING filter, an MV) with ``>= 20`` and ``< 20``, each interpreted
     and fused (one ``FusedChainExecutor`` program per barrier, the
     filter in its mid segment, the threshold lifted), and ``>= 25``
     fused beside them, over phase 4's chunks in lockstep: at every
     barrier each MV against the numpy oracle of cumulative counts and
     the fused against the interpreted; the staged digests against
     ``host_digest``; ``>= 20`` and ``>= 25`` run one kernel-S program
     with two parameter vectors;
  19. RisingWave's q103 and q104 (``build_q103``/``build_q104``: an
     auction chunk left, the bid chunks through the count agg and the
     HAVING filter right, a left semi / anti join, an MV on id) over
     phase 11's stream, interpreted and through ``fuse_pipeline`` (the
     whole program refused, the per-chain fallback printed), each MV
     against the numpy oracle at every barrier;
  20. q7 with the SQL planner's scan shape: a ``WatermarkFilter`` at the
     head of both sides (lag 1,000 ms) and no injected watermark calls,
     interpreted over phase 9's stream, its MV against the q7 actor on
     the rows the filters keep, and no table key below the last
     generated watermark (``Q7_SCAN_EPOCHS`` of them);
  21. Nexmark q19 on the retractable GroupTopN (``build_q19``: a store of
     every bid, 2^26 slots), interpreted and fused, over phase 4's
     first ``Q19_EPOCHS`` epochs;
  22. q19 on the append-only GroupTopN (``build_q19_append_only``: bands
     of (2^22, 10)), both ways, in lockstep with phase 21: the four MVs'
     digests equal at every barrier, each MV against the numpy oracle at
     ``Q19_CHECKS``;
  23. RisingWave's q105 (``build_q105``: the count before the join, a
     TopN of 1,000 by count) over phase 11's stream, both ways (the whole
     program refused for the TopN), each MV against the oracle at every
     barrier;
  24. RisingWave's q102 (``build_q102``: the count joined with the
     auctions; a dynamic filter of that join's U-/U+ stream against a
     SimpleAgg's average over a second count; an MV on (id, auction))
     over phase 11's stream, interpreted and with each stage through
     ``fuse_pipeline`` (stage 1 one program, stage 2 refused and run per
     chain, the refusals pinned), each MV against the numpy oracle at
     every barrier, the SimpleAgg's and the filter's kernel-H digests
     against ``host_digest``.
  25. q5 as a table function (Project lo/hi, ProjectSet
     generate_series(lo, hi) with max_steps 5, Project window_start,
     COUNT(*) per (auction, window_start), an MV; tables of phase 4's
     size) over phase 4's chunks, interpreted and fused (the chain split
     as Project, ProjectSet, one program), each MV equal to phase 4's
     q5-lite MV row for row;
  26. grouping sets (Expand over (auction), (bidder), (), COUNT(*) and
     SUM(price) on (auction, bidder, flag) with nullable keys, an MV;
     2^22 slots) over phase 4's chunks, both ways, against a numpy oracle;
  27. unnest (phase 11's auctions with LIST<int64> tags encoded by
     ``array/composite.py``, ProjectSet unnest, COUNT(*) per tag, an MV of
     2^17 slots), both ways, against a numpy oracle;
  28. temporal enrichment (auctions into a device MV on id; bids through
     an inner TemporalJoin for seller and category, COUNT(*) and
     SUM(price) per seller, an MV; 2^22 slots) over phase 11's stream in
     lockstep, the bid chain interpreted and fused, against a numpy
     oracle at every barrier;
  29. ranked bids (RowIdGen, Sort on date_time 2^21, the append-only
     OverWindow by auction 2^22 with row_number, count, sum/min/max, lag,
     rank and dense_rank, an MV on _row_id 2^26) over phase 4's chunks,
     a date_time watermark at each epoch's maximum after its barrier,
     interpreted and through ``fuse_pipeline`` (the MV refused behind the
     passthrough window, the refusal checked), equal at every barrier,
     the MV against a numpy oracle;
  30. closed-window bid sequences (RowIdGen, a 10 s tumble, the EOWC
     OverWindow by (window_start, auction) 2^21 with row_number, ranks,
     lead, lag(2), ROWS frames and a running max, an MV 2^26), both ways
     (the MV fused), against a numpy oracle of the closed windows;
  31. hot auctions ranked per window (hop 10 s / 2 s, COUNT(*) 2^24 in
     flush rounds of 2^17 groups, 0 - num, the general OverWindow 2^24
     with rank, dense_rank, row_number, lag and a running sum, an MV on
     the pk 2^26), both ways (the agg epoch-batched, the MV fused),
     against a numpy rank of q5's counts (ties of num order by arrival:
     runs agree per pk on num and the ranks, per window on the multiset
     of row_number, lag and sum);
  with AC (append, emit), AD, AE (EOWC emit, general recompute) and AF
  (apply with a ghost and a bad delete, diff) in phase 3 and the three
  paths' kills in phase 16 (5 epochs, the kill after barrier 3);
  32. q5 (hop, COUNT(*) 2^24, a device MV and a host MV beside it) under
     a device budget of a quarter of the un-evicted run's state: a
     commit into a LocalFsObjectStore after every barrier, then
     ``evict_cold`` on the agg, over phase 4's first 6 epochs
     (``COLD_EPOCHS``), both ways; at every barrier the MV's kernel-H
     digest equals the un-evicted run's and the host MV the device MV;
     re-created groups merge back (kernel AG's merge); the interpreted
     run is killed after barrier 4's eviction (``COLD_KILL_AT``) and
     recovered (phase 16's kill of 32); the
     store's point reads of every group equal the un-evicted agg's lanes;
  33. q8 under a budget over phase 7's events cut into epochs that end
     mid-window, a watermark 4 s behind after every eviction: both join
     sides evicted, returning keys faulted in (on touch, or all before
     the fused program), closed evicted keys tombstoned; killed and
     recovered as 32; point reads of live keys equal the un-evicted
     sides', closed keys read absent;
  34. q5-max under a budget (its MAX groups recorded, faulted in before
     any row lands on them, or to expire), both ways;
  with AG (the select on q5's agg, its merge candidates and a q8 side;
  the merge over every call kind and dtype) and R as fault-in (with
  multiset rows) in phase 3;
  then a host phase: VALUES into an MV, NOW over three barriers, a
  troublemaker at rate 1 whose logged faults show in the MV behind it,
  and phase 28's enrichment with its auctions in a host MV (one epoch);
  35. q5 from SQL (``StreamPlanner`` at bench.py's capacity, then
     ``graph_planned_mv``) over phase 4's chunks through the actor
     graph: one actor (bench.py's setting, no hash dispatch), and 4
     parallel agg actors behind kernel AH's dispatch masks, fused chains
     in the actors and chunk by chunk; each MV against the oracle and
     phase 4's MV, every instance owning some groups, their sum the
     MV's; no actor thread alive after ``close()``; the read guard under
     two threads;
  36. q8 from SQL at 4 parallel join actors over phase 7's events, both
     ways, its host MV against the q8 actor and phase 7's MV;
  37. q7 from SQL, one join actor (its keys trace to no source column,
     as in the reference), over phase 9's first chunk, both ways, against
     the q7 actor; the next chunk overflows the join side as in the
     reference's plan;
  with AH (vnode_of on every key dtype, the dispatch masks for 2-4
  downstreams) in phase 3 and phase 16's q5 from SQL killed at 4 actors
  and recovered at 3 (every restored row routed by AH's vnode_of).
  38. q5 from SQL through ``sharded_planned_mv`` (the agg and the MV
     stacked over a mesh on the card, rows exchanged by kernel AI) over
     phase 4's chunks at 4 and 8 shards: the MV against the oracle and
     phase 4's MV, every shard owning groups, their sum the MV's rows,
     the routed rows summing to the valid hopped rows, no latch set;
  39. q8 from SQL sharded at 4 over phase 7's events (the MV against the
     q8 actor and phase 7's MV), and beside it a run committed after
     every barrier, killed after barrier 6 of 10 and recovered at 8
     shards (every restored row routed by vnode), equal to the
     uninterrupted run at every barrier after;
  40. q7 from SQL sharded at 4 (the MAX agg's stacked flush into the
     sharded join, a sharded MV) over phase 9's first chunk against the
     q7 actor; the next chunk overflows the join side as the serial
     plan's does;
  41. q19's retractable GroupTopN sharded at 4 (RowIdGen, StackSplit,
     ShardedGroupTopN, q19's device MV) over phase 21's chunks, the MV's
     kernel-H digest equal to phase 21's at every barrier;
  with AI (q5's hopped chunks stacked at 4 shards and split 8 ways, every
  key dtype, a nullable key, a chunk past its bucket) in phase 3. Each
  sharded phase prints rows/s, barrier p50/p99, peak bytes, AI's
  launches, launches and flush rounds per barrier and the rows each
  shard received. Phases 32-34 run 6 epochs (the kill after barrier 4)
  since phases 38-41 came.
Phase 16 also kills and recovers q19 and q105 (after phase 23), q102
(after phase 24), phases 25 and 26 (after q5-max's kill) and phase 28
(after phase 28). Then a ``{"kernels": [...]}`` line, the nvidia-smi name/power line, and
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
import types
from collections import Counter

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
# q8 (phases 7-8), bench.py's settings: tables of _state_cap(0.09 * 20M,
# 2^16) slots each, one person and one auction chunk per epoch
Q8_CAP = 1 << 23
Q8_FANOUT = 8
Q8_OUT_CAP = 1 << 14
P_ROWS = 32_768  # person chunk capacity (about 20,000 persons an epoch)
A_ROWS = 65_536  # auction chunk capacity (about 60,000 auctions an epoch)
# q7 (phases 9-10), bench.py's bench_q7 settings at q5's volume: every
# table _state_cap(1M, 2^16) slots, join fanout 16, out_cap 2^14, the
# bids of each 8,192-event piece one chunk pushed to both sides (the
# chunking of bench.py's "full" tier). With 65,536-event pieces the
# first chunk of a window passes all its bids (a new group passes), and
# a (window, price) key collects more bids than the fanout holds
# (scripts/q7_join_fanout.py counts them): the join raises.
Q7_CAP = 1 << 22
Q7_FANOUT = 16
Q7_OUT_CAP = 1 << 14
Q7_CHUNK_EVENTS = 8_192
Q7_COLS = ("auction", "bidder", "price", "date_time")
# q101 (phases 11-12): tables sized up front by bench.py's _state_cap
# rule for about 1.2M auctions and 2.4M claimed MV keys (padded rows
# included); the agg flushes 2^15 groups a round (its default), so a
# flush chunk holds up to 65,536 U-/U+ rows, and one join emission up to
# 98,304 pairs and transitions
Q101_AGG_CAP = 1 << 22
Q101_JOIN_CAP = 1 << 22
Q101_FANOUT = 4
Q101_MV_CAP = 1 << 23
Q101_OUT_CAP = 1 << 17


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so
    far (``t_s``), so the time each phase takes shows in the log."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
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


def device_time_ms(torch, fn, reps: int, setup=None) -> float:
    """Device-only time of ``fn`` a call: the summed spans of the device
    events ``torch.profiler`` records over ``reps`` calls (after a
    warm-up), less ``setup``'s device-to-device copies
    (``restore_table``), over ``reps``: the time the trace shows the card
    busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    total = sum(ev.time_range.elapsed_us() for ev in prof.events()
                if ev.device_type == DeviceType.CUDA and not ev.name.startswith("Memcpy DtoD"))
    return total / 1e3 / reps if total > 0 else None  # None: the profiler saw no kernel


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
def a_same(torch, base, keys, valid, what: str) -> None:
    """Kernel A and its plain version on copies of ``base``, held row for
    row (found, inserted, placed), rows sharing a slot iff they share a
    key, keys that were in ``base`` at their slot, the same stored keys
    and claimed count."""
    from risingwave_tpu_torch.ops import hash_table as ht

    ta, tp = clone_table(base), clone_table(base)
    _, sa, fa, ia = ht.lookup_or_insert(ta, keys, valid)
    _, sp, fp, ip = ht._lookup_or_insert_torch(tp, keys, valid)
    torch.cuda.synchronize()
    check(torch.equal(fa, fp) and torch.equal(ia, ip), f"A {what}: found, inserted per row")
    check(torch.equal(sa >= 0, sp >= 0), f"A {what}: placed rows")
    ok = valid & (sa >= 0)
    _, key_id = torch.unique(torch.stack([k[ok] for k in keys], 1), dim=0, return_inverse=True)
    s = sa[ok].long()
    pairs = torch.unique(torch.stack([key_id, s], 1), dim=0)
    check(pairs.shape[0] == int(key_id.max()) + 1 == torch.unique(s).numel(),
          f"A {what}: rows share a slot iff they share a key")
    old = fp & ok
    check(torch.equal(sa[old], sp[old]), f"A {what}: existing keys at their slot")
    stored = lambda t: torch.unique(torch.stack([k[t.fp1 != 0] for k in t.keys], 1), dim=0)
    check(torch.equal(stored(ta), stored(tp)), f"A {what}: same stored keys")
    check(int(ta.claimed) == int(tp.claimed) == int((ta.fp1 != 0).sum()),
          f"A {what}: claimed-slot counter")


def a_hard_batches(torch, dev, rng) -> dict:
    """A against its plain version where warps meet one key: a new key
    repeated over whole warps (and each of 128 new keys over one warp),
    and keys whose hash128 h1 agree but whose keys differ (pairs found by
    a host search with the plain hash128 over 2^18 random keys), both
    new, then both found, interleaved in single warps."""
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops.hashing import hash128

    base = ht.HashTable.create(1 << 16, (torch.int64, torch.int64), device=dev)
    pre = torch.from_numpy(rng.choice(1 << 40, 8_000, replace=False).astype(np.int64)).to(dev)
    _, pre_slots, _, _ = ht._lookup_or_insert_torch(
        base, (pre, pre * 3), torch.ones(8_000, dtype=torch.bool, device=dev))
    base.live[pre_slots[::2].long()] = True  # the rest: tombstones
    hot = np.full(4096, (1 << 41) + 7, np.int64)  # one new key over 128 warps
    per_warp = np.repeat((1 << 42) + np.arange(128, dtype=np.int64), 32)
    old = pre[torch.from_numpy(rng.integers(0, 8_000, 4096)).to(dev)].cpu().numpy()
    k0 = torch.from_numpy(np.concatenate([hot, per_warp, old])).to(dev)
    valid = torch.from_numpy(rng.random(len(k0)) > 0.02).to(dev)
    a_same(torch, base, (k0, k0 * 3), valid, "repeated new keys")

    cand = torch.from_numpy(rng.choice(1 << 50, 1 << 18, replace=False).astype(np.int64)).to(dev)
    h1, _ = hash128((cand,))
    order = torch.argsort(h1)
    hs = h1[order]
    same = torch.nonzero(hs[1:] == hs[:-1]).flatten()
    check(same.numel() > 0, "A: an h1 collision among 2^18 keys")
    a_keys, b_keys = cand[order[same]], cand[order[same + 1]]
    check(bool((a_keys != b_keys).all()), "A: colliding keys differ")
    pair = torch.stack([a_keys, b_keys], 1)  # (m, 2)
    # per pair two warps: a, b alternating, then a's and b's halves
    lane = torch.arange(32, device=dev)
    alt = pair[:, lane % 2]
    halves = pair[:, (lane >= 16).long()]
    keys1 = torch.cat([alt, halves], 1).reshape(-1)
    one = ht.HashTable.create(1 << 12, (torch.int64,), device=dev)
    ones = torch.ones(len(keys1), dtype=torch.bool, device=dev)
    a_same(torch, one, (keys1,), ones, "h1-colliding keys, new")
    _, placed, _, _ = ht._lookup_or_insert_torch(one, (keys1,), ones)
    one.live[placed[::3].long()] = True
    a_same(torch, one, (keys1,), ones, "h1-colliding keys, found")
    return {"repeated_rows": len(k0), "h1_collisions": int(same.numel())}


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
    # per row its two key lanes and valid read, slot, found and inserted
    # written; per valid row the stamp, key lanes and live of its slot
    # read (a probe reads no fingerprint); per new slot its fp1, fp2,
    # stamp and key lanes written
    nbytes = ROWS * (16 + 1 + 4 + 1 + 1) + n_valid * (4 + 16 + 1) + n_new * 28
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
    dev_ms = device_time_ms(torch, lambda: ht.lookup_or_insert(ta, (k0, k1), valid), 5, setup)
    hard = a_hard_batches(torch, dev, rng)
    return {
        "name": "A lookup_or_insert", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/lookup_or_insert.cu",
        "replaces": "risingwave_tpu/ops/hash_table.py:119",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": None,
        "ms_at_end_load": ms_end,
        "shape": {"rows": ROWS, "capacity": TABLE_CAP, "new_slots": n_new,
                  "occupied_before": MID_KEYS, "occupied_before_end_load": END_KEYS,
                  **hard},
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
        "library_call": "none: no one PyTorch call upserts with the last row per slot winning",
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
        "library_call": "none: no one PyTorch call computes each row's windows and tiles "
                        "every lane",
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
    again = agg_ops.reduce_by_key(keys, signs, calls, {}, {})
    check(all(torch.equal(a, b) for a, b in zip(la.values(), reduce_outputs(torch, again).values())),
          "F: a second call gives the same bits")
    hard = f_hard_cases(torch, dev, np.random.default_rng(SEED + 5))
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
        "hard_cases": hard,
    }, (keys, fa)


F_HARD_CALLS = (("count_star", None, "n"), ("count", "v", "cv"), ("sum", "v", "sv"),
                ("sum", "w", "sw"), ("sum", "f", "sf"), ("sum", "g", "sg"), ("min", "v", "mnv"),
                ("max", "w", "mxw"), ("min", "f", "mnf"), ("max", "g", "mxg"))
F_HARD_ROWS = 8 * 2048 + 17  # eight reduce tiles and a few rows of a ninth
F_FLOAT_SUMS = ("red.sum_sf", "red.sum_sg")


def f_hard_input(torch, dev, rng, n: int, k=None, x=None, signs=None):
    """Key lanes (int64 ``k``, float64 ``x``), signs and value lanes of n
    rows: random keys unless given, signs mostly +1 with retractions and
    invisible rows, int64/int32/float64/float32 values with NULLs."""
    if k is None:
        k = rng.integers(0, 300, n).astype(np.int64)
    if x is None:
        x = rng.choice(np.array([0.0, -0.0, 1.5, np.nan]), n)
    if signs is None:
        signs = np.where(rng.random(n) < 0.8, 1, -1).astype(np.int32)
        signs[rng.random(n) < 0.1] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    values = {"v": t(rng.integers(-(10**12), 10**12, n).astype(np.int64)),
              "w": t(rng.integers(-1000, 1000, n).astype(np.int32)),
              "f": t(rng.standard_normal(n) * 1e3),
              "g": t((rng.standard_normal(n) * 50).astype(np.float32))}
    nulls = {"v": t(rng.random(n) < 0.1), "f": t(rng.random(n) < 0.1)}
    return (t(k), t(x)), t(signs), values, nulls


def f_bits(torch, a):
    """A lane as integers of its width, so floats compare bit for bit."""
    if not a.dtype.is_floating_point:
        return a
    return a.view(torch.int64 if a.element_size() == 8 else torch.int32)


def f_hard_one(torch, dev, what, keys, signs, values, nulls, fingerprints=None) -> dict:
    """One hard case: the kernel twice (the same bits) against the plain
    version (integer lanes, keys, rep_valid, w, the latch exact; float
    sums within SUM_RTOL (float64) or F32_SUM_TOL sqrt(n) (float32) of the
    segment's sum of magnitudes, from the plain version over |x| and |sign|:
    the same segments)."""
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops.agg import AggCall

    calls = tuple(AggCall(*c) for c in F_HARD_CALLS)
    n = signs.numel()
    got = agg_ops._reduce_by_key_cuda(keys, signs, calls, values, nulls, fingerprints)
    again = agg_ops._reduce_by_key_cuda(keys, signs, calls, values, nulls, fingerprints)
    want = agg_ops._reduce_by_key_torch(keys, signs, calls, values, nulls, fingerprints)
    mag_vals = dict(values, f=values["f"].abs(), g=values["g"].abs().double())
    mags = reduce_outputs(torch, agg_ops._reduce_by_key_torch(keys, signs.abs(), calls, mag_vals,
                                                               nulls, fingerprints))
    torch.cuda.synchronize()
    lg, la, lw = (reduce_outputs(torch, o) for o in (got, again, want))
    check(lg.keys() == lw.keys() == la.keys(), f"F {what}: lanes")
    worst = 0.0
    for name, a in lg.items():
        check(torch.equal(f_bits(torch, a), f_bits(torch, la[name])),
              f"F {what}: {name} the same bits twice")
        b = lw[name]
        check(a.dtype == b.dtype and a.shape == b.shape, f"F {what}: {name} dtype, shape")
        if name in F_FLOAT_SUMS:
            tol = (SUM_RTOL if name == "red.sum_sf" else F32_SUM_TOL * max(n, 1) ** 0.5)
            err = (a.double() - b.double()).abs()
            check(bool((err <= tol * mags[name]).all()), f"F {what}: {name} within tolerance")
            worst = max(worst, float(err.max()) if n else 0.0)
        else:
            check(torch.equal(f_bits(torch, a), f_bits(torch, b)), f"F {what}: {name} bit for bit")
    return {"rows": n, "segments": int(got[1].sum()), "retracted": bool(got[4]),
            "float_sum_max_abs_err": worst}


def f_hard_cases(torch, dev, rng) -> dict:
    """F's hard cases on the card: a hot key whose segment spans every
    reduce tile (its float64 and float32 sums carried across them), every
    row one key (NaN keys equal), every row invisible, forced fingerprint
    collisions with visible rows on the all-ones fingerprint, and n of 0,
    1 and one past a tile."""
    n = F_HARD_ROWS
    out = {}
    k = rng.integers(0, 300, n).astype(np.int64)
    x = rng.choice(np.array([0.0, 1.5]), n)
    hot = rng.random(n) < 0.7
    k[hot], x[hot] = 7, np.where(rng.random(int(hot.sum())) < 0.5, 0.0, -0.0)
    out["hot key"] = f_hard_one(torch, dev, "hot key", *f_hard_input(torch, dev, rng, n, k, x))
    ones = np.full(n, 5, np.int64)
    out["one key"] = f_hard_one(torch, dev, "one key", *f_hard_input(
        torch, dev, rng, n, ones, np.full(n, np.nan), np.ones(n, np.int32)))
    out["invisible"] = f_hard_one(torch, dev, "every row invisible", *f_hard_input(
        torch, dev, rng, n, signs=np.zeros(n, np.int32)))
    keys, signs, values, nulls = f_hard_input(torch, dev, rng, n)
    h1 = torch.from_numpy(rng.choice(np.array([3, 9, 0xFFFFFFFF]), n).astype(np.int64)).to(dev)
    h2 = torch.from_numpy(rng.choice(np.array([1, 0xFFFFFFFF]), n).astype(np.int64)).to(dev)
    out["collisions"] = f_hard_one(torch, dev, "forced collisions", keys, signs, values, nulls,
                                   (h1, h2))
    for m in (0, 1, 2049):
        out[f"n={m}"] = f_hard_one(torch, dev, f"n={m}", *f_hard_input(torch, dev, rng, m))
    return out


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


def digest_bytes(lanes_live) -> int:
    """What one digest must read: its mask lanes over every slot, and
    every lane only at the slots the mask keeps (the others fold to 0)."""
    from risingwave_tpu_torch import integrity

    lanes, live = lanes_live
    masks = integrity._masks(live)
    keep = masks[0].clone()
    for m in masks[1:]:
        keep |= m
    cap = keep.shape[0]
    per_slot = 0
    for a in lanes.values():
        t = a.lane if isinstance(a, integrity.Masked) else a
        per_slot += t.element_size() * (t.numel() // cap)
    return cap * len(masks) + int(keep.sum()) * per_slot


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
    nbytes = digest_bytes(agg) + digest_bytes(mv)
    return {
        "name": "H state digest", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/state_digest.cu",
        "replaces": "risingwave_tpu/integrity.py:329",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "library_call": "none: no one PyTorch call hashes rows into the reference's digest",
        "shape": {"capacity": TABLE_CAP, "calls": "agg lanes + MV lanes (one barrier's two digests)",
                  "bytes": nbytes},
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


# -- phase 3, q8's kernels (J, L, M; H with an entry mask) ------------------------
def clone_side(side):
    from risingwave_tpu_torch.ops.join import JoinSide

    return JoinSide(
        clone_table(side.table), {k: t.clone() for k, t in side.rows.items()},
        {k: t.clone() for k, t in side.row_nulls.items()}, side.row_valid.clone(),
        side.overflow.clone(), side.inconsistent.clone(), side.sdirty.clone(),
        side.stored.clone(), side.degree.clone(),
    )


def side_lanes(side) -> dict:
    """Every tensor lane of a JoinSide, by name (its table's included)."""
    out = {f"table.{k}": t for k, t in vars(side.table).items() if hasattr(t, "dtype")}
    out.update({f"table.key{i}": k for i, k in enumerate(side.table.keys)})
    for name, v in vars(side).items():
        if isinstance(v, dict):
            out.update({f"{name}.{k}": t for k, t in v.items()})
        elif hasattr(v, "dtype"):
            out[name] = v
    return out


def restore_side(dst, src) -> None:
    for a, b in zip(side_lanes(dst).values(), side_lanes(src).values()):
        a.copy_(b)


def left_chunk(torch, dev, ids, starts, names, ops=None, cap=None):
    """A person-side chunk (id, name, starttime) on the card."""
    from risingwave_tpu_torch.array.chunk import StreamChunk

    cols = {"id": np.asarray(ids, np.int64), "name": np.asarray(names, np.int32),
            "starttime": np.asarray(starts, np.int64)}
    return StreamChunk.from_numpy(cols, cap or len(cols["id"]), ops=ops, device=dev)


def q8_left_side(torch, dev, rng, cap: int, n_keys: int, fanout: int = Q8_FANOUT):
    """A (cap, fanout) person-shaped join side holding ``n_keys`` keys,
    filled through A + L in 65,536-row chunks, plus a full bucket (key
    id 1) and a key holding one row twice (id 2). Returns the side and
    the filled keys' ids, starts and names."""
    from risingwave_tpu_torch.ops.join import JoinSide, apply_side

    names = ("id", "name", "starttime")
    side = JoinSide.create(cap, fanout, (torch.int64, torch.int64),
                           {"id": torch.int64, "name": torch.int32, "starttime": torch.int64},
                           device=dev)
    ids = rng.permutation(n_keys).astype(np.int64) + 1000
    starts = rng.integers(0, 200, n_keys) * 10_000
    names_ = rng.integers(0, 1000, n_keys)
    full = (np.full(fanout, 1), np.zeros(fanout), np.arange(fanout))
    dup = (np.full(2, 2), np.zeros(2), np.full(2, 7))
    batches = [(ids[i:i + 65_536], starts[i:i + 65_536], names_[i:i + 65_536])
               for i in range(0, n_keys, 65_536)] + [full, dup]
    for b_ids, b_starts, b_names in batches:
        c = left_chunk(torch, dev, b_ids, b_starts, b_names)
        apply_side(side, (c.col("id"), c.col("starttime")), {k: c.col(k) for k in names}, {},
                   c.valid, c.ops, names)
    return side, ids, starts, names_


def kernel_j(torch, dev, rng, cap: int = Q8_CAP, n: int = A_ROWS, prefill: int = 282_247):
    """J against its plain version: a 65,536-row auction chunk (new keys
    with in-chunk repeats, keys seen before, one DELETE row) after A on
    a seen-set of ``prefill`` keys; and J's first-occurrence entry
    alone."""
    import dataclasses

    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import dedup as dd
    from risingwave_tpu_torch.ops import hash_table as ht

    keys = ("seller", "astarttime")
    table = ht.HashTable.create(cap, (torch.int64, torch.int64), device=dev)
    sdirty = torch.zeros(cap, dtype=torch.bool, device=dev)
    scratch = ht.first_scratch(cap, dev)
    latches = lambda: (torch.zeros((), dtype=torch.bool, device=dev),
                       torch.zeros((), dtype=torch.bool, device=dev))
    seen_s = rng.integers(1000, 10**7, prefill)
    seen_w = rng.integers(0, 200, prefill) * 10_000
    for i in range(0, prefill, n):
        c = StreamChunk.from_numpy({"seller": seen_s[i:i + n], "astarttime": seen_w[i:i + n]}, n,
                                   device=dev)
        dd.dedup_step_fn(table, sdirty, c, keys, scratch, latches())
    pick = rng.integers(0, prefill, n // 4)
    pool = rng.integers(10**8, 2 * 10**8, n // 4)  # new keys, each about 3 times
    new = rng.integers(0, len(pool), n - len(pick))
    sel = np.concatenate([seen_s[pick], pool[new]])
    win = np.concatenate([seen_w[pick], np.zeros(len(new), np.int64)])
    ops = np.zeros(n, np.int32)
    ops[0] = 1  # one DELETE, of a key seen before
    chunk = StreamChunk.from_numpy({"seller": sel, "astarttime": win}, n, ops=ops, device=dev)
    signs = chunk.effective_signs()
    valid = chunk.valid & (signs > 0)
    _, slots, _, inserted = ht.lookup_or_insert(table, tuple(chunk.col(k) for k in keys), valid)
    outs = []
    for fn in ("cuda", "torch"):
        t = dataclasses.replace(table, live=table.live.clone())
        sd, lat = sdirty.clone(), latches()
        if fn == "cuda":
            emit = dd._dedup_emit_cuda(t, sd, chunk, slots, inserted, scratch, lat)
        else:
            emit = dd._dedup_emit_torch(t, sd, chunk, signs, valid, slots, inserted, lat)
        outs.append({"emit": emit, "live": t.live, "sdirty": sd, "saw_delete": lat[0],
                     "dropped": lat[1]})
    torch.cuda.synchronize()
    assert_lanes_equal(torch, outs[0], outs[1], "J")
    check(bool(outs[0]["saw_delete"]) and not bool(outs[0]["dropped"]), "J: latches")
    check(bool((scratch == ht.FIRST_SENTINEL).all()), "J: scratch reset")
    n_emit = int(outs[0]["emit"].sum())
    check(n_emit == len(np.unique(pool[new])), "J: one emitted row per new key")
    first_k = ht.first_occurrence_mask(slots, valid, scratch)
    first_p = ht._first_occurrence_torch(slots, valid)
    check(torch.equal(first_k, first_p), "J: first_occurrence_mask entry")
    err = max_abs_diff(torch, outs[0], outs[1])
    t = dataclasses.replace(table, live=table.live.clone())
    sd, lat = sdirty.clone(), latches()
    ms = time_ms(torch, lambda: dd._dedup_emit_cuda(t, sd, chunk, slots, inserted, scratch, lat), 20)
    plain = time_ms(torch, lambda: dd._dedup_emit_torch(t, sd, chunk, signs, valid, slots, inserted,
                                                         lat), 5)
    key = torch.where(inserted, slots, -1)
    lib = time_ms(torch, lambda: torch.unique(key, return_inverse=True), 10)
    n_ins = int(inserted.sum())
    # valid, ops, slots, inserted read and emit written per row; per
    # inserted row live and sdirty written, the scratch entry read and
    # written twice
    nbytes = n * (1 + 4 + 4 + 1 + 1) + n_ins * (1 + 1 + 16)
    return {
        "name": "J dedup emit", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/dedup_emit.cu",
        "replaces": "risingwave_tpu/executors/dedup.py:47 (with ops/hash_table.py:342)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lib,
        "library_call": "torch.unique(slot, return_inverse=True), the grouping alone",
        "shape": {"rows": n, "capacity": cap, "seen_keys": prefill, "inserted_rows": n_ins,
                  "emitted": n_emit},
    }


def kernel_l(torch, dev, rng, cap: int = Q8_CAP, n: int = P_ROWS, prefill: int = 400_000):
    """L against its plain version on one person chunk after A, into a
    (cap, 8) side holding ``prefill`` keys: new keys, second rows of
    stored keys, four inserts of one new key, a 9th row for a full
    bucket (overflow), two deletes of a row stored twice, an insert and
    a delete of one row (net out), a delete of an absent row
    (inconsistent) and padding. Every lane equal, latches included.
    Then the hot-slot case (``kernel_l_hot``), reported in the row's
    ``hot_slots``. Returns the row and the applied side (M probes it)."""
    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import join as jn

    names = ("id", "name", "starttime")
    side, ids, starts, stored_names = q8_left_side(torch, dev, rng, cap, prefill)
    m = n - 16  # the rest is padding
    k_new = m - 4 - 1 - 2 - 2 - 1 - 200
    pick = rng.integers(0, prefill, 200)
    c_ids = np.concatenate([rng.permutation(k_new) + 10**9, ids[pick], np.full(4, 3), [1], [2, 2],
                            [4, 4], [5]])
    c_st = np.concatenate([np.zeros(k_new), starts[pick], np.zeros(10)]).astype(np.int64)
    c_nm = np.concatenate([rng.integers(0, 1000, k_new + 200), [1, 2, 3, 4], [99], [7, 7],
                           [5, 5], [6]])
    ops = np.zeros(m, np.int32)
    ops[-5:-3] = 1  # the stored twice row, deleted twice
    ops[-2] = 1  # the netting-out row's delete
    ops[-1] = 1  # absent row
    chunk = left_chunk(torch, dev, c_ids, c_st, c_nm, ops=ops, cap=n)
    key_cols = (chunk.col("id"), chunk.col("starttime"))
    pay = {k: chunk.col(k) for k in names}
    _, slots, _, _ = ht.lookup_or_insert(side.table, key_cols, chunk.valid)
    base = clone_side(side)
    got, want = clone_side(base), clone_side(base)
    jn._apply_side_cuda(got, slots, pay, {}, chunk.valid, chunk.ops, names)
    jn._apply_side_torch(want, slots, pay, {}, chunk.valid, chunk.ops, names)
    torch.cuda.synchronize()
    lanes_k, lanes_p = side_lanes(got), side_lanes(want)
    assert_lanes_equal(torch, lanes_k, lanes_p, "L")
    check(bool(got.overflow) and bool(got.inconsistent), "L: overflow and inconsistent latches")
    digs = [integrity.digest_from_scalar(integrity.device_digest(*integrity.join_side_lanes(s)))
            for s in (got, want)]
    check(digs[0] == digs[1], "L: join-side digests")
    err = max_abs_diff(torch, lanes_k, lanes_p)
    work = clone_side(base)
    setup = lambda: restore_side(work, base)
    ms = time_ms(torch, lambda: jn._apply_side_cuda(work, slots, pay, {}, chunk.valid, chunk.ops,
                                                    names), 10, setup)
    plain = time_ms(torch, lambda: jn._apply_side_torch(work, slots, pay, {}, chunk.valid,
                                                        chunk.ops, names), 3, setup)
    n_del = int((ops == 1).sum())
    n_ins = m - n_del
    fanout = side.fanout
    hot = kernel_l_hot(torch, dev, rng, base, work, want, ids, starts, stored_names, n)
    row = {
        "name": "L join apply", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/join_apply.cu",
        "replaces": "risingwave_tpu/ops/join.py:215 (with :141, :178, :192)",
        "max_abs_err": max(err, hot["max_abs_err"]), "ms": ms, "plain_ms": plain,
        "bound_ms": bound_ms(l_bytes(n, m, n_ins, n_del, fanout)),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"rows": n, "capacity": cap, "fanout": fanout, "stored_keys": prefill + 2,
                  "inserts": n_ins, "deletes": n_del},
        "hot_slots": hot,
    }
    del base, want, work
    return row, got


def l_bytes(n: int, m: int, n_ins: int, n_del: int, fanout: int) -> int:
    """Kernel L's bytes: per row valid, ops, slot and 20 payload bytes
    read; per touching row its bucket's row_valid read, sdirty and live
    written; per insert its entry (20 + 1 + 4 B) written; per delete its
    bucket's payload read."""
    return n * (1 + 4 + 4 + 20) + m * (fanout + 2) + n_ins * 25 + n_del * fanout * 20


def kernel_l_hot(torch, dev, rng, base, got, want, ids, starts, names, n: int) -> dict:
    """L where most rows share a slot: ``n`` rows over eight stored keys
    of ``base`` (one row each), half inserts into four of them (each
    bucket has fanout - 1 free positions, the rest overflow), half
    deletes on the other four (half of them of the key's stored row:
    the first clears it, the rest and the absent rows latch
    inconsistent). Every lane equal to the plain version; timed beside
    it. ``got`` and ``want`` are scratch sides; ``base`` gains nothing
    (its keys are all stored already)."""
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import join as jn

    cols = ("id", "name", "starttime")
    half = n // 2
    k_ins = rng.integers(0, 4, half)
    k_del = rng.integers(4, 8, n - half)
    c_ids = np.concatenate([ids[k_ins], ids[k_del]])
    c_st = np.concatenate([starts[k_ins], starts[k_del]])
    d_nm = np.where(rng.random(n - half) < 0.5, names[k_del], rng.integers(0, 1000, n - half))
    c_nm = np.concatenate([rng.integers(0, 1000, half), d_nm])
    ops = np.concatenate([np.zeros(half, np.int32), np.ones(n - half, np.int32)])
    chunk = left_chunk(torch, dev, c_ids, c_st, c_nm, ops=ops)
    key_cols = (chunk.col("id"), chunk.col("starttime"))
    pay = {k: chunk.col(k) for k in cols}
    claimed = int(base.table.claimed)
    _, slots, _, _ = ht.lookup_or_insert(base.table, key_cols, chunk.valid)
    check(int(base.table.claimed) == claimed, "L hot slots: every key stored already")
    restore_side(got, base)
    restore_side(want, base)
    jn._apply_side_cuda(got, slots, pay, {}, chunk.valid, chunk.ops, cols)
    jn._apply_side_torch(want, slots, pay, {}, chunk.valid, chunk.ops, cols)
    torch.cuda.synchronize()
    lanes_k, lanes_p = side_lanes(got), side_lanes(want)
    assert_lanes_equal(torch, lanes_k, lanes_p, "L hot slots")
    check(bool(got.overflow) and bool(got.inconsistent), "L hot slots: both latches")
    ins_slots = torch.unique(slots[:half].long())
    check(int(got.row_valid[ins_slots].sum()) == len(ins_slots) * got.fanout,
          "L hot slots: the insert buckets filled")
    err = max_abs_diff(torch, lanes_k, lanes_p)
    setup = lambda: restore_side(got, base)
    ms = time_ms(torch, lambda: jn._apply_side_cuda(got, slots, pay, {}, chunk.valid, chunk.ops,
                                                    cols), 10, setup)
    plain = time_ms(torch, lambda: jn._apply_side_torch(got, slots, pay, {}, chunk.valid,
                                                        chunk.ops, cols), 3, setup)
    return {"ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms(l_bytes(n, n, half, n - half, got.fanout)),
            "max_abs_err": err,
            "shape": {"rows": n, "keys": 8, "inserts": half, "deletes": n - half}}


def kernel_l_regrow(torch, dev, rng, cap: int = 1 << 20, keys: int = 300_000):
    """L's regrow entry against its plain version: a (2^20, 8) side with
    holes in its buckets (every third row of a key deleted) rebuilt to
    2^21 slots; kernel A re-inserts the kept keys once, both versions
    move the entries to the same new slots."""
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import join as jn

    names = ("id", "name", "starttime")
    side, ids, starts, stored_names = q8_left_side(torch, dev, rng, cap, keys)
    apply = lambda c: jn.apply_side(side, (c.col("id"), c.col("starttime")),
                                    {k: c.col(k) for k in names}, {}, c.valid, c.ops, names)
    # two more rows for a third of the keys, then each one's first row
    # deleted: buckets with a hole at position 0
    sub = rng.choice(keys, keys // 3, replace=False)
    for _ in range(2):
        apply(left_chunk(torch, dev, ids[sub], starts[sub], rng.integers(0, 1000, len(sub))))
    apply(left_chunk(torch, dev, ids[sub], starts[sub], stored_names[sub],
                     ops=np.ones(len(sub), np.int32)))
    check(not bool(side.overflow) and not bool(side.inconsistent), "L regrow: side built cleanly")
    new_cap = 2 * cap
    keep = (side.table.live | side.sdirty) & (side.table.fp1 != 0)
    mk = lambda: jn.JoinSide.create(new_cap, side.fanout, (torch.int64, torch.int64),
                                    {k: a.dtype for k, a in side.rows.items()}, device=dev)
    new_k, new_p = mk(), mk()
    _, new_slots, _, _ = ht.lookup_or_insert(new_k.table, side.table.keys, keep)
    lanes = lambda s: [*s.rows.values(), *s.row_nulls.values(), s.degree]
    jn._regrow_entries_cuda(side, new_k, lanes(side), lanes(new_k), keep, new_slots)
    jn._regrow_entries_torch(side, new_p, lanes(side), lanes(new_p), keep, new_slots)
    torch.cuda.synchronize()
    got = {"row_valid": new_k.row_valid, "degree": new_k.degree,
           **{f"rows.{k}": a for k, a in new_k.rows.items()}}
    want = {"row_valid": new_p.row_valid, "degree": new_p.degree,
            **{f"rows.{k}": a for k, a in new_p.rows.items()}}
    assert_lanes_equal(torch, got, want, "L regrow")
    n_entries = int(side.row_valid.sum())
    check(int(new_k.row_valid.sum()) == n_entries, "L regrow: every entry moved")
    check(bool(new_k.row_valid[:, 0][new_slots[keep].long()].all()), "L regrow: holes compacted")
    err = max_abs_diff(torch, got, want)
    ms = time_ms(torch, lambda: jn._regrow_entries_cuda(side, new_k, lanes(side), lanes(new_k),
                                                        keep, new_slots), 10)
    plain = time_ms(torch, lambda: jn._regrow_entries_torch(side, new_p, lanes(side), lanes(new_p),
                                                            keep, new_slots), 3)
    # keep, new_slots and row_valid read over the old table; per entry
    # moved its 24 B of lanes read and written, row_valid written
    nbytes = cap * (1 + 4 + side.fanout) + n_entries * (2 * 24 + 1)
    return {
        "name": "L join regrow (move entry)", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/join_apply.cu",
        "replaces": "risingwave_tpu/ops/join.py:458",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"capacity": cap, "new_capacity": new_cap, "fanout": side.fanout,
                  "entries": n_entries},
    }


M_HARD_CAP = 1 << 12  # slots of M's hard side
M_HARD_ROWS = 3000  # probe rows of its chunks: 12 tiles of the look-back


def m_hard_cases(torch, dev, rng) -> dict:
    """M against its plain version, every output row (the zero rows past
    the last one too), slots, mc, written, the latch and the counter, on a
    small (2^12, 4) side with full buckets, NULL payloads and keys whose
    rows were all deleted: a 3,000-row chunk (hits, misses, invalid rows,
    deletes, an own NULL lane) in each mode (inner pairs, the outer
    arrival's pairs then NULL pads, semi, anti), into an output that holds
    every row with a long zero tail, one that fits exactly, one cut inside
    the pairs and one cut inside group 2; then an empty chunk (n = 0)."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops import join as jn

    fanout = 4
    side = jn.JoinSide.create(M_HARD_CAP, fanout, (torch.int64,),
                              {"k": torch.int64, "v": torch.int32, "f": torch.float64},
                              nullable=("v",), device=dev)
    keys = np.arange(1500, dtype=np.int64)
    per_key = rng.integers(1, fanout + 1, len(keys))  # every fourth key or so: a full bucket
    k = np.repeat(keys, per_key)
    rows = {"k": k, "v": rng.integers(-9, 9, len(k)).astype(np.int32),
            "f": rng.standard_normal(len(k))}
    nulls = {"v": rng.random(len(k)) < 0.3}
    names = ("f", "k", "v")
    for ops_of in (np.zeros, lambda m, dt: np.full(m, 1, dt)):  # insert all; delete keys < 100
        pick = slice(None) if ops_of is np.zeros else k < 100
        c = StreamChunk.from_numpy({n: v[pick] for n, v in rows.items()}, 8192,
                                   ops=ops_of(len(k[pick]), np.int32),
                                   nulls={n: v[pick] for n, v in nulls.items()}, device=dev)
        jn.apply_side(side, (c.col("k"),), {n: c.col(n) for n in names},
                      {"v": c.nulls["v"]}, c.valid, c.ops, names)
    n = M_HARD_ROWS
    pk = rng.integers(0, 2200, n).astype(np.int64)  # stored, deleted (< 100) and absent keys
    chunk = StreamChunk.from_numpy(
        {"pk": pk, "pv": rng.integers(0, 50, n).astype(np.int32)}, n,
        ops=rng.choice(np.array([0, 1, 2, 3], np.int32), n),
        nulls={"pv": rng.random(n) < 0.2}, device=dev)
    valid = chunk.valid & torch.from_numpy(rng.random(n) < 0.9).to(dev)
    own, own_nulls = {"pk": chunk.col("pk"), "pv": chunk.col("pv")}, {"pv": chunk.nulls["pv"]}
    z = lambda d: torch.zeros((), dtype=d, device=dev)
    modes = {"inner": (True, jn.G2_NONE, ("pk", "pv", "k", "v", "f"), ("pv", "v")),
             "outer": (True, jn.G2_OUTER, ("pk", "pv", "k", "v", "f"), ("pv", "k", "v", "f")),
             "semi": (False, jn.G2_SEMI, ("pk", "pv"), ("pv",)),
             "anti": (False, jn.G2_ANTI, ("pk", "pv"), ("pv",))}

    def both(key, vd, cap_out, pairs_on, g2, out_names, null_names):
        res = []
        for fn in (jn._probe_pairs_cuda, jn._probe_pairs_torch):
            em, cnt = z(torch.bool), z(torch.int64)
            pr = fn(side, key, vd, chunk.ops[:vd.shape[0]],
                    {nm: t[:vd.shape[0]] for nm, t in own.items()},
                    {nm: t[:vd.shape[0]] for nm, t in own_nulls.items()}, out_names, null_names,
                    cap_out, em, cnt, pairs_on, g2)
            res.append({**probed_lanes(pr), "em_overflow": em, "join_rows": cnt})
        torch.cuda.synchronize()
        return res

    cases = 0
    for mode, (pairs_on, g2, out_names, null_names) in modes.items():
        full = both((chunk.col("pk"),), valid, 1 << 16, pairs_on, g2, out_names, null_names)
        total = int(full[1]["written"])
        pairs = int(full[1]["mc"].sum()) if pairs_on else 0
        cuts = {"tail": 1 << 16, "exact": total, "in_pairs": pairs // 2,
                "in_group2": pairs + (total - pairs) // 2}
        for cut, cap_out in cuts.items():
            got, want = full if cut == "tail" else both((chunk.col("pk"),), valid, cap_out,
                                                        pairs_on, g2, out_names, null_names)
            assert_lanes_equal(torch, got, want, f"M {mode}, out_cap {cut} ({cap_out})")
            cases += 1
        check(0 < pairs < total if mode == "outer" else total > 0, f"M {mode}: both groups")
        got, want = both((chunk.col("pk")[:0],), valid[:0], 64, pairs_on, g2, out_names,
                         null_names)
        assert_lanes_equal(torch, got, want, f"M {mode}, n = 0")
        cases += 1
    full_buckets = int((side.row_valid.sum(1) == fanout).sum())
    check(full_buckets > 100, f"M: full buckets on the hard side ({full_buckets})")
    return {"hard_cases": cases, "full_buckets": full_buckets}


def kernel_m(torch, dev, rng, side, n: int = A_ROWS, out_cap: int = Q8_OUT_CAP):
    """M against its plain version: an auction chunk probing L's person
    side (about 9,000 hits, a key of 8 rows, absent keys, one DELETE
    row), then the same chunk into a 1,024-row output (em_overflow); M's
    lookup entry alone; then ``m_hard_cases``."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import join as jn

    live_slots = torch.nonzero(side.table.live).flatten()
    n_hit = min(9_000, n // 8)
    pick = live_slots[torch.from_numpy(rng.integers(0, len(live_slots), n_hit)).to(dev)]
    hit_s = side.table.keys[0][pick].cpu().numpy()
    hit_w = side.table.keys[1][pick].cpu().numpy()
    miss = n - len(hit_s) - 1
    sel = np.concatenate([hit_s, [1], rng.integers(10**10, 2 * 10**10, miss)])
    win = np.concatenate([hit_w, [0], np.zeros(miss, np.int64)])
    ops = np.zeros(n, np.int32)
    ops[5] = 1
    chunk = StreamChunk.from_numpy({"astarttime": win, "seller": sel}, n, ops=ops, device=dev)
    key_cols = (chunk.col("seller"), chunk.col("astarttime"))
    own = {k: chunk.col(k) for k in ("astarttime", "seller")}
    out_names = ("id", "name", "starttime", "astarttime", "seller")
    z = lambda d: torch.zeros((), dtype=d, device=dev)
    err = 0.0
    for cap_out in (out_cap, 1024):
        res = []
        for fn in (jn._probe_pairs_cuda, jn._probe_pairs_torch):
            em, rows = z(torch.bool), z(torch.int64)
            pr = fn(side, key_cols, chunk.valid, chunk.ops, own, {}, out_names, (), cap_out, em,
                    rows)
            res.append({**{f"col.{k}": v for k, v in pr.cols.items()}, "ops": pr.ops,
                        "valid": pr.valid, "slots": pr.slots, "mc": pr.mc,
                        "written": pr.written, "em_overflow": em, "join_rows": rows})
        torch.cuda.synchronize()
        assert_lanes_equal(torch, res[0], res[1], f"M (out_cap {cap_out})")
        err = max(err, max_abs_diff(torch, res[0], res[1]))
        check(bool(res[0]["em_overflow"]) == (cap_out == 1024), "M: em_overflow latch")
        if cap_out == out_cap:
            pairs = int(res[0]["join_rows"])
    slots_k, found_k = ht.lookup(side.table, key_cols, chunk.valid)
    slots_p, found_p = ht._lookup_torch(side.table, key_cols, chunk.valid)
    check(torch.equal(slots_k, slots_p) and torch.equal(found_k, found_p), "M: lookup entry")
    em, rows = z(torch.bool), z(torch.int64)
    ms = time_ms(torch, lambda: jn._probe_pairs_cuda(side, key_cols, chunk.valid, chunk.ops, own,
                                                     {}, out_names, (), out_cap, em, rows), 20)
    dev_ms = device_time_ms(torch, lambda: jn._probe_pairs_cuda(
        side, key_cols, chunk.valid, chunk.ops, own, {}, out_names, (), out_cap, em, rows), 5)
    hard = m_hard_cases(torch, dev, rng)
    plain = time_ms(torch, lambda: jn._probe_pairs_torch(side, key_cols, chunk.valid, chunk.ops,
                                                         own, {}, out_names, (), out_cap, em,
                                                         rows), 5)
    _, match = jn._probe_side_torch(side, key_cols, chunk.valid)
    lib = time_ms(torch, lambda: torch.nonzero(match), 10)
    n_found = int(found_k.sum())
    fanout = side.fanout
    # per probe row its key lanes, valid and ops read and one probe (fp1,
    # fp2, both key lanes, live: 25 B); per hit its bucket's row_valid;
    # per pair 20 B of stored lanes read; the out_cap output rows (36 B
    # of lanes, ops, valid) written
    nbytes = n * (16 + 1 + 4 + 25) + n_found * fanout + pairs * 20 + out_cap * (36 + 4 + 1)
    return {
        "name": "M join probe + pairs", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/join_probe.cu",
        "replaces": "risingwave_tpu/ops/join.py:407,420,429 (with ops/hash_table.py:232)",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": lib,
        "library_call": "torch.nonzero of the (n, fanout) match mask, the compaction alone",
        "shape": {"probe_rows": n, "capacity": side.capacity, "fanout": fanout,
                  "found": n_found, "pairs": pairs, "out_cap": out_cap, **hard},
    }


def kernel_h_join(torch, dev, join):
    """H with its per-entry mask on q8's two join sides (the fused
    program's two join digests): kernel, plain version and numpy
    host_digest equal, and the survivor count taken in the same pass
    equal to a torch reduction."""
    from risingwave_tpu_torch import integrity

    sides = [integrity.join_side_lanes(s) for s in (join.left, join.right)]
    worst = 0.0
    for what, side, (lanes, live) in zip(("left", "right"), (join.left, join.right), sides):
        got = integrity.digest_from_scalar(integrity.device_digest(lanes, live))
        plain = integrity.digest_from_scalar(integrity._device_digest_torch(
            lanes, sorted(lanes), integrity._masks(live)))
        host = integrity.host_digest(*integrity.host_lanes(lanes, live))
        check(got == plain == host, f"H join {what}: kernel {got:x}, plain {plain:x}, numpy {host:x}")
        worst = max(worst, float(abs(got - plain)), float(abs(got - host)))
        dig, surv = integrity.digest_with_survivors(lanes, live, side.sdirty)
        check(integrity.digest_from_scalar(dig) == got, f"H join {what}: digest with survivors")
        check(int(surv) == int((side.table.live | side.sdirty).sum()), f"H join {what}: survivors")

    def both(fn):
        for lanes, live in sides:
            fn(lanes, live)

    ms = time_ms(torch, lambda: both(integrity.device_digest), 10)
    plain = time_ms(torch, lambda: both(lambda la, li: integrity._device_digest_torch(
        la, sorted(la), integrity._masks(li))), 3)
    nbytes = sum(digest_bytes(side) for side in sides)
    return {
        "name": "H state digest, join sides (entry mask)", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/state_digest.cu",
        "replaces": "risingwave_tpu/integrity.py:329 over integrity.py:426",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"capacity": join.left.capacity, "fanout": join.left.fanout,
                  "calls": "both join sides (two of a barrier's five digests)",
                  "bytes": nbytes},
    }


# -- phases 7 and 8: q8 ---------------------------------------------------------
def q8_stream(torch, dev, epochs: int):
    """bench.py's q8 stream: per epoch, 1M events generated in
    65,536-event pieces and batched into one person chunk (id, name,
    date_time) and one auction chunk (seller, date_time), chunk
    capacities the next power of two of the largest epoch's rows."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=EVENT_RATE), seed=SEED)
    host = []
    for _ in range(epochs):
        p_parts, a_parts, done = [], [], 0
        while done < EVENTS_PER_EPOCH:
            n = min(CHUNK_EVENTS, EVENTS_PER_EPOCH - done)
            done += n
            ev = gen.next_events(n)
            p_parts.append(ev["person"])
            a_parts.append(ev["auction"])
        cat = lambda parts, ks: {k: np.concatenate([p[k] for p in parts]) for k in ks}
        host.append((cat(p_parts, ("id", "name", "date_time")),
                     cat(a_parts, ("seller", "date_time"))))
    pow2 = lambda m: 1 << (max(m, 64) - 1).bit_length()
    p_cap = pow2(max(len(p["id"]) for p, _ in host))
    a_cap = pow2(max(len(a["seller"]) for _, a in host))
    chunks = [(StreamChunk.from_numpy(p, p_cap, device=dev), StreamChunk.from_numpy(a, a_cap, device=dev))
              for p, a in host]
    return host, chunks, (p_cap, a_cap)


def cpu_actor_q8(host, window_ms: int) -> dict:
    """The repo benchmark's single-threaded q8 actor (bench.py:50): per
    side a tumble and a dedup dict, each new key probing the other
    side's seen-set. Returns {(id, starttime): name}."""
    pseen, aseen, out = {}, set(), {}
    for p, a in host:
        ws = (p["date_time"] // window_ms) * window_ms
        for i, w, nm in zip(p["id"].tolist(), ws.tolist(), p["name"].tolist()):
            k = (i, w)
            if k not in pseen:
                pseen[k] = nm
                if k in aseen:
                    out[k] = nm
        ws = (a["date_time"] // window_ms) * window_ms
        for s, w in zip(a["seller"].tolist(), ws.tolist()):
            k = (s, w)
            if k not in aseen:
                aseen.add(k)
                if k in pseen:
                    out[k] = pseen[k]
    return out


def q8_mv_rows(mview) -> np.ndarray:
    got = mview.to_numpy()
    rows = np.stack([got["id"], got["starttime"], got["name"].astype(np.int64)], 1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def oracle_rows(oracle: dict) -> np.ndarray:
    rows = np.array([(k[0], k[1], v) for k, v in oracle.items()], np.int64).reshape(-1, 3)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def q8_digests(q8) -> dict:
    """numpy host_digest of each of q8's five states, read back."""
    from risingwave_tpu_torch import integrity

    left, right = q8.pipeline.left[1], q8.pipeline.right[1]
    jl, jr = q8.join.side_digests()
    return {
        "left": integrity.host_digest(*integrity.host_lanes(*left.digest_lanes())),
        "right": integrity.host_digest(*integrity.host_lanes(*right.digest_lanes())),
        "join_left": jl, "join_right": jr,
        "mv": integrity.host_digest(*integrity.host_lanes(
            *integrity.mv_lanes(q8.mview.table, q8.mview.state))),
    }


def run_q8(torch, dev, chunks, fused: bool):
    """q8 over the chunks (person chunk pushed left, then the auction
    chunk right, then a barrier), timed; returns the query, the barrier
    times, the run's seconds, launches and peak bytes."""
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.queries.nexmark_q import build_q8
    from risingwave_tpu_torch.runtime.fused_step import FusedTwoInputExecutor, fuse_pipeline

    q8 = build_q8(capacity=Q8_CAP, fanout=Q8_FANOUT, out_cap=Q8_OUT_CAP, device=dev)
    if fused:
        wrappers = fuse_pipeline(q8.pipeline, label="q8")
        check(len(wrappers) == 1 and isinstance(wrappers[0], FusedTwoInputExecutor),
              "q8 fused: one FusedTwoInputExecutor")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    barrier_ms = []
    t_run = time.perf_counter()
    for p, a in chunks:
        q8.pipeline.push_left(p)
        q8.pipeline.push_right(a)
        tb = time.perf_counter()
        q8.pipeline.barrier()
        torch.cuda.synchronize()
        barrier_ms.append((time.perf_counter() - tb) * 1e3)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    return q8, barrier_ms, run_s, dict(_kernels.LAUNCHES), torch.cuda.max_memory_allocated()


Q8_KERNELS = ("lookup_or_insert", "mv_upsert", "hop_expand", "dedup_emit", "join_apply",
              "join_probe")


def q8_row(phase, host, chunks, caps, q8, barrier_ms, run_s, launches, peak) -> dict:
    rows = sum(len(p["id"]) + len(a["seller"]) for p, a in host)
    return {
        "phase": phase, "epochs": len(chunks), "events": len(chunks) * EVENTS_PER_EPOCH,
        "persons": sum(len(p["id"]) for p, _ in host),
        "auctions": sum(len(a["seller"]) for _, a in host),
        "chunk_capacity": {"person": caps[0], "auction": caps[1]},
        "rows_per_s": rows / run_s, "run_s": run_s,
        "barrier_ms_p50": float(np.percentile(barrier_ms, 50)),
        "barrier_ms_p99": float(np.percentile(barrier_ms, 99)),
        "barrier_ms": barrier_ms,
        "capacity": {"join_left": q8.join.left.capacity, "join_right": q8.join.right.capacity,
                     "dedup_left": q8.pipeline.left[1].table.capacity,
                     "dedup_right": q8.pipeline.right[1].table.capacity,
                     "mv": q8.mview.table.capacity},
        "max_memory_allocated": int(peak), "launches": launches,
    }


def q8_path(torch, dev, epochs: int):
    """Phase 7: q8 interpreted (chunk by chunk through the chains, the
    join and the MV), its final MV against the q8 actor of bench.py."""
    from risingwave_tpu_torch.queries.nexmark_q import Q8_WINDOW_MS

    t0 = time.perf_counter()
    host, chunks, caps = q8_stream(torch, dev, epochs)
    oracle = oracle_rows(cpu_actor_q8(host, Q8_WINDOW_MS))
    setup_s = time.perf_counter() - t0
    q8, barrier_ms, run_s, launches, peak = run_q8(torch, dev, chunks, fused=False)
    got = q8_mv_rows(q8.mview)
    check(got.shape == oracle.shape and np.array_equal(got, oracle),
          f"q8: MV ({len(got)} rows) vs the q8 actor ({len(oracle)} rows)")
    for name in Q8_KERNELS:
        check(launches[name] > 0, f"kernel {name} launched on q8's interpreted path")
    row = q8_row("q8", host, chunks, caps, q8, barrier_ms, run_s, launches, peak)
    row.update(setup_s=setup_s, mv_rows=int(len(got)),
               oracle="bench.py's cpu_actor_q8 (copied): equal")
    return row, launches, (host, chunks, caps, q8, oracle)


def q8_fused_path(torch, dev, host, chunks, caps, interp_q8, oracle):
    """Phase 8: q8 through ``fuse_pipeline``: one program per barrier
    (per side E, A, J, M, A, L, then A, D into the MV; then five H),
    each run under ``no_device_reads``."""
    check_sync_guard(torch, dev)
    q8, barrier_ms, run_s, launches, peak = run_q8(torch, dev, chunks, fused=True)
    w = q8.pipeline._fused
    got = q8_mv_rows(q8.mview)
    check(np.array_equal(got, oracle), "q8 fused: MV vs the q8 actor")
    check(np.array_equal(got, q8_mv_rows(interp_q8.mview)), "q8 fused: MV vs phase 7's MV")
    lane_digests = q8_digests(q8)
    check(w.last_digests == lane_digests,
          f"q8 fused: staged digests {w.last_digests} vs host_digest {lane_digests}")
    check(lane_digests == q8_digests(interp_q8), "q8 fused: digests vs phase 7's state")
    for name in Q8_KERNELS + ("state_digest",):
        check(launches[name] > 0, f"kernel {name} launched on q8's fused path")
    tel = w.last_telemetry
    p_last, a_last = host[-1]
    check(tel["rows_left"] == len(p_last["id"]) and tel["rows_right"] == len(a_last["seller"]),
          "q8 fused: rows_left / rows_right = the last epoch's persons / auctions")
    check(tel["join_rows"] == tel["mv_rows"], "q8 fused: every join row reached the MV")
    row = q8_row("q8_fused", host, chunks, caps, q8, barrier_ms, run_s, launches, peak)
    row.update(
        mv_rows=int(len(got)), last_telemetry=tel,
        digests={k: f"{v:016x}" for k, v in lane_digests.items()},
        sync_guard="set_sync_debug_mode('error') over the program part of every barrier: held",
        oracle="q8 actor and phase 7's MV: equal; staged digests = host_digest of the lanes "
               "read back = host_digest of phase 7's state",
    )
    return row, launches, q8


# -- phase 3, q7's kernels (N, O) -------------------------------------------------
def kernel_n(torch, dev, rng, n: int, cap: int = Q7_CAP, prefill: int = 50_000):
    """N against its plain version: an ``n``-row bid chunk after A on a
    2^22-slot filter table holding ``prefill`` windows with running
    maxes (a tenth of them tombstoned by an expiry), every other slot's
    max stale garbage. The chunk mixes live windows (prices around their
    max, ties included), expired windows (their slots found again with
    neither found nor inserted), new windows (about three rows each),
    a few DELETE rows and padding. Every lane equal, latches included."""
    import dataclasses

    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import dynamic_filter as df
    from risingwave_tpu_torch.ops import hash_table as ht

    table = ht.HashTable.create(cap, (torch.int64,), device=dev)
    wins = (rng.permutation(prefill).astype(np.int64) + 10) * 10_000
    valid_all = torch.ones(prefill, dtype=torch.bool, device=dev)
    _, pslots, _, _ = ht.lookup_or_insert(table, (torch.from_numpy(wins).to(dev),), valid_all)
    check(bool((pslots >= 0).all()), "N: prefill found slots")
    maxes = torch.from_numpy(rng.integers(0, 10**6, cap)).to(dev)  # stale everywhere
    pmax = rng.integers(1_000, 100_000, prefill)
    maxes[pslots.long()] = torch.from_numpy(pmax).to(dev)
    table.live[pslots.long()] = True
    dead = rng.random(prefill) < 0.1
    table.live[pslots[torch.from_numpy(dead).to(dev)].long()] = False
    sdirty = torch.from_numpy(rng.random(cap) < 0.01).to(dev)
    m = n - 500  # the rest is padding
    k_live, k_dead = m // 2, m // 10
    k_new = m - k_live - k_dead
    live_i = rng.choice(np.flatnonzero(~dead), k_live)
    dead_i = rng.choice(np.flatnonzero(dead), k_dead)
    pool = (rng.permutation(k_new // 3 + 1).astype(np.int64) + 10 * prefill + 10) * 10_000
    w = np.concatenate([wins[live_i], wins[dead_i], pool[rng.integers(0, len(pool), k_new)]])
    base_p = np.concatenate([pmax[live_i], pmax[dead_i], rng.integers(1_000, 100_000, k_new)])
    p = base_p + rng.integers(-2, 3, m) * (rng.random(m) < 0.5)  # ties at the max
    order = rng.permutation(m)
    ops = np.where(rng.random(m) < 0.001, 1, 0).astype(np.int32)
    chunk = StreamChunk.from_numpy({"wstart": w[order], "price": p[order]}, n, ops=ops,
                                   device=dev)
    signs = chunk.effective_signs()
    valid = chunk.valid & (signs > 0)
    value = chunk.col("price")
    _, slots, found, inserted = ht.lookup_or_insert(table, (chunk.col("wstart"),), valid)
    latches = lambda: (torch.zeros((), dtype=torch.bool, device=dev),
                       torch.zeros((), dtype=torch.bool, device=dev))
    outs = []
    for fn in ("cuda", "torch"):
        t = dataclasses.replace(table, live=table.live.clone())
        mx, sd, lat = maxes.clone(), sdirty.clone(), latches()
        if fn == "cuda":
            ok = df._filter_cuda(t, mx, sd, chunk, value, slots, inserted, lat)
        else:
            ok = df._filter_torch(t, mx, sd, chunk, value, signs, valid, slots, inserted, lat)
        outs.append({"ok": ok, "maxes": mx, "sdirty": sd, "live": t.live,
                     "saw_delete": lat[0], "dropped": lat[1]})
    torch.cuda.synchronize()
    assert_lanes_equal(torch, outs[0], outs[1], "N")
    check(bool(outs[0]["saw_delete"]) and not bool(outs[0]["dropped"]), "N: latches")
    hit = valid & (slots >= 0)
    pre = maxes[slots.clamp(min=0).long()]
    reused = hit & ~found & ~inserted
    check(int(reused.sum()) > 0 and not bool(outs[0]["live"][slots[reused].long()].any()),
          "N: expired windows found again stay dead")
    ties = int((outs[0]["ok"] & hit & ~inserted & (value == pre)).sum())
    check(ties > 0, "N: ties at the running max pass")
    new_slots = torch.unique(slots[inserted].long())
    fresh = torch.full_like(maxes, np.iinfo(np.int64).min).scatter_reduce_(
        0, slots[inserted].long(), value[inserted], reduce="amax")
    check(torch.equal(outs[0]["maxes"][new_slots], fresh[new_slots]),
          "N: a new slot's stale max is reset before the fold")
    err = max_abs_diff(torch, outs[0], outs[1])
    t = dataclasses.replace(table, live=table.live.clone())
    mx, sd, lat = maxes.clone(), sdirty.clone(), latches()

    def setup():
        mx.copy_(maxes)
        sd.copy_(sdirty)
        t.live.copy_(table.live)

    ms = time_ms(torch, lambda: df._filter_cuda(t, mx, sd, chunk, value, slots, inserted, lat),
                 20, setup)
    plain = time_ms(torch, lambda: df._filter_torch(t, mx, sd, chunk, value, signs, valid, slots,
                                                    inserted, lat), 5, setup)
    idx, vals = slots[hit].long(), value[hit]
    lib = time_ms(torch, lambda: mx.scatter_reduce_(0, idx, vals, reduce="amax"), 20, setup)
    touched = int(torch.unique(idx).numel())
    n_new = int(new_slots.numel())
    # valid, ops, slots, inserted, value read and ok written per row
    # (19 B); per touched slot its max read and written and sdirty
    # written, per new slot live written: a 32-byte sector each
    nbytes = n * 19 + touched * 3 * 32 + n_new * 32
    return {
        "name": "N dynamic filter", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/dyn_filter.cu",
        "replaces": "risingwave_tpu/executors/dynamic_filter.py:56",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lib,
        "library_call": "scatter_reduce_(..., 'amax') of the fold alone",
        "shape": {"rows": n, "capacity": cap, "windows": prefill, "touched_slots": touched,
                  "new_slots": n_new, "expired_rows": int(reused.sum()), "ties": ties},
    }


def o_fill(torch, dev, rng, table, n_live: int, cutoff: int):
    """Claim ``n_live`` random slots of ``table`` (the O pass reads only
    live and the key lane), their window keys half below ``cutoff``;
    returns the slots."""
    slots = torch.from_numpy(rng.choice(table.capacity, n_live, replace=False)).to(dev)
    below = rng.random(n_live) < 0.5
    keys = np.where(below, cutoff - 10_000 * rng.integers(1, 50, n_live),
                    cutoff + 10_000 * rng.integers(0, 50, n_live))
    table.fp1[slots] = 1
    table.keys[0][slots] = torch.from_numpy(keys).to(dev)
    table.live[slots] = True
    return slots


def o_time(torch, fns, setup):
    """The kernel's and the plain version's ms (each pass restores the
    lanes first)."""
    return time_ms(torch, fns[0], 20, setup), time_ms(torch, fns[1], 5, setup)


def o_bytes(cap: int, n_live: int, n_exp: int, per_expired: int) -> int:
    """Kernel O's bytes: the live lane read over the table, each live
    slot's key read (a 32-byte sector), per expired slot ``per_expired``
    bytes of sectors written."""
    return cap + n_live * 32 + n_exp * per_expired


def kernel_o(torch, dev, rng, cap: int = Q7_CAP, n_live: int = 200_000):
    """O against its plain version on each state kind at q7's sizes,
    about half the live keys below the cutoff: a 2^22-slot filter table
    (the dedup's entry too), a (2^22, 16) join side of q7's bid schema,
    and a 2^22-slot HashAgg with q7's MAX in both modes; plus a 2^16-slot
    agg over every agg kind (float MIN/MAX in order-key form) in both
    modes. Every lane equal. Returns one row per entry."""
    import dataclasses

    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import join as jn

    cutoff = 1_436_918_400_000 + 500 * 10_000
    rows = []

    # the filter / dedup key table
    table = ht.HashTable.create(cap, (torch.int64,), device=dev)
    o_fill(torch, dev, rng, table, n_live, cutoff)
    sdirty0 = torch.from_numpy(rng.random(cap) < 0.01).to(dev)
    live0 = table.live.clone()
    got = dataclasses.replace(table, live=live0.clone())
    want = dataclasses.replace(table, live=live0.clone())
    sd_k, sd_p = sdirty0.clone(), sdirty0.clone()
    ht._expire_table_cuda(got, sd_k, 0, cutoff)
    ht._expire_table_torch(want, sd_p, 0, cutoff)
    torch.cuda.synchronize()
    a, b = {"live": got.live, "sdirty": sd_k}, {"live": want.live, "sdirty": sd_p}
    assert_lanes_equal(torch, a, b, "O keys")
    n_exp = int((live0 & ~got.live).sum())
    check(0.4 * n_live < n_exp < 0.6 * n_live, "O keys: about half the live keys expired")

    def setup_k():
        got.live.copy_(live0)
        sd_k.copy_(sdirty0)

    ms, plain = o_time(torch, (lambda: ht._expire_table_cuda(got, sd_k, 0, cutoff),
                               lambda: ht._expire_table_torch(got, sd_k, 0, cutoff)), setup_k)
    rows.append({
        "name": "O expire (filter / dedup)", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/expire.cu",
        "replaces": "risingwave_tpu/executors/dynamic_filter.py:329, executors/dedup.py:284",
        "max_abs_err": max_abs_diff(torch, a, b), "ms": ms, "plain_ms": plain,
        "bound_ms": bound_ms(o_bytes(cap, n_live, n_exp, 2 * 32)), "bound_by": "bytes",
        "library_ms": None,
        "shape": {"capacity": cap, "live": n_live, "expired": n_exp},
    })
    del table, got, want, live0, sdirty0, sd_k, sd_p

    # a join side of q7's bid schema
    side = jn.JoinSide.create(cap, Q7_FANOUT, (torch.int64, torch.int64),
                              {k: torch.int64 for k in ("wstart", "price", "auction", "bidder")},
                              device=dev)
    slots = o_fill(torch, dev, rng, side.table, n_live, cutoff)
    fill = torch.from_numpy(rng.random((n_live, Q7_FANOUT)) < 0.3).to(dev)
    side.row_valid[slots] = fill
    side.degree[slots] = torch.from_numpy(rng.integers(0, 3, (n_live, Q7_FANOUT))
                                          .astype(np.int32)).to(dev)
    for lane in side.rows.values():
        lane[slots] = torch.from_numpy(rng.integers(0, 10**6, (n_live, Q7_FANOUT))).to(dev)
    base = {k: getattr(side, k).clone() for k in ("sdirty", "row_valid", "degree")}
    base_live = side.table.live.clone()

    def twin():
        t = dataclasses.replace(side.table, live=base_live.clone())
        return dataclasses.replace(side, table=t, **{k: v.clone() for k, v in base.items()})

    got, want = twin(), twin()
    jn._expire_keys_cuda(got, 0, cutoff)
    jn._expire_keys_torch(want, 0, cutoff)
    torch.cuda.synchronize()
    lanes = lambda s: {"live": s.table.live, "sdirty": s.sdirty, "row_valid": s.row_valid,
                       "degree": s.degree}
    assert_lanes_equal(torch, lanes(got), lanes(want), "O join side")
    digs = [integrity.digest_from_scalar(integrity.device_digest(*integrity.join_side_lanes(s)))
            for s in (got, want)]
    check(digs[0] == digs[1], "O join side: digests")
    n_exp = int((base_live & ~got.table.live).sum())
    check(0.4 * n_live < n_exp < 0.6 * n_live, "O join side: about half the live keys expired")

    def setup_j():
        got.table.live.copy_(base_live)
        for k, v in base.items():
            getattr(got, k).copy_(v)

    ms, plain = o_time(torch, (lambda: jn._expire_keys_cuda(got, 0, cutoff),
                               lambda: jn._expire_keys_torch(got, 0, cutoff)), setup_j)
    rows.append({
        "name": "O expire (join side)", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/expire.cu",
        "replaces": "risingwave_tpu/ops/join.py:508",
        "max_abs_err": max_abs_diff(torch, lanes(got), lanes(want)), "ms": ms, "plain_ms": plain,
        # per expired slot live, sdirty, its 16 row_valid and 16 degree entries
        "bound_ms": bound_ms(o_bytes(cap, n_live, n_exp, 2 * 32 + 32 + 64)),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"capacity": cap, "fanout": Q7_FANOUT, "live": n_live, "expired": n_exp},
    })
    del side, got, want, base, base_live

    # HashAgg tables: q7's MAX at 2^22, every kind at 2^16, both modes
    agg_row = None
    for acap, calls, dtypes in (
        (cap, (agg_ops.AggCall("max", "price", "maxprice"),), {"price": torch.int64}),
        (1 << 16, (agg_ops.AggCall("count_star", None, "n"), agg_ops.AggCall("sum", "f", "sf"),
                   agg_ops.AggCall("min", "g", "mng"), agg_ops.AggCall("max", "f", "mxf"),
                   agg_ops.AggCall("max", "i", "mxi")),
         {"f": torch.float64, "g": torch.float32, "i": torch.int32}),
    ):
        fx = agg_ops.float_extreme_meta(calls, dtypes)
        table = ht.HashTable.create(acap, (torch.int64,), device=dev)
        k_live = min(n_live, acap // 4)
        aslots = o_fill(torch, dev, rng, table, k_live, cutoff)
        state = agg_ops.create_state(acap, calls, dtypes, dev)
        rnd = lambda dt: torch.from_numpy(rng.integers(-1000, 1000, k_live)).to(dev).to(dt)
        for lane in (state.row_count, *state.accums.values(), *state.nonnull.values(),
                     *state.emitted.values()):
            lane[aslots] = rnd(lane.dtype)
        for lane in (state.dirty, state.emitted_valid, state.sdirty):
            lane[aslots] = torch.from_numpy(rng.random(k_live) < 0.5).to(dev)
        base_st = state_lanes(state)
        base_live = table.live.clone()
        for mark_dirty in (False, True):
            twins = []
            for _ in range(2):
                st = agg_ops.AggState(**{
                    f: ({k: v.clone() for k, v in getattr(state, f).items()}
                        if isinstance(getattr(state, f), dict) else getattr(state, f).clone())
                    for f in vars(state)
                })
                twins.append((dataclasses.replace(table, live=base_live.clone()), st))
            (tk, sk), (tp, sp) = twins
            agg_ops._expire_groups_cuda(tk, sk, calls, 0, cutoff, mark_dirty, fx)
            agg_ops._expire_groups_torch(tp, sp, calls, 0, cutoff, mark_dirty, fx)
            torch.cuda.synchronize()
            a = {"live": tk.live, **state_lanes(sk)}
            b = {"live": tp.live, **state_lanes(sp)}
            what = f"O agg ({len(calls)} calls, mark_dirty={mark_dirty})"
            assert_lanes_equal(torch, a, b, what)
            digs = [integrity.digest_from_scalar(integrity.device_digest(
                *integrity.agg_lanes(t, s, fx))) for t, s in ((tk, sk), (tp, sp))]
            check(digs[0] == digs[1], f"{what}: digests")
            n_exp = int((base_live & ~tk.live).sum())
            check(0.4 * k_live < n_exp < 0.6 * k_live, f"{what}: about half expired")
            if acap == cap and mark_dirty is False:
                def setup_a():
                    tk.live.copy_(base_live)
                    for k, v in state_lanes(sk).items():
                        v.copy_(base_st[k])

                ms, plain = o_time(
                    torch, (lambda: agg_ops._expire_groups_cuda(tk, sk, calls, 0, cutoff, False,
                                                                fx),
                            lambda: agg_ops._expire_groups_torch(tk, sk, calls, 0, cutoff, False,
                                                                 fx)), setup_a)
                # per expired slot live, row_count, sdirty, dirty,
                # emitted_valid and each accumulator / non-null lane
                per = 32 * (5 + len(state.accums) + len(state.nonnull))
                agg_row = {
                    "name": "O expire (agg)", "route": "cuda",
                    "source": "risingwave_tpu_torch/csrc/expire.cu",
                    "replaces": "risingwave_tpu/executors/hash_agg.py:393 "
                                "(with ops/agg.py:533)",
                    "max_abs_err": max_abs_diff(torch, a, b), "ms": ms, "plain_ms": plain,
                    "bound_ms": bound_ms(o_bytes(acap, k_live, n_exp, per)),
                    "bound_by": "bytes", "library_ms": None,
                    "shape": {"capacity": acap, "calls": len(calls), "live": k_live,
                              "expired": n_exp, "mode": "forget_groups"},
                }
            else:
                agg_row.setdefault("also_equal", []).append(
                    {"capacity": acap, "calls": len(calls), "mark_dirty": mark_dirty,
                     "max_abs_err": max_abs_diff(torch, a, b)})
        del table, state, base_st, base_live, twins
    rows.append(agg_row)
    return rows


# -- phases 9 and 10: q7 ---------------------------------------------------------
def q7_stream(torch, dev, epochs: int):
    """bench_q7's stream: per epoch 1M events generated in 8,192-event
    pieces, each piece's bids one chunk of 8,192 rows (auction, bidder,
    price, date_time). Returns the host columns per epoch and the chunks
    on the card."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=EVENT_RATE), seed=SEED)
    host, chunks = [], []
    for _ in range(epochs):
        h_ep, c_ep, done = [], [], 0
        while done < EVENTS_PER_EPOCH:
            n = min(Q7_CHUNK_EVENTS, EVENTS_PER_EPOCH - done)
            done += n
            b = gen.next_events(n)["bid"]
            if len(b["auction"]):
                cols = {k: b[k] for k in Q7_COLS}
                h_ep.append(cols)
                c_ep.append(StreamChunk.from_numpy(cols, Q7_CHUNK_EVENTS, device=dev))
        host.append(h_ep)
        chunks.append(c_ep)
    return host, chunks


def cpu_actor_q7(chunks, window_ms: int) -> dict:
    """The repo benchmark's single-threaded q7 actor (bench.py:562):
    bids at or above their window's running max are kept; the answer is
    every kept bid at its window's final max. Returns
    {(wstart, auction, bidder): (price,)}."""
    wmax, bids_at = {}, {}
    for cols in chunks:
        ws = (cols["date_time"] // window_ms) * window_ms
        for a, b, p, w in zip(cols["auction"].tolist(), cols["bidder"].tolist(),
                              cols["price"].tolist(), ws.tolist()):
            cur = wmax.get(w, -1)
            if p >= cur:
                bids_at.setdefault((w, p), []).append((a, b))
                if p > cur:
                    wmax[w] = p
    return {(w, a, b): (p,) for w, p in wmax.items() for (a, b) in bids_at.get((w, p), ())}


def q7_oracle_rows(chunks, window_ms: int) -> np.ndarray:
    """``cpu_actor_q7`` vectorized: per window the maximum price, and
    every bid at it (a bid equal to the final max always passed the
    running-max test), as sorted unique (wstart, auction, bidder, price)
    rows."""
    cat = {k: np.concatenate([c[k] for c in chunks]) for k in Q7_COLS}
    ws = (cat["date_time"] // window_ms) * window_ms
    uw, inv = np.unique(ws, return_inverse=True)
    mx = np.full(len(uw), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, cat["price"])
    at = cat["price"] == mx[inv]
    rows = np.stack([ws[at], cat["auction"][at], cat["bidder"][at], cat["price"][at]], 1)
    return np.unique(rows, axis=0)


def actor_rows(out: dict) -> np.ndarray:
    rows = np.array([(*k, v[0]) for k, v in out.items()], np.int64).reshape(-1, 4)
    return rows[np.lexsort(rows.T[::-1])]


def q7_mv_rows(mview) -> np.ndarray:
    got = mview.to_numpy()
    rows = np.stack([got["wstart"], got["auction"], got["bidder"], got["price"]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def q7_digests(q7) -> dict:
    """numpy host_digest of each of q7's five states, read back."""
    from risingwave_tpu_torch import integrity

    host = lambda lanes_live: integrity.host_digest(*integrity.host_lanes(*lanes_live))
    jl, jr = q7.join.side_digests()
    return {
        "left": host(q7.pipeline.left[1].digest_lanes()),
        "right": host(integrity.agg_lanes(q7.agg.table, q7.agg.state, q7.agg._float_extremes)),
        "join_left": jl, "join_right": jr,
        "mv": host(integrity.mv_lanes(q7.mview.table, q7.mview.state)),
    }


def run_q7(torch, dev, host, chunks, fused: bool):
    """q7 over the chunks (each pushed left, then right), a barrier per
    epoch, then ``watermark("date_time", max event time so far)``. The
    barriers, the watermarks and the run are timed (the host reads after
    each barrier that keep the MV snapshot and, after the last barrier,
    the five digests are not). Returns the query and a record."""
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.queries.nexmark_q import build_q7
    from risingwave_tpu_torch.runtime.fused_step import FusedTwoInputExecutor, fuse_pipeline

    q7 = build_q7(capacity=Q7_CAP, fanout=Q7_FANOUT, out_cap=Q7_OUT_CAP, agg_capacity=Q7_CAP,
                  filter_capacity=Q7_CAP, device=dev)
    if fused:
        wrappers = fuse_pipeline(q7.pipeline, label="q7")
        check(len(wrappers) == 1 and isinstance(wrappers[0], FusedTwoInputExecutor),
              "q7 fused: one FusedTwoInputExecutor")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    rec = {"barrier_ms": [], "watermark_ms": [], "barrier_launches": [], "flush_rounds": [],
           "snapshots": []}
    run_s, max_ts = 0.0, 0
    for e, (h_ep, c_ep) in enumerate(zip(host, chunks)):
        t0 = time.perf_counter()
        for c in c_ep:
            q7.pipeline.push_left(c)
            q7.pipeline.push_right(c)
        before = dict(_kernels.LAUNCHES)
        tb = time.perf_counter()
        q7.pipeline.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec["barrier_ms"].append((t1 - tb) * 1e3)
        rec["barrier_launches"].append(sum(_kernels.LAUNCHES.values()) - sum(before.values()))
        rec["flush_rounds"].append(_kernels.LAUNCHES["agg_flush"] - before["agg_flush"])
        run_s += t1 - t0
        if e == len(chunks) - 1:
            rec["digests_before_last_watermark"] = q7_digests(q7)
        max_ts = max(max_ts, max(int(c["date_time"].max()) for c in h_ep))
        tw = time.perf_counter()
        q7.pipeline.watermark("date_time", max_ts)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec["watermark_ms"].append((t2 - tw) * 1e3)
        run_s += t2 - tw
        rec["snapshots"].append(q7_mv_rows(q7.mview))
    rec.update(run_s=run_s, launches=dict(_kernels.LAUNCHES),
               peak=torch.cuda.max_memory_allocated(), max_ts=max_ts)
    return q7, rec


Q7_KERNELS = ("lookup_or_insert", "mv_upsert", "hop_expand", "join_apply", "join_probe",
              "agg_flush", "dyn_filter", "expire", "expire_join", "expire_agg")


def q7_checks(torch, q7, rec, oracle, what: str, n_chunks: int, epochs: int) -> None:
    """Every q7 run: the final MV equals the oracle, N ran on every
    filter step and O on every expiry, and after the last watermark
    every live key of the join's left side lies at or after the
    cutoff."""
    from risingwave_tpu_torch.queries.nexmark_q import Q7_WINDOW_MS

    got = rec["snapshots"][-1]
    check(got.shape == oracle.shape and np.array_equal(got, oracle),
          f"{what}: MV ({len(got)} rows) vs the q7 actor ({len(oracle)} rows)")
    launches = rec["launches"]
    for name in Q7_KERNELS:
        check(launches[name] > 0, f"kernel {name} launched on {what}'s path")
    check(launches["dyn_filter"] == n_chunks, f"{what}: N once per filter step")
    check((launches["expire"], launches["expire_join"], launches["expire_agg"])
          == (epochs, 2 * epochs, epochs), f"{what}: O once per expiry (filter, join sides, agg)")
    cutoff = rec["max_ts"] // Q7_WINDOW_MS * Q7_WINDOW_MS  # the hop's window watermark
    for name, table in (("join left", q7.join.left.table), ("join right", q7.join.right.table),
                        ("filter", q7.pipeline.left[1].table), ("agg", q7.agg.table)):
        live = table.live
        check(bool(live.any()), f"{what}: {name} keeps the open windows")
        check(bool((table.keys[0][live] >= cutoff).all()),
              f"{what}: {name} holds no key below the last watermark")


def q7_row(phase, host, q7, rec) -> dict:
    bids = sum(len(c["auction"]) for ep in host for c in ep)
    return {
        "phase": phase, "epochs": len(host), "events": len(host) * EVENTS_PER_EPOCH,
        "bids": bids, "chunks": sum(len(ep) for ep in host), "chunk_capacity": Q7_CHUNK_EVENTS,
        "bids_per_s": bids / rec["run_s"], "run_s": rec["run_s"],
        "barrier_ms_p50": float(np.percentile(rec["barrier_ms"], 50)),
        "barrier_ms_p99": float(np.percentile(rec["barrier_ms"], 99)),
        "barrier_ms": rec["barrier_ms"], "watermark_ms": rec["watermark_ms"],
        "watermark_ms_p50": float(np.percentile(rec["watermark_ms"], 50)),
        "launches_per_barrier": rec["barrier_launches"],
        "flush_rounds_per_barrier": rec["flush_rounds"],
        "expiry_passes": sum(rec["launches"][k] for k in ("expire", "expire_join", "expire_agg")),
        "capacity": {"filter": q7.pipeline.left[1].table.capacity,
                     "agg": q7.agg.table.capacity, "join_left": q7.join.left.capacity,
                     "join_right": q7.join.right.capacity, "mv": q7.mview.table.capacity},
        "fanout": q7.join.left.fanout, "out_cap": q7.join.out_cap,
        "mv_rows": int(len(rec["snapshots"][-1])),
        "max_memory_allocated": int(rec["peak"]), "launches": rec["launches"],
    }


def q7_path(torch, dev, epochs: int):
    """Phase 9: q7 interpreted at bench_q7's sizes, a watermark after
    every barrier, its final MV against the q7 actor of bench.py (its
    vectorized form over the whole stream, held equal to the copy on the
    first two epochs)."""
    from risingwave_tpu_torch.queries.nexmark_q import Q7_WINDOW_MS

    t0 = time.perf_counter()
    host, chunks = q7_stream(torch, dev, epochs)
    first = [c for ep in host[:2] for c in ep]
    check(np.array_equal(actor_rows(cpu_actor_q7(first, Q7_WINDOW_MS)),
                         q7_oracle_rows(first, Q7_WINDOW_MS)),
          "q7 oracle: vectorized form = the actor's copy on the first two epochs")
    oracle = q7_oracle_rows([c for ep in host for c in ep], Q7_WINDOW_MS)
    setup_s = time.perf_counter() - t0
    n_chunks = sum(len(ep) for ep in chunks)
    q7, rec = run_q7(torch, dev, host, chunks, fused=False)
    q7_checks(torch, q7, rec, oracle, "q7", n_chunks, epochs)
    row = q7_row("q7", host, q7, rec)
    row.update(setup_s=setup_s, oracle="bench.py's cpu_actor_q7 (copied; vectorized over the "
               "stream, equal to the copy on the first two epochs): equal")
    return row, rec["launches"], (host, chunks, q7, rec, oracle)


def q7_fused_path(torch, dev, host, chunks, interp, oracle):
    """Phase 10: q7 through ``fuse_pipeline``: one program per barrier
    (left E, A, N, M, A, L and A, D per chunk; right E, F, A, G over the
    epoch; then the agg's flush rounds, each C, M, A, L, A, D; then five
    H), run under ``no_device_reads``; the watermark outside it."""
    check_sync_guard(torch, dev)
    interp_q7, interp_rec = interp
    n_chunks = sum(len(ep) for ep in chunks)
    q7, rec = run_q7(torch, dev, host, chunks, fused=True)
    w = q7.pipeline._fused
    q7_checks(torch, q7, rec, oracle, "q7 fused", n_chunks, len(chunks))
    for e, (a, b) in enumerate(zip(rec["snapshots"], interp_rec["snapshots"])):
        check(np.array_equal(a, b), f"q7 fused: MV vs phase 9's MV at barrier {e}")
    lane_digests = rec["digests_before_last_watermark"]
    check(w.last_digests == lane_digests,
          f"q7 fused: staged digests {w.last_digests} vs host_digest {lane_digests}")
    check(lane_digests == interp_rec["digests_before_last_watermark"],
          "q7 fused: digests vs phase 9's state")
    check(rec["launches"]["state_digest"] > 0, "kernel state_digest launched on q7's fused path")
    tel = w.last_telemetry
    check(tel["rows_left"] == tel["rows_right"] == sum(len(c["auction"]) for c in host[-1]),
          "q7 fused: rows_left = rows_right = the last epoch's bids")
    check(tel["join_rows"] == tel["mv_rows"], "q7 fused: every join row reached the MV")
    row = q7_row("q7_fused", host, q7, rec)
    row.update(
        last_telemetry=tel, digests={k: f"{v:016x}" for k, v in lane_digests.items()},
        sync_guard="set_sync_debug_mode('error') over the program part of every barrier: held",
        oracle="q7 actor and phase 9's MV at every barrier: equal; staged digests = "
               "host_digest of the lanes read back = host_digest of phase 9's state",
    )
    return row, rec["launches"], q7


def profile_q7(torch, dev, host, chunks, epochs: int, fused: bool):
    """Phase 9's (or, ``fused``, phase 10's) run profiled on a fresh q7
    over the same chunks, the watermark included in each epoch."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q7
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    q7 = build_q7(capacity=Q7_CAP, fanout=Q7_FANOUT, out_cap=Q7_OUT_CAP, agg_capacity=Q7_CAP,
                  filter_capacity=Q7_CAP, device=dev)
    if fused:
        fuse_pipeline(q7.pipeline, label="q7")
    max_ts = {e: max(int(c["date_time"].max()) for ep in host[:e + 1] for c in ep)
              for e in range(len(host))}

    def push(pipeline, ec):
        for c in ec[1]:
            pipeline.push_left(c)
            pipeline.push_right(c)

    def after(pipeline, ec):
        pipeline.watermark("date_time", max_ts[ec[0]])

    row = profile_epochs(torch, "q7_fused_profile" if fused else "q7_profile", q7.pipeline, push,
                         list(enumerate(chunks)), epochs, after=after)
    row["bids"] = sum(len(c["auction"]) for ep in host[1:1 + epochs] for c in ep)
    return row


# -- phase 3, q101's kernels (P; M's group 2, L's init_degree) and the join matrix --
def q101_side(torch, dev, names, dtypes, ids, cols, nullable=()):
    """A (Q101_JOIN_CAP, Q101_FANOUT) join side keyed on ``names[0]``,
    one row per id, filled through A + L in 65,536-row chunks."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops.join import JoinSide, apply_side

    side = JoinSide.create(Q101_JOIN_CAP, Q101_FANOUT, (torch.int64,), dtypes, nullable,
                           device=dev)
    for lo in range(0, len(ids), A_ROWS):
        c = StreamChunk.from_numpy({k: v[lo:lo + A_ROWS] for k, v in cols.items()}, A_ROWS,
                                   device=dev)
        apply_side(side, (c.col(names[0]),), {k: c.col(k) for k in names}, {}, c.valid, c.ops,
                   names)
    check(not bool(side.overflow) and not bool(side.inconsistent), "q101 side: filled cleanly")
    return side


def probed_lanes(pr) -> dict:
    """Every lane of a Probed emission, by name."""
    out = {f"col.{k}": v for k, v in pr.cols.items()}
    out.update({f"null.{k}": v for k, v in pr.nulls.items()})
    out.update(ops=pr.ops, valid=pr.valid, slots=pr.slots, mc=pr.mc, written=pr.written)
    return out


def clone_probed(pr):
    from risingwave_tpu_torch.ops.join import Probed

    return Probed({k: v.clone() for k, v in pr.cols.items()},
                  {k: v.clone() for k, v in pr.nulls.items()}, pr.ops.clone(), pr.valid.clone(),
                  pr.slots.clone(), pr.mc.clone(), pr.written.clone())


def emitted_rows(pr, lo: int, hi: int) -> list:
    """Rows lo..hi of an emission chunk as sorted (values..., nulls...,
    op, valid) tuples: a multiset."""
    lanes = ([pr.cols[k] for k in sorted(pr.cols)] + [pr.nulls[k] for k in sorted(pr.nulls)]
             + [pr.ops, pr.valid])
    a = np.stack([x[lo:hi].cpu().numpy().astype(np.int64) for x in lanes], 1)
    return sorted(map(tuple, a.tolist()))


def kernel_p(torch, dev, rng, n_keys: int = 1_200_000, n: int = A_ROWS):
    """P against its plain version on a q101-sized right arrival: a
    65,536-row flush chunk (U-/U+ pairs on stored auctions of degree 1
    that net to zero, first bids on auctions of degree 0, deletes of
    degree-1 auctions that go to zero, absent auctions, padding) after
    M's probe of a (2^22, 4) left side of 1.2M auctions. The degree
    lane, M's rows, the counters and latch equal; P's transitions equal
    as a multiset (P writes them in first-match order, the plain version
    in pid order). Returns the row."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import join as jn
    from risingwave_tpu_torch.types import Op

    ids = np.arange(n_keys, dtype=np.int64) + 1000
    items = rng.integers(0, 100_000, n_keys).astype(np.int32)
    side = q101_side(torch, dev, ("id", "item_name"), {"id": torch.int64,
                                                       "item_name": torch.int32},
                     ids, {"id": ids, "item_name": items})
    pick = rng.permutation(n_keys)
    n_first, n_pair, n_zero, n_absent = 16_384, 16_384, 8_192, 4_096
    first, pair, zero = (ids[pick[:n_first]], ids[pick[n_first:n_first + n_pair]],
                         ids[pick[n_first + n_pair:n_first + n_pair + n_zero]])
    deg1 = np.concatenate([pair, zero])
    d_slots, d_found = ht.lookup(side.table, (torch.from_numpy(deg1).to(dev),),
                                 torch.ones(len(deg1), dtype=torch.bool, device=dev))
    check(bool(d_found.all()), "P: every degree-1 auction found")
    side.degree[d_slots.long(), 0] = 1
    auction = np.concatenate([first, np.repeat(pair, 2), zero,
                              np.arange(n_absent, dtype=np.int64) + 10**9])
    ops = np.concatenate([np.full(n_first, Op.INSERT), np.tile([Op.UPDATE_DELETE,
                                                                 Op.UPDATE_INSERT], n_pair),
                          np.full(n_zero, Op.DELETE), np.full(n_absent, Op.INSERT)])
    m = len(auction)
    price = rng.integers(1, 10**6, m).astype(np.int64)
    chunk = StreamChunk.from_numpy({"auction": auction, "max_price": price}, n,
                                   ops=ops.astype(np.int32),
                                   nulls={"max_price": np.zeros(m, bool)}, device=dev)
    own = {k: chunk.col(k) for k in ("auction", "max_price")}
    out_names = ("id", "item_name", "auction", "max_price")
    z = lambda d: torch.zeros((), dtype=d, device=dev)
    em, rows = z(torch.bool), z(torch.int64)
    base = jn.probe_pairs(side, (chunk.col("auction"),), chunk.valid, chunk.ops, own,
                          {"max_price": chunk.nulls["max_price"]}, out_names, Q101_OUT_CAP, em,
                          rows, ("auction", "max_price"), True, jn.G2_NONE)
    deg0 = side.degree.clone()
    res = []
    for fn in (jn._degree_emit_cuda, jn._degree_emit_torch):
        side.degree.copy_(deg0)
        pr, e, r = clone_probed(base), em.clone(), rows.clone()
        fn(side, pr, chunk.ops, Q101_OUT_CAP, e, r, jn.G3_OUTER)
        res.append((pr, e, r, side.degree.clone()))
    torch.cuda.synchronize()
    (pk, ek, rk, dk), (pp, ep, rp, dp) = res
    check(torch.equal(dk, dp), "P: degree lane")
    w0, w1 = int(base.written), int(pk.written)
    check(w1 == int(pp.written) and w1 - w0 == n_first + n_zero,
          f"P: transitions written ({w1 - w0}, want {n_first + n_zero})")
    check(not bool(ek) and not bool(ep) and int(rk) == int(rp) == w1, "P: latch and join_rows")
    lanes_k, lanes_p = probed_lanes(pk), probed_lanes(pp)
    for k in ("slots", "mc", "written"):
        check(torch.equal(lanes_k.pop(k), lanes_p.pop(k)), f"P: {k}")
    outside = lambda lanes: {k: torch.cat([v[:w0], v[w1:]]) for k, v in lanes.items()}
    assert_lanes_equal(torch, outside(lanes_k), outside(lanes_p), "P: M's rows and the tail")
    check(emitted_rows(pk, w0, w1) == emitted_rows(pp, w0, w1), "P: transitions as a multiset")
    check(not bool(pk.valid[w1:].any()), "P: nothing past the transitions")
    went_pos = int((pk.ops[w0:w1] == int(Op.DELETE)).sum())
    check(went_pos == n_first, "P: a pad retracted per first-time match")
    err = float((dk - dp).abs().max())

    def setup():
        side.degree.copy_(deg0)

    work = clone_probed(base)
    run = lambda fn: fn(side, work, chunk.ops, Q101_OUT_CAP, z(torch.bool), None, jn.G3_OUTER)

    def setup_work():
        setup()
        work.written.copy_(base.written)

    ms = time_ms(torch, lambda: run(jn._degree_emit_cuda), 20, setup_work)
    plain = time_ms(torch, lambda: run(jn._degree_emit_torch), 5, setup_work)
    side.degree.copy_(deg0)
    matched = n_first + 2 * n_pair + n_zero
    distinct = n_first + n_pair + n_zero
    trans = n_first + n_zero
    # per probe row its slot and op read and, with a slot, its bucket's
    # row_valid bytes; per distinct stored row its degree read and
    # written; per transition its stored lanes (12 B) read and its output
    # row (id 8, item 4, auction 8 + null 1, max_price 8 + null 1, op 4,
    # valid 1) written
    nbytes = n * 8 + (matched - n_pair) * Q101_FANOUT + distinct * 8 + trans * (12 + 35)
    row = {
        "name": "P join degree + transitions", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/join_degree.cu",
        "replaces": "risingwave_tpu/ops/join.py:339 (with :394)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"probe_rows": n, "capacity": side.capacity, "fanout": side.fanout,
                  "stored": n_keys, "first_matches": n_first, "net_zero_pairs": n_pair,
                  "went_zero": n_zero, "absent": n_absent, "out_cap": Q101_OUT_CAP,
                  "m_rows": w0, "transitions": w1 - w0},
        "group3_order": "multiset (P: first-match order; plain: pid order)",
    }
    del side, base, res
    return row, ids, items


def kernel_m_outer_l_init(torch, dev, rng, ids, items, n: int = A_ROWS):
    """M with group 2 and L with init_degree, at q101's left arrival: a
    65,536-row auction chunk (half with a stored max bid, half without)
    probing a (2^22, 4) right side of the 1.2M auctions' max bids (M:
    the pairs, then the NULL-padded rows), then folded into the left
    side of those auctions with each row's degree its match count (L,
    after kernel A). Every lane equal. Returns the two rows."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import join as jn

    n_keys = len(ids)
    with_bid = ids[rng.random(n_keys) < 0.9]
    right = q101_side(torch, dev, ("auction", "max_price"),
                      {"auction": torch.int64, "max_price": torch.int64}, with_bid,
                      {"auction": with_bid,
                       "max_price": rng.integers(1, 10**6, len(with_bid)).astype(np.int64)},
                      nullable=("max_price",))
    half = n // 2
    c_ids = np.concatenate([rng.choice(with_bid, half, replace=False),
                            np.arange(n - 16 - half, dtype=np.int64) + 10**9])
    c_items = rng.integers(0, 100_000, len(c_ids)).astype(np.int32)
    chunk = StreamChunk.from_numpy({"id": c_ids, "item_name": c_items}, n, device=dev)
    own = {k: chunk.col(k) for k in ("id", "item_name")}
    out_names = ("id", "item_name", "auction", "max_price")
    null_names = ("auction", "max_price")
    z = lambda d: torch.zeros((), dtype=d, device=dev)
    key = (chunk.col("id"),)
    res = []
    for fn in (jn._probe_pairs_cuda, jn._probe_pairs_torch):
        em, rows = z(torch.bool), z(torch.int64)
        pr = fn(right, key, chunk.valid, chunk.ops, own, {}, out_names, null_names, Q101_OUT_CAP,
                em, rows, True, jn.G2_OUTER)
        res.append({**probed_lanes(pr), "em_overflow": em, "join_rows": rows})
    torch.cuda.synchronize()
    assert_lanes_equal(torch, res[0], res[1], "M with group 2")
    written = int(res[0]["written"])
    check(written == len(c_ids) and int(res[0]["join_rows"]) == written,
          "M with group 2: one row per auction (its pair or its pad)")
    m_err = max_abs_diff(torch, res[0], res[1])
    em, rows = z(torch.bool), z(torch.int64)
    m_run = lambda fn: fn(right, key, chunk.valid, chunk.ops, own, {}, out_names, null_names,
                          Q101_OUT_CAP, em, rows, True, jn.G2_OUTER)
    m_ms = time_ms(torch, lambda: m_run(jn._probe_pairs_cuda), 20)
    m_dev = device_time_ms(torch, lambda: m_run(jn._probe_pairs_cuda), 5)
    m_plain = time_ms(torch, lambda: m_run(jn._probe_pairs_torch), 5)
    n_found = int((res[0]["slots"] >= 0).sum())
    # per probe row its key, item, valid and ops read, one probe (fp1,
    # fp2, key, live: 17 B), slots and mc written; per hit its bucket's
    # row_valid and its pair's stored lanes (16 B + null); the out_cap
    # rows (id 8, item 4, auction 8 + 1, max_price 8 + 1, op 4, valid 1)
    # written
    m_bytes = n * (8 + 4 + 1 + 4 + 17 + 8) + n_found * (Q101_FANOUT + 17) + Q101_OUT_CAP * 35
    mc = res[0]["mc"]
    del right, res

    names = ("id", "item_name")
    left = q101_side(torch, dev, names, {"id": torch.int64, "item_name": torch.int32}, ids,
                     {"id": ids, "item_name": items})
    _, slots, _, _ = ht.lookup_or_insert(left.table, key, chunk.valid)
    base = clone_side(left)
    got, want = clone_side(base), clone_side(base)
    jn._apply_side_cuda(got, slots, own, {}, chunk.valid, chunk.ops, names, mc)
    jn._apply_side_torch(want, slots, own, {}, chunk.valid, chunk.ops, names, mc)
    torch.cuda.synchronize()
    lanes_k, lanes_p = side_lanes(got), side_lanes(want)
    assert_lanes_equal(torch, lanes_k, lanes_p, "L with init_degree")
    check(int(got.degree.sum()) == half, "L: each matched auction's degree is its match count")
    l_err = max_abs_diff(torch, lanes_k, lanes_p)
    work = clone_side(base)
    setup = lambda: restore_side(work, base)
    l_ms = time_ms(torch, lambda: jn._apply_side_cuda(work, slots, own, {}, chunk.valid,
                                                      chunk.ops, names, mc), 10, setup)
    l_plain = time_ms(torch, lambda: jn._apply_side_torch(work, slots, own, {}, chunk.valid,
                                                          chunk.ops, names, mc), 3, setup)
    m = len(c_ids)
    m_row = {
        "name": "M join probe + group 2 (left outer arrival)", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/join_probe.cu",
        "replaces": "risingwave_tpu/ops/join.py:407,420,429 with executors/hash_join.py:174-195",
        "max_abs_err": m_err, "ms": m_ms, "device_ms": m_dev, "plain_ms": m_plain,
        "bound_ms": bound_ms(m_bytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"probe_rows": n, "capacity": Q101_JOIN_CAP, "fanout": Q101_FANOUT,
                  "stored": len(with_bid), "found": n_found, "rows_written": written,
                  "out_cap": Q101_OUT_CAP},
    }
    l_row = {
        "name": "L join apply + init_degree", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/join_apply.cu",
        "replaces": "risingwave_tpu/ops/join.py:215 (init_degree :289-299)",
        "max_abs_err": l_err, "ms": l_ms, "plain_ms": l_plain,
        # per row valid, ops, slot, init_degree and 12 payload bytes
        # read; per insert its bucket's row_valid read, sdirty and live
        # written, its entry (12 + 1 + 4 B) written
        "bound_ms": bound_ms(n * (1 + 4 + 4 + 4 + 12) + m * (Q101_FANOUT + 2) + m * 17),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"rows": n, "capacity": Q101_JOIN_CAP, "fanout": Q101_FANOUT,
                  "stored_keys": len(ids), "inserts": m, "matched": half},
    }
    del left, base, got, want, work
    return m_row, l_row


def join_types_on_card(torch, dev, rng, steps: int = 12, n: int = 2048):
    """Every type of JOIN_TYPES at a small shape: the same random
    insert/delete stream (chunks of ``n`` rows, alternating sides at
    random, deletes only of stored rows) through an executor on the card
    (kernels A, M, P, L) and one on the CPU (their plain versions); per
    chunk the emission multisets, the latch and both sides' digests
    equal. Returns the check row."""
    import collections

    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors.hash_join import JOIN_TYPES, HashJoinExecutor
    from risingwave_tpu_torch.types import Op

    dt = {"l": {"lk": torch.int64, "lv": torch.int64}, "r": {"rk": torch.int64,
                                                           "rv": torch.int32}}
    rows_out = {}
    for jt in JOIN_TYPES:
        exs = [HashJoinExecutor(("lk",), ("rk",), dt["l"], dt["r"], capacity=1 << 13,
                                fanout=32, out_cap=1 << 16, right_nullable=("rv",),
                                join_type=jt, device=d) for d in (dev, "cpu")]
        stored = {"l": [], "r": []}
        total = 0
        for step in range(steps):
            side = "l" if rng.random() < 0.5 else "r"
            k = rng.integers(0, 2048, n).astype(np.int64)
            v = rng.integers(0, 4, n)
            ops = np.zeros(n, np.int32)
            nul = rng.random(n) < 0.2
            pool = stored[side]
            n_del = min(len(pool), n // 4) if step > 1 else 0
            if n_del:
                take = rng.choice(len(pool), n_del, replace=False)
                for j, t in enumerate(take):
                    k[j], v[j], nul[j] = pool[t]
                    ops[j] = Op.DELETE
                keep = np.ones(len(pool), bool)
                keep[take] = False
                pool[:] = [p for p, ok in zip(pool, keep) if ok]
            pool.extend((int(a), int(b), bool(c)) for a, b, c in
                        zip(k[n_del:], v[n_del:], nul[n_del:]))
            names = ("lk", "lv") if side == "l" else ("rk", "rv")
            cols = {names[0]: k, names[1]: v.astype(np.int64 if side == "l" else np.int32)}
            nulls = {"rv": nul} if side == "r" else None
            got = []
            for ex in exs:
                c = StreamChunk.from_numpy(cols, n, ops=ops, nulls=nulls, device=ex.device)
                (out,) = (ex.apply_left if side == "l" else ex.apply_right)(c)
                d = out.to_numpy(with_ops=True)
                ms = collections.Counter(zip(*[
                    np.where(d[nm + "__null"], -1, d[nm]) if nm + "__null" in d else d[nm]
                    for nm in ex.out_names], d["__op__"]))
                got.append((ms, ex.side_digests(), bool(ex._em_overflow)))
            total += sum(got[0][0].values())
            check(got[0][0] == got[1][0], f"join types: {jt} emission at step {step}")
            check(got[0][1] == got[1][1], f"join types: {jt} side digests at step {step}")
            check(got[0][2] == got[1][2] == False, f"join types: {jt} no emission overflow")
        for ex in exs:
            ex.on_barrier(None)
        if jt != "inner":
            check(bool((exs[0].left.degree != 0).any() | (exs[0].right.degree != 0).any()),
                  f"join types: {jt} keeps degrees")
        rows_out[jt] = total
    return {"phase": "kernel_join_types", "steps": steps, "chunk_rows": n,
            "capacity": 1 << 13, "fanout": 32, "rows_emitted": rows_out,
            "check": "card (A, M, P, L) vs CPU (plain versions), per chunk: emission "
                     "multisets, latch, both sides' host_digest: equal"}


# -- phases 11 and 12: q101 ----------------------------------------------------
def q101_stream(torch, dev, epochs: int):
    """Per epoch, 1M events generated in 65,536-event pieces: the
    auctions (id, item_name) batched into one chunk of A_ROWS rows, the
    bids (auction, price) one chunk per piece. Returns the host columns
    (the auctions' seller and category too, for phase 28) and the chunks
    on the card."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=EVENT_RATE), seed=SEED)
    host, chunks = [], []
    for _ in range(epochs):
        a_parts, bids, done = [], [], 0
        while done < EVENTS_PER_EPOCH:
            n = min(CHUNK_EVENTS, EVENTS_PER_EPOCH - done)
            done += n
            ev = gen.next_events(n)
            a_parts.append({k: ev["auction"][k] for k in ("id", "item_name", "seller",
                                                          "category")})
            if len(ev["bid"]["auction"]):
                bids.append({k: ev["bid"][k] for k in ("auction", "price")})
        a = {k: np.concatenate([p[k] for p in a_parts]) for k in a_parts[0]}
        check(len(a["id"]) <= A_ROWS, "q101: an epoch's auctions fit one chunk")
        host.append((a, bids))
        chunks.append((StreamChunk.from_numpy({k: a[k] for k in ("id", "item_name")}, A_ROWS,
                                              device=dev),
                       [StreamChunk.from_numpy(b, CHUNK_EVENTS, device=dev) for b in bids]))
    return host, chunks


def q101_oracle_rows(host) -> np.ndarray:
    """Every auction with its item and its maximum bid, or NULL without
    one, as sorted (id, auction, item_name, max_price, max_price_null)
    rows keyed on the stream key: an unmatched auction's NULL auction
    lane holds 0, as the MV stores it."""
    ids = np.concatenate([a["id"] for a, _ in host])
    items = np.concatenate([a["item_name"] for a, _ in host]).astype(np.int64)
    b_auc = np.concatenate([b["auction"] for _, bs in host for b in bs])
    b_price = np.concatenate([b["price"] for _, bs in host for b in bs])
    u, inv = np.unique(b_auc, return_inverse=True)
    mx = np.full(len(u), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, b_price)
    pos = np.clip(np.searchsorted(u, ids), 0, len(u) - 1)
    has = u[pos] == ids
    rows = np.stack([ids, np.where(has, ids, 0), items, np.where(has, mx[pos], 0),
                     (~has).astype(np.int64)], 1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def q101_mv_rows(mview) -> np.ndarray:
    got = mview.to_numpy()
    nul = got["max_price__null"]
    rows = np.stack([got["id"], got["auction"], got["item_name"].astype(np.int64),
                     np.where(nul, 0, got["max_price"]), nul.astype(np.int64)], 1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


class Q101:
    """The q101 plan from the port's executors (the JAX package has no
    ``build_q101``): auctions left (no executor), HashAgg MAX(price) by
    auction right, a LEFT OUTER HashJoin on id = auction, a device MV
    keyed on the join's stream key (id, auction); ``materialized``: the
    MAX keeps its input (256 distinct prices per auction)."""

    def __init__(self, torch, dev, materialized: bool = False):
        from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
        from risingwave_tpu_torch.executors.hash_join import HashJoinExecutor
        from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
        from risingwave_tpu_torch.ops.agg import AggCall
        from risingwave_tpu_torch.runtime.pipeline import TwoInputPipeline

        i64 = torch.int64
        self.agg = HashAggExecutor(
            group_keys=("auction",),
            calls=(AggCall("max", "price", "max_price", materialized=materialized),),
            schema_dtypes={"auction": i64, "price": i64}, capacity=Q101_AGG_CAP,
            out_cap=OUT_CAP, table_id="q101.maxbid", minput_k=Q5MAX_K, device=dev)
        self.join = HashJoinExecutor(
            left_keys=("id",), right_keys=("auction",),
            left_dtypes={"id": i64, "item_name": torch.int32},
            right_dtypes={"auction": i64, "max_price": i64}, capacity=Q101_JOIN_CAP,
            fanout=Q101_FANOUT, out_cap=Q101_OUT_CAP, right_nullable=("max_price",),
            join_type="left", table_id="q101.join", device=dev)
        self.mview = DeviceMaterializeExecutor(
            pk=("id", "auction"), columns=("item_name", "max_price"),
            schema_dtypes={"id": i64, "item_name": torch.int32, "auction": i64,
                           "max_price": i64},
            nullable=("max_price",), capacity=Q101_MV_CAP, table_id="q101.mview", device=dev)
        self.pipeline = TwoInputPipeline([], [self.agg], self.join, [self.mview])


def q101_digests(q) -> dict:
    """numpy host_digest of each of q101's four states, read back."""
    from risingwave_tpu_torch import integrity

    host = lambda lanes_live: integrity.host_digest(*integrity.host_lanes(*lanes_live))
    jl, jr = q.join.side_digests()
    return {"right": host(integrity.agg_lanes(q.agg.table, q.agg.state, q.agg._float_extremes)),
            "join_left": jl, "join_right": jr,
            "mv": host(integrity.mv_lanes(q.mview.table, q.mview.state))}


def packed_join_digests(q) -> dict:
    """host_digest of each join side with every bucket's live entries
    packed to the front, in position order: the side's content without
    its bucket positions. A rebuild (``regrow``) packs the entries it
    moves, and the fused run's host bound (the flush rounds' padded
    rows) rebuilds the right side late in the run where the interpreted
    run does not, so the two runs' positions, and their plain digests,
    can differ while every key holds the same rows and degrees."""
    from risingwave_tpu_torch import integrity

    out = {}
    for name, side in (("join_left", q.join.left), ("join_right", q.join.right)):
        lanes, live = integrity.host_lanes(*integrity.join_side_lanes(side))
        rv = lanes["rv"]
        order = np.argsort(~rv, axis=1, kind="stable")
        packed = {k: np.take_along_axis(v, order, 1) if v.shape == rv.shape else v
                  for k, v in lanes.items()}
        out[name] = integrity.host_digest(packed, live)
    return out


def run_q101(torch, dev, chunks, fused: bool, materialized: bool = False):
    """q101 over the chunks (each epoch's auction chunk pushed left, then
    its bid chunks right, then a barrier), timed; after each barrier
    (untimed) a hash of the sorted MV rows. Returns the query and a
    record."""
    import hashlib

    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.runtime.fused_step import FusedTwoInputExecutor, fuse_pipeline

    q = Q101(torch, dev, materialized)
    if fused:
        wrappers = fuse_pipeline(q.pipeline, label="q101")
        check(len(wrappers) == 1 and isinstance(wrappers[0], FusedTwoInputExecutor),
              "q101 fused: one FusedTwoInputExecutor")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    rec = {"barrier_ms": [], "push_ms": [], "barrier_launches": [], "flush_rounds": [],
           "mv_hashes": []}
    run_s = 0.0
    for a, bids in chunks:
        t0 = time.perf_counter()
        q.pipeline.push_left(a)
        for b in bids:
            q.pipeline.push_right(b)
        before = dict(_kernels.LAUNCHES)
        tb = time.perf_counter()
        q.pipeline.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec["push_ms"].append((tb - t0) * 1e3)
        rec["barrier_ms"].append((t1 - tb) * 1e3)
        rec["barrier_launches"].append(sum(_kernels.LAUNCHES.values()) - sum(before.values()))
        rec["flush_rounds"].append(_kernels.LAUNCHES["agg_flush"] - before["agg_flush"])
        run_s += t1 - t0
        rows = q101_mv_rows(q.mview)
        rec["mv_hashes"].append(hashlib.sha256(rows.tobytes()).hexdigest())
    rec.update(run_s=run_s, launches=dict(_kernels.LAUNCHES),
               peak=torch.cuda.max_memory_allocated(), final_rows=rows)
    return q, rec


Q101_KERNELS = ("lookup_or_insert", "agg_flush", "mv_upsert", "join_apply", "join_probe",
                "join_degree")


def q101_row(phase, host, q, rec) -> dict:
    auctions = sum(len(a["id"]) for a, _ in host)
    bids = sum(len(b["auction"]) for _, bs in host for b in bs)
    return {
        "phase": phase, "epochs": len(host), "events": len(host) * EVENTS_PER_EPOCH,
        "auctions": auctions, "bids": bids, "bid_chunks": sum(len(bs) for _, bs in host),
        "chunk_capacity": {"auction": A_ROWS, "bid": CHUNK_EVENTS},
        "rows_per_s": (auctions + bids) / rec["run_s"], "run_s": rec["run_s"],
        "barrier_ms_p50": float(np.percentile(rec["barrier_ms"], 50)),
        "barrier_ms_p99": float(np.percentile(rec["barrier_ms"], 99)),
        "barrier_ms": rec["barrier_ms"], "push_ms": rec["push_ms"],
        "launches_per_barrier": rec["barrier_launches"],
        "flush_rounds_per_barrier": rec["flush_rounds"],
        "capacity": {"agg": q.agg.table.capacity, "join_left": q.join.left.capacity,
                     "join_right": q.join.right.capacity, "mv": q.mview.table.capacity},
        "fanout": q.join.left.fanout, "out_cap": q.join.out_cap,
        "mv_rows": int(len(rec["final_rows"])),
        "unmatched": int(rec["final_rows"][:, 4].sum()),
        "max_memory_allocated": int(rec["peak"]), "launches": rec["launches"],
    }


def q101_path(torch, dev, epochs: int):
    """Phase 11: q101 interpreted (the auction chunk through the join,
    each bid chunk through the agg, the agg's flush at the barrier as
    right arrivals), its final MV against the numpy oracle."""
    t0 = time.perf_counter()
    host, chunks = q101_stream(torch, dev, epochs)
    oracle = q101_oracle_rows(host)
    setup_s = time.perf_counter() - t0
    q, rec = run_q101(torch, dev, chunks, fused=False)
    got = rec["final_rows"]
    check(got.shape == oracle.shape and np.array_equal(got, oracle),
          f"q101: MV ({len(got)} rows) vs the oracle ({len(oracle)} rows)")
    for name in Q101_KERNELS:
        check(rec["launches"][name] > 0, f"kernel {name} launched on q101's interpreted path")
    row = q101_row("q101", host, q, rec)
    row.update(setup_s=setup_s, oracle="numpy: every auction with its item and its maximum "
               "bid, or NULL: equal")
    return row, rec["launches"], (host, chunks, q, rec, oracle)


def q101_fused_path(torch, dev, host, chunks, interp, oracle):
    """Phase 12: q101 through ``fuse_pipeline``: one program per barrier
    (the auction chunk M, P, A, L and A, D; the bid epoch F, A, G; then
    the agg's flush rounds, each C, M, P, A, L, A, D; then four H),
    run under ``no_device_reads``."""
    check_sync_guard(torch, dev)
    interp_q, interp_rec = interp
    q, rec = run_q101(torch, dev, chunks, fused=True)
    w = q.pipeline._fused
    check(np.array_equal(rec["final_rows"], oracle), "q101 fused: MV vs the oracle")
    for e, (a, b) in enumerate(zip(rec["mv_hashes"], interp_rec["mv_hashes"])):
        check(a == b, f"q101 fused: MV vs phase 11's MV at barrier {e}")
    lane_digests = q101_digests(q)
    check(w.last_digests == lane_digests,
          f"q101 fused: staged digests {w.last_digests} vs host_digest {lane_digests}")
    interp_digests = q101_digests(interp_q)
    for name in ("right", "mv"):
        check(lane_digests[name] == interp_digests[name], f"q101 fused: {name} digest vs phase 11's")
    # a join side rebuilt in one run only holds its entries at other
    # bucket positions: compare its content then (packed_join_digests)
    packed = packed_join_digests(q)
    interp_packed = packed_join_digests(interp_q)
    side_check = {}
    for name, side, other in (("join_left", q.join.left, interp_q.join.left),
                              ("join_right", q.join.right, interp_q.join.right)):
        if side.capacity == other.capacity:
            check(lane_digests[name] == interp_digests[name],
                  f"q101 fused: {name} digest vs phase 11's")
            side_check[name] = "digest equal"
        else:
            side_check[name] = f"rebuilt {other.capacity} -> {side.capacity} in this run: packed"
        check(packed[name] == interp_packed[name],
              f"q101 fused: {name} content (packed digest) vs phase 11's")
    for name in Q101_KERNELS + ("state_digest", "reduce_by_key", "apply_reduced"):
        check(rec["launches"][name] > 0, f"kernel {name} launched on q101's fused path")
    tel = w.last_telemetry
    a_last, b_last = host[-1]
    check(tel["rows_left"] == len(a_last["id"]) and
          tel["rows_right"] == sum(len(b["auction"]) for b in b_last),
          "q101 fused: rows_left / rows_right = the last epoch's auctions / bids")
    check(tel["join_rows"] == tel["mv_rows"], "q101 fused: every join row reached the MV")
    row = q101_row("q101_fused", host, q, rec)
    row.update(
        last_telemetry=tel, digests={k: f"{v:016x}" for k, v in lane_digests.items()},
        sync_guard="set_sync_debug_mode('error') over the program part of every barrier: held",
        join_side_check=side_check,
        oracle="numpy oracle and phase 11's MV at every barrier: equal; staged digests = "
               "host_digest of the lanes read back; agg and MV digests = phase 11's; each "
               "join side's digest = phase 11's, or, where one run rebuilt it, its packed "
               "digest = phase 11's",
    )
    return row, rec["launches"], q


def profile_q101(torch, dev, chunks, epochs: int, fused: bool):
    """Phase 11's (or, ``fused``, phase 12's) run profiled on a fresh
    q101 over the same chunks."""
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    q = Q101(torch, dev)
    if fused:
        fuse_pipeline(q.pipeline, label="q101")

    def push(pipeline, ep):
        pipeline.push_left(ep[0])
        for b in ep[1]:
            pipeline.push_right(b)

    row = profile_epochs(torch, "q101_fused_profile" if fused else "q101_profile", q.pipeline,
                         push, chunks, epochs)
    row["rows"] = sum(int(a.valid.sum()) + sum(int(b.valid.sum()) for b in bs)
                      for a, bs in chunks[1 : 1 + epochs])
    return row


# -- phase 3, kernel Q: the materialized MIN/MAX multiset ---------------------------
Q5MAX_MAX_CAP = 1 << 6  # the MAX agg's first capacity; its chunk bound grows it to 2^14
Q5MAX_K = 256  # distinct values per window: the SQL planner's minput_k
Q_CHURN_GROUPS = 1 << 20
Q_CHURN_K = 32
Q_CHURN_ROWS = 1 << 20


def mi_sorted(torch, vals, cnt):
    """Each slot's live lanes as one sorted row of (value, count): the
    multiset, whatever lanes hold it."""
    live = cnt > 0
    key = torch.where(live, vals, torch.iinfo(vals.dtype).max)
    c = torch.where(live, cnt, 0)
    order = torch.argsort(c, dim=1, stable=True)
    order = torch.gather(order, 1, torch.argsort(torch.gather(key, 1, order), dim=1,
                                                 stable=True))
    return torch.gather(key, 1, order), torch.gather(c, 1, order)


def q_run(torch, fn, state0, batch, kind, latches=None):
    """One minput_apply (``fn``: the kernel's wrapper or the plain
    version) on copies of ``state0 = (vals, cnt, accum, nonnull)``;
    returns the state after it and the two latches."""
    vals, cnt, acc, nn = (x.clone() for x in state0)
    ovf, inc = latches or (torch.zeros((), dtype=torch.bool, device=vals.device),
                           torch.zeros((), dtype=torch.bool, device=vals.device))
    fn(vals, cnt, *batch, kind, acc, nn, ovf, inc)
    return vals, cnt, acc, nn, ovf, inc


def q_compare(torch, got, want, what: str, state_too: bool = True) -> float:
    """Slot-independent results equal: per slot the multiset of (value,
    count), the accumulator and non-null lanes, both latches."""
    check(bool(got[4]) == bool(want[4]) and bool(got[5]) == bool(want[5]),
          f"{what}: latches (overflow, inconsistent) {bool(got[4]), bool(got[5])} vs "
          f"{bool(want[4]), bool(want[5])}")
    if not state_too:
        return 0.0
    gk, gc = mi_sorted(torch, got[0], got[1])
    wk, wc = mi_sorted(torch, want[0], want[1])
    check(torch.equal(gk, wk) and torch.equal(gc, wc), f"{what}: multisets")
    check(torch.equal(got[2], want[2]), f"{what}: extremes (accumulator lane)")
    check(torch.equal(got[3], want[3]), f"{what}: live totals (non-null lane)")
    return float((got[2] - want[2]).abs().max())


def q_time(torch, fn, state0, batch, kind, reps: int) -> float:
    work = tuple(x.clone() for x in state0)
    latch = torch.zeros((), dtype=torch.bool, device=work[0].device)

    def setup():
        for w, x in zip(work, state0):
            w.copy_(x)

    return time_ms(torch, lambda: fn(work[0], work[1], *batch, kind, work[2], work[3], latch,
                                     latch), reps, setup)


def q_counts(torch, slots, signs, v, notnull):
    """Distinct groups and distinct (group, value) pairs among the
    active rows: what the work of one call depends on."""
    active = (slots >= 0) & (signs != 0)
    if notnull is not None:
        active &= notnull
    s = slots[active].long()
    vv = v[active]
    if vv.dtype.is_floating_point:
        vv = vv.view(torch.int64) if vv.dtype == torch.float64 else vv.view(torch.int32)
    pairs = torch.unique(torch.stack([s, vv.long()], 1), dim=0).shape[0]
    return int(torch.unique(s).numel()), int(pairs)


def q_bytes(n: int, groups: int, pairs: int, k: int, v_bytes: int, nulls: bool,
            lane_bytes: int = 8) -> int:
    """Each row's slot, sign, value (and null byte) read; each touched
    group's K lanes (a ``lane_bytes`` value, a 4-byte count) read and
    its extreme (``lane_bytes``) and 8-byte total written; each pair's
    lane written."""
    return (n * (8 + v_bytes + int(nulls)) + groups * (k * (lane_bytes + 4) + lane_bytes + 8)
            + pairs * (lane_bytes + 4))


def q5_max_flush_batch(torch, dev):
    """Shape (a): epoch 0 of the q5 stream through q5-max (interpreted,
    its watermark after the barrier), then epoch 1's bids through the
    hop and the count agg and the count agg's barrier flush: about
    300,000 Insert/U-/U+ rows, as one batch for the MAX agg's multisets
    (the fused path hands the MAX one such batch a barrier). Returns
    the MAX agg and the batch ``(slots, signs, num, None)``."""
    from risingwave_tpu_torch.ops.hash_table import lookup_or_insert
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_max

    ep0, ep1 = q5_stream(torch, dev, 2)
    q = build_q5_max(capacity=1 << 21, max_capacity=Q5MAX_MAX_CAP, minput_k=Q5MAX_K,
                     device=dev)
    for c in ep0:
        q.pipeline.push(c)
    q.pipeline.barrier()
    ts = max(int(c.col("date_time")[c.valid].max()) for c in ep0)
    q.pipeline.watermark("date_time", ts)
    for c in ep1:
        q.pipeline.push(c)
    outs = q.count_agg.on_barrier(None)
    cat = lambda get: torch.cat([get(c) for c in outs])
    valid, ops = cat(lambda c: c.valid), cat(lambda c: c.ops)
    ws, num = cat(lambda c: c.col("window_start")), cat(lambda c: c.col("num"))
    mx = q.max_agg
    mx.table, slots, _, _ = lookup_or_insert(mx.table, (ws,), valid)
    from risingwave_tpu_torch.array.chunk import StreamChunk

    signs = StreamChunk({"num": num}, valid, {}, ops).effective_signs()
    mx.probe = ((ws,), valid & (signs != 0))  # the epoch path's re-probe of every row
    return mx, (slots, signs, num, None), {
        "flush_rows": int(valid.shape[0]), "valid_rows": int(valid.sum()),
        "inserts": int((valid & (ops == 0)).sum()), "u_minus": int((valid & (ops == 3)).sum()),
        "flush_chunks": len(outs), "max_capacity": mx.table.capacity,
    }


Q_CHURN_DTYPES = {  # value dtype -> (range of the integers behind the values, int -> value)
    "int64": (1 << 40, lambda x: x),
    "float64": (1 << 40, lambda x: (x - (1 << 39)) * 1e-3),
    "int32": (1 << 22, lambda x: x.astype(np.int32)),
    # halves of integers below 2^23 in magnitude: exact in float32, so
    # distinct integers stay distinct values
    "float32": (1 << 22, lambda x: ((x - (1 << 22)) * 0.5).astype(np.float32)),
}


def q_churn(torch, dev, rng, kind: str, dtype: str):
    """Shape (b): 2^20 groups of K = 32 lanes, about half live; 2^20
    rows: 384k deletes of live values on distinct groups (a quarter of
    them the group's current extreme), 512k inserts (half new values,
    half more copies of live ones), 64k rows of slot -1, 64k NULL
    values, the rest padding (sign 0). ``dtype`` names the input
    values' type (``Q_CHURN_DTYPES``); a float's lanes hold its order
    key in int64. Returns ``(state0, batch)``."""
    from risingwave_tpu_torch.ops.agg import _float_to_order_key, accum_init

    g, k, n = Q_CHURN_GROUPS, Q_CHURN_K, Q_CHURN_ROWS
    span, as_value = Q_CHURN_DTYPES[dtype]
    ints = rng.integers(0, span, g)[:, None] + np.arange(k) * 7919
    cnt = np.where(rng.random((g, k)) < 0.5, rng.integers(1, 4, (g, k)), 0).astype(np.int32)
    n_del, n_ins, n_neg, n_null = 3 * n // 8, n // 2, n // 16, n // 16
    slots = np.full(n, -1, np.int32)
    signs = np.zeros(n, np.int32)
    vals = np.zeros(n, np.int64)
    # deletes: one live lane of each of n_del distinct groups
    dg = rng.permutation(g)[:n_del]
    live = cnt[dg] > 0
    score = np.where(live, rng.random((n_del, k)), -1.0)
    lane = score.argmax(1)
    ext = np.where(live, ints[dg], -1 if kind == "max" else 1 << 62)
    ext_lane = ext.argmax(1) if kind == "max" else ext.argmin(1)
    lane = np.where(np.arange(n_del) % 4 == 0, ext_lane, lane)
    has = live.any(1)
    slots[:n_del] = dg
    signs[:n_del] = np.where(has, -1, 1)
    vals[:n_del] = ints[dg, lane]
    # inserts: new values, or more copies of a lane's value
    ig = rng.integers(0, g, n_ins)
    fresh = rng.integers(0, span, n_ins) * 2 + 1
    copy = ints[ig, rng.integers(0, k, n_ins)]
    o = n_del
    slots[o:o + n_ins] = ig
    signs[o:o + n_ins] = 1
    vals[o:o + n_ins] = np.where(rng.random(n_ins) < 0.5, fresh, copy)
    o += n_ins
    signs[o:o + n_neg] = rng.choice(np.array([-1, 1], np.int32), n_neg)  # slot -1
    vals[o:o + n_neg] = rng.integers(0, span, n_neg)
    o += n_neg
    slots[o:o + n_null] = rng.integers(0, g, n_null)
    signs[o:o + n_null] = 1
    vals[o:o + n_null] = rng.integers(0, span, n_null)
    notnull = np.ones(n, bool)
    notnull[o:o + n_null] = False
    perm = rng.permutation(n)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    v = to(as_value(vals[perm]))
    lanes = to(as_value(ints))
    fx = lanes.dtype if lanes.dtype.is_floating_point else None
    if fx is not None:
        lanes = _float_to_order_key(lanes)
    acc = torch.full((g,), accum_init(kind, lanes.dtype, fx), dtype=lanes.dtype, device=dev)
    state0 = (lanes.contiguous(), to(cnt), acc, torch.zeros(g, dtype=torch.int64, device=dev))
    return state0, (to(slots[perm]), to(signs[perm]), v, to(notnull[perm]))


def kernel_q(torch, dev, rng):
    """Q against its plain version on the card: (a) q5-max's real flush
    batch into K = 256 lanes, int64 MAX; (b) the churn shape, float64
    and int32 MIN, int64 and float32 MAX; (c) an overflow and an inconsistency, each latch
    compared; (d) ``minput_clear`` of about half of (b)'s groups; (e)
    ``minput_rescatter`` from 2^20 to 2^21 slots. Lanes may differ (Q
    places a group's new values in counter order, the plain version in
    value order), so per slot the multiset of (value, count), the
    accumulator and non-null lanes and both latches are compared.
    Returns the rows of the apply, clear and rescatter entries."""
    from risingwave_tpu_torch.ops import minput as mi

    kern, plain = mi.minput_apply, mi._minput_fold_torch
    # (a)
    mx, batch, shape_a = q5_max_flush_batch(torch, dev)
    vals, cnt = mx.minput["maxn"]
    state_a = (vals, cnt, mx.state.accums["maxn"], mx.state.nonnull["maxn"])
    got, want = (q_run(torch, f, state_a, batch, "max") for f in (kern, plain))
    torch.cuda.synchronize()
    err = q_compare(torch, got, want, "Q (a) q5-max flush batch")
    check(not bool(got[4]) and not bool(got[5]), "Q (a): no latch")
    ms_a = q_time(torch, kern, state_a, batch, "max", 20)
    plain_a = q_time(torch, plain, state_a, batch, "max", 3)
    lookup_row = kernel_lookup(torch, mx.table, *mx.probe)
    groups, pairs = q_counts(torch, *batch)
    n = batch[0].shape[0]
    nbytes_a = q_bytes(n, groups, pairs, Q5MAX_K, 8, False)
    shape_a.update(rows=n, groups=groups, pairs=pairs, k=Q5MAX_K, kind="max int64")
    del mx, state_a, got, want, batch
    torch.cuda.empty_cache()
    # (b)
    churn = {}
    for kind, dtype in (("min", "float64"), ("max", "int64"), ("max", "float32"),
                        ("min", "int32")):
        state0, batch = q_churn(torch, dev, rng, kind, dtype)
        got, want = (q_run(torch, f, state0, batch, kind) for f in (kern, plain))
        torch.cuda.synchronize()
        name = f"{kind} {dtype}"
        err = max(err, q_compare(torch, got, want, f"Q (b) churn {name}"))
        check(not bool(got[4]) and not bool(got[5]), f"Q (b) {name}: no latch")
        check(int((got[3] != state0[3]).sum()) > 0, f"Q (b) {name}: totals moved")
        groups, pairs = q_counts(torch, *batch)
        churn[name] = {
            "ms": q_time(torch, kern, state0, batch, kind, 10),
            "plain_ms": q_time(torch, plain, state0, batch, kind, 2),
            "bound_ms": bound_ms(q_bytes(Q_CHURN_ROWS, groups, pairs, Q_CHURN_K,
                                         batch[2].element_size(), True,
                                         state0[0].element_size())),
            "groups": groups, "pairs": pairs,
        }
        if dtype == "int64":
            churn_state = got
        del state0, batch, got, want
        torch.cuda.empty_cache()
    # (c)
    cap, k = 64, 4
    z = lambda dt: torch.zeros(cap, dtype=dt, device=dev)
    st0 = (torch.zeros((cap, k), dtype=torch.int64, device=dev),
           torch.zeros((cap, k), dtype=torch.int32, device=dev), z(torch.int64), z(torch.int64))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    cases = {
        "overflow": (t([1] * 5 + [2, 2], torch.int32), t([1] * 7, torch.int32),
                     t([5, 6, 7, 8, 9, 1, 2], torch.int64), None),
        "inconsistent": (t([3, 3, 4], torch.int32), t([1, -1, -1], torch.int32),
                         t([10, 11, 12], torch.int64), None),
    }
    for what, b in cases.items():
        runs = []
        for f in (kern, plain):
            lat = (torch.zeros((), dtype=torch.bool, device=dev),
                   torch.zeros((), dtype=torch.bool, device=dev))
            runs.append(q_run(torch, f, st0, b, "max", lat))
        torch.cuda.synchronize()
        q_compare(torch, *runs, f"Q (c) {what}", state_too=what == "inconsistent")
        check(bool(runs[0][4 if what == "overflow" else 5]), f"Q (c): {what} latched")
        check(not bool(runs[0][5 if what == "overflow" else 4]), f"Q (c): only {what} latched")
    # (d)
    cnt = churn_state[1]
    g = cnt.shape[0]
    slots = torch.where(torch.from_numpy(rng.random(g) < 0.5).to(dev),
                        torch.arange(g, dtype=torch.int32, device=dev), -1)
    a, b = cnt.clone(), cnt.clone()
    mi.minput_clear(churn_state[0], a, slots)
    mi._minput_clear_torch(b, slots)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "Q (d) minput_clear")
    cleared = int((slots >= 0).sum())
    check(int((a[slots >= 0] != 0).sum()) == 0 and torch.equal(a[slots < 0], cnt[slots < 0]),
          "Q (d): exactly the listed groups cleared")
    work = cnt.clone()
    reset = lambda: work.copy_(cnt)
    listed = (slots >= 0)[:, None]  # the slot list as a dense mask (slots[i] is i or -1)
    d_row = {
        "name": "Q minput_clear", "route": "cuda", "source": "risingwave_tpu_torch/csrc/minput.cu",
        "replaces": "risingwave_tpu/ops/minput.py:172", "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: mi.minput_clear(churn_state[0], work, slots), 20, reset),
        "plain_ms": time_ms(torch, lambda: mi._minput_clear_torch(work, slots), 5, reset),
        "bound_ms": bound_ms(g * 4 + cleared * Q_CHURN_K * 4), "bound_by": "bytes",
        "library_ms": time_ms(torch, lambda: work.masked_fill_(listed, 0), 20, reset),
        "library_call": "masked_fill_ of the listed groups' count rows (the slot list's "
                        "mask built untimed)",
        "shape": {"groups": g, "k": Q_CHURN_K, "cleared": cleared},
    }
    # (e)
    vals = churn_state[0]
    keep = torch.from_numpy(rng.random(g) < 0.7).to(dev)
    new_cap = 2 * g
    new_slots = torch.randperm(new_cap, device=dev)[:g].to(torch.int32)

    def plain_rescatter():
        nv = torch.zeros((new_cap, Q_CHURN_K), dtype=vals.dtype, device=dev)
        nc = torch.zeros((new_cap, Q_CHURN_K), dtype=cnt.dtype, device=dev)
        mi._minput_rescatter_torch(vals, cnt, keep, new_slots, nv, nc)
        return nv, nc

    kv, kc = mi.minput_rescatter(vals, cnt, keep, new_slots, new_cap)
    pv, pc = plain_rescatter()
    torch.cuda.synchronize()
    check(torch.equal(kv, pv) and torch.equal(kc, pc), "Q (e) minput_rescatter")
    kept = int(keep.sum())
    del kv, kc, pv, pc
    idx, kept_v, kept_c = new_slots[keep].long(), vals[keep], cnt[keep]
    lib_v = torch.zeros((new_cap, Q_CHURN_K), dtype=vals.dtype, device=dev)
    lib_c = torch.zeros((new_cap, Q_CHURN_K), dtype=cnt.dtype, device=dev)

    def library_rescatter():
        lib_v.index_copy_(0, idx, kept_v)
        lib_c.index_copy_(0, idx, kept_c)
    e_row = {
        "name": "Q minput_rescatter", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/minput.cu",
        "replaces": "risingwave_tpu/ops/minput.py:179", "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: mi.minput_rescatter(vals, cnt, keep, new_slots, new_cap), 10),
        "plain_ms": time_ms(torch, plain_rescatter, 3),
        # keep and new_slots read; each kept row's K lanes read; the new
        # (2^21, K) lanes written whole (the wrapper zero-fills them)
        "bound_ms": bound_ms(g * 5 + kept * Q_CHURN_K * 12 + new_cap * Q_CHURN_K * 12),
        "bound_by": "bytes", "library_ms": time_ms(torch, library_rescatter, 10),
        "library_call": "index_copy_ of the kept rows' value and count lanes to their new "
                        "slots (the gather of the kept rows and the zero fill left out)",
        "shape": {"old_capacity": g, "new_capacity": new_cap, "k": Q_CHURN_K, "kept": kept},
    }
    del churn_state, work, a, b, lib_v, lib_c, kept_v, kept_c
    torch.cuda.empty_cache()
    a_row = {
        "name": "Q minput_apply", "route": "cuda", "source": "risingwave_tpu_torch/csrc/minput.cu",
        "replaces": "risingwave_tpu/ops/minput.py:65", "max_abs_err": err,
        "ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_ms(nbytes_a), "bound_by": "bytes",
        "library_ms": None, "shape": shape_a, "churn": churn,
        "latch_cases": "overflow (5 new values, K = 4) and inconsistency (a retraction of a "
                       "value never inserted): each latch equal to the plain version's",
        "compared": "per slot the multiset of (value, count), the accumulator and non-null "
                    "lanes, both latches",
    }
    return a_row, d_row, e_row, lookup_row


def kernel_lookup(torch, table, keys, valid):
    """K3 on its own: M's ``rw_lookup`` entry, the epoch path's re-probe of
    every row of q5-max's flush batch (shape (a)) into the MAX agg's
    table, against ``_lookup_torch`` on the same inputs."""
    from risingwave_tpu_torch.ops.hash_table import _lookup_torch, lookup

    got, want = lookup(table, keys, valid), _lookup_torch(table, keys, valid)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "K3 rw_lookup: slots and found vs the plain version")
    check(bool((got[0][valid] >= 0).all()), "K3 rw_lookup: every re-probed row has its slot")
    n, cap = valid.shape[0], table.capacity
    key_bytes = sum(k.element_size() for k in keys)
    lane_bytes = table.fp1.element_size() + table.fp2.element_size() + 1 + sum(
        k.element_size() for k in table.keys)
    return {
        "name": "K3 -> M rw_lookup", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/join_probe.cu",
        "replaces": "risingwave_tpu/ops/hash_table.py:232", "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: lookup(table, keys, valid), 20),
        "plain_ms": time_ms(torch, lambda: _lookup_torch(table, keys, valid), 3),
        # the probe's keys and valid read, slots and found written, the
        # table's lanes read once
        "bound_ms": bound_ms(n * (key_bytes + 1 + 4 + 1) + cap * lane_bytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"rows": n, "probed": int(valid.sum()), "capacity": cap},
    }


# -- phases 13 and 14: q5-max ----------------------------------------------------
def q5_max_oracle(oracle) -> np.ndarray:
    """(window_start, maxn) rows: per window the largest of q5_oracle's
    counts, sorted by window."""
    _, w, c = oracle
    order = np.argsort(w, kind="stable")
    ws, first = np.unique(w[order], return_index=True)
    return np.stack([ws, np.maximum.reduceat(c[order], first)], 1)


def q5_max_mv_rows(mview) -> np.ndarray:
    got = mview.to_numpy()
    check(not bool(got["maxn__null"].any()), "q5-max: no NULL maximum")
    rows = np.stack([got["window_start"], got["maxn"]], 1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def q5_max_digests(q) -> dict:
    """numpy host_digest of q5-max's three states, read back."""
    from risingwave_tpu_torch import integrity

    host = lambda lanes_live: integrity.host_digest(*integrity.host_lanes(*lanes_live))
    return {"count": host(integrity.agg_lanes(q.count_agg.table, q.count_agg.state)),
            "agg": host(integrity.agg_lanes(q.max_agg.table, q.max_agg.state)),
            "mv": host(integrity.mv_lanes(q.mview.table, q.mview.state))}


def run_q5_max(torch, dev, chunks, epoch_ts, cap: int, fused: bool):
    """q5-max over phase 4's chunks: per epoch the bid chunks, a barrier,
    then ``watermark("date_time", the epoch's largest event time)``. The
    barriers, the watermarks and the run are timed (the MV read after
    each barrier, and the digests before the last watermark, are not).
    Returns the query and a record."""
    import hashlib

    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_max
    from risingwave_tpu_torch.runtime.fused_step import FusedChainExecutor, fuse_pipeline

    q = build_q5_max(capacity=cap, max_capacity=Q5MAX_MAX_CAP, minput_k=Q5MAX_K, device=dev)
    if fused:
        wrappers = fuse_pipeline(q.pipeline, label="q5max")
        check(len(wrappers) == 1 and isinstance(wrappers[0], FusedChainExecutor)
              and wrappers[0].agg is q.max_agg and bool(q.max_agg.minput),
              "q5-max fused: one FusedChainExecutor over the MAX agg and the MV")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    rec = {"barrier_ms": [], "watermark_ms": [], "barrier_launches": [], "flush_rounds": [],
           "mv_hashes": []}
    run_s = 0.0
    for e, (per_epoch, ts) in enumerate(zip(chunks, epoch_ts)):
        t0 = time.perf_counter()
        for c in per_epoch:
            q.pipeline.push(c)
        before = dict(_kernels.LAUNCHES)
        tb = time.perf_counter()
        q.pipeline.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec["barrier_ms"].append((t1 - tb) * 1e3)
        rec["barrier_launches"].append(sum(_kernels.LAUNCHES.values()) - sum(before.values()))
        rec["flush_rounds"].append(_kernels.LAUNCHES["agg_flush"] - before["agg_flush"])
        run_s += t1 - t0
        rows = q5_max_mv_rows(q.mview)
        rec["mv_hashes"].append(hashlib.sha256(rows.tobytes()).hexdigest())
        if e == len(chunks) - 1:
            rec["digests_before_last_watermark"] = q5_max_digests(q)
            if fused:
                rec["staged"] = dict(q.pipeline.executors[1].last_digests)
        tw = time.perf_counter()
        q.pipeline.watermark("date_time", ts)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec["watermark_ms"].append((t2 - tw) * 1e3)
        run_s += t2 - tw
    rec.update(run_s=run_s, launches=dict(_kernels.LAUNCHES),
               peak=torch.cuda.max_memory_allocated(), final_rows=q5_max_mv_rows(q.mview))
    return q, rec


Q5MAX_KERNELS = ("lookup_or_insert", "agg_flush", "mv_upsert", "hop_expand", "expire_agg",
                 "minput", "minput_clear", "minput_rescatter", "slot_move")


def q5_max_checks(q, rec, oracle, what: str, epochs: int) -> None:
    got = rec["final_rows"]
    check(got.shape == oracle.shape and np.array_equal(got, oracle),
          f"{what}: MV ({len(got)} windows) vs the oracle ({len(oracle)} windows)")
    check(not bool(q.max_agg.mi_bad), f"{what}: mi_bad clear")
    launches = rec["launches"]
    for name in Q5MAX_KERNELS:
        check(launches[name] > 0, f"kernel {name} launched on {what}'s path")
    check(launches["minput_clear"] == epochs, f"{what}: Q's clear once per watermark")
    check(launches["expire_agg"] == 2 * epochs, f"{what}: O once per agg per watermark")
    check(q.max_agg.minput["maxn"][0].shape == (q.max_agg.table.capacity, Q5MAX_K),
          f"{what}: the multisets follow the MAX agg's growth")


def q5_max_row(phase, chunks, q, rec) -> dict:
    bids = sum(int(c.valid.sum()) for ep in chunks for c in ep)
    return {
        "phase": phase, "epochs": len(chunks), "events": len(chunks) * EVENTS_PER_EPOCH,
        "bids": bids, "chunk_capacity": CHUNK_EVENTS, "minput_k": Q5MAX_K,
        "bids_per_s": bids / rec["run_s"], "run_s": rec["run_s"],
        "barrier_ms_p50": float(np.percentile(rec["barrier_ms"], 50)),
        "barrier_ms_p99": float(np.percentile(rec["barrier_ms"], 99)),
        "watermark_ms_p50": float(np.percentile(rec["watermark_ms"], 50)),
        "watermark_ms_p99": float(np.percentile(rec["watermark_ms"], 99)),
        "barrier_ms": rec["barrier_ms"], "watermark_ms": rec["watermark_ms"],
        "launches_per_barrier": rec["barrier_launches"],
        "flush_rounds_per_barrier": rec["flush_rounds"],
        "capacity": {"count": q.count_agg.table.capacity, "max": q.max_agg.table.capacity,
                     "mv": q.mview.table.capacity},
        "windows": int(len(rec["final_rows"])),
        "max_memory_allocated": int(rec["peak"]), "launches": rec["launches"],
    }


def q5_max_path(torch, dev, chunks, cap, q5_oracle_rows):
    """Phase 13: q5-max interpreted over phase 4's chunks (the count agg
    sized as phase 4's, both aggs cleaned by a watermark after every
    barrier), its final MV against the numpy oracle."""
    t0 = time.perf_counter()
    epoch_ts = [max(int(c.col("date_time")[c.valid].max()) for c in ep) for ep in chunks]
    oracle = q5_max_oracle(q5_oracle_rows)
    setup_s = time.perf_counter() - t0
    q, rec = run_q5_max(torch, dev, chunks, epoch_ts, cap, fused=False)
    q5_max_checks(q, rec, oracle, "q5-max", len(chunks))
    row = q5_max_row("q5_max", chunks, q, rec)
    row.update(setup_s=setup_s, oracle="numpy: per window the largest count of q5's "
               "hop expansion: equal; mi_bad clear")
    return row, rec["launches"], (epoch_ts, q, rec, oracle)


def q5_max_fused_path(torch, dev, chunks, cap, interp):
    """Phase 14: q5-max through ``fuse_pipeline``: the hop and the count
    agg as one epoch batch (E, F, A, G), its flush interpreted (C); the
    MAX agg and the MV one program per barrier (F, A, G over the flush
    rows, the row re-probe and Q, then C -> A -> D rounds and two H),
    run under ``no_device_reads``; the watermarks outside it."""
    check_sync_guard(torch, dev)
    epoch_ts, interp_q, interp_rec, oracle = interp
    q, rec = run_q5_max(torch, dev, chunks, epoch_ts, cap, fused=True)
    q5_max_checks(q, rec, oracle, "q5-max fused", len(chunks))
    for e, (a, b) in enumerate(zip(rec["mv_hashes"], interp_rec["mv_hashes"])):
        check(a == b, f"q5-max fused: MV vs phase 13's MV at barrier {e}")
    lane = rec["digests_before_last_watermark"]
    check(rec["staged"] == {"agg": lane["agg"], "mv": lane["mv"]},
          f"q5-max fused: staged digests {rec['staged']} vs host_digest {lane}")
    check(lane == interp_rec["digests_before_last_watermark"],
          "q5-max fused: digests vs phase 13's state")
    for name in ("reduce_by_key", "apply_reduced", "state_digest", "lookup"):
        check(rec["launches"][name] > 0, f"kernel {name} launched on q5-max's fused path")
    row = q5_max_row("q5_max_fused", chunks, q, rec)
    row.update(
        digests={k: f"{v:016x}" for k, v in lane.items()},
        sync_guard="set_sync_debug_mode('error') over the program part of every barrier: held",
        oracle="numpy oracle and phase 13's MV at every barrier: equal; staged digests = "
               "host_digest of the lanes read back = host_digest of phase 13's state "
               "(before the last watermark)",
    )
    return row, rec["launches"]


def profile_q5_max(torch, dev, chunks, epoch_ts, cap, epochs: int, fused: bool):
    """Phase 13's (or, ``fused``, phase 14's) run profiled on a fresh
    q5-max over the same chunks, the watermark included in each epoch."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_max
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    q = build_q5_max(capacity=cap, max_capacity=Q5MAX_MAX_CAP, minput_k=Q5MAX_K, device=dev)
    if fused:
        fuse_pipeline(q.pipeline, label="q5max")

    def push(pipeline, ec):
        for c in ec[1]:
            pipeline.push(c)

    def after(pipeline, ec):
        pipeline.watermark("date_time", epoch_ts[ec[0]])

    row = profile_epochs(torch, "q5_max_fused_profile" if fused else "q5_max_profile",
                         q.pipeline, push, list(enumerate(chunks)), epochs, after=after)
    row["bids"] = sum(int(c.valid.sum()) for ep in chunks[1:1 + epochs] for c in ep)
    return row


# -- phase 15: q101 with a materialized MAX ------------------------------------------
Q101_MI_EPOCHS = 3


def q101_minput_path(torch, dev, host, chunks):
    """Phase 15: q101 with its right-hand MAX materialized (the planner's
    256 distinct prices per auction; at most 62 occur in these epochs),
    interpreted and then fused (the two-input program's agg side runs
    the row re-probe and Q), over the first epochs of phases 11-12's
    stream: each MV against the q101 oracle of those epochs, the fused
    MV against the interpreted one at every barrier."""
    host, chunks = host[:Q101_MI_EPOCHS], chunks[:Q101_MI_EPOCHS]
    oracle = q101_oracle_rows(host)
    rows, launches, recs = {}, {}, {}
    for fused in (False, True):
        q, rec = run_q101(torch, dev, chunks, fused=fused, materialized=True)
        what = "q101 minput fused" if fused else "q101 minput"
        check(np.array_equal(rec["final_rows"], oracle), f"{what}: MV vs the oracle")
        check(not bool(q.agg.mi_bad), f"{what}: mi_bad clear")
        check(rec["launches"]["minput"] > 0, f"kernel minput launched on {what}'s path")
        if fused:
            check(rec["launches"]["lookup"] > 0, f"{what}: the row re-probe ran")
            check(any(c.materialized for c in q.pipeline._fused.plan.right.agg.calls),
                  f"{what}: the agg side's minput")
        recs[fused] = rec
        key = "q101_minput_fused" if fused else "q101_minput"
        rows[key] = q101_row(key, host, q, rec)
        launches[key] = rec["launches"]
        del q
        torch.cuda.empty_cache()
    for e, (a, b) in enumerate(zip(recs[True]["mv_hashes"], recs[False]["mv_hashes"])):
        check(a == b, f"q101 minput fused: MV vs the interpreted MV at barrier {e}")
    return {"phase": "q101_minput", "epochs": Q101_MI_EPOCHS, "minput_k": Q5MAX_K, **rows,
            "oracle": "numpy q101 oracle of these epochs: equal, interpreted and fused; fused "
                      "= interpreted at every barrier"}, launches


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


def q5_stream(torch, dev, epochs: int) -> list:
    """The q5 stream: per epoch, 1M events generated in 65,536-event
    pieces, each piece's bids one chunk of CHUNK_EVENTS rows on the card."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=EVENT_RATE), seed=SEED)
    chunks = []
    for _ in range(epochs):
        per_epoch, done = [], 0
        while done < EVENTS_PER_EPOCH:
            n = min(CHUNK_EVENTS, EVENTS_PER_EPOCH - done)
            done += n
            bid = gen.next_chunks(n, CHUNK_EVENTS, device=dev)["bid"]
            if bid is not None:
                per_epoch.append(bid)
        chunks.append(per_epoch)
    return chunks


def main_path(torch, dev, epochs: int):
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS, build_q5_lite

    t0 = time.perf_counter()
    chunks = q5_stream(torch, dev, epochs)
    auctions, stamps = [], []
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


def profile_epochs(torch, phase: str, pipeline, push, epochs_data, epochs: int,
                   after=None) -> dict:
    """Where the time goes: one warm-up epoch, then ``epochs`` under
    ``torch.profiler``, each ``push(pipeline, epoch)``, a barrier, then
    ``after(pipeline, epoch)`` if given (q7's watermark). Wall time of
    the window, device time summed over its kernels and copies, the
    device's idle share, the host time of the pushes, barriers and
    ``after`` calls, and the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    check(len(epochs_data) > epochs, "profile: more epochs than the path ran")
    host = {"push_s": 0.0, "barrier_s": 0.0, "after_s": 0.0}

    def run(ep):
        t0 = time.perf_counter()
        push(pipeline, ep)
        t1 = time.perf_counter()
        pipeline.barrier()
        t2 = time.perf_counter()
        if after is not None:
            after(pipeline, ep)
        host["push_s"] += t1 - t0
        host["barrier_s"] += t2 - t1
        host["after_s"] += time.perf_counter() - t2

    run(epochs_data[0])
    torch.cuda.synchronize()
    host.update(push_s=0.0, barrier_s=0.0, after_s=0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ep in epochs_data[1 : 1 + epochs]:
            run(ep)
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
        "phase": phase, "epochs": epochs,
        "wall_ms": wall_s * 1e3,
        "device_ms": device_ms if measured else "not measured",
        "device_idle_share": 1 - device_ms / (wall_s * 1e3) if measured else "not measured",
        "host_push_ms": host["push_s"] * 1e3, "host_barrier_ms": host["barrier_s"] * 1e3,
        "host_after_barrier_ms": host["after_s"] * 1e3,
        "device_ms_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15]),
    }


def profile_q5(torch, dev, chunks, cap, epochs: int, fused: bool):
    """Phase 4's (or, ``fused``, phase 6's) run profiled on a fresh
    q5-lite over the same chunks."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    q5 = build_q5_lite(capacity=cap, state_cleaning=False, device=dev)
    if fused:
        fuse_pipeline(q5.pipeline, label="q5")

    def push(pipeline, per_epoch):
        for c in per_epoch:
            pipeline.push(c)

    row = profile_epochs(torch, "q5_fused_profile" if fused else "q5_profile", q5.pipeline, push,
                         chunks, epochs)
    row["bids"] = sum(int(c.valid.sum()) for ep in chunks[1 : 1 + epochs] for c in ep)
    return row


def profile_q8(torch, dev, chunks, epochs: int, fused: bool):
    """Phase 7's (or, ``fused``, phase 8's) run profiled on a fresh q8
    over the same chunks."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q8
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    q8 = build_q8(capacity=Q8_CAP, fanout=Q8_FANOUT, out_cap=Q8_OUT_CAP, device=dev)
    if fused:
        fuse_pipeline(q8.pipeline, label="q8")

    def push(pipeline, pa):
        pipeline.push_left(pa[0])
        pipeline.push_right(pa[1])

    row = profile_epochs(torch, "q8_fused_profile" if fused else "q8_profile", q8.pipeline, push,
                         chunks, epochs)
    row["rows"] = sum(int(p.valid.sum()) + int(a.valid.sum()) for p, a in chunks[1 : 1 + epochs])
    return row


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


# -- phase 3, kernel R (checkpoint staging and restore) ------------------------
R_Q5_LIVE = 3_000_000  # live groups of q5's agg at 2^24 slots (phase 4's mean)
R_JOIN_CAP = Q8_CAP
R_JOIN_KEYS = 1_200_000  # keys of a q8 join side late in phase 7
R_MAX_CAP = 1 << 14  # q5-max's MAX agg after its first barrier
R_MAX_LIVE = 60  # about 54 windows live at a barrier (phase 13)


def r_lanes_q5(torch, dev, g):
    """q5's agg at 2^24 slots: 3M live groups, a third of them sdirty,
    two thirds stored, 100,000 stored dead groups sdirty (tombstones)."""
    cap = TABLE_CAP
    perm = torch.randperm(cap, device=dev, generator=g)
    live_i, tomb_i = perm[:R_Q5_LIVE], perm[R_Q5_LIVE:R_Q5_LIVE + 100_000]
    z = lambda: torch.zeros(cap, dtype=torch.bool, device=dev)
    live, sdirty, stored, ev, dirty = z(), z(), z(), z(), z()
    live[live_i] = True
    sdirty[live_i[: R_Q5_LIVE // 3]] = True
    stored[live_i[R_Q5_LIVE // 3:]] = True
    ev[live_i] = True
    sdirty[tomb_i] = True
    stored[tomb_i] = True
    ri = lambda lo, hi: torch.randint(lo, hi, (cap,), device=dev, generator=g)
    lanes = {"k0": ri(1000, 2_000_000), "k1": ri(0, 1 << 40), "row_count": ri(0, 50),
             "acc_num": ri(0, 50), "em_num": ri(0, 50), "ev": ev}
    return lanes, sdirty, (live, ev, dirty), stored, None


def r_lanes_join(torch, dev, g):
    """A q8 join side (2^23, 8) with degrees: 1.2M keys, a third sdirty,
    another 10% with moved degrees only (ddirty), 50,000 tombstones."""
    cap, f = R_JOIN_CAP, Q8_FANOUT
    perm = torch.randperm(cap, device=dev, generator=g)
    n = R_JOIN_KEYS
    live_i, tomb_i = perm[:n], perm[n:n + 50_000]
    z = lambda: torch.zeros(cap, dtype=torch.bool, device=dev)
    live, sdirty, stored, ddirty = z(), z(), z(), z()
    live[live_i] = True
    sdirty[live_i[: n // 3]] = True
    ddirty[live_i[n // 3: n // 3 + n // 10]] = True
    stored[live_i[n // 3:]] = True
    sdirty[tomb_i] = True
    stored[tomb_i] = True
    r2 = lambda hi, dt: torch.randint(0, hi, (cap, f), device=dev, generator=g).to(dt)
    lanes = {"k0": torch.randint(0, 1 << 40, (cap,), device=dev, generator=g),
             "rv": r2(2, torch.bool), "deg": r2(4, torch.int32),
             "r_date_time": r2(1 << 40, torch.int64), "r_id": r2(1 << 40, torch.int64),
             "r_name": r2(1 << 20, torch.int32)}
    return lanes, sdirty, (live,), stored, ddirty


def r_lanes_max(torch, dev, g):
    """q5-max's MAX agg: (2^14, 256) multisets, 60 live windows, all
    sdirty, and 20 stored windows closed by a watermark (tombstones)."""
    cap, k = R_MAX_CAP, Q5MAX_K
    perm = torch.randperm(cap, device=dev, generator=g)
    live_i, tomb_i = perm[:R_MAX_LIVE], perm[R_MAX_LIVE:R_MAX_LIVE + 20]
    z = lambda: torch.zeros(cap, dtype=torch.bool, device=dev)
    live, sdirty, stored, ev, dirty = z(), z(), z(), z(), z()
    live[live_i] = True
    ev[live_i] = True
    sdirty[live_i] = True
    sdirty[tomb_i] = True
    stored[tomb_i] = True
    ri = lambda lo, hi, shape=(cap,): torch.randint(lo, hi, shape, device=dev, generator=g)
    lanes = {"k0": ri(0, 1 << 40), "row_count": ri(0, 500), "acc_maxn": ri(0, 60),
             "em_maxn": ri(0, 60), "nn_maxn": ri(0, 500), "ei_maxn": ri(0, 2).to(torch.bool),
             "miv_maxn": ri(0, 60, (cap, k)), "mic_maxn": ri(0, 9, (cap, k)).to(torch.int32),
             "ev": ev}
    return lanes, sdirty, (live, ev, dirty), stored, None


def _plain_mark(marks, idx, tomb) -> None:
    """The mark's plain version (and the library call): ``stored[sel] =
    ~tomb`` by index_put_, then every dirty lane zeroed."""
    marks[0][idx] = ~tomb
    for t in marks[1:]:
        t.zero_()


def row_bytes(lanes) -> int:
    return sum(a[0].numel() * a.element_size() for a in lanes.values())


def r_shape(torch, dev, name, made, times: bool) -> dict:
    """R's four entries against their plain versions on one shape:
    select, gather (every lane and the tomb, one copy), mark and a
    scatter of the gathered rows to fresh slots; with ``times`` each
    entry's device time, its plain version's and the library call's."""
    from risingwave_tpu_torch.ops import checkpoint as ck

    lanes, sdirty, alive, stored, ddirty = made
    cap = sdirty.shape[0]
    sel, tomb, n, n_dirty = ck.stage_select(sdirty, alive, stored, ddirty)
    p_sel, p_tomb, p_n, p_dirty = ck._stage_select_torch(sdirty, alive, stored, ddirty)
    torch.cuda.synchronize()
    check((n, n_dirty) == (p_n, p_dirty) and torch.equal(sel, p_sel)
          and torch.equal(tomb, p_tomb), f"R {name}: select vs plain")
    got = ck.gather_rows(lanes, sel, {"tombstone": tomb})
    idx = p_sel.long()
    for k, a in lanes.items():
        check(np.array_equal(got[k], a[idx].cpu().numpy()), f"R {name}: gather of {k}")
    check(np.array_equal(got["tombstone"], p_tomb.cpu().numpy()), f"R {name}: gathered tomb")
    dirt = () if ddirty is None else (ddirty,)
    marks = [t.clone() for t in (stored, sdirty, *dirt)]
    work = [t.clone() for t in marks]
    ck.mark_checkpointed(*work[:2], sel, tomb, *work[2:])
    plain = [t.clone() for t in marks]
    plain[0][idx] = ~p_tomb
    for t in plain[1:]:
        t.zero_()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(work, plain)), f"R {name}: mark vs plain")
    slots = torch.randperm(cap, device=dev)[:n].to(torch.int32)
    rows = {k: got[k] for k in lanes}
    fresh = lambda: {k: torch.zeros_like(a) for k, a in lanes.items()}
    k_dst, p_dst = fresh(), fresh()
    ck.scatter_rows(k_dst, slots, rows)
    rows_dev = {k: torch.from_numpy(np.ascontiguousarray(r)).to(dev) for k, r in rows.items()}
    sidx = slots.long()
    for k, a in p_dst.items():
        a[sidx] = rows_dev[k]
    torch.cuda.synchronize()
    check(all(torch.equal(k_dst[k], p_dst[k]) for k in lanes), f"R {name}: scatter vs plain")
    shape = {"capacity": cap, "selected": n, "dirty": n_dirty, "tombstones": int(p_tomb.sum()),
             "lanes": len(lanes), "row_bytes": row_bytes(lanes),
             "fanout_or_k": max(a[0].numel() for a in lanes.values())}
    out = {"shape": shape}
    if not times or n == 0:
        return out
    every = {**lanes, "tombstone": tomb}
    n_sel_lanes = 2 + len(alive) + len(dirt)
    mask = torch.zeros_like(sdirty)
    mask[idx] = True
    packed, layout = ck._gather_packed(every, sel, {"tombstone"})
    host = torch.empty(packed.shape[0], dtype=torch.uint8, pin_memory=True)
    staged, s_layout = ck._pack_host(lanes, rows, n)
    s_packed = staged.to(dev)
    restore = lambda: [a.copy_(b) for a, b in zip(work, marks)]
    rb = row_bytes(lanes)
    out.update({
        "select": {
            "ms": time_ms(torch, lambda: ck._stage_select_launch(sdirty, alive, stored, ddirty),
                          20),
            "plain_ms": time_ms(torch, lambda: ck._stage_select_torch(sdirty, alive, stored,
                                                                      ddirty), 3),
            "library_ms": time_ms(torch, lambda: torch.nonzero(mask), 20),
            "bound_ms": bound_ms(cap * n_sel_lanes + n * 5 + 16),
        },
        "gather": {
            "ms": time_ms(torch, lambda: ck._gather_packed(every, sel, {"tombstone"}), 20),
            "copy_ms": time_ms(torch, lambda: host.copy_(packed, non_blocking=True), 20),
            "packed_bytes": int(packed.shape[0]),
            "with_copy_ms": time_ms(torch, lambda: ck.gather_rows(lanes, sel,
                                                                  {"tombstone": tomb}), 10),
            "plain_ms": time_ms(torch, lambda: [a[idx] for a in lanes.values()], 10),
            "library_ms": time_ms(torch, lambda: [torch.index_select(a, 0, idx).cpu()
                                                  for a in lanes.values()], 5),
            "bound_ms": bound_ms(n * (2 * rb + 4 + 2)),
        },
        "mark": {
            "ms": time_ms(torch, lambda: ck.mark_checkpointed(*work[:2], sel, tomb, *work[2:]),
                          20, restore),
            "plain_ms": time_ms(torch, lambda: _plain_mark(work, idx, p_tomb), 20, restore),
            "library_ms": time_ms(torch, lambda: _plain_mark(work, idx, p_tomb), 20, restore),
            "bound_ms": bound_ms(n * (4 + 1 + 1) + cap * (1 + len(dirt))),
        },
        "scatter": {
            "ms": time_ms(torch, lambda: ck._scatter_packed(k_dst, slots, s_packed, s_layout),
                          20),
            "copy_ms": time_ms(torch, lambda: staged.to(dev, non_blocking=True), 20),
            "plain_ms": time_ms(torch, lambda: [p_dst[k].__setitem__(sidx, rows_dev[k])
                                                for k in lanes], 10),
            "library_ms": time_ms(torch, lambda: [p_dst[k].index_put_((sidx,), rows_dev[k])
                                                  for k in lanes], 10),
            "bound_ms": bound_ms(n * (2 * rb + 4)),
        },
    })
    return out


def pcie_rates(torch, dev, nbytes: int = 1 << 28) -> dict:
    """The host link's measured rate: one pinned copy of 256 MiB each way."""
    dev_buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d2h = time_ms(torch, lambda: host.copy_(dev_buf, non_blocking=True), 5)
    h2d = time_ms(torch, lambda: dev_buf.copy_(host, non_blocking=True), 5)
    return {"bytes": nbytes, "d2h_ms": d2h, "h2d_ms": h2d,
            "d2h_gb_per_s": nbytes / d2h / 1e6, "h2d_gb_per_s": nbytes / h2d / 1e6}


def kernel_r(torch, dev):
    """R against its plain version on the card (phase 3): q5's agg at
    2^24 slots (3M live, a third sdirty, tombstones), a q8 join side
    (2^23, 8) with degrees and moved-degree marks, q5-max's MAX agg with
    its (2^14, 256) multisets, and an empty selection (no sdirty slot).
    Returns the four entries' rows (times on q5's agg) and the shapes."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    shapes = {}
    for name, make in (("q5_agg", r_lanes_q5), ("join_side", r_lanes_join),
                       ("q5max_agg", r_lanes_max)):
        shapes[name] = r_shape(torch, dev, name, make(torch, dev, g), True)
        torch.cuda.empty_cache()
    lanes, sdirty, alive, stored, _ = r_lanes_q5(torch, dev, g)
    empty = r_shape(torch, dev, "empty", (lanes, torch.zeros_like(sdirty), alive, stored, None),
                    False)
    check(empty["shape"]["selected"] == 0 and empty["shape"]["dirty"] == 0, "R: empty select")
    shapes["empty_sel"] = empty
    del lanes, sdirty, alive, stored
    torch.cuda.empty_cache()
    pcie = pcie_rates(torch, dev)
    main = shapes["q5_agg"]
    base = {"route": "cuda", "source": "risingwave_tpu_torch/csrc/checkpoint.cu",
            "max_abs_err": 0.0, "bound_by": "bytes"}
    other = lambda entry: {k: v[entry] for k, v in shapes.items() if entry in v}
    rows = []
    for entry, name, replaces, lib in (
        ("select", "R stage_select", "risingwave_tpu/storage/state_table.py:102 (stage_marks; "
         "the marks executors/hash_agg.py:1289-1297 pulls)", "torch.nonzero of the mask"),
        ("gather", "R gather_rows (K32)", "risingwave_tpu/storage/state_table.py:165",
         "per-lane index_select followed by .cpu()"),
        ("mark", "R mark_checkpointed (K30)", "risingwave_tpu/executors/hash_agg.py:1262, "
         "executors/hash_join.py:893", "stored[sel] = ~tomb plus the dirty lanes' zero_()"),
        ("scatter", "R scatter_rows", "risingwave_tpu/executors/hash_agg.py:1367-1403 (the "
         "restores' .at[slots].set; the port's own entry)", "per-lane index_put_"),
    ):
        t = main[entry]
        rows.append({**base, "name": name, "replaces": replaces, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "library_ms": t["library_ms"], "library_call": lib,
                     "shapes": {k: v["shape"] for k, v in shapes.items()},
                     "by_shape": other(entry), "pcie": pcie})
    return rows


# -- phase 16: kill and recover ------------------------------------------------
KILL_EPOCHS = 10  # of each query's stream (the tables keep phases 4-14's sizes)
KILL_AT = 6  # commits after barriers 1-6, then the kill
# the kills of q19 and the window paths (p29-p31), cut for the script's
# time limit
WIN_KILL_EPOCHS, WIN_KILL_AT = 5, 3
R_ENTRIES = ("checkpoint", "gather_rows", "mark_checkpointed", "scatter_rows")


def packed_side_digest(side) -> int:
    """host_digest of a join side with every bucket's live entries packed
    to the front: its content without bucket positions (a ``regrow``
    packs the entries it moves)."""
    from risingwave_tpu_torch import integrity

    lanes, live = integrity.host_lanes(*integrity.join_side_lanes(side))
    order = np.argsort(~lanes["rv"], axis=1, kind="stable")
    packed = {k: np.take_along_axis(v, order, 1) if v.shape == lanes["rv"].shape else v
              for k, v in lanes.items()}
    return integrity.host_digest(packed, live)


def device_digests(pipeline) -> dict:
    """Kernel H's digest of every Checkpointable executor's state (a join
    per side; an executor with host state, its host digest), by table
    id."""
    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.runtime.fused_step import expand_fused

    out = {}
    for ex in expand_fused(pipeline.executors):
        if not hasattr(ex, "checkpoint_delta"):
            continue
        if hasattr(ex, "join_type"):
            for tid, side in zip(ex.checkpoint_table_ids(), (ex.left, ex.right)):
                out[tid] = integrity.digest_from_scalar(
                    integrity.device_digest(*integrity.join_side_lanes(side)))
        elif not hasattr(ex, "digest_lanes"):  # host state (RowIdGen's counter)
            out[ex.table_id] = ex.state_digest()
        else:
            out[ex.table_id] = integrity.digest_from_scalar(
                integrity.device_digest(*ex.digest_lanes()))
    return out


def same_state(a, b, what: str, skip=()) -> str:
    """Every table's digest equal but those of ``skip``; a join side that
    only one run rebuilt may differ in bucket positions alone, and then
    its packed digest must be equal. Returns how the joins compared."""
    from risingwave_tpu_torch.runtime.fused_step import expand_fused

    da, db = device_digests(a.pipeline), device_digests(b.pipeline)
    how = "digest"
    for tid in da:
        if da[tid] == db[tid] or tid in skip:
            continue
        sides = {}
        for q in (a, b):
            for ex in expand_fused(q.pipeline.executors):
                if hasattr(ex, "join_type") and tid in ex.checkpoint_table_ids():
                    side = ex.left if tid.endswith(".left") else ex.right
                    sides.setdefault(tid, []).append(packed_side_digest(side))
        check(tid in sides and sides[tid][0] == sides[tid][1], f"{what}: table {tid}")
        how = "digest (joins rebuilt in one run only: packed digest)"
    return how


class KillSpec:
    """One query of phase 16: ``build()`` a fresh query at its phase's
    sizes, ``drive(q, e)`` epoch e (pushes, barrier, watermark),
    ``mv_rows(q)`` its MV as sorted rows, ``oracle`` those rows after
    KILL_EPOCHS epochs, ``refuse``: also recover into a fused run;
    ``tie_tables``: tables whose state orders ties by arrival, which two
    runs may order apart (compared by ``mv_rows`` alone across runs);
    ``rows_each_barrier``: read the MV rows back at every barrier after
    the kill, or (an MV of millions of rows, its kernel-H digest already
    compared there) only at the end."""

    def __init__(self, name, build, drive, mv_rows, oracle, refuse=False, tie_tables=(),
                 rows_each_barrier=True, depth=None):
        self.name, self.build, self.drive, self.mv_rows = name, build, drive, mv_rows
        self.oracle, self.refuse, self.tie_tables = oracle, refuse, tuple(tie_tables)
        self.rows_each_barrier = rows_each_barrier
        # (epochs, kill after barrier), KILL_EPOCHS and KILL_AT unless given
        self.depth = depth


def timed_commit(torch, mgr, epoch, executors, rec) -> None:
    """``commit_epoch`` in its parts: stage (kernel R's select, gather, one
    copy and mark), then the SST build and put with the manifest, then
    any compaction it owes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = mgr.stage(executors)
    t1 = time.perf_counter()
    mgr.commit_staged(epoch, staged)
    for tid in mgr.tables_needing_compaction():
        mgr.compact_once(tid, epoch)
    t2 = time.perf_counter()
    rec["stage_ms"].append((t1 - t0) * 1e3)
    rec["sst_ms"].append((t2 - t1) * 1e3)
    rec["commit_ms"].append((t2 - t0) * 1e3)
    rec["rows"].append(sum(len(d.tombstone) for d in staged))
    rec["bytes"].append(sum(a.nbytes for d in staged for part in (d.key_cols, d.value_cols)
                            for a in part.values()) + sum(d.tombstone.nbytes for d in staged))


def timed_recover(torch, store_dir, q) -> dict:
    """``recover`` into a fresh query, its seconds split into the store
    read (SST reads and merges) and the restore (kernels A and R)."""
    from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore
    from risingwave_tpu_torch.runtime.fused_step import expand_fused

    mgr = CheckpointManager(LocalFsObjectStore(store_dir))
    read_s = [0.0]
    read = mgr.read_table

    def timed_read(table_id):
        t = time.perf_counter()
        out = read(table_id)
        read_s[0] += time.perf_counter() - t
        return out

    mgr.read_table = timed_read
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.recover(expand_fused(q.pipeline.executors))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return {"recover_s": total, "read_s": read_s[0], "restore_s": total - read_s[0],
            "epoch": mgr.max_committed_epoch}


def kill_and_recover(torch, dev, spec: KillSpec):
    """Phase 16 for one query: runs A (committing after every barrier into
    a LocalFsObjectStore) and B (uninterrupted) side by side; at barrier
    KILL_AT every object of A goes and the cache empties; a fresh A'
    recovers (with ``refuse``, a second one, A'', recovers and re-fuses)
    and must equal A's pre-kill MV and digests; A', A'' and B then run
    the remaining epochs, their MVs and digests equal at every barrier,
    and equal to the oracle at the end."""
    import gc
    import shutil
    import tempfile

    epochs, kill_at = spec.depth or (KILL_EPOCHS, KILL_AT)
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore
    from risingwave_tpu_torch.runtime.fused_step import expand_fused, fuse_pipeline

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    store_dir = tempfile.mkdtemp(prefix="rw_ckpt_")
    try:
        a, b = spec.build(), spec.build()
        mgr = CheckpointManager(LocalFsObjectStore(store_dir))
        rec = {"stage_ms": [], "sst_ms": [], "commit_ms": [], "rows": [], "bytes": []}
        for e in range(kill_at):
            spec.drive(a, e)
            spec.drive(b, e)
            timed_commit(torch, mgr, a.pipeline.epoch, expand_fused(a.pipeline.executors), rec)
        pre = device_digests(a.pipeline)
        pre_mv = spec.mv_rows(a)
        same_state(a, b, f"{spec.name}: A vs B before the kill", spec.tie_tables)
        del a, mgr
        gc.collect()
        torch.cuda.empty_cache()
        a2 = spec.build()
        rec_a2 = timed_recover(torch, store_dir, a2)
        check(np.array_equal(spec.mv_rows(a2), pre_mv), f"{spec.name}: recovered MV = pre-kill")
        check(device_digests(a2.pipeline) == pre, f"{spec.name}: recovered digests = pre-kill")
        runs = [a2]
        if spec.refuse:
            a3 = spec.build()
            CheckpointManager(LocalFsObjectStore(store_dir)).recover(
                expand_fused(a3.pipeline.executors))
            check(len(fuse_pipeline(a3.pipeline, label=spec.name)) == 1,
                  f"{spec.name}: the recovered pipeline re-fuses into one program")
            check(device_digests(a3.pipeline) == pre, f"{spec.name}: fused recovery's digests")
            runs.append(a3)
        joins = set()
        for e in range(kill_at, epochs):
            for q in (*runs, b):
                spec.drive(q, e)
            last = e == epochs - 1
            mv_b = spec.mv_rows(b) if spec.rows_each_barrier or last else None
            for i, q in enumerate(runs):
                what = f"{spec.name} barrier {e + 1} {'fused ' if i else ''}recovered vs B"
                if mv_b is not None:
                    check(np.array_equal(spec.mv_rows(q), mv_b), f"{what}: MV")
                joins.add(same_state(q, b, what, spec.tie_tables))
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(mv_b.shape == spec.oracle.shape and np.array_equal(mv_b, spec.oracle),
              f"{spec.name}: B's MV vs the oracle")
        for k in R_ENTRIES:
            check(launches[k] > 0, f"{spec.name}: kernel R's {k} launched")
        pct = lambda xs, p: float(np.percentile(xs, p))
        return {
            "phase": "16", "query": spec.name, "epochs": epochs, "kill_after_barrier": kill_at,
            "commit_ms_p50": pct(rec["commit_ms"], 50), "commit_ms_p99": pct(rec["commit_ms"], 99),
            "stage_ms_p50": pct(rec["stage_ms"], 50), "stage_ms_p99": pct(rec["stage_ms"], 99),
            "sst_put_ms_p50": pct(rec["sst_ms"], 50), "sst_put_ms_p99": pct(rec["sst_ms"], 99),
            "commit_ms": rec["commit_ms"], "stage_ms": rec["stage_ms"], "sst_put_ms": rec["sst_ms"],
            "rows_staged": rec["rows"], "bytes_staged": rec["bytes"], **rec_a2,
            "refused": spec.refuse, "compared": sorted(joins), "mv_rows": int(len(mv_b)),
            "max_memory_allocated": int(peak), "launches": launches,
            "checks": "recovered MV and every table's kernel-H digest = pre-kill; recovered "
                      "runs = the uninterrupted run at every barrier (MV, digests); MV = "
                      "oracle at the end",
        }, launches
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def q5_epochs_oracle(ep):
    """q5's numpy oracle over the epochs ``ep`` of phase 4's chunks."""
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS

    lane = lambda name: np.concatenate([c.col(name)[c.valid].cpu().numpy() for e in ep for c in e])
    return q5_oracle(lane("auction"), lane("date_time"), Q5_WINDOW_MS, Q5_SLIDE_MS)


def kill_q5(torch, dev, chunks, cap):
    """Phase 16's q5: phase 4's first KILL_EPOCHS epochs, tables of phase
    4's sizes; also recovered into a fused run."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite

    ep = chunks[:KILL_EPOCHS]
    oracle = q5_epochs_oracle(ep)

    def drive(q, e):
        for c in ep[e]:
            q.pipeline.push(c)
        q.pipeline.barrier()

    def rows(q):
        got = mv_rows_sorted(q.mview)
        return np.stack([got["auction"], got["window_start"], got["num"]], 1)

    spec = KillSpec("q5", lambda: build_q5_lite(capacity=cap, state_cleaning=False, device=dev),
                    drive, rows, np.stack(oracle, 1), refuse=True)
    return kill_and_recover(torch, dev, spec), oracle


def kill_q5_max(torch, dev, chunks, cap, q5_oracle10):
    """Phase 16's q5-max: phase 4's first KILL_EPOCHS epochs with a
    watermark after every barrier, phase 13's sizes."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_max

    ep = chunks[:KILL_EPOCHS]
    ts = [max(int(c.col("date_time")[c.valid].max()) for c in e) for e in ep]

    def drive(q, e):
        for c in ep[e]:
            q.pipeline.push(c)
        q.pipeline.barrier()
        q.pipeline.watermark("date_time", ts[e])

    spec = KillSpec("q5_max", lambda: build_q5_max(capacity=cap, max_capacity=Q5MAX_MAX_CAP,
                                                   minput_k=Q5MAX_K, device=dev),
                    drive, lambda q: q5_max_mv_rows(q.mview), q5_max_oracle(q5_oracle10))
    return kill_and_recover(torch, dev, spec)


def kill_q8(torch, dev, host, chunks):
    """Phase 16's q8: phase 7's first KILL_EPOCHS epochs and sizes; also
    recovered into a fused run."""
    from risingwave_tpu_torch.queries.nexmark_q import Q8_WINDOW_MS, build_q8

    def drive(q, e):
        p, a = chunks[e]
        q.pipeline.push_left(p)
        q.pipeline.push_right(a)
        q.pipeline.barrier()

    spec = KillSpec("q8", lambda: build_q8(capacity=Q8_CAP, fanout=Q8_FANOUT, out_cap=Q8_OUT_CAP,
                                           device=dev),
                    drive, lambda q: q8_mv_rows(q.mview),
                    oracle_rows(cpu_actor_q8(host[:KILL_EPOCHS], Q8_WINDOW_MS)), refuse=True)
    return kill_and_recover(torch, dev, spec)


def kill_q7(torch, dev, host, chunks):
    """Phase 16's q7: phase 9's first KILL_EPOCHS epochs and sizes, the
    watermark after every barrier."""
    from risingwave_tpu_torch.queries.nexmark_q import Q7_WINDOW_MS, build_q7

    ts = np.maximum.accumulate([max(int(c["date_time"].max()) for c in h)
                                for h in host[:KILL_EPOCHS]]).tolist()

    def drive(q, e):
        for c in chunks[e]:
            q.pipeline.push_left(c)
            q.pipeline.push_right(c)
        q.pipeline.barrier()
        q.pipeline.watermark("date_time", ts[e])

    spec = KillSpec("q7", lambda: build_q7(capacity=Q7_CAP, fanout=Q7_FANOUT, out_cap=Q7_OUT_CAP,
                                           agg_capacity=Q7_CAP, filter_capacity=Q7_CAP,
                                           device=dev),
                    drive, lambda q: q7_mv_rows(q.mview),
                    q7_oracle_rows([c for h in host[:KILL_EPOCHS] for c in h], Q7_WINDOW_MS))
    return kill_and_recover(torch, dev, spec)


def kill_q101(torch, dev, host, chunks):
    """Phase 16's q101: phase 11's first KILL_EPOCHS epochs and sizes."""

    def drive(q, e):
        a, bids = chunks[e]
        q.pipeline.push_left(a)
        for b in bids:
            q.pipeline.push_right(b)
        q.pipeline.barrier()

    spec = KillSpec("q101", lambda: Q101(torch, dev), drive, lambda q: q101_mv_rows(q.mview),
                    q101_oracle_rows(host[:KILL_EPOCHS]))
    return kill_and_recover(torch, dev, spec)


# -- phase 3, kernels S and T; phases 17-20: expressions and the stateless operators
S_ROWS = 1 << 20  # the expression battery's rows
S_GROUP = 10  # battery trees per compiled projection
S_ULPS = 4  # transcendental tolerance: ulp of max(|x|, 1)
Q1_Q2_MV_FLOOR = 1 << 16
HOT_AGG_CAP = 1 << 22  # q103's subquery: about 1.2M auctions over 20M events
HOT_MV_CAP = 1 << 22
HOT_SHARED = 25  # a second >= threshold: shares >= 20's fused program
Q103_CAP = 1 << 22  # agg, join sides (with Q103_FANOUT) and MV, as phases 11-12
Q103_FANOUT = 4
Q103_OUT_CAP = 1 << 17
Q7_SCAN_LAG_MS = 1000  # tests/test_watermark_filter.py's lag
Q7_SCAN_EPOCHS = EPOCHS  # the first to cut should the script near its limit


class PathLaunches:
    """Kernel launches per path when several paths run in lockstep: each
    call's launches are the counts' difference across it."""

    def __init__(self):
        self.by = {}

    def run(self, path: str, fn, *args):
        from risingwave_tpu_torch import _kernels

        before = dict(_kernels.LAUNCHES)
        out = fn(*args)
        acc = self.by.setdefault(path, {k: 0 for k in _kernels.LAUNCHES})
        for k, v in _kernels.LAUNCHES.items():
            acc[k] += v - before.get(k, 0)
        return out


def s_chunk(torch, dev, rng, n: int):
    """Bid-shaped lanes (auction, bidder, price, channel, date_time) and
    extra int32, int64, float64, float32, bool and timestamp lanes, with
    seeded NULL lanes, as one StreamChunk on the card."""
    from risingwave_tpu_torch.array.chunk import StreamChunk

    f = (rng.standard_normal(n) * 3).round(2)
    f[:6] = [0.0, -0.0, 1.0, -2.5, 2.5, 0.5]
    cols = {
        "auction": rng.integers(1000, 1_200_000, n).astype(np.int64),
        "bidder": rng.integers(1000, 400_000, n).astype(np.int64),
        "price": rng.integers(1, 10**7, n).astype(np.int64),
        "channel": rng.integers(0, 4, n).astype(np.int32),
        "date_time": 1_436_918_400_000 + np.sort(rng.integers(0, 2 * 10**9, n)),
        "b": rng.integers(-6, 7, n).astype(np.int32),  # zeros: division by zero
        "c": rng.integers(-10**6, 10**6, n).astype(np.int64),
        "f": f,
        "g": (rng.standard_normal(n) * 2).astype(np.float32),
        "p": rng.random(n) < 0.5,
        "ts": rng.integers(-2_208_988_800_000, 4_102_444_800_000, n).astype(np.int64),
    }
    nulls = {k: rng.random(n) < 0.2 for k in ("bidder", "b", "f", "p")}
    return StreamChunk.from_numpy(cols, n, nulls=nulls, device=dev)


def s_battery(dictionary):
    """(name, tree, transcendental) reaching every opcode of kernel S."""
    from risingwave_tpu_torch.expr import expr as E
    from risingwave_tpu_torch.expr import functions as F

    col, lit, B, Fn = E.col, E.lit, E.BinOp, F.Func
    a, bd, pr, b, c, f, g, p, ts = (col(n) for n in ("auction", "bidder", "price", "b", "c", "f",
                                                      "g", "p", "ts"))
    out = [
        ("q1_price", lit(0.908) * pr, False), ("a+b", a + b, False), ("b+5", b + 5, False),
        ("b*b*b", b * b * b * b * b * b * b * b * b * b * b * b, False), ("c*c", c * c * c * c, False),
        ("a-c", a - c, False), ("f*g", f * g, False), ("g*0.5", g * 0.5, False),
        ("f+1", f + 1, False), ("p+p", p + p, False), ("p*p", p * p, False),
        ("a//b", a // b, False), ("a%b", a % b, False), ("b//2", b // 2, False),
        ("a/b", B("/", a, b), False), ("b/b", B("/", b, b), False), ("f//g", f // g, False),
        ("f%g", f % g, False), ("g//2.5", g // 2.5, False), ("f/f", B("/", f, f), False),
        ("a//0", a // 0, False), ("g%b", g % b, False), ("p//p", B("//", p, p), False),
        ("a<b", a < b, False), ("f>=g", f >= g, False), ("b==3", b == 3, False),
        ("f!=f", f != f, False), ("g>0.5", g > 0.5, False), ("bd<=c", bd <= c, False),
        ("and", (a > 600_000) & (b < 0), False), ("or", (bd > 200_000) | (b < 0), False),
        ("not", E.Not(p), False), ("and_p", E.And(p, f > 0), False),
        ("or_p", E.Or(p, E.Not(p)), False), ("and_int", E.And(b, c), False),
        ("isnull", E.IsNull(b), False), ("notnull", E.IsNull(f, True), False),
        ("isnull_lit", E.IsNull(lit(None)), False), ("between", E.Between(a, b, c), False),
        ("between_f", E.Between(f, lit(-1.0), lit(1.0)), False),
        ("in", E.InList(b, (1, 2, 3)), False), ("in_f", E.InList(f, (0.5, 2)), False),
        ("in_empty", E.InList(a, ()), False),
        ("case", E.Case(((b > 0, f), (b < 0, g)), lit(None)), False),
        ("case_b", E.Case(((p, lit(1)),), b), False),
        ("coalesce", F.Coalesce((b, c)), False), ("coalesce3", F.Coalesce((f, g, lit(0.0))), False),
        ("nullif", F.NullIf(b, lit(3)), False), ("nullif2", F.NullIf(bd, c), False),
        ("cast_i32", E.Cast(f * 1e9, np.int32), False), ("cast_i64", E.Cast(f, np.int64), False),
        ("cast_f32", E.Cast(a, np.float32), False), ("cast_bool", E.Cast(b, np.bool_), False),
        ("cast_f64_f32", E.Cast(f, np.float32), False), ("cast_nan", E.Cast(
            B("/", f, f) * 1e300 * 1e300, np.int64), False),
        ("tumble", E.TumbleStart(col("date_time"), 10_000), False),
        ("tumble_b", E.TumbleStart(b, 7), False), ("assume", E.AssumeNotNull(b), False),
        ("null", lit(None), False), ("lit_np", lit(np.int32(4)) + b, False),
    ]
    out += [(f"extract_{x}", F.Extract(x, ts), False) for x in (
        "epoch", "millisecond", "second", "minute", "hour", "day", "month", "year", "dow", "doy")]
    out += [(f"trunc_{x}", F.DateTrunc(x, ts), False) for x in (
        "second", "minute", "hour", "day", "week", "month", "year")]
    fns = [
        ("abs", (c,), False), ("abs", (f,), False), ("sign", (f,), False), ("sign", (b,), False),
        ("ceil", (f,), False), ("floor", (g,), False), ("round", (f,), False),
        ("round", (f, lit(1)), True), ("round", (g, lit(1)), True), ("round", (a, b), False),
        ("trunc", (f,), False), ("trunc", (f, lit(2)), True), ("mod", (a, b), False),
        ("mod", (f, g), False), ("mod", (a, lit(123)), False), ("pow", (f, lit(2)), True),
        ("power", (g, b), True), ("sqrt", (f,), True), ("exp", (f,), True), ("ln", (f,), True),
        ("log10", (f,), True), ("cbrt", (f,), True), ("log2", (g,), True), ("sin", (f,), True),
        ("cos", (f,), True), ("tan", (f,), True), ("cot", (f,), True),
        ("asin", (B("/", f, lit(4.0)),), True), ("acos", (B("/", f, lit(4.0)),), True),
        ("atan", (f,), True), ("sinh", (f,), True), ("cosh", (f,), True), ("tanh", (f,), True),
        ("asinh", (f,), True), ("acosh", (f,), True), ("atanh", (B("/", f, lit(4.0)),), True),
        ("degrees", (f,), False), ("radians", (c,), False), ("log", (g, f), True),
        ("atan2", (f, g), True), ("hypot", (f, g), True), ("factorial", (b,), False),
        ("gcd", (c, a), False), ("lcm", (c, b), False), ("bit_and", (a, c), False),
        ("bit_or", (a, b), False), ("bit_xor", (c, b), False), ("bit_not", (a,), False),
        ("bit_shift_left", (a, b * 11), False), ("bit_shift_right", (c, b * 11), False),
        ("greatest", (a, b, f), False), ("least", (b, lit(3)), False),
        ("greatest", (f, g), False),
    ]
    out += [(f"fn_{n}_{i}", Fn(n, args), t) for i, (n, args, t) in enumerate(fns)]
    out += [(f"str_{n}", F.StringFunc(n, col("channel"), dictionary), False)
            for n in ("upper", "lower", "length")]
    used = {e.name for _, e, _ in out if isinstance(e, F.Func)}
    check(used == set(F.registry_names()), "S battery: every registered function")
    return out


def ulp_err(torch, want, got) -> float:
    """Largest |want - got| in ulps of max(|want|, |got|, 1); NaN and
    infinite positions must agree (they count 0)."""
    check(torch.equal(torch.isnan(want), torch.isnan(got)), "S: NaN positions")
    fin = torch.isfinite(want) & torch.isfinite(got)
    check(torch.equal(want[~fin].nan_to_num(0.0), got[~fin].nan_to_num(0.0)),
          "S: infinite values")
    w, g = want[fin].double(), got[fin].double()
    mag = torch.maximum(torch.maximum(w.abs(), g.abs()), torch.ones_like(w)).to(want.dtype)
    ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).double()
    return float(((w - g).abs() / ulp).max()) if w.numel() else 0.0


def s_compare(torch, want, got, trans: bool, what: str) -> float:
    """One output of the kernel against the plain version: dtype, NULL
    lane and values bit for bit (NaN equal to NaN, -0.0 to 0.0), or for
    a transcendental function within S_ULPS. Returns the ulps seen."""
    (wv, wn), (gv, gn) = want, got
    check(wv.dtype == gv.dtype, f"S {what}: dtype {gv.dtype} vs {wv.dtype}")
    check((wn is None) == (gn is None), f"S {what}: NULL lane presence")
    if wn is not None:
        check(torch.equal(wn, gn), f"S {what}: NULL lane")
    if trans and wv.is_floating_point():
        ulps = ulp_err(torch, wv, gv)
        check(ulps <= S_ULPS, f"S {what}: {ulps} ulp")
        return ulps
    same = torch.equal(wv, gv) or (wv.is_floating_point() and torch.equal(
        torch.isnan(wv), torch.isnan(gv)) and torch.equal(wv.nan_to_num(0.0), gv.nan_to_num(0.0)))
    check(same, f"S {what}: values")
    return 0.0


def s_flush_chunk(torch, dev, rng, n: int, cap: int = None):
    """An agg flush's layout: rows 2i+1, 2i+2 a U-/U+ pair of one group's
    old and new count (pair (255, 256) across the tile boundary), plain
    inserts and deletes among them, row cap-1 a U- whose U+ is row 0
    (the wraparound); counts near 20, some NULL."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.types import Op

    cap = cap or n
    ops = np.zeros(n, np.int32)
    num = rng.integers(10, 30, n).astype(np.int64)
    for i in range(1, n - 1, 2):
        r = rng.random()
        if r < 0.8:
            ops[i], ops[i + 1] = Op.UPDATE_DELETE, Op.UPDATE_INSERT
            num[i + 1] = num[i] + 1
        else:
            ops[i], ops[i + 1] = (Op.DELETE, Op.INSERT) if r < 0.9 else (Op.INSERT, Op.DELETE)
    ops[n - 1], ops[0] = Op.UPDATE_DELETE, Op.UPDATE_INSERT
    num[0], num[n - 1] = 20, 19
    if n > 256:
        ops[255], ops[256] = Op.UPDATE_DELETE, Op.UPDATE_INSERT
        num[255], num[256] = 19, 20
    cols = {"auction": rng.integers(1000, 10**6, n).astype(np.int64), "num": num,
            "v": rng.integers(-3, 3, n).astype(np.int32)}
    return StreamChunk.from_numpy(cols, cap, ops=ops, nulls={"v": rng.random(n) < 0.3},
                                  device=dev)


def kernel_s(torch, dev, rng):
    """S against its plain version on the card: the battery of trees over
    2^20 bid-shaped rows in projections of S_GROUP outputs (every opcode
    reached, a lifted program with its parameter operand too), then the
    filter over agg-flush chunks with torn pairs (across a tile boundary
    and the wraparound; 1-D, stacked, and 1,000-row chunks whose ends fall
    inside tiles). Timed on the main paths' shapes: q1's projection and
    q2's predicate on a 65,536-row bid chunk. Returns the rw_project and
    the rw_filter rows."""
    from risingwave_tpu_torch.array.chunk import StreamChunk, stack_chunks
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
    from risingwave_tpu_torch.expr import expr as E
    from risingwave_tpu_torch.expr.functions import Func
    from risingwave_tpu_torch.ops import expr_vm

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=EVENT_RATE), seed=SEED)
    battery = s_battery(gen.dicts["channel"])
    chunk = s_chunk(torch, dev, rng, S_ROWS)
    ops_seen, worst_ulps, n_prog, trans_names = set(), 0.0, 0, []
    exprs = [(n, e) for n, e, _ in battery]
    trans = {n: t for n, _, t in battery}
    for lo in range(0, len(exprs), S_GROUP):
        part = exprs[lo:lo + S_GROUP]
        got = expr_vm._project_cuda(chunk, part)
        want = expr_vm.project_torch(chunk, part)
        torch.cuda.synchronize()
        prog = expr_vm.program_for(part, chunk, False)
        ops_seen |= {ins[0] for ins in prog.insns}
        n_prog += 1
        for name, _ in part:
            u = s_compare(torch, (want[0][name], want[1].get(name)),
                          (got[0][name], got[1].get(name)), trans[name], name)
            worst_ulps = max(worst_ulps, u)
            if trans[name]:
                trans_names.append(name)
    # a lifted program reads its parameters from the operand
    lifted = E.lift_literals((E.col("c") >= 20) & (E.col("f") < 1.5), ints := [], fl := [])
    params = {"i": torch.tensor(ints, dtype=torch.int64, device=dev),
              "f": torch.tensor(fl, dtype=torch.float64, device=dev)}
    with E.param_scope(params):
        got = expr_vm._project_cuda(chunk, (("x", lifted),))
        want = expr_vm.project_torch(chunk, (("x", lifted),))
        ops_seen |= {ins[0] for ins in expr_vm.program_for((("x", lifted),), chunk, False).insns}
    s_compare(torch, (want[0]["x"], want[1].get("x")), (got[0]["x"], got[1].get("x")), False,
              "lifted")
    # the filter: q103's and q104's HAVING (lifted too), a NULL-bearing
    # predicate, over 1-D, stacked and short chunks
    flush = s_flush_chunk(torch, dev, rng, CHUNK_EVENTS)
    short = [s_flush_chunk(torch, dev, rng, 1000) for _ in range(5)]
    shapes = {"flush": flush, "stacked": stack_chunks([s_flush_chunk(torch, dev, rng, CHUNK_EVENTS)
                                                        for _ in range(4)]),
              "short_stacked": stack_chunks(short), "short": short[0]}
    preds = {"ge20": E.col("num") >= 20, "lt20": E.col("num") < 20,
             "null3vl": (E.col("v") > 0) | (E.col("num") > 25),
             "lifted": E.lift_literals(E.col("num") >= 20, [], [])}
    torn = 0
    for sname, ch in shapes.items():
        for pname, pred in preds.items():
            with E.param_scope({"i": torch.tensor([20], dtype=torch.int64, device=dev),
                                "f": torch.zeros(0, dtype=torch.float64, device=dev)}):
                gv, go = expr_vm._filter_cuda(ch, pred)
                wv, wo = expr_vm.filter_torch(ch, pred)
                ops_seen |= {i[0] for i in expr_vm.program_for((("keep", pred),), ch, True).insns}
            torch.cuda.synchronize()
            check(torch.equal(gv, wv) and torch.equal(go, wo), f"S filter {pname} on {sname}")
            torn += int((go != ch.ops).sum())
    check(torn > 0, "S filter: torn pairs rewritten")
    fv, fo = expr_vm._filter_cuda(flush, preds["ge20"])
    check(bool(fv[0]) and int(fo[0]) == 0 and not bool(fv[CHUNK_EVENTS - 1]),
          "S filter: the U+ of a pair across the wraparound becomes an Insert")
    check(bool(fv[256]) and int(fo[256]) == 0 and not bool(fv[255]),
          "S filter: the U+ of a pair across the tile boundary becomes an Insert")
    missing = set(expr_vm.OPS) - ops_seen
    check(not missing, f"S: opcodes never run {sorted(missing)}")
    # times on the main paths' shapes: a 65,536-row bid chunk
    bid = gen.next_chunks(CHUNK_EVENTS, CHUNK_EVENTS, device=dev)["bid"]
    n = bid.capacity
    q1_out = (("auction", E.col("auction")), ("bidder", E.col("bidder")),
              ("price", E.lit(0.908) * E.col("price")), ("date_time", E.col("date_time")))
    q2_pred = Func("mod", (E.col("auction"), E.lit(123))) == E.lit(0)
    ms_p = time_ms(torch, lambda: expr_vm._project_cuda(bid, q1_out), 50)
    plain_p = time_ms(torch, lambda: expr_vm.project_torch(bid, q1_out), 10)
    ms_f = time_ms(torch, lambda: expr_vm._filter_cuda(bid, q2_pred), 50)
    plain_f = time_ms(torch, lambda: expr_vm.filter_torch(bid, q2_pred), 10)
    ms_flush = time_ms(torch, lambda: expr_vm._filter_cuda(flush, preds["ge20"]), 50)
    ms_battery = time_ms(torch, lambda: expr_vm._project_cuda(chunk, exprs[:S_GROUP]), 5)
    # the first battery program's bytes: each input lane (and its NULL
    # lane) and the valid lane read once, each output (and its NULL lane)
    # written once
    first = exprs[:S_GROUP]
    first_cols, first_nulls = expr_vm._project_cuda(chunk, first)
    prog = expr_vm.program_for(first, chunk, False)
    in_bytes = sum(chunk.col(c).element_size() + int(nullable) for c, _, nullable in prog.inputs)
    out_bytes = sum(first_cols[name].element_size() + int(first_nulls.get(name) is not None)
                    for name, _ in first)
    first_bound = bound_ms(S_ROWS * (1 + in_bytes + out_bytes))
    got_p = expr_vm._project_cuda(bid, q1_out)[0]["price"]
    want_p = expr_vm.project_torch(bid, q1_out)[0]["price"]
    err_p = float((got_p - want_p).abs().max())
    common = {"battery": {"trees": len(exprs), "programs": n_prog, "rows": S_ROWS,
                          "opcodes": len(ops_seen), "transcendental": trans_names,
                          "worst_ulps": worst_ulps, "tolerance_ulps": S_ULPS,
                          "first_program_ms": ms_battery,
                          "first_program_bound_ms": first_bound,
                          "first_program_bytes_per_row": 1 + in_bytes + out_bytes},
              "library_call": "none (no single PyTorch call evaluates an expression tree)"}
    proj = {
        "name": "S rw_project", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/expr_eval.cu (+ expr_vm.cuh)",
        "replaces": "risingwave_tpu/executors/project.py:22 (+ expr/expr.py, expr/functions.py)",
        "max_abs_err": err_p, "ms": ms_p, "plain_ms": plain_p,
        # q1: the price lane read, the float64 price written
        "bound_ms": bound_ms(n * 16), "bound_by": "bytes", "library_ms": None,
        "shape": {"rows": n, "outputs": "q1's (one computed: 0.908 * price)"}, **common,
    }
    filt = {
        "name": "S rw_filter", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/expr_eval.cu (+ expr_vm.cuh)",
        "replaces": "risingwave_tpu/executors/filter.py:25",
        "max_abs_err": 0.0, "ms": ms_f, "plain_ms": plain_f,
        # auction 8, valid 1, ops 4 read; valid 1, ops 4 written
        "bound_ms": bound_ms(n * 18), "bound_by": "bytes", "library_ms": None,
        "shape": {"rows": n, "predicate": "q2's MOD(auction, 123) = 0",
                  "flush_chunk_ms": ms_flush, "torn_pairs_rewritten": torn}, **common,
    }
    return proj, filt


def kernel_t(torch, dev, rng):
    """T against its plain version on the card: a 65,536-row bid chunk
    with late inserts, retractions below the floor, U-/U+ pairs whose U+
    falls below it (a pair across a tile boundary and one across the
    wraparound), NULL event times; the mask, the ops and the running max
    exactly, over a run of chunks whose floor rises."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import watermark_filter as wf
    from risingwave_tpu_torch.types import Op

    n, base = CHUNK_EVENTS, 1_436_918_400_000
    maxes = [torch.full((), wf.INT64_MIN, dtype=torch.int64, device=dev) for _ in range(2)]
    floor, dropped, chunks = wf.INT64_MIN, 0, []
    for step in range(4):
        ts = base + step * 60_000 + rng.integers(-20_000, 60_000, n)
        ops = np.where(rng.random(n) < 0.1, Op.DELETE, Op.INSERT).astype(np.int32)
        for i in range(3, n - 1, 11):
            ops[i], ops[i + 1] = Op.UPDATE_DELETE, Op.UPDATE_INSERT
            ts[i + 1] = base - 10**6  # the update moves the row below the floor
        ops[255], ops[256], ts[256] = Op.UPDATE_DELETE, Op.UPDATE_INSERT, base - 10**6
        ops[n - 1], ops[0], ts[0] = Op.UPDATE_DELETE, Op.UPDATE_INSERT, base - 10**6
        chunk = StreamChunk.from_numpy({"date_time": ts.astype(np.int64)}, n, ops=ops,
                                       nulls={"date_time": rng.random(n) < 0.05}, device=dev)
        got = wf._wm_cuda(chunk, maxes[0], "date_time", floor)
        want = wf._wm_torch(chunk, maxes[1], "date_time", floor)
        torch.cuda.synchronize()
        check(torch.equal(got.valid, want.valid) and torch.equal(got.ops, want.ops),
              f"T: mask and ops, step {step}")
        check(int(maxes[0]) == int(maxes[1]), f"T: running max, step {step}")
        dropped += int((chunk.valid & ~got.valid).sum())
        if step:  # row 0's U+ lies below the floor from the second chunk on
            check(not bool(got.valid[0]) and int(got.ops[n - 1]) == Op.DELETE,
                  "T: a U- whose wrapped U+ dropped is a Delete")
        floor = int(maxes[0]) - 5_000
        chunks.append(chunk)
    check(dropped > 0, "T: late inserts dropped")
    chunk = chunks[-1]
    rmax = maxes[0].clone()
    ms = time_ms(torch, lambda: wf._wm_cuda(chunk, rmax, "date_time", floor), 50)
    plain = time_ms(torch, lambda: wf._wm_torch(chunk, rmax, "date_time", floor), 10)
    masked = torch.where(chunk.valid & ~chunk.nulls["date_time"], chunk.col("date_time"),
                         torch.full_like(chunk.col("date_time"), wf.INT64_MIN))
    lib = time_ms(torch, lambda: torch.amax(masked), 50)
    return {
        "name": "T watermark filter", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/wm_filter.cu",
        "replaces": "risingwave_tpu/executors/watermark_filter.py:31",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
        # ts 8, NULL 1, valid 1, ops 4 read; valid 1, ops 4 written
        "bound_ms": bound_ms(n * 19), "bound_by": "bytes", "library_ms": lib,
        "library_call": "torch.amax of the masked event-time lane (the fold alone)",
        "shape": {"rows": n, "chunks": len(chunks), "dropped_rows": dropped},
    }


def bid_host_rows(chunks) -> dict:
    """The valid bid rows of phase 4's chunks, read back, with the row id
    RowIdGen gives them (chunk index x capacity + row)."""
    out = {k: [] for k in ("_row_id", "auction", "bidder", "price", "date_time")}
    k = 0
    for c in (c for ep in chunks for c in ep):
        v = c.valid.cpu().numpy()
        out["_row_id"].append(k * c.capacity + np.flatnonzero(v))
        for name in ("auction", "bidder", "price", "date_time"):
            out[name].append(c.col(name).cpu().numpy()[v])
        k += 1
    return {n: np.concatenate(a) for n, a in out.items()}


def lockstep(torch, paths, epochs_data, push, launches: PathLaunches, after=None):
    """Drive several pipelines over the same epochs: per epoch each path
    pushes its chunks and takes its barrier, timed to the card's idle.
    ``after(e)`` checks every barrier. Returns per path run seconds and
    barrier ms."""
    rec = {p: {"run_s": 0.0, "barrier_ms": []} for p in paths}
    for e, ep in enumerate(epochs_data):
        for p, pipe in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            launches.run(p, push, pipe, ep)
            tb = time.perf_counter()
            launches.run(p, pipe.barrier)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec[p]["barrier_ms"].append((t1 - tb) * 1e3)
            rec[p]["run_s"] += t1 - t0
        if after is not None:
            after(e)
    return rec


def path_row(phase, rows, rec, **extra) -> dict:
    return {"phase": phase, "rows": rows, "rows_per_s": rows / rec["run_s"],
            "run_s": rec["run_s"],
            "barrier_ms_p50": float(np.percentile(rec["barrier_ms"], 50)),
            "barrier_ms_p99": float(np.percentile(rec["barrier_ms"], 99)), **extra}


def q1_q2_paths(torch, dev, chunks):
    """Phase 17: q1 and q2 interpreted over phase 4's bid chunks (RowIdGen
    and Project, q2's Filter first), each MV against a numpy oracle of
    the same rows and expressions."""
    from risingwave_tpu_torch.queries.nexmark_q import Q1_RATE, Q2_MODULUS, build_q1, build_q2

    host = bid_host_rows(chunks)
    n_bids = len(host["auction"])
    q2_rows = int((host["auction"] % Q2_MODULUS == 0).sum())
    q1 = build_q1(capacity=state_cap(n_bids, Q1_Q2_MV_FLOOR), device=dev)
    q2 = build_q2(capacity=state_cap(q2_rows, Q1_Q2_MV_FLOOR), device=dev)
    launches = PathLaunches()

    def push(pipe, ep):
        for c in ep:
            pipe.push(c)

    torch.cuda.reset_peak_memory_stats()
    rec = lockstep(torch, {"q1": q1.pipeline, "q2": q2.pipeline}, chunks, push, launches)
    peak = torch.cuda.max_memory_allocated()
    got = q1.mview.to_numpy()
    order = np.argsort(got["_row_id"])
    check(np.array_equal(got["_row_id"][order], host["_row_id"]), "q1: row ids vs oracle")
    for name in ("auction", "bidder", "date_time"):
        check(np.array_equal(got[name][order], host[name]), f"q1: {name} vs oracle")
    check(np.array_equal(got["price"][order], Q1_RATE * host["price"]),
          "q1: 0.908 * price vs numpy, bit for bit")
    got = q2.mview.to_numpy()
    order = np.argsort(got["_row_id"])
    keep = host["auction"] % Q2_MODULUS == 0
    for name in ("_row_id", "auction", "price"):
        check(np.array_equal(got[name][order], host[name][keep]), f"q2: {name} vs oracle")
    for p in ("q1", "q2"):
        check(launches.by[p]["expr_eval" if p == "q1" else "expr_filter"] > 0,
              f"kernel S launched on {p}'s path")
    n_chunks = sum(len(ep) for ep in chunks)
    check(launches.by["q1"]["expr_eval"] == n_chunks, "q1: one rw_project a chunk")
    check(launches.by["q2"]["expr_filter"] == n_chunks and launches.by["q2"]["expr_eval"] == 0,
          "q2: one rw_filter a chunk, its all-column Project launches nothing")
    rows = [
        path_row("q1", n_bids, rec["q1"], mv_rows=n_bids, mv_capacity=q1.mview.table.capacity,
                 oracle="numpy (row id, auction, bidder, 0.908 * price, date_time): equal",
                 launches=launches.by["q1"], max_memory_allocated=int(peak)),
        path_row("q2", n_bids, rec["q2"], mv_rows=q2_rows, mv_capacity=q2.mview.table.capacity,
                 oracle="numpy rows with auction % 123 = 0: equal", launches=launches.by["q2"]),
    ]
    return rows, launches.by


def hot_paths(torch, dev, chunks):
    """Phase 18: q103's subquery (count per auction, HAVING, MV) with >= 20
    and < 20, each interpreted and fused (the filter in the program's mid
    segment, its threshold lifted), and >= 25 fused beside them (sharing
    >= 20's kernel-S program, its own parameter vector); at every barrier
    the fused MV equals the interpreted one and both the numpy oracle of
    cumulative counts; the staged digests equal host_digest of the lanes
    read back."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops import expr_vm
    from risingwave_tpu_torch.queries.nexmark_q import build_hot_auctions
    from risingwave_tpu_torch.runtime.fused_step import (
        FusedChainExecutor,
        fuse_pipeline,
        fused_cache_stats,
    )

    check_sync_guard(torch, dev)
    variants = {"ge20": (">=", 20, False), "ge20_fused": (">=", 20, True),
                "lt20": ("<", 20, False), "lt20_fused": ("<", 20, True),
                f"ge{HOT_SHARED}_fused": (">=", HOT_SHARED, True)}
    stats0 = fused_cache_stats()
    qs, wrappers = {}, {}
    for name, (op, t, fused) in variants.items():
        q = build_hot_auctions(t, op, capacity=HOT_AGG_CAP, mv_capacity=HOT_MV_CAP, device=dev)
        if fused:
            (w,) = fuse_pipeline(q.pipeline, label=name)
            check(isinstance(w, FusedChainExecutor) and w.plan.mid is not None,
                  f"{name}: one program, the filter in its mid segment")
            wrappers[name] = w
        qs[name] = q
    host_auctions = [np.concatenate([c.col("auction").cpu().numpy()[c.valid.cpu().numpy()]
                                     for c in ep]) for ep in chunks]
    counts = np.zeros(int(max(a.max() for a in host_auctions)) + 1, np.int64)
    launches = PathLaunches()

    def push(pipe, ep):
        for c in ep:
            pipe.push(c)

    def after(e):
        counts[:] += np.bincount(host_auctions[e], minlength=len(counts))
        ids = np.flatnonzero(counts)
        for name, q in qs.items():
            op, t, _ = variants[name]
            keep = counts[ids] >= t if op == ">=" else counts[ids] < t
            got = q.mview.to_numpy()
            order = np.argsort(got["auction"])
            check(np.array_equal(got["auction"][order], ids[keep])
                  and np.array_equal(got["num"][order], counts[ids][keep]),
                  f"{name}: MV vs cumulative counts at barrier {e}")

    torch.cuda.reset_peak_memory_stats()
    rec = lockstep(torch, {n: q.pipeline for n, q in qs.items()}, chunks, push, launches, after)
    peak = torch.cuda.max_memory_allocated()
    for name, w in wrappers.items():
        lane = state_digests(qs[name])
        check(w.last_digests == lane, f"{name}: staged digests vs host_digest of the lanes")
        check(w._lift_state == "on", f"{name}: threshold lifted")
        plain = name.replace("_fused", "")
        if plain in qs:
            check(lane == state_digests(qs[plain]), f"{name}: digests vs the interpreted run")
    w20, w25 = wrappers["ge20_fused"], wrappers[f"ge{HOT_SHARED}_fused"]
    check(w20._exec_plan.mid == w25._exec_plan.mid, "ge20 and ge25: one lifted plan")
    check(w20._params["i"].tolist() == [20] and w25._params["i"].tolist() == [HOT_SHARED],
          "ge20 and ge25: two parameter vectors")
    # the programs the fused plans ran: their lifted HAVING over the
    # agg's delta signature (num: int64, no NULLs)
    probe = StreamChunk.from_numpy({"num": np.zeros(1, np.int64)}, 1, device=dev)
    progs = {n: expr_vm.program_for((("keep", w._exec_plan.mid.steps[0].pred.value),), probe,
                                    True) for n, w in wrappers.items()}
    check(progs["ge20_fused"] is progs[f"ge{HOT_SHARED}_fused"]
          and progs["lt20_fused"] is not progs["ge20_fused"],
          "fused runs: one kernel-S program for >= 20 and >= 25, one for < 20")
    baked = {id(expr_vm.program_for((("keep", qs[n].having.pred),), probe, True))
             for n, (_, _, fused) in variants.items() if not fused}
    for name in qs:
        kern = "expr_filter"
        check(launches.by[name][kern] > 0, f"kernel S's filter launched on {name}'s path")
    total = sum(len(a) for a in host_auctions)
    stats = fused_cache_stats()
    rows = [path_row(f"hot_{name}", total, rec[name], mv_rows=len(qs[name].mview.to_numpy()[
        "auction"]), launches=launches.by[name]) for name in qs]
    rows[0].update(
        programs={"fused_plans": len(wrappers), "fused_programs": len({id(p) for p in
                                                                         progs.values()}),
                  "interpreted_baked": len(baked),
                  "plans_lifted": stats["plans_lifted"] - stats0["plans_lifted"]},
        thresholds="ge20 and ge25 fused: one compiled kernel-S program, two parameter vectors",
        agg_capacity=HOT_AGG_CAP, mv_capacity=HOT_MV_CAP, max_memory_allocated=int(peak),
        sync_guard="set_sync_debug_mode('error') over the program part of every fused barrier: "
                   "held",
        oracle="numpy cumulative counts at every barrier, fused = interpreted: equal")
    return rows, launches.by


def q103_paths(torch, dev, host, chunks):
    """Phase 19: q103 and q104 over phase 11's stream (an auction chunk
    left, the bid chunks right, per epoch), interpreted and through
    fuse_pipeline (the reference's per-chain fallback: the refusal
    printed); at every barrier each MV equals the numpy oracle and the
    two paths equal each other."""
    from risingwave_tpu_torch.queries.nexmark_q import HOT_BIDS, build_q103, build_q104
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals

    fusion_refusals(clear=True)
    qs, shapes = {}, {}
    for name, build in (("q103", build_q103), ("q104", build_q104)):
        for fused in (False, True):
            q = build(capacity=Q103_CAP, fanout=Q103_FANOUT, out_cap=Q103_OUT_CAP,
                      mv_capacity=Q103_CAP, device=dev)
            key = name + ("_fused" if fused else "")
            if fused:
                fuse_pipeline(q.pipeline, label=key)
                shapes[key] = [[type(e).__name__ for e in getattr(q.pipeline, a)]
                               for a in ("left", "right", "tail")]
                check(shapes[key] == [[], ["EpochBatchedAggExecutor", "FilterExecutor"],
                                      ["FusedChainExecutor"]], f"{key}: the per-chain fallback")
            qs[key] = q
    refusals = fusion_refusals()
    check(len(refusals) == 2 and all(r["executor"] == "FilterExecutor" for r in refusals),
          "q103/q104: whole-pipeline fusion refused for the side's filter")
    counts = np.zeros(int(max(max(b["auction"].max() for b in bids) for _, bids in host)) + 1,
                      np.int64)
    ids_so_far = []
    launches = PathLaunches()

    def push(pipe, ep):
        a, bids = ep
        pipe.push_left(a)
        for b in bids:
            pipe.push_right(b)

    def after(e):
        a, bids = host[e]
        ids_so_far.append(a["id"])
        for b in bids:
            counts[:] += np.bincount(b["auction"], minlength=len(counts))
        ids = np.unique(np.concatenate(ids_so_far))
        n = np.where(ids < len(counts), counts[np.minimum(ids, len(counts) - 1)], 0)
        want = {"q103": ids[n >= HOT_BIDS], "q104": ids[(n == 0) | (n >= HOT_BIDS)]}
        for key, q in qs.items():
            got = np.sort(q.mview.to_numpy()["id"])
            check(np.array_equal(got, want[key.replace("_fused", "")]),
                  f"{key}: MV ({len(got)} ids) vs the oracle at barrier {e}")

    torch.cuda.reset_peak_memory_stats()
    rec = lockstep(torch, {k: q.pipeline for k, q in qs.items()}, chunks, push, launches, after)
    peak = torch.cuda.max_memory_allocated()
    rows_in = sum(len(a["id"]) + sum(len(b["auction"]) for b in bids) for a, bids in host)
    for key in qs:
        check(launches.by[key]["expr_filter"] > 0 and launches.by[key]["join_degree"] > 0,
              f"kernels S and P launched on {key}'s path")
    rows = [path_row(key, rows_in, rec[key], mv_rows=len(q.mview.to_numpy()["id"]),
                     launches=launches.by[key], chains=shapes.get(key))
            for key, q in qs.items()]
    rows[0].update(refusals=refusals, agg_capacity=Q103_CAP, join=(Q103_CAP, Q103_FANOUT),
                   mv_capacity=Q103_CAP, out_cap=Q103_OUT_CAP, max_memory_allocated=int(peak),
                   oracle="numpy: auctions with >= 20 bids so far (q103), with none or >= 20 "
                          "(q104), at every barrier; fallback = interpreted: equal")
    return rows, launches.by


def q7_scan_path(torch, dev, host, chunks):
    """Phase 20: q7 with the planner's scan shape, a WatermarkFilter at
    the head of both sides and no injected watermark calls, interpreted
    (the reference refuses to fuse a side holding one) over phase 9's
    stream; its MV against the q7 actor on the rows the filters keep;
    after the last barrier no table holds a key below the last generated
    watermark."""
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.executors.watermark_filter import WatermarkFilterExecutor
    from risingwave_tpu_torch.queries.nexmark_q import Q7_WINDOW_MS, build_q7

    host, chunks = host[:Q7_SCAN_EPOCHS], chunks[:Q7_SCAN_EPOCHS]
    q7 = build_q7(capacity=Q7_CAP, fanout=Q7_FANOUT, out_cap=Q7_OUT_CAP, agg_capacity=Q7_CAP,
                  filter_capacity=Q7_CAP, device=dev)
    q7.pipeline.left.insert(0, WatermarkFilterExecutor("date_time", Q7_SCAN_LAG_MS, device=dev))
    q7.pipeline.right.insert(0, WatermarkFilterExecutor("date_time", Q7_SCAN_LAG_MS, device=dev))
    # the rows the filters keep: inserts at or above the watermark of the
    # last barrier (the generator's event times never fall behind it)
    kept, floor, mx = [], None, None
    for h_ep in host:
        for cols in h_ep:
            ok = np.ones(len(cols["date_time"]), bool) if floor is None else \
                cols["date_time"] >= floor
            kept.append({k: v[ok] for k, v in cols.items()})
            mx = int(cols["date_time"].max()) if mx is None else max(mx, int(
                cols["date_time"].max()))
        floor = mx - Q7_SCAN_LAG_MS
    oracle = q7_oracle_rows(kept, Q7_WINDOW_MS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    barrier_ms, run_s = [], 0.0
    for c_ep in chunks:
        t0 = time.perf_counter()
        for c in c_ep:
            q7.pipeline.push_left(c)
            q7.pipeline.push_right(c)
        tb = time.perf_counter()
        q7.pipeline.barrier()  # the generated watermarks walk inside it
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        barrier_ms.append((t1 - tb) * 1e3)
        run_s += t1 - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    got = q7_mv_rows(q7.mview)
    check(got.shape == oracle.shape and np.array_equal(got, oracle),
          f"q7 scan filters: MV ({len(got)} rows) vs the q7 actor on the kept rows "
          f"({len(oracle)} rows)")
    n_chunks = sum(len(ep) for ep in chunks)
    check(launches["wm_filter"] == 2 * n_chunks, "q7 scan filters: T once a chunk on each side")
    wms = [q7.pipeline.left[0]._wm, q7.pipeline.right[0]._wm]
    check(wms == [floor, floor], f"q7 scan filters: generated watermarks {wms} vs {floor}")
    cutoff = floor // Q7_WINDOW_MS * Q7_WINDOW_MS  # the tumble's window watermark
    for name, table in (("join left", q7.join.left.table), ("join right", q7.join.right.table),
                        ("filter", q7.pipeline.left[2].table), ("agg", q7.agg.table)):
        live = table.live
        check(bool(live.any()), f"q7 scan filters: {name} keeps the open windows")
        check(bool((table.keys[0][live] >= cutoff).all()),
              f"q7 scan filters: {name} holds no key below the last generated watermark")
    bids = sum(len(c["auction"]) for ep in host for c in ep)
    return {
        "phase": "q7_scan_watermark_filters", "epochs": len(chunks), "bids": bids,
        "bids_per_s": bids / run_s, "run_s": run_s,
        "barrier_ms_p50": float(np.percentile(barrier_ms, 50)),
        "barrier_ms_p99": float(np.percentile(barrier_ms, 99)), "barrier_ms": barrier_ms,
        "lag_ms": Q7_SCAN_LAG_MS, "last_watermark": floor, "kept_rows": sum(
            len(c["auction"]) for c in kept), "mv_rows": int(len(got)),
        "max_memory_allocated": int(peak), "launches": launches,
        "oracle": "bench.py's cpu_actor_q7 (vectorized) on the rows the filters keep: equal; "
                  "no table key below the last generated watermark",
    }, launches


# -- phase 3, kernels U, V, W, X; phases 21-23: TopN (q19, q19-ao, q105) ----------
# q19 (phases 21-22) over phase 4's stream: the retractable store holds every
# bid (18.4M rows over 20M events: state_cap gives 2^26 slots); the
# append-only auction table holds about 1.2M auctions (bands of 2^22 x 10),
# and out_cap 2^17 covers a 65,536-row chunk's leavers and entrants; the
# MVs hold each auction's top 10 (and the tombstones of rows pushed out)
Q19_CAP = 1 << 26
Q19AO_CAP = 1 << 22
Q19AO_OUT_CAP = 1 << 17
Q19_MV_CAP = 1 << 24
# phases 21-22 run phase 4's first Q19_EPOCHS epochs (cut from 20, then 10, for the
# script's time limit); barriers Q19_CHECKS are held against the oracle
Q19_EPOCHS = 8
Q19_CHECKS = (4, Q19_EPOCHS - 1)
Q19_COLS = ("_row_id", "auction", "bidder", "price", "channel", "date_time")
Q19_PRICE_BITS = 27  # prices stay below 2^27 (round(10^6 * 100) at most)
# q105 (phase 23) over phase 11's stream at its sizes: agg 2^22, join sides
# (2^22, 4), out_cap 2^17, a TopN store of 2^22
Q105_CAP = 1 << 22
Q105_FANOUT = 4
Q105_OUT_CAP = 1 << 17
W_LIVE = 1_200_000  # kernel W's store: q105's auctions
W_TIED = 5_000  # rows tied at the 1,000th count
TOPN_KERNELS = {  # what each path's run must launch
    "q19": ("lookup_or_insert", "topn_upsert", "group_topk", "checkpoint", "gather_rows",
            "mv_upsert"),
    "q19_ao": ("lookup_or_insert", "first_occurrence", "topn_band", "mv_upsert"),
    "q105": ("lookup_or_insert", "topn_upsert", "topn_rank", "gather_rows", "join_probe",
             "mv_upsert"),
}


def q19_host(chunks) -> list:
    """Per epoch, the valid bid rows of phase 4's chunks read back, with
    the row id RowIdGen gives them (chunk index x capacity + row)."""
    out, k = [], 0
    for ep in chunks:
        parts = []
        for c in ep:
            v = c.valid.cpu().numpy()
            d = {"_row_id": k * c.capacity + np.flatnonzero(v)}
            for name in Q19_COLS[1:]:
                d[name] = c.col(name).cpu().numpy()[v].astype(np.int64)
            parts.append(d)
            k += 1
        out.append({n: np.concatenate([p[n] for p in parts]) for n in Q19_COLS})
    return out


def q19_top(rows: dict) -> dict:
    """q19's relation: per auction the 10 bids of highest price, a tie
    to the lower row id (the earlier bid)."""
    check(int(rows["price"].max(initial=0)) < 1 << Q19_PRICE_BITS and
          int(rows["price"].min(initial=0)) >= 0, "q19 oracle: prices fit the packed key")
    key = (rows["auction"] << Q19_PRICE_BITS) | ((1 << Q19_PRICE_BITS) - 1 - rows["price"])
    order = np.lexsort((rows["_row_id"], key))
    a = rows["auction"][order]
    first = np.ones(len(a), bool)
    first[1:] = a[1:] != a[:-1]
    at = np.arange(len(a))
    keep = order[(at - np.maximum.accumulate(np.where(first, at, 0))) < 10]
    return {n: v[keep] for n, v in rows.items()}


def q19_rows(d: dict) -> np.ndarray:
    rows = np.stack([np.asarray(d[n]).astype(np.int64) for n in Q19_COLS], 1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def mv_digest(mview) -> int:
    """Kernel H's digest of a device MV's live rows."""
    from risingwave_tpu_torch import integrity

    return integrity.digest_from_scalar(
        integrity.device_digest(*integrity.mv_lanes(mview.table, mview.state)))


def emission_rows(out) -> tuple:
    """(ops, rows) of an emission chunk's valid rows, columns by name."""
    v = out.valid.cpu().numpy()
    rows = np.stack([out.columns[n].cpu().numpy()[v].astype(np.int64)
                     for n in sorted(out.columns)], 1)
    return out.ops.cpu().numpy()[v], rows


def same_multiset(a: np.ndarray, b: np.ndarray) -> bool:
    sort = lambda r: r[np.lexsort(r.T[::-1])] if len(r) else r
    return a.shape == b.shape and np.array_equal(sort(a), sort(b))


def kernel_u(torch, dev, chunks):
    """U against its plain version: the last bid chunk of phase 4's stream
    into q19-ao's (2^22, 10) bands after the other chunks (kernels A and
    J first, as the path runs them); bands, marks, live and latches
    exact, the emission equal as a multiset per op with every DELETE
    before every INSERT."""
    from risingwave_tpu_torch.executors import top_n as tn
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.queries.nexmark_q import build_q19_append_only

    q = build_q19_append_only(capacity=Q19AO_CAP, out_cap=Q19AO_OUT_CAP, device=dev)
    rowid, topn = q.pipeline.executors[0], q.topn
    flat = [c for ep in chunks for c in ep]
    for c in flat[:-1]:
        topn.apply(rowid.apply(c)[0])
    chunk = rowid.apply(flat[-1])[0]
    valid = chunk.valid & (chunk.effective_signs() > 0)
    _, slots, _, _ = ht.lookup_or_insert(topn.table, (chunk.col("auction"),), valid)
    fmask = ht.first_occurrence_mask(slots, valid, topn.scratch)
    base = {k: v.clone() for k, v in topn.state.items()}
    live0 = topn.table.live.clone()

    def restore():
        for k, v in base.items():
            topn.state[k].copy_(v)
        topn.table.live.copy_(live0)

    fixed = (topn.group_keys, topn.order_col, topn.desc, topn.k, topn.payload, topn.out_cap)
    lat = tuple(torch.zeros((), dtype=torch.bool, device=dev) for _ in range(3))

    def run(fn):
        if fn == "cuda":
            return tn._topn_band_cuda(topn.table, topn.state, chunk, slots, fmask, *fixed,
                                      topn.scratch, lat)
        return tn._topn_band_torch(topn.table, topn.state, chunk, slots, valid, *fixed, lat)

    outs = []
    for fn in ("cuda", "torch"):
        restore()
        for t in lat:
            t.zero_()
        out = run(fn)
        lanes = {f"state.{k}": v.clone() for k, v in topn.state.items()}
        lanes["live"] = topn.table.live.clone()
        outs.append((emission_rows(out), lanes, [bool(t) for t in lat]))
    torch.cuda.synchronize()
    assert_lanes_equal(torch, outs[0][1], outs[1][1], "U: bands, sdirty, live")
    check(outs[0][2] == outs[1][2] == [False] * 3, "U: latches")
    check(bool((topn.scratch == ht.FIRST_SENTINEL).all()), "U: scratch reset")
    (ops_k, rows_k), (ops_p, rows_p) = outs[0][0], outs[1][0]
    for ops in (ops_k, ops_p):
        check(bool(np.all(np.diff(ops) <= 0)), "U: every DELETE before every INSERT")
    for op in (0, 1):
        check(same_multiset(rows_k[ops_k == op], rows_p[ops_p == op]),
              f"U: emission multiset of op {op}")
    err = max_abs_diff(torch, outs[0][1], outs[1][1])
    ms = time_ms(torch, lambda: run("cuda"), 20, setup=restore)
    plain = time_ms(torch, lambda: run("torch"), 3, setup=restore)
    restore()
    n, k = chunk.capacity, topn.k
    groups = int(fmask.sum())
    emitted = len(ops_k)
    entrants = int((ops_k == 0).sum())
    # per row slots 4, fmask 1, valid 1, ops 4 and order 8 read; per
    # entering row its payload 28 read; per touched group its band rows
    # (order 8, valid 1, payload 28 per entry) read and written, live and
    # sdirty written, the key read; per emitted row its key 8, order 8,
    # payload 28, op 4 and valid 1 written
    nbytes = n * 18 + entrants * 28 + groups * (k * 37 * 2 + 2 + 8) + emitted * 49
    return {
        "name": "U append-only GroupTopN band step", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/topn_band.cu",
        "replaces": "risingwave_tpu/executors/top_n.py:67",
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "library_call": "none (no PyTorch call maintains per-group top-k bands)",
        "emission_same_order": bool(np.array_equal(ops_k, ops_p) and np.array_equal(rows_k,
                                                                                    rows_p)),
        "shape": {"rows": n, "bands": [Q19AO_CAP, k], "groups": int(topn.table.live.sum()),
                  "touched_groups": groups, "deletes": int((ops_k == 1).sum()),
                  "inserts": int((ops_k == 0).sum()), "out_cap": topn.out_cap},
    }


def v_compare(torch, dev, topn, chunk, what: str, epoch_dirty: bool) -> dict:
    """V against its plain version on ``chunk`` after kernel A, each run
    from the same store; every row lane, live, the marks, the latch and
    the scratch lane exact. Leaves the kernel's result in the store."""
    from risingwave_tpu_torch.executors import top_n_plain as tp
    from risingwave_tpu_torch.ops import hash_table as ht

    _, slots, _, _ = ht.lookup_or_insert(topn.table, tuple(chunk.col(k) for k in topn.store_keys),
                                         chunk.valid)
    ed = topn.epoch_dirty if epoch_dirty else None
    lanes = lambda: {**{f"r_{n}": a for n, a in topn.rows.items()}, "live": topn.table.live,
                     "sdirty": topn.sdirty, **({"ed": ed} if ed is not None else {})}
    base = {k: v.clone() for k, v in lanes().items()}

    def restore():
        for k, v in lanes().items():
            v.copy_(base[k])

    dropped = torch.zeros((), dtype=torch.bool, device=dev)

    def run(fn):
        if fn == "cuda":
            tp._topn_upsert_cuda(topn.table, topn.rows, topn.sdirty, ed, chunk, slots, topn.names,
                                 topn.scratch, dropped)
        else:
            tp._topn_upsert_torch(topn.table, topn.rows, topn.sdirty, ed, chunk, slots,
                                  topn.names, dropped)

    outs = []
    for fn in ("torch", "cuda"):  # the kernel's result stays in the store
        restore()
        run(fn)
        outs.append({k: v.clone() for k, v in lanes().items()} | {"dropped": dropped.clone()})
    torch.cuda.synchronize()
    assert_lanes_equal(torch, outs[1], outs[0], f"V ({what})")
    check(not bool(dropped), f"V ({what}): no dropped row")
    check(bool((topn.scratch == -1).all()), f"V ({what}): scratch reset")
    err = max_abs_diff(torch, outs[1], outs[0])
    ms = time_ms(torch, lambda: run("cuda"), 20, setup=restore)
    plain = time_ms(torch, lambda: run("torch"), 5, setup=restore)
    restore()
    run("cuda")
    n = chunk.capacity
    winners = int(torch.unique(slots[chunk.valid]).numel())
    lane_bytes = sum(a.element_size() for a in topn.rows.values())
    marks = 3 if epoch_dirty else 2
    # per row slots 4, valid 1 and ops 4 read; per winning slot its row's
    # lanes read, and its lanes and marks (live, sdirty, epoch_dirty)
    # written
    nbytes = n * 9 + winners * (2 * lane_bytes + marks)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms(nbytes), "max_abs_err": err,
            "shape": {"rows": n, "capacity": topn.table.capacity, "winning_slots": winners,
                      "live_rows": int(topn.table.live.sum())}}


def pairs_chunk(torch, dev, rng, topn, n: int, new_value, fresh_key):
    """A chunk of n rows on ``topn``'s store: U-/U+ pairs on stored rows
    (the U+ with ``new_value(old)`` in the order column), 1,000 of them
    again at the end (the last pair wins), 1,000 deletes of other stored
    rows and fresh inserts (``fresh_key(m)`` gives m new rows) to fill."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.types import Op

    live = torch.nonzero(topn.table.live).flatten()
    n_pairs, n_again, n_del = n // 2 - 3_000, 1_000, 1_000
    pick = live[torch.randperm(len(live), device=dev)[:n_pairs + n_del]]
    rows = {c: topn.rows[c][pick].cpu().numpy() for c in topn.names}
    pairs = {c: v[:n_pairs] for c, v in rows.items()}
    new = dict(pairs)
    new[topn.order_col] = new_value(pairs[topn.order_col])
    again = {c: v[:n_again // 2] for c, v in new.items()}
    again_new = dict(again)
    again_new[topn.order_col] = new_value(again[topn.order_col])
    dels = {c: v[n_pairs:] for c, v in rows.items()}
    fresh = fresh_key(n - 2 * n_pairs - n_again - n_del)
    cols = {c: np.concatenate([np.stack([pairs[c], new[c]], 1).reshape(-1),
                               np.stack([again[c], again_new[c]], 1).reshape(-1), dels[c],
                               fresh[c]]) for c in topn.names}
    ops = np.concatenate([np.tile([int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)], n_pairs),
                          np.tile([int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)], n_again // 2),
                          np.full(n_del, int(Op.DELETE)),
                          np.full(len(fresh[topn.order_col]), int(Op.INSERT))]).astype(np.int32)
    check(len(ops) == n, "V's chunk: n rows")
    return StreamChunk.from_numpy(cols, n, ops=ops, device=dev)


X_HARD_CAP = 1 << 12  # slots of each of X's hard stores


def x_store(torch, dev, rng, groups, order, pk, live, cap=X_HARD_CAP):
    """A TopN row store for X alone: the rows at random slots of ``cap``,
    the store keys the group lanes and an int64 pk."""
    from risingwave_tpu_torch.ops.hash_table import HashTable

    at = torch.from_numpy(rng.choice(cap, len(order), replace=False)).to(dev)

    def lane(vals):
        v = torch.from_numpy(np.asarray(vals)).to(dev)
        out = torch.zeros(cap, dtype=v.dtype, device=dev)
        out[at] = v
        return out

    glanes = tuple(lane(g) for g in groups)
    rows = {f"g{i}": g for i, g in enumerate(glanes)}
    rows["o"] = lane(order)
    table = HashTable.create(cap, tuple(g.dtype for g in glanes) + (torch.int64,), device=dev)
    for tk, g in zip(table.keys, glanes):
        tk.copy_(g)
    table.keys[-1].copy_(lane(np.asarray(pk, np.int64)))
    table.live.copy_(lane(np.asarray(live, np.bool_)))
    return table, rows, glanes, at


def x_hard_stores(torch, dev, rng) -> dict:
    """X against its plain version, per slot, on small stores built to
    reach each of its branches: ties in (group, order key) across the
    k-th place broken by pk (against slot order); groups of exactly k
    and k + 1 live rows under dead rows of better order values; a group
    of dead rows only, with an epoch-dirty slot; float order lanes with
    NaN, -0.0 and infinities; INT64 extremes in every lane; a packed key
    past 64 bits (the order key cut), and group lanes past 64 bits on
    their own (the inexact groups), once with several groups in one run
    of equal key; nine group lanes. Each with no slot, some slots and
    every slot epoch-dirty, k in (1, 3, 10, 11), ASC and DESC. Then
    ``x_long_runs``."""
    from risingwave_tpu_torch.executors import top_n_plain as tp

    i_min, i_max = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    stores = {}
    # ties and group sizes: g1 15 rows tied; g2 8 then 4 tied across the
    # 10th place; g3 exactly 10 live, g4 exactly 11, each under dead rows
    # of better order; g5 dead rows only
    g = np.repeat(np.arange(1, 6), (15, 12, 14, 15, 6)).astype(np.int64)
    o = np.r_[np.full(15, 5), np.full(8, 1), np.full(4, 5), rng.integers(0, 4, 10),
              np.full(4, i_min), rng.integers(0, 4, 11), np.full(4, i_min),
              np.full(6, -3)].astype(np.int64)
    live = np.r_[np.ones(37, bool), np.zeros(4, bool), np.ones(11, bool), np.zeros(10, bool)]
    pk = rng.permutation(len(g)).astype(np.int64)
    stores["ties"] = ((g,), o, pk, live)
    vals = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5])
    for ft in (np.float32, np.float64):
        n = 180
        stores[f"floats_{np.dtype(ft).name}"] = (
            (rng.integers(0, 6, n).astype(np.int64),), vals[rng.integers(0, 8, n)].astype(ft),
            np.arange(n, dtype=np.int64)[::-1].copy(), rng.random(n) < 0.8)
    ext = np.array([i_min, i_min + 1, -1, 0, 1, i_max - 1, i_max], np.int64)
    n = 140
    stores["int64_extremes"] = (
        (ext[rng.integers(0, 7, n)],), ext[rng.integers(0, 7, n)],
        np.r_[ext, rng.choice(1 << 40, n - 7, replace=False)].astype(np.int64),
        rng.random(n) < 0.85)
    # 40 varying group bits and a full 64-bit order key: the key is cut
    n = 400
    big = rng.integers(1 << 39, 1 << 40, 8)
    ords = rng.integers(i_min, i_max, 60, dtype=np.int64)
    stores["key_past_64"] = ((big[rng.integers(0, 8, n)].astype(np.int64),),
                             ords[rng.integers(0, 60, n)], np.arange(n, dtype=np.int64),
                             rng.random(n) < 0.9)
    # two full-range group lanes: the group bits alone pass 64
    n = 600
    ga = rng.integers(i_min, i_max, 4, dtype=np.int64)
    gb = rng.integers(i_min, i_max, 3, dtype=np.int64)
    stores["groups_past_64"] = ((ga[rng.integers(0, 4, n)], gb[rng.integers(0, 3, n)]),
                                rng.integers(0, 5, n).astype(np.int64),
                                rng.permutation(n).astype(np.int64), rng.random(n) < 0.9)
    # 1 + 64 group bits: a run of equal key holds the groups whose second
    # lane differs only in its low bits
    n = 600
    stores["groups_share_run"] = ((rng.integers(0, 2, n).astype(np.int64),
                                   np.array([0, 1, 2, 3, -1], np.int64)[rng.integers(0, 5, n)]),
                                  rng.integers(0, 3, n).astype(np.int64),
                                  rng.permutation(n).astype(np.int64), rng.random(n) < 0.9)
    n = 500
    stores["nine_group_lanes"] = (tuple(rng.integers(0, 2, n).astype(np.int64) for _ in range(9)),
                                  rng.integers(0, 4, n).astype(np.int64),
                                  rng.permutation(n).astype(np.int64), rng.random(n) < 0.9)
    n = 100
    stores["bool_group_int32_order"] = (
        (rng.random(n) < 0.5,), np.array([-2**31, -1, 0, 1, 2**31 - 1], np.int32)[
            rng.integers(0, 5, n)], np.arange(n, dtype=np.int64), rng.random(n) < 0.9)
    cases = 0
    for name, (groups, order, pk, lv) in stores.items():
        table, rows, glanes, at = x_store(torch, dev, rng, groups, order, pk, lv)
        some = torch.zeros(X_HARD_CAP, dtype=torch.bool, device=dev)
        some[at[torch.from_numpy(rng.random(len(at)) < 0.1).to(dev)]] = True
        some[at[-1]] = True  # g5's last dead row in "ties"
        none = torch.zeros_like(some)
        every = torch.ones_like(some)
        for dirty in (none, some, every):
            for k in (1, 3, 10, 11):
                for desc in (False, True):
                    got = tp._group_topk_mask_cuda(table, rows, dirty, k, desc, glanes, "o")
                    want = tp._group_topk_mask_torch(table, rows, dirty, k, desc, glanes, "o")
                    torch.cuda.synchronize()
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"X {name} (k {k}, desc {desc}): in_topk, gdirty")
                    cases += 1
    return {"hard_cases": cases, **x_long_runs(torch, dev, rng)}


X_LONG_CAP = 1 << 18  # slots of each of X's long-run stores
X_LONG_TIED = 150_000  # rows of the one tie run across the k-th place


def x_long_runs(torch, dev, rng) -> dict:
    """X against its plain version on runs of tied rows across the k-th
    place far longer than ``TOPK_LONG_RUN`` (sorted by
    ``rw_group_topk_long``, not counted by one warp): one group of
    ``X_LONG_TIED`` live rows of one order value beside 200 small groups
    (exact groups), and 120,000 rows whose group bits pass 64 in two runs
    of equal key of five groups each (inexact groups); k 1, 10 and 1,000,
    ASC and DESC, no slot and some slots epoch-dirty. X's time on each
    (k = 10), with the long entry's launches."""
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.executors import top_n_plain as tp

    n_small = 200 * 20
    n = X_LONG_TIED + n_small
    stores = {
        "tied": ((np.r_[np.zeros(X_LONG_TIED, np.int64),
                        np.repeat(np.arange(1, 201), 20).astype(np.int64)],),
                 np.r_[np.full(X_LONG_TIED, 7), rng.integers(0, 9, n_small)].astype(np.int64),
                 rng.permutation(n).astype(np.int64), rng.random(n) < 0.97),
    }
    n = 120_000
    stores["groups_share_run"] = ((rng.integers(0, 2, n).astype(np.int64),
                                   np.array([0, 1, 2, 3, -1], np.int64)[rng.integers(0, 5, n)]),
                                  rng.integers(0, 50, n).astype(np.int64),
                                  rng.permutation(n).astype(np.int64), rng.random(n) < 0.97)
    out = {}
    for name, (groups, order, pk, lv) in stores.items():
        table, rows, glanes, at = x_store(torch, dev, rng, groups, order, pk, lv, X_LONG_CAP)
        some = torch.zeros(X_LONG_CAP, dtype=torch.bool, device=dev)
        some[at[torch.from_numpy(rng.random(len(at)) < 0.01).to(dev)]] = True
        for dirty in (torch.zeros_like(some), some):
            for k in (1, 10, 1000):
                for desc in (False, True):
                    before = _kernels.LAUNCHES["group_topk_long"]
                    got = tp._group_topk_mask_cuda(table, rows, dirty, k, desc, glanes, "o")
                    want = tp._group_topk_mask_torch(table, rows, dirty, k, desc, glanes, "o")
                    torch.cuda.synchronize()
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"X long {name} (k {k}, desc {desc}): in_topk, gdirty")
                    check(_kernels.LAUNCHES["group_topk_long"] == before + 1,
                          f"X long {name} (k {k}): the long runs sorted")
        fn = lambda: tp._group_topk_mask_cuda(table, rows, some, 10, False, glanes, "o")
        out[f"long_{name}_ms"] = time_ms(torch, fn, 3)
        out[f"long_{name}_rows"] = len(order)
    return out


def kernel_vx(torch, dev, rng, chunks):
    """V and X at q19's shapes: a 2^26-slot retractable store after phase
    4's 20 epochs (each earlier epoch's marks cleared, as its barrier
    does); V on a 65,536-row chunk of U-/U+ pairs, deletes and inserts;
    then X (k = 10) over the store with the last epoch's and the chunk's
    epoch-dirty rows, per slot exact, and on ``x_hard_stores``."""
    from risingwave_tpu_torch.executors import top_n_plain as tp
    from risingwave_tpu_torch.queries.nexmark_q import build_q19

    q = build_q19(capacity=Q19_CAP, device=dev)
    rowid, topn = q.pipeline.executors[0], q.topn
    for i, ep in enumerate(chunks):
        if i:
            topn.epoch_dirty.zero_()
        for c in ep:
            topn.apply(rowid.apply(c)[0])
    top_id = rowid._base

    def fresh(m):
        ids = top_id + np.arange(m)
        return {"_row_id": ids, "auction": rng.integers(1000, 1_200_000, m),
                "bidder": rng.integers(1000, 400_000, m), "price": rng.integers(100, 10**8, m),
                "channel": rng.integers(0, 4, m).astype(np.int32),
                "date_time": np.full(m, 1_437_000_000_000)}

    chunk = pairs_chunk(torch, dev, rng, topn, CHUNK_EVENTS,
                        lambda p: (p * 7 + 13) % 10**8, fresh)
    v = v_compare(torch, dev, topn, chunk, "q19's 2^26 store", epoch_dirty=True)
    v_row = {"name": "V TopN row-store upsert", "route": "cuda",
             "source": "risingwave_tpu_torch/csrc/topn_upsert.cu",
             "replaces": "risingwave_tpu/executors/top_n_plain.py:53 (and :367, with "
                         "epoch_dirty)", "bound_by": "bytes", "library_ms": None,
             "library_call": "none (no PyTorch call applies an upsert with last-row-wins)", **v}
    args = (topn.table, topn.rows, topn.epoch_dirty, topn.limit, topn.desc, topn.group_by,
            topn.order_col)
    got = tp._group_topk_mask_cuda(topn.table, topn.rows, topn.epoch_dirty, topn.limit,
                                   topn.desc, (topn.rows["auction"],), topn.order_col)
    want = tp._group_topk_mask_torch(topn.table, topn.rows, topn.epoch_dirty, topn.limit,
                                     topn.desc, (topn.rows["auction"],), topn.order_col)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "X: in_topk, gdirty")
    ms = time_ms(torch, lambda: tp.group_topk_mask(*args), 3)
    dev_ms = device_time_ms(torch, lambda: tp.group_topk_mask(*args), 3)
    hard = x_hard_stores(torch, dev, rng)
    plain = time_ms(torch, lambda: tp._group_topk_mask_torch(
        topn.table, topn.rows, topn.epoch_dirty, topn.limit, topn.desc,
        (topn.rows["auction"],), topn.order_col), 1)
    okey = topn.rows["price"]
    lib = time_ms(torch, lambda: torch.sort(okey, stable=True), 3)
    cap = topn.table.capacity
    n_live = int(topn.table.live.sum())
    # what X must touch: per slot live and epoch_dirty read, the group
    # lanes read (gdirty), in_topk and gdirty written; per live row its
    # order lane read. The store keys that are not group lanes are read
    # only inside runs of tied rows across a group's k-th place (not
    # counted)
    g_bytes = sum(topn.rows[g].element_size() for g in topn.group_by)
    nbytes = cap * (1 + 1 + g_bytes + 2) + n_live * topn.rows[topn.order_col].element_size()
    x_row = {"name": "X group top-k mask", "route": "cuda",
             "source": "risingwave_tpu_torch/csrc/topn_rank.cu",
             "replaces": "risingwave_tpu/executors/top_n_plain.py:390",
             "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
             "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": lib,
             "library_call": "torch.sort(stable=True) of one 64-bit lane of the store (the "
                             "composite key's order lane alone)",
             "shape": {"capacity": cap, "live_rows": n_live, "k": topn.limit,
                       "epoch_dirty": int(topn.epoch_dirty.sum()),
                       "in_topk": int(got[0].sum()), "gdirty": int(got[1].sum()), **hard}}
    return v_row, x_row


W_HARD_CAP = 1 << 12  # slots of each of W's hard stores
W_TIE_CAP = 1 << 20  # slots of W's store whose live rows all tie


def w_store(torch, dev, order, pks, live):
    """A TopN row store for W alone: the lanes per slot, no key hashed (W
    reads live and the key lanes alone)."""
    from risingwave_tpu_torch.ops.hash_table import HashTable

    lanes = [torch.from_numpy(np.ascontiguousarray(k)).to(dev) for k in pks]
    table = HashTable.create(len(live), tuple(k.dtype for k in lanes), device=dev)
    for tk, k in zip(table.keys, lanes):
        tk.copy_(k)
    table.live.copy_(torch.from_numpy(np.asarray(live, np.bool_)).to(dev))
    return table, torch.from_numpy(np.ascontiguousarray(order)).to(dev)


def w_hard_stores(torch, dev, rng) -> dict:
    """W against its plain version, slot for slot, on small stores built
    to reach each of its branches: ties across the n-th place broken by
    the pk lanes; dead rows with stale lanes (INT64 extremes among their
    order values) for n past the live count; an all-dead store; float32
    and float64 order lanes with NaN, -0.0 and infinities; two full-range
    pk lanes (the packed key past 64 bits); int32 and bool pk lanes; each
    at n of 0, 1, inside the live rows, the live count, past it and the
    capacity, ASC and DESC. Then a 2^20-slot store whose live rows all
    tie on one order value (every live row a candidate, a multi-tile
    sort), at n = 1,000 and past its live count."""
    from risingwave_tpu_torch.executors import top_n_plain as tp

    cap = W_HARD_CAP
    i_min, i_max = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    live = rng.random(cap) < 0.6
    stale = rng.integers(-20, 20, cap).astype(np.int64)
    stale[~live & (rng.random(cap) < 0.2)] = i_min
    stale[~live & (rng.random(cap) < 0.2)] = i_max
    perm = rng.permutation(cap).astype(np.int64) - 100
    fvals = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5, 2.0])
    stores = {
        "stale_dead": (stale, [perm], live),
        "ties": (np.where(rng.random(cap) < 0.5, 7, rng.integers(-30, 30, cap)).astype(np.int64),
                 [rng.integers(-3, 3, cap).astype(np.int64), perm], live),
        "all_dead": (stale, [perm], np.zeros(cap, bool)),
        "float32": (fvals[rng.integers(0, 9, cap)].astype(np.float32), [perm], live),
        "float64": (fvals[rng.integers(0, 9, cap)], [perm], live),
        "wide_pk": (rng.integers(0, 3, cap).astype(np.int64),
                    [np.where(rng.random(cap) < 0.5, 12345,
                              rng.integers(i_min, i_max, cap, dtype=np.int64)),
                     rng.integers(i_min, i_max, cap, dtype=np.int64)], live),
        "pk_dtypes": (rng.integers(0, 4, cap).astype(np.int32),
                      [(rng.integers(-2**31, 2**31, cap) // 2**28).astype(np.int32),
                       rng.random(cap) < 0.5, (perm + 100).astype(np.int32)], live),
    }
    cases = 0
    for name, (order, pks, lv) in stores.items():
        table, lane = w_store(torch, dev, order, pks, lv)
        n_live = int(lv.sum())
        ns = sorted({0, 1, 37, n_live // 2, n_live, n_live + 1, n_live + 200, cap})
        for n in (m for m in ns if m <= cap):
            for desc in (False, True):
                got = tp._rank_top_cuda(table, lane, n, desc)
                want = tp._rank_top_torch(table, lane, n, desc)
                torch.cuda.synchronize()
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"W {name} (n {n}, desc {desc}): idx, alive")
                cases += 1
    live = rng.random(W_TIE_CAP) < 0.6
    table, lane = w_store(torch, dev, np.full(W_TIE_CAP, 60, np.int64),
                          [rng.permutation(W_TIE_CAP).astype(np.int64)], live)
    for n in (1000, int(live.sum()) + 1000):
        got = tp._rank_top_cuda(table, lane, n, True)
        want = tp._rank_top_torch(table, lane, n, True)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"W every live row tied (n {n}): idx, alive")
        cases += 1
    return {"hard_cases": cases}


def kernel_vw(torch, dev, rng):
    """V and W at q105's shapes: a 2^22-slot TopN store of 1.2M auctions
    whose counts tie 5,000 rows at the 1,000th rank, with 200 dead rows
    of the largest counts; V on a 65,536-row chunk of U-/U+ count
    changes, deletes and inserts; then W (n = 1,000, DESC) exact, and on
    ``w_hard_stores``."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import top_n_plain as tp
    from risingwave_tpu_torch.ops.agg import topn_order_key
    from risingwave_tpu_torch.types import Op

    i64 = torch.int64
    dtypes = {"id": i64, "item_name": torch.int32, "auction": i64, "bid_count": i64}
    topn = tp.TopNExecutor("bid_count", 1000, ("id", "auction"), dtypes, desc=True,
                           capacity=Q105_CAP, device=dev)
    ids = 1000 + np.arange(W_LIVE, dtype=np.int64)
    counts = rng.integers(1, 60, W_LIVE)
    counts[rng.permutation(W_LIVE)[:W_TIED]] = 60
    counts[rng.permutation(W_LIVE)[:400]] = 1000 + rng.permutation(100_000)[:400]
    cols = {"id": ids, "item_name": rng.integers(0, 100, W_LIVE).astype(np.int32),
            "auction": ids, "bid_count": counts}
    for at in range(0, W_LIVE, CHUNK_EVENTS):
        topn.apply(StreamChunk.from_numpy({c: v[at:at + CHUNK_EVENTS] for c, v in cols.items()},
                                          CHUNK_EVENTS, device=dev))
    dead = {"id": 10**9 + np.arange(200), "item_name": np.zeros(200, np.int32),
            "auction": 10**9 + np.arange(200), "bid_count": np.full(200, 2**62)}
    for op in (Op.INSERT, Op.DELETE):
        topn.apply(StreamChunk.from_numpy(dead, 256, ops=np.full(200, int(op), np.int32),
                                          device=dev))
    top_id = 2 * 10**9

    def fresh(m):
        new_ids = top_id + np.arange(m)
        return {"id": new_ids, "item_name": np.zeros(m, np.int32), "auction": new_ids,
                "bid_count": np.ones(m, np.int64)}

    chunk = pairs_chunk(torch, dev, rng, topn, CHUNK_EVENTS, lambda c: c + 1, fresh)
    v = v_compare(torch, dev, topn, chunk, "q105's 2^22 store", epoch_dirty=False)
    v_row = {"name": "V TopN row-store upsert (q105)", "route": "cuda",
             "source": "risingwave_tpu_torch/csrc/topn_upsert.cu",
             "replaces": "risingwave_tpu/executors/top_n_plain.py:53", "bound_by": "bytes",
             "library_ms": None,
             "library_call": "none (no PyTorch call applies an upsert with last-row-wins)", **v}
    lane = topn.rows["bid_count"]
    got = tp._rank_top_cuda(topn.table, lane, 1000, True)
    want = tp._rank_top_torch(topn.table, lane, 1000, True)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "W: idx, alive")
    check(bool(got[1].all()), "W: no dead row among the top 1,000")
    top_counts = lane[got[0].long()]
    nth = int(top_counts[-1])
    tied = int((topn.table.live & (lane == nth)).sum())
    check(tied >= 1000, f"W: thousands of rows tied at the 1,000th count ({tied})")
    ms = time_ms(torch, lambda: tp.rank_top(topn.table, lane, 1000, True), 20)
    dev_ms = device_time_ms(torch, lambda: tp.rank_top(topn.table, lane, 1000, True), 3)
    hard = w_hard_stores(torch, dev, rng)
    plain = time_ms(torch, lambda: tp._rank_top_torch(topn.table, lane, 1000, True), 3)
    key = topn_order_key(lane, True)
    lib = time_ms(torch, lambda: torch.topk(key, 1000, largest=False), 20)
    cap = topn.table.capacity
    # what W must touch: live 1 and the order lane 8 read per slot; the
    # two pk lanes (16) only for the rows tied at the n-th order key,
    # which they order; n slots and their liveness written
    nbytes = cap * 9 + tied * 16 + 1000 * 5
    w_row = {"name": "W top-n rank", "route": "cuda",
             "source": "risingwave_tpu_torch/csrc/topn_rank.cu",
             "replaces": "risingwave_tpu/executors/top_n_plain.py:86",
             "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
             "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": lib,
             "library_call": "torch.topk of the flipped order key (liveness and ties left out)",
             "shape": {"capacity": cap, "live_rows": int(topn.table.live.sum()), "n": 1000,
                       "nth_count": nth, "tied_at_nth": tied, "dead_extreme_rows": 200,
                       **hard}}
    return v_row, w_row


def q19_paths(torch, dev, chunks):
    """Phases 21 and 22: q19 on the retractable GroupTopN (``build_q19``)
    and on the append-only one (``build_q19_append_only``), each
    interpreted and through ``fuse_pipeline`` (the MV fused behind the
    TopN), over phase 4's chunks in lockstep. At every barrier the four
    MVs' kernel-H digests are equal; at barriers Q19_CHECKS every MV
    equals the numpy oracle; at the end each fused run's staged digest
    equals host_digest of its MV read back, and each TopN's state digest
    its interpreted twin's."""
    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.queries.nexmark_q import build_q19, build_q19_append_only
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    check_sync_guard(torch, dev)
    builds = {
        "q19": lambda: build_q19(capacity=Q19_CAP, mv_capacity=Q19_MV_CAP, device=dev),
        "q19_ao": lambda: build_q19_append_only(capacity=Q19AO_CAP, out_cap=Q19AO_OUT_CAP,
                                                mv_capacity=Q19_MV_CAP, device=dev),
    }
    qs, wrappers, chains = {}, {}, {}
    for name, build in builds.items():
        for fused in (False, True):
            q = build()
            key = name + ("_fused" if fused else "")
            if fused:
                (w,) = fuse_pipeline(q.pipeline, label=key)
                chains[key] = [type(e).__name__ for e in q.pipeline.executors]
                check(w.members == [q.mview] and chains[key][-1] == "FusedChainExecutor",
                      f"{key}: the MV fused behind the TopN")
                wrappers[key] = w
            qs[key] = q
    host = q19_host(chunks)
    oracle = {"top": None, "upto": 0}
    launches = PathLaunches()

    def push(pipe, ep):
        for c in ep:
            pipe.push(c)

    per_barrier = []

    def after(e):
        digs = {k: mv_digest(q.mview) for k, q in qs.items()}
        check(len(set(digs.values())) == 1, f"q19 barrier {e}: the four MVs' digests {digs}")
        per_barrier.append(digs["q19"])
        if e not in Q19_CHECKS:
            return
        parts = host[oracle["upto"]:e + 1] + ([oracle["top"]] if oracle["top"] else [])
        oracle["top"] = q19_top({n: np.concatenate([p[n] for p in parts]) for n in Q19_COLS})
        oracle["upto"] = e + 1
        want = q19_rows(oracle["top"])
        for k, q in qs.items():
            got = q19_rows(q.mview.to_numpy())
            check(np.array_equal(got, want), f"{k}: MV ({len(got)} rows) vs the oracle "
                  f"({len(want)} rows) at barrier {e}")

    torch.cuda.reset_peak_memory_stats()
    rec = lockstep(torch, {k: q.pipeline for k, q in qs.items()}, chunks, push, launches, after)
    peak = torch.cuda.max_memory_allocated()
    for key, w in wrappers.items():
        mv = integrity.host_digest(*integrity.host_lanes(*integrity.mv_lanes(
            qs[key].mview.table, qs[key].mview.state)))
        check(w.last_digests.get("mv") == mv, f"{key}: staged MV digest vs host_digest")
        twin = qs[key.replace("_fused", "")].topn
        check(qs[key].topn.state_digest() == twin.state_digest(),
              f"{key}: TopN state vs the interpreted run's")
    for key in qs:
        for kern in TOPN_KERNELS[key.replace("_fused", "")]:
            check(launches.by[key][kern] > 0, f"{key}: kernel {kern} launched")
    bids = sum(len(h["auction"]) for h in host)
    rows = [path_row(key, bids, rec[key], mv_rows=int(q.mview.table.live.sum()),
                     mv_capacity=q.mview.table.capacity, launches=launches.by[key],
                     chain=chains.get(key)) for key, q in qs.items()]
    rows[0].update(
        store_capacity=qs["q19"].topn.table.capacity, bands=[qs["q19_ao"].topn.table.capacity,
                                                             qs["q19_ao"].topn.k],
        out_cap=Q19AO_OUT_CAP, checked_barriers=list(Q19_CHECKS), max_memory_allocated=int(peak),
        oracle="the four MVs' kernel-H digests equal at every barrier; each MV = the numpy "
               "oracle (per auction the 10 highest prices, ties to the earlier bid) at the "
               "checked barriers; staged MV digests = host_digest of the lanes read back; "
               "fused TopN state = interpreted")
    return rows, launches.by, per_barrier


def q105_paths(torch, dev, host, chunks):
    """Phase 23: RisingWave's q105 (``build_q105``) over phase 11's stream
    (an auction chunk left, the bid chunks right, per epoch), interpreted
    and through ``fuse_pipeline``: the whole program is refused for the
    TopN in its tail and each chain falls back, the decision the
    reference's ``fuse_pipeline`` makes for this plan (held equal on the
    CPU, ``tests/test_torch_q105.py``); the MVs equal the numpy oracle
    (the 1,000 auctions with the most bids, ties to the lower id) and
    each other at every barrier."""
    from risingwave_tpu_torch.queries.nexmark_q import Q105_TOP, build_q105
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals

    fusion_refusals(clear=True)
    qs, chains = {}, {}
    for fused in (False, True):
        q = build_q105(capacity=Q105_CAP, fanout=Q105_FANOUT, out_cap=Q105_OUT_CAP,
                       topn_capacity=Q105_CAP, device=dev)
        key = "q105" + ("_fused" if fused else "")
        if fused:
            fuse_pipeline(q.pipeline, label=key)
            chains[key] = [[type(e).__name__ for e in getattr(q.pipeline, a)]
                           for a in ("left", "right", "tail")]
            check(chains[key] == [[], ["EpochBatchedAggExecutor"],
                                  ["TopNExecutor", "FusedChainExecutor"]],
                  f"{key}: the per-chain fallback")
        qs[key] = q
    refusals = fusion_refusals()
    check([(r["fragment"], r["executor"]) for r in refusals] == [("q105_fused/tail",
                                                                  "TopNExecutor")],
          "q105: whole-pipeline fusion refused for the TopN in the tail")
    top = max(int(a["id"].max()) for a, _ in host) + 1
    counts = np.zeros(top, np.int64)
    items = np.zeros(top, np.int64)
    seen = np.zeros(top, bool)
    launches = PathLaunches()

    def push(pipe, ep):
        a, bids = ep
        pipe.push_left(a)
        for b in bids:
            pipe.push_right(b)

    def after(e):
        a, bids = host[e]
        seen[a["id"]] = True
        items[a["id"]] = a["item_name"]
        for b in bids:
            counts[:] += np.bincount(b["auction"], minlength=top)[:top]
        ids = np.flatnonzero(seen & (counts > 0))
        o = np.lexsort((ids, -counts[ids]))[:Q105_TOP]
        want = np.stack([ids[o], items[ids[o]], counts[ids[o]]], 1)
        want = want[np.argsort(want[:, 0])]
        for key, q in qs.items():
            d = q.mview.to_numpy()
            got = np.stack([d["id"], d["item_name"].astype(np.int64), d["bid_count"]], 1)
            got = got[np.argsort(got[:, 0])]
            check(np.array_equal(got, want), f"{key}: MV vs the oracle at barrier {e}")

    torch.cuda.reset_peak_memory_stats()
    rec = lockstep(torch, {k: q.pipeline for k, q in qs.items()}, chunks, push, launches, after)
    peak = torch.cuda.max_memory_allocated()
    for key in qs:
        for kern in TOPN_KERNELS["q105"]:
            check(launches.by[key][kern] > 0, f"{key}: kernel {kern} launched")
    rows_in = sum(len(a["id"]) + sum(len(b["auction"]) for b in bids) for a, bids in host)
    rows = [path_row(key, rows_in, rec[key], mv_rows=int(q.mview.table.live.sum()),
                     launches=launches.by[key], chains=chains.get(key))
            for key, q in qs.items()]
    rows[0].update(refusals=refusals, agg_capacity=Q105_CAP, join=[Q105_CAP, Q105_FANOUT],
                   topn_capacity=Q105_CAP, out_cap=Q105_OUT_CAP, limit=Q105_TOP,
                   max_memory_allocated=int(peak),
                   oracle="numpy: the 1,000 auctions with the most bids so far (ties to the "
                          "lower id) at every barrier; fallback = interpreted: equal")
    return rows, launches.by


def kill_q19(torch, dev, chunks):
    """Phase 16's q19: phase 4's first WIN_KILL_EPOCHS epochs (the kill
    after barrier WIN_KILL_AT), phase 21's sizes (the retractable store
    and its mirror rebuilt on recovery)."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q19

    ep = chunks[:WIN_KILL_EPOCHS]
    host = q19_host(ep)
    oracle = q19_rows(q19_top({n: np.concatenate([h[n] for h in host]) for n in Q19_COLS}))

    def drive(q, e):
        for c in ep[e]:
            q.pipeline.push(c)
        q.pipeline.barrier()

    spec = KillSpec("q19", lambda: build_q19(capacity=Q19_CAP, mv_capacity=Q19_MV_CAP,
                                             device=dev),
                    drive, lambda q: q19_rows(q.mview.to_numpy()), oracle,
                    depth=(WIN_KILL_EPOCHS, WIN_KILL_AT))
    return kill_and_recover(torch, dev, spec)


def kill_q105(torch, dev, host, chunks):
    """Phase 16's q105: phase 11's first KILL_EPOCHS epochs, phase 23's
    sizes (the TopN's emitted mirror recomputed on recovery)."""
    from risingwave_tpu_torch.queries.nexmark_q import Q105_TOP, build_q105

    ids = np.concatenate([a["id"] for a, _ in host[:KILL_EPOCHS]])
    item = np.concatenate([a["item_name"] for a, _ in host[:KILL_EPOCHS]]).astype(np.int64)
    u, c = np.unique(np.concatenate([b["auction"] for _, bids in host[:KILL_EPOCHS]
                                     for b in bids]), return_counts=True)
    pos = np.clip(np.searchsorted(u, ids), 0, len(u) - 1)
    has = u[pos] == ids
    ids, item, cnt = ids[has], item[has], c[pos[has]]
    o = np.lexsort((ids, -cnt))[:Q105_TOP]
    oracle = np.stack([ids[o], item[o], cnt[o]], 1)
    oracle = oracle[np.argsort(oracle[:, 0])]

    def drive(q, e):
        a, bids = chunks[e]
        q.pipeline.push_left(a)
        for b in bids:
            q.pipeline.push_right(b)
        q.pipeline.barrier()

    def rows(q):
        d = q.mview.to_numpy()
        got = np.stack([d["id"], d["item_name"].astype(np.int64), d["bid_count"]], 1)
        return got[np.argsort(got[:, 0])]

    spec = KillSpec("q105", lambda: build_q105(capacity=Q105_CAP, fanout=Q105_FANOUT,
                                               out_cap=Q105_OUT_CAP, topn_capacity=Q105_CAP,
                                               device=dev),
                    drive, rows, oracle)
    return kill_and_recover(torch, dev, spec)



# -- phase 3, kernels Y and Z; phase 24: q102 (SimpleAgg and the general filter) --
# q102 (phase 24) over phase 11's stream at q105's sizes: both counts 2^22,
# join sides (2^22, 4), out_cap 2^17, the filter's row store and the MV 2^22
Q102_CAP = 1 << 22
Y_ROWS = 1 << 17  # a flush chunk of the second count: 65,536 U-/U+ pairs
Z_ROWS = 1 << 17  # a left chunk of the filter: 65,536 U-/U+ pairs
Z_LIVE = 1_200_000  # the filter's rows: q102's joined auctions after 20 epochs
SUM_RTOL = 1e-12  # float64 sums, relative to the sum of the magnitudes
# float32 sums of n rows: 4 sqrt(n) 2^-24 of the sum of the magnitudes,
# the statistical size of n float32 roundings in either order of addition
F32_SUM_TOL = 4 * 2**-24
Q102_KERNELS = ("lookup_or_insert", "agg_flush", "join_probe", "join_apply", "simple_agg",
                "expr_eval", "dyn_general", "dyn_rv_diff", "gather_rows", "mv_upsert")


def y_chunk(torch, dev, rng, n: int, retract: bool):
    """A flush chunk of q102's second count (``bid_count`` int64) with a
    float64 lane ``f`` and a float32 lane ``g`` (NULLs in ``f``): U-/U+
    pairs, each raising ``bid_count`` by 1 and ``g`` by 0 to 2, when
    ``retract``, else inserts."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.types import Op

    counts = rng.integers(1, 200, n // 2).astype(np.int64)
    cols = {"bid_count": np.stack([counts, counts + 1], 1).reshape(-1),
            "f": rng.standard_normal(n) * 1e3, "g": (rng.standard_normal(n) * 50).astype(
                np.float32)}
    ops = np.full(n, int(Op.INSERT), np.int32)
    if retract:
        ops = np.tile(np.asarray([int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)], np.int32),
                      n // 2)
        # each update moves g up by 0 to 2, so its signed sum is about n / 2
        cols["g"][1::2] = cols["g"][0::2] + rng.uniform(0, 2, n // 2).astype(np.float32)
    nulls = {"f": rng.random(n) < 0.1}
    return StreamChunk.from_numpy(cols, n, ops=ops, nulls=nulls, device=dev), cols


def kernel_y(torch, dev, rng):
    """Y against its plain version on the card (phase 3): q102's two calls
    (COUNT(*), SUM(bid_count)) with a COUNT, a float64 and a float32 SUM
    on a 2^17-row U-/U+ flush chunk; then an append-only chunk through
    MIN/MAX calls (int64 MIN, float64 MAX, float32 MIN) and one retraction
    of the MIN, which must latch. Integer lanes exact, float64 sums within
    SUM_RTOL of the sum of magnitudes, float32 within 4 sqrt(n) 2^-24 of
    it; each sum's plain value more than 4 tolerances from 0."""
    from risingwave_tpu_torch.executors import simple_agg as sa
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops.agg import AggCall

    dtypes = {"bid_count": torch.int64, "f": torch.float64, "g": torch.float32}
    flush_calls = (AggCall("count_star", None, "n_auctions"),
                   AggCall("sum", "bid_count", "n_bids"), AggCall("count", "f", "nf"),
                   AggCall("sum", "f", "sf"), AggCall("sum", "g", "sg"))
    ext_calls = (AggCall("count_star", None, "n"), AggCall("min", "bid_count", "mn"),
                 AggCall("max", "f", "mx"), AggCall("min", "g", "mg"), AggCall("sum", "f", "sf"))

    def compare(calls, chunk, cols, what):
        fresh = lambda: agg_ops.create_state(2, calls, dtypes, dev)
        got = sa._simple_step_cuda(fresh(), chunk, calls)
        want = sa._simple_step_torch(fresh(), chunk, calls)
        torch.cuda.synchronize()
        a, b = state_lanes(got), state_lanes(want)
        sums = {f"accums.{c.output}" for c in calls if c.kind == "sum"}
        err = 0.0
        for k in a:
            x, y = a[k], b[k]
            if not x.is_floating_point():
                check(torch.equal(x, y), f"Y {what}: lane {k}")
                continue
            lane = "f" if x.dtype == torch.float64 else "g"
            mag = float(np.abs(cols[lane]).sum())
            tol = SUM_RTOL * mag if lane == "f" else F32_SUM_TOL * chunk.capacity**0.5 * mag
            d = float((x.double() - y.double()).abs().max())
            check(d <= tol, f"Y {what}: {k} differs by {d} > {tol}")
            if k in sums:  # the plain value lies well outside the tolerance
                check(float(y.double().abs().max()) > 4 * tol, f"Y {what}: {k} near 0")
            err = max(err, d)
        return err, got

    chunk, cols = y_chunk(torch, dev, rng, Y_ROWS, retract=True)
    err_flush, st = compare(flush_calls, chunk, cols, "flush chunk")
    check(int(st.accums["n_auctions"][0]) == 0 and int(st.row_count[0]) == 0,
          "Y: each U-/U+ pair nets to 0 in COUNT(*)")
    check(int(st.accums["n_bids"][0]) == Y_ROWS // 2, "Y: SUM(bid_count) of the pairs")
    ins, icols = y_chunk(torch, dev, rng, Y_ROWS, retract=False)
    err_ext, _ = compare(ext_calls, ins, icols, "append-only extremes")
    # one retraction of the MIN: both latch
    one, _ = y_chunk(torch, dev, rng, 2, retract=True)
    for fn in (sa._simple_step_cuda, sa._simple_step_torch):
        st = agg_ops.create_state(2, ext_calls, dtypes, dev)
        fn(st, one, ext_calls)
        check(bool(st.minmax_retracted), f"Y: {fn.__name__} latches a MIN retraction")
    state = agg_ops.create_state(2, flush_calls, dtypes, dev)
    ms = time_ms(torch, lambda: sa._simple_step_cuda(state, chunk, flush_calls), 20)
    plain = time_ms(torch, lambda: sa._simple_step_torch(state, chunk, flush_calls), 5)
    signed = chunk.col("bid_count") * chunk.effective_signs().to(torch.int64)
    lib = time_ms(torch, lambda: torch.sum(signed), 20)
    # valid 1 and ops 4 read per row; bid_count 8, f 8 with its null 1, g 4
    nbytes = Y_ROWS * (1 + 4 + 8 + 8 + 1 + 4)
    return {
        "name": "Y SimpleAgg apply", "route": "cuda", "source": "risingwave_tpu_torch/csrc/simple_agg.cu",
        "replaces": "risingwave_tpu/executors/simple_agg.py:37",
        "max_abs_err": max(err_flush, err_ext), "ms": ms, "plain_ms": plain,
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": lib,
        "library_call": "torch.sum of the signed bid_count lane (the fold alone)",
        "tolerance": f"integers exact; float64 sums {SUM_RTOL} of sum|x|; float32 sums "
                     "4 sqrt(n) 2^-24 sum|x|",
        "shape": {"rows": Y_ROWS, "calls": [c.kind for c in flush_calls],
                  "extreme_calls": [c.kind for c in ext_calls]},
    }


def filter_store(torch, dev, rng):
    """q102's filter at phase 24's size: a 2^22-slot row store of Z_LIVE
    joined auctions (id = auction, item_name, bid_count), inserted through
    the executor (kernels A and Z) in Z_ROWS-row chunks, its right value
    at the mean count."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import DynamicFilterExecutor

    i64 = torch.int64
    dtypes = {"id": i64, "item_name": torch.int32, "auction": i64, "bid_count": i64}
    ex = DynamicFilterExecutor("bid_count", ">=", ("id", "auction"), dtypes, capacity=Q102_CAP,
                               table_id="z.filter", device=dev)
    ids = 1000 + np.arange(Z_LIVE, dtype=np.int64)
    counts = rng.integers(1, 40, Z_LIVE).astype(np.int64)
    items = rng.integers(0, 10_000, Z_LIVE).astype(np.int32)
    for at in range(0, Z_LIVE, Z_ROWS):
        sl = slice(at, at + Z_ROWS)
        ex.apply_left(StreamChunk.from_numpy(
            {"id": ids[sl], "item_name": items[sl], "auction": ids[sl], "bid_count": counts[sl]},
            Z_ROWS, device=dev))
    ex.rv.fill_(15)
    ex.rv_valid.fill_(True)
    ex.passing.copy_(ex.table.live & (ex.rows["bid_count"] >= ex.rv))
    return ex, ids, items, counts


def z_lanes(ex) -> dict:
    lanes = {f"k{i}": k.clone() for i, k in enumerate(ex.table.keys)}
    lanes.update({f"r_{n}": a.clone() for n, a in ex.rows.items()})
    lanes.update(live=ex.table.live.clone(), passing=ex.passing.clone(),
                 sdirty=ex.sdirty.clone(), scratch=ex.scratch.clone(),
                 dropped=ex._dropped.clone())
    return lanes


def z_restore(ex, lanes) -> None:
    for n, a in ex.rows.items():
        a.copy_(lanes[f"r_{n}"])
    for name, dst in (("live", ex.table.live), ("passing", ex.passing), ("sdirty", ex.sdirty),
                      ("scratch", ex.scratch), ("dropped", ex._dropped)):
        dst.copy_(lanes[name])


def kernel_z(torch, dev, rng):
    """Z against its plain versions on the card (phase 3), on
    ``filter_store``'s 1.2M rows in 2^22 slots. The left step: a 2^17-row
    chunk of 65,536 U-/U+ pairs (count c -> c + 1) of stored pks, one
    insert-then-delete and one delete-then-insert of a pk among them,
    after one kernel-A lookup; every row lane, live, pass, sdirty and the
    scratch lane exact, the pass-through mask exact. The diff: the right
    value moved up (15 -> 25) and then down (25 -> 5) over the store; the
    changed slots in order, their status, pass and sdirty exact."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import dynamic_filter as df
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.types import Op

    ex, ids, items, counts = filter_store(torch, dev, rng)
    pick = rng.choice(Z_LIVE, Z_ROWS // 2, replace=False)
    pid, pc = np.repeat(ids[pick], 2), np.stack([counts[pick], counts[pick] + 1], 1).reshape(-1)
    ops = np.tile(np.asarray([int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)], np.int32),
                  Z_ROWS // 2)
    ops[:2] = [int(Op.INSERT), int(Op.DELETE)]  # a new pk in and out
    pid[:2] = 10**9
    ops[2:4] = [int(Op.DELETE), int(Op.INSERT)]  # a stored pk out and back
    cols = {"id": pid, "item_name": np.repeat(items[pick], 2), "auction": pid, "bid_count": pc}
    chunk = StreamChunk.from_numpy(cols, Z_ROWS, ops=ops, device=dev)
    active = chunk.valid & (chunk.effective_signs() != 0)
    _, slots, _, _ = ht.lookup_or_insert(ex.table, (chunk.col("id"), chunk.col("auction")),
                                         active)
    base = z_lanes(ex)
    signs = chunk.effective_signs()

    def left(fn):
        if fn == "cuda":
            return df._dyn_left_cuda(ex.table, ex.rows, ex.passing, ex.sdirty, ex.scratch, chunk,
                                     slots, ex.rv, ex.rv_valid, ex.op, ex.value_col, ex._dropped)
        return df._dyn_left_torch(ex.table, ex.rows, ex.passing, ex.sdirty, chunk, slots, signs,
                                  active, ex.rv, ex.rv_valid, ex.op, ex.value_col, ex._dropped)

    outs = []
    for fn in ("cuda", "torch"):
        z_restore(ex, base)
        ok = left(fn)
        outs.append((ok.clone(), z_lanes(ex)))
    torch.cuda.synchronize()
    check(torch.equal(outs[0][0], outs[1][0]), "Z left: pass-through mask")
    assert_lanes_equal(torch, outs[0][1], outs[1][1], "Z left: store lanes")
    check(bool((ex.scratch == -1).all()), "Z left: scratch reset")
    passed = int(outs[0][0].sum())
    err_left = max_abs_diff(torch, outs[0][1], outs[1][1])
    left_ms = time_ms(torch, lambda: left("cuda"), 20, setup=lambda: z_restore(ex, base))
    left_plain = time_ms(torch, lambda: left("torch"), 3, setup=lambda: z_restore(ex, base))
    z_restore(ex, base)
    left("cuda")
    after_left = z_lanes(ex)
    winners = len(np.unique(pid))  # one row per pk of the chunk wins its slot
    # per row valid 1, ops 4, slots 4 and value 8 read and the mask 1
    # written; per winner its other lanes (id, item_name, auction) 20 read,
    # its lanes 28 and live, sdirty, pass 3 written (the election's
    # scratch lane is the kernel's own bookkeeping, not counted)
    left_bytes = Z_ROWS * (1 + 4 + 4 + 8 + 1) + winners * (20 + 28 + 3)

    value = ex.rows["bid_count"]
    diffs, flips = [], []
    for new_rv in (25, 5):
        rv = torch.tensor(new_rv, dtype=torch.int64, device=dev)
        res = []
        for fn in (df._dyn_rv_diff_cuda, df._dyn_rv_diff_torch):
            z_restore(ex, after_left)
            sel, now, n, dropped = fn(ex.table, value, ex.passing, ex.sdirty, rv, ex.rv_valid,
                                      ex.op, ex._dropped)
            res.append((sel.clone(), now.clone(), n, dropped, ex.passing.clone(),
                        ex.sdirty.clone()))
        torch.cuda.synchronize()
        (s1, n1, c1, d1, p1, sd1), (s2, n2, c2, d2, p2, sd2) = res
        check(c1 == c2 and not d1 and not d2, f"Z diff to {new_rv}: count {c1} vs {c2}")
        check(torch.equal(s1, s2) and torch.equal(n1, n2), f"Z diff to {new_rv}: slots, status")
        check(torch.equal(p1, p2) and torch.equal(sd1, sd2), f"Z diff to {new_rv}: pass, sdirty")
        flips.append(c1)
        diffs.append((rv, after_left))
        after_left = z_lanes(ex)
    check(flips[0] > 0 and flips[1] > 0, "Z diff: rows flip both ways")
    rv, lanes = diffs[0]
    setup = lambda: z_restore(ex, lanes)
    diff_ms = time_ms(torch, lambda: df._dyn_rv_diff_cuda(
        ex.table, value, ex.passing, ex.sdirty, rv, ex.rv_valid, ex.op, ex._dropped), 20,
        setup=setup)
    diff_plain = time_ms(torch, lambda: df._dyn_rv_diff_torch(
        ex.table, value, ex.passing, ex.sdirty, rv, ex.rv_valid, ex.op, ex._dropped), 5,
        setup=setup)
    diff_lib = time_ms(torch, lambda: torch.ne(ex.table.live & ex.rv_valid & (value >= rv),
                                               ex.passing), 20, setup=setup)
    cap = ex.table.capacity
    # live 1, value 8 and pass 1 read per slot; per flipped slot pass 1,
    # sdirty 1, its slot 4 and status 1 written
    diff_bytes = cap * 10 + flips[0] * 7
    shape = {"capacity": cap, "live_rows": int(ex.table.live.sum()), "chunk_rows": Z_ROWS,
             "passed": passed, "rv_moves": [15, 25, 5], "flipped": flips}
    left_row = {
        "name": "Z dynamic filter left step", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/dyn_general.cu",
        "replaces": "risingwave_tpu/executors/dynamic_filter.py:417", "max_abs_err": err_left,
        "ms": left_ms, "plain_ms": left_plain, "bound_ms": bound_ms(left_bytes),
        "bound_by": "bytes", "library_ms": None,
        "library_call": "none (no PyTorch call scatters with the last row winning)",
        "shape": shape,
    }
    diff_row = {
        "name": "Z dynamic filter right-value diff", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/dyn_general.cu",
        "replaces": "risingwave_tpu/executors/dynamic_filter.py:442", "max_abs_err": 0.0,
        "ms": diff_ms, "plain_ms": diff_plain, "bound_ms": bound_ms(diff_bytes),
        "bound_by": "bytes", "library_ms": diff_lib,
        "library_call": "torch.ne(live & rv_valid & (value >= rv), passing), the mask alone",
        "shape": shape,
    }
    return left_row, diff_row


def q102_oracle(host, upto: int) -> np.ndarray:
    """q102's MV after epochs 0..upto as sorted (id, item_name, count)
    rows: per-auction counts of every bid so far, rv = all bids //
    auctions with a bid, joined with the auctions seen, count >= rv."""
    ids = np.concatenate([a["id"] for a, _ in host[:upto + 1]])
    items = np.concatenate([a["item_name"] for a, _ in host[:upto + 1]]).astype(np.int64)
    u, c = np.unique(np.concatenate([b["auction"] for _, bids in host[:upto + 1] for b in bids]),
                     return_counts=True)
    rv = int(c.sum()) // len(u)
    pos = np.clip(np.searchsorted(u, ids), 0, len(u) - 1)
    keep = (u[pos] == ids) & (c[pos] >= rv)
    rows = np.stack([ids[keep], items[keep], c[pos[keep]]], 1)
    return rows[np.argsort(rows[:, 0])]


def q102_rows(q) -> np.ndarray:
    d = q.mview.to_numpy()
    check(bool(np.array_equal(d["id"], d["auction"])), "q102: MV pk id = auction")
    rows = np.stack([d["id"], d["item_name"].astype(np.int64), d["bid_count"]], 1)
    return rows[np.argsort(rows[:, 0])]


def build_q102_full(dev):
    from risingwave_tpu_torch.queries.nexmark_q import build_q102

    return build_q102(capacity=Q102_CAP, fanout=Q105_FANOUT, out_cap=Q105_OUT_CAP, device=dev)


def q102_paths(torch, dev, host, chunks):
    """Phase 24: RisingWave's q102 (``build_q102``) over phase 11's stream
    (an auction chunk, then the bid chunks, per epoch), interpreted and
    with each stage through ``fuse_pipeline``: stage 1 one
    ``FusedTwoInputExecutor`` program per barrier, stage 2's whole program
    refused (a dynamic filter is not a HashJoin) and its chains per chain,
    the refusals those ``tests/test_torch_q102.py`` pins. Each MV equals
    the numpy oracle at every barrier, the fused one the interpreted one;
    the SimpleAgg's and the filter's kernel-H digests equal host_digest of
    their lanes read back, and the fused run's states the interpreted
    run's."""
    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals

    fusion_refusals(clear=True)
    qs, chains = {}, {}
    for fused in (False, True):
        q = build_q102_full(dev)
        key = "q102" + ("_fused" if fused else "")
        if fused:
            made = fuse_pipeline(q.stage1, label=f"{key}/1") + fuse_pipeline(q.stage2,
                                                                               label=f"{key}/2")
            check([type(w).__name__ for w in made] == ["FusedTwoInputExecutor"],
                  f"{key}: stage 1 one program")
            chains[key] = [[type(e).__name__ for e in getattr(q.stage2, a)]
                           for a in ("left", "right", "tail")]
            check(chains[key] == [[], ["EpochBatchedAggExecutor", "SimpleAggExecutor",
                                       "ProjectExecutor"], ["DeviceMaterializeExecutor"]],
                  f"{key}: stage 2's per-chain fallback")
        qs[key] = q
    refusals = fusion_refusals()
    check([(r["code"], r["fragment"], r["executor"]) for r in refusals] == [
        ("RW-E807", "q102_fused/2", "DynamicFilterExecutor"),
        ("RW-E807", "q102_fused/2/tail", "DynamicFilterExecutor")],
        "q102: the refusals of the CPU test")
    launches = PathLaunches()

    def push(q, ep):
        a, bids = ep
        q.push_auction(a)
        for b in bids:
            q.push_bid(b)

    def after(e):
        want = q102_oracle(host, e)
        got = {k: q102_rows(q) for k, q in qs.items()}
        for k, rows in got.items():
            check(np.array_equal(rows, want), f"{k}: MV ({len(rows)} rows) vs the oracle "
                  f"({len(want)} rows) at barrier {e}")

    torch.cuda.reset_peak_memory_stats()
    rec = lockstep(torch, qs, chunks, push, launches, after)
    peak = torch.cuda.max_memory_allocated()
    staged = {}
    for key, q in qs.items():
        for name in ("simple", "dfilter"):
            ex = getattr(q, name)
            dev_dig = integrity.digest_from_scalar(integrity.device_digest(*ex.digest_lanes()))
            check(dev_dig == ex.state_digest(), f"{key}: {name}'s kernel-H digest = host_digest")
            staged[f"{key}.{name}"] = dev_dig
        for kern in Q102_KERNELS:
            check(launches.by[key][kern] > 0, f"{key}: kernel {kern} launched")
    for name in ("count", "count2", "simple", "dfilter", "mview"):
        check(getattr(qs["q102"], name).state_digest() == getattr(qs["q102_fused"],
                                                                  name).state_digest(),
              f"q102 fused: {name} state vs the interpreted run's")
    rows_in = sum(len(a["id"]) + sum(len(b["auction"]) for b in bids) for a, bids in host)
    rows = [path_row(key, rows_in, rec[key], mv_rows=int(q.mview.table.live.sum()),
                     filter_rows=int(q.dfilter.table.live.sum()),
                     right_value=int(q.dfilter.rv), launches=launches.by[key],
                     chains=chains.get(key)) for key, q in qs.items()]
    rows[0].update(refusals=refusals, agg_capacity=Q102_CAP, join=[Q102_CAP, Q105_FANOUT],
                   filter_capacity=Q102_CAP, mv_capacity=Q102_CAP, out_cap=Q105_OUT_CAP,
                   max_memory_allocated=int(peak),
                   oracle="numpy: per-auction counts, rv = bids // auctions with a bid, the "
                          "join with the auctions seen, count >= rv, at every barrier for both "
                          "runs; fused states = interpreted; SimpleAgg and filter kernel-H "
                          "digests = host_digest of their lanes read back")
    return rows, launches.by


def kill_q102(torch, dev, host, chunks):
    """Phase 16's q102: phase 11's first KILL_EPOCHS epochs, phase 24's
    sizes (the filter's row store and right value, the SimpleAgg's row,
    both counts, the join and the MV recovered)."""
    oracle = q102_oracle(host, KILL_EPOCHS - 1)

    class Run:
        """A ``Q102`` as phase 16 drives a query: ``pipeline`` (its
        ``executors`` and ``epoch``) and ``mview``."""

        def __init__(self):
            self.pipeline = build_q102_full(dev)
            self.mview = self.pipeline.mview

    def drive(run, e):
        a, bids = chunks[e]
        run.pipeline.push_auction(a)
        for b in bids:
            run.pipeline.push_bid(b)
        run.pipeline.barrier()

    spec = KillSpec("q102", Run, drive, lambda run: q102_rows(run.pipeline), oracle)
    return kill_and_recover(torch, dev, spec)


# -- kernels AA and AB; phases 25-28: table functions, grouping sets, temporal join --
P25_STEPS = 5  # generate_series(lo, hi): the hop's five windows of a bid
P26_SETS = (("auction",), ("bidder",), ())
P26_CAP = 1 << 22  # about 1.2M auctions, 0.4M bidders and the total (phase 4's bids)
P27_CAP = 1 << 17  # one group per tag of a 2^16 domain
P28_CAP = 1 << 22  # the auctions MV (about 1.2M rows), the seller agg and MV
TAG_CAP = 8
TAG_DOMAIN = 1 << 16
TABLE_KERNELS = {  # what each path's run must launch
    "p25": ("series", "expr_eval", "lookup_or_insert", "mv_upsert"),
    "p26": ("expand", "lookup_or_insert", "mv_upsert"),
    "p27": ("unnest", "lookup_or_insert", "mv_upsert"),
    "p28": ("temporal_probe", "lookup_or_insert", "mv_upsert"),
}


class Lockstep:
    """Two pipelines driven as one (phase 28: the auctions MV, then the
    bids through the temporal join): a barrier closes both, a checkpoint
    takes both chains' executors at the second's epoch."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    @property
    def executors(self):
        return list(self.first.executors) + list(self.second.executors)

    @property
    def epoch(self):
        return self.second.epoch

    def barrier(self):
        self.first.barrier()
        return self.second.barrier()


def table_path(pipeline, agg, mview, **extra):
    from types import SimpleNamespace

    return SimpleNamespace(pipeline=pipeline, agg=agg, mview=mview, **extra)


def build_p25(torch, dev, cap):
    """q5 as a table function: Project (lo = date_time // 2000 - 4, hi =
    date_time // 2000) -> ProjectSet(generate_series(lo, hi), max_steps
    5) -> Project (window_start = value * 2000) -> COUNT(*) per (auction,
    window_start) -> MV."""
    from risingwave_tpu_torch.executors import ProjectSetExecutor
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.executors.project import ProjectExecutor
    from risingwave_tpu_torch.expr import col, lit
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    keys = ("auction", "window_start")
    agg = HashAggExecutor(keys, (AggCall("count_star", None, "num"),),
                          dict.fromkeys(keys, torch.int64), capacity=cap, table_id="p25.agg",
                          device=dev)
    mview = DeviceMaterializeExecutor(keys, ("num",), dict.fromkeys(keys + ("num",), torch.int64),
                                      table_id="p25.mview", capacity=cap, device=dev)
    slide = lit(Q5_SLIDE_MS)
    return table_path(Pipeline([
        ProjectExecutor({"auction": col("auction"),
                         "lo": col("date_time") // slide - lit(P25_STEPS - 1),
                         "hi": col("date_time") // slide}),
        ProjectSetExecutor("generate_series", out="value", start_col="lo", stop_col="hi",
                           max_steps=P25_STEPS),
        ProjectExecutor({"auction": col("auction"), "window_start": col("value") * slide}),
        agg, mview]), agg, mview)


def build_p26(torch, dev, cap=P26_CAP):
    """Grouping sets: Expand((auction), (bidder), ()) -> COUNT(*),
    SUM(price) on (auction, bidder, flag), auction and bidder nullable ->
    MV (a NULL key's pk lane holds 0, as the reference's MV stores it)."""
    from risingwave_tpu_torch.executors import ExpandExecutor
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    i64 = torch.int64
    keys = ("auction", "bidder", "flag")
    agg = HashAggExecutor(keys, (AggCall("count_star", None, "n"), AggCall("sum", "price", "total")),
                          {**dict.fromkeys(keys, i64), "price": i64}, capacity=cap,
                          nullable_keys=("auction", "bidder"), table_id="p26.agg", device=dev)
    mview = DeviceMaterializeExecutor(keys, ("n", "total"), dict.fromkeys(keys + ("n", "total"), i64),
                                      table_id="p26.mview", capacity=cap, device=dev)
    return table_path(Pipeline([ExpandExecutor(P26_SETS), agg, mview]), agg, mview)


def build_p27(torch, dev, cap=P27_CAP):
    """unnest: ProjectSet(unnest(tags), list_cap 8) -> COUNT(*) per tag -> MV."""
    from risingwave_tpu_torch.executors import ProjectSetExecutor
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    agg = HashAggExecutor(("tag",), (AggCall("count_star", None, "n"),), {"tag": torch.int64},
                          capacity=cap, table_id="p27.agg", device=dev)
    mview = DeviceMaterializeExecutor(("tag",), ("n",), {"tag": torch.int64, "n": torch.int64},
                                      table_id="p27.mview", capacity=cap, device=dev)
    return table_path(Pipeline([ProjectSetExecutor("unnest", out="tag", list_col="tags",
                                                   list_cap=TAG_CAP), agg, mview]), agg, mview)


def build_p28(torch, dev, cap=P28_CAP):
    """Temporal enrichment: auctions -> a device MV on id (interpreted:
    a fused MV writes at the barrier, and the probe would read it an
    epoch late); bids -> TemporalJoin(inner: seller, category) ->
    COUNT(*), SUM(price) per seller -> MV."""
    from risingwave_tpu_torch.executors import TemporalJoinExecutor
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    i64 = torch.int64
    auctions = DeviceMaterializeExecutor(("id",), ("seller", "category"),
                                         dict.fromkeys(("id", "seller", "category"), i64),
                                         table_id="p28.auctions", capacity=cap, device=dev)
    agg = HashAggExecutor(("seller",), (AggCall("count_star", None, "n"),
                                        AggCall("sum", "price", "total")),
                          {"seller": i64, "price": i64}, capacity=cap,
                          nullable_keys=("seller",), table_id="p28.agg", device=dev)
    mview = DeviceMaterializeExecutor(("seller",), ("n", "total"),
                                      dict.fromkeys(("seller", "n", "total"), i64),
                                      table_id="p28.mview", capacity=cap, device=dev)
    right = Pipeline([auctions])
    bids = Pipeline([TemporalJoinExecutor(auctions, ("auction",), ("seller", "category"),
                                          "inner"), agg, mview])
    return table_path(Lockstep(right, bids), agg, mview, right=right, bids=bids,
                      auctions=auctions)


def tag_chunks(torch, dev, host):
    """Phase 11's auctions (id, item_name) with a LIST<int64> ``tags``
    column, encoded on the host by ``array/composite.py`` (the DML edge):
    0-8 tags a row from a 2^16 domain, a tenth of the lists NULL, drawn
    from the seed; an epoch's first rows hold an empty list, a full one
    and a NULL one. Returns per epoch the lists and the chunk on the card."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.array.composite import encode_column
    from risingwave_tpu_torch.types import DataType, Field

    rng = np.random.default_rng(SEED + 27)
    field = Field("tags", DataType.LIST, elem=DataType.INT64, list_cap=TAG_CAP)
    out = []
    for a, _ in host:
        n = len(a["id"])
        lens = rng.integers(0, TAG_CAP + 1, n)
        lens[:2] = (0, TAG_CAP)
        isnull = rng.random(n) < 0.1
        isnull[:3] = (False, False, True)
        flat = rng.integers(0, TAG_DOMAIN, int(lens.sum()))
        lists = [None if z else v.tolist() for v, z in zip(np.split(flat, np.cumsum(lens)[:-1]),
                                                            isnull)]
        lanes, nulls = encode_column(field, lists)
        lanes.update(id=a["id"], item_name=a["item_name"])
        out.append((lists, StreamChunk.from_numpy(lanes, A_ROWS, nulls=nulls, device=dev)))
    return out


def p26_oracle(host_bids) -> dict:
    """Phase 26's MV as sorted (auction, bidder, flag, n, total) rows, a
    NULL key as 0."""
    rows = []
    for flag, key in ((0, "auction"), (1, "bidder")):
        u, inv = np.unique(host_bids[key], return_inverse=True)
        n = np.bincount(inv)
        total = np.bincount(inv, weights=host_bids["price"]).astype(np.int64)
        z = np.zeros(len(u), np.int64)
        ks = (u, z) if flag == 0 else (z, u)
        rows.append(np.stack([*ks, np.full(len(u), flag), n, total], 1))
    rows.append(np.asarray([[0, 0, 2, len(host_bids["price"]), int(host_bids["price"].sum())]]))
    return sort_rows(np.concatenate(rows).astype(np.int64))


def sort_rows(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def mv_table_rows(mview, names) -> np.ndarray:
    d = mview.to_numpy()
    return sort_rows(np.stack([d[n].astype(np.int64) for n in names], 1))


def p27_oracle(tags) -> np.ndarray:
    flat = np.asarray([t for lists in tags for lst in lists if lst for t in lst], np.int64)
    n = np.bincount(flat, minlength=TAG_DOMAIN)
    u = np.flatnonzero(n)
    return np.stack([u, n[u]], 1)


def p28_oracle(host, upto: int) -> np.ndarray:
    """(seller, n, total) after epochs 0..upto: each bid joined with the
    seller of an auction pushed by then (its epoch's auctions first)."""
    sellers, prices = [], []
    ids = np.zeros(0, np.int64)
    sel = np.zeros(0, np.int64)
    for a, bids in host[:upto + 1]:
        ids = np.concatenate([ids, a["id"]])
        sel = np.concatenate([sel, a["seller"]])
        order = np.argsort(ids, kind="stable")
        ids, sel = ids[order], sel[order]
        for b in bids:
            pos = np.clip(np.searchsorted(ids, b["auction"]), 0, len(ids) - 1)
            hit = ids[pos] == b["auction"]
            sellers.append(sel[pos[hit]])
            prices.append(b["price"][hit])
    s, p = np.concatenate(sellers), np.concatenate(prices)
    u, inv = np.unique(s, return_inverse=True)
    return np.stack([u, np.bincount(inv), np.bincount(inv, weights=p).astype(np.int64)], 1)


def aa_lanes(chunk) -> dict:
    out = {f"col.{k}": v for k, v in chunk.columns.items()}
    out.update({f"null.{k}": v for k, v in chunk.nulls.items()})
    out.update(valid=chunk.valid, ops=chunk.ops)
    return out


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_aa(torch, dev, rng, bid, tagged):
    """Kernel AA's three entries against their plain versions on the card,
    bit for bit (copies: no tolerance applies): unnest on a 65,536-row
    auction chunk with LIST<int64> tags of cap 8 (lists of length 0, 8 and
    NULL among them) into 524,288 rows; the series on phase 25's projection
    of a 65,536-row bid chunk (k = 5, 327,680 rows) and on one with NULL
    bounds; Expand's three grouping sets on a bid chunk (196,608 rows; the
    int32 channel and a null lane beside the int64 lanes) and on one with
    null lanes inside and outside the sets. The latches: a list past the
    cap and a span past max_steps raise at the barrier. Each timed beside
    its plain version and its library call (``Tensor.repeat`` of each
    tiled lane)."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import ProjectSetExecutor
    from risingwave_tpu_torch.executors import expand as ex_mod
    from risingwave_tpu_torch.executors import project_set as ps

    def compare(got, want, what):
        torch.cuda.synchronize()
        assert_lanes_equal(torch, aa_lanes(got), aa_lanes(want), what)

    mask = lambda share: torch.from_numpy(rng.random(bid.capacity) < share).to(dev)

    def library(chunk, k, drop=()):
        lanes = [a for n, a in chunk.columns.items() if n not in drop]
        lanes += [a for n, a in chunk.nulls.items() if n not in drop]
        lanes += [chunk.valid, chunk.ops]
        return time_ms(torch, lambda: [a.repeat(k) for a in lanes], 20)

    rows = []
    # unnest
    k = TAG_CAP
    drop = {n for n in tagged.columns if n.startswith("tags.")}
    got = ps._unnest_cuda(tagged, "tags", "tag", k, True)
    compare(got, ps._unnest_torch(tagged, "tags", "tag", k, True), "AA unnest")
    v = got.valid.reshape(k, -1)
    check(not bool(v[:, 0].any()) and bool(v[:, 1].all()) and not bool(v[:, 2].any()),
          "AA unnest: an empty list yields nothing, a full one 8 rows, a NULL one nothing")
    for cap, raises in ((TAG_CAP, False), (4, True)):
        ex = ProjectSetExecutor("unnest", out="tag", list_col="tags", list_cap=cap)
        ex.apply(tagged)
        plain_hit = bool(ps.truncated(tagged, "unnest", "tags", None, cap))
        check(bool(ex._truncated) == plain_hit == raises,
              f"AA unnest: the kernel's latch at list_cap {cap} equals its plain version")
        try:
            ex.on_barrier(None)
            latched = False
        except RuntimeError as e:
            if "unnest list exceeded list_cap" not in str(e):
                raise
            latched = True
        check(latched == raises, f"AA unnest: the latch at list_cap {cap}")
    ms = time_ms(torch, lambda: ps._unnest_cuda(tagged, "tags", "tag", k, True), 20)
    plain = time_ms(torch, lambda: ps._unnest_torch(tagged, "tags", "tag", k, True), 5)
    read = list(tagged.columns.values()) + [a for n, a in tagged.nulls.items() if n not in drop]
    written = [a for n, a in got.columns.items()] + list(got.nulls.values())
    rows.append({
        "name": "AA unnest", "route": "cuda", "source": "risingwave_tpu_torch/csrc/tile_expand.cu",
        "replaces": "risingwave_tpu/executors/project_set.py:31", "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain,
        "bound_ms": bound_ms(nbytes(read + [tagged.valid, tagged.ops])
                             + nbytes(written + [got.valid, got.ops])),
        "bound_by": "bytes", "library_ms": library(tagged, k, drop),
        "library_call": "Tensor.repeat of each tiled lane (columns, null lanes, valid, ops)",
        "tolerance": "bit for bit",
        "shape": {"rows": tagged.capacity, "copies": k, "out_rows": got.capacity,
                  "lanes": {n: str(a.dtype) for n, a in tagged.columns.items()}},
    })
    # series: phase 25's first projection of a bid chunk, then NULL bounds
    lo = torch.div(bid.col("date_time"), 2000, rounding_mode="floor") - (P25_STEPS - 1)
    proj = StreamChunk({"auction": bid.col("auction"), "lo": lo, "hi": lo + (P25_STEPS - 1)},
                       bid.valid, {}, bid.ops)
    got = ps._series_cuda(proj, "lo", "hi", "value", P25_STEPS, True)
    compare(got, ps._series_torch(proj, "lo", "hi", "value", P25_STEPS, True), "AA series")
    check(bool(torch.equal(got.valid, bid.valid.repeat(P25_STEPS))), "AA series: every span is 5")
    lat = torch.zeros((), dtype=torch.bool, device=dev)
    ps._series_cuda(proj, "lo", "hi", "value", P25_STEPS, True, lat)
    check(not bool(lat), "AA series: spans of 5 leave the latch clear")
    n = bid.capacity
    hi = proj.col("hi").clone()
    hi[: n // 8] += 7  # spans past max_steps
    nulled = StreamChunk({**proj.columns, "hi": hi}, proj.valid,
                         {"lo": mask(0.1), "hi": mask(0.1)}, proj.ops)
    compare(ps._series_cuda(nulled, "lo", "hi", "value", P25_STEPS, False),
            ps._series_torch(nulled, "lo", "hi", "value", P25_STEPS, False), "AA series NULL bounds")
    ex = ProjectSetExecutor("generate_series", out="value", start_col="lo", stop_col="hi",
                            max_steps=P25_STEPS)
    ex.apply(nulled)
    check(bool(ex._truncated) and bool(ps.truncated(nulled, "series", "lo", "hi", P25_STEPS)),
          "AA series: the kernel's latch equals its plain version")
    try:
        ex.on_barrier(None)
        latched = False
    except RuntimeError as e:
        if "generate_series exceeded max_steps" not in str(e):
            raise
        latched = True
    check(latched, "AA series: a span past max_steps latches")
    ms = time_ms(torch, lambda: ps._series_cuda(proj, "lo", "hi", "value", P25_STEPS, True), 20)
    plain = time_ms(torch, lambda: ps._series_torch(proj, "lo", "hi", "value", P25_STEPS, True), 5)
    rows.append({
        "name": "AA series", "route": "cuda", "source": "risingwave_tpu_torch/csrc/tile_expand.cu",
        "replaces": "risingwave_tpu/executors/project_set.py:54", "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain,
        "bound_ms": bound_ms(nbytes([*proj.columns.values(), proj.valid, proj.ops])
                             + nbytes([*got.columns.values(), got.valid, got.ops])),
        "bound_by": "bytes", "library_ms": library(proj, P25_STEPS),
        "library_call": "Tensor.repeat of each tiled lane (columns, valid, ops)",
        "tolerance": "bit for bit",
        "shape": {"rows": n, "copies": P25_STEPS, "out_rows": got.capacity},
    })
    # expand: phase 26's chunk, then null lanes in and outside the sets
    names = tuple(sorted({c for s in P26_SETS for c in s}))
    got = ex_mod._expand_cuda(bid, P26_SETS, names, "flag")
    compare(got, ex_mod._expand_torch(bid, P26_SETS, names, "flag"), "AA expand")
    nulled = bid.with_nulls(bidder=mask(0.2), channel=mask(0.2))
    compare(ex_mod._expand_cuda(nulled, P26_SETS, names, "flag"),
            ex_mod._expand_torch(nulled, P26_SETS, names, "flag"), "AA expand with null lanes")
    ms = time_ms(torch, lambda: ex_mod._expand_cuda(bid, P26_SETS, names, "flag"), 20)
    plain = time_ms(torch, lambda: ex_mod._expand_torch(bid, P26_SETS, names, "flag"), 5)
    rows.append({
        "name": "AA expand", "route": "cuda", "source": "risingwave_tpu_torch/csrc/tile_expand.cu",
        "replaces": "risingwave_tpu/executors/expand.py:29", "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain,
        "bound_ms": bound_ms(nbytes([*bid.columns.values(), bid.valid, bid.ops])
                             + nbytes([*got.columns.values(), *got.nulls.values(), got.valid,
                                       got.ops])),
        "bound_by": "bytes", "library_ms": library(bid, len(P26_SETS)),
        "library_call": "Tensor.repeat of each tiled lane (columns, valid, ops; the sets' "
                        "null lanes left out)",
        "tolerance": "bit for bit",
        "shape": {"rows": n, "copies": len(P26_SETS), "out_rows": got.capacity,
                  "lanes": {c: str(a.dtype) for c, a in bid.columns.items()}},
    })
    return rows


def kernel_ab(torch, dev, rng, mv, bid):
    """Kernel AB against its plain version on the card, bit for bit, both
    join types: 65,536 bid rows (a twentieth of their keys NULL) against
    phase 28's auctions MV (2^22 slots, about 1.2M rows); then with 1,000
    probed auctions deleted from it (they must not match); then against
    a 2^10-slot MV that grew under 65,536 inserted auctions. Timed on the
    plain chunk, with the library composition (kernel M's ``rw_lookup``,
    then ``index_select`` of each value and null lane)."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import TemporalJoinExecutor
    from risingwave_tpu_torch.executors import temporal_join as tj
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.types import Op

    out_cols = ("seller", "category")
    n = bid.capacity

    def probe(fn, m, chunk, jt):
        keys = (chunk.col("auction"),)
        key_ok = ~chunk.null_of("auction")
        return fn(m.table, m.state.values, m.state.vnulls, chunk, keys, key_ok, out_cols, jt)

    def compare(m, chunk, what):
        outs = {}
        for jt in ("inner", "left"):
            got = probe(tj._probe_cuda, m, chunk, jt)
            want = probe(tj._probe_torch, m, chunk, jt)
            torch.cuda.synchronize()
            assert_lanes_equal(torch, aa_lanes(got), aa_lanes(want), f"AB {what} {jt}")
            outs[jt] = got
        check(torch.equal(outs["left"].valid, chunk.valid), f"AB {what}: left keeps every row")
        return outs

    nulled = bid.with_nulls(auction=torch.from_numpy(rng.random(n) < 0.05).to(dev))
    outs = compare(mv, nulled, "NULL keys")
    check(not bool((outs["inner"].valid & nulled.nulls["auction"]).any()),
          "AB: a NULL key never matches")
    matched = int(outs["inner"].valid.sum())
    # deleted MV rows
    gone = torch.unique(bid.col("auction")[bid.valid])[:1000]
    dels = StreamChunk.from_numpy({"id": gone.cpu().numpy(), "seller": np.zeros(len(gone), np.int64),
                                   "category": np.zeros(len(gone), np.int64)}, 1024,
                                  ops=np.full(len(gone), int(Op.DELETE), np.int32), device=dev)
    ms = time_ms(torch, lambda: probe(tj._probe_cuda, mv, bid, "inner"), 20)
    plain = time_ms(torch, lambda: probe(tj._probe_torch, mv, bid, "inner"), 5)

    def lib():
        slots, found = ht._lookup_cuda(mv.table, (bid.col("auction"),), bid.valid)
        idx = torch.where(found, slots.long(), mv.table.capacity - 1)
        return [mv.state.values[c].index_select(0, idx) for c in out_cols]

    library_ms = time_ms(torch, lib, 20)
    n_live = int(mv.table.live.sum())
    mv.apply(dels)
    outs = compare(mv, bid, "after deletes")
    hit_gone = torch.isin(bid.col("auction"), gone) & bid.valid
    check(not bool((outs["inner"].valid & hit_gone).any()) and bool(hit_gone.any()),
          "AB: a deleted MV row does not match")
    # growth: a small MV that rebuilds while auctions arrive, probed after
    small = DeviceMaterializeExecutor(("id",), out_cols, {"id": torch.int64, "seller": torch.int64,
                                                          "category": torch.int64},
                                      capacity=1 << 10, device=dev)
    ids = torch.unique(bid.col("auction")[bid.valid]).cpu().numpy()
    small.apply(StreamChunk.from_numpy({"id": ids, "seller": ids % 977, "category": ids % 13},
                                       n, device=dev))
    check(small.table.capacity > 1 << 10, "AB: the small MV grew")
    compare(small, bid, "after growth")
    (joined,) = TemporalJoinExecutor(small, ("auction",), out_cols, "inner").apply(bid)
    check(torch.equal(joined.valid, bid.valid), "AB: every bid finds its auction after growth")
    # bytes: the key, valid and key_ok lanes; per probed row the slot's
    # fp1, fp2, key and live; the gathered lanes; the outputs
    n_valid = int(bid.valid.sum())
    read = n * (8 + 1 + 1) + n_valid * (4 + 4 + 8 + 1) + n * 8 * len(out_cols)
    written = n * (8 + 1) * len(out_cols) + n
    return {
        "name": "AB temporal probe", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/temporal_probe.cu",
        "replaces": "risingwave_tpu/executors/temporal_join.py:32", "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(read + written), "bound_by": "bytes",
        "library_ms": library_ms,
        "library_call": "a composition of two calls: kernel M's rw_lookup, then index_select "
                        "of each value lane",
        "tolerance": "bit for bit",
        "shape": {"rows": n, "mv_capacity": mv.table.capacity, "mv_rows": n_live,
                  "matched_inner": matched, "outputs": list(out_cols)},
    }


def table_phase(torch, key, build, chain_of, want_chain, data, push, names, want, rows_in,
                after=None):
    """The frame of phases 25-28: an interpreted and a fused build of one
    path (the fused chain split as ``want_chain``) driven in lockstep over
    ``data`` (``push(run, item)``, then a barrier; ``after(runs, e)``
    checks barrier e); each run launches its TABLE_KERNELS; at the end
    each MV's ``names`` rows equal ``want``, and the fused run's staged
    digests equal host_digest of its lanes and the interpreted run's
    state. Returns the runs, the path rows and the launches by path."""
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

    runs = {key: build(), f"{key}_fused": build()}
    fused = runs[f"{key}_fused"]
    made = fuse_pipeline(chain_of(fused), label=key)
    check([type(w).__name__ for w in made] == ["FusedChainExecutor"], f"{key}: one fused program")
    got = [type(e).__name__ for e in chain_of(fused).executors]
    check(got == want_chain, f"{key}: the fused chain splits as {want_chain}: {got}")
    by_pipe = {id(q.pipeline): q for q in runs.values()}
    launches = PathLaunches()
    torch.cuda.reset_peak_memory_stats()
    rec = lockstep(torch, {k: q.pipeline for k, q in runs.items()}, data,
                   lambda pipe, item: push(by_pipe[id(pipe)], item), launches,
                   None if after is None else lambda e: after(runs, e))
    peak = torch.cuda.max_memory_allocated()
    for k, q in runs.items():
        for kern in TABLE_KERNELS[key]:
            check(launches.by[k][kern] > 0, f"{k}: kernel {kern} launched")
        got = mv_table_rows(q.mview, names)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"{k}: MV ({len(got)} rows) vs the oracle ({len(want)} rows)")
    digests = state_digests(fused)
    check(made[0].last_digests == digests, f"{key} fused: staged digests vs host_digest")
    check(digests == state_digests(runs[key]), f"{key} fused: state vs the interpreted run's")
    rows = [path_row(k, rows_in, rec[k], mv_rows=int(len(want)), launches=launches.by[k])
            for k in runs]
    rows[1].update(chain=want_chain, digests={k: f"{v:016x}" for k, v in digests.items()})
    rows[0].update(max_memory_allocated=int(peak))
    return runs, rows, launches.by


P25_NAMES = ("auction", "window_start", "num")
P26_NAMES = ("auction", "bidder", "flag", "n", "total")
P28_NAMES = ("seller", "n", "total")


def push_bids(q, ep) -> None:
    for c in ep:
        q.pipeline.push(c)


def p25_paths(torch, dev, chunks, cap, q5_rows):
    """Phase 25: q5 as a table function over phase 4's bid chunks, tables
    of phase 4's size, interpreted and fused in lockstep: each MV equals
    phase 4's q5-lite MV row for row (itself equal to the numpy oracle);
    the latch stays clear (every span is 5)."""
    n_bids = sum(int(c.valid.sum()) for ep in chunks for c in ep)
    _, rows, by = table_phase(
        torch, "p25", lambda: build_p25(torch, dev, cap), lambda q: q.pipeline,
        ["ProjectExecutor", "ProjectSetExecutor", "FusedChainExecutor"], chunks, push_bids,
        P25_NAMES, q5_rows, n_bids)
    rows[0].update(capacity=cap, oracle="phase 4's q5-lite MV (equal to the numpy hop oracle), "
                                        "row for row, both runs; fused staged digests = "
                                        "host_digest = the interpreted run's")
    return rows, by


def p26_paths(torch, dev, chunks):
    """Phase 26: grouping sets over phase 4's bid chunks (196,608-row
    expanded chunks), agg and MV of 2^22 slots, both ways: each MV equals
    the numpy oracle of the three groupings."""
    n_bids = sum(int(c.valid.sum()) for ep in chunks for c in ep)
    _, rows, by = table_phase(
        torch, "p26", lambda: build_p26(torch, dev), lambda q: q.pipeline,
        ["ExpandExecutor", "FusedChainExecutor"], chunks, push_bids, P26_NAMES,
        p26_oracle(bid_host_rows(chunks)), n_bids)
    rows[0].update(capacity=P26_CAP, sets=[list(s) for s in P26_SETS],
                   oracle="numpy counts and price sums per auction, per bidder and in total "
                          "(a NULL key's pk lane 0), both runs; fused state = interpreted")
    return rows, by


def p27_paths(torch, dev, tagged):
    """Phase 27: unnest over phase 11's auction chunks with their tags,
    agg and MV of 2^17 slots, both ways: each MV equals the numpy count
    of every tag."""
    want = p27_oracle([lists for lists, _ in tagged])
    _, rows, by = table_phase(
        torch, "p27", lambda: build_p27(torch, dev), lambda q: q.pipeline,
        ["ProjectSetExecutor", "FusedChainExecutor"], [c for _, c in tagged],
        lambda q, c: q.pipeline.push(c), ("tag", "n"), want,
        sum(len(lists) for lists, _ in tagged))
    rows[0].update(capacity=P27_CAP, list_cap=TAG_CAP, tag_domain=TAG_DOMAIN,
                   tags=int(want[:, 1].sum()),
                   null_lists=sum(v is None for lists, _ in tagged for v in lists),
                   oracle="numpy bincount of every tag of the non-NULL lists, both runs; "
                          "fused state = interpreted")
    return rows, by


def auction_chunks(torch, dev, host):
    """Phase 11's auctions as (id, seller, category) chunks on the card."""
    from risingwave_tpu_torch.array.chunk import StreamChunk

    return [StreamChunk.from_numpy({k: a[k] for k in ("id", "seller", "category")}, A_ROWS,
                                   device=dev) for a, _ in host]


def push_p28(chunks, a_chunks):
    """Epoch e of phase 28: its auction chunk into the auctions MV, then
    its bid chunks through the temporal join."""

    def push(q, e):
        q.right.push(a_chunks[e])
        for b in chunks[e][1]:
            q.bids.push(b)

    return push


def p28_paths(torch, dev, host, chunks, a_chunks):
    """Phase 28: temporal enrichment over phase 11's stream, the bid chain
    interpreted and fused (the auctions MV interpreted in both runs);
    each seller MV equals the numpy oracle at every barrier. Returns the
    interpreted run's auctions MV for kernel AB."""

    def after(runs, e):
        want = p28_oracle(host, e)
        for k, q in runs.items():
            got = mv_table_rows(q.mview, P28_NAMES)
            check(got.shape == want.shape and np.array_equal(got, want),
                  f"{k}: MV ({len(got)} rows) vs the oracle ({len(want)} rows) at barrier {e}")

    rows_in = sum(len(a["id"]) + sum(len(b["auction"]) for b in bids) for a, bids in host)
    runs, rows, by = table_phase(
        torch, "p28", lambda: build_p28(torch, dev), lambda q: q.bids,
        ["TemporalJoinExecutor", "FusedChainExecutor"], range(len(chunks)),
        push_p28(chunks, a_chunks), P28_NAMES, p28_oracle(host, len(chunks) - 1), rows_in, after)
    for row, q in zip(rows, runs.values()):
        row["auctions"] = int(q.auctions.table.live.sum())
    rows[0].update(capacity=P28_CAP,
                   oracle="numpy: each bid joined with the seller of an auction pushed by then, "
                          "counts and price sums per seller, at every barrier for both runs; "
                          "fused state = interpreted; the auctions MV interpreted in both")
    return rows, by, runs["p28"].auctions


def generators_on_card(torch, dev):
    """The host phase on the card: VALUES into an MV (once, at the first
    barrier), NOW over three barriers into an MV keyed on it (one row,
    the barrier's ms), and a troublemaker at rate 1 in front of COUNT(*)
    per k -> MV, whose MV must hold the signed count of what the
    troublemaker emitted (its logged faults) and differ from the clean
    run's."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import NowExecutor, TroublemakerExecutor, ValuesExecutor
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    i64 = torch.int64
    vals = ValuesExecutor({"x": np.asarray([3, 1, 4, 1, 5], np.int64)}, device=dev)
    mv = DeviceMaterializeExecutor(("_row_id",), ("x",), {"_row_id": i64, "x": i64}, capacity=16,
                                   device=dev)
    pipe = Pipeline([vals, mv])
    for _ in range(2):
        pipe.barrier()
        check(sorted(v[0] for v in mv.snapshot().values()) == [1, 1, 3, 4, 5],
              "VALUES: its rows once")
    now = NowExecutor(device=dev)
    mvn = DeviceMaterializeExecutor(("now",), (), {"now": i64}, capacity=16, device=dev)
    pipe = Pipeline([now, mvn])
    for ms in (1000, 2000, 3500):
        pipe.barrier(epoch=ms << 16)
        check(mvn.snapshot() == {(ms,): ()}, f"NOW: one row {ms} after its barrier")

    def run(chaos):
        agg = HashAggExecutor(("k",), (AggCall("count_star", None, "n"),), {"k": i64},
                              capacity=1 << 8, device=dev)
        mvk = DeviceMaterializeExecutor(("k",), ("n",), {"k": i64, "n": i64}, capacity=1 << 8,
                                        device=dev)
        pipe = Pipeline([agg, mvk])
        tm = TroublemakerExecutor(seed=SEED, rate=1.0)
        emitted = Counter()
        for i in range(16):
            c = StreamChunk.from_numpy({"k": np.asarray([i, i + 1, i + 2], np.int64),
                                        "v": np.arange(3, dtype=np.int64)}, 4, device=dev)
            for out in (tm.apply(c) if chaos else [c]):
                d = out.to_numpy()
                for k, op in zip(d["k"].tolist(), d["__op__"].tolist()):
                    emitted[k] += -1 if op in (1, 2) else 1
                pipe.push(out)
        pipe.barrier()
        return mvk.snapshot(), emitted, tm.log

    clean, _, _ = run(False)
    dirty, emitted, log = run(True)
    check(len(log) == 16 and {m for m, _, _ in log} <= {"corrupt_value", "flip_op", "dup_row"},
          "troublemaker: a logged fault per chunk")
    check(dirty == {(k,): (n,) for k, n in emitted.items() if n > 0},
          "troublemaker: the MV holds the signed count of what it emitted (a group whose "
          "count is not positive is absent)")
    check(dirty != clean, "troublemaker: its faults show in the MV")
    return {"phase": "generators", "values_rows": 5, "now_barriers": 3,
            "troublemaker_faults": Counter(m for m, _, _ in log),
            "checks": "VALUES once into an MV; NOW's MV one row per barrier; the troublemaker's "
                      "MV = the signed count of its emitted rows != the clean MV"}


def kill_p25(torch, dev, chunks, cap, q5_oracle10):
    """Phase 16's p25: phase 4's first KILL_EPOCHS epochs, phase 25's sizes."""

    def drive(q, e):
        push_bids(q, chunks[e])
        q.pipeline.barrier()

    spec = KillSpec("p25", lambda: build_p25(torch, dev, cap), drive,
                    lambda q: mv_table_rows(q.mview, P25_NAMES), np.stack(q5_oracle10, 1))
    return kill_and_recover(torch, dev, spec)


def kill_p26(torch, dev, chunks):
    """Phase 16's p26: phase 4's first KILL_EPOCHS epochs, phase 26's sizes."""

    def drive(q, e):
        push_bids(q, chunks[e])
        q.pipeline.barrier()

    spec = KillSpec("p26", lambda: build_p26(torch, dev), drive,
                    lambda q: mv_table_rows(q.mview, P26_NAMES),
                    p26_oracle(bid_host_rows(chunks[:KILL_EPOCHS])))
    return kill_and_recover(torch, dev, spec)


def kill_p28(torch, dev, host, chunks, a_chunks):
    """Phase 16's p28: phase 11's first KILL_EPOCHS epochs, phase 28's
    sizes (the auctions MV, the seller agg and MV recovered)."""
    push = push_p28(chunks, a_chunks)

    def drive(q, e):
        push(q, e)
        q.pipeline.barrier()

    spec = KillSpec("p28", lambda: build_p28(torch, dev), drive,
                    lambda q: mv_table_rows(q.mview, P28_NAMES), p28_oracle(host, KILL_EPOCHS - 1))
    return kill_and_recover(torch, dev, spec)


# -- phases 29-31: the window paths; phase 3's AC-AF -------------------------
WIN_SORT_CAP = 1 << 21  # phase 29's sort arena: an epoch's ~920,000 bids wait for its watermark
WIN_OVER_CAP = 1 << 22  # phase 29's partitions: about 1.2M auctions over 20M events
WIN_MV_CAP = 1 << 26  # a row per bid, about 18.4M (as q1's MV)
P30_CAP = 1 << 21  # phase 30's EOWC arena: an epoch's bids and the open 10 s window
P31_CAP = 1 << 24  # phase 31's general arena: q5's about 6M (auction, window_start) groups
TUMBLE_MS = 10_000
P31_HOP = (10_000, 2_000)
# phase 31's agg flushes up to 2^17 groups a round (q5's default is 2^15):
# each round is one chunk of U-/U+ pairs into the general over-window,
# whose two emissions per chunk are arena-wide (2^24 rows), and the fused
# MV tail buffers a barrier's emissions: about 350,000 dirty groups a
# barrier make 3 rounds, not 11
P31_OUT_CAP = 1 << 17
WIN_COLS = ("auction", "bidder", "price", "date_time")
P29_CALLS = (("row_number", None, "rn"), ("count", None, "cnt"), ("sum", "price", "total"),
             ("min", "price", "lo"), ("max", "price", "hi"), ("lag", "price", "prev"),
             ("rank", "date_time", "rk"), ("dense_rank", "date_time", "drk"))
P30_CALLS = (("row_number", None, "rn"), ("rank", "date_time", "rk"),
             ("dense_rank", "date_time", "drk"), ("lead", "price", "nxt"),
             ("lag", "price", "prev2", {"offset": 2}), ("sum", "price", "s3", {"frame": (-2, 0)}),
             ("count", None, "c3", {"frame": (-2, 0)}), ("min", "price", "m4", {"frame": (-2, 1)}),
             ("max", "price", "hi"))
P31_CALLS = (("rank", "neg_num", "rk"), ("dense_rank", "neg_num", "drk"),
             ("row_number", None, "rn"), ("lag", "num", "prev"), ("sum", "num", "run"))
WINDOW_KERNELS = {  # what each path's run must launch
    "p29": ("arena", "arena_emit", "lookup_or_insert", "over_step", "mv_upsert"),
    "p30": ("hop_expand", "arena", "window_fold", "window_order", "window_calls", "mv_upsert"),
    "p31": ("hop_expand", "lookup_or_insert", "expr_eval", "over_apply", "window_fold",
            "window_order", "window_calls", "over_diff", "mv_upsert"),
}
WINDOW_CHAINS = {  # each fused run's chain, as the reference's fuse_chain splits it
    "p29": ["RowIdGenExecutor", "SortExecutor", "OverWindowExecutor",
            "DeviceMaterializeExecutor"],
    "p30": ["RowIdGenExecutor", "HopWindowExecutor", "EowcOverWindowExecutor",
            "FusedChainExecutor"],
    "p31": ["EpochBatchedAggExecutor", "ProjectExecutor", "GeneralOverWindowExecutor",
            "FusedChainExecutor"],
}
P29_OUT = tuple(c[2] for c in P29_CALLS)
P30_OUT = tuple(c[2] for c in P30_CALLS)
P31_OUT = tuple(c[2] for c in P31_CALLS)
NULL_SENTINEL = -(2**63)  # a NULL cell in the oracles' rows
AF_PAIRS = P31_OUT_CAP  # U-/U+ pairs of kernel AF's phase-3 chunk: one flush round of phase 31


def window_calls(specs):
    from risingwave_tpu_torch.executors.over_window import WindowCall

    return tuple(WindowCall(*s[:3], **(s[3] if len(s) > 3 else {})) for s in specs)


def build_p29(torch, dev):
    """Ranked bids: RowIdGen -> Sort(date_time) -> OverWindow by auction ->
    MV on _row_id (the SQL planner's order: the hidden row id first)."""
    from types import SimpleNamespace

    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.executors.over_window import OverWindowExecutor
    from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor
    from risingwave_tpu_torch.executors.sort import SortExecutor
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    dt = {n: torch.int64 for n in ("_row_id",) + WIN_COLS}
    q = SimpleNamespace()
    q.sort = SortExecutor("date_time", dt, capacity=WIN_SORT_CAP, table_id="p29.sort", device=dev)
    q.over = OverWindowExecutor(("auction",), window_calls(P29_CALLS), dt, capacity=WIN_OVER_CAP,
                                table_id="p29.over", device=dev)
    q.mview = DeviceMaterializeExecutor(
        ("_row_id",), WIN_COLS + P29_OUT, {**dt, **dict.fromkeys(P29_OUT, torch.int64)},
        capacity=WIN_MV_CAP, nullable=("lo", "hi", "prev"), table_id="p29.mview", device=dev)
    q.pipeline = Pipeline([RowIdGenExecutor(table_id="p29.row_id"), q.sort, q.over, q.mview])
    q.window = (q.sort, q.over)
    return q


def build_p30(torch, dev):
    """Closed-window bid sequences: RowIdGen -> 10 s tumble ->
    EowcOverWindow by (window_start, auction) ordered by date_time -> MV on
    _row_id."""
    from types import SimpleNamespace

    from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.executors.over_window import EowcOverWindowExecutor
    from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    dt = {n: torch.int64 for n in ("_row_id", "window_start") + WIN_COLS}
    q = SimpleNamespace()
    q.eowc = EowcOverWindowExecutor(("window_start", "auction"), "date_time",
                                    window_calls(P30_CALLS), dt, win_col="window_start",
                                    capacity=P30_CAP, table_id="p30.eowc", device=dev)
    q.mview = DeviceMaterializeExecutor(
        ("_row_id",), WIN_COLS + ("window_start",) + P30_OUT,
        {**dt, **dict.fromkeys(P30_OUT, torch.int64)}, capacity=WIN_MV_CAP, nullable=P30_OUT,
        table_id="p30.mview", device=dev)
    q.pipeline = Pipeline([RowIdGenExecutor(table_id="p30.row_id"),
                           HopWindowExecutor("date_time", TUMBLE_MS, TUMBLE_MS), q.eowc, q.mview])
    q.window = (q.eowc,)
    return q


def build_p31(torch, dev):
    """Hot auctions ranked per window, the planner's plan of rank() OVER
    (PARTITION BY window_start ORDER BY num DESC) over q5-lite's counts:
    hop -> COUNT(*) per (auction, window_start) -> Project neg_num ->
    GeneralOverWindow -> Project -> MV on the pk."""
    from types import SimpleNamespace

    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
    from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
    from risingwave_tpu_torch.executors.over_window import GeneralOverWindowExecutor
    from risingwave_tpu_torch.executors.project import ProjectExecutor
    from risingwave_tpu_torch.expr import col, lit
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    keys = ("auction", "window_start")
    q = SimpleNamespace()
    q.agg = HashAggExecutor(keys, (AggCall("count_star", None, "num"),),
                            dict.fromkeys(keys, torch.int64), capacity=TABLE_CAP,
                            out_cap=P31_OUT_CAP, table_id="p31.agg", device=dev)
    q.over = GeneralOverWindowExecutor(
        ("window_start",), "neg_num", keys, window_calls(P31_CALLS),
        dict.fromkeys(keys + ("num", "neg_num"), torch.int64), capacity=P31_CAP,
        table_id="p31.over", device=dev)
    q.mview = DeviceMaterializeExecutor(
        keys, ("num",) + P31_OUT, dict.fromkeys(keys + ("num",) + P31_OUT, torch.int64),
        capacity=WIN_MV_CAP, nullable=("prev",), table_id="p31.mview", device=dev)
    q.pipeline = Pipeline([
        HopWindowExecutor("date_time", *P31_HOP), q.agg,
        ProjectExecutor({"auction": col("auction"), "window_start": col("window_start"),
                         "num": col("num"), "neg_num": lit(0) - col("num")}),
        q.over,
        ProjectExecutor({n: col(n) for n in keys + ("num",) + P31_OUT}),
        q.mview])
    q.window = (q.over,)
    return q


WINDOW_BUILDS = {"p29": build_p29, "p30": build_p30, "p31": build_p31}


def epoch_watermarks(chunks) -> list:
    """Each epoch's largest bid date_time (the watermark after its barrier)."""
    return [max(int(c.col("date_time")[c.valid].max()) for c in ep) for ep in chunks]


def window_drive(q, ep, wm) -> None:
    for c in ep:
        q.pipeline.push(c)
    q.pipeline.barrier()
    q.pipeline.watermark("date_time", wm)


def _group_starts(*keys) -> np.ndarray:
    """Boundaries of runs of equal key tuples in sorted rows."""
    n = len(keys[0])
    new = np.zeros(n, bool)
    if n:
        new[0] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    return new


def _seg_index(new: np.ndarray):
    """(segment id, position of the segment's first row) per row."""
    idx = np.arange(len(new))
    start = np.maximum.accumulate(np.where(new, idx, 0))
    return np.cumsum(new) - 1, start


def _seg_cum(v: np.ndarray, gid: np.ndarray, kind: str) -> np.ndarray:
    """Running max or min within segments (values below 2^40)."""
    big = np.int64(1) << 40
    if kind == "max":
        return np.maximum.accumulate(gid * big + v) - gid * big
    return big - 1 - (np.maximum.accumulate(gid * big + (big - 1 - v)) - gid * big)


def _shift(v, d, start, end, idx):
    """v at idx + d when it stays inside the row's segment, else NULL."""
    j = idx + d
    ok = (j >= start) & (j <= end)
    return np.where(ok, v[np.clip(j, 0, len(v) - 1)], NULL_SENTINEL), ~ok


def p29_oracle(host, last_wm: int) -> np.ndarray:
    """Phase 29's MV rows from numpy: every bid below the last watermark,
    per auction in (date_time, row id) order, with its running window
    values; sorted by row id."""
    keep = host["date_time"] < last_wm
    rid, auc, bidder, price, ts = (host[k][keep] for k in ("_row_id",) + WIN_COLS)
    o = np.lexsort((rid, ts, auc))
    rid, auc, bidder, price, ts = rid[o], auc[o], bidder[o], price[o], ts[o]
    idx = np.arange(len(rid))
    gid, start = _seg_index(_group_starts(auc))
    pos = idx - start
    cs = np.concatenate([[0], np.cumsum(price)])
    total = cs[idx + 1] - cs[start]
    lo, hi = _seg_cum(price, gid, "min"), _seg_cum(price, gid, "max")
    prev = np.where(pos > 0, np.roll(price, 1), NULL_SENTINEL)
    newts = _group_starts(auc, ts)
    rk = np.maximum.accumulate(np.where(newts, idx, 0)) - start + 1
    c = np.cumsum(newts)
    drk = c - c[start] + 1
    rows = np.stack([rid, auc, bidder, price, ts, pos + 1, pos + 1, total, lo, hi, prev, rk, drk],
                    1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def p30_oracle(host, last_wm: int) -> np.ndarray:
    """Phase 30's MV rows from numpy: every bid of a 10 s window the last
    watermark closed, per (window, auction) in (date_time, row id) order,
    with each call over the complete partition; sorted by row id."""
    ws_all = host["date_time"] - host["date_time"] % TUMBLE_MS
    keep = ws_all < last_wm - last_wm % TUMBLE_MS
    rid, auc, bidder, price, ts = (host[k][keep] for k in ("_row_id",) + WIN_COLS)
    ws = ws_all[keep]
    o = np.lexsort((rid, ts, auc, ws))
    rid, auc, bidder, price, ts, ws = rid[o], auc[o], bidder[o], price[o], ts[o], ws[o]
    idx = np.arange(len(rid))
    new = _group_starts(ws, auc)
    gid, start = _seg_index(new)
    end = np.concatenate([np.flatnonzero(new)[1:] - 1, [len(new) - 1]])[gid] if len(new) else idx
    pos = idx - start
    newts = _group_starts(ws, auc, ts)
    rk = np.maximum.accumulate(np.where(newts, idx, 0)) - start + 1
    c = np.cumsum(newts)
    drk = c - c[start] + 1
    nxt, _ = _shift(price, 1, start, end, idx)
    prev2, _ = _shift(price, -2, start, end, idx)
    cs = np.concatenate([[0], np.cumsum(price)])
    lo3 = np.maximum(idx - 2, start)
    s3 = cs[idx + 1] - cs[lo3]
    c3 = idx + 1 - lo3
    m4 = price.copy()
    for d in (-2, -1, 1):
        v, out = _shift(price, d, start, end, idx)
        m4 = np.where(out, m4, np.minimum(m4, v))
    hi = _seg_cum(price, gid, "max")
    rows = np.stack([rid, auc, bidder, price, ts, ws, pos + 1, rk, drk, nxt, prev2, s3, c3, m4,
                     hi], 1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def p31_oracle(q5_counts) -> np.ndarray:
    """Phase 31's MV from numpy, as ``p31_canon`` gives it: q5's counts
    per (auction, window_start) (``q5_oracle``, hop 10 s / 2 s), ranked by
    count descending per window (per pk: num, rank, dense_rank), and per
    window the (row_number, lag, running sum) triples that the tied rows
    share by position."""
    auc, ws, num = (np.asarray(a, np.int64) for a in q5_counts)
    o = np.lexsort((-num, ws))
    auc, ws, num = auc[o], ws[o], num[o]
    idx = np.arange(len(num))
    new = _group_starts(ws)
    gid, start = _seg_index(new)
    newn = _group_starts(ws, num)
    rk = np.maximum.accumulate(np.where(newn, idx, 0)) - start + 1
    c = np.cumsum(newn)
    drk = c - c[start] + 1
    pos = idx - start
    prev = np.where(pos > 0, np.roll(num, 1), NULL_SENTINEL)
    cs = np.concatenate([[0], np.cumsum(num)])
    run = cs[idx + 1] - cs[start]
    return _canon_rows(np.stack([auc, ws, num, rk, drk], 1), np.stack([ws, pos + 1, prev, run], 1))


def _canon_rows(per_pk: np.ndarray, per_window: np.ndarray) -> np.ndarray:
    """One array of both parts: the per-pk rows, then the per-window
    multiset as sorted rows padded with a -1 marker."""
    marked = np.concatenate([np.full((len(per_window), 1), -1, np.int64), per_window], 1)
    return np.concatenate([sort_rows(per_pk), sort_rows(marked)])


def _mv_cols(mview, names) -> dict:
    d = mview.to_numpy()
    out = {}
    for n in names:
        v = d[n].astype(np.int64)
        null = d.get(n + "__null")
        out[n] = np.where(null, NULL_SENTINEL, v) if null is not None else v
    return out


def p29_rows(q) -> np.ndarray:
    d = _mv_cols(q.mview, ("_row_id",) + WIN_COLS + P29_OUT)
    rows = np.stack([d[n] for n in ("_row_id",) + WIN_COLS + ("rn", "cnt", "total", "lo", "hi",
                                                               "prev", "rk", "drk")], 1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def p30_rows(q) -> np.ndarray:
    d = _mv_cols(q.mview, ("_row_id", "window_start") + WIN_COLS + P30_OUT)
    rows = np.stack([d[n] for n in ("_row_id",) + WIN_COLS + ("window_start",) + P30_OUT], 1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def p31_canon(q) -> np.ndarray:
    """Phase 31's MV as two runs must agree on it: ties of num are ordered
    by arrival (seq), and two runs' aggs flush a barrier's groups in their
    own order, so per pk (num, rank, dense_rank), and per window the
    multiset of (row_number, lag, running sum)."""
    d = _mv_cols(q.mview, ("auction", "window_start", "num") + P31_OUT)
    return _canon_rows(np.stack([d[n] for n in ("auction", "window_start", "num", "rk", "drk")], 1),
                       np.stack([d[n] for n in ("window_start", "rn", "prev", "run")], 1))


WINDOW_ROWS = {"p29": p29_rows, "p30": p30_rows, "p31": p31_canon}


def p31_tie_free_digest(q) -> int:
    """Kernel H over phase 31's MV lanes that no tie order reaches (the
    pk, num, rank, dense_rank)."""
    from risingwave_tpu_torch import integrity

    lanes, live = integrity.mv_lanes(q.mview.table, q.mview.state)
    keep = {k: v for k, v in lanes.items()
            if k.startswith("k") or k in ("v_num", "v_rk", "v_drk")}
    return integrity.digest_from_scalar(integrity.device_digest(keep, live))


def window_compare(key, runs, what) -> None:
    """The fused run against the interpreted one: every table's kernel-H
    digest (p31: the agg's and the MV's tie-free lanes)."""
    from types import SimpleNamespace

    a, b = runs[key], runs[f"{key}_fused"]
    if key == "p31":
        check(p31_tie_free_digest(a) == p31_tie_free_digest(b), f"{what}: p31 MV (tie-free)")
        check(device_digests(SimpleNamespace(executors=[a.agg]))
              == device_digests(SimpleNamespace(executors=[b.agg])), f"{what}: p31 agg")
        return
    same_state(a, b, what)


def window_paths(torch, dev, key, chunks, wms, want):
    """Phases 29-31 for one path: an interpreted and a fused build driven
    over the epochs (per epoch: the bids, a barrier, a date_time watermark
    at the epoch's maximum), compared at every barrier before its
    watermark; the fused chain split as the reference's (phase 29's MV
    refusal recorded); then a last barrier (the fused MV takes the last
    watermark's emission) and each run's MV against the numpy oracle;
    each window executor's kernel-H digest against ``host_digest`` of its
    lanes read back. Returns the runs, rows and launches by path."""
    from risingwave_tpu_torch import integrity
    from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline, fusion_refusals

    runs = {key: WINDOW_BUILDS[key](torch, dev), f"{key}_fused": WINDOW_BUILDS[key](torch, dev)}
    fused = runs[f"{key}_fused"]
    fusion_refusals(clear=True)
    made = fuse_pipeline(fused.pipeline, label=key)
    got = [type(e).__name__ for e in fused.pipeline.executors]
    check(got == WINDOW_CHAINS[key], f"{key}: the fused chain splits as {WINDOW_CHAINS[key]}: {got}")
    refusals = fusion_refusals(clear=True)
    if key == "p29":
        check(not made and len(refusals) == 1 and refusals[0]["executor"] == "OverWindowExecutor"
              and "passthrough" in refusals[0]["message"], f"p29: the MV refusal {refusals}")
    launches = PathLaunches()
    rec = {k: {"run_s": 0.0, "barrier_ms": [], "watermark_ms": []} for k in runs}
    torch.cuda.reset_peak_memory_stats()
    for e, ep in enumerate(chunks):
        for k, q in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            launches.run(k, lambda: [q.pipeline.push(c) for c in ep])
            tb = time.perf_counter()
            launches.run(k, q.pipeline.barrier)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec[k]["barrier_ms"].append((t1 - tb) * 1e3)
            rec[k]["run_s"] += t1 - t0
        window_compare(key, runs, f"{key} barrier {e + 1}")
        for k, q in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            launches.run(k, q.pipeline.watermark, "date_time", wms[e])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rec[k]["watermark_ms"].append(dt * 1e3)
            rec[k]["run_s"] += dt
    for k, q in runs.items():
        launches.run(k, q.pipeline.barrier)
    peak = torch.cuda.max_memory_allocated()
    window_compare(key, runs, f"{key} end")
    got = WINDOW_ROWS[key](runs[key])
    check(got.shape == want.shape and np.array_equal(got, want),
          f"{key}: MV ({len(got)} rows) vs the oracle ({len(want)} rows)")
    if key == "p31":  # the fused MV orders ties on its own
        got_f = WINDOW_ROWS[key](fused)
        check(np.array_equal(got_f, want), f"{key}_fused: MV vs the oracle")
    digests = {}
    for k, q in runs.items():
        for kern in WINDOW_KERNELS[key]:
            check(launches.by[k][kern] > 0, f"{k}: kernel {kern} launched")
    # the window executors' kernel-H digests against host_digest of their
    # lanes read back (the fused run's equal the interpreted run's by the
    # per-barrier comparison, so one run's read-back suffices)
    for ex in runs[key].window:
        dev_d = integrity.digest_from_scalar(integrity.device_digest(*ex.digest_lanes()))
        check(dev_d == ex.state_digest(), f"{key}: {ex.table_id} kernel-H digest vs host_digest")
        digests[ex.table_id] = f"{dev_d:016x}"
    n_in = sum(int(c.valid.sum()) for ep in chunks for c in ep)
    rows = [path_row(k, n_in, {"run_s": rec[k]["run_s"], "barrier_ms": rec[k]["barrier_ms"]},
                     watermark_ms_p50=float(np.percentile(rec[k]["watermark_ms"], 50)),
                     watermark_ms_p99=float(np.percentile(rec[k]["watermark_ms"], 99)),
                     mv_rows=int(runs[k].mview.table.live.sum()), launches=launches.by[k])
            for k in runs]
    rows[0].update(max_memory_allocated=int(peak), digests=digests,
                   chain_fused=WINDOW_CHAINS[key],
                   refusals=[r["message"] for r in refusals])
    return runs, rows, launches.by


def kill_window(torch, dev, key, chunks, wms):
    """Phase 16 for one window path: its first WIN_KILL_EPOCHS epochs at
    its phase's sizes, the kill after barrier WIN_KILL_AT; the oracle of
    those epochs; phase 31's general over-window and MV compared across
    runs by ``p31_canon`` (ties)."""
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS

    n = WIN_KILL_EPOCHS
    last = wms[n - 1]
    if key == "p31":
        lane = lambda name: np.concatenate([c.col(name)[c.valid].cpu().numpy()
                                            for e in chunks[:n] for c in e])
        oracle = p31_oracle(q5_oracle(lane("auction"), lane("date_time"), Q5_WINDOW_MS,
                                      Q5_SLIDE_MS))
    else:
        host = bid_host_rows(chunks[:n])
        oracle = (p29_oracle if key == "p29" else p30_oracle)(host, last)

    def drive(q, e):
        window_drive(q, chunks[e], wms[e])

    spec = KillSpec(key, lambda: WINDOW_BUILDS[key](torch, dev), drive, WINDOW_ROWS[key], oracle,
                    tie_tables=("p31.over", "p31.mview") if key == "p31" else (),
                    rows_each_barrier=key == "p31", depth=(n, WIN_KILL_AT))
    return kill_and_recover(torch, dev, spec)


def clone_lanes(d: dict) -> dict:
    return {k: v.clone() for k, v in d.items()}


def kernel_ac(torch, dev, ep):
    """Kernel AC against its plain version on the card, bit for bit: an
    epoch of phase 4's bid chunks (about 920,000 rows) appended into a
    2^21-slot arena (the last 65,536-row chunk timed, from the state
    before it), then one watermark past them all emitting every row in
    (date_time, seq) order. Library: ``torch.sort(stable=True)`` of ts
    after seq over the closed slots."""
    from risingwave_tpu_torch.executors import sort as so
    from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor

    dt = {n: torch.int64 for n in ("_row_id",) + WIN_COLS}
    rid = RowIdGenExecutor()
    chunks = [rid.apply(c)[0] for c in ep]
    names = tuple(dt)
    arenas = [so.SortExecutor("date_time", dt, capacity=WIN_SORT_CAP, device=dev) for _ in range(2)]
    scratch = so.arena_scratch(WIN_SORT_CAP, chunks[0].capacity, dev)

    def lanes(a):
        out = {f"c_{n}": a.buf[n] for n in names}
        out.update(valid=a.valid, seq=a.seq, next_seq=a.next_seq.reshape(1),
                   latch=torch.stack([a._overflow, a._saw_delete]))
        return out

    for c in chunks[:-1]:
        for a, fn in zip(arenas, (so._arena_append_cuda, so._arena_append_torch)):
            args = (a.buf, a.bnulls, a.valid, a.seq, a.next_seq, c, names, a._overflow,
                    a._saw_delete)
            fn(*args, scratch) if fn is so._arena_append_cuda else fn(*args)
    last = chunks[-1]
    before = clone_lanes(lanes(arenas[0]))

    def restore():
        a = arenas[0]
        for n in names:
            a.buf[n].copy_(before[f"c_{n}"])
        a.valid.copy_(before["valid"])
        a.seq.copy_(before["seq"])
        a.next_seq.copy_(before["next_seq"][0])

    a0, a1 = arenas

    def app_cuda():
        so._arena_append_cuda(a0.buf, a0.bnulls, a0.valid, a0.seq, a0.next_seq, last, names,
                              a0._overflow, a0._saw_delete, scratch)

    ms = time_ms(torch, app_cuda, 20, restore)
    plain = time_ms(torch, lambda: so._arena_append_torch(
        a0.buf, a0.bnulls, a0.valid, a0.seq, a0.next_seq, last, names, a0._overflow,
        a0._saw_delete), 5, restore)
    restore()
    app_cuda()
    so._arena_append_torch(a1.buf, a1.bnulls, a1.valid, a1.seq, a1.next_seq, last, names,
                           a1._overflow, a1._saw_delete)
    torch.cuda.synchronize()
    assert_lanes_equal(torch, lanes(a0), lanes(a1), "AC append")
    n_rows = int(a0.valid.sum())
    # emit: every row closes
    cutoff = int(a0.buf["date_time"][a0.valid].max()) + 1
    pre = clone_lanes(lanes(a0))

    def restore_emit():
        for n in names:
            a0.buf[n].copy_(pre[f"c_{n}"])
        a0.valid.copy_(pre["valid"])

    emit_ms = time_ms(torch, lambda: so._arena_emit_cuda(a0.buf, a0.bnulls, a0.valid, a0.seq,
                                                         cutoff, names, "date_time", scratch),
                      10, restore_emit)
    emit_plain = time_ms(torch, lambda: so._arena_emit_torch(a0.buf, a0.bnulls, a0.valid, a0.seq,
                                                             cutoff, names, "date_time"),
                         3, restore_emit)
    restore_emit()
    closed = torch.nonzero(a0.valid).flatten()

    def lib():
        o1 = torch.sort(a0.seq[closed], stable=True).indices
        return o1[torch.sort(a0.buf["date_time"][closed][o1], stable=True).indices]

    lib_ms = time_ms(torch, lib, 10)
    got = so._arena_emit_cuda(a0.buf, a0.bnulls, a0.valid, a0.seq, cutoff, names, "date_time",
                              scratch)
    want = so._arena_emit_torch(a1.buf, a1.bnulls, a1.valid, a1.seq, cutoff, names, "date_time")
    torch.cuda.synchronize()
    check(got[3] == want[3] == n_rows, f"AC emit: closed {got[3]} / {want[3]} / {n_rows}")
    m = got[3]
    assert_lanes_equal(torch, {n: got[0][n][:m] for n in names},
                       {n: want[0][n][:m] for n in names}, "AC emit rows in (ts, seq) order")
    check(bool(got[2][:m].all()) and not bool(got[2][m:].any()), "AC emit: valid prefix")
    check(torch.equal(a0.valid, a1.valid) and not bool(a0.valid.any()), "AC emit: slots freed")
    n = last.capacity
    lane_b = 8 * len(names)
    app_bytes = WIN_SORT_CAP + n * (1 + 4 + lane_b) + int(last.valid.sum()) * (lane_b + 8 + 1)
    emit_bytes = WIN_SORT_CAP * (1 + 8) + m * (8 + 8 + 4) + m * lane_b * 2 + m + WIN_SORT_CAP
    shape = {"arena": WIN_SORT_CAP, "chunk": n, "rows_before": n_rows - int(last.valid.sum()),
             "closed": m}
    common = {"route": "cuda", "source": "risingwave_tpu_torch/csrc/arena.cu", "max_abs_err": 0.0,
              "bound_by": "bytes", "tolerance": "bit for bit", "shape": shape}
    return [
        {"name": "AC arena append", "replaces": "risingwave_tpu/executors/sort.py:36", "ms": ms,
         "plain_ms": plain, "bound_ms": bound_ms(app_bytes), "library_ms": None,
         "library_call": "none: no one PyTorch call claims free slots in order", **common},
        {"name": "AC arena emit", "replaces": "risingwave_tpu/executors/sort.py:72",
         "ms": emit_ms, "plain_ms": emit_plain, "bound_ms": bound_ms(emit_bytes),
         "library_ms": lib_ms, "library_call": "torch.sort(stable=True) of the closed rows' seq, "
                                               "then of their ts in that order", **common},
    ], (a0, got)


def kernel_ad(torch, dev, emission):
    """Kernel AD against its plain version on the card, bit for bit: AC's
    2^21-row emission (about 920,000 bids in time order) through the
    append-only window's eight calls into a 2^22-slot partition table
    that already holds the same partitions (their accumulators seeded by
    one earlier step), kernel A's slots taken once. Library:
    ``torch.sort`` of the slot lane, then ``torch.cumsum`` of a value
    lane in that order."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import over_window as ow
    from risingwave_tpu_torch.ops.hash_table import lookup_or_insert

    cols, nulls, valid, m = emission
    chunk = StreamChunk(columns=cols, valid=valid, nulls=nulls,
                        ops=torch.zeros(valid.shape[0], dtype=torch.int32, device=dev))
    dt = {n: torch.int64 for n in cols}
    calls = window_calls(P29_CALLS)
    ex = ow.OverWindowExecutor(("auction",), calls, dt, capacity=WIN_OVER_CAP, device=dev)
    # an earlier step with the same rows shifted back in time seeds every
    # partition's accumulators (rank order stays legal)
    early = StreamChunk(columns={**cols, "date_time": cols["date_time"] - (1 << 40)}, valid=valid,
                        nulls=nulls, ops=chunk.ops)
    ex.apply(early)
    active = chunk.valid & (chunk.signs() > 0)
    ex.table, slots, _, _ = lookup_or_insert(ex.table, (chunk.col("auction"),), active)
    acc0 = clone_lanes(ex.accums)
    sd0, live0 = ex.sdirty.clone(), ex.table.live.clone()
    lat = lambda: tuple(torch.zeros((), dtype=torch.bool, device=dev) for _ in range(3))
    scratch = ow.over_step_scratch(chunk.capacity, ow._over_scan_lanes(calls),
                                   sum(len(ow._accum_names(c)) for c in calls), dev)

    def restore():
        for k, v in acc0.items():
            ex.accums[k].copy_(v)
        ex.sdirty.copy_(sd0)
        ex.table.live.copy_(live0)

    lat_k = lat()
    run_k = lambda: ow._over_step_cuda(ex.table, ex.accums, ex.sdirty, chunk, slots, calls, lat_k,
                                       scratch)
    ms = time_ms(torch, run_k, 10, restore)
    lat_p = lat()
    run_p = lambda: ow._over_step_torch(ex.table, ex.accums, ex.sdirty, chunk, slots, active,
                                        calls, lat_p)
    plain = time_ms(torch, run_p, 3, restore)
    restore()
    outs_k, nulls_k = run_k()
    state_k = {**clone_lanes(ex.accums), "sdirty": ex.sdirty.clone(), "live": ex.table.live.clone()}
    restore()
    outs_p, nulls_p = run_p()
    torch.cuda.synchronize()
    state_p = {**ex.accums, "sdirty": ex.sdirty, "live": ex.table.live}
    assert_lanes_equal(torch, state_k, state_p, "AD accumulators and marks")
    v = chunk.valid & active
    assert_lanes_equal(torch, {k: o[v] for k, o in outs_k.items()},
                       {k: o[v] for k, o in outs_p.items()}, "AD outputs")
    assert_lanes_equal(torch, {k: o[v] for k, o in nulls_k.items()},
                       {k: o[v] for k, o in nulls_p.items()}, "AD null lanes")
    check([bool(x) for x in lat_k] == [bool(x) for x in lat_p] == [False] * 3, "AD latches clear")
    key = torch.where(active, slots.long(), ex.table.capacity)
    price = chunk.col("price")

    def lib():
        o = torch.sort(key, stable=True).indices
        return torch.cumsum(price[o], 0)

    lib_ms = time_ms(torch, lib, 10)
    n = chunk.capacity
    segs = int(torch.unique(slots[active]).numel())
    n_acc = sum(len(ow._accum_names(c)) for c in calls)
    inputs = 2  # price, date_time
    need = (n * (4 + 1 + 4 + 8 * inputs) + segs * n_acc * 8 * 2 + n * 8 * len(calls)
            + n * 3 + segs * 2)
    return {"name": "AD over step", "route": "cuda", "source": "risingwave_tpu_torch/csrc/over_step.cu",
            "replaces": "risingwave_tpu/executors/over_window.py:129", "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms(need), "bound_by": "bytes",
            "library_ms": lib_ms, "library_call": "torch.sort of the slot lane, then "
                                                  "torch.cumsum of price in that order",
            "tolerance": "bit for bit",
            "shape": {"rows": n, "valid": int(m), "partitions": segs, "calls": len(calls),
                      "table": ex.table.capacity}}


def kernel_ae_eowc(torch, dev, ep):
    """Kernel AE's EOWC emit against its plain version on the card, bit
    for bit and row for row: an epoch of phase 4's bids, tumbled into 10 s
    windows, appended into a 2^21-slot EOWC arena, then one watermark
    closing every window: (window_start, auction, date_time, seq) order
    and phase 30's nine calls. Library: ``torch.sort`` of one packed key
    (window index, auction) of the closed rows."""
    from risingwave_tpu_torch.executors import over_window as ow
    from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
    from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor

    dt = {n: torch.int64 for n in ("_row_id", "window_start") + WIN_COLS}
    calls = window_calls(P30_CALLS)
    ex = ow.EowcOverWindowExecutor(("window_start", "auction"), "date_time", calls, dt,
                                   win_col="window_start", capacity=P30_CAP, device=dev)
    rid, hop = RowIdGenExecutor(), HopWindowExecutor("date_time", TUMBLE_MS, TUMBLE_MS)
    for c in ep:
        for t in hop.apply(rid.apply(c)[0]):
            ex.apply(t)
    cutoff = int(ex.buf["window_start"][ex.valid].max()) + 1
    v0 = ex.valid.clone()
    scratch = ow.window_scratch(P30_CAP, ow._window_scan_lanes(calls), dev)
    args = (ex.buf, ex.bnulls, ex.valid, ex.seq, cutoff, ex.names, calls, ex.part_keys,
            ex.order_col, ex.win_col)
    restore = lambda: ex.valid.copy_(v0)
    ms = time_ms(torch, lambda: ow._eowc_emit_cuda(*args, scratch), 10, restore)
    dev_ms = device_time_ms(torch, lambda: ow._eowc_emit_cuda(*args, scratch), 3, restore)
    plain = time_ms(torch, lambda: ow._eowc_emit_torch(*args), 2, restore)
    restore()
    sort = ae_sort_alone(torch, dev, ow, {"cap": P30_CAP, "n_ghost": 0, "m1": ex.valid,
                                         "win": ex.buf["window_start"], "cutoff": cutoff},
                         ow._eowc_keys(ex.buf, ex.part_keys, ex.order_col, ex.seq),
                         len(ex.part_keys), len(ex.part_keys), scratch)
    closed = torch.nonzero(ex.valid).flatten()
    ws = ex.buf["window_start"][closed]
    packed = ((ws - ws.min()) // TUMBLE_MS << 32) | ex.buf["auction"][closed]
    lib_ms = time_ms(torch, lambda: torch.sort(packed), 10)
    got = ow._eowc_emit_cuda(*args, scratch)
    vk = ex.valid.clone()
    restore()
    want = ow._eowc_emit_torch(*args)
    torch.cuda.synchronize()
    m = got[3]
    check(m == want[3] == int(v0.sum()), f"AE EOWC: closed {m} / {want[3]}")
    assert_lanes_equal(torch, {k: v[:m] for k, v in got[0].items()},
                       {k: v[:m] for k, v in want[0].items()}, "AE EOWC rows in sorted order")
    assert_lanes_equal(torch, {k: v[:m] for k, v in got[1].items()},
                       {k: v[:m] for k, v in want[1].items()}, "AE EOWC null lanes")
    check(torch.equal(vk, ex.valid) and not bool(vk.any()), "AE EOWC: slots freed")
    check(bool(got[2][:m].all()) and not bool(got[2][m:].any()), "AE EOWC: valid prefix")
    n_lanes = len(ex.names)
    # read: valid + window lane of the arena; per closed row its four key
    # lanes, the inputs (price) and every lane gathered; written: every
    # emission lane, call outputs and null lanes
    need = P30_CAP * 9 + m * (8 * 4 + 8 + 8 * n_lanes) + m * (8 * n_lanes + 9 * len(calls) + 1)
    hard = ae_eowc_hard(torch, dev, np.random.default_rng(SEED + 30))
    return {"name": "AE window order + calls (EOWC emit)", "route": "cuda",
            "source": "risingwave_tpu_torch/csrc/window_calls.cu",
            "replaces": "risingwave_tpu/executors/over_window.py:403", "max_abs_err": 0.0,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain, "bound_ms": bound_ms(need),
            "bound_by": "bytes", "library_ms": lib_ms,
            "library_call": "torch.sort of one packed (window, auction) key of the closed rows",
            "sort_alone": sort, "hard_cases": hard, "tolerance": "bit for bit, row for row",
            "shape": {"arena": P30_CAP, "closed": int(m), "calls": len(calls)}}


def ae_sort_alone(torch, dev, ow, domain, keys, n_part, order_lane, scratch) -> dict:
    """Kernel AE's sort alone on its own packed keys: the fold and the
    write of ``window_order`` leave each member's first word in
    ``scratch["words"]`` (entry order); ``onesweep_sort`` of those keys
    over the plan's bytes, held to be a stable sort of them, timed beside
    ``torch.sort`` of the same keys (signed: a timing point only)."""
    m, fold = ow.window_fold(domain, keys, scratch)
    plan = ow.window_pack_plan(fold, n_part, order_lane)
    ow.window_order(domain, keys, plan, m, scratch)
    words = scratch["words"][:m].clone()
    sscr = ow.window_scratch(m, 0, dev)
    mask = plan.pass_masks[0]
    ms = time_ms(torch, lambda: ow.onesweep_sort(words, sscr, mask), 10)
    lib = time_ms(torch, lambda: torch.sort(words), 10)
    got_k, got_p = ow.onesweep_sort(words, sscr, mask)
    flip = lambda t: t ^ torch.iinfo(torch.int64).min  # unsigned order as signed
    want = torch.sort(flip(words), stable=True)
    torch.cuda.synchronize()
    check(torch.equal(flip(got_k), want.values) and torch.equal(got_p.long(), want.indices),
          "AE sort alone: a stable sort of the packed keys' first words")
    return {"ms": ms, "library_ms": lib, "library_call": "torch.sort of the same keys",
            "keys": m, "bits": plan.bits, "words": plan.words,
            "passes": sum(bin(x).count("1") for x in plan.pass_masks)}


def general_state_clone(ex) -> dict:
    """Every lane of a general over-window's arena and table, cloned."""
    st = {f"buf_{k}": v.clone() for k, v in ex.buf.items()}
    st.update({f"em_{k}": v.clone() for k, v in ex.em.items()})
    st.update({f"en_{k}": v.clone() for k, v in ex.emnulls.items()})
    st.update(present=ex.present.clone(), seq=ex.seq.clone(), em_valid=ex.em_valid.clone(),
              sdirty=ex.sdirty.clone(), live=ex.table.live.clone())
    return st


def general_restore(ex, st) -> None:
    for k, v in ex.buf.items():
        v.copy_(st[f"buf_{k}"])
    for k, v in ex.em.items():
        v.copy_(st[f"em_{k}"])
    for k in list(ex.emnulls):
        if f"en_{k}" in st:
            ex.emnulls[k].copy_(st[f"en_{k}"])
        else:
            del ex.emnulls[k]
    ex.present.copy_(st["present"])
    ex.seq.copy_(st["seq"])
    ex.em_valid.copy_(st["em_valid"])
    ex.sdirty.copy_(st["sdirty"])
    ex.table.live.copy_(st["live"])


def general_lanes(ex) -> dict:
    out = {f"buf_{k}": v for k, v in ex.buf.items()}
    out.update({f"em_{k}": v for k, v in ex.em.items()})
    out.update({f"en_{k}": v for k, v in ex.emnulls.items()})
    out.update(present=ex.present, seq=ex.seq, em_valid=ex.em_valid, sdirty=ex.sdirty,
               live=ex.table.live)
    return out


def kernel_ae_af(torch, dev, rng, ex):
    """Kernels AF and AE's recompute against their plain versions on the
    card, bit for bit, on phase 31's general over-window after its run
    (a 2^24-slot arena of about 6M groups) and a 65,536-row chunk of
    U-/U+ pairs moving 32,768 of its rows' counts: AF's apply (the same
    slots from kernel A), AE's order and calls over the whole arena, AF's
    diff (the retract and insert chunks row for row in slot order, the
    emitted lanes); then a ghost and a bad delete on a small arena.
    Libraries: ``torch.sort`` of one packed key over the members (AE),
    ``torch.nonzero`` of the retract and insert masks (AF)."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import over_window as ow
    from risingwave_tpu_torch.ops.hash_table import lookup_or_insert

    cap = ex.capacity
    live_slots = torch.nonzero(ex.present).flatten()
    pick = live_slots[torch.from_numpy(rng.choice(live_slots.numel(), AF_PAIRS,
                                                  replace=False)).to(dev)]
    n = 2 * AF_PAIRS
    ops = torch.zeros(n, dtype=torch.int32, device=dev)
    ops[0::2] = 2  # UPDATE_DELETE
    ops[1::2] = 3  # UPDATE_INSERT
    cols = {}
    for k in ex.lane_names:
        old = ex.buf[k][pick]
        if k == "num":
            new = old + torch.from_numpy(rng.integers(-3, 4, pick.numel())).to(dev)
        elif k == "neg_num":
            new = None
        else:
            new = old
        cols[k] = (old, new)
    cols["neg_num"] = (cols["neg_num"][0], -cols["num"][1])
    lanes = {k: torch.stack([o, nw], 1).reshape(-1) for k, (o, nw) in cols.items()}
    chunk = StreamChunk(columns=lanes, valid=torch.ones(n, dtype=torch.bool, device=dev),
                        ops=ops)
    ex.table, slots, found, _ = lookup_or_insert(ex.table, tuple(chunk.col(k) for k in ex.pk),
                                                 chunk.valid)
    st0 = general_state_clone(ex)
    lat = lambda: (torch.zeros((), dtype=torch.bool, device=dev),
                   torch.zeros((), dtype=torch.bool, device=dev))
    ascr = ow.apply_scratch(cap, dev)
    wscr = ow.window_scratch(cap + n, ow._window_scan_lanes(ex.calls), dev)
    dscr = ow.diff_scratch(cap, dev)
    restore = lambda: general_restore(ex, st0)
    seq_base = ex._seq_base
    lat_k = lat()
    apply_k = lambda: ow._over_apply_cuda(ex.table, slots, found, ex._state(), chunk, ex.part_keys,
                                          ex.lane_names, seq_base, lat_k, ascr)
    lat_p = lat()
    apply_p = lambda: ow._over_apply_torch(ex.table, slots, found, ex._state(), chunk,
                                           ex.part_keys, ex.lane_names, seq_base, lat_p)
    ap_ms = time_ms(torch, apply_k, 10, restore)
    ap_plain = time_ms(torch, apply_p, 3, restore)
    restore()
    got_a = apply_k()
    st_k = clone_lanes(general_lanes(ex))
    restore()
    want_a = apply_p()
    torch.cuda.synchronize()
    assert_lanes_equal(torch, st_k, general_lanes(ex), "AF apply: arena lanes")
    assert_lanes_equal(torch, dict(zip(("touched", "ghost", "gslots"), got_a)),
                       dict(zip(("touched", "ghost", "gslots"), want_a)), "AF apply: outputs")
    check([bool(x) for x in lat_k] == [bool(x) for x in lat_p] == [False, False],
          "AF apply: latches clear")
    st1 = general_state_clone(ex)  # after the apply
    touched, ghost, gslots = want_a
    rec_k = lambda: ow._general_recompute_cuda(ex._state(), touched, ghost, gslots, ex.calls,
                                               ex.part_keys, ex.order_col, wscr)
    rec_p = lambda: ow._general_recompute_torch(ex._state(), touched, ghost, gslots, ex.calls,
                                                ex.part_keys, ex.order_col)
    ae_ms = time_ms(torch, rec_k, 5)
    ae_dev = device_time_ms(torch, rec_k, 3)
    ae_plain = time_ms(torch, rec_p, 2)
    out_k, nul_k, dirty_k = rec_k()
    out_p, nul_p, dirty_p = rec_p()
    torch.cuda.synchronize()
    check(torch.equal(dirty_k, dirty_p) and bool(dirty_k.any()), "AE general: dirty slots")
    assert_lanes_equal(torch, {k: v[dirty_k] for k, v in out_k.items()},
                       {k: v[dirty_p] for k, v in out_p.items()}, "AE general: outputs")
    assert_lanes_equal(torch, {k: v[dirty_k] for k, v in nul_k.items()},
                       {k: v[dirty_p] for k, v in nul_p.items()}, "AE general: null lanes")
    members = torch.nonzero(ex.present | ex.em_valid).flatten()
    pk = (ex.buf["window_start"][members] - ex.buf["window_start"][members].min()) // P31_HOP[1]
    packed = (pk << 40) | (ex.buf["num"][members] & ((1 << 40) - 1))
    ae_lib = time_ms(torch, lambda: torch.sort(packed), 5)
    n_members = int(members.numel())
    gdom = {"cap": cap, "n_ghost": n, "m1": ex.present, "m2": ex.em_valid,
            "present": ex.present, "ghost": ghost, "gslot": gslots}
    sort = ae_sort_alone(torch, dev, ow, gdom, ow._general_keys(ex._state(), ex.part_keys,
                                                                 ex.order_col),
                         len(ex.part_keys), len(ex.part_keys) + 1, wscr)
    # diff on the same inputs
    ops_pair = ex._ops if ex._ops is not None else (
        torch.full((cap,), 1, dtype=torch.int32, device=dev),
        torch.zeros(cap, dtype=torch.int32, device=dev))
    restore1 = lambda: general_restore(ex, st1)
    diff_k = lambda: ow._over_diff_cuda(ex._state(), ex.emnulls, out_p, nul_p, dirty_p,
                                        ex.lane_names, ex.out_names, *ops_pair, dscr)
    diff_p = lambda: ow._over_diff_torch(ex._state(), ex.emnulls, out_p, nul_p, dirty_p,
                                         ex.lane_names, ex.out_names, *ops_pair)
    df_ms = time_ms(torch, diff_k, 10, restore1)
    df_dev = device_time_ms(torch, diff_k, 3, restore1)
    df_plain = time_ms(torch, diff_p, 3, restore1)
    restore1()
    ret_k, ins_k = diff_k()
    st_dk = clone_lanes(general_lanes(ex))
    restore1()
    ret_p, ins_p = diff_p()
    torch.cuda.synchronize()
    assert_lanes_equal(torch, st_dk, general_lanes(ex), "AF diff: emitted lanes")
    n_ret, n_ins = int(ret_p.valid.sum()), int(ins_p.valid.sum())
    check(torch.equal(ret_k.valid, ret_p.valid) and torch.equal(ins_k.valid, ins_p.valid)
          and n_ins > 0, "AF diff: valid prefixes")
    for what, a, b, m in (("retract", ret_k, ret_p, n_ret), ("insert", ins_k, ins_p, n_ins)):
        assert_lanes_equal(torch, {k: v[:m] for k, v in a.columns.items()},
                           {k: v[:m] for k, v in b.columns.items()}, f"AF diff: {what} rows")
        assert_lanes_equal(torch, {k: v[:m] for k, v in a.nulls.items()},
                           {k: v[:m] for k, v in b.nulls.items()}, f"AF diff: {what} nulls")
    restore1()
    flags_r = ex.em_valid & dirty_p
    flags_i = ex.present & dirty_p
    df_lib = time_ms(torch, lambda: (torch.nonzero(flags_r), torch.nonzero(flags_i)), 10)
    restore()
    af_small = af_ghost_case(torch, dev)
    hrng = np.random.default_rng(SEED + 31)
    ae_hard, af_hard = ae_general_hard(torch, dev, hrng), af_diff_hard(torch, dev, hrng)
    lane_b = 8 * len(ex.lane_names)
    ap_need = n * (4 + 1 + 1 + 4 + lane_b + 8) + cap + int(found.numel()) * (lane_b + 8 + 3)
    ae_need = (cap + n) * 3 + n_members * (8 * 4 + 8 * 2) + n_members * 9 * len(ex.calls) + cap
    n_dirty = int(dirty_p.sum())
    cols_b = 8 * (len(ex.lane_names) + len(ex.calls))
    df_need = cap * 3 + n_dirty * cols_b * 2 + (n_ret + n_ins) * cols_b * 2
    shape = {"arena": cap, "members": n_members, "chunk": n, "dirty": n_dirty,
             "retract": n_ret, "insert": n_ins}
    common = {"route": "cuda", "max_abs_err": 0.0, "bound_by": "bytes",
              "tolerance": "bit for bit (outputs at dirty slots; chunks row for row)",
              "shape": shape}
    return [
        {"name": "AE window order + calls (general recompute)",
         "source": "risingwave_tpu_torch/csrc/window_calls.cu",
         "replaces": "risingwave_tpu/executors/over_window.py:927", "ms": ae_ms,
         "device_ms": ae_dev, "plain_ms": ae_plain, "bound_ms": bound_ms(ae_need),
         "library_ms": ae_lib,
         "library_call": "torch.sort of one packed (window, num) key over the members",
         "sort_alone": sort, "hard_cases": ae_hard, **common},
        {"name": "AF over apply", "source": "risingwave_tpu_torch/csrc/over_diff.cu",
         "replaces": "risingwave_tpu/executors/over_window.py:927", "ms": ap_ms,
         "plain_ms": ap_plain, "bound_ms": bound_ms(ap_need), "library_ms": None,
         "library_call": "none: no one PyTorch call lets the last row per slot win",
         "ghost_case": af_small, **common},
        {"name": "AF over diff", "source": "risingwave_tpu_torch/csrc/over_diff.cu",
         "replaces": "risingwave_tpu/executors/over_window.py:927", "ms": df_ms,
         "device_ms": df_dev, "plain_ms": df_plain, "bound_ms": bound_ms(df_need),
         "library_ms": df_lib,
         "library_call": "torch.nonzero of the retract and of the insert mask",
         "hard_cases": af_hard, **common},
    ]


def af_ghost_case(torch, dev) -> dict:
    """AF's apply on a small arena, card against plain: a same-chunk move
    of a row to another partition (its ghost) and a DELETE of an unknown
    pk (bad_delete); then the whole step, card against CPU."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import over_window as ow

    calls = window_calls((("row_number", None, "rn"), ("sum", "x", "sx")))
    dt = {"id": torch.int64, "p": torch.int64, "o": torch.int64, "x": torch.int64}
    exs = [ow.GeneralOverWindowExecutor(("p",), "o", ("id",), calls, dt, capacity=64, device=d)
           for d in (dev, "cpu")]
    steps = [({"id": [0, 1, 2], "p": [1, 1, 1], "o": [10, 20, 30], "x": [5, 6, 7]}, [0, 0, 0]),
             ({"id": [1, 1, 9], "p": [1, 2, 1], "o": [20, 20, 1], "x": [6, 6, 0]}, [1, 0, 1])]
    outs = []
    for cols, ops in steps:
        got = []
        for ex in exs:
            chunk = StreamChunk.from_numpy({k: np.asarray(v, np.int64) for k, v in cols.items()}, 4,
                                           ops=np.asarray(ops, np.int32), device=ex.device)
            got.append([Counter(map(tuple, np.stack([o.to_numpy()[k] for k in
                                                     ("id", "p", "o", "x", "rn", "sx")], 1)
                                    .tolist())) for o in ex.apply(chunk)])
        check(got[0] == got[1], "AF small: emissions card vs CPU")
        outs.append(got[0])
    check(exs[0].state_digest() == exs[1].state_digest(), "AF small: states card vs CPU")
    check(bool(exs[0]._bad_delete) and bool(exs[1]._bad_delete), "AF small: bad_delete latched")
    # the ghost re-emitted the old partition's remaining rows
    check(any(r[0] == 2 for r in outs[1][1]), "AF small: the old partition re-emitted")
    return {"ghost_move": True, "bad_delete": True, "checks": "card = CPU: emissions, digests"}


# kernel AE's and AF's hard cases (phase 3): the calls every case computes
AE_HARD_CALLS = (("rank", "o", "rk"), ("dense_rank", "o", "drk"), ("row_number", None, "rn"),
                 ("lag", "x", "lg"), ("lead", "x", "ld", {"offset": 2}), ("sum", "x", "sx"),
                 ("min", "x", "mn"), ("max", "x", "mx"), ("count", None, "cnt"),
                 ("count", None, "cf", {"frame": (-1, 1)}), ("sum", "x", "sf", {"frame": (-2, 0)}),
                 ("min", "y", "mf", {"frame": (-1, 1)}))
AE_HARD_CAP = 3 * 4096 + 17  # not a multiple of any tile (1,024, 2,048, 4,096)
I64_EXTREMES = (-(2**63), -(2**63) + 1, -7, -1, 0, 1, 3, 2**63 - 2, 2**63 - 1)


def _hard_values(rng, kind: str, n: int, lane: int) -> np.ndarray:
    """A key lane of a hard case: few values (partitions form), int64
    extremes, wide random int64 (two such lanes pass 64 bits), or one value."""
    if kind == "wide":
        return rng.choice(rng.integers(-(2**63), 2**63 - 1, 9, dtype=np.int64), n)
    if kind == "extremes":
        return rng.choice(np.asarray(I64_EXTREMES, np.int64), n)
    if kind == "one_partition" and lane >= 0:
        return np.full(n, 5, np.int64)
    return rng.integers(-6, 6, n).astype(np.int64) if lane >= 0 else \
        rng.integers(-40, 10, n).astype(np.int64)


def ae_eowc_hard(torch, dev, rng) -> dict:
    """Kernel AE's EOWC emit against its plain version on the card, bit for
    bit and row for row, on arenas made from a seed: two wide partition
    lanes (the key past 64 bits), int64 extremes in the partition and the
    order lanes, NULL inputs, one closed row, none, every row in one
    partition, a domain that is not a multiple of a tile; twelve calls."""
    from risingwave_tpu_torch.executors import over_window as ow

    calls = window_calls(AE_HARD_CALLS)
    done = {}
    for case in ("wide", "extremes", "nulls", "one_member", "no_members", "one_partition",
                 "ragged"):
        cap = 64 if case in ("one_member", "no_members") else AE_HARD_CAP
        n_part = 2 if case == "wide" else 1
        names = ("w",) + tuple(f"p{k}" for k in range(n_part)) + ("o", "x", "y")
        buf = {"w": torch.from_numpy(rng.integers(0, 4, cap) * 10).to(dev)}
        for k in range(n_part):
            buf[f"p{k}"] = torch.from_numpy(_hard_values(rng, case, cap, k)).to(dev)
        order_kind = "extremes" if case == "extremes" else "small"
        buf["o"] = torch.from_numpy(_hard_values(rng, order_kind, cap, -1)).to(dev)
        buf["x"] = torch.from_numpy(rng.integers(-50, 50, cap)).to(dev)
        buf["y"] = torch.from_numpy(rng.integers(-(2**40), 2**40, cap)).to(dev)
        bnulls = {"x": torch.from_numpy(rng.random(cap) < (0.4 if case == "nulls" else 0.1))
                  .to(dev)}
        valid = torch.from_numpy(rng.random(cap) < 0.8).to(dev)
        if case == "one_member":
            valid.zero_()
            valid[17] = True
        if case == "no_members":
            valid.zero_()
        seq = torch.from_numpy(rng.permutation(cap).astype(np.int64) + 7).to(dev)
        part_keys = ("w",) + tuple(f"p{k}" for k in range(n_part))
        cutoff = 30 if case != "one_member" else 10**6
        v_k, v_p = valid.clone(), valid.clone()
        got = ow._eowc_emit_cuda(buf, bnulls, v_k, seq, cutoff, names, calls, part_keys, "o",
                                 "w", None)
        want = ow._eowc_emit_torch(buf, bnulls, v_p, seq, cutoff, names, calls, part_keys, "o",
                                   "w")
        torch.cuda.synchronize()
        m = got[3]
        check(m == want[3], f"AE EOWC {case}: closed {m} / {want[3]}")
        check(torch.equal(v_k, v_p), f"AE EOWC {case}: slots freed")
        if m:
            assert_lanes_equal(torch, {k: v[:m] for k, v in got[0].items()},
                               {k: v[:m] for k, v in want[0].items()}, f"AE EOWC {case}: rows")
            assert_lanes_equal(torch, {k: v[:m] for k, v in got[1].items()},
                               {k: v[:m] for k, v in want[1].items()}, f"AE EOWC {case}: nulls")
            check(bool(got[2][:m].all()) and not bool(got[2][m:].any()),
                  f"AE EOWC {case}: valid prefix")
        done[case] = m
    return done


def ae_general_hard(torch, dev, rng) -> dict:
    """Kernel AE's general recompute against its plain version on the card,
    bit for bit at every dirty slot, on arenas made from a seed: present,
    emitted-only (absent) and free slots, ghosts of same-chunk partition
    moves (their keys from the emitted lanes at their slots), two wide
    partition lanes, int64 extremes, NULL inputs, one member, none, every
    member in one partition, a domain that is not a multiple of a tile."""
    from risingwave_tpu_torch.executors import over_window as ow

    calls = window_calls(AE_HARD_CALLS)
    done = {}
    for case in ("ghosts", "wide", "extremes", "nulls", "one_member", "no_members",
                 "one_partition", "ragged"):
        cap = 64 if case in ("one_member", "no_members") else AE_HARD_CAP
        n = 0 if case in ("one_member", "no_members") else 600
        n_part = 2 if case == "wide" else 1
        part_keys = tuple(f"p{k}" for k in range(n_part))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        buf, em = {}, {}
        for k in part_keys:
            buf[k] = t(_hard_values(rng, case, cap, 0))
            em[k] = t(_hard_values(rng, case, cap, 0))
        order_kind = "extremes" if case == "extremes" else "small"
        buf["o"] = t(_hard_values(rng, order_kind, cap, -1))
        em["o"] = t(_hard_values(rng, order_kind, cap, -1))
        buf["x"] = t(rng.integers(-50, 50, cap))
        buf["y"] = t(rng.integers(-(2**40), 2**40, cap))
        bnulls = {"x": t(rng.random(cap) < (0.4 if case == "nulls" else 0.1))}
        present = t(rng.random(cap) < 0.6)
        em_valid = t(rng.random(cap) < 0.5)
        if case in ("one_member", "no_members"):
            present.zero_()
            em_valid.zero_()
            if case == "one_member":
                present[9] = True
        ghost = t(rng.random(n) < 0.5) if n else torch.zeros(0, dtype=torch.bool, device=dev)
        gslots = t(rng.integers(0, cap, n).astype(np.int32)) if n else \
            torch.zeros(0, dtype=torch.int32, device=dev)
        touched = t(rng.random(cap) < 0.2)
        if case == "one_member":
            touched[9] = True
        st = {"buf": buf, "bnulls": bnulls, "em": em, "present": present,
              "em_valid": em_valid, "seq": t(rng.permutation(cap).astype(np.int64))}
        out_k, nul_k, dirty_k = ow._general_recompute_cuda(st, touched, ghost, gslots, calls,
                                                           part_keys, "o", None)
        out_p, nul_p, dirty_p = ow._general_recompute_torch(st, touched, ghost, gslots, calls,
                                                            part_keys, "o")
        torch.cuda.synchronize()
        check(torch.equal(dirty_k, dirty_p), f"AE general {case}: dirty slots")
        assert_lanes_equal(torch, {k: v[dirty_k] for k, v in out_k.items()},
                           {k: v[dirty_p] for k, v in out_p.items()}, f"AE general {case}: outputs")
        assert_lanes_equal(torch, {k: v[dirty_k] for k, v in nul_k.items()},
                           {k: v[dirty_p] for k, v in nul_p.items()}, f"AE general {case}: nulls")
        check(case == "no_members" or bool(dirty_k.any()), f"AE general {case}: a dirty slot")
        done[case] = int(dirty_k.sum())
    return done


def af_diff_hard(torch, dev, rng) -> dict:
    """Kernel AF's diff against its plain version on the card, on arenas
    made from a seed: no retracts, no inserts, every slot flagged (each
    both retracted and inserted, its emitted row read before it is
    overwritten), a mix with NULLs over a domain that is not a multiple of
    a tile, and rows of 22 lanes (past the 16 a thread holds in
    registers); the chunks row for row, the emitted lanes, em_valid,
    sdirty."""
    from risingwave_tpu_torch.executors import over_window as ow

    done = {}
    for case in ("no_retracts", "no_inserts", "all_flagged", "mixed", "many_lanes"):
        extra = [f"v{j}" for j in range(17)] if case == "many_lanes" else []
        lane_names, out_names = ["id", "p", "x"] + extra, ["rk", "lg"]
        cap = AE_HARD_CAP
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        r = lambda lo, hi: t(rng.integers(lo, hi, cap))
        present = t(rng.random(cap) < 0.6)
        em_valid = t(rng.random(cap) < 0.6)
        dirty = t(rng.random(cap) < 0.7)
        if case == "no_retracts":
            em_valid.zero_()
        if case == "no_inserts":
            present.zero_()
        if case == "all_flagged":
            present.fill_(True)
            em_valid.fill_(True)
            dirty.fill_(True)
        buf = {"id": r(0, 1 << 40), "p": r(-3, 3), "x": t(rng.integers(-5, 5, cap)
                                                           .astype(np.int32))}
        buf.update({v: r(-2, 2) for v in extra})
        em = {k: r(-3, 3) for k in lane_names + out_names}
        if case == "all_flagged":  # every emitted value differs from the current one
            em["x"] = buf["x"].long() + 100
        bnulls = {"x": t(rng.random(cap) < 0.2)}
        new_out = {"rk": r(0, 4), "lg": r(-3, 3)}
        new_nulls = {"rk": torch.zeros(cap, dtype=torch.bool, device=dev),
                     "lg": t(rng.random(cap) < 0.3)}
        emnulls = {"lg": t(rng.random(cap) < 0.3)}
        if case == "mixed":
            emnulls["x"] = t(rng.random(cap) < 0.2)
        ops = (torch.full((cap,), 1, dtype=torch.int32, device=dev),
               torch.zeros(cap, dtype=torch.int32, device=dev))

        def state():
            return ({"buf": buf, "bnulls": bnulls, "em": {k: v.clone() for k, v in em.items()},
                     "present": present, "em_valid": em_valid.clone(),
                     "sdirty": torch.zeros(cap, dtype=torch.bool, device=dev)},
                    {k: v.clone() for k, v in emnulls.items()})

        st_k, en_k = state()
        st_p, en_p = state()
        ret_k, ins_k = ow._over_diff_cuda(st_k, en_k, new_out, new_nulls, dirty, lane_names,
                                          out_names, *ops, None)
        ret_p, ins_p = ow._over_diff_torch(st_p, en_p, new_out, new_nulls, dirty, lane_names,
                                           out_names, *ops)
        torch.cuda.synchronize()
        n_ret, n_ins = int(ret_p.valid.sum()), int(ins_p.valid.sum())
        for what, a, b, m in (("retract", ret_k, ret_p, n_ret), ("insert", ins_k, ins_p, n_ins)):
            check(torch.equal(a.valid, b.valid), f"AF diff {case}: {what} valid lane")
            assert_lanes_equal(torch, {k: v[:m] for k, v in a.columns.items()},
                               {k: v[:m] for k, v in b.columns.items()},
                               f"AF diff {case}: {what} rows")
            assert_lanes_equal(torch, {k: v[:m] for k, v in a.nulls.items()},
                               {k: v[:m] for k, v in b.nulls.items()},
                               f"AF diff {case}: {what} nulls")
        assert_lanes_equal(torch, st_k["em"], st_p["em"], f"AF diff {case}: emitted lanes")
        assert_lanes_equal(torch, en_k, en_p, f"AF diff {case}: emitted null lanes")
        check(torch.equal(st_k["em_valid"], st_p["em_valid"])
              and torch.equal(st_k["sdirty"], st_p["sdirty"]), f"AF diff {case}: em_valid, sdirty")
        want = {"no_retracts": n_ret == 0 < n_ins, "no_inserts": n_ins == 0 < n_ret,
                "all_flagged": n_ret == n_ins == cap, "mixed": 0 < n_ret and 0 < n_ins,
                "many_lanes": 0 < n_ret and 0 < n_ins}
        check(want[case], f"AF diff {case}: {n_ret} retracts, {n_ins} inserts")
        done[case] = [n_ret, n_ins]
    return done


# -- phase 3, kernel AG; phases 32-34: the cold tier under a device budget -----
AG_Q5_LIVE = R_Q5_LIVE  # q5's agg at 2^24 slots after a commit (phase 4's mean)
AG_HITS = 1 << 18  # re-created groups a barrier merges, every call kind and dtype
AG_FAULT_KEYS = 4096  # evicted MAX windows faulted back in, with (K,) multiset rows
# phases 32-34 (and their kills) cut from phase 16's depth (10 epochs, the
# kill after 6) for the script's time limit when phases 38-41 came
COLD_EPOCHS = 6
COLD_KILL_AT = 4  # the kill of 32 and 33: after this barrier's eviction
COLD_BUDGET_SHARE = 4  # the budget: a quarter of the un-evicted run's state bytes
# phase 33's watermark delay: RisingWave's Nexmark sources declare
# WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
Q8_WM_DELAY_MS = 4_000
Q8_COLD_SHIFT_MS = 5_000  # phase 33's epochs end mid-window (q8's tumble is 10 s)
COLD_KERNELS = {  # what each cold path's run must launch
    "q5": ("cold_select", "cold_merge", "gather_rows", "lookup_or_insert", "slot_move"),
    "q8": ("cold_select", "gather_rows", "scatter_rows", "lookup_or_insert", "slot_move"),
    "q5_max": ("cold_select", "cold_merge", "gather_rows", "scatter_rows", "minput_rescatter"),
}


def ag_marks_q5(torch, dev, g):
    """q5's agg at 2^24 slots after a commit: 3M claimed groups, stored
    and clean but for a tenth re-touched since (dirty and sdirty) and a
    tenth new (sdirty, not stored), and 50,000 claimed dead slots."""
    cap = TABLE_CAP
    perm = torch.randperm(cap, device=dev, generator=g)
    n = AG_Q5_LIVE
    live_i, dead_i = perm[:n], perm[n:n + 50_000]
    z = lambda: torch.zeros(cap, dtype=torch.bool, device=dev)
    live, ev, dirty, sdirty, stored = z(), z(), z(), z(), z()
    live[live_i] = True
    ev[live_i[: n - n // 10]] = True
    stored[live_i[: n - n // 10]] = True
    dirty[live_i[: n // 10]] = True
    sdirty[live_i[: n // 10]] = True
    sdirty[live_i[n - n // 10:]] = True
    fp1 = torch.zeros(cap, dtype=torch.int32, device=dev)
    fp1[live_i] = torch.randint(1, 1 << 30, (n,), dtype=torch.int32, device=dev, generator=g)
    fp1[dead_i] = 7
    return fp1, live, sdirty, stored, ev, dirty


def ag_marks_join(torch, dev, g):
    """A q8 join side at 2^23 keys after a commit: 1.2M keys, stored and
    clean but for a third appended to since (sdirty) and a tenth with
    moved degrees (ddirty)."""
    cap, n = R_JOIN_CAP, R_JOIN_KEYS
    perm = torch.randperm(cap, device=dev, generator=g)[:n]
    z = lambda: torch.zeros(cap, dtype=torch.bool, device=dev)
    live, sdirty, stored, ddirty = z(), z(), z(), z()
    live[perm] = True
    stored[perm] = True
    sdirty[perm[: n // 3]] = True
    ddirty[perm[n // 3: n // 3 + n // 10]] = True
    fp1 = torch.zeros(cap, dtype=torch.int32, device=dev)
    fp1[perm] = torch.randint(1, 1 << 30, (n,), dtype=torch.int32, device=dev, generator=g)
    return fp1, live, sdirty, stored, ddirty


def ag_select(torch, dev, what, mode, marks, times: bool) -> dict:
    """AG's select against its plain version on one state: the durable
    slots, the hot mask and the counts bit for bit; with ``times`` its
    time, the plain version's and torch.nonzero of the durable mask's."""
    from risingwave_tpu_torch.ops import cold_tier as ct

    fp1, live, sdirty, stored = marks[:4]
    kw = (dict(ev=marks[4], dirty=marks[5]) if mode == ct.AGG
          else dict(ddirty=marks[4]) if mode == ct.JOIN else {})
    got = ct.cold_select(mode, fp1, live, sdirty, stored, **kw)
    want = ct._cold_select_torch(mode, fp1, live, sdirty, stored, kw.get("ev"), kw.get("dirty"),
                                 kw.get("ddirty"))
    torch.cuda.synchronize()
    check(torch.equal(got.sel, want.sel) and got.n_counted == want.n_counted
          and got.n_hot == want.n_hot, f"AG select {what}: slots and counts vs plain")
    check((got.hot is None) == (want.hot is None)
          and (got.hot is None or torch.equal(got.hot, want.hot)), f"AG select {what}: hot mask")
    cap, n = fp1.shape[0], got.sel.numel()
    # the bytes of each slot that the mode's formula reads: agg fp1, live,
    # ev, dirty, sdirty, stored; join fp1, sdirty, stored, ddirty; merge
    # sdirty and stored (the hot byte written but by merge)
    read = {ct.AGG: 4 + 5, ct.JOIN: 4 + 2 + ("ddirty" in kw), ct.MERGE: 2}[mode]
    out = {"shape": {"capacity": cap, "durable": n, "counted": got.n_counted,
                     "hot": got.n_hot}}
    if not times:
        return out
    durable = torch.zeros(cap, dtype=torch.bool, device=dev)
    durable[want.sel.long()] = True
    args = (mode, fp1, live, sdirty, stored, kw.get("ev"), kw.get("dirty"), kw.get("ddirty"))
    out.update(
        ms=time_ms(torch, lambda: ct._cold_select_launch(*args), 20),
        plain_ms=time_ms(torch, lambda: ct._cold_select_torch(*args), 5),
        library_ms=time_ms(torch, lambda: torch.nonzero(durable), 20),
        # the mode's lanes read once, the hot mask and the list written
        bound_ms=bound_ms(cap * read + (cap if mode != ct.MERGE else 0) + 4 * n + 24),
    )
    return out


AG_MERGE_CALLS = (("count_star", None, "n"), ("count", "v", "cv"), ("sum", "v", "sv"),
                  ("sum", "f", "sf"), ("sum", "h", "sh"), ("min", "v", "mnv"),
                  ("max", "w", "mxw"), ("min", "f", "mnf"), ("max", "h", "mxh"))


def ag_merge(torch, dev, g, rng) -> dict:
    """AG's merge on a barrier's hit slots of q5's 2^24-slot agg, every
    call kind and dtype (COUNT/SUM in int64, float64 and float32, int
    MIN/MAX, float MIN/MAX on order keys), against its plain version bit
    for bit; times, bound and ``index_add_`` of one lane."""
    from risingwave_tpu_torch.array.chunk import _numpy_dtype
    from risingwave_tpu_torch.ops import agg
    from risingwave_tpu_torch.ops import checkpoint as ck
    from risingwave_tpu_torch.ops import cold_tier as ct

    cap, n = TABLE_CAP, AG_HITS
    calls = tuple(agg.AggCall(*c) for c in AG_MERGE_CALLS)
    dts = {"v": torch.int64, "w": torch.int32, "f": torch.float64, "h": torch.float32}
    st = agg.create_state(cap, calls, dts, device=dev)
    live = torch.zeros(cap, dtype=torch.bool, device=dev)
    slots = torch.randperm(cap, device=dev, generator=g)[:n].to(torch.int32)
    lanes = ct.agg_merge_lanes(st, calls)
    rows = {}
    for ln in lanes:
        t = ln.dst
        if ln.op == ct.TRUE:
            continue
        if t.dtype == torch.bool:
            rows[ln.name] = rng.random(n) < 0.5
        elif t.is_floating_point():
            v = (rng.standard_normal(n) * 1e3).astype(np.float64 if t.dtype == torch.float64
                                                     else np.float32)
            v[rng.random(n) < 0.1] = -0.0
            rows[ln.name] = v
        else:
            rows[ln.name] = rng.integers(-1 << 30, 1 << 30, n).astype(
                np.int64 if t.dtype == torch.int64 else np.int32)
        # the state's own values at the hit slots, so that every fold moves
        t[slots.long()] = torch.from_numpy(np.roll(rows[ln.name], 3)).to(dev)
    base = {k: v.clone() for k, v in state_lanes(st).items()}
    base_live = live.clone()
    ct.cold_merge(lanes, slots, rows, st.row_count, live)
    got = {k: v.clone() for k, v in state_lanes(st).items()}
    got_live = live.clone()

    def restore():
        for k, v in state_lanes(st).items():
            v.copy_(base[k])
        live.copy_(base_live)

    restore()
    # the port's plain version on the card's tensors: its arithmetic is the
    # merge's (rows cast as cold_merge casts them)
    host = {ln.name: np.ascontiguousarray(rows[ln.name], dtype=_numpy_dtype(ln.dst.dtype))
            for ln in lanes if ln.op != ct.TRUE}
    plain = lambda: ct._cold_merge_torch(lanes, slots, host, st.row_count, live)
    plain()
    torch.cuda.synchronize()
    want = state_lanes(st)
    assert_lanes_equal(torch, got, want, "AG merge vs plain")
    check(torch.equal(got_live, live), "AG merge: live = row_count > 0")
    with_rows = {ln.name: ln.dst for ln in lanes if ln.op != ct.TRUE}
    staged, layout = ck._pack_host(with_rows, rows, n)
    packed = staged.to(dev)
    idx = slots.long()
    one = torch.from_numpy(host["row_count"]).to(dev)
    fold_bytes = sum(ln.dst.element_size() for ln in lanes if ln.op in (ct.ADD, ct.MIN, ct.MAX))
    all_bytes = sum(ln.dst.element_size() for ln in lanes)
    row_b = sum(ln.dst.element_size() for ln in lanes if ln.op != ct.TRUE)
    return {
        "ms": time_ms(torch, lambda: ct._cold_merge_launch(lanes, slots, packed, layout,
                                                           st.row_count, live), 20, restore),
        "with_copy_ms": time_ms(torch, lambda: ct.cold_merge(lanes, slots, rows, st.row_count,
                                                             live), 5, restore),
        "plain_ms": time_ms(torch, plain, 5, restore),
        "library_ms": time_ms(torch, lambda: st.row_count.index_add_(0, idx, one), 20, restore),
        # slots and the rows read once, the folded lanes read at the hit
        # slots, every lane and live written there
        "bound_ms": bound_ms(n * (4 + row_b + fold_bytes + all_bytes + 1)),
        "shape": {"capacity": cap, "hits": n, "lanes": len(lanes),
                  "calls": [c[0] + ":" + (c[1] or "*") for c in AG_MERGE_CALLS]},
    }


def ag_fault_in(torch, dev, rng) -> dict:
    """R as fault-in: AG_FAULT_KEYS evicted windows of q5-max's MAX agg
    (K = 256 multiset rows) faulted back into its 2^14-slot table (kernel
    A, then one scatter of every lane with ``stored`` and ``live``),
    against the plain versions (the same functions on CPU tensors) lane
    for lane, the multisets included; times of the scatter, its plain
    version and per-lane ``index_put_``."""
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor, scatter_agg_rows
    from risingwave_tpu_torch.ops import checkpoint as ck
    from risingwave_tpu_torch.ops.agg import AggCall

    n, k = AG_FAULT_KEYS, Q5MAX_K
    calls = (AggCall("max", "num", "maxn", materialized=True),)
    mk = lambda d: HashAggExecutor(("window_start",), calls, {"window_start": torch.int64,
                                                              "num": torch.int64},
                                   capacity=R_MAX_CAP, minput_k=k, device=d)
    card, cpu = mk(dev), mk("cpu")
    keys = {"k0": rng.choice(1 << 40, n, replace=False).astype(np.int64)}
    cnt = rng.integers(0, 4, (n, k)).astype(np.int32)
    rows = {"row_count": rng.integers(1, 500, n).astype(np.int64),
            "acc_maxn": rng.integers(0, 60, n).astype(np.int64),
            "em_maxn": rng.integers(0, 60, n).astype(np.int64),
            "nn_maxn": rng.integers(0, 500, n).astype(np.int64),
            "ei_maxn": rng.random(n) < 0.1, "ev": rng.random(n) < 0.9,
            "miv_maxn": rng.integers(0, 60, (n, k)).astype(np.int64), "mic_maxn": cnt}
    rows["row_count"][:8] = 0  # faulted in dead
    outs, slots_by = {}, {}
    for name, ex in (("card", card), ("cpu", cpu)):
        ex.table, slots = ck.insert_keys(ex.table, keys, n)
        slots_by[name] = slots
        scatter_agg_rows(ex.table, ex.state, ex.minput, slots, rows, calls, ex._dtypes, n)
        lanes = {**state_lanes(ex.state), "live": ex.table.live, "fp1": ex.table.fp1,
                 "k0": ex.table.keys[0]}
        for nm, (v, c) in ex.minput.items():
            lanes[f"miv_{nm}"], lanes[f"mic_{nm}"] = v, c
        # by key: kernel A may place a colliding key at another slot than
        # the plain version, so each key's lanes are read at its own slot
        idx = slots.long()
        outs[name] = ({kk: (v[idx] if v.dim() else v).cpu() for kk, v in lanes.items()},
                      {kk: int(v.sum()) for kk, v in lanes.items()
                       if v.dtype == torch.bool and v.dim() == 1})
        check(bool((slots >= 0).all()), f"R fault-in ({name}): every key has a slot")
    assert_lanes_equal(torch, outs["card"][0], outs["cpu"][0], "R fault-in vs plain (by key)")
    check(outs["card"][1] == outs["cpu"][1], "R fault-in: no other slot's marks set")
    check(int(card.table.live.sum()) == n - 8 and int(card.state.stored.sum()) == n,
          "R fault-in: live = row_count > 0, every row stored")
    slots = slots_by["card"]
    dst = {"row_count": card.state.row_count, "acc_maxn": card.state.accums["maxn"],
           "em_maxn": card.state.emitted["maxn"], "nn_maxn": card.state.nonnull["maxn"],
           "ei_maxn": card.state.emitted_isnull["maxn"], "ev": card.state.emitted_valid,
           "miv_maxn": card.minput["maxn"][0], "mic_maxn": card.minput["maxn"][1],
           "live": card.table.live, "stored": card.state.stored}
    src = {**rows, "live": rows["row_count"] > 0, "stored": np.ones(n, np.bool_)}
    staged, layout = ck._pack_host(dst, src, n)
    packed = staged.to(dev)
    host = {kk: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for kk, v in src.items()}
    idx = slots.long()
    rb = row_bytes(dst)
    return {
        "ms": time_ms(torch, lambda: ck._scatter_packed(dst, slots, packed, layout), 20),
        "with_copy_ms": time_ms(torch, lambda: scatter_agg_rows(
            card.table, card.state, card.minput, slots, rows, calls, card._dtypes, n), 5),
        "plain_ms": time_ms(torch, lambda: [dst[kk].__setitem__(idx, host[kk]) for kk in dst], 10),
        "library_ms": time_ms(torch, lambda: [dst[kk].index_put_((idx,), host[kk])
                                              for kk in dst], 10),
        "bound_ms": bound_ms(n * (2 * rb + 4)),
        "shape": {"capacity": R_MAX_CAP, "keys": n, "k": k, "row_bytes": rb},
    }


def kernel_ag(torch, dev):
    """AG against its plain version on the card (phase 3): the select on
    q5's 2^24-slot agg after a commit, on a q8 side (2^23, 8) and as the
    merge candidates; the merge on a barrier's hit slots over every call
    kind and dtype; and R as fault-in with multiset rows. Returns the
    rows of the select, the merge and the fault-in."""
    from risingwave_tpu_torch.ops import cold_tier as ct

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 30)
    rng = np.random.default_rng(SEED + 30)
    q5 = ag_marks_q5(torch, dev, g)
    shapes = {"q5_agg": ag_select(torch, dev, "q5 agg", ct.AGG, q5, True),
              "q5_merge_candidates": ag_select(torch, dev, "merge candidates", ct.MERGE, q5,
                                               True)}
    del q5
    side = ag_marks_join(torch, dev, g)
    shapes["q8_side"] = ag_select(torch, dev, "q8 side", ct.JOIN, side, True)
    del side
    torch.cuda.empty_cache()
    check(shapes["q5_agg"]["shape"]["durable"] > 0 and shapes["q8_side"]["shape"]["hot"] > 0,
          "AG select: durable and hot slots on both shapes")
    merge = ag_merge(torch, dev, g, rng)
    torch.cuda.empty_cache()
    fault = ag_fault_in(torch, dev, rng)
    torch.cuda.empty_cache()
    base = {"route": "cuda", "max_abs_err": 0.0, "bound_by": "bytes"}
    main = shapes["q5_agg"]
    return [
        {**base, "name": "AG cold select", "source": "risingwave_tpu_torch/csrc/cold_tier.cu",
         "replaces": "risingwave_tpu/executors/hash_agg.py:330 (_evict's hot mask and count; "
                     "evict_cold :879-931), executors/hash_join.py:617 (_evict_side)",
         "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
         "library_ms": main["library_ms"], "library_call": "torch.nonzero of the durable mask",
         "by_shape": shapes},
        {**base, "name": "AG cold merge", "source": "risingwave_tpu_torch/csrc/cold_tier.cu",
         "replaces": "risingwave_tpu/executors/hash_agg.py:1217 (_cold_merge, and _merge_cold's "
                     "set_live :1013-1017)",
         "ms": merge["ms"], "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
         "library_ms": merge["library_ms"], "library_call": "index_add_ of the row_count lane",
         "with_copy_ms": merge["with_copy_ms"], "shape": merge["shape"]},
        {**base, "name": "R scatter_rows as fault-in (K30)",
         "source": "risingwave_tpu_torch/csrc/checkpoint.cu",
         "replaces": "risingwave_tpu/executors/hash_agg.py:1162 (_fault_in_scatter), "
                     "executors/hash_join.py:736 (_restore_cold_keys)",
         "ms": fault["ms"], "plain_ms": fault["plain_ms"], "bound_ms": fault["bound_ms"],
         "library_ms": fault["library_ms"], "library_call": "per-lane index_put_",
         "with_copy_ms": fault["with_copy_ms"], "shape": fault["shape"]},
    ]


class ColdSpec:
    """One path of phases 32-34: ``build()`` a fresh query, ``push(q, e)``
    epoch e's chunks, ``after(q, e)`` what follows the barrier's commit
    and eviction (a watermark, or None), ``mv(q)`` its device MV,
    ``rows(q)`` the MV as sorted rows, ``oracle`` those rows at the end,
    ``rows_in`` the input rows of the epochs, ``host_mv``: also sink into
    a host MV (interpreted run)."""

    def __init__(self, name, build, push, after, mv, rows, oracle, rows_in, host_mv=False):
        self.name, self.build, self.push, self.after = name, build, push, after
        self.mv, self.rows, self.oracle, self.host_mv = mv, rows, oracle, host_mv
        self.rows_in = rows_in


def cold_bytes(pipeline) -> int:
    """Device bytes of the state the tier manages (the aggs and joins)."""
    from risingwave_tpu_torch.runtime.fused_step import cold_executors

    return sum(ex.state_nbytes() for ex in cold_executors(pipeline.executors))


def arm_cold(pipeline, mgr) -> list:
    from risingwave_tpu_torch.runtime.fused_step import cold_executors

    members = cold_executors(pipeline.executors)
    for ex in members:
        if hasattr(ex, "cold_get_rows"):
            ex.cold_get_rows = mgr.get_rows
        else:
            ex.cold_reader = lambda keys, tid=ex.table_id: mgr.get_rows(tid, keys)
    return members


def _bytes_at(make, cap: int) -> int:
    """Bytes of ``make(cap)``'s tensors from two tiny CPU instances: every
    lane is (cap, ...) or a scalar, so the bytes are linear in cap."""
    from risingwave_tpu_torch.ops.cold_tier import tensor_nbytes

    b1, b2 = tensor_nbytes(make(1)), tensor_nbytes(make(2))
    return b1 + (b2 - b1) * (cap - 1)


def _evicted_bytes(torch, ex) -> int:
    """The bytes an evicted executor must hold (checks only): those of a
    table and state at the capacity its hot set needs, ``grow_pow2(n_hot,
    2^10)`` (a join side without a durable key is left at its capacity),
    from plain masks of its marks and the shapes alone (nothing of that
    size is allocated on the card)."""
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops import minput as mi_ops
    from risingwave_tpu_torch.ops.hash_table import HashTable
    from risingwave_tpu_torch.ops.join import JoinSide
    from risingwave_tpu_torch.storage.state_table import grow_pow2

    def side_bytes(sd):
        durable = (sd.table.fp1 != 0) & sd.stored & ~sd.sdirty & ~sd.ddirty
        cap = sd.capacity
        if bool(durable.any()):
            cap = grow_pow2(int(((sd.table.fp1 != 0) & ~durable).sum()), 1 << 10, 0.5)
        return _bytes_at(lambda c: JoinSide.create(
            c, sd.fanout, tuple(k.dtype for k in sd.table.keys),
            {n: a.dtype for n, a in sd.rows.items()}, tuple(sd.row_nulls), device="cpu"), cap)

    if hasattr(ex, "left"):
        return side_bytes(ex.left) + side_bytes(ex.right)
    t, st = ex.table, ex.state
    durable = (t.fp1 != 0) & st.stored & ~st.sdirty & ~st.dirty
    hot = (t.live | st.emitted_valid | st.dirty | st.sdirty) & (t.fp1 != 0) & ~durable
    cap = grow_pow2(int(hot.sum()), 1 << 10, 0.5)
    return _bytes_at(lambda c: (HashTable.create(c, tuple(k.dtype for k in t.keys), device="cpu"),
                                agg_ops.create_state(c, ex.calls, ex._dtypes, "cpu"),
                                mi_ops.create_minput(c, ex.minput_k, ex.calls, ex._dtypes, "cpu")),
                     cap)


def evict_checked(torch, members) -> tuple:
    """The budget rule's eviction, each executor's ``state_nbytes()`` after
    it held equal to that of its hot set's table (``_evicted_bytes``).
    Returns (evicted, ms)."""
    want = [_evicted_bytes(torch, ex) for ex in members]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(ex.evict_cold() for ex in members)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    for ex, w in zip(members, want):
        check(ex.state_nbytes() == w,
              f"{ex.table_id}: state_nbytes after eviction {ex.state_nbytes()} = its hot "
              f"set's table {w}")
    return n, ms


def rows_digest(rows: np.ndarray) -> tuple:
    """(rows, sum, xor) of a 64-bit mix of each int64 row: the multiset's
    digest, whatever the rows' order."""
    h = np.full(len(rows), 0x9E3779B97F4A7C15, np.uint64)
    for j in range(rows.shape[1]):
        x = (h ^ rows[:, j].astype(np.int64).view(np.uint64)) * np.uint64(0xBF58476D1CE4E5B9)
        h = (x ^ (x >> np.uint64(31))) * np.uint64(0x94D049BB133111EB)
    return len(h), int(h.sum(dtype=np.uint64)), int(np.bitwise_xor.reduce(h)) if len(h) else 0


def cold_counts(members) -> Counter:
    out = Counter()
    for ex in members:
        out.update(ex.cold_counts)
    return out


class MemTrack:
    """Device bytes of one run over ``start`` (what was allocated when it
    began: the stream and what earlier phases left), per barrier: the
    peak from the epoch's first push to the barrier's end (its commit
    and eviction included) and what stays allocated then."""

    def __init__(self, torch, start: int):
        self.torch, self.start, self.peaks, self.resident = torch, start, [], []

    def begin(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()

    def end(self):
        self.torch.cuda.synchronize()
        self.peaks.append(self.torch.cuda.max_memory_allocated() - self.start)
        self.resident.append(self.torch.cuda.memory_allocated() - self.start)

    def row(self) -> dict:
        return {"allocated_at_start": int(self.start),
                "peak_over_start": int(max(self.peaks)),
                "peak_over_start_by_barrier": [int(x) for x in self.peaks],
                "resident_over_start_by_barrier": [int(x) for x in self.resident]}


def cold_baseline(torch, spec: ColdSpec) -> dict:
    """The un-evicted run (interpreted): its MV digest at every barrier,
    its managed state bytes at the last one (the budget's base), its
    device bytes at its start and at their peak, and the host copy of
    its state that the point reads are held against. The query leaves
    the card before it returns, so that the runs under the budget hold
    only their own state beside what both find there."""
    import gc

    from risingwave_tpu_torch import _kernels

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    q = spec.build()
    digests, barrier_ms, mem = [], [], MemTrack(torch, start)
    t0 = time.perf_counter()
    for e in range(COLD_EPOCHS):
        mem.begin()
        spec.push(q, e)
        tb = time.perf_counter()
        q.pipeline.barrier()
        torch.cuda.synchronize()
        barrier_ms.append((time.perf_counter() - tb) * 1e3)
        if spec.after is not None:
            spec.after(q, e)
        mem.end()
        digests.append(mv_digest(spec.mv(q)))
    run_s = time.perf_counter() - t0
    out = {"digests": digests, "bytes": cold_bytes(q.pipeline), "run_s": run_s,
           "barrier_ms": barrier_ms, "mem": mem.row(), "snap": point_snapshot(torch, q)}
    del q
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def cold_run(torch, dev, spec: ColdSpec, base: dict, fused: bool, kill: bool):
    """One path of phases 32-34 under the budget: per barrier a commit
    into a LocalFsObjectStore (timed as phase 16's), then, over the
    budget, ``evict_cold`` on every armed executor (checked), then
    ``after``; the MV's kernel-H digest equal to the un-evicted run's at
    every barrier. With ``kill`` (phase 16's kill of this path) the run
    dies after barrier COLD_KILL_AT's eviction and a fresh query
    recovers from the store, is armed again and runs on. Returns the
    row, the launches and the store's directory and manager."""
    import gc
    import tempfile

    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.executors.materialize import MaterializeExecutor
    from risingwave_tpu_torch.runtime.fused_step import checkpointed_executors, fuse_pipeline
    from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore

    label = f"{spec.name}_cold{'_fused' if fused else ''}"
    budget = base["bytes"] // COLD_BUDGET_SHARE
    store_dir = tempfile.mkdtemp(prefix="rw_cold_")

    def make():
        q = spec.build()
        host = None
        if spec.host_mv and not fused:
            mv = spec.mv(q)
            host = MaterializeExecutor(mv.pk, mv.columns, table_id=f"{spec.name}.host_mv")
            host.checkpoint_enabled = True
            q.pipeline.executors.append(host)
        if fused:
            fuse_pipeline(q.pipeline, label=label)
        return q, host

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    q, host = make()
    mgr = CheckpointManager(LocalFsObjectStore(store_dir))
    members = arm_cold(q.pipeline, mgr)
    rec = {"stage_ms": [], "sst_ms": [], "commit_ms": [], "rows": [], "bytes": []}
    barrier_ms, evict_ms, evicted, bytes_after, counts = [], [], [], [], Counter()
    host_checks, recovered = 0, None
    run_s, mem = 0.0, MemTrack(torch, start)
    for e in range(COLD_EPOCHS):
        mem.begin()
        t0 = time.perf_counter()
        spec.push(q, e)
        tb = time.perf_counter()
        q.pipeline.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        barrier_ms.append((t1 - tb) * 1e3)
        timed_commit(torch, mgr, q.pipeline.epoch, checkpointed_executors(q.pipeline.executors),
                     rec)
        total = cold_bytes(q.pipeline)
        if total > budget:
            n, ms = evict_checked(torch, members)
            evicted.append(n)
            evict_ms.append(ms)
        bytes_after.append(cold_bytes(q.pipeline))
        if spec.after is not None:
            spec.after(q, e)
        torch.cuda.synchronize()
        run_s += time.perf_counter() - t0
        mem.end()
        check(mv_digest(spec.mv(q)) == base["digests"][e],
              f"{label} barrier {e + 1}: MV digest = the un-evicted run's")
        if host is not None:
            # an order-free digest of the rows at every barrier, the rows
            # themselves sorted at the last
            d, h = spec.mv(q).to_numpy(), host.to_numpy()
            names = list(spec.mv(q).pk) + list(spec.mv(q).columns)
            dm = np.stack([d[k] for k in names], 1)
            hm = np.stack([h[k] for k in names], 1)
            same = (rows_digest(dm) == rows_digest(hm) if e < COLD_EPOCHS - 1 else
                    np.array_equal(dm[np.lexsort(dm.T[::-1])], hm[np.lexsort(hm.T[::-1])]))
            check(same, f"{label} barrier {e + 1}: the host MV = the device MV")
            host_checks += 1
        if kill and e == COLD_KILL_AT - 1:
            counts.update(cold_counts(members))
            check(evicted and evicted[-1] > 0, f"{label}: the kill follows an eviction")
            del q, host, members, mgr
            gc.collect()
            torch.cuda.empty_cache()
            q, host = make()
            recovered = timed_recover(torch, store_dir, q)
            mgr = CheckpointManager(LocalFsObjectStore(store_dir))
            members = arm_cold(q.pipeline, mgr)
            check(mv_digest(spec.mv(q)) == base["digests"][e],
                  f"{label}: recovered MV digest = the un-evicted run's at barrier {e + 1}")
    if spec.after is not None:
        # a last checkpoint, so that the store holds the last watermark's
        # closures (the point reads compare it with the un-evicted run)
        timed_commit(torch, mgr, q.pipeline.epoch + 1,
                     checkpointed_executors(q.pipeline.executors), rec)
    counts.update(cold_counts(members))
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    got = spec.rows(q)
    check(got.shape == spec.oracle.shape and np.array_equal(got, spec.oracle),
          f"{label}: MV ({len(got)} rows) vs the oracle ({len(spec.oracle)} rows)")
    for k in COLD_KERNELS[spec.name]:
        check(launches[k] > 0, f"{label}: kernel {k} launched")
    check(sum(evicted) > 0, f"{label}: groups or keys evicted")
    pct = lambda xs, p: float(np.percentile(xs, p)) if xs else None
    row = {
        "phase": {"q5": "32", "q8": "33", "q5_max": "34"}[spec.name], "path": label,
        "epochs": COLD_EPOCHS, "budget_bytes": budget, "unevicted_state_bytes": base["bytes"],
        "state_bytes_after_eviction": bytes_after, "evicted": evicted,
        "cold_counts": dict(counts), "rows_in": spec.rows_in,
        "rows_per_s": spec.rows_in / run_s, "run_s": run_s,
        # the un-evicted run commits nothing: phase 16 has its commits
        "rows_per_s_without_commits":
            spec.rows_in / (run_s - sum(rec["commit_ms"][:COLD_EPOCHS]) / 1e3),
        "barrier_ms_p50": pct(barrier_ms, 50), "barrier_ms_p99": pct(barrier_ms, 99),
        "barrier_ms": barrier_ms,
        "commit_ms_p50": pct(rec["commit_ms"], 50), "commit_ms_p99": pct(rec["commit_ms"], 99),
        "commit_ms": rec["commit_ms"], "rows_staged": rec["rows"],
        "evict_ms_p50": pct(evict_ms, 50), "evict_ms_p99": pct(evict_ms, 99),
        "evict_ms": evict_ms, **mem.row(),
        "unevicted": {**base["mem"], "run_s": base["run_s"],
                      "rows_per_s": spec.rows_in / base["run_s"],
                      "barrier_ms_p50": pct(base["barrier_ms"], 50),
                      "barrier_ms_p99": pct(base["barrier_ms"], 99)},
        "launches": launches,
        "checks": "MV kernel-H digest = the un-evicted run's at every barrier; MV = oracle at "
                  "the end; state_nbytes after each eviction = the hot set's table's",
    }
    if host_checks:
        row["host_mv_checks"] = host_checks
    if recovered is not None:
        row["kill_after_barrier"] = COLD_KILL_AT
        row["recover"] = recovered
    return row, launches, (store_dir, q)


def point_snapshot(torch, q) -> list:
    """What the store's point reads are held against, copied to the host
    so that the un-evicted run's query can leave the card before the
    budget runs: per join side its live and closed keys and its live
    keys' lanes, per agg its alive groups' keys and lanes (float extremes
    in the reference's dtype) and their multisets as ``mi_sorted`` rows."""
    from risingwave_tpu_torch.ops.agg import order_key_to_reference
    from risingwave_tpu_torch.runtime.fused_step import cold_executors

    out = []
    for ex in cold_executors(q.pipeline.executors):
        if hasattr(ex, "left"):
            for name, side in (("left", ex.left), ("right", ex.right)):
                live = side.table.live
                closed = (side.table.fp1 != 0) & ~live
                lanes = {"rv": side.row_valid, "deg": side.degree,
                         **{f"r_{n}": a for n, a in side.rows.items()},
                         **{f"n_{n}": a for n, a in side.row_nulls.items()}}
                out.append({
                    "tid": f"{ex.table_id}.{name}", "join": True,
                    "keys": {f"k{i}": k[live].cpu().numpy() for i, k in enumerate(side.table.keys)},
                    "closed": {f"k{i}": k[closed].cpu().numpy()
                               for i, k in enumerate(side.table.keys)},
                    "lanes": {k: a[live].cpu().numpy() for k, a in lanes.items()}})
            continue
        st, t = ex.state, ex.table
        alive = (t.live | st.emitted_valid) & (t.fp1 != 0)
        fx = dict(ex._float_extremes)
        want = {"row_count": st.row_count, "ev": st.emitted_valid}
        for n, a in st.accums.items():
            want[f"acc_{n}"], want[f"em_{n}"] = a, st.emitted[n]
        for n, a in st.nonnull.items():
            want[f"nn_{n}"], want[f"ei_{n}"] = a, st.emitted_isnull[n]
        lanes = {}
        for k, a in want.items():
            w = a[alive].cpu().numpy()
            name = k.split("_", 1)[-1]
            if k[:3] in ("acc", "em_") and name in fx:
                w = order_key_to_reference(w, np.dtype(str(fx[name]).split(".")[1]))
            lanes[k] = w
        multisets = {}
        for n, (v, c) in ex.minput.items():
            wv, wc = mi_sorted(torch, v[alive], c[alive])
            multisets[n] = (wv.cpu().numpy(), wc.cpu().numpy())
        out.append({"tid": ex.table_id, "join": False,
                    "keys": {f"k{i}": k[alive].cpu().numpy() for i, k in enumerate(t.keys)},
                    "lanes": lanes, "multisets": multisets})
    return out


def point_reads_equal(torch, store_dir, snap: list, what: str) -> dict:
    """The store's point reads of every key of the un-evicted run's aggs
    and join sides (``point_snapshot``) equal that run's lanes (a join
    side's buckets packed, a multiset as sorted (value, count) pairs); a
    join key the un-evicted run has closed (claimed, not live) reads
    absent."""
    from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore

    mgr = CheckpointManager(LocalFsObjectStore(store_dir))
    checked = Counter()
    for m in snap:
        tid = m["tid"]
        found, vals = mgr.get_rows(tid, m["keys"])
        if m["join"]:
            check(found.all(), f"{what}: every live {tid} key in the store")
            rv = m["lanes"]["rv"]
            order = np.argsort(~rv, axis=1, kind="stable")
            s_order = np.argsort(~vals["rv"], axis=1, kind="stable")
            pack = lambda a, o: np.take_along_axis(a, o, 1)
            for k, a in m["lanes"].items():
                want = np.where(pack(rv, order), pack(a, order), 0)
                got = np.where(pack(vals["rv"], s_order), pack(vals[k], s_order), 0)
                check(np.array_equal(got, want), f"{what}: {tid} lane {k}")
            n_closed = len(m["closed"]["k0"])
            if n_closed:
                f2, _ = mgr.get_rows(tid, m["closed"])
                check(not f2.any(), f"{what}: {tid}'s closed keys read absent")
                checked[f"{tid}.closed"] = n_closed
            checked[tid] = len(rv)
            continue
        check(found.all(), f"{what}: every {tid} group in the store")
        for k, w in m["lanes"].items():
            check(np.array_equal(vals[k], w), f"{what}: {tid} lane {k}")
        for n, (wv, wc) in m["multisets"].items():
            gv, gc = mi_sorted(torch, torch.from_numpy(vals[f"miv_{n}"]),
                               torch.from_numpy(vals[f"mic_{n}"]))
            check(np.array_equal(wv, gv.numpy()) and np.array_equal(wc, gc.numpy()),
                  f"{what}: {tid} multisets")
        checked[tid] = len(m["lanes"]["row_count"])
    return dict(checked)


def cold_paths(torch, dev, spec: ColdSpec) -> tuple:
    """Phases 32-34 for one query: the un-evicted run, then the path under
    the budget interpreted (with phase 16's kill where the query has
    one) and fused, then the store's point reads against the un-evicted
    run. Returns the rows and each path's launches."""
    import shutil

    base = cold_baseline(torch, spec)
    rows, by = [], {}
    for fused in (False, True):
        kill = not fused and spec.name in ("q5", "q8")
        row, launches, (store_dir, q) = cold_run(torch, dev, spec, base, fused, kill)
        try:
            if not fused:
                row["point_reads"] = point_reads_equal(torch, store_dir, base["snap"],
                                                       row["path"])
        finally:
            shutil.rmtree(store_dir, ignore_errors=True)
        del q
        by[row["path"]] = launches
        rows.append(row)
        torch.cuda.empty_cache()
    c_int, c_fused = rows[0]["cold_counts"], rows[1]["cold_counts"]
    for c in (c_int, c_fused):
        check(c.get("evicted", 0) > 0, f"{spec.name}: evicted > 0")
    if spec.name == "q5":
        check(c_int.get("merged", 0) > 0 and c_fused.get("merged", 0) > 0,
              "q5: groups merged back both ways")
    else:
        check(c_int.get("faulted_in", 0) > 0 and c_fused.get("faulted_in", 0) > 0,
              f"{spec.name}: keys faulted in both ways")
    if spec.name == "q8":
        check(c_int.get("cold_tombstones", 0) > 0 and c_fused.get("cold_tombstones", 0) > 0,
              "q8: closed evicted keys became cold tombstones both ways")
    del base
    torch.cuda.empty_cache()
    return rows, by


def q5_cold(torch, dev, chunks, cap, q5_oracle_cold):
    """Phase 32: q5 (hop -> COUNT(*) by (auction, window_start) -> device
    MV, and a host MV beside it) over phase 4's first COLD_EPOCHS
    epochs, tables of phase 4's sizes."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite

    ep = chunks[:COLD_EPOCHS]

    def push(q, e):
        for c in ep[e]:
            q.pipeline.push(c)

    def rows(q):
        got = mv_rows_sorted(q.mview)
        return np.stack([got["auction"], got["window_start"], got["num"]], 1)

    spec = ColdSpec("q5", lambda: build_q5_lite(capacity=cap, state_cleaning=False, device=dev),
                    push, None, lambda q: q.mview, rows, np.stack(q5_oracle_cold, 1),
                    sum(int(c.valid.sum()) for e in ep for c in e), host_mv=True)
    return cold_paths(torch, dev, spec)


def q5_max_cold(torch, dev, chunks, cap, q5_oracle_cold):
    """Phase 34: q5-max over phase 4's first COLD_EPOCHS epochs with a
    watermark after every barrier's commit and eviction, phase 13's
    sizes."""
    from risingwave_tpu_torch.queries.nexmark_q import build_q5_max

    ep = chunks[:COLD_EPOCHS]
    ts = [max(int(c.col("date_time")[c.valid].max()) for c in e) for e in ep]

    def push(q, e):
        for c in ep[e]:
            q.pipeline.push(c)

    spec = ColdSpec("q5_max", lambda: build_q5_max(capacity=cap, max_capacity=Q5MAX_MAX_CAP,
                                                   minput_k=Q5MAX_K, device=dev),
                    push, lambda q, e: q.pipeline.watermark("date_time", ts[e]),
                    lambda q: q.mview, lambda q: q5_max_mv_rows(q.mview),
                    q5_max_oracle(q5_oracle_cold), sum(int(c.valid.sum()) for e in ep for c in e))
    return cold_paths(torch, dev, spec)


def q8_shifted(torch, dev, host, epochs: int):
    """Phase 7's events cut into ``epochs`` epochs of the same span whose
    boundaries fall Q8_COLD_SHIFT_MS into a tumble window (phase 7's
    epochs end on window boundaries, so no window spans two of them and
    no key returns): per epoch one person and one auction chunk, the
    capacities the next power of two of the largest epoch's rows."""
    from risingwave_tpu_torch.array.chunk import StreamChunk

    cat = lambda side, ks: {k: np.concatenate([h[side][k] for h in host]) for k in ks}
    persons = cat(0, ("id", "name", "date_time"))
    auctions = cat(1, ("seller", "date_time"))
    t0 = int(min(persons["date_time"].min(), auctions["date_time"].min()))
    span = EVENTS_PER_EPOCH * 1000 // EVENT_RATE
    edges = [-(2**62)] + [t0 + Q8_COLD_SHIFT_MS + e * span for e in range(1, epochs + 1)]
    cut = lambda d, lo, hi: {k: v[(d["date_time"] >= lo) & (d["date_time"] < hi)]
                             for k, v in d.items()}
    out = [(cut(persons, lo, hi), cut(auctions, lo, hi)) for lo, hi in zip(edges, edges[1:])]
    pow2 = lambda m: 1 << (max(m, 64) - 1).bit_length()
    p_cap = pow2(max(len(p["id"]) for p, _ in out))
    a_cap = pow2(max(len(a["seller"]) for _, a in out))
    chunks = [(StreamChunk.from_numpy(p, p_cap, device=dev),
               StreamChunk.from_numpy(a, a_cap, device=dev)) for p, a in out]
    return out, chunks


def q8_cold(torch, dev, host, chunks):
    """Phase 33: q8 over phase 7's events cut into COLD_EPOCHS epochs
    that end inside a window (``q8_shifted``), with a ``date_time``
    watermark after every barrier's commit and eviction,
    Q8_WM_DELAY_MS behind the largest event time so far (the window
    open at an epoch's end stays open: its evicted keys come back),
    phase 7's sizes."""
    from risingwave_tpu_torch.queries.nexmark_q import Q8_WINDOW_MS, build_q8

    host, chunks = q8_shifted(torch, dev, host, COLD_EPOCHS)
    ts = np.maximum.accumulate([max(int(p["date_time"].max()), int(a["date_time"].max()))
                                for p, a in host]) - Q8_WM_DELAY_MS
    ts = ts.tolist()

    def push(q, e):
        p, a = chunks[e]
        q.pipeline.push_left(p)
        q.pipeline.push_right(a)

    spec = ColdSpec("q8", lambda: build_q8(capacity=Q8_CAP, fanout=Q8_FANOUT, out_cap=Q8_OUT_CAP,
                                           device=dev),
                    push, lambda q, e: q.pipeline.watermark("date_time", ts[e]),
                    lambda q: q.mview, lambda q: q8_mv_rows(q.mview),
                    oracle_rows(cpu_actor_q8(host, Q8_WINDOW_MS)),
                    sum(len(p["id"]) + len(a["seller"]) for p, a in host))
    return cold_paths(torch, dev, spec)


def p28_host_path(torch, dev, host, chunks, a_chunks, epochs: int = 1):
    """The host phase's temporal enrichment: phase 28's query with its
    auctions in a host ``MaterializeExecutor`` (the temporal join's
    host probe) over phase 11's first ``epochs`` epochs, the seller MV
    equal to the numpy oracle (what the device-MV run equals) at every
    barrier."""
    from risingwave_tpu_torch.executors import TemporalJoinExecutor
    from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.executors.materialize import (
        DeviceMaterializeExecutor,
        MaterializeExecutor,
    )
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    i64 = torch.int64
    auctions = MaterializeExecutor(("id",), ("seller", "category"), table_id="p28.host_auctions")
    agg = HashAggExecutor(("seller",), (AggCall("count_star", None, "n"),
                                        AggCall("sum", "price", "total")),
                          {"seller": i64, "price": i64}, capacity=P28_CAP,
                          nullable_keys=("seller",), table_id="p28.agg", device=dev)
    mview = DeviceMaterializeExecutor(("seller",), ("n", "total"),
                                      dict.fromkeys(("seller", "n", "total"), i64),
                                      table_id="p28.mview", capacity=P28_CAP, device=dev)
    bids = Pipeline([TemporalJoinExecutor(auctions, ("auction",), ("seller", "category"),
                                          "inner"), agg, mview])
    t0 = time.perf_counter()
    n_bids = 0
    for e in range(epochs):
        auctions.apply(a_chunks[e])
        auctions.on_barrier(None)
        for b in chunks[e][1]:
            bids.push(b)
            n_bids += int(b.valid.sum())
        bids.barrier()
        want = p28_oracle(host, e)
        got = mv_table_rows(mview, P28_NAMES)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"p28 host MV: seller MV vs the oracle at barrier {e + 1}")
    return {"phase": "host", "path": "p28_host_mv", "epochs": epochs, "bids": n_bids,
            "auctions_rows": len(auctions.snapshot()), "backend": auctions._backend,
            "run_s": time.perf_counter() - t0,
            "checks": "the temporal join's host probe against a host MV: the seller MV = the "
                      "numpy oracle (= the device-MV run of phase 28) at every barrier"}


# -- phases 35-37 and phase 16's graph kill: SQL through the actor graph ----
# the SQL of __graft_entry__.py:20-50 (bench.py:729's q5), copied
Q5_SQL = (
    "CREATE MATERIALIZED VIEW q5 AS "
    "SELECT auction, window_start, count(*) AS num "
    "FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND) "
    "GROUP BY auction, window_start"
)
Q7_SQL = (
    "CREATE MATERIALIZED VIEW q7 AS "
    "SELECT b.auction, b.bidder, b.price, b.wstart FROM "
    "(SELECT auction, bidder, price, window_start AS wstart "
    " FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)) AS b "
    "JOIN "
    "(SELECT max(price) AS maxprice, window_start AS mwstart "
    " FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND) "
    " GROUP BY window_start) AS m "
    "ON b.wstart = m.mwstart AND b.price = m.maxprice"
)
Q8_SQL = (
    "CREATE MATERIALIZED VIEW q8 AS "
    "SELECT p.id, p.name, p.starttime FROM "
    "(SELECT id, name, window_start AS starttime "
    " FROM TUMBLE(person, date_time, INTERVAL '10' SECOND) "
    " GROUP BY id, name, window_start) AS p "
    "JOIN "
    "(SELECT seller, window_start AS astarttime "
    " FROM TUMBLE(auction, date_time, INTERVAL '10' SECOND) "
    " GROUP BY seller, window_start) AS a "
    "ON p.id = a.seller AND p.starttime = a.astarttime"
)
GRAPH_P = 4  # parallel actors of a partitioned fragment
GRAPH_RESTORE_P = 3  # phase 16's graph kill recovers at another parallelism
AH_ROWS = (65_536, 1 << 20)  # vnode_of against its plain version at these sizes
AH_OF_ROWS = 1 << 22  # vnode_of's timing shape: a restored agg's dispatch-key lane
# the depth the reference's SQL q7 plan holds on phase 9's stream: its join
# side's (window, price) keys pass the planner's fanout of 16 in chunk 2
# (bid 14,739; the reference raises there on the CPU as the port does)
Q7_SQL_CHUNKS = 1
GRAPH_Q5_KERNELS = ("hop_expand", "lookup_or_insert", "agg_flush", "mv_upsert")
GRAPH_Q8_KERNELS = ("hop_expand", "lookup_or_insert", "dedup_emit", "join_apply", "join_probe")


def sql_factory(dev, tables, cap: int):
    """A fresh planner per call over the Nexmark tables named, as
    ``graph_planned_mv`` wants one per instance."""
    from risingwave_tpu_torch.connectors import nexmark as nx
    from risingwave_tpu_torch.sql import Catalog, StreamPlanner

    schemas = {"bid": nx.BID_SCHEMA, "person": nx.PERSON_SCHEMA, "auction": nx.AUCTION_SCHEMA}
    catalog = Catalog({t: schemas[t] for t in tables})
    return lambda: StreamPlanner(catalog, capacity=cap, device=dev)


def partitioned_views(mv) -> list:
    from risingwave_tpu_torch.runtime.fragmenter import PartitionedStateView

    return [v for v in mv.pipeline.executors if isinstance(v, PartitionedStateView)]


def union_digest(view) -> int:
    """Kernel H's digest of a partitioned agg's whole table: each packed
    (sum, xor) instance digest combined as one table's (the instances'
    key spaces are disjoint), so it does not depend on the parallelism."""
    from risingwave_tpu_torch import integrity

    s = x = 0
    for inst in view._instances:
        d = integrity.digest_from_scalar(integrity.device_digest(*inst.digest_lanes()))
        s, x = (s + (d >> 32)) & 0xFFFFFFFF, x ^ (d & 0xFFFFFFFF)
    return (s << 32) | x


def instance_groups(view) -> list:
    return [int(inst.table.live.sum()) for inst in view._instances]


def kernel_ah(torch, dev, bid):
    """AH against its plain versions on the card, bit for bit: vnode_of
    over 65,536 and 2^20 rows of every key dtype (float lanes with -0.0,
    +0.0, NaNs of two payloads, infinities), two- and three-lane keys and
    a strided lane; the dispatch masks for 2, 3 and 4 downstreams on a
    q5 bid chunk with invalid rows. Times both entries at the main
    path's shapes."""
    from risingwave_tpu_torch.ops import hashing as H

    rng = np.random.default_rng(SEED + 35)
    keys = [("int64",), ("int32",), ("bool",), ("float32",), ("float64",), ("int64", "int64"),
            ("int64", "float64", "bool"), ("int32", "float32", "int64")]
    checked = 0
    for n in AH_ROWS:
        f32, f64 = rng.standard_normal(n).astype(np.float32), rng.standard_normal(n)
        specials = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
        f32[:6], f64[:6] = specials, specials
        f32[6] = np.array(0x7FC00123, np.uint32).view(np.float32)
        f64[6] = np.array(0x7FF0000000000ABC, np.uint64).view(np.float64)
        host = {"int64": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
                "int32": rng.integers(-(2**31), 2**31, n).astype(np.int32),
                "bool": rng.random(n) < 0.5, "float32": f32, "float64": f64}
        lanes = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        for key in keys:
            cols = [lanes[k] if i == 0 else torch.roll(lanes[k], i) for i, k in enumerate(key)]
            got = H._vnode_of_cuda(cols)
            check(torch.equal(got, H._vnode_of_torch(cols)), f"AH vnode_of {key}, {n} rows")
            if key[0].startswith("float"):
                g = got[:7].tolist()
                check(g[0] == g[1] and g[2] == g[3] == g[6], f"AH: -0.0 and NaNs, {key}")
            checked += 1
        wide = torch.stack([lanes["int64"], lanes["float64"].view(torch.int64)], 1)
        got = H._vnode_of_cuda([wide[:, 1], wide[:, 0]])
        check(torch.equal(got, H._vnode_of_torch([wide[:, 1].contiguous(), lanes["int64"]])),
              f"AH vnode_of on strided lanes, {n} rows")
    n = bid.capacity
    auction = bid.col("auction")
    valid = bid.valid.clone()
    valid[::7] = False
    check(int((~valid).sum()) > 0, "AH: the bid chunk has invalid rows")
    for n_down in (2, 3, 4):
        got = H._vnode_dispatch_cuda([auction], valid, n_down)
        check(torch.equal(got, H._vnode_slice_masks_torch([auction], valid, n_down)),
              f"AH dispatch masks, {n_down} downstreams")
        check(torch.equal(got.sum(0), valid.to(torch.int64)), "AH: one downstream a valid row")
    ms = time_ms(torch, lambda: H._vnode_dispatch_cuda([auction], valid, GRAPH_P), 50)
    plain = time_ms(torch, lambda: H._vnode_slice_masks_torch([auction], valid, GRAPH_P), 20)
    lane = torch.from_numpy(rng.integers(0, 1 << 40, AH_OF_ROWS, dtype=np.int64)).to(dev)
    ms_of = time_ms(torch, lambda: H._vnode_of_cuda([lane]), 50)
    plain_of = time_ms(torch, lambda: H._vnode_of_torch([lane]), 10)
    common = {"route": "cuda", "source": "risingwave_tpu_torch/csrc/vnode.cu",
              "max_abs_err": 0.0, "bound_by": "bytes", "library_ms": None,
              "library_call": "none (no PyTorch call hashes rows)"}
    return [
        {"name": "AH dispatch masks", **common,
         "replaces": "risingwave_tpu/runtime/graph.py:172", "ms": ms, "plain_ms": plain,
         # the key lane 8 and valid 1 read, n_down mask bytes written, per row
         "bound_ms": bound_ms(n * (9 + GRAPH_P)),
         "shape": {"rows": n, "key_lanes": 1, "n_down": GRAPH_P,
                   "invalid_rows": int((~valid).sum()), "cases_checked": checked + 3}},
        {"name": "AH vnode_of", **common,
         "replaces": "risingwave_tpu/ops/hashing.py:129", "ms": ms_of, "plain_ms": plain_of,
         "bound_ms": bound_ms(AH_OF_ROWS * 12),  # an int64 lane read, int32 vnodes written
         "shape": {"rows": AH_OF_ROWS, "key_lanes": 1}},
    ]


def check_sync_guard_threads(torch, dev) -> dict:
    """The fused program's guard under actor threads, on the card: a read
    inside one thread's guarded block raises, another thread's read at
    the same moment does not, and the sync mode is restored after both."""
    import threading

    from risingwave_tpu_torch.runtime import fused_step as fs

    probe = torch.zeros(1, device=dev)
    a_inside, b_done = threading.Event(), threading.Event()
    seen = {}

    def guarded():
        with fs.shared_device_thread():
            with fs.no_device_reads(dev):
                a_inside.set()
                b_done.wait(30)
                try:
                    probe.item()
                    seen["a"] = "read let through"
                except fs.DeviceReadInFusedProgram:
                    seen["a"] = "raised"

    def reader():
        with fs.shared_device_thread():
            a_inside.wait(30)
            try:
                probe.item()
                seen["b"] = "read"
            except Exception as e:  # noqa: BLE001 -- reported by the check below
                seen["b"] = repr(e)
            finally:
                b_done.set()

    ts = [threading.Thread(target=guarded), threading.Thread(target=reader)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    check(seen == {"a": "raised", "b": "read"}, f"the read guard under two threads: {seen}")
    check(torch.cuda.get_sync_debug_mode() == 0, "the read guard restored the sync mode")
    return seen


def run_graph(torch, mv, epochs_data, push):
    """Drive a planned MV's graph over the epochs (``push(pipeline,
    epoch)``, a barrier, the card drained), timed; returns the barrier
    ms, the run's seconds, launches and peak bytes."""
    from risingwave_tpu_torch import _kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    barrier_ms = []
    t_run = time.perf_counter()
    for ep in epochs_data:
        push(mv.pipeline, ep)
        tb = time.perf_counter()
        mv.pipeline.barrier()
        torch.cuda.synchronize()
        barrier_ms.append((time.perf_counter() - tb) * 1e3)
    run_s = time.perf_counter() - t_run
    return barrier_ms, run_s, dict(_kernels.LAUNCHES), torch.cuda.max_memory_allocated()


def graph_row(phase, key, mv, p, eb, barrier_ms, run_s, rows_in, launches, peak, alive, **extra):
    return {
        "phase": phase, "path": key, "parallelism": p, "epoch_batch": eb,
        "actors": len(mv.pipeline.graph.actors), "actors_alive_after_close": alive,
        "plan": [type(e).__name__ for e in mv.pipeline.executors],
        "rows_per_s": rows_in / run_s, "run_s": run_s,
        "barrier_ms_p50": float(np.percentile(barrier_ms, 50)),
        "barrier_ms_p99": float(np.percentile(barrier_ms, 99)), "barrier_ms": barrier_ms,
        "max_memory_allocated": int(peak), "launches": launches, **extra,
    }


def q5_graph_paths(torch, dev, chunks, oracle, q5_rows):
    """Phase 35: q5 from SQL (``graph_planned_mv``, bench.py's planner
    capacity) over phase 4's chunks: one actor (bench.py's own setting,
    no hash dispatch), and GRAPH_P parallel agg actors behind AH's
    dispatch, fused chains in the actors and chunk by chunk. Each MV
    against the numpy oracle and phase 4's MV; at GRAPH_P every instance
    owns some groups but not all, and their groups sum to the MV's."""
    import gc

    from risingwave_tpu_torch.runtime.fragmenter import graph_planned_mv

    cap = state_cap(2 * EVENTS_PER_EPOCH, 1 << 16)
    factory = sql_factory(dev, ("bid",), cap)
    n_chunks = sum(len(ep) for ep in chunks)
    n_bids = sum(int(c.valid.sum()) for ep in chunks for c in ep)
    want = sort_rows(np.stack(oracle, 1))
    check(np.array_equal(q5_rows, want), "phase 35: phase 4's MV = the oracle")

    def push(pipeline, ep):
        for c in ep:
            pipeline.push(c)

    rows, launches = [], {}
    for key, p, eb in (("q5_sql_p1", 1, True), (f"q5_sql_p{GRAPH_P}", GRAPH_P, True),
                       (f"q5_sql_p{GRAPH_P}_chunked", GRAPH_P, False)):
        mv = graph_planned_mv(factory, Q5_SQL, parallelism=p, epoch_batch=eb)
        graph = mv.pipeline.graph
        try:
            barrier_ms, run_s, got_l, peak = run_graph(torch, mv, chunks, push)
            got = mv_table_rows(mv.mview, P25_NAMES)
            check(np.array_equal(got, want), f"{key}: MV ({len(got)} rows) = the oracle and "
                                             "phase 4's MV")
            groups = None
            if p > 1:
                (view,) = partitioned_views(mv)
                groups = instance_groups(view)
                del view  # it holds the instances: the next run must not
                check(all(0 < g < len(want) for g in groups), f"{key}: every instance owns "
                                                              f"some groups, none all: {groups}")
                check(sum(groups) == len(got), f"{key}: instances' groups sum to the MV's")
            check(got_l["vnode_dispatch"] == (n_chunks if p > 1 else 0),
                  f"{key}: AH's dispatch once a chunk ({got_l['vnode_dispatch']})")
            for name in GRAPH_Q5_KERNELS:
                check(got_l[name] > 0, f"{key}: kernel {name} launched")
        finally:
            mv.pipeline.close()
        alive = sum(a.is_alive() for a in graph.actors)
        check(alive == 0, f"{key}: no actor thread alive after close()")
        launches[key] = got_l
        rows.append(graph_row("35", key, mv, p, eb, barrier_ms, run_s, n_bids, got_l, peak,
                              alive, planner_capacity=cap, chunks=n_chunks, bids=n_bids,
                              groups=int(len(got)), groups_per_instance=groups,
                              oracle="numpy q5 oracle and phase 4's MV: equal"))
        del mv, graph  # the graph's actors hold the executors, in reference cycles
        gc.collect()
        torch.cuda.empty_cache()
    rows[-1]["sync_guard_threads"] = check_sync_guard_threads(torch, dev)
    return rows, launches


def q8_sql_rows(mview) -> np.ndarray:
    """The SQL q8's host MV as (id, starttime, name) rows, sorted as
    ``oracle_rows``."""
    got = mview.to_numpy()
    rows = np.stack([got["id"], got["starttime"], got["name"].astype(np.int64)], 1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def q8_graph_paths(torch, dev, host, chunks, oracle, rows7):
    """Phase 36: q8 from SQL at GRAPH_P parallel join actors over phase
    7's events (each epoch's person chunk pushed left, its auction chunk
    right), fused chains in the actors and chunk by chunk; the host MV
    tail on the terminal actor against the copy of cpu_actor_q8 and
    phase 7's MV."""
    import gc

    from risingwave_tpu_torch.runtime.fragmenter import graph_planned_mv

    factory = sql_factory(dev, ("person", "auction"), Q8_CAP)
    rows_in = sum(len(p["id"]) + len(a["seller"]) for p, a in host)
    check(np.array_equal(rows7, oracle), "phase 36: phase 7's MV = the q8 actor")

    def push(pipeline, ep):
        pipeline.push_left(ep[0])
        pipeline.push_right(ep[1])

    rows, launches = [], {}
    for key, eb in ((f"q8_sql_p{GRAPH_P}", True), (f"q8_sql_p{GRAPH_P}_chunked", False)):
        mv = graph_planned_mv(factory, Q8_SQL, parallelism=GRAPH_P, epoch_batch=eb)
        graph = mv.pipeline.graph
        try:
            barrier_ms, run_s, got_l, peak = run_graph(torch, mv, chunks, push)
            got = q8_sql_rows(mv.mview)
            check(got.shape == oracle.shape and np.array_equal(got, oracle),
                  f"{key}: MV ({len(got)} rows) = the q8 actor and phase 7's MV")
            check(got_l["vnode_dispatch"] == 2 * len(chunks),
                  f"{key}: AH's dispatch once a chunk on each side")
            for name in GRAPH_Q8_KERNELS:
                check(got_l[name] > 0, f"{key}: kernel {name} launched")
            check(len(partitioned_views(mv)) == 3, f"{key}: both dedups and the join partitioned")
        finally:
            mv.pipeline.close()
        alive = sum(a.is_alive() for a in graph.actors)
        check(alive == 0, f"{key}: no actor thread alive after close()")
        launches[key] = got_l
        rows.append(graph_row("36", key, mv, GRAPH_P, eb, barrier_ms, run_s, rows_in, got_l,
                              peak, alive, planner_capacity=Q8_CAP, mv_rows=int(len(got)),
                              oracle="bench.py's cpu_actor_q8 (copied) and phase 7's MV: "
                                     "equal"))
        del mv, graph  # the graph's actors hold the executors, in reference cycles
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


def q7_graph_paths(torch, dev, host, chunks):
    """Phase 37: q7 from SQL. Its join keys trace to no source column, so
    ``graph_planned_mv`` builds one join actor at any parallelism, as the
    reference. Over phase 9's first Q7_SQL_CHUNKS chunks (the depth the
    reference's plan holds: its join side's keys pass the fanout of 16
    in the next chunk), both ways, the MV against the copy of
    cpu_actor_q7; then the next chunk overflows the join side at the
    barrier, as the reference's does."""
    import gc

    from risingwave_tpu_torch.queries.nexmark_q import Q7_WINDOW_MS
    from risingwave_tpu_torch.runtime.fragmenter import graph_planned_mv

    factory = sql_factory(dev, ("bid",), Q7_CAP)
    data = [[c] for c in chunks[0][:Q7_SQL_CHUNKS]]
    want = actor_rows(cpu_actor_q7(host[0][:Q7_SQL_CHUNKS], Q7_WINDOW_MS))
    rows_in = sum(len(c["auction"]) for c in host[0][:Q7_SQL_CHUNKS])

    def push(pipeline, ep):
        for c in ep:
            pipeline.push_left(c)
            pipeline.push_right(c)

    rows, launches = [], {}
    for key, eb in (("q7_sql", True), ("q7_sql_chunked", False)):
        mv = graph_planned_mv(factory, Q7_SQL, parallelism=GRAPH_P, epoch_batch=eb)
        graph = mv.pipeline.graph
        overflow = None
        try:
            names = sorted(a.actor_name for a in graph.actors)
            check(names == ["join#0", "left_src#0", "right_src#0"],
                  f"{key}: one join actor ({names})")
            barrier_ms, run_s, got_l, peak = run_graph(torch, mv, data, push)
            got = q7_mv_rows(mv.mview)
            check(len(want) and got.shape == want.shape and np.array_equal(got, want),
                  f"{key}: MV ({len(got)} rows) = the q7 actor")
            for name in ("hop_expand", "lookup_or_insert", "join_apply", "join_probe"):
                check(got_l[name] > 0, f"{key}: kernel {name} launched")
            check(got_l["vnode_dispatch"] == 0, f"{key}: no hash dispatch")
            push(mv.pipeline, [chunks[0][Q7_SQL_CHUNKS]])
            try:
                mv.pipeline.barrier()
            except RuntimeError as e:
                overflow = repr(e.__cause__)
            check(overflow is not None and "overflowed" in overflow,
                  f"{key}: the next chunk overflows the join side as the reference's plan")
        finally:
            mv.pipeline.close()
        alive = sum(a.is_alive() for a in graph.actors)
        check(alive == 0, f"{key}: no actor thread alive after close()")
        launches[key] = got_l
        rows.append(graph_row("37", key, mv, GRAPH_P, eb, barrier_ms, run_s, rows_in, got_l,
                              peak, alive, planner_capacity=Q7_CAP, chunks=Q7_SQL_CHUNKS,
                              mv_rows=int(len(got)), next_chunk=overflow,
                              oracle="bench.py's cpu_actor_q7 (copied) over these chunks: "
                                     "equal"))
        del mv, graph  # the graph's actors hold the executors, in reference cycles
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


def kill_q5_graph(torch, dev, chunks, q5_oracle10):
    """Phase 16's q5 from SQL: GRAPH_P parallel agg actors, a commit into
    a LocalFsObjectStore after every barrier, killed (the graph closed,
    every object gone) after barrier KILL_AT of KILL_EPOCHS, recovered
    into a fresh graph at GRAPH_RESTORE_P actors (every restored row
    routed by AH's vnode_of), and continued beside an uninterrupted run
    at GRAPH_P: the MV's and the agg table's kernel-H digests equal at
    every barrier, the rows at the end, and the oracle."""
    import gc
    import shutil
    import tempfile

    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.runtime.fragmenter import graph_planned_mv
    from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore

    factory = sql_factory(dev, ("bid",), state_cap(2 * EVENTS_PER_EPOCH, 1 << 16))
    ep = chunks[:KILL_EPOCHS]

    def drive(q, e):
        for c in ep[e]:
            q.pipeline.push(c)
        q.pipeline.barrier()

    def state(q):
        (view,) = partitioned_views(q)
        return {"agg": union_digest(view), "mv": mv_digest(q.mview)}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    store_dir = tempfile.mkdtemp(prefix="rw_ckpt_")
    a = b = a2 = None
    try:
        a = graph_planned_mv(factory, Q5_SQL, parallelism=GRAPH_P)
        b = graph_planned_mv(factory, Q5_SQL, parallelism=GRAPH_P)
        mgr = CheckpointManager(LocalFsObjectStore(store_dir))
        rec = {"stage_ms": [], "sst_ms": [], "commit_ms": [], "rows": [], "bytes": []}
        for e in range(KILL_AT):
            drive(a, e)
            drive(b, e)
            timed_commit(torch, mgr, a.pipeline.epoch, a.pipeline.executors, rec)
        pre = state(a)
        check(pre == state(b), "q5 graph: A = B before the kill")
        pre_rows = mv_table_rows(a.mview, P25_NAMES)
        a.pipeline.close()
        check(not any(t.is_alive() for t in a.pipeline.graph.actors), "q5 graph: A closed")
        del a, mgr
        a = None
        gc.collect()
        torch.cuda.empty_cache()
        a2 = graph_planned_mv(factory, Q5_SQL, parallelism=GRAPH_RESTORE_P)
        before = _kernels.LAUNCHES["vnode_of"]
        rec_a2 = timed_recover(torch, store_dir, a2)
        routed = _kernels.LAUNCHES["vnode_of"] - before
        a2.pipeline._epoch = rec_a2["epoch"]
        check(routed > 0, "q5 graph: the restore routed rows through AH's vnode_of")
        check(np.array_equal(mv_table_rows(a2.mview, P25_NAMES), pre_rows),
              "q5 graph: recovered MV = pre-kill")
        check(state(a2) == pre, "q5 graph: recovered agg and MV digests = pre-kill")
        (view,) = partitioned_views(a2)
        groups = instance_groups(view)
        check(len(groups) == GRAPH_RESTORE_P and min(groups) > 0,
              f"q5 graph: every recovered instance owns groups ({groups})")
        for e in range(KILL_AT, KILL_EPOCHS):
            drive(a2, e)
            drive(b, e)
            check(state(a2) == state(b), f"q5 graph barrier {e + 1}: recovered = B")
        got = mv_table_rows(a2.mview, P25_NAMES)
        check(np.array_equal(got, mv_table_rows(b.mview, P25_NAMES)), "q5 graph: rows = B's")
        check(np.array_equal(got, sort_rows(np.stack(q5_oracle10, 1))),
              "q5 graph: MV = the oracle")
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for k in R_ENTRIES:
            check(launches[k] > 0, f"q5 graph: kernel R's {k} launched")
        pct = lambda xs, p: float(np.percentile(xs, p))
        return {
            "phase": "16", "query": "q5_sql_graph", "epochs": KILL_EPOCHS,
            "kill_after_barrier": KILL_AT, "parallelism": GRAPH_P,
            "recovered_parallelism": GRAPH_RESTORE_P, "vnode_of_launches": routed,
            "groups_per_instance_after_recovery": groups,
            "commit_ms_p50": pct(rec["commit_ms"], 50), "commit_ms_p99": pct(rec["commit_ms"], 99),
            "stage_ms_p50": pct(rec["stage_ms"], 50), "sst_put_ms_p50": pct(rec["sst_ms"], 50),
            "commit_ms": rec["commit_ms"], "rows_staged": rec["rows"],
            "bytes_staged": rec["bytes"], **rec_a2, "mv_rows": int(len(got)),
            "max_memory_allocated": int(peak), "launches": launches,
            "checks": "recovered MV rows and the agg's and MV's kernel-H digests = pre-kill; "
                      "the recovered run (3 actors) = the uninterrupted one (4) at every "
                      "barrier (digests), rows at the end; MV = oracle",
        }, launches
    finally:
        for q in (a, a2, b):
            if q is not None:
                q.pipeline.close()
        shutil.rmtree(store_dir, ignore_errors=True)



# -- the sharded path: kernel AI (phase 3), phases 38-41 ---------------------------
SHARDS = (4, 8)  # phase 38's meshes
SHARD_KILL = (4, 8)  # phase 39: run and killed at 4 shards, recovered at 8
SHARD_Q8_CAP = 1 << 20  # phase 39's planner capacity: a join side's ~300,000 keys a shard
SHARD_Q7_CAP = 1 << 18  # phase 40's: one 8,192-event chunk (Q7_CAP's sides, 4 times, need 21 GB)
SHARD_TOPN = 4  # phase 41's mesh
AI_TYPE_ROWS = 65_536  # the dtype cases' rows a source shard
AI_SKEW_BUCKET = 4_096
SHARD_Q5_KERNELS = ("exchange", "hop_expand", "lookup_or_insert", "agg_apply", "agg_flush",
                    "mv_upsert")
SHARD_Q8_KERNELS = ("exchange", "hop_expand", "lookup_or_insert", "dedup_emit", "join_apply",
                    "join_probe", "mv_upsert")
SHARD_Q7_KERNELS = ("exchange", "hop_expand", "lookup_or_insert", "agg_apply", "agg_flush",
                    "join_apply", "join_probe", "mv_upsert")
SHARD_TOPN_KERNELS = ("exchange", "lookup_or_insert", "topn_upsert", "group_topk",
                      "gather_rows", "mv_upsert")


def ai_bytes(chunk, out, keys) -> int:
    """Kernel AI's bytes: each input lane's storage read once (a
    broadcast lane once), the keys too where they are not lanes, each
    output lane and ``valid`` written once, the counts and flags."""
    seen, total = set(), 0
    for a in list(chunk.columns.values()) + list(chunk.nulls.values()) + [chunk.ops,
                                                                         chunk.valid] + list(keys):
        p = a.untyped_storage().data_ptr()
        if p in seen:
            continue
        seen.add(p)
        total += a.untyped_storage().nbytes()
    received, overflow, counts = out
    for a in (list(received.columns.values()) + list(received.nulls.values())
              + [received.ops, received.valid, overflow, counts]):
        total += a.numel() * a.element_size()
    return total


AI_HARD_CAP = 2 * 2048 + 5  # rows a source shard: two tiles and a few rows of a third


def ai_hard_chunk(torch, dev, rng, n_shards: int, cap: int, key=None, valid_share: float = 0.8):
    """A stacked (n_shards, cap) chunk with int64, int32, float32 and bool
    lanes (NULLs in one), a float64 lane broadcast to every shard (stride
    0), ops, and ``valid_share`` of its rows valid; the keys random in
    [0, 5,000) unless ``key`` is given."""
    from risingwave_tpu_torch.array.chunk import StreamChunk

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    shape = (n_shards, cap)
    k = rng.integers(0, 5_000, shape).astype(np.int64) if key is None else np.full(shape, key)
    cols = {"k": t(k), "a": t(rng.integers(-(2**31), 2**31 - 1, shape).astype(np.int32)),
            "g": t(rng.standard_normal(shape).astype(np.float32)),
            "b": t(rng.random(shape) < 0.5),
            "f": t(rng.standard_normal(cap)).unsqueeze(0).expand(n_shards, cap)}
    return StreamChunk(cols, t(rng.random(shape) < valid_share), {"g": t(rng.random(shape) < 0.3)},
                       t(rng.integers(0, 4, shape).astype(np.int32)))


def ai_hard_cases(torch, dev, rng) -> list:
    """(what, chunk, keys, shards, bucket_cap) of AI's hard cases: 1, 3 and
    64 shards; one destination taking every row; a bucket exactly full;
    chunks of no rows."""
    from risingwave_tpu_torch.parallel import exchange as X

    cases = []
    for n in (1, 3, 64):
        st = ai_hard_chunk(torch, dev, rng, n, AI_HARD_CAP)
        cases.append((f"{n} shards", st, (st.col("k"),), n, X.default_bucket_cap(AI_HARD_CAP, n)))
    st = ai_hard_chunk(torch, dev, rng, 8, AI_HARD_CAP, key=4242)
    cases.append(("one destination takes every row", st, (st.col("k"),), 8, AI_HARD_CAP))
    st = ai_hard_chunk(torch, dev, rng, 4, AI_HARD_CAP, key=99, valid_share=1.0)
    cases.append(("a bucket exactly full", st, (st.col("k"),), 4, AI_HARD_CAP))
    st = ai_hard_chunk(torch, dev, rng, 4, 0)
    cases.append(("cap 0", st, (st.col("k"),), 4, X.default_bucket_cap(0, 4)))
    return cases


def kernel_ai(torch, dev, chunks):
    """AI against its plain version on the card, bit for bit (every
    received lane, valid, counts, flags): q5's hopped chunks stacked 4
    deep at 4 shards (four distinct 327,680-row chunks) and split 8 ways
    as the plan's StackSplit does (one chunk broadcast, stride 0);
    int64, int32, float64 (-0.0, NaNs), float32 and bool keys and a
    nullable int64 key as the agg builds it; a chunk whose rows all go
    to one shard, past a bucket of AI_SKEW_BUCKET (flags set, the sink
    writes nothing); ``ai_hard_cases``. Times the two q5 shapes; the library point is
    ``torch.sort(stable=True)`` of the destination lane."""
    from risingwave_tpu_torch.array.chunk import StreamChunk, stack_chunks
    from risingwave_tpu_torch.executors.hop_window import hop_step_fn
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.sharded_agg import _stacked_key_lanes
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS
    from risingwave_tpu_torch.runtime.fragmenter import StackSplitExecutor

    def compare(chunk, keys, n, bc, what):
        got = X.exchange_chunk(chunk, keys, n, bc)
        lanes = X.exchange_cols(chunk)
        bufs, vbuf, ovf, cnt = X._exchange_torch(lanes, chunk.valid, keys, n, bc)
        rec, flag, counts = got
        for name, want in bufs.items():
            have = (rec.ops if name == "__ops__" else rec.nulls[name[8:]]
                    if name.startswith("__null__") else rec.columns[name])
            check(have.dtype == want.dtype and torch.equal(
                have.view(torch.uint8) if have.dtype != torch.bool else have,
                want.view(torch.uint8) if want.dtype != torch.bool else want),
                f"AI {what}: lane {name} bit for bit")
        check(torch.equal(rec.valid, vbuf), f"AI {what}: valid")
        check(torch.equal(counts, cnt) and torch.equal(flag, ovf), f"AI {what}: counts, flags")
        check(int(rec.valid.sum()) == int(torch.minimum(cnt, torch.tensor(bc, device=dev)).sum()),
              f"AI {what}: every routed row in its bucket")
        return got

    hop = lambda c: hop_step_fn(c, "date_time", Q5_WINDOW_MS, Q5_SLIDE_MS, "window_start")
    hopped = [hop(c) for c in chunks[0][:4]]
    key_of = lambda st: (st.col("auction"), st.col("window_start"))
    cases = []
    st4 = stack_chunks(hopped)
    bc4 = X.default_bucket_cap(st4.valid.shape[1], 4)
    cases.append(("q5 stacked 4x327680, 4 shards", st4, key_of(st4), 4, bc4))
    (st8,) = StackSplitExecutor(8).apply(hopped[0])
    bc8 = X.default_bucket_cap(st8.valid.shape[1], 8)
    cases.append(("q5 split 8 ways, 8 shards", st8, key_of(st8), 8, bc8))
    rng = np.random.default_rng(SEED + 38)
    n = AI_TYPE_ROWS
    for kd in ("int64", "int32", "float64", "float32", "bool", "nullable int64"):
        per = []
        for s in range(4):
            if kd.startswith("float"):
                k = rng.standard_normal(n).astype(kd)
                k[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
                k[6] = (np.array(0x7FC00123, np.uint32).view(np.float32) if kd == "float32"
                        else np.array(0x7FF0000000000ABC, np.uint64).view(np.float64))
            elif kd == "bool":
                k = rng.random(n) < 0.5
            elif kd == "int32":
                k = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
            else:
                k = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
            rows = int(rng.integers(n // 2, n))
            cols = {"k": k[:rows], "v": rng.standard_normal(rows).astype(np.float32),
                    "w": rng.integers(0, 9, rows).astype(np.int32)}
            nulls = {"v": rng.random(rows) < 0.2}
            if kd.startswith("nullable"):
                nulls["k"] = rng.random(rows) < 0.25
            ops = rng.integers(0, 4, rows).astype(np.int32)
            per.append(StreamChunk.from_numpy(cols, n, ops=ops, nulls=nulls, device=dev))
        st = stack_chunks(per)
        keys = _stacked_key_lanes(st, ("k",), (kd.startswith("nullable"),))
        cases.append((f"{kd} key", st, keys, 4, X.default_bucket_cap(n, 4)))
    skew = stack_chunks([StreamChunk.from_numpy(
        {"k": np.full(n, 777, np.int64), "v": np.arange(n, dtype=np.int64)}, n, device=dev)
        for _ in range(4)])
    cases.append(("skewed past the bucket", skew, (skew.col("k"),), 4, AI_SKEW_BUCKET))
    cases += ai_hard_cases(torch, dev, np.random.default_rng(SEED + 39))
    shapes = {}
    for what, st, keys, n_sh, bc in cases:
        rec, flag, counts = compare(st, keys, n_sh, bc, what)
        if what.startswith("skewed"):
            d = int(X._dest_shard_torch((skew.col("k")[:1, :1],), n_sh)[0, 0])
            check(bool(flag.all()), "AI skewed: every source's flag set")
            check(int(rec.valid[d].sum()) == n_sh * bc and int(rec.valid.sum()) == n_sh * bc,
                  "AI skewed: the destination's buckets full, nothing past them")
        if what == "a bucket exactly full":
            check(not bool(flag.any()) and int(counts.max()) == bc,
                  "AI: a bucket exactly full sets no flag")
        shapes[what] = {"shards": n_sh, "rows": list(st.valid.shape), "bucket_cap": bc,
                        "routed": int(counts.sum()), "received": int(rec.valid.sum())}
    timed = {}
    for what, st, keys, n_sh, bc in cases[:2]:
        out = X.exchange_chunk(st, keys, n_sh, bc)
        lanes = X.exchange_cols(st)
        ms = time_ms(torch, lambda: X.exchange_chunk(st, keys, n_sh, bc), 20)
        plain = time_ms(torch, lambda: X._exchange_torch(lanes, st.valid, keys, n_sh, bc), 3)
        dest = X._dest_shard_torch(keys, n_sh).reshape(-1)
        lib = time_ms(torch, lambda: torch.sort(dest, stable=True), 20)
        timed[what] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bound_ms(ai_bytes(st, out, keys))}
    main = timed[cases[0][0]]
    return {
        "name": "AI exchange", "route": "cuda", "source": "risingwave_tpu_torch/csrc/exchange.cu",
        "replaces": "risingwave_tpu/parallel/exchange.py:111", "max_abs_err": 0.0,
        "bound_by": "bytes", **main,
        "library_call": "torch.sort(stable=True) of the destination lane (a point: no single "
                        "PyTorch call exchanges rows)",
        "shape": {"cases": shapes, "timed": timed},
    }


def accumulate_exchange(ex, method: str = "apply"):
    """Keep the routing counts of every exchange an executor runs (a list
    append after each call of ``method``, the counts tensor the path made
    anyway); ``routed_counts`` sums them after the run."""
    seen = []
    fn = getattr(ex, method)

    def counted(*args):
        out = fn(*args)
        seen.append(ex.ex_counts_last)
        return out

    setattr(ex, method, counted)
    return seen


def routed_counts(torch, seen):
    """The (n, n) routed rows summed over the exchanges ``seen``."""
    return torch.stack(seen).to(torch.int64).sum(0)


def sharded_of(mv, cls):
    return [e for e in mv.pipeline.executors if isinstance(e, cls)]


def run_sharded(torch, mv, epochs_data, push, after=None):
    """Drive a sharded plan (``push(pipeline, epoch)``, a barrier, the card
    drained), timed; ``after(e)`` runs after barrier ``e``, untimed, and
    its launches are not the path's. Returns barrier ms, run seconds,
    launches, peak bytes and, per barrier, the flush rounds of its
    sharded aggs."""
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.parallel import ShardedHashAgg

    aggs = sharded_of(mv, ShardedHashAgg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    other = Counter()
    barrier_ms, rounds, run_s = [], [], 0.0
    for e, ep in enumerate(epochs_data):
        t0 = time.perf_counter()
        push(mv.pipeline, ep)
        tb = time.perf_counter()
        mv.pipeline.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        barrier_ms.append((t1 - tb) * 1e3)
        run_s += t1 - t0
        rounds.append([a.flush_rounds_last for a in aggs])
        if after is not None:
            before = dict(_kernels.LAUNCHES)
            after(e)
            other.update({k: v - before[k] for k, v in _kernels.LAUNCHES.items()})
    launches = {k: v - other[k] for k, v in _kernels.LAUNCHES.items()}
    return barrier_ms, run_s, launches, torch.cuda.max_memory_allocated(), rounds


def sharded_row(phase, key, mv, n, barrier_ms, run_s, rows_in, launches, peak, rounds,
                received, **extra):
    per_barrier = len(barrier_ms)
    return {
        "phase": phase, "path": key, "shards": n,
        "plan": [type(e).__name__ for e in mv.pipeline.executors],
        "rows_per_s": rows_in / run_s, "run_s": run_s,
        "barrier_ms_p50": float(np.percentile(barrier_ms, 50)),
        "barrier_ms_p99": float(np.percentile(barrier_ms, 99)), "barrier_ms": barrier_ms,
        "max_memory_allocated": int(peak), "ai_launches": launches["exchange"],
        "launches_per_barrier": sum(launches.values()) / per_barrier,
        "flush_rounds_per_barrier": rounds, "received_rows_per_shard": received,
        "launches": launches, **extra,
    }


def q5_sharded_paths(torch, dev, chunks, oracle, q5_rows):
    """Phase 38: q5 from SQL through ``sharded_planned_mv`` (bench.py's
    planner capacity, as phase 35) over phase 4's chunks at 4 and 8
    shards: the MV against the oracle and phase 4's MV, every shard owning
    groups, the shards' groups summing to the MV's rows, the exchange's
    routed rows summing to the valid hopped rows, no latch set."""
    import gc

    from risingwave_tpu_torch.parallel import ShardedHashAgg, ShardedMaterialize
    from risingwave_tpu_torch.runtime.fragmenter import sharded_planned_mv

    cap = state_cap(2 * EVENTS_PER_EPOCH, 1 << 16)
    factory = sql_factory(dev, ("bid",), cap)
    n_bids = sum(int(c.valid.sum()) for ep in chunks for c in ep)
    want = sort_rows(np.stack(oracle, 1))
    check(np.array_equal(q5_rows, want), "phase 38: phase 4's MV = the oracle")

    def push(pipeline, ep):
        for c in ep:
            pipeline.push(c)

    rows, launches = [], {}
    for n in SHARDS:
        key = f"q5_sharded_{n}"
        mv = sharded_planned_mv(factory, Q5_SQL, n)
        try:
            (agg,) = sharded_of(mv, ShardedHashAgg)
            (smv,) = sharded_of(mv, ShardedMaterialize)
            check(mv.mview is smv and agg.stacked_out, f"{key}: the MV sharded, the agg's flush "
                                                       "stacked into it")
            routed = accumulate_exchange(agg)
            barrier_ms, run_s, got_l, peak, rounds = run_sharded(torch, mv, chunks, push)
            got = mv_table_rows(mv.mview, P25_NAMES)
            check(np.array_equal(got, want), f"{key}: MV ({len(got)} rows) = the oracle and "
                                             "phase 4's MV")
            groups = agg.table.live.sum(1).tolist()
            check(all(g > 0 for g in groups) and sum(groups) == len(got),
                  f"{key}: every shard owns groups, their sum the MV's rows: {groups}")
            check(sum(smv.shard_rows()) == len(got), f"{key}: the MV's shards sum to its rows")
            counts = routed_counts(torch, routed)
            check(int(counts.sum()) == 5 * n_bids, f"{key}: routed rows {int(counts.sum())} = "
                                                   f"the valid hopped rows {5 * n_bids}")
            check(not bool(agg.dropped.any() | smv.state.dropped.any()), f"{key}: no latch set")
            check(got_l["exchange"] >= len([c for ep in chunks for c in ep]),
                  f"{key}: AI once a chunk at least")
            for name in SHARD_Q5_KERNELS:
                check(got_l[name] > 0, f"{key}: kernel {name} launched")
            launches[key] = got_l
            rows.append(sharded_row(
                "38", key, mv, n, barrier_ms, run_s, n_bids, got_l, peak, rounds,
                counts.sum(0).tolist(), planner_capacity=cap, bids=n_bids,
                groups=int(len(got)), groups_per_shard=groups, mv_rows_per_shard=smv.shard_rows(),
                agg_capacity=agg.capacity, mv_capacity=smv.capacity,
                oracle="numpy q5 oracle and phase 4's MV: equal"))
        finally:
            mv.pipeline.close()
        del mv, agg, smv
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


def q8_sharded_paths(torch, dev, host, chunks, oracle, rows7):
    """Phase 39: q8 from SQL sharded at SHARD_KILL[0] over phase 7's
    events. Run B, alone on the card, goes uninterrupted over all of them
    (timed; its MV against the q8 actor and phase 7's MV at the end, its
    MV digest kept at every barrier). Then run A goes over the first
    KILL_EPOCHS, committing into a LocalFsObjectStore after every
    barrier, is killed after barrier KILL_AT, recovered into a fresh plan
    at SHARD_KILL[1] shards (every restored row routed by vnode, kernel
    AH) and continued: its MV digest equals B's at every barrier, its
    rows the q8 actor's over those epochs."""
    import gc
    import shutil
    import tempfile

    from risingwave_tpu_torch import _kernels, integrity
    from risingwave_tpu_torch.parallel import ShardedHashJoin, ShardedMaterialize
    from risingwave_tpu_torch.queries.nexmark_q import Q8_WINDOW_MS
    from risingwave_tpu_torch.runtime.fragmenter import sharded_planned_mv
    from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore

    factory = sql_factory(dev, ("person", "auction"), SHARD_Q8_CAP)
    n_run, n_rec = SHARD_KILL
    check(np.array_equal(rows7, oracle), "phase 39: phase 7's MV = the q8 actor")
    want10 = oracle_rows(cpu_actor_q8(host[:KILL_EPOCHS], Q8_WINDOW_MS))

    def push(pipeline, ep):
        pipeline.push_left(ep[0])
        pipeline.push_right(ep[1])

    def digest(mv):
        return integrity.digest_from_scalar(integrity.device_digest(*mv.mview.digest_lanes()))

    store_dir = tempfile.mkdtemp(prefix="rw_shard_ckpt_")
    a = b = None
    try:
        b = sharded_planned_mv(factory, Q8_SQL, n_run)
        (join_b,) = sharded_of(b, ShardedHashJoin)
        check(isinstance(b.mview, ShardedMaterialize), "q8 sharded: the MV sharded")
        routed = accumulate_exchange(join_b, "_apply")
        digests_b = []
        barrier_ms, run_s, got_l, peak, rounds = run_sharded(
            torch, b, chunks, push, after=lambda e: digests_b.append(digest(b)))
        for name in SHARD_Q8_KERNELS:
            check(got_l[name] > 0, f"q8 sharded: kernel {name} launched")
        got = q8_sql_rows(b.mview)
        check(got.shape == oracle.shape and np.array_equal(got, oracle),
              f"q8 sharded: B's MV ({len(got)} rows) = the q8 actor and phase 7's MV")
        join_capacity = join_b.left.row_valid.shape[1]
        received = routed_counts(torch, routed).sum(0).tolist()
        b.pipeline.close()
        del b, join_b, routed
        b = None
        gc.collect()
        torch.cuda.empty_cache()

        mgr = CheckpointManager(LocalFsObjectStore(store_dir))
        rec = {"stage_ms": [], "sst_ms": [], "commit_ms": [], "rows": [], "bytes": []}
        a = sharded_planned_mv(factory, Q8_SQL, n_run)
        for e in range(KILL_AT):
            push(a.pipeline, chunks[e])
            a.pipeline.barrier()
            timed_commit(torch, mgr, a.pipeline.epoch, a.pipeline.executors, rec)
        check(digest(a) == digests_b[KILL_AT - 1], "q8 sharded: A = B before the kill")
        pre = q8_sql_rows(a.mview)
        a.pipeline.close()
        del a
        a = None
        gc.collect()
        torch.cuda.empty_cache()
        a = sharded_planned_mv(factory, Q8_SQL, n_rec)
        before = _kernels.LAUNCHES["vnode_of"]
        rec_a2 = timed_recover(torch, store_dir, a)
        routed_restore = _kernels.LAUNCHES["vnode_of"] - before
        a.pipeline._epoch = rec_a2["epoch"]
        check(routed_restore > 0, "q8 sharded: the restore routed rows through AH's vnode_of")
        check(np.array_equal(q8_sql_rows(a.mview), pre), "q8 sharded: recovered MV = pre-kill")
        check(all(e.mesh.n_shards == n_rec for e in a.pipeline.executors if hasattr(e, "mesh")),
              f"q8 sharded: recovered at {n_rec} shards")
        for e in range(KILL_AT, KILL_EPOCHS):
            push(a.pipeline, chunks[e])
            a.pipeline.barrier()
            check(digest(a) == digests_b[e], f"q8 sharded barrier {e + 1}: recovered = B")
        got10 = q8_sql_rows(a.mview)
        check(np.array_equal(got10, want10), f"q8 sharded: the recovered MV ({len(got10)} rows) "
                                              f"= the q8 actor over {KILL_EPOCHS} epochs")
        rows_in = sum(len(p["id"]) + len(a_["seller"]) for p, a_ in host)
        pct = lambda xs, p: float(np.percentile(xs, p))  # noqa: E731
        # the row's plan names come from the recovered plan, which has B's executors
        row = sharded_row(
            "39", f"q8_sharded_{n_run}", a, n_run,
            barrier_ms, run_s, rows_in, got_l, peak, rounds, received,
            planner_capacity=SHARD_Q8_CAP, mv_rows=int(len(got)), join_capacity=join_capacity,
            peak_of="run B alone on the card (A and the recovered run come after it)",
            kill={"epochs": KILL_EPOCHS, "kill_after_barrier": KILL_AT,
                  "recovered_shards": n_rec, "vnode_of_launches": routed_restore,
                  "commit_ms_p50": pct(rec["commit_ms"], 50),
                  "commit_ms_p99": pct(rec["commit_ms"], 99),
                  "rows_staged": rec["rows"], "bytes_staged": rec["bytes"], **rec_a2},
            oracle="B: bench.py's cpu_actor_q8 (copied) and phase 7's MV; the recovered run: "
                   "B's MV digest at every barrier after the kill, the actor over its epochs")
        return [row], {f"q8_sharded_{n_run}": got_l}
    finally:
        for q in (a, b):
            if q is not None:
                q.pipeline.close()
        shutil.rmtree(store_dir, ignore_errors=True)


def q7_sharded_path(torch, dev, host, chunks):
    """Phase 40: q7 from SQL sharded at SHARD_KILL[0] (the MAX agg's flush
    stacked into the sharded join, a ShardedMaterialize tail, as the
    reference plans it) over phase 9's first Q7_SQL_CHUNKS chunks, the
    depth the plan holds (phase 37), against the q7 actor; the next chunk
    overflows the join side as the serial plan's does."""
    import gc

    from risingwave_tpu_torch.parallel import ShardedHashAgg, ShardedMaterialize
    from risingwave_tpu_torch.queries.nexmark_q import Q7_WINDOW_MS
    from risingwave_tpu_torch.runtime.fragmenter import sharded_planned_mv

    n = SHARD_KILL[0]
    factory = sql_factory(dev, ("bid",), SHARD_Q7_CAP)
    data = [[c] for c in chunks[0][:Q7_SQL_CHUNKS]]
    want = actor_rows(cpu_actor_q7(host[0][:Q7_SQL_CHUNKS], Q7_WINDOW_MS))
    rows_in = sum(len(c["auction"]) for c in host[0][:Q7_SQL_CHUNKS])

    def push(pipeline, ep):
        for c in ep:
            pipeline.push_left(c)
            pipeline.push_right(c)

    mv = sharded_planned_mv(factory, Q7_SQL, n)
    overflow = None
    try:
        (agg,) = sharded_of(mv, ShardedHashAgg)
        check(agg.stacked_out and isinstance(mv.mview, ShardedMaterialize),
              "q7 sharded: the MAX flush stacked into the join, the MV sharded")
        barrier_ms, run_s, got_l, peak, rounds = run_sharded(torch, mv, data, push)
        got = q7_mv_rows(mv.mview)
        check(len(want) and got.shape == want.shape and np.array_equal(got, want),
              f"q7 sharded: MV ({len(got)} rows) = the q7 actor")
        for name in SHARD_Q7_KERNELS:
            check(got_l[name] > 0, f"q7 sharded: kernel {name} launched")
        push(mv.pipeline, [chunks[0][Q7_SQL_CHUNKS]])
        try:
            mv.pipeline.barrier()
        except RuntimeError as e:
            overflow = repr(e.__cause__)
        check(overflow is not None and "overflowed" in overflow,
              "q7 sharded: the next chunk overflows the join side as the serial plan's")
    finally:
        mv.pipeline.close()
    row = sharded_row("40", f"q7_sharded_{n}", mv, n, barrier_ms, run_s, rows_in, got_l, peak,
                      rounds, None, planner_capacity=SHARD_Q7_CAP, chunks=Q7_SQL_CHUNKS,
                      mv_rows=int(len(got)), next_chunk=overflow,
                      oracle="bench.py's cpu_actor_q7 (copied) over these chunks: equal")
    del mv, agg
    gc.collect()
    torch.cuda.empty_cache()
    return [row], {f"q7_sharded_{n}": got_l}


def q19_sharded_path(torch, dev, chunks, want_digests):
    """Phase 41: a retractable GroupTopN sharded at SHARD_TOPN, composed
    as the reference's tests/test_sharded_top_n.py composes it (RowIdGen,
    StackSplit, ShardedGroupTopN by auction, q19's device MV on the
    diffs), over phase 21's chunks: the MV's kernel-H digest equals phase
    21's q19 MV at every barrier, and the oracle's rows at the end."""
    from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor
    from risingwave_tpu_torch.parallel import ShardedGroupTopN, make_mesh
    from risingwave_tpu_torch.queries.nexmark_q import BID_DTYPES, Q19_TOP, _q19_mview
    from risingwave_tpu_torch.runtime.fragmenter import StackSplitExecutor
    from risingwave_tpu_torch.runtime.pipeline import Pipeline

    n = SHARD_TOPN
    topn = ShardedGroupTopN(make_mesh(n, dev), ("auction",), "price", Q19_TOP, ("_row_id",),
                            BID_DTYPES, desc=True, capacity=Q19_CAP // n,
                            table_id="q19.gtopn")
    mview = _q19_mview(Q19_MV_CAP, "q19.mview", dev)
    pipe = Pipeline([RowIdGenExecutor(table_id="q19.rowid"), StackSplitExecutor(n), topn, mview])

    planned = types.SimpleNamespace(pipeline=pipe)  # run_sharded's view of a plan
    routed = accumulate_exchange(topn)
    ranked = []

    def push(p, ep):
        for c in ep:
            p.push(c)

    def after(e):
        ranked.append(topn.ranked_last)
        check(mv_digest(mview) == want_digests[e], f"q19 sharded barrier {e + 1}: MV digest = "
                                                   "phase 21's")

    barrier_ms, run_s, got_l, peak, rounds = run_sharded(torch, planned, chunks, push, after)
    host = q19_host(chunks)
    want = q19_rows(q19_top({c: np.concatenate([h[c] for h in host]) for c in Q19_COLS}))
    got = q19_rows(mview.to_numpy())
    check(np.array_equal(got, want), f"q19 sharded: MV ({len(got)} rows) = the oracle")
    for name in SHARD_TOPN_KERNELS:
        check(got_l[name] > 0, f"q19 sharded: kernel {name} launched")
    bids = sum(len(h["auction"]) for h in host)
    row = sharded_row("41", f"q19_sharded_{n}", planned, n, barrier_ms, run_s, bids, got_l, peak,
                      None, routed_counts(torch, routed).sum(0).tolist(),
                      store_capacity=topn.capacity,
                      shards_ranked_per_barrier=ranked, mv_rows=int(len(got)),
                      oracle="phase 21's q19 MV digest at every barrier; the numpy oracle at "
                             "the end")
    return [row], {f"q19_sharded_{n}": got_l}


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
    j_row = kernel_j(torch, dev, rng)
    emit({"phase": "kernel", **j_row})
    l_row, l_side = kernel_l(torch, dev, rng)
    emit({"phase": "kernel", **l_row})
    m_row = kernel_m(torch, dev, rng, l_side)
    emit({"phase": "kernel", **m_row})
    del l_side
    torch.cuda.empty_cache()
    lr_row = kernel_l_regrow(torch, dev, rng)
    emit({"phase": "kernel", **lr_row})
    torch.cuda.empty_cache()
    # q7's chunks (8,192 rows), and a 65,536-row chunk
    n_row = kernel_n(torch, dev, rng, Q7_CHUNK_EVENTS)
    big = kernel_n(torch, dev, rng, CHUNK_EVENTS)
    n_row["chunk_65536"] = {k: big[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                "max_abs_err", "shape")}
    emit({"phase": "kernel", **n_row})
    torch.cuda.empty_cache()
    o_rows = kernel_o(torch, dev, rng)
    for r in o_rows:
        emit({"phase": "kernel", **r})
    torch.cuda.empty_cache()
    p_row, q101_ids, q101_items = kernel_p(torch, dev, rng)
    emit({"phase": "kernel", **p_row})
    torch.cuda.empty_cache()
    mo_row, li_row = kernel_m_outer_l_init(torch, dev, rng, q101_ids, q101_items)
    emit({"phase": "kernel", **mo_row})
    emit({"phase": "kernel", **li_row})
    del q101_ids, q101_items
    torch.cuda.empty_cache()
    emit(join_types_on_card(torch, dev, rng))
    torch.cuda.empty_cache()
    qa_row, qd_row, qe_row, lookup_row = kernel_q(torch, dev, rng)
    for r in (qa_row, qd_row, qe_row, lookup_row):
        emit({"phase": "kernel", **r})
    torch.cuda.empty_cache()
    r_rows = kernel_r(torch, dev)
    for r in r_rows:
        emit({"phase": "kernel", **r})
    torch.cuda.empty_cache()
    ag_rows = kernel_ag(torch, dev)
    for r in ag_rows:
        emit({"phase": "kernel", **r})
    torch.cuda.empty_cache()
    s_proj_row, s_filt_row = kernel_s(torch, dev, rng)
    emit({"phase": "kernel", **s_proj_row})
    emit({"phase": "kernel", **s_filt_row})
    t_row = kernel_t(torch, dev, rng)
    emit({"phase": "kernel", **t_row})
    torch.cuda.empty_cache()

    q5_row, l4, (chunks, cap, interp_q5, oracle) = main_path(torch, dev, EPOCHS)
    emit(q5_row)
    if args.profile:
        emit(profile_q5(torch, dev, chunks, cap, args.profile, fused=False))
    torch.cuda.empty_cache()
    fused_row, l6 = fused_path(torch, dev, chunks, cap, interp_q5, oracle)
    emit(fused_row)
    q5_rows = mv_table_rows(interp_q5.mview, P25_NAMES)
    del interp_q5
    torch.cuda.empty_cache()
    # phase 3's AH and phase 35 (q5 from SQL through the actor graph) on phase 4's stream
    ah_rows = kernel_ah(torch, dev, chunks[0][0])
    for r in ah_rows:
        emit({"phase": "kernel", **r})
    rows35, l35 = q5_graph_paths(torch, dev, chunks, oracle, q5_rows)
    for r in rows35:
        emit(r)
    torch.cuda.empty_cache()
    # phase 3's AI and phase 38 (q5 from SQL on the mesh) on phase 4's stream
    ai_row = kernel_ai(torch, dev, chunks)
    emit({"phase": "kernel", **ai_row})
    torch.cuda.empty_cache()
    rows38, l38 = q5_sharded_paths(torch, dev, chunks, oracle, q5_rows)
    for r in rows38:
        emit(r)
    torch.cuda.empty_cache()
    # phases 25 and 26 take phase 4's stream too
    rows25, l25 = p25_paths(torch, dev, chunks, cap, q5_rows)
    for r in rows25:
        emit(r)
    del q5_rows
    torch.cuda.empty_cache()
    rows26, l26 = p26_paths(torch, dev, chunks)
    for r in rows26:
        emit(r)
    if args.profile:
        torch.cuda.empty_cache()
        emit(profile_q5(torch, dev, chunks, cap, args.profile, fused=True))
    torch.cuda.empty_cache()

    # phases 13 and 14 take phase 4's stream while it is on the card
    q5m_row13, l13, q5m_interp = q5_max_path(torch, dev, chunks, cap, oracle)
    emit(q5m_row13)
    if args.profile:
        emit(profile_q5_max(torch, dev, chunks, q5m_interp[0], cap, args.profile, fused=False))
        torch.cuda.empty_cache()
    q5m_row14, l14 = q5_max_fused_path(torch, dev, chunks, cap, q5m_interp)
    emit(q5m_row14)
    if args.profile:
        torch.cuda.empty_cache()
        emit(profile_q5_max(torch, dev, chunks, q5m_interp[0], cap, args.profile, fused=True))
    del q5m_interp
    torch.cuda.empty_cache()
    (k5_row, l16_q5), q5_oracle10 = kill_q5(torch, dev, chunks, cap)
    emit(k5_row)
    torch.cuda.empty_cache()
    k5g_row, l16_q5g = kill_q5_graph(torch, dev, chunks, q5_oracle10)
    emit(k5g_row)
    k5m_row, l16_q5m = kill_q5_max(torch, dev, chunks, cap, q5_oracle10)
    emit(k5m_row)
    torch.cuda.empty_cache()
    # phases 32 and 34 (the cold tier; 32's kill is phase 16's) on phase 4's stream
    q5_oracle_cold = q5_epochs_oracle(chunks[:COLD_EPOCHS])
    rows32, l32 = q5_cold(torch, dev, chunks, cap, q5_oracle_cold)
    for r in rows32:
        emit(r)
    torch.cuda.empty_cache()
    rows34, l34 = q5_max_cold(torch, dev, chunks, cap, q5_oracle_cold)
    del q5_oracle_cold
    for r in rows34:
        emit(r)
    torch.cuda.empty_cache()
    k25_row, l16_p25 = kill_p25(torch, dev, chunks, cap, q5_oracle10)
    emit(k25_row)
    torch.cuda.empty_cache()
    k26_row, l16_p26 = kill_p26(torch, dev, chunks)
    emit(k26_row)
    torch.cuda.empty_cache()
    # phases 17 and 18 take phase 4's stream too
    rows17, l17 = q1_q2_paths(torch, dev, chunks)
    for r in rows17:
        emit(r)
    torch.cuda.empty_cache()
    rows18, l18 = hot_paths(torch, dev, chunks)
    for r in rows18:
        emit(r)
    torch.cuda.empty_cache()
    # phase 3's U, V and X, phases 21-22 and phase 16's q19 on phase 4's stream
    u_row = kernel_u(torch, dev, chunks)
    emit({"phase": "kernel", **u_row})
    torch.cuda.empty_cache()
    v19_row, x_row = kernel_vx(torch, dev, rng, chunks)
    emit({"phase": "kernel", **v19_row})
    emit({"phase": "kernel", **x_row})
    torch.cuda.empty_cache()
    rows21, l21, q19_digests = q19_paths(torch, dev, chunks[:Q19_EPOCHS])
    for r in rows21:
        emit(r)
    torch.cuda.empty_cache()
    rows41, l41 = q19_sharded_path(torch, dev, chunks[:Q19_EPOCHS], q19_digests)
    for r in rows41:
        emit(r)
    del q19_digests
    torch.cuda.empty_cache()
    k19_row, l16_q19 = kill_q19(torch, dev, chunks)
    emit(k19_row)
    torch.cuda.empty_cache()
    # phases 29-31, phase 3's AC-AF and phase 16's window kills on phase 4's stream
    wms = epoch_watermarks(chunks)
    host4 = bid_host_rows(chunks)
    runs29, rows29, l29 = window_paths(torch, dev, "p29", chunks, wms, p29_oracle(host4, wms[-1]))
    for r in rows29:
        emit(r)
    del runs29
    torch.cuda.empty_cache()
    ac_rows, (ac_arena, ac_emission) = kernel_ac(torch, dev, chunks[0])
    for r in ac_rows:
        emit({"phase": "kernel", **r})
    ad_row = kernel_ad(torch, dev, ac_emission)
    emit({"phase": "kernel", **ad_row})
    del ac_arena, ac_emission
    torch.cuda.empty_cache()
    runs30, rows30, l30 = window_paths(torch, dev, "p30", chunks, wms, p30_oracle(host4, wms[-1]))
    for r in rows30:
        emit(r)
    del runs30, host4
    torch.cuda.empty_cache()
    ae_row = kernel_ae_eowc(torch, dev, chunks[0])
    emit({"phase": "kernel", **ae_row})
    torch.cuda.empty_cache()
    runs31, rows31, l31 = window_paths(torch, dev, "p31", chunks, wms, p31_oracle(oracle))
    for r in rows31:
        emit(r)
    del runs31["p31_fused"]
    torch.cuda.empty_cache()
    ae_gen_row, ap_row, df_row = kernel_ae_af(torch, dev, rng, runs31["p31"].over)
    for r in (ae_gen_row, ap_row, df_row):
        emit({"phase": "kernel", **r})
    del runs31
    torch.cuda.empty_cache()
    l16_win = {}
    for key in ("p29", "p30", "p31"):
        k_row, l16_win[f"{key}_recover"] = kill_window(torch, dev, key, chunks, wms)
        emit(k_row)
        torch.cuda.empty_cache()
    aa_bid = chunks[0][0]  # kernel AA's bid chunk, phase 4's first
    del chunks
    torch.cuda.empty_cache()

    q8_row7, l7, (host, q8_chunks, caps, interp_q8, q8_oracle) = q8_path(torch, dev, EPOCHS)
    emit(q8_row7)
    if args.profile:
        emit(profile_q8(torch, dev, q8_chunks, args.profile, fused=False))
        torch.cuda.empty_cache()
    q8_row8, l8, fused_q8 = q8_fused_path(torch, dev, host, q8_chunks, caps, interp_q8, q8_oracle)
    emit(q8_row8)
    q8_rows7 = q8_mv_rows(interp_q8.mview)
    del interp_q8
    torch.cuda.empty_cache()
    hj_row = kernel_h_join(torch, dev, fused_q8.join)
    emit({"phase": "kernel", **hj_row})
    del fused_q8
    torch.cuda.empty_cache()
    rows36, l36 = q8_graph_paths(torch, dev, host, q8_chunks, q8_oracle, q8_rows7)
    for r in rows36:
        emit(r)
    torch.cuda.empty_cache()
    rows39, l39 = q8_sharded_paths(torch, dev, host, q8_chunks, q8_oracle, q8_rows7)
    for r in rows39:
        emit(r)
    del q8_rows7
    if args.profile:
        torch.cuda.empty_cache()
        emit(profile_q8(torch, dev, q8_chunks, args.profile, fused=True))
    k8_row, l16_q8 = kill_q8(torch, dev, host, q8_chunks)
    emit(k8_row)
    torch.cuda.empty_cache()
    rows33, l33 = q8_cold(torch, dev, host, q8_chunks)  # phase 33, with phase 16's kill
    for r in rows33:
        emit(r)
    del q8_chunks, host
    torch.cuda.empty_cache()

    q7_row9, l9, (q7_host, q7_chunks, interp_q7, interp_rec, q7_oracle) = q7_path(torch, dev,
                                                                                 EPOCHS)
    emit(q7_row9)
    if args.profile:
        emit(profile_q7(torch, dev, q7_host, q7_chunks, args.profile, fused=False))
        torch.cuda.empty_cache()
    q7_row10, l10, fused_q7 = q7_fused_path(torch, dev, q7_host, q7_chunks,
                                            (interp_q7, interp_rec), q7_oracle)
    emit(q7_row10)
    del interp_q7, fused_q7
    if args.profile:
        torch.cuda.empty_cache()
        emit(profile_q7(torch, dev, q7_host, q7_chunks, args.profile, fused=True))
    k7_row, l16_q7 = kill_q7(torch, dev, q7_host, q7_chunks)
    emit(k7_row)
    torch.cuda.empty_cache()
    row20, l20 = q7_scan_path(torch, dev, q7_host, q7_chunks)
    emit(row20)
    torch.cuda.empty_cache()
    rows37, l37 = q7_graph_paths(torch, dev, q7_host, q7_chunks)
    for r in rows37:
        emit(r)
    torch.cuda.empty_cache()
    rows40, l40 = q7_sharded_path(torch, dev, q7_host, q7_chunks)
    for r in rows40:
        emit(r)
    del q7_host, q7_chunks, interp_rec
    torch.cuda.empty_cache()

    q101_row11, l11, (h101, c101, interp_q101, rec101, oracle101) = q101_path(torch, dev, EPOCHS)
    emit(q101_row11)
    if args.profile:
        emit(profile_q101(torch, dev, c101, args.profile, fused=False))
        torch.cuda.empty_cache()
    q101_row12, l12, fused_q101 = q101_fused_path(torch, dev, h101, c101, (interp_q101, rec101),
                                                  oracle101)
    emit(q101_row12)
    del interp_q101, fused_q101
    if args.profile:
        torch.cuda.empty_cache()
        emit(profile_q101(torch, dev, c101, args.profile, fused=True))
    torch.cuda.empty_cache()
    q101_mi_row, l15 = q101_minput_path(torch, dev, h101, c101)
    emit(q101_mi_row)
    k101_row, l16_q101 = kill_q101(torch, dev, h101, c101)
    emit(k101_row)
    torch.cuda.empty_cache()
    rows19, l19 = q103_paths(torch, dev, h101, c101)
    for r in rows19:
        emit(r)
    torch.cuda.empty_cache()
    # phase 3's V and W, phase 23 and phase 16's q105 on phase 11's stream
    v105_row, w_row = kernel_vw(torch, dev, rng)
    emit({"phase": "kernel", **v105_row})
    emit({"phase": "kernel", **w_row})
    torch.cuda.empty_cache()
    rows23, l23 = q105_paths(torch, dev, h101, c101)
    for r in rows23:
        emit(r)
    k105_row, l16_q105 = kill_q105(torch, dev, h101, c101)
    emit(k105_row)
    torch.cuda.empty_cache()
    # phase 3's Y and Z, phase 24 and phase 16's q102 on phase 11's stream
    y_row = kernel_y(torch, dev, rng)
    emit({"phase": "kernel", **y_row})
    zl_row, zd_row = kernel_z(torch, dev, rng)
    emit({"phase": "kernel", **zl_row})
    emit({"phase": "kernel", **zd_row})
    torch.cuda.empty_cache()
    rows24, l24 = q102_paths(torch, dev, h101, c101)
    for r in rows24:
        emit(r)
    torch.cuda.empty_cache()
    k102_row, l16_q102 = kill_q102(torch, dev, h101, c101)
    emit(k102_row)
    torch.cuda.empty_cache()
    # phases 27 and 28, phase 3's AA and AB and phase 16's p28 on phase 11's stream
    tagged = tag_chunks(torch, dev, h101)
    rows27, l27 = p27_paths(torch, dev, tagged)
    for r in rows27:
        emit(r)
    torch.cuda.empty_cache()
    a_chunks = auction_chunks(torch, dev, h101)
    rows28, l28, p28_mv = p28_paths(torch, dev, h101, c101, a_chunks)
    for r in rows28:
        emit(r)
    aa_rows = kernel_aa(torch, dev, rng, aa_bid, tagged[0][1])
    for r in aa_rows:
        emit({"phase": "kernel", **r})
    ab_row = kernel_ab(torch, dev, rng, p28_mv, c101[0][1][0])
    emit({"phase": "kernel", **ab_row})
    del tagged, p28_mv, aa_bid
    torch.cuda.empty_cache()
    k28_row, l16_p28 = kill_p28(torch, dev, h101, c101, a_chunks)
    emit(k28_row)
    emit(p28_host_path(torch, dev, h101, c101, a_chunks))
    del h101, c101, a_chunks
    torch.cuda.empty_cache()
    emit(generators_on_card(torch, dev))

    rows = [(a_row, "lookup_or_insert"), (b_row, "agg_apply"), (c_row, "agg_flush"),
            (d_row, "mv_upsert"), (e_row, "hop_expand"), (f_row, "reduce_by_key"),
            (g_row, "apply_reduced"), (h_row, "state_digest"), (hj_row, "state_digest"),
            (i_row, "slot_move"), (j_row, "dedup_emit"), (l_row, "join_apply"),
            (lr_row, "join_regrow"), (m_row, "join_probe"), (n_row, "dyn_filter"),
            (o_rows[0], "expire"), (o_rows[1], "expire_join"), (o_rows[2], "expire_agg"),
            (p_row, "join_degree"), (mo_row, "join_probe"), (li_row, "join_apply"),
            (qa_row, "minput"), (qd_row, "minput_clear"), (qe_row, "minput_rescatter"),
            (lookup_row, "lookup")] + list(zip(r_rows, R_ENTRIES)) + [
            (s_proj_row, "expr_eval"), (s_filt_row, "expr_filter"), (t_row, "wm_filter"),
            (u_row, "topn_band"), (v19_row, "topn_upsert"), (v105_row, "topn_upsert"),
            (w_row, "topn_rank"), (x_row, "group_topk"), (y_row, "simple_agg"),
            (zl_row, "dyn_general"), (zd_row, "dyn_rv_diff")] + list(zip(
                aa_rows, ("unnest", "series", "expand"))) + [(ab_row, "temporal_probe")] + [
            (ac_rows[0], "arena"), (ac_rows[1], "arena_emit"), (ad_row, "over_step"),
            (ae_row, "window_calls"), (ae_gen_row, "window_order"), (ap_row, "over_apply"),
            (df_row, "over_diff")] + list(zip(ag_rows, ("cold_select", "cold_merge",
                                                         "scatter_rows"))) + list(zip(
                ah_rows, ("vnode_dispatch", "vnode_of"))) + [(ai_row, "exchange")]
    paths = {"q5": l4, "q5_fused": l6, "q8": l7, "q8_fused": l8, "q7": l9, "q7_fused": l10,
             "q101": l11, "q101_fused": l12, "q5_max": l13, "q5_max_fused": l14, **l15,
             "q5_recover": l16_q5, "q5_max_recover": l16_q5m, "q8_recover": l16_q8,
             "q7_recover": l16_q7, "q101_recover": l16_q101, **l17,
             **{f"hot_{k}": v for k, v in l18.items()}, **l19, "q7_scan_watermark_filters": l20,
             **l21, "q19_recover": l16_q19, **l23, "q105_recover": l16_q105, **l24,
             "q102_recover": l16_q102, **l25, **l26, **l27, **l28, "p25_recover": l16_p25,
             "p26_recover": l16_p26, "p28_recover": l16_p28, **l29, **l30, **l31, **l16_win,
             **l32, **l33, **l34, **l35, "q5_sql_graph_recover": l16_q5g, **l36, **l37,
             **l38, **l39, **l40, **l41}
    for row, key in rows:
        # each main path's run counts from zero: phases 4, 6-41 (a path
        # of a phase that drives several in lockstep counts its own calls)
        row["launches_by_path"] = {p: counts[key] for p, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    keep = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path")
    emit({"kernels": [{k: r[k] for k in keep} for r, _ in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
