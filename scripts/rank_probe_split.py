"""Time kernels W (top-n rank) and M (join probe + pairs) on the card,
split by launch, and run the paths that call them; for comparing two
trees of the repo on one card.

Usage (on a machine with one CUDA card):

    python scripts/rank_probe_split.py [--root TREE] [--reps 20] [--paths]

``--root`` is the checkout whose ``risingwave_tpu_torch`` and
``chip_smoke.py`` are imported (default: this repo), so a second tree
unpacked beside it (``git archive``) can be timed in the same call.

Split mode (always), at ``chip_smoke.py``'s phase-3 shapes:

- W: ``chip_smoke.kernel_vw``'s store, q105's 2^22 slots holding 1.2M
  live auctions whose counts tie 5,000 rows at the 1,000th place, 200
  dead rows of the largest counts; ``rank_top(n=1,000, DESC)``;
- M: ``chip_smoke.kernel_m``'s chunk, 65,536 auction rows (about 9,000
  hits) probing a (2^23, 8) person side of 400,000 keys into a 2^14-row
  output (q8's join);
- M+: ``chip_smoke.kernel_m_outer_l_init``'s, a 65,536-row auction chunk
  (half with a stored max bid) probing a (2^22, 4) side of 1.2M
  auctions' max bids, pairs then NULL-padded rows (q101's left arrival).

Each gives ``ms`` (CUDA events around each call, the mean), ``wall_ms``
(the host clock around a call and a synchronise), ``enqueue_ms`` (the
host clock a call, calls issued back to back), ``device_ms`` (the
device spans ``torch.profiler`` records, a call: kernels, memsets and
copies) split ``by_kernel`` as [ms a call, launches a call], and
``host_gap_ms`` = ``ms`` - ``device_ms``: what the card waits on the host.

``--paths``: then phases 7 and 8 (q8), 9 and 10 (q7), 11 and 12 (q101),
23 (q105 both ways) and phase 16's q105 kill, as ``chip_smoke.py``
runs them over 20 epochs, their rows printed.

Prints one JSON object per line; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def spans(torch, fn, reps: int) -> dict:
    """Device ms a call of ``fn`` by kernel name (and in all), from the
    device events ``torch.profiler`` records over ``reps`` calls after a
    warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = defaultdict(float)
    count = defaultdict(int)
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.name.split("(")[0].replace("void ", "")
        by[name] += ev.time_range.elapsed_us() / 1e3 / reps
        count[name] += 1
    return {"device_ms": sum(by.values()),
            "by_kernel": {k: [by[k], count[k] / reps] for k in sorted(by, key=by.get,
                                                                      reverse=True)}}


def timed(torch, cs, fn, reps: int) -> dict:
    """``ms``, ``wall_ms``, ``enqueue_ms`` (the host's time a call, calls
    issued back to back without a synchronise), the profiler's split and
    the host's gap."""
    ms = cs.time_ms(torch, fn, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    sp = spans(torch, fn, 3)
    return {"ms": ms, "wall_ms": wall, "enqueue_ms": enqueue, **sp,
            "host_gap_ms": ms - sp["device_ms"]}


def w_store(torch, dev, cs, rng):
    """``chip_smoke.kernel_vw``'s TopN store before its V chunk."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.executors import top_n_plain as tp
    from risingwave_tpu_torch.types import Op

    i64 = torch.int64
    dtypes = {"id": i64, "item_name": torch.int32, "auction": i64, "bid_count": i64}
    topn = tp.TopNExecutor("bid_count", 1000, ("id", "auction"), dtypes, desc=True,
                           capacity=cs.Q105_CAP, device=dev)
    ids = 1000 + np.arange(cs.W_LIVE, dtype=np.int64)
    counts = rng.integers(1, 60, cs.W_LIVE)
    counts[rng.permutation(cs.W_LIVE)[:cs.W_TIED]] = 60
    counts[rng.permutation(cs.W_LIVE)[:400]] = 1000 + rng.permutation(100_000)[:400]
    cols = {"id": ids, "item_name": rng.integers(0, 100, cs.W_LIVE).astype(np.int32),
            "auction": ids, "bid_count": counts}
    for at in range(0, cs.W_LIVE, cs.CHUNK_EVENTS):
        topn.apply(StreamChunk.from_numpy({c: v[at:at + cs.CHUNK_EVENTS] for c, v in cols.items()},
                                          cs.CHUNK_EVENTS, device=dev))
    dead = {"id": 10**9 + np.arange(200), "item_name": np.zeros(200, np.int32),
            "auction": 10**9 + np.arange(200), "bid_count": np.full(200, 2**62)}
    for op in (Op.INSERT, Op.DELETE):
        topn.apply(StreamChunk.from_numpy(dead, 256, ops=np.full(200, int(op), np.int32),
                                          device=dev))
    torch.cuda.synchronize()
    return topn


def split_w(torch, dev, cs, rng, reps: int) -> dict:
    from risingwave_tpu_torch.executors import top_n_plain as tp

    topn = w_store(torch, dev, cs, rng)
    lane = topn.rows["bid_count"]
    got = tp.rank_top(topn.table, lane, 1000, True)
    want = tp._rank_top_torch(topn.table, lane, 1000, True)
    torch.cuda.synchronize()
    same = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    row = timed(torch, cs, lambda: tp.rank_top(topn.table, lane, 1000, True), reps)
    nth = int(lane[got[0][-1].long()])
    tied = int((topn.table.live & (lane == nth)).sum())
    return {**row, "equal_to_plain": same,
            "shape": {"capacity": topn.table.capacity, "live": int(topn.table.live.sum()),
                      "n": 1000, "tied_at_nth": tied}}


def split_m(torch, dev, cs, rng, reps: int) -> dict:
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops import join as jn

    side, _, _, _ = cs.q8_left_side(torch, dev, rng, cs.Q8_CAP, 400_000)
    n = cs.A_ROWS
    live_slots = torch.nonzero(side.table.live).flatten()
    pick = live_slots[torch.from_numpy(rng.integers(0, len(live_slots), 9_000)).to(dev)]
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
    em, rows = z(torch.bool), z(torch.int64)
    run = lambda: jn.probe_pairs(side, key_cols, chunk.valid, chunk.ops, own, {}, out_names,
                                 cs.Q8_OUT_CAP, em, rows, ())
    got = run()
    want = jn._probe_pairs_torch(side, key_cols, chunk.valid, chunk.ops, own, {}, out_names, (),
                                 cs.Q8_OUT_CAP, z(torch.bool), z(torch.int64))
    torch.cuda.synchronize()
    same = all(torch.equal(got.cols[k], want.cols[k]) for k in out_names) and all(
        torch.equal(getattr(got, f), getattr(want, f)) for f in ("ops", "valid", "slots", "mc",
                                                                 "written"))
    return {**timed(torch, cs, run, reps), "equal_to_plain": same,
            "shape": {"probe_rows": n, "capacity": side.capacity, "fanout": side.fanout,
                      "written": int(got.written), "out_cap": cs.Q8_OUT_CAP}}


def split_m_outer(torch, dev, cs, rng, reps: int) -> dict:
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops import join as jn

    ids = rng.permutation(1_200_000).astype(np.int64) + 1000
    with_bid = ids[rng.random(len(ids)) < 0.9]
    right = cs.q101_side(torch, dev, ("auction", "max_price"),
                         {"auction": torch.int64, "max_price": torch.int64}, with_bid,
                         {"auction": with_bid,
                          "max_price": rng.integers(1, 10**6, len(with_bid)).astype(np.int64)},
                         nullable=("max_price",))
    n = cs.A_ROWS
    half = n // 2
    c_ids = np.concatenate([rng.choice(with_bid, half, replace=False),
                            np.arange(n - 16 - half, dtype=np.int64) + 10**9])
    c_items = rng.integers(0, 100_000, len(c_ids)).astype(np.int32)
    chunk = StreamChunk.from_numpy({"id": c_ids, "item_name": c_items}, n, device=dev)
    own = {k: chunk.col(k) for k in ("id", "item_name")}
    out_names = ("id", "item_name", "auction", "max_price")
    null_names = ("auction", "max_price")
    z = lambda d: torch.zeros((), dtype=d, device=dev)
    em, rows = z(torch.bool), z(torch.int64)
    key = (chunk.col("id"),)
    run = lambda: jn.probe_pairs(right, key, chunk.valid, chunk.ops, own, {}, out_names,
                                 cs.Q101_OUT_CAP, em, rows, null_names, True, jn.G2_OUTER)
    got = run()
    want = jn._probe_pairs_torch(right, key, chunk.valid, chunk.ops, own, {}, out_names,
                                 null_names, cs.Q101_OUT_CAP, z(torch.bool), z(torch.int64), True,
                                 jn.G2_OUTER)
    torch.cuda.synchronize()
    same = all(torch.equal(got.cols[k], want.cols[k]) for k in out_names) and all(
        torch.equal(got.nulls[k], want.nulls[k]) for k in null_names) and all(
        torch.equal(getattr(got, f), getattr(want, f)) for f in ("ops", "valid", "slots", "mc",
                                                                 "written"))
    return {**timed(torch, cs, run, reps), "equal_to_plain": same,
            "shape": {"probe_rows": n, "capacity": right.capacity, "fanout": right.fanout,
                      "written": int(got.written), "out_cap": cs.Q101_OUT_CAP}}


def paths(torch, dev, cs) -> None:
    """Phases 7-12, 23 and phase 16's q105 kill, as chip_smoke.py runs them."""
    drop = ("launches", "refusals", "launches_by_path")
    show = lambda r: emit({k: v for k, v in r.items() if k not in drop})
    row, _, (host, chunks, caps, interp, oracle) = cs.q8_path(torch, dev, cs.EPOCHS)
    show(row)
    row, _, _ = cs.q8_fused_path(torch, dev, host, chunks, caps, interp, oracle)
    show(row)
    del host, chunks, interp
    torch.cuda.empty_cache()
    row, _, (host, chunks, interp, rec, oracle) = cs.q7_path(torch, dev, cs.EPOCHS)
    show(row)
    row, _, _ = cs.q7_fused_path(torch, dev, host, chunks, (interp, rec), oracle)
    show(row)
    del host, chunks, interp, rec
    torch.cuda.empty_cache()
    row, _, (host, chunks, interp, rec, oracle) = cs.q101_path(torch, dev, cs.EPOCHS)
    show(row)
    row, _, _ = cs.q101_fused_path(torch, dev, host, chunks, (interp, rec), oracle)
    show(row)
    del interp, rec
    torch.cuda.empty_cache()
    rows, _ = cs.q105_paths(torch, dev, host, chunks)
    for r in rows:
        show(r)
    torch.cuda.empty_cache()
    row, _ = cs.kill_q105(torch, dev, host, chunks)
    show(row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--paths", action="store_true", help="also run phases 7-12, 23, 16's q105")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("rank_probe_split: torch finds no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from risingwave_tpu_torch import _kernels

    if not cs.__file__.startswith(root) or not _kernels.__file__.startswith(root):
        print(f"rank_probe_split: imported {cs.__file__}, not from {root}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "root": root})
    emit({"build_s": _kernels.build_all()})
    rng = np.random.default_rng(cs.SEED)
    emit({"split": "W", **split_w(torch, dev, cs, rng, args.reps)})
    torch.cuda.empty_cache()
    emit({"split": "M", **split_m(torch, dev, cs, rng, args.reps)})
    torch.cuda.empty_cache()
    emit({"split": "M+", **split_m_outer(torch, dev, cs, rng, args.reps)})
    torch.cuda.empty_cache()
    if args.paths:
        paths(torch, dev, cs)
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
