"""Time kernels F (reduce_by_key) and AI (vnode exchange) on the card,
split by launch, and run the paths that call them; for comparing two
trees of the repo on one card.

Usage (on a machine with one CUDA card):

    python scripts/reduce_exchange_split.py [--root TREE] [--reps 20] [--rows] [--paths]

``--root`` is the checkout whose ``risingwave_tpu_torch`` and
``chip_smoke.py`` are imported (default: this repo), so a second tree
unpacked beside it (``git archive``) can be timed in the same call.

Split mode (always), at ``chip_smoke.py``'s phase-3 shapes:

- F: ``chip_smoke.kernel_f``'s epoch, 16 stacked 65,536-row bid chunks
  hopped into 5.24M rows (q5's fused epoch), keys (auction,
  window_start), COUNT(*); beside it ``torch.sort(stable=True)`` of the
  64-bit fingerprint key, F's sort alone as a library call, and F's
  second call on the same input compared bit for bit with its first;
- AI: ``chip_smoke.kernel_ai``'s two q5 shapes, four hopped 327,680-row
  chunks stacked at 4 shards and one split 8 ways at 8 shards.

Each gives ``ms`` (CUDA events around each call, the mean), ``wall_ms``
(the host clock around a call and a synchronise), ``enqueue_ms`` (the
host clock a call, calls issued back to back), ``device_ms`` (the
device spans ``torch.profiler`` records, a call: kernels, memsets and
copies) split ``by_kernel`` as [ms a call, launches a call], and
``host_gap_ms`` = ``ms`` - ``device_ms``: what the card waits on the host.
AI's rows add ``fill_ms``, a fill kernel's time over ``fill_bytes``, the
bytes of every output slot of every lane and of valid (what AI's one
memset zeroes, less its few scratch words).

``--rows``: the same split for kernels B, C, D and L, each at its own
phase-3 shape (``chip_smoke.kernel_b``, ``kernel_c``, ``kernel_d``,
``kernel_l``): the first timing each of those functions takes is the
kernel's, and it is split as above (a setup's device-to-device copies
left out of ``device_ms``); and E on one 65,536-row chunk, the shape of
most of its launches, with its byte bound.

``--paths``: then phases 4 and 6 (q5, fused q5), 13 and 14 (q5-max,
fused), 38 (q5 at 4 and 8 shards), 7 and 39 (q8, q8 at 4 shards), as
``chip_smoke.py`` runs them over 20 epochs, their rows printed.

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


def spans(torch, fn, reps: int, setup=None) -> dict:
    """Device ms a call of ``fn`` by kernel name (and in all), from the
    device events ``torch.profiler`` records over ``reps`` calls after a
    warm-up; ``setup``'s device-to-device copies are left out."""
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
    by = defaultdict(float)
    count = defaultdict(int)
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        if setup is not None and ev.name.startswith("Memcpy DtoD"):
            continue
        name = ev.name.split("(")[0].replace("void ", "")
        by[name] += ev.time_range.elapsed_us() / 1e3 / reps
        count[name] += 1
    return {"device_ms": sum(by.values()),
            "by_kernel": {k: [by[k], count[k] / reps] for k in sorted(by, key=by.get,
                                                                      reverse=True)}}


def timed(torch, cs, fn, reps: int, setup=None) -> dict:
    """``ms``, ``wall_ms``, ``enqueue_ms`` (the host's time a call, calls
    issued back to back without a synchronise), the profiler's split and
    the host's gap."""
    ms = cs.time_ms(torch, fn, reps, setup)
    wall = enqueue = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    if setup is None:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
    sp = spans(torch, fn, 3, setup)
    return {"ms": ms, "wall_ms": wall * 1e3 / reps,
            "enqueue_ms": enqueue * 1e3 / reps if setup is None else None, **sp,
            "host_gap_ms": ms - sp["device_ms"]}


def split_f(torch, dev, cs, reps: int) -> dict:
    from risingwave_tpu_torch.array.chunk import flatten_stacked
    from risingwave_tpu_torch.executors import hop_window as hw
    from risingwave_tpu_torch.executors.hash_agg import _build_key_lanes
    from risingwave_tpu_torch.ops import agg as agg_ops
    from risingwave_tpu_torch.ops.agg import AggCall
    from risingwave_tpu_torch.ops.hashing import hash128

    stacked = cs.epoch_chunks(torch, dev, cs.SEED + 1)
    flat = flatten_stacked(hw.hop_step_fn(stacked, "date_time", 10_000, 2_000, "window_start"))
    del stacked
    calls = (AggCall("count_star", None, "num"),)
    keys = _build_key_lanes(flat, ("auction", "window_start"), (False, False))
    signs = flat.effective_signs()
    run = lambda: agg_ops.reduce_by_key(keys, signs, calls, {}, {})
    got, again = run(), run()
    want = agg_ops._reduce_by_key_torch(keys, signs, calls, {}, {})
    torch.cuda.synchronize()
    lanes = lambda out: cs.reduce_outputs(torch, out)
    same = all(torch.equal(a, b) for a, b in zip(lanes(got).values(), lanes(want).values()))
    repeat = all(torch.equal(a, b) for a, b in zip(lanes(got).values(), lanes(again).values()))
    row = timed(torch, cs, run, reps)
    h1, h2 = hash128(keys)
    key64 = ((h1 << 32) | h2) ^ (-(2**63))
    row["library_sort_ms"] = cs.time_ms(torch, lambda: torch.sort(key64, stable=True), reps)
    return {**row, "equal_to_plain": same, "same_bits_twice": repeat,
            "shape": {"rows": int(signs.numel()), "invisible": int((signs == 0).sum()),
                      "representatives": int(got[1].sum())}}


def split_ai(torch, dev, cs, reps: int) -> list:
    from risingwave_tpu_torch.executors.hop_window import hop_step_fn
    from risingwave_tpu_torch.array.chunk import stack_chunks
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS
    from risingwave_tpu_torch.runtime.fragmenter import StackSplitExecutor

    chunks = cs.q5_stream(torch, dev, 1)
    hop = lambda c: hop_step_fn(c, "date_time", Q5_WINDOW_MS, Q5_SLIDE_MS, "window_start")
    hopped = [hop(c) for c in chunks[0][:4]]
    del chunks
    key_of = lambda st: (st.col("auction"), st.col("window_start"))
    st4 = stack_chunks(hopped)
    (st8,) = StackSplitExecutor(8).apply(hopped[0])
    out = []
    for what, st, n in (("4 shards, 4 x 327,680 rows", st4, 4),
                        ("8 shards, one chunk split 8 ways", st8, 8)):
        keys = key_of(st)
        bc = X.default_bucket_cap(st.valid.shape[1], n)
        run = lambda: X.exchange_chunk(st, keys, n, bc)
        rec, flag, counts = run()
        bufs, vbuf, ovf, cnt = X._exchange_torch(X.exchange_cols(st), st.valid, keys, n, bc)
        torch.cuda.synchronize()
        same = (torch.equal(rec.valid, vbuf) and torch.equal(counts, cnt)
                and torch.equal(flag, ovf) and torch.equal(rec.ops, bufs["__ops__"])
                and all(torch.equal(rec.columns[k], bufs[k]) for k in rec.columns))
        # what zeroing every output slot costs at the card's rate: the
        # same bytes (each lane and valid) zeroed by a fill kernel
        lanes = X.exchange_cols(st)
        fill_bytes = n * n * bc * (1 + sum(a.element_size() for a in lanes.values()))
        buf = torch.empty(fill_bytes, dtype=torch.uint8, device=dev)
        fill_ms = cs.time_ms(torch, buf.zero_, reps)
        del buf
        out.append({**timed(torch, cs, run, reps), "equal_to_plain": same, "case": what,
                    "fill_ms": fill_ms, "fill_bytes": fill_bytes,
                    "shape": {"shards": n, "rows": list(st.valid.shape), "bucket_cap": bc,
                              "lanes": len(X.exchange_cols(st)),
                              "routed": int(counts.sum())}})
    return out


def split_rows(torch, dev, cs, reps: int) -> list:
    """B, C, D and L at their phase-3 shapes: each ``chip_smoke.kernel_*``
    runs as in the script, and the first ``time_ms`` it takes (its
    kernel's) is split."""
    real = cs.time_ms
    taken = []

    def first_split(torch_, fn, reps_, setup=None):
        if not taken:
            cs.time_ms = real
            taken.append(timed(torch_, cs, fn, reps, setup))
            cs.time_ms = first_split
        return real(torch_, fn, reps_, setup)

    def run(name, f, *args):
        taken.clear()
        cs.time_ms = first_split
        try:
            out = f(torch, dev, *args)
        finally:
            cs.time_ms = real
        row = out[0] if isinstance(out, tuple) else out
        rows.append({"split": name, **taken[0], "kernel_row_ms": row["ms"],
                     "shape": row.get("shape")})
        return out

    rows = []
    rng = np.random.default_rng(cs.SEED)
    a_row, a_out = cs.kernel_a(torch, dev, rng)
    _, b_results = run("B", cs.kernel_b, rng, a_out)
    run("C", cs.kernel_c, rng, b_results, a_out[0])
    del a_out, b_results
    torch.cuda.empty_cache()
    run("D", cs.kernel_d, rng)
    torch.cuda.empty_cache()
    run("L", cs.kernel_l, rng)
    torch.cuda.empty_cache()
    rows.append(split_e_chunk(torch, dev, cs, reps))
    return rows


def split_e_chunk(torch, dev, cs, reps: int) -> dict:
    """E at the shape most of its launches take: one 65,536-row bid chunk
    of q5's stream hopped into 5 windows (the interpreted paths' call;
    phase 3 times it over a 16-chunk epoch), with its byte bound counted
    as ``chip_smoke.kernel_e`` counts it."""
    from risingwave_tpu_torch.executors.hop_window import hop_step_fn
    from risingwave_tpu_torch.queries.nexmark_q import Q5_SLIDE_MS, Q5_WINDOW_MS

    chunk = cs.q5_stream(torch, dev, 1)[0][0]
    run = lambda: hop_step_fn(chunk, "date_time", Q5_WINDOW_MS, Q5_SLIDE_MS, "window_start")
    out = run()
    row_in = sum(a.element_size() for a in chunk.columns.values()) + 1 + 4
    row_out = sum(a.element_size() for a in out.columns.values()) + 1 + 4
    nbytes = chunk.valid.numel() * row_in + out.valid.numel() * row_out
    return {"split": "E", **timed(torch, cs, run, reps), "bound_ms": cs.bound_ms(nbytes),
            "shape": {"chunk_rows": int(chunk.valid.numel()), "rows_out": int(out.valid.numel())}}


def paths(torch, dev, cs) -> None:
    """Phases 4, 6, 13, 14, 38, 7 and 39, as chip_smoke.py runs them."""
    drop = ("launches", "refusals", "launches_by_path", "barrier_ms", "watermark_ms")
    show = lambda r: emit({k: v for k, v in r.items() if k not in drop})
    row, _, (chunks, cap, interp, oracle) = cs.main_path(torch, dev, cs.EPOCHS)
    show(row)
    row, _ = cs.fused_path(torch, dev, chunks, cap, interp, oracle)
    show(row)
    q5_rows = cs.mv_table_rows(interp.mview, cs.P25_NAMES)
    del interp
    torch.cuda.empty_cache()
    row, _, q5m = cs.q5_max_path(torch, dev, chunks, cap, oracle)
    show(row)
    row, _ = cs.q5_max_fused_path(torch, dev, chunks, cap, q5m)
    show(row)
    del q5m
    torch.cuda.empty_cache()
    rows, _ = cs.q5_sharded_paths(torch, dev, chunks, oracle, q5_rows)
    for r in rows:
        show(r)
    del chunks, q5_rows
    torch.cuda.empty_cache()
    row, _, (host, chunks, _, interp, oracle) = cs.q8_path(torch, dev, cs.EPOCHS)
    show(row)
    rows7 = cs.q8_mv_rows(interp.mview)
    del interp
    torch.cuda.empty_cache()
    rows, _ = cs.q8_sharded_paths(torch, dev, host, chunks, oracle, rows7)
    for r in rows:
        show(r)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", action="store_true", help="also split B, C, D and L")
    ap.add_argument("--paths", action="store_true", help="also run phases 4, 6, 13, 14, 38, 7, 39")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("reduce_exchange_split: torch finds no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from risingwave_tpu_torch import _kernels

    if not cs.__file__.startswith(root) or not _kernels.__file__.startswith(root):
        print(f"reduce_exchange_split: imported {cs.__file__}, not from {root}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "root": root})
    emit({"build_s": _kernels.build_all()})
    emit({"split": "F", **split_f(torch, dev, cs, args.reps)})
    torch.cuda.empty_cache()
    for r in split_ai(torch, dev, cs, args.reps):
        emit({"split": "AI", **r})
    torch.cuda.empty_cache()
    if args.rows:
        for r in split_rows(torch, dev, cs, args.reps):
            emit(r)
        torch.cuda.empty_cache()
    if args.paths:
        paths(torch, dev, cs)
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
