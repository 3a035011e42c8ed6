"""Time kernels AE and AF's diff on the card, split by launch, and run
phases 30 and 31; for comparing two trees of the repo on one card.

Usage (on a machine with one CUDA card):

    python scripts/window_split.py [--root TREE] [--epochs 20] [--paths]

``--root`` is the checkout whose ``risingwave_tpu_torch`` and
``chip_smoke.py`` are imported (default: this repo), so a second tree
unpacked beside it (``git archive``) can be timed in the same call.

Split mode (always): the q5 stream of ``chip_smoke.q5_stream`` over
``--epochs`` epochs; its q5 counts (``q5_epochs_oracle``: about 6.07M
(auction, window_start) groups at 20 epochs) inserted, window by window,
in 131,072-row chunks into phase 31's general over-window (a 2^24-slot
arena, phase 31's calls); then phase 3's chunk of kernel AF (131,072
U-/U+ pairs moving counts by -3..3) through AF's apply, and AE's general
recompute and AF's diff timed on that state: CUDA events around each
call, and ``torch.profiler``'s device spans summed by kernel name (the
split). AE's EOWC emit likewise at ``chip_smoke.kernel_ae_eowc``'s shape
(the first epoch's bids tumbled into a 2^21-slot arena, one watermark
closing every window).

``--paths``: then ``chip_smoke.window_paths`` for phases 30 and 31 over
the same stream, held against their oracles as in ``chip_smoke.py``.

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
    warm-up; ``setup``'s device-to-device copies left out."""
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
        if ev.device_type != DeviceType.CUDA or ev.name.startswith("Memcpy DtoD"):
            continue
        name = ev.name.split("(")[0].replace("void ", "")
        by[name] += ev.time_range.elapsed_us() / 1e3 / reps
        count[name] += 1
    return {"device_ms": sum(by.values()),
            "by_kernel": {k: [by[k], count[k] / reps] for k in sorted(by, key=by.get,
                                                                      reverse=True)}}


def general_state(torch, dev, cs, ow, groups):
    """Phase 31's general over-window holding ``groups`` (auction,
    window_start, count), inserted window by window in 131,072-row chunks."""
    from risingwave_tpu_torch.array.chunk import StreamChunk

    auction, ws, num = groups
    order = np.lexsort((auction, ws))
    auction, ws, num = auction[order], ws[order], num[order]
    keys = ("auction", "window_start")
    ex = ow.GeneralOverWindowExecutor(
        ("window_start",), "neg_num", keys, cs.window_calls(cs.P31_CALLS),
        dict.fromkeys(keys + ("num", "neg_num"), torch.int64), capacity=cs.P31_CAP,
        table_id="p31.over", device=dev)
    step = cs.P31_OUT_CAP
    for lo in range(0, len(num), step):
        hi = min(lo + step, len(num))
        cols = {"auction": auction[lo:hi], "window_start": ws[lo:hi],
                "num": num[lo:hi].astype(np.int64), "neg_num": -num[lo:hi].astype(np.int64)}
        ex.apply(StreamChunk.from_numpy(cols, step, device=dev))
    torch.cuda.synchronize()
    return ex


def split_general(torch, dev, cs, ow, ex, rng, reps: int) -> dict:
    """AF's apply on phase 3's pair chunk, then AE's general recompute and
    AF's diff timed and split (``chip_smoke.kernel_ae_af``'s inputs)."""
    from risingwave_tpu_torch.array.chunk import StreamChunk
    from risingwave_tpu_torch.ops.hash_table import lookup_or_insert

    cap = ex.capacity
    live_slots = torch.nonzero(ex.present).flatten()
    pick = live_slots[torch.from_numpy(rng.choice(live_slots.numel(), cs.AF_PAIRS,
                                                  replace=False)).to(dev)]
    n = 2 * cs.AF_PAIRS
    ops = torch.zeros(n, dtype=torch.int32, device=dev)
    ops[0::2] = 2
    ops[1::2] = 3
    old = {k: ex.buf[k][pick] for k in ex.lane_names}
    new = dict(old)
    new["num"] = old["num"] + torch.from_numpy(rng.integers(-3, 4, pick.numel())).to(dev)
    new["neg_num"] = -new["num"]
    lanes = {k: torch.stack([old[k], new[k]], 1).reshape(-1) for k in ex.lane_names}
    chunk = StreamChunk(columns=lanes, valid=torch.ones(n, dtype=torch.bool, device=dev),
                        ops=ops)
    ex.table, slots, found, _ = lookup_or_insert(ex.table, tuple(chunk.col(k) for k in ex.pk),
                                                 chunk.valid)
    lat = (torch.zeros((), dtype=torch.bool, device=dev),
           torch.zeros((), dtype=torch.bool, device=dev))
    touched, ghost, gslots = ow._over_apply_cuda(
        ex.table, slots, found, ex._state(), chunk, ex.part_keys, ex.lane_names, ex._seq_base,
        lat, ow.apply_scratch(cap, dev))
    wscr = ow.window_scratch(cap + n, ow._window_scan_lanes(ex.calls), dev)
    dscr = ow.diff_scratch(cap, dev)
    rec = lambda: ow._general_recompute_cuda(ex._state(), touched, ghost, gslots, ex.calls,
                                             ex.part_keys, ex.order_col, wscr)
    ae = {"ms": cs.time_ms(torch, rec, reps), **spans(torch, rec, 3)}
    out, nul, dirty = rec()
    st1 = cs.general_state_clone(ex)
    restore = lambda: cs.general_restore(ex, st1)
    ops_pair = (torch.full((cap,), 1, dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=torch.int32, device=dev))
    diff = lambda: ow._over_diff_cuda(ex._state(), ex.emnulls, out, nul, dirty, ex.lane_names,
                                      ex.out_names, *ops_pair, dscr)
    af = {"ms": cs.time_ms(torch, diff, reps, restore), **spans(torch, diff, 3, restore)}
    restore()
    ret, ins = diff()
    members = int((ex.present | ex.em_valid).sum())
    shape = {"arena": cap, "members": members, "chunk": n, "dirty": int(dirty.sum()),
             "retract": int(ret.valid.sum()), "insert": int(ins.valid.sum())}
    return {"ae_general": ae, "af_diff": af, "shape": shape}


def split_eowc(torch, dev, cs, ow, ep, reps: int) -> dict:
    """AE's EOWC emit at ``chip_smoke.kernel_ae_eowc``'s shape."""
    from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
    from risingwave_tpu_torch.executors.row_id_gen import RowIdGenExecutor

    dt = {n: torch.int64 for n in ("_row_id", "window_start") + cs.WIN_COLS}
    calls = cs.window_calls(cs.P30_CALLS)
    ex = ow.EowcOverWindowExecutor(("window_start", "auction"), "date_time", calls, dt,
                                   win_col="window_start", capacity=cs.P30_CAP, device=dev)
    rid, hop = RowIdGenExecutor(), HopWindowExecutor("date_time", cs.TUMBLE_MS, cs.TUMBLE_MS)
    for c in ep:
        for t in hop.apply(rid.apply(c)[0]):
            ex.apply(t)
    cutoff = int(ex.buf["window_start"][ex.valid].max()) + 1
    v0 = ex.valid.clone()
    scratch = ow.window_scratch(cs.P30_CAP, ow._window_scan_lanes(calls), dev)
    args = (ex.buf, ex.bnulls, ex.valid, ex.seq, cutoff, ex.names, calls, ex.part_keys,
            ex.order_col, ex.win_col)
    restore = lambda: ex.valid.copy_(v0)
    fn = lambda: ow._eowc_emit_cuda(*args, scratch)
    row = {"ms": cs.time_ms(torch, fn, reps, restore), **spans(torch, fn, 3, restore),
           "closed": int(v0.sum())}
    restore()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--paths", action="store_true", help="also run phases 30 and 31")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("window_split: torch finds no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from risingwave_tpu_torch import _kernels
    from risingwave_tpu_torch.executors import over_window as ow

    if not ow.__file__.startswith(root):
        print(f"window_split: imported {ow.__file__}, not from {root}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "root": root})
    emit({"build_s": _kernels.build_all()})
    t0 = time.perf_counter()
    chunks = cs.q5_stream(torch, dev, args.epochs)
    groups = cs.q5_epochs_oracle(chunks)
    emit({"stream_s": time.perf_counter() - t0, "groups": int(len(groups[0]))})
    rng = np.random.default_rng(cs.SEED)
    t0 = time.perf_counter()
    ex = general_state(torch, dev, cs, ow, groups)
    emit({"general_fill_s": time.perf_counter() - t0})
    emit({"split": "general", **split_general(torch, dev, cs, ow, ex, rng, args.reps)})
    del ex
    torch.cuda.empty_cache()
    emit({"split": "eowc", **split_eowc(torch, dev, cs, ow, chunks[0], args.reps)})
    torch.cuda.empty_cache()
    if args.paths:
        wms = cs.epoch_watermarks(chunks)
        host = cs.bid_host_rows(chunks)
        for key, want in (("p30", cs.p30_oracle(host, wms[-1])), ("p31", cs.p31_oracle(groups))):
            runs, rows, _ = cs.window_paths(torch, dev, key, chunks, wms, want)
            for r in rows:
                emit({k: v for k, v in r.items() if k not in ("launches", "refusals")})
            del runs
            torch.cuda.empty_cache()
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
