#!/usr/bin/env python3
"""How many bids q7's dynamic max filter lets through per (window, price)
key, by chunk size: the join's left side holds them in a bucket of
``fanout`` entries per key.

    python3 scripts/q7_join_fanout.py [--chunks 65536 8192] [--epochs 3]

The filter passes a row iff its window is new in the chunk (every row
of a newly claimed window passes) or its price is >= the window's max
before the chunk, so a larger chunk passes more of a window's first
bids, and equal prices pile up on one join key. Runs the port's Nexmark
generator at chip_smoke.py's settings (10,000 events/s, 1M-event
epochs) on the CPU, in numpy; prints one JSON line per chunk size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WINDOW_MS = 10_000


def passing_keys(chunks, window_ms: int = WINDOW_MS) -> np.ndarray:
    """Per (window, price) key, the count of bids the filter passes."""
    wmax: dict = {}
    keys = []
    for b in chunks:
        ws = b["date_time"] // window_ms * window_ms
        pre = np.array([wmax.get(w, np.iinfo(np.int64).min) for w in ws.tolist()])
        new = np.array([w not in wmax for w in ws.tolist()])
        ok = new | (b["price"] >= pre)
        keys.append(np.stack([ws[ok], b["price"][ok]], 1))
        uw, inv = np.unique(ws, return_inverse=True)
        top = np.full(len(uw), np.iinfo(np.int64).min)
        np.maximum.at(top, inv, b["price"])
        for w, m in zip(uw.tolist(), top.tolist()):
            wmax[w] = max(wmax.get(w, m), m)
    _, counts = np.unique(np.concatenate(keys), axis=0, return_counts=True)
    return counts


def main() -> int:
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[65_536, 8_192])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--events-per-epoch", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--fanout", type=int, default=16)
    args = ap.parse_args()
    for size in args.chunks:
        gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=args.seed)
        chunks = []
        for _ in range(args.epochs):
            done = 0
            while done < args.events_per_epoch:
                n = min(size, args.events_per_epoch - done)
                done += n
                chunks.append(gen.next_events(n)["bid"])
        counts = passing_keys(chunks)
        print(json.dumps({
            "chunk_events": size, "epochs": args.epochs, "keys": int(len(counts)),
            "max_bids_per_key": int(counts.max()),
            "keys_over_fanout": int((counts > args.fanout).sum()), "fanout": args.fanout,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
