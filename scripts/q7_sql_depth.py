#!/usr/bin/env python3
"""How deep the SQL plan of Nexmark q7 runs on chip_smoke.py's q7
stream before its join side overflows, in the JAX reference on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/q7_sql_depth.py [--chunks 4]

The SQL q7 (``__graft_entry__.Q7_SQL``) joins every bid of a 10 s
tumble to its window's MAX on (window_start, price), so the join's left
side keeps every bid under its (window, price) key, in a bucket of the
planner's default fanout (16). chip_smoke.py's phases 9 and 37 generate
bids at 10,000 events/s in 8,192-event chunks (seed 20261017). This
plans the SQL with the reference's ``StreamPlanner``, pushes the chunks
to both sides with a barrier after each, and prints one JSON line: the
barriers that held, the first that raised and why, and, in numpy, the
first bid whose (window, price) key passes the fanout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 20261017
CHUNK_EVENTS = 8_192
WINDOW_MS = 10_000
COLS = ("auction", "bidder", "price", "date_time")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=4)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import __graft_entry__ as graft
    from risingwave_tpu.array.chunk import StreamChunk
    from risingwave_tpu.connectors.nexmark import BID_SCHEMA, NexmarkConfig, NexmarkGenerator
    from risingwave_tpu.sql import Catalog, StreamPlanner

    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000), seed=SEED)
    mv = StreamPlanner(Catalog({"bid": BID_SCHEMA}), capacity=1 << 16).plan(graft.Q7_SQL)
    fanout = mv.pipeline.join.left.fanout
    keys: Counter = Counter()
    first_over, seen, held, raised = None, 0, [], None
    for k in range(args.chunks):
        bid = gen.next_events(CHUNK_EVENTS)["bid"]
        for w, p in zip((bid["date_time"] // WINDOW_MS).tolist(), bid["price"].tolist()):
            keys[(w, p)] += 1
            if first_over is None and keys[(w, p)] > fanout:
                first_over = seen
            seen += 1
        chunk = StreamChunk.from_numpy({c: bid[c] for c in COLS}, CHUNK_EVENTS)
        mv.pipeline.push_left(chunk)
        mv.pipeline.push_right(chunk)
        try:
            mv.pipeline.barrier()
        except RuntimeError as e:
            raised = {"after_chunk": k + 1, "error": str(e)}
            break
        held.append({"after_chunk": k + 1, "bids": seen, "mv_rows": len(mv.mview.snapshot())})
    print(json.dumps({"fanout": fanout, "held": held, "raised": raised,
                      "first_bid_past_fanout": first_over,
                      "max_bids_per_key": max(keys.values())}))


if __name__ == "__main__":
    main()
