"""Phases 38 and 39 (q5 at 4 and 8 shards, q8 at 4) as ``chip_smoke.py``
runs them, with every kernel-AI call (``exchange._exchange_cuda``) timed
between CUDA events: the time of each call on the card's stream, the
host's launch included, summed per phase with the calls' shapes.

Usage (on a machine with one CUDA card), for one tree of the repo (a
second unpacked beside it with ``git archive`` compares two):

    python scripts/exchange_path_probe.py TREE

Prints one JSON object per path (rows/s, barrier p50) and per phase
(``calls``, ``ms_sum``, ``ms_mean``, the four commonest shapes as
(shards, rows a shard, bucket_cap, lanes))."""
import json
import os
import sys
from collections import Counter

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from risingwave_tpu_torch import _kernels  # noqa: E402
from risingwave_tpu_torch.parallel import exchange as X  # noqa: E402

assert cs.__file__.startswith(root) and X.__file__.startswith(root)
dev = torch.device("cuda")
_kernels.build_all()
rec = []
real = X._exchange_cuda


def timed(lanes, valid, keys, n, bc):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = real(lanes, valid, keys, n, bc)
    b.record()
    rec.append((a, b, (n, valid.shape[1], bc, len(lanes))))
    return out


X._exchange_cuda = timed


def summary(tag, rows):
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b, _ in rec]
    shapes = Counter(s for _, _, s in rec)
    top = [[list(k), v] for k, v in shapes.most_common(4)]
    for r in rows:
        print(json.dumps({"tree": root, "path": r.get("path"), "rows_per_s": r["rows_per_s"],
                          "barrier_ms_p50": r["barrier_ms_p50"]}), flush=True)
    print(json.dumps({"tree": root, "ai": tag, "calls": len(ms), "ms_sum": sum(ms),
                      "ms_mean": sum(ms) / max(len(ms), 1), "shapes": top}), flush=True)
    rec.clear()


row, _, (chunks, cap, interp, oracle) = cs.main_path(torch, dev, cs.EPOCHS)
q5_rows = cs.mv_table_rows(interp.mview, cs.P25_NAMES)
del interp
torch.cuda.empty_cache()
rec.clear()
rows, _ = cs.q5_sharded_paths(torch, dev, chunks, oracle, q5_rows)
summary("38", rows)
del chunks, q5_rows
torch.cuda.empty_cache()
row, _, (host, chunks, _, interp, oracle) = cs.q8_path(torch, dev, cs.EPOCHS)
rows7 = cs.q8_mv_rows(interp.mview)
del interp
torch.cuda.empty_cache()
rec.clear()
rows, _ = cs.q8_sharded_paths(torch, dev, host, chunks, oracle, rows7)
summary("39", rows)
