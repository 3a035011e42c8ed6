"""The port stands alone: ``risingwave_tpu_torch`` imports neither jax nor
``risingwave_tpu``, runs q5, q8, q7 (with watermarks) and q19 (both
TopN executors), an unnest into an Expand and the host MV (both
backends) on the CPU when asked to, commits and recovers q5 through its
own storage layer, runs q5 evicting its agg after every commit, plans
q5 from SQL and runs it through the actor graph at parallelism 2 and
over a mesh of 2 shards (``parallel``), and refuses to fall back to the CPU when CUDA is asked for but absent.

A subprocess is needed because tests/conftest.py imports jax into every
pytest process.
"""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "risingwave_tpu_torch"

_CHILD = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "risingwave_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
import risingwave_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(risingwave_tpu_torch.__path__, "risingwave_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
for m in ("runtime.fused_step", "executors.epoch_batch", "integrity", "executors.dedup",
          "executors.hash_join", "ops.join", "queries.nexmark_q", "runtime.pipeline",
          "executors.dynamic_filter", "storage.state_table", "storage.block_sst",
          "storage.sstable", "storage.object_store", "resilience", "metrics", "event_log",
          "ops.checkpoint", "expr.expr", "expr.functions", "expr.dtypes", "ops.expr_vm",
          "executors.filter", "executors.project", "executors.watermark_filter",
          "executors.row_id_gen", "executors.top_n", "executors.top_n_plain",
          "executors.simple_agg", "array.composite", "array.arrow", "executors.project_set",
          "executors.expand", "executors.temporal_join", "executors.generators",
          "executors.troublemaker", "executors.sort", "executors.over_window",
          "ops.cold_tier", "native", "executors.materialize", "sql.parser", "sql.optimizer",
          "sql.typing", "sql.planner", "executors.lookup", "runtime.graph",
          "runtime.fragmenter", "parallel", "parallel.exchange", "parallel.sharded_agg",
          "parallel.sharded_join", "parallel.sharded_mv", "parallel.sharded_top_n"):
    assert "risingwave_tpu_torch." + m in mods, m
assert not any(k.split(".")[0] in ("jax", "risingwave_tpu") for k in sys.modules)

from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.queries.nexmark_q import build_q5_lite

q5 = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
gen = NexmarkGenerator(NexmarkConfig(first_event_rate=50_000))
for _ in range(2):
    q5.pipeline.push(gen.next_chunks(400, 400, device="cpu")["bid"])
    q5.pipeline.barrier()
snap = q5.mview.snapshot()
assert snap and all(v[0] > 0 for v in snap.values())

import tempfile
from risingwave_tpu_torch.storage import CheckpointManager, LocalFsObjectStore

with tempfile.TemporaryDirectory() as d:
    CheckpointManager(LocalFsObjectStore(d)).commit_epoch(q5.pipeline.epoch,
                                                          q5.pipeline.executors)
    again = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
    CheckpointManager(LocalFsObjectStore(d)).recover(again.pipeline.executors)
    assert again.mview.snapshot() == snap
    assert again.agg.state_digest() == q5.agg.state_digest()

from risingwave_tpu_torch.runtime.fused_step import fuse_pipeline

fused = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
(w,) = fuse_pipeline(fused.pipeline)
gen = NexmarkGenerator(NexmarkConfig(first_event_rate=50_000))
for _ in range(2):
    fused.pipeline.push(gen.next_chunks(400, 400, device="cpu")["bid"])
    fused.pipeline.barrier()
assert fused.mview.snapshot() == snap and set(w.last_digests) == {"agg", "mv"}

from risingwave_tpu_torch.queries.nexmark_q import build_q8

q8_snaps = []
for fuse in (False, True):
    q8 = build_q8(capacity=1 << 10, out_cap=1 << 10, device="cpu")
    if fuse:
        (w8,) = fuse_pipeline(q8.pipeline)
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000))
    for _ in range(2):
        ch = gen.next_chunks(3000, 4096, device="cpu")
        q8.pipeline.push_left(ch["person"].select(["id", "name", "date_time"]))
        q8.pipeline.push_right(ch["auction"].select(["seller", "date_time"]))
        q8.pipeline.barrier()
    q8_snaps.append(q8.mview.snapshot())
assert q8_snaps[0] and q8_snaps[0] == q8_snaps[1] and len(w8.last_digests) == 5

from risingwave_tpu_torch.queries.nexmark_q import build_q7

q7_snaps = []
for fuse in (False, True):
    q7 = build_q7(capacity=1 << 10, out_cap=1 << 10, device="cpu")
    if fuse:
        (w7,) = fuse_pipeline(q7.pipeline)
    gen = NexmarkGenerator(NexmarkConfig(first_event_rate=200))
    mx = 0
    for _ in range(3):
        bid = gen.next_chunks(1500, 2048, device="cpu")["bid"]
        bid = bid.select(["auction", "bidder", "price", "date_time"])
        q7.pipeline.push_left(bid)
        q7.pipeline.push_right(bid)
        q7.pipeline.barrier()
        mx = max(mx, int(bid.to_numpy()["date_time"].max()))
        q7.pipeline.watermark("date_time", mx)
    q7_snaps.append(q7.mview.snapshot())
assert q7_snaps[0] and q7_snaps[0] == q7_snaps[1] and len(w7.last_digests) == 5
assert int(q7.agg.table.live.sum()) < int(q7.agg.table.occupancy())

from risingwave_tpu_torch.queries.nexmark_q import build_q19, build_q19_append_only

q19s = [build_q19(capacity=1 << 10, device="cpu"),
        build_q19_append_only(capacity=1 << 8, out_cap=1 << 11, device="cpu")]
gen = NexmarkGenerator(NexmarkConfig(first_event_rate=10_000))
for _ in range(2):
    bid = gen.next_chunks(600, 600, device="cpu")["bid"]
    for q in q19s:
        q.pipeline.push(bid)
        q.pipeline.barrier()
assert q19s[0].mview.snapshot() == q19s[1].mview.snapshot() != {}

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.array.composite import encode_column
from risingwave_tpu_torch.executors import ExpandExecutor, NowExecutor, ProjectSetExecutor
from risingwave_tpu_torch.types import DataType, Field

lanes, nulls = encode_column(Field("xs", DataType.LIST, elem=DataType.INT64, list_cap=3),
                             [[1, 2], None, [3]])
(un,) = ProjectSetExecutor("unnest", out="x", list_col="xs", list_cap=3).apply(
    StreamChunk.from_numpy(lanes, 4, nulls=nulls, device="cpu"))
assert sorted(un.to_numpy()["x"].tolist()) == [1, 2, 3]
(ex,) = ExpandExecutor([("x",), ()]).apply(un)
assert ex.capacity == 24 and int(ex.valid.sum()) == 6

from risingwave_tpu_torch.executors import SortExecutor
from risingwave_tpu_torch.executors.base import Watermark
from risingwave_tpu_torch.executors.over_window import OverWindowExecutor, WindowCall

srt = SortExecutor("t", {"t": torch.int64, "p": torch.int64}, capacity=16, device="cpu")
srt.apply(StreamChunk.from_numpy({"t": [3, 1, 2], "p": [1, 1, 2]}, 4, device="cpu"))
(closed,) = srt.on_watermark(Watermark("t", 3))[1]
(ranked,) = OverWindowExecutor(("p",), (WindowCall("row_number", None, "rn"),),
                               {"p": torch.int64}, capacity=16, device="cpu").apply(closed)
assert ranked.to_numpy()["rn"].tolist() == [1, 1]

from risingwave_tpu_torch.executors import MaterializeExecutor
from risingwave_tpu_torch.storage import MemObjectStore
from risingwave_tpu_torch.types import Op

for force in (False, True):
    hmv = MaterializeExecutor(("k",), ("v",), table_id="hmv")
    hmv._force_python = force
    hmv.apply(StreamChunk.from_numpy({"k": [1, 2, 1], "v": [5, 6, 7]}, 4, device="cpu"))
    assert hmv.snapshot() == {(1,): (7,), (2,): (6,)}
    assert hmv._backend == ("python" if force else "native")

cold = build_q5_lite(capacity=1 << 10, state_cleaning=False, device="cpu")
mgr = CheckpointManager(MemObjectStore())
cold.agg.cold_reader = lambda keys: mgr.get_rows(cold.agg.table_id, keys)
gen = NexmarkGenerator(NexmarkConfig(first_event_rate=50_000))
for _ in range(2):
    cold.pipeline.push(gen.next_chunks(400, 400, device="cpu")["bid"])
    cold.pipeline.barrier()
    mgr.commit_epoch(cold.pipeline.epoch, cold.pipeline.executors)
    assert cold.agg.evict_cold() > 0
assert cold.mview.snapshot() == snap and cold.agg.cold_counts["merged"] > 0

from risingwave_tpu_torch.connectors.nexmark import BID_SCHEMA
from risingwave_tpu_torch.runtime.fragmenter import graph_planned_mv
from risingwave_tpu_torch.sql import Catalog, StreamPlanner

Q5 = ("CREATE MATERIALIZED VIEW q5 AS SELECT auction, window_start, count(*) AS num "
      "FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND) "
      "GROUP BY auction, window_start")
sql_cat = Catalog({"bid": BID_SCHEMA})
planned = graph_planned_mv(lambda: StreamPlanner(sql_cat, capacity=1 << 10, device="cpu"), Q5,
                           parallelism=2)
gen = NexmarkGenerator(NexmarkConfig(first_event_rate=50_000))
try:
    for _ in range(2):
        planned.pipeline.push(gen.next_chunks(400, 400, device="cpu")["bid"])
        planned.pipeline.barrier()
finally:
    planned.pipeline.close()
assert planned.mview.snapshot() == snap

import risingwave_tpu_torch.parallel as par
from risingwave_tpu_torch.runtime import sharded_planned_mv

assert not any(k.split(".")[0] in ("jax", "risingwave_tpu") for k in sys.modules)
sharded = sharded_planned_mv(lambda: StreamPlanner(sql_cat, capacity=1 << 10, device="cpu"), Q5,
                             2)
assert any(isinstance(e, par.ShardedHashAgg) for e in sharded.pipeline.executors)
gen = NexmarkGenerator(NexmarkConfig(first_event_rate=50_000))
try:
    for _ in range(2):
        sharded.pipeline.push(gen.next_chunks(400, 400, device="cpu")["bid"])
        sharded.pipeline.barrier()
finally:
    sharded.pipeline.close()
assert sharded.mview.snapshot() == snap

assert not torch.cuda.is_available()
for make in (lambda: build_q5_lite(), lambda: build_q8(), lambda: build_q7(),
             lambda: StreamPlanner(sql_cat).plan(Q5),
             lambda: build_q19(), lambda: build_q19_append_only(),
             lambda: NexmarkGenerator().next_chunks(10, 16),
             lambda: NowExecutor(), lambda: SortExecutor("t", {"t": torch.int64}),
             lambda: par.make_mesh(2)):
    try:
        make()
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("default device ran without CUDA")
print("MODULES", len(mods))
'''


def test_port_imports_and_runs_without_jax_and_never_falls_back_to_cpu():
    env = {
        "PATH": "/usr/bin:/bin",
        "PYTHONPATH": str(ROOT),
        "CUDA_VISIBLE_DEVICES": "",  # no card, even on a machine that has one
        "PYTHONDONTWRITEBYTECODE": "1",
    }
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("MODULES")[1])
    assert n >= 31  # every module of the slices was imported


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|risingwave_tpu)(\.|\s|$)", re.M
)


def test_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        text = f.read_text()
        hits = [m.group(0) for m in _FORBIDDEN.finditer(text)]
        assert not hits, f"{f}: {hits}"
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from risingwave_tpu.ops import agg")
    assert not _FORBIDDEN.search("from risingwave_tpu_torch.ops import agg")
