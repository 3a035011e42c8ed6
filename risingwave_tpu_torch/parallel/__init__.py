"""Parallelism: vnode-sharded operators over a mesh.

Port of ``risingwave_tpu/parallel/__init__.py``. Reference model
(SURVEY.md §2.11): RisingWave parallelizes a fragment into N actors;
rows route to actors by the vnode of the distribution key (256 vnodes,
src/stream/src/executor/dispatch.rs:683) through an exchange.

Here a fragment's N shards stack their state on one device
(``make_mesh``); the exchange is kernel AI (``exchange.py``), which
writes each row into its destination shard's receive buffer, and each
shard then runs the single-chip kernels on its rows of the stacked
state. ``scale.py`` (the ScaleController, which drives the streaming
runtime) and ``meshprof.py`` are not ported yet (ROADMAP S6, S8).
"""

from risingwave_tpu_torch.array.chunk import stack_chunks
from risingwave_tpu_torch.parallel.sharded_agg import Mesh, ShardedHashAgg, make_mesh
from risingwave_tpu_torch.parallel.sharded_join import (
    ShardedDedup,
    ShardedHashJoin,
    flatten_stacked,
    stack_for_mesh,
)
from risingwave_tpu_torch.parallel.sharded_mv import ShardedMaterialize
from risingwave_tpu_torch.parallel.sharded_top_n import ShardedGroupTopN

__all__ = [
    "Mesh",
    "ShardedDedup",
    "ShardedGroupTopN",
    "ShardedHashAgg",
    "ShardedHashJoin",
    "ShardedMaterialize",
    "flatten_stacked",
    "make_mesh",
    "stack_chunks",
    "stack_for_mesh",
]
