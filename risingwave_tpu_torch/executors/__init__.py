"""Streaming executors — the dataflow operators (port of
``risingwave_tpu/executors/``). Each module holds its executor and the
step functions whose kernels it launches; the TopN family, the
SimpleAgg and the general dynamic filter are exported here, as the
reference's ``executors/__init__.py`` exports them."""

from risingwave_tpu_torch.executors.dynamic_filter import DynamicFilterExecutor
from risingwave_tpu_torch.executors.simple_agg import SimpleAggExecutor
from risingwave_tpu_torch.executors.top_n import GroupTopNExecutor
from risingwave_tpu_torch.executors.top_n_plain import (
    RetractableGroupTopNExecutor,
    TopNExecutor,
)

__all__ = [
    "DynamicFilterExecutor",
    "GroupTopNExecutor",
    "RetractableGroupTopNExecutor",
    "SimpleAggExecutor",
    "TopNExecutor",
]
