"""Streaming executors — the dataflow operators (port of
``risingwave_tpu/executors/``). Each module holds its executor and the
step functions whose kernels it launches; the TopN family, the
SimpleAgg, the general dynamic filter, the table-function, grouping-set
and temporal-join executors, the EOWC sort, the generators, the host
MV and the troublemaker are exported here (the reference exports SortExecutor,
``risingwave_tpu/executors/__init__.py:25,37``)."""

from risingwave_tpu_torch.executors.dynamic_filter import DynamicFilterExecutor
from risingwave_tpu_torch.executors.expand import ExpandExecutor
from risingwave_tpu_torch.executors.generators import NowExecutor, ValuesExecutor
from risingwave_tpu_torch.executors.materialize import MaterializeExecutor
from risingwave_tpu_torch.executors.project_set import ProjectSetExecutor
from risingwave_tpu_torch.executors.simple_agg import SimpleAggExecutor
from risingwave_tpu_torch.executors.sort import SortExecutor
from risingwave_tpu_torch.executors.temporal_join import TemporalJoinExecutor
from risingwave_tpu_torch.executors.top_n import GroupTopNExecutor
from risingwave_tpu_torch.executors.top_n_plain import (
    RetractableGroupTopNExecutor,
    TopNExecutor,
)
from risingwave_tpu_torch.executors.troublemaker import TroublemakerExecutor

__all__ = [
    "DynamicFilterExecutor",
    "ExpandExecutor",
    "GroupTopNExecutor",
    "MaterializeExecutor",
    "NowExecutor",
    "ProjectSetExecutor",
    "RetractableGroupTopNExecutor",
    "SimpleAggExecutor",
    "SortExecutor",
    "TemporalJoinExecutor",
    "TopNExecutor",
    "TroublemakerExecutor",
    "ValuesExecutor",
]
