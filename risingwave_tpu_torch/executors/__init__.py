"""Streaming executors — the dataflow operators (port of
``risingwave_tpu/executors/``). Each module holds its executor and the
step functions whose kernels it launches; the TopN family is exported
here, as the reference's ``executors/__init__.py`` exports it."""

from risingwave_tpu_torch.executors.top_n import GroupTopNExecutor
from risingwave_tpu_torch.executors.top_n_plain import (
    RetractableGroupTopNExecutor,
    TopNExecutor,
)

__all__ = ["GroupTopNExecutor", "RetractableGroupTopNExecutor", "TopNExecutor"]
