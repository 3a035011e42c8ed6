"""SQL frontend — parser, binder, streaming planner.

Port of ``risingwave_tpu/sql/``. Reference: src/sqlparser/ (parser),
src/frontend/src/{binder,planner,optimizer,stream_fragmenter}/. See
parser.py / planner.py docs.
"""

from risingwave_tpu_torch.sql.parser import parse
from risingwave_tpu_torch.sql.planner import Catalog, PlannedMV, StreamPlanner

__all__ = ["parse", "Catalog", "StreamPlanner", "PlannedMV"]
