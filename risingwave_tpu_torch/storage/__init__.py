"""Storage — object store, SSTs, checkpoint/recovery (Hummock-lite).

Port of ``risingwave_tpu/storage/__init__.py``, with the reference's
exports. See the module docs.
"""

from risingwave_tpu_torch.storage.object_store import (
    LocalFsObjectStore,
    MemObjectStore,
    ObjectStore,
)
from risingwave_tpu_torch.storage.state_table import (
    Checkpointable,
    CheckpointManager,
    StateDelta,
)

__all__ = [
    "ObjectStore",
    "MemObjectStore",
    "LocalFsObjectStore",
    "Checkpointable",
    "CheckpointManager",
    "StateDelta",
]
