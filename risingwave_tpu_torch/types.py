"""Row ops and the column types the chunk and the Nexmark source use.

Port of ``risingwave_tpu/types.py`` (``Op``/``op_sign`` at :38-52, the
``DataType``/``Field``/``Schema`` subset of :53-246). Reference:
src/common/src/types/ and src/common/src/array/stream_chunk.rs:45.

Every device column is one fixed-width torch dtype; VARCHAR rides an
int32 dictionary code (array/dictionary.py) and TIMESTAMP int64 ms.
Composite types (INTERVAL, STRUCT, LIST, ...) are not ported yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class Op(enum.IntEnum):
    """Row-level change op (reference: stream_chunk.rs:45)."""

    INSERT = 0
    DELETE = 1
    UPDATE_DELETE = 2
    UPDATE_INSERT = 3


def op_sign(ops: torch.Tensor) -> torch.Tensor:
    """+1 for Insert/UpdateInsert, -1 for Delete/UpdateDelete (int32)."""
    retract = (ops == Op.DELETE) | (ops == Op.UPDATE_DELETE)
    one = torch.ones((), dtype=torch.int32, device=ops.device)
    return torch.where(retract, -one, one)


class DataType(enum.Enum):
    """Logical column types at the host edge (fixed-width subset)."""

    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOLEAN = "boolean"
    TIMESTAMP = "timestamp"  # ms since epoch, int64 on device
    VARCHAR = "varchar"  # dictionary-encoded int32 on device

    @property
    def device_dtype(self) -> torch.dtype:
        return _DEVICE_DTYPES[self]


_DEVICE_DTYPES = {
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BOOLEAN: torch.bool,
    DataType.TIMESTAMP: torch.int64,
    DataType.VARCHAR: torch.int32,
}


@dataclass(frozen=True)
class Field:
    """A named, typed column."""

    name: str
    dtype: DataType

    def __repr__(self) -> str:
        return f"{self.name}:{self.dtype.value}"


@dataclass(frozen=True)
class Schema:
    """Ordered list of fields (reference: src/common/src/catalog/schema.rs)."""

    fields: tuple

    def __init__(self, fields):
        object.__setattr__(
            self,
            "fields",
            tuple(
                f if isinstance(f, Field) else Field(f[0], f[1]) for f in fields
            ),
        )

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)
