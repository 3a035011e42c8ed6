"""Row ops and the column types the chunk and the Nexmark source use.

Port of ``risingwave_tpu/types.py`` (``Op``/``op_sign`` :38-52,
``DataType`` :53, ``Interval`` :130, ``Field`` :160, ``Schema`` :187,
``schema_from_dtypes`` :233). Reference: src/common/src/types/ and
src/common/src/array/stream_chunk.rs:45.

Every device column is one fixed-width torch dtype; VARCHAR and JSONB
ride an int32 dictionary code (array/dictionary.py), TIMESTAMP int64 ms
and DECIMAL a scaled int64. The composite types (INTERVAL, STRUCT, LIST,
INT256) expand into several such lanes at the host edge
(array/composite.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
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
    """Logical column types at the host edge.

    Wider SQL types map onto fixed-width device lanes:
    - DECIMAL(p, s) -> scaled int64 (value * 10^s; ``Field.scale``);
    - INTERVAL -> ``name.months`` int32 + ``name.usecs`` int64;
    - JSONB -> int32 dictionary code of the canonical JSON text;
    - STRUCT -> one lane per leaf field, named ``parent.child``;
    - LIST -> ``name.<i>`` element lanes padded to ``Field.list_cap``
      plus a ``name.#`` int32 length lane;
    - INT256 -> 4 little-endian int64 limbs.
    """

    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOLEAN = "boolean"
    TIMESTAMP = "timestamp"  # ms since epoch, int64 on device
    VARCHAR = "varchar"  # dictionary-encoded int32 on device
    DECIMAL = "decimal"  # scaled int64 on device (Field.scale)
    INTERVAL = "interval"  # composite: months int32 + usecs int64
    JSONB = "jsonb"  # dictionary-encoded canonical JSON, int32
    STRUCT = "struct"  # composite: child lanes (Field.children)
    LIST = "list"  # composite: padded element lanes (Field.elem/cap)
    INT256 = "int256"  # composite: 4 little-endian int64 limbs

    @property
    def device_dtype(self) -> torch.dtype:
        d = _DEVICE_DTYPES.get(self)
        if d is None:
            raise TypeError(f"{self} is composite: expand via array/composite.py")
        return d

    @property
    def numpy_dtype(self) -> np.dtype:
        """The device lane's dtype as numpy sees it (the host edge's)."""
        return torch.empty(0, dtype=self.device_dtype).numpy().dtype

    @property
    def is_composite(self) -> bool:
        return self in (DataType.INTERVAL, DataType.STRUCT, DataType.LIST, DataType.INT256)

    @property
    def null_value(self):
        """Padding value used in invalid lanes (never observed by kernels)."""
        return self.numpy_dtype.type(0)


_DEVICE_DTYPES = {
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BOOLEAN: torch.bool,
    DataType.TIMESTAMP: torch.int64,
    DataType.VARCHAR: torch.int32,
    DataType.DECIMAL: torch.int64,
    DataType.JSONB: torch.int32,
}


@dataclass(frozen=True)
class Interval:
    """SQL INTERVAL value (reference: src/common/src/types/interval.rs
    keeps months/days/usecs; days fold into usecs here)."""

    months: int = 0
    usecs: int = 0

    @staticmethod
    def of(months=0, days=0, hours=0, minutes=0, seconds=0, usecs=0):
        return Interval(
            months=months,
            usecs=usecs
            + int(seconds * 1_000_000)
            + minutes * 60_000_000
            + hours * 3_600_000_000
            + days * 86_400_000_000,
        )

    def total_usecs(self) -> int:
        """Fixed-usec view; months use the reference's 30-day estimate
        (interval.rs comparison semantics)."""
        return self.months * 30 * 86_400_000_000 + self.usecs


@dataclass(frozen=True)
class Field:
    """A named, typed column.

    Type parameters ride on the field: ``scale`` for DECIMAL(p, s);
    ``children`` (a Schema) for STRUCT; ``elem`` + ``list_cap`` for LIST.
    """

    name: str
    dtype: DataType
    scale: "int | None" = None
    children: "Schema | None" = None
    elem: "DataType | None" = None
    list_cap: "int | None" = None

    def __post_init__(self):
        if self.dtype is DataType.DECIMAL and self.scale is None:
            object.__setattr__(self, "scale", 6)  # pg-ish default
        if self.dtype is DataType.STRUCT and self.children is None:
            raise ValueError(f"STRUCT field {self.name!r} needs children")
        if self.dtype is DataType.LIST:
            if self.elem is None:
                raise ValueError(f"LIST field {self.name!r} needs elem")
            if self.list_cap is None:
                object.__setattr__(self, "list_cap", 16)

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

    @property
    def names(self) -> tuple:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def select(self, names) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def concat(self, other: "Schema", prefix: str = "") -> "Schema":
        return Schema(self.fields + tuple(Field(prefix + f.name, f.dtype) for f in other.fields))


def schema_from_dtypes(dtypes: dict) -> Schema:
    """Device dtypes (torch or numpy) -> logical Schema (the reverse edge
    mapping)."""
    rev = {
        torch.int32: DataType.INT32,
        torch.int64: DataType.INT64,
        torch.float32: DataType.FLOAT32,
        torch.float64: DataType.FLOAT64,
        torch.bool: DataType.BOOLEAN,
    }
    to_torch = lambda d: d if isinstance(d, torch.dtype) else torch.from_numpy(
        np.zeros(0, np.dtype(d))).dtype
    return Schema(tuple(Field(n, rev[to_torch(d)]) for n, d in dtypes.items()))
