"""Columnar chunk model — the unit of dataflow.

Port of ``risingwave_tpu/array/chunk.py``. Reference:
src/common/src/array/data_chunk.rs (columns + visibility bitmap) and
src/common/src/array/stream_chunk.rs:98 (+ ops column).

A chunk is a fixed-capacity struct of (capacity,) tensors: a ``valid``
lane marks live rows, padding lanes hold zeros, ``nulls[name]`` marks
SQL NULL for nullable columns only, and a StreamChunk adds an int32
``ops`` lane of ``types.Op``. Fixed capacities keep the shapes every
kernel sees to a small set, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from risingwave_tpu_torch import resolve_device
from risingwave_tpu_torch.types import Schema, op_sign


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def to_device(arr, device) -> torch.Tensor:
    """A numpy array as a tensor of its own on ``device`` (always a
    copy: state is updated in place, and the source may be read-only)."""
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


@dataclass
class DataChunk:
    """Fixed-capacity columnar batch with visibility + per-column nulls."""

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor  # (capacity,) bool
    nulls: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def null_of(self, name: str) -> torch.Tensor:
        """Null lane for a column; all-False lane if non-nullable."""
        lane = self.nulls.get(name)
        if lane is None:
            return torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
        return lane

    def is_nullable(self, name: str) -> bool:
        return name in self.nulls

    def select(self, names) -> "DataChunk":
        return DataChunk(
            {n: self.columns[n] for n in names},
            self.valid,
            {n: self.nulls[n] for n in names if n in self.nulls},
        )

    def mask(self, keep: torch.Tensor) -> "DataChunk":
        """Narrow visibility (filter) without moving data."""
        return DataChunk(self.columns, self.valid & keep, self.nulls)

    def with_columns(self, **cols: torch.Tensor) -> "DataChunk":
        """Add/replace columns. Replaced columns become NON-nullable
        (a stale null lane would send fresh values to the NULL group)."""
        new = dict(self.columns)
        new.update(cols)
        nulls = {n: a for n, a in self.nulls.items() if n not in cols}
        return DataChunk(new, self.valid, nulls)

    def with_nulls(self, **lanes: torch.Tensor) -> "DataChunk":
        new = dict(self.nulls)
        new.update(lanes)
        return DataChunk(self.columns, self.valid, new)

    def rename(self, mapping: Mapping[str, str]) -> "DataChunk":
        return DataChunk(
            {mapping.get(n, n): a for n, a in self.columns.items()},
            self.valid,
            {mapping.get(n, n): a for n, a in self.nulls.items()},
        )

    # -- host interop ---------------------------------------------------
    @staticmethod
    def from_numpy(
        cols: Mapping[str, np.ndarray],
        capacity: int,
        schema: Optional[Schema] = None,
        nulls: Optional[Mapping[str, np.ndarray]] = None,
        device="cuda",
    ) -> "DataChunk":
        dev = resolve_device(device)
        n = _common_len(cols)
        if n > capacity:
            raise ValueError(f"{n} rows exceed capacity {capacity}")
        out = {}
        for name, arr in cols.items():
            arr = np.asarray(arr)
            dtype = (
                _numpy_dtype(schema.field(name).dtype.device_dtype)
                if schema is not None
                else arr.dtype
            )
            if (
                np.issubdtype(arr.dtype, np.integer)
                and np.issubdtype(dtype, np.integer)
                and arr.size
                and (
                    arr.max(initial=0) > np.iinfo(dtype).max
                    or arr.min(initial=0) < np.iinfo(dtype).min
                )
            ):
                raise ValueError(
                    f"column {name!r}: values overflow device dtype {dtype}"
                )
            pad = np.zeros(capacity, dtype=dtype)
            pad[:n] = arr.astype(dtype)
            out[name] = to_device(pad, dev)
        valid = np.zeros(capacity, dtype=np.bool_)
        valid[:n] = True
        dev_nulls = {}
        for name, lane in (nulls or {}).items():
            if name not in out:
                raise KeyError(f"null lane for unknown column {name!r}")
            pad = np.zeros(capacity, dtype=np.bool_)
            pad[:n] = np.asarray(lane, dtype=np.bool_)
            dev_nulls[name] = to_device(pad, dev)
        return DataChunk(out, to_device(valid, dev), dev_nulls)

    def _live_slice(self):
        """(valid_prefix, pad): move the valid lane first, then only the
        prefix that holds live rows (flush chunks compact their rows to
        the front)."""
        valid = self.valid.cpu().numpy()
        nz = np.flatnonzero(valid)
        if len(nz) == 0:
            return valid[:0], 0
        k = int(nz[-1]) + 1
        return valid[:k], k

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Compact live rows back to host (drops padding); NULL lanes
        come back as ``<name>__null`` bool columns."""
        valid, pad = self._live_slice()
        out = {n: a[:pad].cpu().numpy()[valid] for n, a in self.columns.items()}
        for n, lane in self.nulls.items():
            out[n + "__null"] = lane[:pad].cpu().numpy()[valid]
        return out


@dataclass
class StreamChunk(DataChunk):
    """DataChunk + per-row change op (reference: stream_chunk.rs:98)."""

    ops: torch.Tensor = None  # (capacity,) int32 of types.Op; required

    def __post_init__(self):
        if self.ops is None:
            raise TypeError(
                "StreamChunk.ops is required; use from_numpy to default "
                "to all-INSERT"
            )

    @staticmethod
    def from_data(chunk: DataChunk, ops: Optional[torch.Tensor] = None) -> "StreamChunk":
        if ops is None:  # all INSERT
            ops = torch.zeros(chunk.capacity, dtype=torch.int32, device=chunk.device)
        return StreamChunk(columns=chunk.columns, valid=chunk.valid, nulls=chunk.nulls, ops=ops)

    @staticmethod
    def from_numpy(
        cols: Mapping[str, np.ndarray],
        capacity: int,
        ops: Optional[np.ndarray] = None,
        schema: Optional[Schema] = None,
        nulls: Optional[Mapping[str, np.ndarray]] = None,
        device="cuda",
    ) -> "StreamChunk":
        base = DataChunk.from_numpy(cols, capacity, schema, nulls, device)
        pad = np.zeros(capacity, dtype=np.int32)
        if ops is not None:
            pad[: len(ops)] = np.asarray(ops, dtype=np.int32)
        return StreamChunk(
            columns=base.columns,
            valid=base.valid,
            nulls=base.nulls,
            ops=to_device(pad, base.device),
        )

    def signs(self) -> torch.Tensor:
        """+1 / -1 per row; 0 contribution is handled via ``valid``."""
        return op_sign(self.ops)

    def effective_signs(self) -> torch.Tensor:
        """Signs with padding zeroed — the canonical retraction weight."""
        return torch.where(self.valid, self.signs(), torch.zeros_like(self.ops))

    def select(self, names) -> "StreamChunk":
        return StreamChunk(
            {n: self.columns[n] for n in names},
            self.valid,
            {n: self.nulls[n] for n in names if n in self.nulls},
            self.ops,
        )

    def mask(self, keep: torch.Tensor) -> "StreamChunk":
        return StreamChunk(self.columns, self.valid & keep, self.nulls, self.ops)

    def with_columns(self, **cols: torch.Tensor) -> "StreamChunk":
        new = dict(self.columns)
        new.update(cols)
        nulls = {n: a for n, a in self.nulls.items() if n not in cols}
        return StreamChunk(new, self.valid, nulls, self.ops)

    def with_nulls(self, **lanes: torch.Tensor) -> "StreamChunk":
        new = dict(self.nulls)
        new.update(lanes)
        return StreamChunk(self.columns, self.valid, new, self.ops)

    def rename(self, mapping: Mapping[str, str]) -> "StreamChunk":
        return StreamChunk(
            {mapping.get(n, n): a for n, a in self.columns.items()},
            self.valid,
            {mapping.get(n, n): a for n, a in self.nulls.items()},
            self.ops,
        )

    def to_numpy(self, with_ops: bool = True) -> Dict[str, np.ndarray]:
        out = super().to_numpy()
        if with_ops:
            valid, pad = self._live_slice()
            out["__op__"] = self.ops[:pad].cpu().numpy()[valid]
        return out


def _common_len(cols: Mapping[str, np.ndarray]) -> int:
    lens = {len(np.asarray(a)) for a in cols.values()}
    if len(lens) > 1:
        raise ValueError(f"ragged columns: {lens}")
    return lens.pop() if lens else 0


def concat_chunks(chunks, capacity: Optional[int] = None, device=None) -> StreamChunk:
    """Host-side helper: stack chunks into one wider chunk (test
    utility). ``device`` defaults to the first chunk's."""
    nps = [c.to_numpy(with_ops=True) for c in chunks]
    names = [n for n in nps[0] if n != "__op__" and not n.endswith("__null")]
    null_names = sorted(
        {n[: -len("__null")] for d in nps for n in d if n.endswith("__null")}
    )
    cols = {n: np.concatenate([d[n] for d in nps]) for n in names}
    nulls = {
        n: np.concatenate(
            [d.get(n + "__null", np.zeros(len(d[n]), np.bool_)) for d in nps]
        )
        for n in null_names
    }
    ops = np.concatenate([d["__op__"] for d in nps])
    cap = capacity or max(1, len(ops))
    return StreamChunk.from_numpy(
        cols,
        cap,
        ops=ops,
        nulls=nulls or None,
        device=device if device is not None else chunks[0].device,
    )


def stack_chunks(chunks) -> StreamChunk:
    """Stack chunks of one signature (capacity, columns, null lanes,
    dtypes) into one chunk whose lanes carry a leading (n_chunks,) axis
    (reference: ``parallel/sharded_agg.py:615``)."""
    c0 = chunks[0]
    stack = lambda get: torch.stack([get(c) for c in chunks])
    return StreamChunk(
        {n: stack(lambda c, n=n: c.columns[n]) for n in c0.columns},
        stack(lambda c: c.valid),
        {n: stack(lambda c, n=n: c.nulls[n]) for n in c0.nulls},
        stack(lambda c: c.ops),
    )


def flatten_stacked(chunk: StreamChunk) -> StreamChunk:
    """A stacked chunk as one row batch, chunk 0's rows first (a view;
    reference: ``fused_step.py:323``, ``hash_agg.py:205-211``)."""
    flat = lambda a: a.reshape(-1)
    return StreamChunk(
        {n: flat(a) for n, a in chunk.columns.items()},
        flat(chunk.valid),
        {n: flat(a) for n, a in chunk.nulls.items()},
        flat(chunk.ops),
    )

