"""Expand executor — row duplication for GROUPING SETS.

Port of ``risingwave_tpu/executors/expand.py`` (``_expand_step`` :29,
``ExpandExecutor`` :56). Reference: src/stream/src/executor/expand.rs —
each input row is emitted once per column subset with the columns
OUTSIDE the subset replaced by NULL and a ``flag`` column identifying
the subset; a downstream HashAgg grouping on (keys..., flag) then
computes every grouping set in one pass.

K = len(subsets) is static, so a chunk of capacity C becomes one chunk
of capacity C * K with copy i forming the i-th contiguous block (U-/U+
pairs stay adjacent), copy i's out-of-subset columns carrying an
all-True null lane. On the card one launch of kernel AA's ``rw_expand``
(``csrc/tile_expand.cu``) writes every lane; on the CPU it is the plain
PyTorch version. Like the reference, the executor has no pure step, so
``fuse_chain`` leaves it interpreted.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.executors.project_set import (
    _check_chunk,
    _copy_index,
    _tile,
)


def expand_step(chunk: StreamChunk, subsets, names, flag_col: str) -> StreamChunk:
    """Copy i of every row: each listed column outside ``subsets[i]``
    NULL, ``flag_col`` = i (int64); the other null lanes tile."""
    if chunk.valid.device.type == "cpu":
        return _expand_torch(chunk, subsets, names, flag_col)
    if chunk.valid.device.type == "cuda":
        return _expand_cuda(chunk, subsets, names, flag_col)
    raise ValueError(f"unsupported device {chunk.valid.device}")


def _expand_torch(chunk, subsets, names, flag_col):
    cap, dev = chunk.capacity, chunk.device
    k = len(subsets)
    cols = {n: _tile(a, k) for n, a in chunk.columns.items()}
    cols[flag_col] = _copy_index(k, cap, dev)
    nulls = {}
    for n in names:
        base = chunk.nulls.get(n)
        lanes = []
        for subset in subsets:
            if n in subset:
                lanes.append(base if base is not None
                             else torch.zeros(cap, dtype=torch.bool, device=dev))
            else:  # outside the subset: NULL in this copy
                lanes.append(torch.ones(cap, dtype=torch.bool, device=dev))
        nulls[n] = torch.cat(lanes)
    # columns not mentioned in any subset keep their own null lanes
    for n, lane in chunk.nulls.items():
        if n not in nulls:
            nulls[n] = _tile(lane, k)
    return StreamChunk(cols, _tile(chunk.valid, k), nulls, _tile(chunk.ops, k))


def _expand_cuda(chunk, subsets, names, flag_col):
    k = len(subsets)
    _check_chunk("expand", chunk, k)
    cap, dev = chunk.capacity, chunk.device
    empty = lambda dtype: torch.empty(cap * k, dtype=dtype, device=dev)
    rows, cols, nulls = [], {}, {}
    for n, a in chunk.columns.items():
        cols[n] = empty(a.dtype)
        rows.append((a.data_ptr(), cols[n].data_ptr(), a.element_size(), 0, 0))
    cols[flag_col] = flag = empty(torch.int64)
    for n in names:
        # mode 1: copy i keeps the row's null bit (0 without a lane) where
        # bit i of keep is set, else writes 1
        keep = sum(1 << i for i, s in enumerate(subsets) if n in s)
        base = chunk.nulls.get(n)
        nulls[n] = empty(torch.bool)
        rows.append((0 if base is None else base.data_ptr(), nulls[n].data_ptr(), 1, 1, keep))
    for n, lane in chunk.nulls.items():
        if n not in nulls:
            nulls[n] = empty(torch.bool)
            rows.append((lane.data_ptr(), nulls[n].data_ptr(), 1, 0, 0))
    if len(rows) > _kernels.TILE_LANES:
        raise ValueError(
            f"expand: {len(rows)} lanes exceed kernel AA's {_kernels.TILE_LANES}")
    valid, ops = empty(torch.bool), empty(torch.int32)
    _kernels.call(
        "tile_expand", "rw_expand", _kernels.int64_rows(rows, _kernels.TILE_LANES), len(rows),
        k, cap, chunk.valid.data_ptr(), chunk.ops.data_ptr(), flag.data_ptr(), valid.data_ptr(),
        ops.data_ptr(),
    )
    return StreamChunk(cols, valid, nulls, ops)


class ExpandExecutor(Executor):
    """GROUPING SETS expansion: ``subsets`` lists, per output copy, the
    columns that KEEP their values (the grouping set); all other listed
    columns become NULL in that copy; ``flag_col`` carries the subset
    ordinal (group on (cols..., flag) downstream)."""

    def __init__(self, subsets: Sequence[Sequence[str]], flag_col: str = "flag"):
        if not subsets:
            raise ValueError("expand needs at least one subset")
        self.subsets = tuple(tuple(s) for s in subsets)
        # the union of all subset columns is what expansion touches
        self.names = tuple(sorted({c for s in self.subsets for c in s}))
        self.flag_col = flag_col

    def _step(self, chunk: StreamChunk) -> StreamChunk:
        return expand_step(chunk, self.subsets, self.names, self.flag_col)

    def trace_contract(self):
        return {
            "kind": "device",
            "trace_step": self._step,
            "state": None,
            "donate": True,
            # output capacity is input capacity x len(subsets)
            "emission": "passthrough",
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        missing = [n for n in self.names if n not in chunk.columns]
        if missing:
            raise KeyError(f"expand subset columns not in chunk: {missing}")
        if self.flag_col in chunk.columns:
            raise ValueError(
                f"flag column {self.flag_col!r} collides with an input "
                "column; pass a different flag_col"
            )
        return [self._step(chunk)]
