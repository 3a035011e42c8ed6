"""Temporal join — stream rows enriched against a versioned table.

Port of ``risingwave_tpu/executors/temporal_join.py`` (``_probe_step``
:32, ``TemporalJoinExecutor`` :52). Reference:
src/stream/src/executor/temporal_join.rs:44 — the stream (left) side
probes the right TABLE at the row's processing epoch; the right side
keeps NO join state and emits nothing on its own. Used for ``JOIN t FOR
SYSTEM_TIME AS OF PROCTIME()`` lookups (dimension tables).

The right side is the table's ``DeviceMaterializeExecutor``. The probe
is one launch of kernel AB (``csrc/temporal_probe.cu``): the read-only
probe of the MV's pk table (K3's loop, ``csrc/probe.cuh``; found only
where the slot is live), the gather of every output value lane at the
found slot (a miss reads slot cap - 1, as the reference), the NULL
lanes (``miss | vnulls[slot]``) and ``valid`` (``left`` keeps misses,
``inner`` drops them). On the CPU it is the plain PyTorch version.
``apply`` reads ``right.table`` and ``right.state`` each time, never a
cached copy: the MV grows and rebuilds between chunks.

A host-map right side (``MaterializeExecutor``) is probed on the host,
as the reference's ``_probe_host`` (:161): the chunk is read back, each
valid row's key looked up in the MV's snapshot, and the output lanes
and their NULL lanes built on the chunk's device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
from risingwave_tpu_torch.ops.hash_table import HashTable, _lookup_torch, key_lane_rows

# output columns one launch of kernel AB gathers (csrc/temporal_probe.cu TP_MAX_OUT)
PROBE_OUTS = 16


def probe_step(table: HashTable, values, vnulls, chunk: StreamChunk, key_lanes, key_ok,
               out_cols, jt: str) -> StreamChunk:
    """``chunk`` enriched with ``out_cols`` of the table's row whose pk
    equals ``key_lanes`` (already in the table's key dtypes). Rows with
    ``key_ok`` False (a NULL key) never match."""
    if chunk.valid.device.type == "cpu":
        return _probe_torch(table, values, vnulls, chunk, key_lanes, key_ok, out_cols, jt)
    if chunk.valid.device.type == "cuda":
        return _probe_cuda(table, values, vnulls, chunk, key_lanes, key_ok, out_cols, jt)
    raise ValueError(f"unsupported device {chunk.valid.device}")


def _probe_torch(table, values, vnulls, chunk, key_lanes, key_ok, out_cols, jt):
    # SQL: NULL = anything is unknown — NULL-keyed rows never match
    slots, found = _lookup_torch(table, key_lanes, chunk.valid & key_ok)
    found = found & key_ok
    idx = torch.where(found, slots.long(), torch.full_like(slots.long(), table.capacity - 1))
    cols = dict(chunk.columns)
    nulls = dict(chunk.nulls)
    for name in out_cols:
        cols[name] = values[name][idx]
        miss = ~found
        lane = vnulls.get(name)
        if lane is not None:
            miss = miss | lane[idx]
        nulls[name] = miss
    valid = chunk.valid if jt == "left" else (chunk.valid & found)
    return StreamChunk(cols, valid, nulls, chunk.ops)


def _probe_cuda(table, values, vnulls, chunk, key_lanes, key_ok, out_cols, jt):
    n = chunk.capacity
    if len(out_cols) > PROBE_OUTS:
        raise ValueError(
            f"temporal probe: {len(out_cols)} outputs exceed kernel AB's {PROBE_OUTS}")
    if chunk.valid.dtype != torch.bool or key_ok.dtype != torch.bool:
        raise TypeError("temporal probe: valid and key_ok must be bool lanes")
    keys = key_lane_rows(table, key_lanes, n, "temporal_probe")
    _kernels.check_cuda("temporal_probe", chunk.valid, key_ok, n=n)
    dev = chunk.device
    cols = dict(chunk.columns)
    nulls = dict(chunk.nulls)
    outs = []
    for name in out_cols:
        src, vnull = values[name], vnulls.get(name)
        _kernels.check_cuda("temporal_probe", src, *(() if vnull is None else (vnull,)),
                            n=table.capacity)
        cols[name] = torch.empty(n, dtype=src.dtype, device=dev)
        nulls[name] = torch.empty(n, dtype=torch.bool, device=dev)
        outs.append((src.data_ptr(), 0 if vnull is None else vnull.data_ptr(),
                     cols[name].data_ptr(), nulls[name].data_ptr(), src.element_size()))
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    _kernels.call(
        "temporal_probe", "rw_temporal_probe", _kernels.int64_rows(keys, 8), len(keys), n,
        chunk.valid.data_ptr(), key_ok.data_ptr(), table.fp1.data_ptr(), table.fp2.data_ptr(),
        table.live.data_ptr(), table.capacity, _kernels.int64_rows(outs, PROBE_OUTS), len(outs),
        1 if jt == "left" else 0, valid.data_ptr(),
    )
    return StreamChunk(cols, valid, nulls, chunk.ops)


class TemporalJoinExecutor(Executor):
    """``stream JOIN table FOR SYSTEM_TIME AS OF PROCTIME()``.

    ``right``: the table's materialize executor. ``left_keys``: stream
    columns equi-matched against the table's pk (in pk order).
    ``output_cols``: table value columns appended to every matched row.
    ``join_type``: "inner" drops misses, "left" keeps them with
    NULL-padded table columns.
    """

    def __init__(self, right, left_keys: Sequence[str], output_cols: Sequence[str],
                 join_type: str = "inner"):
        if join_type not in ("inner", "left"):
            raise ValueError("temporal join supports inner/left")
        self.right = right
        self.left_keys = tuple(left_keys)
        self.output_cols = tuple(output_cols)
        self.join_type = join_type

    def _key_lanes(self, chunk: StreamChunk):
        """The left key lanes cast to the table's key dtypes, and
        ``key_ok`` (no key column NULL)."""
        key_lanes = tuple(
            chunk.col(k).to(tk.dtype) for k, tk in zip(self.left_keys, self.right.table.keys)
        )
        key_ok = torch.ones(chunk.capacity, dtype=torch.bool, device=chunk.device)
        for k in self.left_keys:
            key_ok = key_ok & ~chunk.null_of(k)
        return key_lanes, key_ok

    def _step(self, chunk: StreamChunk) -> StreamChunk:
        key_lanes, key_ok = self._key_lanes(chunk)
        return probe_step(self.right.table, self.right.state.values, self.right.state.vnulls,
                          chunk, key_lanes, key_ok, self.output_cols, self.join_type)

    def trace_contract(self):
        return {
            "kind": "device",
            "trace_step": self._step,
            # the probe only READS the right table: nothing to donate
            "state": None,
            "donate": True,
            "emission": "passthrough",
        }

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        if isinstance(self.right, DeviceMaterializeExecutor):
            if len(self.right.pk) != len(self.left_keys):
                raise ValueError("left_keys must match the table pk")
            return [self._step(chunk)]
        return [self._probe_host(chunk)]

    def _probe_host(self, chunk: StreamChunk) -> StreamChunk:
        snap = self.right.snapshot()  # pk tuple -> value tuple
        col_pos = {c: i for i, c in enumerate(self.right.columns)}
        data = chunk.to_numpy(with_ops=True)
        n = len(data["__op__"])
        found = np.zeros(chunk.capacity, np.bool_)
        outs = {c: np.zeros(chunk.capacity, object) for c in self.output_cols}
        live = np.flatnonzero(chunk.valid.cpu().numpy())
        for j, i in enumerate(live[:n]):
            if any(data.get(k + "__null") is not None and data[k + "__null"][j]
                   for k in self.left_keys):
                continue  # a NULL key never matches (SQL unknown)
            row = snap.get(tuple(data[k][j].item() for k in self.left_keys))
            if row is not None:
                found[i] = True
                for c in self.output_cols:
                    outs[c][i] = row[col_pos[c]]
        dev = chunk.device
        cols = dict(chunk.columns)
        nulls = dict(chunk.nulls)
        for c in self.output_cols:
            vals = outs[c].tolist()
            cols[c] = torch.from_numpy(np.asarray([0 if v is None else v for v in vals])).to(dev)
            nulls[c] = torch.from_numpy(~found | np.asarray([v is None for v in vals])).to(dev)
        valid = chunk.valid
        if self.join_type != "left":
            valid = valid & torch.from_numpy(found).to(dev)
        return StreamChunk(cols, valid, nulls, chunk.ops)
