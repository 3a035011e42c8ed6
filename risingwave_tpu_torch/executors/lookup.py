"""Lookup / delta join over shared index arrangements.

Reference: src/stream/src/executor/lookup.rs (+ lookup_union.rs,
delta_join in the frontend planner): a join realized as two LOOKUPS
against index arrangements — Δ(A ⋈ B) = ΔA ⋈ B ∪ A ⋈ ΔB — where the
arrangements ARE the user's CREATE INDEX state, shared, not duplicated
per join (the reference's motivating win over hash join state).

Engine mapping: an IndexArrangement is a MaterializeExecutor whose pk
is (index columns ‖ base pk) — the index-column prefix makes upserts
collision-free — plus an in-memory prefix map for O(1) lookups. The
runtime's subscription routing updates each arrangement from its base
table's change stream in the same push cycle that reaches the join, so
each delta looks up the other side's arrangement at exactly the
reference's snapshot point (deltas process in arrival order).

The delta join itself is STATELESS: recovery restores the
arrangements from their own checkpoint tables and replayed chunks
re-derive the same emissions.

Port of ``risingwave_tpu/executors/lookup.py`` (host code, no device
kernel: the arrangements are host row maps). The delta join's
emissions land on the device of the chunk that arrived. ``lint_info``
and ``trace_contract`` are not ported (the analysis hooks).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Barrier, Executor
from risingwave_tpu_torch.executors.materialize import MaterializeExecutor
from risingwave_tpu_torch.types import Op


class IndexArrangement(MaterializeExecutor):
    """CREATE INDEX state: rows keyed by (index cols ‖ base pk) with a
    prefix map for point lookups (arrange.rs analogue)."""

    def __init__(
        self,
        index_cols: Sequence[str],
        base_pk: Sequence[str],
        columns: Sequence[str],
        table_id: str,
    ):
        self.index_cols = tuple(index_cols)
        self.base_pk = tuple(base_pk)
        super().__init__(
            pk=self.index_cols + self.base_pk,
            columns=tuple(columns),
            table_id=table_id,
        )
        self.by_prefix: Dict[Tuple, set] = {}
        # the prefix map + lookup() read self.rows: pin the dict
        # backend for apply AND restore (the native map never
        # populates .rows)
        self._force_python = True
        self._backend = "python"

    # -- maintenance -----------------------------------------------------
    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        data = chunk.to_numpy(with_ops=True)
        ops = data["__op__"]
        plen = len(self.index_cols)
        lanes = []
        for name in self.pk:
            col = data[name].tolist()
            nl = data.get(name + "__null")
            if nl is not None:
                col = [
                    None if isnull else v for v, isnull in zip(col, nl)
                ]
            lanes.append(col)
        for i in range(len(ops)):
            k = tuple(lane[i] for lane in lanes)
            pre = k[:plen]
            if ops[i] in (Op.DELETE, Op.UPDATE_DELETE):
                s = self.by_prefix.get(pre)
                if s is not None:
                    s.discard(k)
                    if not s:
                        del self.by_prefix[pre]
            else:
                # the prefix is part of the pk: an upsert of the same
                # full key can never leave a stale prefix entry
                self.by_prefix.setdefault(pre, set()).add(k)
        return super().apply(chunk)

    def restore_state(self, table_id, key_cols, value_cols):
        super().restore_state(table_id, key_cols, value_cols)
        plen = len(self.index_cols)
        self.by_prefix = {}
        for k in self.rows:
            self.by_prefix.setdefault(k[:plen], set()).add(k)

    # -- reads -----------------------------------------------------------
    def lookup(self, prefix: Tuple) -> List[Dict[str, object]]:
        """All current rows whose index columns equal ``prefix`` —
        each as a full name->value dict."""
        out = []
        for k in self.by_prefix.get(tuple(prefix), ()):
            v = self.rows.get(k)
            if v is None:
                continue
            row = dict(zip(self.pk, k))
            row.update(zip(self.columns, v))
            out.append(row)
        return out


class DeltaJoinExecutor(Executor):
    """Two-input inner join as lookups against two shared
    IndexArrangements (delta join). Emits, per arriving delta row, the
    delta's op for every current match on the other side.

    ``left_out`` / ``right_out``: [(output name, side column)] —
    includes the hidden base-pk lanes the downstream MV keys on."""

    def __init__(
        self,
        left_arr: IndexArrangement,
        right_arr: IndexArrangement,
        left_keys: Sequence[str],
        right_keys: Sequence[str],
        left_out: Sequence[Tuple[str, str]],
        right_out: Sequence[Tuple[str, str]],
        out_cap: int = 1 << 12,
    ):
        if len(left_keys) != len(right_keys):
            raise ValueError("join key arity mismatch")
        if tuple(left_arr.index_cols[: len(left_keys)]) != tuple(
            left_keys
        ) or tuple(right_arr.index_cols[: len(right_keys)]) != tuple(
            right_keys
        ):
            raise ValueError(
                "delta join needs indexes whose leading columns are "
                "exactly the join keys"
            )
        self.left_arr = left_arr
        self.right_arr = right_arr
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.left_out = tuple(left_out)
        self.right_out = tuple(right_out)
        self.out_cap = out_cap

    # -- the two delta paths --------------------------------------------
    def _rows_of(self, chunk: StreamChunk, names):
        data = chunk.to_numpy(with_ops=True)
        ops = data["__op__"]
        cols = {}
        for name in names:
            col = data[name].tolist()
            nl = data.get(name + "__null")
            if nl is not None:
                col = [
                    None if isnull else v for v, isnull in zip(col, nl)
                ]
            cols[name] = col
        return ops, cols, len(ops)

    def _emit(self, out_rows, out_ops, device) -> List[StreamChunk]:
        if not out_rows:
            return []
        names = [n for n, _ in self.left_out] + [
            n for n, _ in self.right_out
        ]
        out: List[StreamChunk] = []
        for at in range(0, len(out_rows), self.out_cap):
            rows = out_rows[at : at + self.out_cap]
            ops = out_ops[at : at + self.out_cap]
            cols = {}
            nulls = {}
            for j, name in enumerate(names):
                vals = [r[j] for r in rows]
                nl = np.asarray([v is None for v in vals], bool)
                cols[name] = np.asarray(
                    [0 if v is None else v for v in vals], np.int64
                )
                if nl.any():
                    nulls[name] = nl
            cap = 1 << max(1, int(np.ceil(np.log2(max(2, len(rows))))))
            out.append(
                StreamChunk.from_numpy(
                    cols, cap, ops=np.asarray(ops, np.int32), nulls=nulls,
                    device=device,
                )
            )
        return out

    def _delta(self, chunk, side_keys, own_out, other_arr, other_out, flip):
        stream_cols = [c for _, c in own_out]
        ops, cols, n = self._rows_of(
            chunk, set(stream_cols) | set(side_keys)
        )
        valid_rows = range(n)
        out_rows, out_ops = [], []
        for i in valid_rows:
            key = tuple(cols[k][i] for k in side_keys)
            if any(v is None for v in key):
                continue  # SQL: NULL join keys never match
            matches = other_arr.lookup(key)
            if not matches:
                continue
            mine = [cols[c][i] for _, c in own_out]
            for m in matches:
                theirs = [m[c] for _, c in other_out]
                row = theirs + mine if flip else mine + theirs
                out_rows.append(row)
                out_ops.append(int(ops[i]))
        return self._emit(out_rows, out_ops, chunk.device)

    def apply_left(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._delta(
            chunk,
            self.left_keys,
            self.left_out,
            self.right_arr,
            self.right_out,
            flip=False,
        )

    def apply_right(self, chunk: StreamChunk) -> List[StreamChunk]:
        return self._delta(
            chunk,
            self.right_keys,
            self.right_out,
            self.left_arr,
            self.left_out,
            flip=True,
        )

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        raise TypeError("DeltaJoinExecutor is two-input: apply_left/right")

    def on_barrier(self, barrier: Barrier) -> List[StreamChunk]:
        return []
